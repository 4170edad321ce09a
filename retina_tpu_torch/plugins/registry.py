"""Plugin registry: name → constructor (a copy of retina_tpu/plugins/registry.py).

Reference analog: pkg/plugin/registry/registry.go:36-53 — a package-level
map populated by plugin ``init()`` self-registration, panicking on
duplicates. Same contract: :func:`add` raises on dup, :func:`get` raises
KeyError on unknown names (pluginmanager surfaces both as fatal).
"""

from __future__ import annotations

from typing import Callable, Type

from retina_tpu_torch.config import Config
from retina_tpu_torch.plugins import api  # noqa: F401 — quoted annotations below

PluginCtor = Callable[[Config], "api.Plugin"]

_registry: dict[str, PluginCtor] = {}


def add(name: str, ctor: PluginCtor) -> None:
    if name in _registry:
        raise ValueError(f"plugin {name!r} already registered")
    _registry[name] = ctor


def get(name: str) -> PluginCtor:
    if name not in _registry:
        raise KeyError(
            f"plugin {name!r} not registered (known: {sorted(_registry)})"
        )
    return _registry[name]


def names() -> list[str]:
    return sorted(_registry)


def register(cls: Type["api.Plugin"]) -> Type["api.Plugin"]:
    """Class decorator: the init()+Add self-registration idiom."""
    add(cls.name, cls)
    return cls
