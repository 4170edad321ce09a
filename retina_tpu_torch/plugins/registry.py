"""Plugin registry: name → constructor (a copy of retina_tpu/plugins/registry.py).

Reference analog: pkg/plugin/registry/registry.go:36-53 — a package-level
map populated by plugin ``init()`` self-registration, panicking on
duplicates. Same contract: :func:`add` raises on dup. The reference's
lookup side (``get``, ``names``) comes with the plugin manager that reads it.
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


def register(cls: Type["api.Plugin"]) -> Type["api.Plugin"]:
    """Class decorator: the init()+Add self-registration idiom."""
    add(cls.name, cls)
    return cls
