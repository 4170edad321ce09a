"""In-process CRD store — the kube-apiserver seam (port of
retina_tpu/operator/store.py).

The reference's controllers watch CRs through controller-runtime informers
backed by a real apiserver (unit-tested with envtest, SURVEY.md §4). This
store is that seam: typed objects keyed by (kind, namespace/name), with
apply/delete firing registered watchers — the informer contract the
reconcilers consume. The bridges (``operator/bridge.py``) feed it from a
directory of YAML files or from an apiserver; the agent's module
reconciles watch it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from retina_tpu_torch.log import logger

WatchFn = Callable[[str, Any], None]  # (event, obj); event: applied|deleted


class CRDStore:
    def __init__(self) -> None:
        self._log = logger("crdstore")
        self._lock = threading.RLock()
        self._objs: dict[str, dict[str, Any]] = {}
        self._watchers: dict[str, list[WatchFn]] = {}

    @staticmethod
    def _key(obj: Any) -> str:
        ns = getattr(obj, "namespace", "") or "default"
        return f"{ns}/{obj.name}"

    def apply(self, kind: str, obj: Any) -> None:
        if hasattr(obj, "validate"):
            obj.validate()
        with self._lock:
            self._objs.setdefault(kind, {})[self._key(obj)] = obj
            watchers = list(self._watchers.get(kind, []))
        for w in watchers:
            try:
                w("applied", obj)
            except Exception:
                self._log.exception("watcher failed kind=%s", kind)

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        with self._lock:
            obj = self._objs.get(kind, {}).pop(f"{namespace}/{name}", None)
            watchers = list(self._watchers.get(kind, []))
        if obj is None:
            raise KeyError(f"{kind} {namespace}/{name} not found")
        for w in watchers:
            try:
                w("deleted", obj)
            except Exception:
                self._log.exception("watcher failed kind=%s", kind)

    def get(self, kind: str, name: str, namespace: str = "default") -> Any:
        with self._lock:
            obj = self._objs.get(kind, {}).get(f"{namespace}/{name}")
        if obj is None:
            raise KeyError(f"{kind} {namespace}/{name} not found")
        return obj

    def list(self, kind: str) -> list[Any]:
        with self._lock:
            return list(self._objs.get(kind, {}).values())

    def watch(self, kind: str, fn: WatchFn) -> None:
        with self._lock:
            self._watchers.setdefault(kind, []).append(fn)
        # Replay existing objects (informer initial-sync semantics).
        for obj in self.list(kind):
            try:
                fn("applied", obj)
            except Exception:
                self._log.exception("watcher replay failed kind=%s", kind)
