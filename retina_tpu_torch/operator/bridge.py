"""External backends for the CRD store seam (port of
retina_tpu/operator/bridge.py).

Reference analog: the reference operator's reconcilers are fed by
controller-runtime informers against a real kube-apiserver
(pkg/controllers/operator/capture/controller.go:102; envtest in unit
tests). The in-process :class:`CRDStore` is that seam; this module plugs
EXTERNAL sources into it so the same reconcilers run unmodified:

- :class:`FileBridge` — watches a directory of CR YAMLs (the envtest/
  fake-apiserver analog): apply on add/change, delete on file removal,
  and Capture status written back next to the source file (the status-
  subresource analog), so ``kubectl-retina``-style workflows complete
  against plain files.
- :class:`KubeBridge` — list+watch of the retina.sh custom resources over
  :class:`~retina_tpu_torch.operator.kubeclient.KubeClient`, with
  resourceVersion resumption, and a PATCH of the status subresource on
  reconcile — the same REST contract controller-runtime speaks. The agent
  runs one over its two module kinds.

Both run a background thread, never raise out of it, and translate to the
store's apply/delete informer events. PyYAML is imported only when a
document is parsed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Callable, Optional

from retina_tpu_torch.crd.types import (
    Capture,
    MetricsConfiguration,
    TracesConfiguration,
)
from retina_tpu_torch.log import logger
from retina_tpu_torch.operator.kubeclient import KubeClient
from retina_tpu_torch.operator.kubewatch import meta_keys
from retina_tpu_torch.operator.store import CRDStore

GROUP = "retina.sh"
VERSION = "v1alpha1"


def _parser(cls) -> Callable[[dict], Any]:
    """A dict → CR parser through the type's ``from_yaml`` (the reference's
    round trip, which also normalises the document)."""
    def parse(doc: dict) -> Any:
        import yaml  # only here: the agent imports no YAML parser otherwise

        return cls.from_yaml(yaml.safe_dump(doc))

    return parse


# kind -> (plural, parser)
KINDS: dict[str, Any] = {
    "Capture": ("captures", _parser(Capture)),
    "MetricsConfiguration": ("metricsconfigurations",
                             _parser(MetricsConfiguration)),
    "TracesConfiguration": ("tracesconfigurations",
                            _parser(TracesConfiguration)),
}


class FileBridge:
    """Directory of CR YAMLs → CRDStore (apply/delete/status)."""

    def __init__(self, store: CRDStore, directory: str,
                 poll_interval: float = 0.5):
        self._log = logger("filebridge")
        self.store = store
        self.directory = directory
        self.poll_interval = poll_interval
        self._seen: dict[str, float] = {}  # path -> mtime
        self._applied: dict[str, list[tuple[str, str, str]]] = {}
        #   path -> [(kind, namespace, name)] for every doc in the file
        self._status_paths: dict[tuple[str, str, str], str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sync_once(self) -> None:
        """One reconcile pass: apply new/changed files, delete removed
        files AND docs dropped from still-present multi-doc files."""
        present: set[str] = set()
        for fname in sorted(os.listdir(self.directory)):
            if not fname.endswith((".yaml", ".yml")):
                continue
            path = os.path.join(self.directory, fname)
            present.add(path)
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            if self._seen.get(path) == mtime:
                continue
            self._seen[path] = mtime
            try:
                import yaml  # only here: the agent imports no YAML parser otherwise

                with open(path) as fh:
                    docs = [d for d in yaml.safe_load_all(fh) if d]
            except Exception as e:  # noqa: BLE001 — one bad file != down
                self._log.warning("error reading %s: %s", path, e)
                continue
            n_caps = sum(1 for d in docs if d.get("kind") == "Capture")
            entries: list[tuple[str, str, str]] = []
            for doc in docs:
                try:
                    entry = self._apply_doc(path, doc, n_caps)
                    if entry is not None:
                        entries.append(entry)
                except Exception as e:  # noqa: BLE001
                    self._log.warning("error applying %s: %s", path, e)
            for entry in self._applied.get(path, []):
                if entry not in entries:
                    self._delete_entry(entry)
            self._applied[path] = entries
        # Removal = deletion (the informer DELETE event).
        for path in list(self._applied):
            if path not in present:
                for entry in self._applied.pop(path):
                    self._delete_entry(entry)
                self._seen.pop(path, None)

    def _delete_entry(self, entry: tuple[str, str, str]) -> None:
        kind, ns, name = entry
        self._status_paths.pop(entry, None)
        try:
            self.store.delete(kind, name, ns)
            self._log.info("deleted %s %s/%s (source doc removed)",
                           kind, ns, name)
        except KeyError:  # noqa: RT101 — already deleted; idempotent reconcile
            pass

    def _apply_doc(self, path: str, doc: dict,
                   n_caps: int) -> Optional[tuple[str, str, str]]:
        kind = doc.get("kind", "")
        if kind not in KINDS:
            self._log.warning("skipping %s: unknown kind %r", path, kind)
            return None
        obj = KINDS[kind][1](doc)
        ns = getattr(obj, "namespace", "") or "default"
        entry = (kind, ns, obj.name)
        if kind == "Capture":
            # Single-capture files keep the plain "<file>.status" contract;
            # multi-capture files get per-name status files. Registered
            # BEFORE apply: the store fires reconcilers synchronously and
            # the Running status sync must find its path.
            self._status_paths[entry] = (
                path + ".status" if n_caps <= 1
                else f"{path}.{obj.name}.status"
            )
        self.store.apply(kind, obj)
        return entry

    def on_status(self, kind: str, obj: Any) -> None:
        """Status sink (wire as the Operator's ``status_sink``): write
        the object's status beside its source file — the
        status-subresource write-back analog."""
        ns = getattr(obj, "namespace", "") or "default"
        sp = self._status_paths.get((kind, ns, obj.name))
        if sp is None:
            return
        tmp = sp + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(dataclasses.asdict(obj.status), fh, indent=2)
        os.replace(tmp, sp)

    def start(self) -> None:
        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.sync_once()
                except Exception:  # noqa: BLE001
                    self._log.exception("file sync failed")
                self._stop.wait(self.poll_interval)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="filebridge")
        self._thread.start()
        self._log.info("file bridge watching %s", self.directory)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)


# ---------------------------------------------------------------------
class KubeBridge:
    """kube-apiserver → CRDStore via list+watch on the retina.sh CRs."""

    API_BASE = f"/apis/{GROUP}/{VERSION}"

    def __init__(self, store: CRDStore, kubeconfig: str,
                 namespace: str = "", retry_s: float = 2.0,
                 kinds: list[str] | None = None):
        """``kinds`` restricts the watch set (default: every KINDS
        entry) — the agent daemon watches only its module CRs instead
        of adding a redundant per-node Capture list+watch stream."""
        self._log = logger("kubebridge")
        self.store = store
        self.namespace = namespace
        self.retry_s = retry_s
        self.kinds = list(kinds) if kinds is not None else list(KINDS)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.client = KubeClient(kubeconfig)

    def _ingest(self, kind: str, event: str, item: dict) -> None:
        parse = KINDS[kind][1]
        if event in ("ADDED", "MODIFIED"):
            try:
                obj = parse(item)
            except Exception as e:  # noqa: BLE001 — poison CR
                # One malformed CR must not wedge the whole kind's
                # watch (an exception escaping into list_watch's LIST
                # loop re-LISTs forever and no CR of this kind ever
                # reconciles again). Skip-and-log, like an admission
                # rejection.
                meta = item.get("metadata", {}) or {}
                self._log.warning(
                    "ignoring malformed %s %s/%s: %s", kind,
                    meta.get("namespace", "default"),
                    meta.get("name", "?"), e,
                )
                return
            self.store.apply(kind, obj)
        elif event == "DELETED":
            meta = item.get("metadata", {})
            try:
                self.store.delete(
                    kind, meta.get("name", ""),
                    meta.get("namespace", "default"),
                )
            except KeyError:  # noqa: RT101 — already deleted; idempotent reconcile
                pass

    def _sync(self, kind: str, metas: list[dict]) -> None:
        """Post-LIST resync: delete store objects the apiserver no longer
        has (a CR deleted while the watch was down)."""
        listed = meta_keys(metas)
        for obj in self.store.list(kind):
            ns = getattr(obj, "namespace", "") or "default"
            if f"{ns}/{obj.name}" not in listed:
                try:
                    self.store.delete(kind, obj.name, ns)
                except KeyError:  # noqa: RT101 — already deleted; resync race
                    pass

    def patch_status(self, kind: str, obj: Any) -> None:
        """PATCH the status subresource (merge-patch), best effort."""
        plural = KINDS[kind][0]
        ns = getattr(obj, "namespace", "") or "default"
        url = self.client.url(
            self.API_BASE, plural,
            namespace=self.namespace or ns,
            suffix=f"/{obj.name}/status",
        )
        body = json.dumps(
            {"status": dataclasses.asdict(obj.status)}
        ).encode()
        try:
            self.client.request(
                url, method="PATCH", body=body,
                content_type="application/merge-patch+json",
            ).close()
        except Exception as e:  # noqa: BLE001
            self._log.warning("status patch %s/%s failed: %s",
                              kind, obj.name, e)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        for kind in self.kinds:
            plural = KINDS[kind][0]
            t = threading.Thread(
                target=self.client.list_watch,
                args=(self.API_BASE, plural),
                kwargs={
                    "on_event": (
                        lambda ev, item, k=kind: self._ingest(k, ev, item)
                    ),
                    "stop": self._stop,
                    "namespace": self.namespace,
                    "retry_s": self.retry_s,
                    "log": self._log,
                    "on_sync": (
                        lambda metas, k=kind: self._sync(k, metas)
                    ),
                },
                name=f"kubebridge-{plural}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        self._log.info("kube bridge watching %s at %s",
                       ",".join(self.kinds), self.client.server)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(2.0)
