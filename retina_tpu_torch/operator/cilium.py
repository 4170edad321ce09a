"""Cilium CRD interop: identity without our CNI (port of
retina_tpu/operator/cilium.py).

Reference analog: pkg/controllers/operator/cilium-crds/ — when the
reference runs its Hubble control plane on a cluster whose CNI is not
Cilium, the operator manufactures the Cilium identity objects itself:
- endpoint/identitymanager.go — allocates one numeric identity per
  distinct security-label set (refcounted; released on pod delete).
- endpoint/endpoint_controller.go:281-360 — Pod events →
  CiliumEndpoint CRs (+ CiliumIdentity CRs) written to the apiserver so
  cilium-ecosystem consumers (hubble relay/UI) see standard objects.

Two directions here, both over the shared
:class:`~retina_tpu_torch.operator.kubeclient.KubeClient`:

- :class:`CiliumPublisher` (operator): pod identity → CiliumIdentity +
  CiliumEndpoint CRs on the apiserver. Identical label sets share one
  identity; the CID is deleted when its last endpoint goes.
- :class:`CiliumWatcher` (agent): consume EXISTING CiliumEndpoints
  (cluster runs the Cilium CNI) as the identity source — CEPs land in
  the identity cache as RetinaEndpoints, filling the same role the
  core/v1 pod watcher does, but from the foreign CNI's objects. Its LIST
  takes the same ``list_scope`` as the pod watcher's (one filter push a
  LIST in the agent).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, ContextManager, Optional

from retina_tpu_torch.common import RetinaEndpoint
from retina_tpu_torch.log import logger
from retina_tpu_torch.operator.kubeclient import KubeClient
from retina_tpu_torch.operator.kubewatch import meta_keys

CILIUM_V2 = "/apis/cilium.io/v2"
# Cilium reserves identities <256 (host, world, …); user-label identities
# start here (cilium identity.MinimalAllocationIdentity).
MIN_IDENTITY = 256


class IdentityAllocator:
    """Label-set → refcounted numeric identity (identitymanager.go).

    One identity per DISTINCT sorted label set; allocating the same set
    again bumps a refcount, releasing decrements, and the identity number
    is freed (and reported) only when the count reaches zero — exactly
    one release per deleted/relabeled pod, or identities leak.
    """

    def __init__(self, base: int = MIN_IDENTITY):
        self._next = base
        self._by_labels: dict[tuple[tuple[str, str], ...], int] = {}
        self._refs: dict[int, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
        return tuple(sorted(labels.items()))

    def allocate(self, labels: dict[str, str]) -> int:
        key = self._key(labels)
        with self._lock:
            num = self._by_labels.get(key)
            if num is None:
                num = self._next
                self._next += 1
                self._by_labels[key] = num
            self._refs[num] = self._refs.get(num, 0) + 1
            return num

    def release(self, labels: dict[str, str]) -> Optional[int]:
        """Returns the identity number if this was the last reference
        (caller should delete the CiliumIdentity CR), else None."""
        key = self._key(labels)
        with self._lock:
            num = self._by_labels.get(key)
            if num is None:
                return None
            left = self._refs.get(num, 0) - 1
            if left > 0:
                self._refs[num] = left
                return None
            self._refs.pop(num, None)
            del self._by_labels[key]
            return num

    def lookup(self, labels: dict[str, str]) -> Optional[int]:
        with self._lock:
            return self._by_labels.get(self._key(labels))


def security_labels(ep: RetinaEndpoint) -> dict[str, str]:
    """Pod labels + namespace in Cilium's k8s: source prefix
    (ciliumEndpointsLabels, endpoint_controller.go:653)."""
    out = {f"k8s:{k}": v for k, v in ep.labels}
    out["k8s:io.kubernetes.pod.namespace"] = ep.namespace
    return out


class CiliumPublisher:
    """RetinaEndpoint upserts/deletes → CiliumEndpoint/CiliumIdentity CRs.

    Wire to the cache's pod pubsub topic (or call ``pod_upsert``/
    ``pod_delete`` directly). Writes are PUTs with create-on-404 — the
    reconciler owns these objects, so last-writer-wins is correct.
    """

    def __init__(self, client: KubeClient, node_name: str = ""):
        self._log = logger("ciliumpub")
        self.client = client
        self.node_name = node_name
        self.alloc = IdentityAllocator()
        # pod key -> (labels, identity) so delete can release exactly once.
        self._published: dict[str, tuple[dict[str, str], int]] = {}
        self._lock = threading.Lock()
        self._bootstrap_ceps: set[str] = set()
        self._bootstrap_cids: set[int] = set()

    # -- restart reconciliation -----------------------------------------
    def bootstrap(self) -> None:
        """LIST the CEP/CID objects a previous run left behind, so this
        run (a) numbers new identities above any existing CID — a restart
        must not reuse a live number for a different label set — and
        (b) can GC objects whose pod vanished while we were down."""
        try:
            with self.client.request(
                self.client.url(CILIUM_V2, "ciliumidentities")
            ) as r:
                for it in json.load(r).get("items", []):
                    try:
                        self._bootstrap_cids.add(
                            int(it.get("metadata", {}).get("name", "")))
                    except ValueError:  # noqa: RT101 — non-numeric CID name; skip entry
                        pass
            if self._bootstrap_cids:
                self.alloc._next = max(self.alloc._next,
                                       max(self._bootstrap_cids) + 1)
            with self.client.request(
                self.client.url(CILIUM_V2, "ciliumendpoints")
            ) as r:
                for it in json.load(r).get("items", []):
                    meta = it.get("metadata", {}) or {}
                    self._bootstrap_ceps.add(
                        f"{meta.get('namespace', 'default')}"
                        f"/{meta.get('name', '')}"
                    )
        except Exception as e:  # noqa: BLE001 — GC is best effort
            self._log.warning("bootstrap list failed: %s", e)

    def gc_stale(self) -> None:
        """After the first pod LIST has been published through: delete
        leftover CEPs with no live pod and CIDs no live pod references.
        Pod events arrive on an async pubsub, so a just-listed pod may
        still be in flight here — its upsert re-PUTs both objects, so a
        transient wrong delete converges back to correct state."""
        with self._lock:
            live_keys = set(self._published)
            live_ids = {num for _, num in self._published.values()}
            stale_ceps = self._bootstrap_ceps - live_keys
            stale_cids = self._bootstrap_cids - live_ids
            self._bootstrap_ceps = set()
            self._bootstrap_cids = set()
        for key in stale_ceps:
            ns, _, name = key.partition("/")
            self._delete(self.client.url(
                CILIUM_V2, "ciliumendpoints", namespace=ns,
                suffix=f"/{name}"))
        for num in stale_cids:
            self._delete(self.client.url(
                CILIUM_V2, "ciliumidentities", suffix=f"/{num}"))
        if stale_ceps or stale_cids:
            self._log.info("gc: removed %d stale endpoints, %d identities",
                           len(stale_ceps), len(stale_cids))

    # -- REST helpers --------------------------------------------------
    def _put(self, url: str, doc: dict) -> None:
        body = json.dumps(doc).encode()
        try:
            self.client.request(url, method="PUT", body=body).close()
        except Exception:  # noqa: BLE001 — 404/409 → try POST create
            create = url.rsplit("/", 1)[0]
            try:
                self.client.request(create, method="POST", body=body).close()
            except Exception as e:  # noqa: BLE001
                self._log.warning("write %s failed: %s", url, e)

    def _delete(self, url: str) -> None:
        try:
            self.client.request(url, method="DELETE").close()
        except Exception as e:  # noqa: BLE001
            self._log.warning("delete %s failed: %s", url, e)

    # -- reconcile (endpoint_controller.go:360 handlePodUpsert) --------
    def pod_upsert(self, ep: RetinaEndpoint) -> None:
        labels = security_labels(ep)
        with self._lock:
            prev = self._published.get(ep.key())
            if prev is not None and prev[0] == labels:
                released = None
                num = prev[1]
            else:
                num = self.alloc.allocate(labels)
                released = (
                    self.alloc.release(prev[0]) if prev is not None else None
                )
            self._published[ep.key()] = (labels, num)
        self._put(
            self.client.url(CILIUM_V2, "ciliumidentities",
                            suffix=f"/{num}"),
            {
                "apiVersion": "cilium.io/v2",
                "kind": "CiliumIdentity",
                "metadata": {"name": str(num)},
                "security-labels": labels,
            },
        )
        self._put(
            self.client.url(CILIUM_V2, "ciliumendpoints",
                            namespace=ep.namespace, suffix=f"/{ep.name}"),
            {
                "apiVersion": "cilium.io/v2",
                "kind": "CiliumEndpoint",
                "metadata": {"name": ep.name, "namespace": ep.namespace},
                "status": {
                    "identity": {
                        "id": num,
                        "labels": sorted(
                            f"{k}={v}" for k, v in labels.items()
                        ),
                    },
                    "networking": {
                        "addressing": [
                            {("ipv6" if ":" in ip else "ipv4"): ip}
                            for ip in ep.ips
                        ],
                        "node": ep.node or self.node_name,
                    },
                    "state": "ready",
                },
            },
        )
        if released is not None:
            self._delete(self.client.url(
                CILIUM_V2, "ciliumidentities", suffix=f"/{released}"))

    def pod_delete(self, key: str) -> None:
        """(handlePodDelete, endpoint_controller.go:332)."""
        with self._lock:
            prev = self._published.pop(key, None)
        if prev is None:
            return
        labels, _num = prev
        ns, _, name = key.partition("/")
        self._delete(self.client.url(
            CILIUM_V2, "ciliumendpoints", namespace=ns, suffix=f"/{name}"))
        released = self.alloc.release(labels)
        if released is not None:
            self._delete(self.client.url(
                CILIUM_V2, "ciliumidentities", suffix=f"/{released}"))

    # -- pubsub adapter ------------------------------------------------
    def on_pod_event(self, event: tuple) -> None:
        """Cache TOPIC_PODS payloads: ("updated"|"deleted", RetinaEndpoint)."""
        action, ep = event
        if action == "deleted":
            self.pod_delete(ep.key())
        else:
            self.pod_upsert(ep)


# ---------------------------------------------------------------------
def cep_to_endpoint(doc: dict) -> Optional[RetinaEndpoint]:
    """CiliumEndpoint → RetinaEndpoint (the consume direction).

    CEPs carry security labels, not pod annotations, so the resulting
    endpoint has an empty ``annotations`` tuple — per-pod
    retina.sh=observe opt-in is unavailable in cilium identity mode
    (the daemon warns; namespace-level opt-in still works)."""
    meta = doc.get("metadata", {}) or {}
    status = doc.get("status", {}) or {}
    net = status.get("networking", {}) or {}
    ips = tuple(
        a.get("ipv4") or a.get("ipv6", "")
        for a in net.get("addressing") or []
    )
    ips = tuple(ip for ip in ips if ip)
    if not ips or not meta.get("name"):
        return None
    raw = (status.get("identity", {}) or {}).get("labels") or []
    labels = {}
    for entry in raw:
        k, _, v = entry.partition("=")
        # Only genuine pod labels: Cilium CEPs also carry derived labels
        # (reserved:*, k8s:io.cilium.k8s.policy.*, namespace metadata) —
        # keeping those would make identity_source=cilium produce
        # different label sets than the core/v1 pod watcher.
        if not k.startswith("k8s:"):
            continue
        k = k[len("k8s:"):]
        if (k == "io.kubernetes.pod.namespace"
                or k.startswith("io.cilium.k8s.")
                or k.startswith("io.kubernetes.")):
            continue
        labels[k] = v
    return RetinaEndpoint(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        ips=ips,
        labels=tuple(sorted(labels.items())),
        node=net.get("node", ""),
    )


class CiliumWatcher:
    """list+watch ciliumendpoints → identity cache (the agent running on
    a Cilium cluster: identity from the foreign CNI's own objects)."""

    def __init__(self, cache, kubeconfig: str = "", namespace: str = "",
                 retry_s: float = 2.0,
                 list_scope: Optional[Callable[[], ContextManager]] = None):
        self._log = logger("ciliumwatch")
        self.cache = cache
        self.namespace = namespace
        self.retry_s = retry_s
        self.list_scope = list_scope
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.client = KubeClient(kubeconfig)

    def _on_cep(self, event: str, doc: dict) -> None:
        meta = doc.get("metadata", {}) or {}
        key = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
        if event == "DELETED":
            self.cache.delete_endpoint(key)
            return
        ep = cep_to_endpoint(doc)
        if ep is not None:
            self.cache.update_endpoint(ep)

    def _sync(self, metas: list[dict]) -> None:
        listed = meta_keys(metas)
        for key in self.cache.list_endpoint_keys():
            if key not in listed:
                self.cache.delete_endpoint(key)

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.client.list_watch,
            args=(CILIUM_V2, "ciliumendpoints"),
            kwargs={
                "on_event": self._on_cep,
                "stop": self._stop,
                "namespace": self.namespace,
                "retry_s": self.retry_s,
                "log": self._log,
                "on_sync": self._sync,
                "list_scope": self.list_scope,
            },
            name="ciliumwatch", daemon=True,
        )
        self._thread.start()
        self._log.info("ciliumendpoints watcher at %s", self.client.server)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
