"""Node-local identity cache with dense pod-index allocation (port of
retina_tpu/controllers/cache.py).

Reference analog: pkg/controllers/cache/cache.go — maps pod-key →
RetinaEndpoint, services, nodes, IP→key indexes, namespace counts, and
publishes object events on pubsub (:17-66 structure, :68-195 getters,
:196-441 updaters). The TPU-specific addition: every endpoint gets a
**stable dense pod index** (index 0 = unknown/world) — the integer the
device-side IdentityMap maps IPs to, and the row index of the pipeline's
per-pod counter rectangles. Freed indices are recycled so the index space
stays ≤ n_pods (the dense tables' static height). The reference's key
listings for informer resyncs come with the cluster watchers (ROADMAP §1
item 7).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from retina_tpu_torch.common import (
    RetinaEndpoint,
    RetinaNode,
    RetinaSvc,
    TOPIC_NAMESPACES,
    TOPIC_PODS,
    TOPIC_SERVICES,
)
from retina_tpu_torch.events.schema import ip_to_u32
from retina_tpu_torch.log import logger
from retina_tpu_torch.pubsub import PubSub

EventType = str  # "added" | "updated" | "deleted"


class Cache:
    def __init__(self, pubsub: Optional[PubSub] = None, max_pods: int = 1 << 12):
        self._log = logger("cache")
        self._ps = pubsub
        self._lock = threading.RLock()
        self._max_pods = max_pods
        self._eps: dict[str, RetinaEndpoint] = {}
        self._svcs: dict[str, RetinaSvc] = {}
        self._nodes: dict[str, RetinaNode] = {}
        self._ip_to_key: dict[str, str] = {}
        self._ns_counts: dict[str, int] = {}
        self._key_to_index: dict[str, int] = {}
        self._free_indices: list[int] = []
        self._next_index = 1  # 0 reserved for unknown/world
        self._dirty_cbs: list[Callable[[], None]] = []
        # Namespaces carrying the retina.sh=observe annotation — the
        # annotation-driven pod-level opt-in set
        # (cache.AddAnnotatedNamespace, namespace_controller.go:54-62).
        self._annotated_ns: set[str] = set()

    # -- dirty notification (identity table rebuild trigger) ----------
    def on_identity_change(self, cb: Callable[[], None]) -> None:
        self._dirty_cbs.append(cb)

    def _notify(self) -> None:
        for cb in self._dirty_cbs:
            try:
                cb()
            except Exception:
                self._log.exception("identity-change callback failed")

    # -- updaters (cache.go:196-441) ----------------------------------
    def update_endpoint(self, ep: RetinaEndpoint) -> int:
        """Upsert; returns the endpoint's dense pod index."""
        with self._lock:
            key = ep.key()
            prev = self._eps.get(key)
            if prev is None:
                if self._free_indices:
                    idx = self._free_indices.pop()
                elif self._next_index < self._max_pods:
                    idx = self._next_index
                    self._next_index += 1
                else:
                    self._log.warning(
                        "pod index space exhausted (%d); %s mapped to 0",
                        self._max_pods, key,
                    )
                    idx = 0
                if idx:
                    self._key_to_index[key] = idx
                self._ns_counts[ep.namespace] = (
                    self._ns_counts.get(ep.namespace, 0) + 1
                )
            else:
                idx = self._key_to_index.get(key, 0)
                for ip in prev.ips:
                    if self._ip_to_key.get(ip) == key:
                        del self._ip_to_key[ip]
            self._eps[key] = ep
            for ip in ep.ips:
                self._ip_to_key[ip] = key
            ev = "updated" if prev else "added"
        if self._ps:
            self._ps.publish(TOPIC_PODS, (ev, ep))
        self._notify()
        return idx

    def delete_endpoint(self, key: str) -> None:
        with self._lock:
            ep = self._eps.pop(key, None)
            if ep is None:
                return
            for ip in ep.ips:
                if self._ip_to_key.get(ip) == key:
                    del self._ip_to_key[ip]
            idx = self._key_to_index.pop(key, None)
            if idx:
                self._free_indices.append(idx)
            n = self._ns_counts.get(ep.namespace, 0) - 1
            if n <= 0:
                self._ns_counts.pop(ep.namespace, None)
            else:
                self._ns_counts[ep.namespace] = n
        if self._ps:
            self._ps.publish(TOPIC_PODS, ("deleted", ep))
        self._notify()

    def update_service(self, svc: RetinaSvc) -> None:
        with self._lock:
            self._svcs[svc.key()] = svc
            if svc.cluster_ip:
                self._ip_to_key[svc.cluster_ip] = svc.key()
        if self._ps:
            self._ps.publish(TOPIC_SERVICES, ("updated", svc))

    def delete_service(self, key: str) -> None:
        with self._lock:
            svc = self._svcs.pop(key, None)
            if svc and svc.cluster_ip:
                self._ip_to_key.pop(svc.cluster_ip, None)

    def update_node(self, node: RetinaNode) -> None:
        with self._lock:
            self._nodes[node.name] = node

    def list_nodes(self) -> list[RetinaNode]:
        with self._lock:
            return list(self._nodes.values())

    def endpoints_in_namespace(self, ns: str) -> list[RetinaEndpoint]:
        with self._lock:
            return [ep for ep in self._eps.values()
                    if ep.namespace == ns]

    # -- annotated namespaces (namespace_controller.go analog) --------
    def set_annotated_namespace(self, ns: str, annotated: bool) -> None:
        with self._lock:
            if annotated == (ns in self._annotated_ns):
                return
            if annotated:
                self._annotated_ns.add(ns)
            else:
                self._annotated_ns.discard(ns)
        if self._ps:
            self._ps.publish(
                TOPIC_NAMESPACES,
                ("annotated" if annotated else "unannotated", ns),
            )

    def annotated_namespaces(self) -> set[str]:
        with self._lock:
            return set(self._annotated_ns)

    # -- getters (cache.go:68-195) ------------------------------------
    def get_obj_by_ip(self, ip: str):
        with self._lock:
            key = self._ip_to_key.get(ip)
            if key is None:
                return None
            return self._eps.get(key) or self._svcs.get(key)

    def get_endpoint(self, key: str) -> Optional[RetinaEndpoint]:
        with self._lock:
            return self._eps.get(key)

    def get_index(self, key: str) -> int:
        with self._lock:
            return self._key_to_index.get(key, 0)

    def endpoint_by_index(self, idx: int) -> Optional[RetinaEndpoint]:
        with self._lock:
            for k, i in self._key_to_index.items():
                if i == idx:
                    return self._eps.get(k)
        return None

    def namespace_count(self, ns: str) -> int:
        with self._lock:
            return self._ns_counts.get(ns, 0)

    def pod_count(self) -> int:
        with self._lock:
            return len(self._eps)

    # -- device identity table source ---------------------------------
    def ip_index_map(self) -> dict[int, int]:
        """{ipv4 u32 → pod index} for IdentityMap.build_host."""
        out: dict[int, int] = {}
        with self._lock:
            for key, idx in self._key_to_index.items():
                ep = self._eps.get(key)
                if ep is None or idx == 0:
                    continue
                for ip in ep.ips:
                    try:
                        out[ip_to_u32(ip)] = idx
                    except (ValueError, AttributeError):
                        continue  # IPv6/hostnames: not device-mapped yet
        return out

    def index_label_map(self) -> dict[int, RetinaEndpoint]:
        """{pod index → endpoint} for scrape-time label attachment."""
        with self._lock:
            return {
                idx: self._eps[key]
                for key, idx in self._key_to_index.items()
                if key in self._eps
            }
