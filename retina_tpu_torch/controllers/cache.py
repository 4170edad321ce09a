"""Node-local identity cache with dense pod-index allocation (a copy of
retina_tpu/controllers/cache.py).

Reference analog: pkg/controllers/cache/cache.go — maps pod-key →
RetinaEndpoint (:17-66 structure, :68-195 getters, :196-441 updaters). The
agent's addition: every endpoint gets a **stable dense pod index** (index
0 = unknown/world) — the integer the device-side IdentityMap maps IPs to,
and the row index of the pipeline's per-pod counter rectangles. Freed
indices are recycled so the index space stays ≤ n_pods (the dense tables'
static height).

The port keeps the pod side the scrape surface reads. The reference's IP
index, services, nodes, namespace counts, annotated namespaces and the
object events it publishes on the bus come with the daemon that watches
them.
"""

from __future__ import annotations

import threading
from typing import Optional

from retina_tpu_torch.common import RetinaEndpoint
from retina_tpu_torch.log import logger


class Cache:
    def __init__(self, max_pods: int = 1 << 12):
        self._log = logger("cache")
        self._lock = threading.RLock()
        self._max_pods = max_pods
        self._eps: dict[str, RetinaEndpoint] = {}
        self._key_to_index: dict[str, int] = {}
        self._free_indices: list[int] = []
        self._next_index = 1  # 0 reserved for unknown/world

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
            else:
                idx = self._key_to_index.get(key, 0)
            self._eps[key] = ep
        return idx

    def delete_endpoint(self, key: str) -> None:
        with self._lock:
            if self._eps.pop(key, None) is None:
                return
            idx = self._key_to_index.pop(key, None)
            if idx:
                self._free_indices.append(idx)

    # -- getters (cache.go:68-195) ------------------------------------
    def get_endpoint(self, key: str) -> Optional[RetinaEndpoint]:
        with self._lock:
            return self._eps.get(key)

    def get_index(self, key: str) -> int:
        with self._lock:
            return self._key_to_index.get(key, 0)

    def index_label_map(self) -> dict[int, RetinaEndpoint]:
        """{pod index → endpoint} for scrape-time label attachment."""
        with self._lock:
            return {
                idx: self._eps[key]
                for key, idx in self._key_to_index.items()
                if key in self._eps
            }
