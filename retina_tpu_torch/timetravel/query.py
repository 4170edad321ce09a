"""Range queries over snapshot rings (port of retina_tpu/timetravel/query.py).

``QueryService._query`` folds the slots of one ring in ``[e0, e1)``
(``RangeFold``: K8, K9) and returns the reference's result document: the
family's top-k counted by the span CMS (K10), the distinct-flow
cardinality, the entropy bits and, with invertible state, the decoded
heavy keys and their sources. ``query_range`` is the in-process call of
the capture loop. One fold runs at a time.

The HTTP route (``attach``, ``handle``), its result cache and the
overload gating wait for the port's daemon.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from retina_tpu_torch.fleet.aggregator import format_key
from retina_tpu_torch.timetravel.fold import RangeFold, range_decode, range_extract, range_topk
from retina_tpu_torch.timetravel.ring import SnapshotRing


class QueryService:
    """Owns the fold and the rings it queries."""

    def __init__(self, cfg, fold: RangeFold | None = None,
                 device: torch.device | str | None = None) -> None:
        self.cfg = cfg
        self.fold = fold or RangeFold(device)
        self.device = self.fold.device
        self.rings: dict[str, SnapshotRing] = {}
        self._flight = threading.Lock()
        self.queries = 0

    def add_ring(self, ring: SnapshotRing) -> None:
        self.rings[ring.name] = ring

    def _query(self, ring: SnapshotRing, e0: int, e1: int, k: int, fam: str) -> dict:
        """The result document of one range query (single flight)."""
        slots = ring.select(e0, e1)
        doc: dict[str, Any] = {
            "ring": ring.name, "t0": e0, "t1": e1,
            "windows": len(slots),
            "epochs": [s[0] for s in slots],
        }
        if not slots:
            doc["empty"] = True
            return doc
        seeds = slots[0][3]
        with self._flight:
            merged = self.fold.fold([s[1] for s in slots], seeds)
            extras = range_extract(merged, seeds, self.device)
            dec = range_decode(merged, seeds, self.device)
        keys, counts = range_topk(merged, seeds, fam=fam, k=k, est=extras.get(f"{fam}_est"),
                                  device=self.device)
        self.queries += 1
        doc["topk"] = {
            "family": fam,
            "keys": [{"key": format_key(row), "count": int(c)} for row, c in zip(keys, counts)],
        }
        doc["cardinality"] = extras.get("cardinality", 0.0)
        doc["entropy_bits"] = extras.get("entropy_bits", {})
        if dec is not None:
            srcs, pkts = dec["sources"]
            doc["decode"] = {
                "n_keys": int(len(dec["keys"])),
                "keys": [format_key(row) for row in dec["keys"][:k]],
                "est": [int(x) for x in dec["est"][:k]],
                "sources": [{"src_ip": int(s), "packets": int(p)}
                            for s, p in zip(srcs[:k], pkts[:k])],
            }
        return doc

    def query_range(self, ring_name: str, e0: int, e1: int) -> dict[str, Any] | None:
        """Fold + decode for in-process callers; waits for a running fold."""
        ring = self.rings.get(ring_name)
        if ring is None:
            return None
        slots = ring.select(e0, e1)
        if not slots:
            return None
        seeds = slots[0][3]
        with self._flight:
            merged = self.fold.fold([s[1] for s in slots], seeds)
        return {
            "merged": merged, "seeds": seeds,
            "windows": len(slots),
            "decode": range_decode(merged, seeds, self.device),
        }
