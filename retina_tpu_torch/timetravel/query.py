"""Range queries over snapshot rings (port of retina_tpu/timetravel/query.py).

Served as ``GET /timetravel/query`` on the agent's HTTP server
(``attach``: ``Server.register_route``). Query parameters: ``ring``
(default ``engine``); ``t0`` and ``t1``, the window-epoch range
``[t0, t1)``, or ``last=N`` for the newest N windows; ``k`` (default
``cfg.timetravel_query_topk``); ``fam`` (flow, svc or dns; default flow).
An unknown ring is a 404, a missing or empty range a 400, an empty ring a
200 with ``"empty": true``.

``QueryService._query`` folds the slots of one ring in ``[e0, e1)``
(``RangeFold``: K8, K9) and returns the reference's result document: the
family's top-k counted by the span CMS (K10), the distinct-flow
cardinality (K17), the entropy bits (K16) and, with invertible state, the
decoded heavy keys and their sources (K15). ``query_range`` is the
in-process call of the capture loop.

The latency contract is the reference's: a handler thread never queues
behind a fold. One fold runs at a time (``_query_cached`` takes the flight
lock without waiting); every other request is served from the TTL result
cache (stale if need be) or answered 503 ``busy``. A range that ends
before the ring's newest slot cannot change, so only a range over the live
edge keys its cache entry by the ring's append count. Under overload
SHEDDING any cached result serves, marked ``stale`` once past its TTL. The
cache keeps at most 128 keys.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any

import torch

from retina_tpu_torch.fleet.aggregator import format_key
from retina_tpu_torch.log import logger, rate_limited
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.runtime.overload import SHEDDING
from retina_tpu_torch.timetravel.fold import RangeFold, range_decode, range_extract, range_topk
from retina_tpu_torch.timetravel.ring import SnapshotRing

_JSON = "application/json"
CACHE_KEYS = 128  # result-cache bound


def _reply(code: int, doc: dict) -> tuple[int, bytes, str]:
    return code, json.dumps(doc, default=str).encode(), _JSON


class QueryService:
    """Owns the fold, the rings it queries and the result cache."""

    def __init__(self, cfg, overload=None, fold: RangeFold | None = None,
                 device: torch.device | str | None = None) -> None:
        self.cfg = cfg
        self.log = logger("timetravel.query")
        self._overload = overload
        self.fold = fold or RangeFold(device)
        self.device = self.fold.device
        self.rings: dict[str, SnapshotRing] = {}
        # (ring, e0, e1, k, fam, appended) -> (monotonic time, result doc)
        self._cache: dict[Any, tuple[float, dict]] = {}
        self._cache_lock = threading.Lock()
        # Reentrant: _query_cached holds it around _query, which takes it too.
        self._flight = threading.RLock()
        self.queries = 0

    def add_ring(self, ring: SnapshotRing) -> None:
        self.rings[ring.name] = ring

    def attach(self, server) -> None:
        server.register_route("/timetravel/query", self.handle)
        server.expose_var("timetravel", lambda: {n: r.stats() for n, r in self.rings.items()})

    # -- the HTTP entry (handler threads; bounded latency) -------------------
    def handle(self, q: dict) -> tuple[int, bytes, str]:
        """(status, JSON body, content type) of one request; ``q`` is the
        parsed query string (name -> list of values)."""
        m = get_metrics()
        t0 = time.monotonic()
        status = "error"
        try:
            code, doc, status = self._handle(q)
            return _reply(code, doc)
        except Exception:
            if rate_limited("timetravel.query"):
                self.log.exception("range query failed")
            return _reply(500, {"error": "internal"})
        finally:
            m.timetravel_query_seconds.observe(time.monotonic() - t0)
            m.timetravel_queries.labels(status=status).inc()

    def _handle(self, q: dict) -> tuple[int, dict, str]:
        ring_name = q.get("ring", ["engine"])[0]
        ring = self.rings.get(ring_name)
        if ring is None:
            return 404, {"error": f"unknown ring {ring_name!r}",
                         "rings": sorted(self.rings)}, "bad_request"
        oldest, newest = ring.span()
        if newest < 0:
            return 200, {"ring": ring_name, "windows": 0, "empty": True}, "empty"
        if "last" in q:
            n = max(1, int(q["last"][0]))
            e0, e1 = newest - n + 1, newest + 1
        else:
            try:
                e0 = int(q["t0"][0])
                e1 = int(q["t1"][0])
            except (KeyError, ValueError, IndexError):
                return 400, {"error": "need t0+t1 (window epochs) or last=N"}, "bad_request"
        if e1 <= e0:
            return 400, {"error": "empty range: t1 <= t0"}, "bad_request"
        k = int(q.get("k", [self.cfg.timetravel_query_topk])[0])
        fam = q.get("fam", ["flow"])[0]
        return self._query_cached(ring, e0, e1, k, fam)

    def _query_cached(self, ring: SnapshotRing, e0: int, e1: int, k: int, fam: str,
                      ) -> tuple[int, dict, str]:
        """The cached, single-flight fold: (status, document, outcome)."""
        ov = self._overload
        shedding = ov is not None and ov.state >= SHEDDING
        _, newest = ring.span()
        edge = ring.appended if e1 > newest else 0
        key = (ring.name, e0, e1, k, fam, edge)
        ttl = float(self.cfg.timetravel_query_cache_ttl_s)
        now = time.monotonic()
        with self._cache_lock:
            hit = self._cache.get(key)
        if hit is not None and (shedding or now - hit[0] < ttl):
            doc = dict(hit[1])
            if shedding and now - hit[0] >= ttl:
                doc["stale"] = True
            return 200, doc, "stale" if doc.get("stale") else "ok"
        if not self._flight.acquire(blocking=False):
            # A fold is running: serve what the cache has rather than wait.
            if hit is not None:
                doc = dict(hit[1])
                doc["stale"] = True
                return 200, doc, "stale"
            return 503, {"error": "busy", "retry": True}, "busy"
        try:
            doc = self._query(ring, e0, e1, k, fam)
            with self._cache_lock:
                self._cache[key] = (time.monotonic(), doc)
                while len(self._cache) > CACHE_KEYS:
                    self._cache.pop(next(iter(self._cache)))
            return 200, doc, "ok"
        finally:
            self._flight.release()

    # -- the range query (single flight) -------------------------------------
    def _query(self, ring: SnapshotRing, e0: int, e1: int, k: int, fam: str) -> dict:
        """The result document of one range query (single flight)."""
        slots = ring.select(e0, e1)
        get_metrics().timetravel_query_windows.set(len(slots))
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
