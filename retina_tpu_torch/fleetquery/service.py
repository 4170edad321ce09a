"""Fleet-level federated range queries, ``GET /fleet/query`` (port of
retina_tpu/fleetquery/service.py).

Query parameters are the node tier's (``timetravel/query.py``): ``t0`` and
``t1``, a window-epoch range, or ``last=N``, plus ``k`` and ``fam``. The
answer is the node tier's document plus a ``coverage`` block::

    {"coverage": {"nodes_answered": 58, "nodes_total": 64,
                  "partial": true}, ...}

The latency contract is the node tier's: a handler thread never queues
behind a fold or a scatter. One gather and fold runs at a time (the flight
lock, taken without waiting); other requests are served from the TTL
result cache, stale if need be, or answered 503 ``busy``. Ranges that end
at or before the fleet's newest known epoch cannot change and key with a
zero edge token. Under SHEDDING no scatter starts: any cached result
serves (TTL ignored), everything else is ``busy``.

Fan-out: every node is asked once on a shared bounded pool; after
``fleetquery_hedge_delay_s`` of quiet, unfinished nodes get ONE hedged
duplicate request; whatever lands by ``fleetquery_node_deadline_s`` merges,
everyone else is counted in ``fleet_query_node_errors`` and the answer is
partial. A node whose seeds disagree with the majority's is left out of the
merge and counted (``seed_mismatch``).

The fold is split in two, as the reference's: each node folds its own span
(``LocalNodeClient``, or a node's own query tier) and answers one snapshot;
this service then folds the node snapshots on its device (``RangeFold``:
K8 and K9) and answers from the merged snapshot with the range extract
(K16's bits, K17's estimate, K10's re-count), the range decode (K15, K10)
and the top-k. With the aggregator's merged-epoch ring (``add_ring``) there
is no scatter: the ring's span is folded directly.
"""

from __future__ import annotations

import concurrent.futures
import json
import threading
import time
from collections import Counter
from typing import Any

import torch

from retina_tpu_torch.fleet.aggregator import format_key
from retina_tpu_torch.log import logger, rate_limited
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.runtime.overload import SHEDDING
from retina_tpu_torch.timetravel.fold import RangeFold, range_decode, range_extract, range_topk
from retina_tpu_torch.timetravel.ring import SnapshotRing

_JSON = "application/json"


def _reply(code: int, doc: dict) -> tuple[int, bytes, str]:
    return code, json.dumps(doc, default=str).encode(), _JSON


class LocalNodeClient:
    """A fleet member reachable in-process: one snapshot ring and the
    node-side span fold behind the node-client surface
    (``query(e0, e1, deadline_s)`` -> answer dict or None)::

        {"node": str, "epochs": [int, ...], "window_s": float,
         "seeds": {...}, "arrays": {name: ndarray} | None}

    ``arrays`` is the node's span-folded snapshot (None when the range is
    empty there). Spans are cached per ring generation (the ring's append
    count), so a repeat query is a dict hit. ``dead`` is the harness's kill
    switch (a lost node answers None); ``latency_s`` simulates the wire.
    """

    def __init__(self, name: str, ring: SnapshotRing, fold: RangeFold,
                 latency_s: float = 0.0) -> None:
        self.name = name
        self.ring = ring
        self.fold = fold
        self.latency_s = float(latency_s)
        self.dead = False
        self.calls = 0
        self._cache: dict[Any, dict] = {}

    def query(self, e0: int, e1: int, deadline_s: float) -> dict[str, Any] | None:
        self.calls += 1
        if self.dead:
            return None
        if self.latency_s > 0:
            time.sleep(self.latency_s)
        if self.dead:  # died while "on the wire"
            return None
        key = (int(e0), int(e1), self.ring.appended)
        hit = self._cache.get(key)
        if hit is not None:
            return dict(hit)
        slots = self.ring.select(e0, e1)
        if not slots:
            ans: dict[str, Any] = {"node": self.name, "epochs": [], "window_s": 0.0,
                                   "seeds": {}, "arrays": None}
        else:
            seeds = slots[0][3]
            arrays = (slots[0][1] if len(slots) == 1
                      else self.fold.fold([s[1] for s in slots], seeds))
            ans = {"node": self.name, "epochs": [s[0] for s in slots],
                   "window_s": slots[0][2], "seeds": dict(seeds), "arrays": arrays}
        self._cache[key] = ans
        while len(self._cache) > 32:
            self._cache.pop(next(iter(self._cache)))
        return dict(ans)


class FleetQueryService:
    """One per daemon; owns the scatter pool, the fold and the fleet-level
    result cache."""

    def __init__(self, cfg, overload=None, fold: RangeFold | None = None,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.log = logger("fleetquery")
        self._overload = overload
        self.fold = fold or RangeFold(device)
        self.device = self.fold.device
        self.clients: list[Any] = []
        self.ring: SnapshotRing | None = None  # the aggregator's epoch ring
        # (e0, e1, k, fam, edge) -> (monotonic time, result doc)
        self._cache: dict[Any, tuple[float, dict]] = {}
        self._cache_lock = threading.Lock()
        self._flight = threading.Lock()
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()
        # Live-edge token: bumped whenever new fleet epochs may exist
        # (note_append, or a gather that saw a newer epoch). Ranges ending
        # at or before the newest known epoch key with edge 0.
        self._edge = 0
        self._newest = -1
        self.queries = 0
        self.hedges = 0
        self.node_errors: dict[str, int] = {}

    # -- wiring ---------------------------------------------------------------
    def add_client(self, client: Any) -> None:
        """Register one fleet member (the node-client surface)."""
        self.clients.append(client)

    def add_ring(self, ring: SnapshotRing) -> None:
        """Aggregator-resident mode: no scatter, fold the merged-epoch ring
        directly (every epoch there is already cluster-merged)."""
        self.ring = ring

    def note_append(self) -> None:
        """New fleet epochs may have landed: invalidate live-edge keys."""
        self._edge += 1

    def attach(self, server) -> None:
        server.register_route("/fleet/query", self.handle)
        server.expose_var("fleetquery", self.stats)

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def stats(self) -> dict:
        return {
            "clients": len(self.clients),
            "dead_clients": sum(1 for c in self.clients if getattr(c, "dead", False)),
            "ring": self.ring.name if self.ring is not None else None,
            "queries": self.queries,
            "hedges": self.hedges,
            "node_errors": dict(self.node_errors),
            "newest_epoch": self._newest,
            "cache_entries": len(self._cache),
        }

    # -- the HTTP entry (handler threads; bounded latency) ----------------------
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
            if rate_limited("fleetquery"):
                self.log.exception("fleet query failed")
            return _reply(500, {"error": "internal"})
        finally:
            m.fleet_query_seconds.observe(time.monotonic() - t0)
            m.fleet_query_requests.labels(status=status).inc()
            self.queries += 1

    def _handle(self, q: dict) -> tuple[int, dict, str]:
        if not self.clients and self.ring is None:
            return 404, {"error": "no fleet sources attached"}, "bad_request"
        newest = self._newest
        if self.ring is not None and not self.clients:
            _, newest = self.ring.span()
        if "last" in q:
            if newest < 0:
                return 400, {"error": "fleet span unknown yet; use t0+t1"}, "bad_request"
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
        k = int(q.get("k", [self.cfg.fleetquery_topk])[0])
        fam = q.get("fam", ["flow"])[0]
        return self._query_cached(e0, e1, k, fam)

    # -- cached, single-flight gather and fold -----------------------------------
    def _query_cached(self, e0: int, e1: int, k: int, fam: str) -> tuple[int, dict, str]:
        ov = self._overload
        shedding = ov is not None and ov.state >= SHEDDING
        edge = self._edge if (self._newest < 0 or e1 > self._newest) else 0
        key = (e0, e1, k, fam, edge)
        ttl = float(self.cfg.fleetquery_cache_ttl_s)
        now = time.monotonic()
        with self._cache_lock:
            hit = self._cache.get(key)
        if hit is not None and (shedding or now - hit[0] < ttl):
            doc = dict(hit[1])
            if shedding and now - hit[0] >= ttl:
                doc["stale"] = True
            status = "stale" if doc.get("stale") else (
                "partial" if doc.get("coverage", {}).get("partial") else "ok")
            return 200, doc, status
        if shedding:
            # A cluster-wide fan-out is exactly the load this node must not
            # add while it drops its own: with nothing cached, back off.
            if hit is not None:
                doc = dict(hit[1])
                doc["stale"] = True
                return 200, doc, "stale"
            return 503, {"error": "busy", "retry": True}, "busy"
        if not self._flight.acquire(blocking=False):
            if hit is not None:
                doc = dict(hit[1])
                doc["stale"] = True
                return 200, doc, "stale"
            return 503, {"error": "busy", "retry": True}, "busy"
        try:
            code, doc, status = self._query(e0, e1, k, fam)
            if code == 200:
                with self._cache_lock:
                    self._cache[key] = (time.monotonic(), doc)
                    while len(self._cache) > 128:
                        self._cache.pop(next(iter(self._cache)))
            return code, doc, status
        finally:
            self._flight.release()

    # -- the federated query (single flight) --------------------------------------
    def _query(self, e0: int, e1: int, k: int, fam: str) -> tuple[int, dict, str]:
        m = get_metrics()
        if self.clients:
            results = self._scatter(e0, e1)
            total = len(self.clients)
        else:
            slots = self.ring.select(e0, e1)
            results = [{
                "node": self.ring.name,
                "epochs": [s[0] for s in slots],
                "window_s": slots[0][2] if slots else 0.0,
                "seeds": dict(slots[0][3]) if slots else {},
                "arrays": (None if not slots else slots[0][1] if len(slots) == 1
                           else self.fold.fold([s[1] for s in slots], slots[0][3])),
            }]
            total = 1
        answered = len(results)
        m.fleet_query_nodes_answered.set(answered)
        coverage = {"nodes_answered": answered, "nodes_total": total,
                    "partial": 0 < answered < total}
        m.fleet_query_coverage.set(answered / total if total else 0.0)
        doc: dict[str, Any] = {"t0": e0, "t1": e1, "coverage": coverage}
        if answered == 0:
            # A scatter nobody answered is an outage, not an empty range.
            doc["error"] = "no nodes answered"
            return 503, doc, "error"

        # Seed agreement by majority (ties to the larger serialized seed
        # set): a misconfigured node's arrays would corrupt the fold, and
        # mid-rotation the fold follows the seed set most nodes hold.
        tally = Counter(tuple(sorted(r["seeds"].items()))
                        for r in results if r["arrays"] is not None)
        winner = max(tally, key=lambda s: (tally[s], s), default=())
        seeds = dict(winner)
        parts: list[dict] = []
        epochs: set[int] = set()
        for r in results:
            if r["arrays"] is None:
                continue
            if r["seeds"] != seeds:
                self._count_node_error("seed_mismatch")
                coverage["nodes_answered"] -= 1
                coverage["partial"] = True
                continue
            parts.append(r["arrays"])
            epochs.update(int(e) for e in r["epochs"])
        if not parts:
            doc["windows"] = 0
            doc["empty"] = True
            return 200, doc, "empty"
        newest_seen = max(epochs)
        if newest_seen > self._newest:
            self._newest = newest_seen
            self._edge += 1
        doc["windows"] = len(epochs)
        doc["epochs"] = sorted(epochs)

        merged = self._fold_many(parts, seeds)
        extras = range_extract(merged, seeds, self.device)
        dec = range_decode(merged, seeds, self.device)
        keys, counts = range_topk(merged, seeds, fam=fam, k=k, est=extras.get(f"{fam}_est"),
                                  device=self.device)
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
        return 200, doc, "partial" if coverage["partial"] else "ok"

    def _fold_many(self, parts: list[dict], seeds: dict) -> dict:
        """The node snapshots folded into one, in one ``RangeFold.fold``:
        one launch of K8 and one of K9 whatever the number of parts (both
        take any depth). The reference folds in chunks of 8
        (``FOLD_CHUNK``) only to bound its jit signatures; the fold is
        associative, so one flat fold gives the same arrays (the f32
        entropy sums exactly while a bucket stays below 2^24)."""
        return parts[0] if len(parts) == 1 else self.fold.fold(parts, seeds)

    def _count_node_error(self, reason: str) -> None:
        get_metrics().fleet_query_node_errors.labels(reason=reason).inc()
        self.node_errors[reason] = self.node_errors.get(reason, 0) + 1

    # -- scatter with a per-node deadline and one hedged retry -----------------------
    def _ensure_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=max(2, int(self.cfg.fleetquery_fanout)),
                    thread_name_prefix="fleetquery")
            return self._pool

    def _scatter(self, e0: int, e1: int) -> list[dict]:
        m = get_metrics()
        deadline_s = float(self.cfg.fleetquery_node_deadline_s)
        hedge_s = float(self.cfg.fleetquery_hedge_delay_s)
        pool = self._ensure_pool()
        t0 = time.monotonic()
        first = {c.name: pool.submit(c.query, e0, e1, deadline_s) for c in self.clients}
        # After hedge_s of quiet, unfinished nodes get one duplicate request
        # (a tail is usually one slow replica, not a dead one).
        concurrent.futures.wait(list(first.values()), timeout=min(hedge_s, deadline_s))
        hedged: dict[str, concurrent.futures.Future] = {}
        for c in self.clients:
            if not first[c.name].done():
                hedged[c.name] = pool.submit(c.query, e0, e1, deadline_s)
                self.hedges += 1
                m.fleet_query_hedges.inc()
        results: list[dict] = []
        for c in self.clients:
            res, reason = None, None
            budget = deadline_s - (time.monotonic() - t0)
            try:
                res = first[c.name].result(timeout=max(0.0, budget))
            except concurrent.futures.TimeoutError:
                reason = "timeout"
            except Exception:
                reason = "error"
            if res is None and c.name in hedged:
                # The hedge left hedge_s late: the same grace past the
                # primary deadline.
                budget = (deadline_s + hedge_s) - (time.monotonic() - t0)
                try:
                    res = hedged[c.name].result(timeout=max(0.0, budget))
                    reason = None if res is not None else reason
                except concurrent.futures.TimeoutError:
                    reason = reason or "timeout"
                except Exception:
                    reason = reason or "error"
            if res is not None:
                results.append(res)
            else:
                self._count_node_error(reason or "dead")
        return results
