"""The port's fleet query plane against the reference's (CPU).

Every case of the reference's ``tests/test_fleetquery.py`` runs on both
packages over the same node rings (``LocalNodeClient`` on both sides, the
same slot arrays): the port's ``FleetQueryService.handle`` must answer with
the reference's status and document (floats within ``pytest.approx``'s
default, the reference's own tolerance), and the node counters (calls,
hedges, node errors) must agree. The cases: the scatter against a flat
fold, the one-call fold against the reference's chunked ``_fold_many``, a
dead node, every node dead, seed-mismatch quarantine, an empty range, the
immutable cache, TTL expiry, the live edge, single flight and busy,
SHEDDING, hedging, the ring mode, bad requests and the node client's span
cache and kill switch.

Hedging is checked by counts with an injected slow client whose first call
waits for its hedge, never by wall-clock latency.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

import retina_tpu.fleetquery.service as jfqs
from retina_tpu.config import Config as JConfig
from retina_tpu.fleet.dryrun import INV_SEEDS
from retina_tpu.fleetquery.service import FleetQueryService as JService
from retina_tpu.fleetquery.service import LocalNodeClient as JClient
from retina_tpu.runtime.overload import NOMINAL, SHEDDING
from retina_tpu.timetravel.fold import RangeFold as JFold
from retina_tpu.timetravel.ring import SnapshotRing as JRing
from retina_tpu_torch import exporter, metrics
from retina_tpu_torch.config import Config
from retina_tpu_torch.fleetquery import FleetQueryService, LocalNodeClient
from retina_tpu_torch.timetravel.fold import RangeFold, range_extract, range_topk
from retina_tpu_torch.timetravel.ring import SnapshotRing
from test_fleetquery import _slot

FOLD = RangeFold("cpu")
JFOLD = JFold()
E0 = 100
WAIT_S = 30.0


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


class _Ov:
    state = NOMINAL


def _cfg(**kw):
    kw.setdefault("fleetquery_enabled", True)
    kw.setdefault("fleetquery_node_deadline_s", 5.0)
    kw.setdefault("fleetquery_hedge_delay_s", 1.0)
    kw.setdefault("fleetquery_fanout", 4)
    kw.setdefault("fleetquery_cache_ttl_s", 60.0)
    return Config(**kw), JConfig(**kw)


class Side:
    """One package's service, its overload stand-in and its node clients."""

    def __init__(self, svc, ov) -> None:
        self.svc, self.ov = svc, ov

    @property
    def clients(self):
        return self.svc.clients

    def handle(self, q: dict) -> tuple[int, dict]:
        code, body, ctype = self.svc.handle(q)
        assert ctype == "application/json"
        return code, json.loads(body)


def fleets(n_nodes=3, n_windows=4, seed=11, client=(LocalNodeClient, JClient), **cfg_kw):
    """The port's and the reference's fleet over the same slots: every node
    holds the same windows (the merged answer has a closed form)."""
    cfg, jcfg = _cfg(**cfg_kw)
    rng = np.random.default_rng(seed)
    slots = [_slot(rng) for _ in range(n_windows)]
    sides = []
    for svc_cls, ring_cls, cl_cls, fold, c in ((FleetQueryService, SnapshotRing, client[0], FOLD,
                                                cfg),
                                               (JService, JRing, client[1], JFOLD, jcfg)):
        ov = _Ov()
        svc = svc_cls(c, overload=ov, fold=fold)
        for i in range(n_nodes):
            ring = ring_cls(16, name=f"n{i}")
            for e, arr in enumerate(slots):
                ring.append_host(E0 + e, arr, 1.0, INV_SEEDS)
            svc.add_client(cl_cls(f"n{i}", ring, fold))
        sides.append(Side(svc, ov))
    return sides[0], sides[1], slots


def same_doc(a, b, what: str = "doc") -> None:
    """Equal documents: floats within pytest.approx's default."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (what, a, b)
        for k in b:
            same_doc(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), (what, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same_doc(x, y, f"{what}[{i}]")
    elif isinstance(b, float):
        assert a == pytest.approx(b), what
    else:
        assert a == b, what


def both(port: Side, ref: Side, q: dict) -> tuple[int, dict]:
    """One request on both sides: equal status and document."""
    code, doc = port.handle(q)
    jcode, jdoc = ref.handle(q)
    assert code == jcode, (q, doc, jdoc)
    same_doc(doc, jdoc)
    return code, doc


def calls(side: Side) -> list[int]:
    return [c.calls for c in side.clients]


SPAN = {"t0": [str(E0)], "t1": [str(E0 + 4)]}


# -- federation -----------------------------------------------------------------------


def test_scatter_merge_equals_flat_fold_and_the_reference():
    port, ref, slots = fleets()
    code, doc = both(port, ref, SPAN)
    assert code == 200 and doc["windows"] == 4 and doc["epochs"] == [E0 + i for i in range(4)]
    assert doc["coverage"] == {"nodes_answered": 3, "nodes_total": 3, "partial": False}
    span = FOLD.fold(slots, INV_SEEDS)
    merged = FOLD.fold([span] * 3, INV_SEEDS)
    ex = range_extract(merged, INV_SEEDS, "cpu")
    k = int(port.svc.cfg.fleetquery_topk)
    keys, counts = range_topk(merged, INV_SEEDS, fam="flow", k=k, est=ex.get("flow_est"),
                              device="cpu")
    assert doc["cardinality"] == pytest.approx(ex["cardinality"])
    assert [e["count"] for e in doc["topk"]["keys"]] == [int(c) for c in counts]
    assert doc["decode"]["n_keys"] > 0


@pytest.mark.parametrize("n_parts,chunk", [(5, 2), (9, 8), (17, 8), (2, 8)])
def test_one_fold_equals_the_reference_chunked_fold(monkeypatch, n_parts, chunk):
    """The port folds every answered node in one call; the reference in
    chunks of FOLD_CHUNK. Associativity makes them equal, the f32 entropy
    included while every bucket stays below 2^24."""
    monkeypatch.setattr(jfqs, "FOLD_CHUNK", chunk)
    rng = np.random.default_rng(23 + n_parts)
    parts = [_slot(rng) for _ in range(n_parts)]
    cfg, jcfg = _cfg()
    got = FleetQueryService(cfg, fold=FOLD)._fold_many([dict(p) for p in parts], INV_SEEDS)
    want = JService(jcfg, fold=JFOLD)._fold_many([dict(p) for p in parts], INV_SEEDS)
    assert set(got) == set(want)
    assert float(np.asarray(want["entropy"]).max()) < 2 ** 24
    for name in want:
        w = np.asarray(want[name])
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_dead_node_partial_coverage():
    port, ref, _ = fleets()
    port.clients[1].dead = ref.clients[1].dead = True
    code, doc = both(port, ref, SPAN)
    assert code == 200 and doc["windows"] == 4
    assert doc["coverage"] == {"nodes_answered": 2, "nodes_total": 3, "partial": True}
    assert port.svc.node_errors == ref.svc.node_errors == {"dead": 1}


def test_all_nodes_dead_is_an_outage_not_empty():
    port, ref, _ = fleets()
    for c in port.clients + ref.clients:
        c.dead = True
    code, doc = both(port, ref, SPAN)
    assert code == 503 and doc["error"] == "no nodes answered"
    assert doc["coverage"]["nodes_answered"] == 0


def test_seed_mismatch_node_is_quarantined():
    port, ref, slots = fleets()
    for side, ring_cls in ((port, SnapshotRing), (ref, JRing)):
        bad = ring_cls(16, name="bad-seeds")
        for e, arr in enumerate(slots):
            bad.append_host(E0 + e, arr, 1.0, dict(INV_SEEDS, flow=999))
        side.clients[1].ring = bad
    code, doc = both(port, ref, SPAN)
    assert code == 200
    assert doc["coverage"] == {"nodes_answered": 2, "nodes_total": 3, "partial": True}
    assert port.svc.node_errors == ref.svc.node_errors == {"seed_mismatch": 1}


def test_empty_range_answers_empty():
    port, ref, _ = fleets()
    code, doc = both(port, ref, {"t0": [str(E0 + 50)], "t1": [str(E0 + 60)]})
    assert code == 200 and doc["empty"] and doc["windows"] == 0
    assert doc["coverage"]["nodes_answered"] == 3


# -- the bounded-latency contract ----------------------------------------------------


def test_immutable_range_serves_from_cache():
    port, ref, _ = fleets()
    both(port, ref, SPAN)  # learns the fleet's newest epoch
    q = {"t0": [str(E0)], "t1": [str(E0 + 3)]}
    assert both(port, ref, q)[0] == 200
    before = calls(port), calls(ref)
    code, doc = both(port, ref, q)
    assert code == 200 and "stale" not in doc
    assert (calls(port), calls(ref)) == before


def test_ttl_expiry_rescatters():
    port, ref, _ = fleets(fleetquery_cache_ttl_s=0.05)
    both(port, ref, SPAN)
    before = calls(port), calls(ref)
    time.sleep(0.1)
    assert both(port, ref, SPAN)[0] == 200
    for side, b0 in zip((port, ref), before):  # every node asked again (a cold fold
        assert all(c > b for c, b in zip(calls(side), b0))  # may draw a hedge too)


def test_live_edge_invalidation_on_note_append():
    port, ref, _ = fleets()
    both(port, ref, SPAN)
    q = {"t0": [str(E0)], "t1": [str(E0 + 5)]}  # past the newest epoch
    assert both(port, ref, q)[1]["windows"] == 4
    before = calls(port), calls(ref)
    assert both(port, ref, q)[1]["windows"] == 4  # cached
    assert (calls(port), calls(ref)) == before
    rng = np.random.default_rng(99)
    new = _slot(rng)
    for side in (port, ref):
        for c in side.clients:
            c.ring.append_host(E0 + 4, new, 1.0, INV_SEEDS)
        side.svc.note_append()
    code, doc = both(port, ref, q)
    assert code == 200 and doc["windows"] == 5
    for side, b0 in zip((port, ref), before):
        assert all(c > b for c, b in zip(calls(side), b0))


def test_busy_single_flight_and_serve_stale():
    port, ref, _ = fleets(fleetquery_cache_ttl_s=0.01)
    q = {"t0": [str(E0)], "t1": [str(E0 + 3)]}
    for side in (port, ref):
        assert side.svc._flight.acquire(blocking=False)
    try:
        code, doc = both(port, ref, q)
        assert code == 503 and doc == {"error": "busy", "retry": True}
    finally:
        port.svc._flight.release()
        ref.svc._flight.release()
    both(port, ref, SPAN)
    both(port, ref, q)  # primes the immutable key
    time.sleep(0.05)  # stale
    for side in (port, ref):
        assert side.svc._flight.acquire(blocking=False)
    try:
        before = calls(port), calls(ref)
        code, doc = both(port, ref, q)
        assert code == 200 and doc["stale"] is True
        assert (calls(port), calls(ref)) == before
    finally:
        port.svc._flight.release()
        ref.svc._flight.release()


def test_shedding_never_scatters():
    port, ref, _ = fleets(fleetquery_cache_ttl_s=0.01)
    both(port, ref, SPAN)
    q = {"t0": [str(E0)], "t1": [str(E0 + 3)]}
    both(port, ref, q)  # primed while NOMINAL
    time.sleep(0.05)  # past the TTL
    port.ov.state = ref.ov.state = SHEDDING
    before = calls(port), calls(ref)
    code, doc = both(port, ref, q)
    assert code == 200 and doc["stale"] is True
    code, doc = both(port, ref, {"t0": [str(E0 + 1)], "t1": [str(E0 + 3)]})
    assert code == 503 and doc["error"] == "busy"
    assert (calls(port), calls(ref)) == before  # no fan-out


def _slow(base):
    """A node client whose first call waits (up to WAIT_S) for its second:
    the hedge. So the primary cannot answer before the hedge is sent,
    whatever the machine's load."""

    class Slow(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.slow = self.name == "n1"
            self.hedge_seen = threading.Event()

        def query(self, e0, e1, deadline_s):
            if self.slow:
                if self.calls == 0:
                    self.calls += 1
                    self.hedge_seen.wait(WAIT_S)
                    self.calls -= 1
                else:
                    self.hedge_seen.set()
            return super().query(e0, e1, deadline_s)

    return Slow


def test_hedged_retry_fires_once_for_the_slow_node():
    port, ref, _ = fleets(client=(_slow(LocalNodeClient), _slow(JClient)),
                          fleetquery_hedge_delay_s=0.05, fleetquery_node_deadline_s=WAIT_S)
    # The fast nodes answer SPAN from their span caches, so only n1 can
    # still be unfinished after the hedge delay, however slow a fold is
    # on a loaded machine. The warm-up calls are not the scatter's.
    for side in (port, ref):
        for c in side.clients:
            if c.name != "n1":
                c.query(E0, E0 + 4, WAIT_S)
                c.calls = 0
    code, doc = both(port, ref, SPAN)
    assert code == 200 and doc["coverage"]["partial"] is False
    assert port.svc.hedges == ref.svc.hedges == 1
    assert calls(port) == calls(ref) == [1, 2, 1]  # the primary and its hedge
    assert not port.svc.node_errors and not ref.svc.node_errors


# -- the aggregator's ring -------------------------------------------------------------


def test_ring_mode_folds_merged_epochs():
    cfg, jcfg = _cfg()
    rng = np.random.default_rng(31)
    slots = [_slot(rng) for _ in range(3)]
    sides = []
    for svc_cls, ring_cls, fold, c in ((FleetQueryService, SnapshotRing, FOLD, cfg),
                                       (JService, JRing, JFOLD, jcfg)):
        svc = svc_cls(c, overload=_Ov(), fold=fold)
        ring = ring_cls(8, name="fleet-epochs")
        for e, arr in enumerate(slots):
            ring.append_host(200 + e, arr, 1.0, INV_SEEDS)
        svc.add_ring(ring)
        sides.append(Side(svc, None))
    port, ref = sides
    for q in ({"last": ["2"]}, {"last": ["1"]}, {"t0": ["199"], "t1": ["203"]},
              {"last": ["2"], "fam": ["svc"], "k": ["5"]}):
        code, doc = both(port, ref, q)
        assert code == 200
    code, doc = both(port, ref, {"last": ["2"]})
    assert doc["epochs"] == [201, 202] and doc["topk"]["keys"]
    assert doc["coverage"] == {"nodes_answered": 1, "nodes_total": 1, "partial": False}
    empty = Side(FleetQueryService(cfg, fold=FOLD), None)
    empty.svc.add_ring(SnapshotRing(4, name="fleet-epochs"))
    jempty = Side(JService(jcfg, fold=JFOLD), None)
    jempty.svc.add_ring(JRing(4, name="fleet-epochs"))
    assert both(empty, jempty, {"last": ["1"]})[0] == 400  # span unknown yet


# -- request validation ------------------------------------------------------------------


def test_bad_requests():
    port, ref, _ = fleets()
    for q in ({}, {"t0": ["5"], "t1": ["5"]}, {"t0": ["x"], "t1": ["9"]}, {"last": ["2"]}):
        assert both(port, ref, q)[0] == 400, q
    assert both(port, ref, SPAN)[0] == 200
    assert both(port, ref, {"last": ["2"]})[0] == 200
    cfg, jcfg = _cfg()
    bare, jbare = Side(FleetQueryService(cfg, fold=FOLD), None), Side(JService(jcfg, fold=JFOLD),
                                                                      None)
    assert both(bare, jbare, {"last": ["1"]})[0] == 404
    assert port.svc.stats() == ref.svc.stats()


# -- the node client -----------------------------------------------------------------------


def test_local_node_client_span_cache_and_kill_switch():
    rng = np.random.default_rng(41)
    slots = [_slot(rng) for _ in range(3)]
    extra = _slot(rng)
    answers = []
    for ring_cls, cl_cls, fold in ((SnapshotRing, LocalNodeClient, FOLD),
                                   (JRing, JClient, JFOLD)):
        ring = ring_cls(8, name="n0")
        for e, arr in enumerate(slots):
            ring.append_host(E0 + e, arr, 1.0, INV_SEEDS)
        c = cl_cls("n0", ring, fold)
        one = c.query(E0, E0 + 1, 5.0)
        assert one["epochs"] == [E0] and one["window_s"] == 1.0
        assert one["arrays"] is slots[0]  # a one-slot span ships the slot
        r1 = c.query(E0, E0 + 3, 5.0)
        r2 = c.query(E0, E0 + 3, 5.0)
        assert c.calls == 3 and r1["arrays"] is r2["arrays"]  # the span cache
        ring.append_host(E0 + 3, extra, 1.0, INV_SEEDS)
        r3 = c.query(E0, E0 + 3, 5.0)
        assert r3["epochs"] == [E0, E0 + 1, E0 + 2] and r3["arrays"] is not r1["arrays"]
        c.dead = True
        assert c.query(E0, E0 + 3, 5.0) is None and c.calls == 5
        answers.append(r3)
    got, want = answers
    assert (got["node"], got["epochs"], got["window_s"], got["seeds"]) == (
        want["node"], want["epochs"], want["window_s"], want["seeds"])
    for name, a in want["arrays"].items():
        np.testing.assert_array_equal(got["arrays"][name], np.asarray(a), err_msg=name)
