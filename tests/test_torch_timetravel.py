"""The port's snapshot ring, range fold, range queries and query service
against the reference's (CPU).

The slots are real window exports: the same traffic is stepped through the
port's Telemetry at a small cut of INVERTIBLE_CONFIG, and each window's
``fleet_export`` (held to the reference's in tests/test_torch_telemetry.py)
is read back as host numpy. The reference and the port then fold and query
the same slots. Rules: u32 arrays, keys, counts and estimates exactly; the
entropy histograms exactly (integer counts below 2^24); the HLL cardinality
and the entropy bits within rtol 1e-5 (float32 sums and logarithms in two
libraries).
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch

from retina_tpu.config import Config as JConfig
from retina_tpu.timetravel.fold import RangeFold as JRangeFold
from retina_tpu.timetravel.fold import range_cardinality as jrange_cardinality
from retina_tpu.timetravel.fold import range_decode as jrange_decode
from retina_tpu.timetravel.fold import range_entropy as jrange_entropy
from retina_tpu.timetravel.fold import range_extract as jrange_extract
from retina_tpu.timetravel.fold import range_topk as jrange_topk
from retina_tpu.timetravel.query import QueryService as JQueryService
from retina_tpu.timetravel.ring import SnapshotRing as JSnapshotRing
from retina_tpu_torch.config import Config
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig
from retina_tpu_torch.parallel.telemetry import Telemetry
from retina_tpu_torch.timetravel.fold import (
    RangeFold,
    host_arrays,
    range_cardinality,
    range_decode,
    range_entropy,
    range_extract,
    range_topk,
)
from retina_tpu_torch.timetravel.query import QueryService
from retina_tpu_torch.timetravel.ring import SnapshotRing
from retina_tpu_torch.u32 import from_numpy, to_numpy
from test_torch_pipeline import API, B, PODS, SMALL, SMALL_CUTS, clock, traffic

CUTS = {"invertible": SMALL_CUTS["invertible"], "no_invertible": SMALL_CUTS["deployed"]}


def window_slots(cut: str, n_windows: int = 5, seed: int = 40):
    """[(epoch, host arrays, window_s, seeds)] of n windows of traffic."""
    tel = Telemetry(PipelineConfig(**CUTS[cut]), device="cpu")
    ident = IdentityMap.build_host(PODS, n_slots=1 << 8, device="cpu")
    st = tel.init_state()
    slots = []
    for w in range(n_windows):
        for i, rec in enumerate(traffic(seed + w, 2)):
            st, _ = tel.step(st, from_numpy(rec, "cpu"), B, clock(w, i), ident,
                             apiserver_ip=API)
        slots.append((100 + w, host_arrays(tel.fleet_export(st)), 1.0, tel.fleet_seeds(st)))
        st, _ = tel.end_window(st)
    return slots


@pytest.fixture(scope="module", params=sorted(CUTS))
def slots(request):
    return request.param, window_slots(request.param)


def compare_arrays(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, ref in want.items():
        ref = np.asarray(ref)
        assert got[name].dtype == ref.dtype and got[name].shape == ref.shape, name
        np.testing.assert_array_equal(got[name], ref, err_msg=name)


def compare_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


# -- the ring ---------------------------------------------------------------------


def test_ring_capacity_eviction_select_span_and_stats():
    ring, ref = SnapshotRing(3), JSnapshotRing(3)
    assert ring.span() == ref.span() == (-1, -1)
    for e in (10, 11, 12, 13, 15):
        for r in (ring, ref):
            r.append_host(e, {"totals": np.full(8, e, np.uint32)}, 1.0, {"flow": 1})
    assert ring.span() == ref.span() == (12, 15)
    assert [s[0] for s in ring.select(0, 100)] == [12, 13, 15]
    assert [s[0] for s in ring.select(13, 15)] == [s[0] for s in ref.select(13, 15)] == [13]
    assert len(ring) == 3
    got, want = ring.stats(), ref.stats()
    assert got == want
    assert (got["appended"], got["evicted"]) == (5, 2)


def test_ring_worker_reads_offers_back_and_a_full_queue_drops():
    ring = SnapshotRing(4, queue_size=2)
    export = {"totals": torch.arange(8, dtype=torch.int32),
              "entropy": torch.ones((3, 4)), "hll_flows": torch.full((1, 4), -1,
                                                                      dtype=torch.int32)}
    # Not started: the queue fills and further offers drop without blocking.
    assert ring.offer(1, export, 1.0, {"flow": 1}) and ring.offer(2, export, 1.0, {})
    assert not ring.offer(3, export, 1.0, {})
    assert ring.dropped == 1 and len(ring) == 0
    ring.start()
    assert ring.drain(5.0)
    assert [s[0] for s in ring.select(0, 10)] == [1, 2]
    epoch, arrays, window_s, seeds = ring.select(1, 2)[0]
    assert (epoch, window_s, seeds) == (1, 1.0, {"flow": 1})
    assert arrays["totals"].dtype == np.uint32 and arrays["entropy"].dtype == np.float32
    assert int(arrays["hll_flows"][0, 0]) == 0xFFFFFFFF
    ring.stop()
    assert not ring.offer(4, export, 1.0, {}) and ring.dropped == 2


def test_ring_counts_every_offer_under_contention():
    """More offering threads than cores against the worker: every offer is
    appended or counted as dropped, and the ring keeps its capacity."""
    ring = SnapshotRing(8, queue_size=3)
    ring.start()
    n_threads, per_thread = 16, 50
    accepted = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def offer(t):
            ok = 0
            for i in range(per_thread):
                ok += ring.offer(t * per_thread + i, {"totals": np.zeros(8, np.uint32)}, 1.0, {})
            accepted.append(ok)

        threads = [threading.Thread(target=offer, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        assert ring.drain(10.0)
    finally:
        sys.setswitchinterval(interval)
        ring.stop()
    total = n_threads * per_thread
    assert ring.appended == sum(accepted) and ring.appended + ring.dropped == total
    assert len(ring) == min(8, ring.appended) and ring.evicted == max(0, ring.appended - 8)
    assert ring.last_error is None


def test_offered_export_is_unchanged_by_the_window_close():
    kw = dict(batch_capacity=1 << 10, n_pods=64, cms_width=1 << 10, topk_slots=1 << 6,
              hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 8,
              identity_slots=1 << 8, invertible_width=1 << 8, invertible_hi_width=1 << 5)
    eng = SketchEngine(Config(heavy_keys_source="invertible", timetravel_enabled=True,
                              timetravel_ring_windows=4, **kw), device="cpu")
    eng.update_identities(PODS)
    for w in range(6):
        eng.step_records(traffic(60 + w, 1)[0], now_s=200 + w)
        before = eng.telemetry.fleet_export(eng.state)
        out = eng.close_window(epoch=w)
        assert "export" not in out  # fleet off: the ring alone takes the export
        assert float(eng.state.entropy.counts.sum()) == 0.0  # end_window zeroed it
        assert eng.timetravel_ring.drain(5.0)
        _, arrays, window_s, seeds = eng.timetravel_ring.select(w, w + 1)[0]
        assert arrays["entropy"].sum() > 0
        compare_arrays(arrays, host_arrays(before))
        assert seeds == Telemetry.fleet_seeds(eng.state) and window_s == 1.0
    stats = eng.timetravel_ring.stats()
    assert (stats["depth"], stats["appended"], stats["evicted"]) == (4, 6, 2)
    eng.stop()


# -- the fold and the range queries --------------------------------------------------


@pytest.mark.parametrize("span", [slice(0, 1), slice(1, 4), slice(0, 5)],
                         ids=["one", "three", "all"])
def test_range_fold_and_queries_match_reference(slots, span):
    cut, all_slots = slots
    sel = all_slots[span]
    seeds = sel[0][3]
    arrays = [s[1] for s in sel]
    kops.reset_launch_counts()
    merged = RangeFold("cpu").fold(arrays, seeds)
    want = JRangeFold().fold(arrays, seeds)
    compare_arrays(merged, want)
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}  # CPU: plain

    got, ref = range_extract(merged, seeds, "cpu"), jrange_extract(want, seeds)
    assert set(got) == set(ref)
    assert got["cardinality"] == pytest.approx(ref["cardinality"], rel=1e-5)
    compare_close(got["entropy_bits"], ref["entropy_bits"])
    for fam in ("flow", "svc", "dns"):
        np.testing.assert_array_equal(got[f"{fam}_est"], np.asarray(ref[f"{fam}_est"]))
        assert got[f"{fam}_est"].dtype == np.uint32
        for kw in ({}, {"est": got[f"{fam}_est"]}):
            gk, gc = range_topk(merged, seeds, fam=fam, k=8, device="cpu", **kw)
            rk, rc = jrange_topk(want, seeds, fam=fam, k=8, **kw)
            np.testing.assert_array_equal(gk, rk)
            np.testing.assert_array_equal(gc, rc)
            assert gc.dtype == rc.dtype
    assert range_cardinality(merged, seeds, "cpu") == pytest.approx(
        jrange_cardinality(want, seeds), rel=1e-5)
    compare_close(range_entropy(merged, seeds, "cpu"), jrange_entropy(want, seeds))

    got, ref = range_decode(merged, seeds, "cpu"), jrange_decode(want, seeds)
    if cut == "no_invertible":
        assert got is None and ref is None
        return
    for key in ("keys", "est", "tier"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        assert got[key].dtype == ref[key].dtype, key
    for g, r in zip(got["sources"], ref["sources"]):
        np.testing.assert_array_equal(g, r)
    assert len(got["keys"]) > 0
    # The decoded keys as candidates of the top-k.
    gk, gc = range_topk(merged, seeds, k=16, candidates=got["keys"], device="cpu")
    rk, rc = jrange_topk(want, seeds, k=16, candidates=ref["keys"])
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_array_equal(gc, rc)


def test_empty_fold_raises_and_missing_arrays_are_skipped():
    with pytest.raises(ValueError, match="empty"):
        RangeFold("cpu").fold([], {})
    assert range_extract({}, {}, "cpu") == {}
    assert range_decode({"flow_cms": np.zeros((4, 8), np.uint32)}, {}, "cpu") is None
    assert range_cardinality({}, {}, "cpu") == 0.0 and range_entropy({}, {}, "cpu") == {}
    keys, counts = range_topk({}, {}, device="cpu")
    assert keys.shape == (0, 0) and counts.shape == (0,)


# -- the query service ------------------------------------------------------------------


def _doc_equal(got: dict, want: dict) -> None:
    """Documents equal, the float answers within rtol 1e-5."""
    assert set(got) == set(want)
    for key in want:
        if key == "cardinality":
            assert got[key] == pytest.approx(want[key], rel=1e-5)
        elif key == "entropy_bits":
            compare_close(got[key], want[key])
        else:
            assert got[key] == want[key], key


def test_query_service_document_matches_reference(slots):
    cut, all_slots = slots
    jcfg, cfg = JConfig(), Config()
    ref, port = JQueryService(jcfg), QueryService(cfg, device="cpu")
    jring, ring = JSnapshotRing(4), SnapshotRing(4)
    for s in all_slots:  # five windows into four slots: one evicted
        jring.append_host(*s)
        ring.append_host(*s)
    ref.add_ring(jring)
    port.add_ring(ring)
    for e0, e1, k, fam in ((104, 105, 5, "flow"), (101, 105, 32, "flow"), (0, 200, 3, "svc"),
                           (102, 104, 4, "dns"), (300, 400, 5, "flow")):
        got = port._query(ring, e0, e1, k, fam)
        want = ref._query(jring, e0, e1, k, fam)
        _doc_equal(got, want)
        if e0 < 300:
            assert got["windows"] == min(e1, 105) - max(e0, 101)
            assert got["topk"]["keys"]
            assert ("decode" in got) == (cut == "invertible")
    got = port.query_range("engine", 102, 105)
    want = ref.query_range("engine", 102, 105)
    compare_arrays(got["merged"], want["merged"])
    assert got["windows"] == want["windows"] == 3 and got["seeds"] == want["seeds"]
    assert (got["decode"] is None) == (want["decode"] is None)
    assert port.query_range("nope", 0, 1) is None and port.query_range("engine", 0, 1) is None


def test_query_service_runs_one_fold_at_a_time():
    slots = window_slots("no_invertible", n_windows=2)
    svc = QueryService(Config(), device="cpu")
    ring = SnapshotRing(4)
    for s in slots:
        ring.append_host(*s)
    svc.add_ring(ring)
    inside, peak = [0], [0]
    real_fold = svc.fold.fold

    def counting_fold(*a):
        inside[0] += 1
        peak[0] = max(peak[0], inside[0])
        try:
            return real_fold(*a)
        finally:
            inside[0] -= 1

    svc.fold.fold = counting_fold
    threads = [threading.Thread(target=svc._query, args=(ring, 0, 200, 4, "flow"))
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert peak[0] == 1 and svc.queries == 4


def test_port_ring_slots_fold_with_reference_slots():
    """A slot read back by the port's ring worker equals the host arrays
    the reference's ring would hold for the same export."""
    tel = Telemetry(PipelineConfig(**SMALL), device="cpu")
    ident = IdentityMap.build_host(PODS, n_slots=1 << 8, device="cpu")
    st, _ = tel.step(tel.init_state(), from_numpy(traffic(70, 1)[0], "cpu"), B, 1, ident)
    ring = SnapshotRing(2)
    ring.start()
    ring.offer(7, tel.fleet_export(st), 1.0, tel.fleet_seeds(st))
    assert ring.drain(5.0)
    ring.stop()
    _, arrays, _, _ = ring.select(7, 8)[0]
    export = tel.fleet_export(st)
    for name, a in arrays.items():
        np.testing.assert_array_equal(a, to_numpy(export[name]))
