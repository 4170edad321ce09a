"""The port's runtime lanes against the JAX reference and against their own
synchronous replay (CPU).

- The overload controller (``runtime/overload.py``): the row tiers, the
  priority class and the 1-in-k sampler (its phase carried across calls)
  equal the reference's on the same rows and k; the state machine moves
  through the same states on the same injected signals and clock.
- The feed handoff (``parallel/feed.py``): ``TransferQueue`` and
  ``TransferMux`` deliver a scripted sequence in the reference's order,
  with its backpressure and control lane; the worker pool flushes every
  staged block on stop and counts what it cannot stage.
- The device proxy (``utils/device_proxy.py``) runs calls from several
  threads in order, runs re-entrant calls directly and delivers
  exceptions; staging buffers are reused only once their copy is done.
- The engine's lanes (``SketchEngine.start``) with 1 and with 4 feed
  workers over its ``QueueSink`` equal the synchronous replay of their own
  dispatch log (the batches, ``now_s``, ``n_raw`` and the closes as the
  dispatch thread issued them): state exactly (floats within rtol 1e-5),
  the published windows alike. Thread timing decides the quantum
  boundaries, so an independent run cannot be held exactly.
- An idle close against the reference engine's ``_close_window``; the
  snapshot cache; ``conntrack_gc``, ``top_*``, ``_hk_account``,
  ``add_observer`` and ``ReplayProvider(engine=)``; ``pcap_replay``
  batches; ``cms_update_jit`` against the reference.

Every test that starts a thread stops it and joins with a timeout.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retina_tpu.config import Config as JConfig
from retina_tpu.engine import SketchEngine as JEngine
from retina_tpu.events.synthetic import TrafficGen as JTrafficGen
from retina_tpu.ops.countmin import CountMinSketch as JCMS
from retina_tpu.ops.countmin import cms_update_jit as jcms_update_jit
from retina_tpu.parallel import feed as jfeed
from retina_tpu.runtime import overload as jov
from retina_tpu_torch.capture.providers import ReplayProvider
from retina_tpu_torch.config import Config
from retina_tpu_torch.engine import SketchEngine, zero_window
from retina_tpu_torch.events.schema import F, NUM_FIELDS
from retina_tpu_torch.events.synthetic import TrafficGen
from retina_tpu_torch.ops.countmin import CountMinSketch, cms_update_jit
from retina_tpu_torch.parallel import feed
from retina_tpu_torch.parallel.telemetry import topk_from_snapshot
from retina_tpu_torch.runtime import overload as ov
from retina_tpu_torch.sources.pcapdecode import decode_pcap_bytes
from retina_tpu_torch.u32 import from_numpy, to_numpy
from retina_tpu_torch.utils.device_proxy import DeviceProxy, PinnedStaging, to_host
from test_torch_engine import _configs, _engines, escalating
from retina_tpu_torch.convert import state_to_numpy
from test_torch_pipeline import PODS, compare_states, leaf_names

JOIN_S = 30.0  # bound on every join of a thread a test starts


# -- the overload controller ------------------------------------------------------


def _rows(seed: int, n: int = 3000) -> np.ndarray:
    """Combined-looking rows: packet weights from 1 to past the exempt
    threshold, latency probes, and pods 1-15 in the priority prefix."""
    rec = TrafficGen(n_flows=500, n_pods=48, seed=seed).batch(n)
    rng = np.random.default_rng(seed)
    rec[:, F.PACKETS] = rng.integers(1, 100, n).astype(np.uint32)
    rec[::37, F.TSVAL] = 5
    rec[5::41, F.TSECR] = 7
    return rec


TIER_CASES = {
    "default": {},
    "priority": dict(overload_priority_ip_mask=0xFFFFFFF0, overload_priority_ip_match=0x0A000000),
    "exempt_all": dict(overload_exempt_packets=0),
    "k3": dict(overload_sample_k=3, overload_exempt_packets=30),
}


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_row_tiers_and_priority_class_match_reference(case):
    jcfg, cfg = JConfig(**TIER_CASES[case]), Config(**TIER_CASES[case])
    rec = _rows(1)
    np.testing.assert_array_equal(ov.row_tiers(rec, cfg), jov.row_tiers(rec, jcfg))
    mask, match = cfg.overload_priority_ip_mask, cfg.overload_priority_ip_match
    np.testing.assert_array_equal(
        ov.priority_class_np(rec[:, F.SRC_IP], rec[:, F.DST_IP], mask, match),
        jov.priority_class_np(rec[:, F.SRC_IP], rec[:, F.DST_IP], mask, match))


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_sample_rows_and_its_phase_match_reference(case):
    """SAMPLING pinned on both; three calls carry the rotating phase; the
    window annotation after them, and NOMINAL's pass-through."""
    jcfg, cfg = JConfig(**TIER_CASES[case]), Config(**TIER_CASES[case])
    jctl, ctl = jov.OverloadController(jcfg), ov.OverloadController(cfg)
    for c in (jctl, ctl):
        c._state = ov.SAMPLING
    for seed, n in ((2, 3000), (3, 7), (4, 1500)):
        rec = _rows(seed, n)
        (jkept, jk), (kept, k) = jctl.sample_rows(rec), ctl.sample_rows(rec)
        assert k == jk == cfg.overload_sample_k
        np.testing.assert_array_equal(kept, jkept)
        assert ctl._phase == jctl._phase
    assert ctl.window_annotation() == jctl.window_annotation()
    for c in (jctl, ctl):
        c._state = ov.NOMINAL
    rec = _rows(5)
    assert ctl.sample_rows(rec)[1] == jctl.sample_rows(rec)[1] == 1
    assert ctl.window_annotation() == jctl.window_annotation()


def test_sampling_keeps_exempt_rows_whole_and_one_in_k_of_the_rest():
    """The Horvitz-Thompson rule of runtime/overload.py over a run of calls:
    exempt weight kept whole, exactly one non-exempt row in k kept in offer
    order, and the estimate within four standard deviations."""
    cfg = Config()
    ctl = ov.OverloadController(cfg)
    ctl._state = ov.SAMPLING
    k = cfg.overload_sample_k
    offered_exempt = offered_rest = kept_exempt = kept_rest = n_rest = 0
    sq = 0
    for seed in range(6, 12):
        rec = _rows(seed, 2000)
        exempt = ov.row_tiers(rec, cfg) > ov.TIER_BACKGROUND
        kept, got_k = ctl.sample_rows(rec)
        kex = ov.row_tiers(kept, cfg) > ov.TIER_BACKGROUND
        pk, kpk = rec[:, F.PACKETS].astype(np.int64), kept[:, F.PACKETS].astype(np.int64)
        offered_exempt += int(pk[exempt].sum())
        offered_rest += int(pk[~exempt].sum())
        kept_exempt += int(kpk[kex].sum())
        kept_rest += int(kpk[~kex].sum())
        n_rest += int((~exempt).sum())
        sq += int((kpk[~kex] ** 2).sum())
        assert got_k == k
    assert kept_exempt == offered_exempt
    assert ctl._phase == n_rest % k
    est = kept_exempt + k * kept_rest
    assert abs(est - (offered_exempt + offered_rest)) <= 4 * np.sqrt((k - 1) * k * sq)


def test_controller_moves_through_the_references_states():
    jcfg, cfg = JConfig(overload_tick_s=0.05), Config(overload_tick_s=0.05)
    sig = {"v": 0.0}
    jctl = jov.OverloadController(jcfg, lambda: {"staging": sig["v"]})
    ctl = ov.OverloadController(cfg, lambda: {"staging": sig["v"]})
    t = 100.0
    script = [(0.1, 0.2), (0.1, 0.8), (0.1, 0.95), (0.6, 0.95), (0.6, 0.95), (0.6, 0.95),
              (0.1, 0.3), (0.1, 0.6), (0.9, 0.3), (1.1, 0.3), (0.5, 0.3), (0.6, 0.3),
              (0.01, 0.99), (0.1, 0.99), (2.1, 0.1), (2.1, 0.1), (2.1, 0.1), (2.1, 0.1)]
    seen = []
    for dt, v in script:
        t += dt
        sig["v"] = v
        got, want = ctl.tick(t), jctl.tick(t)
        assert got == want, (t, v)
        assert ctl.shed_stages() == jctl.shed_stages()
        assert ctl.sample_k == jctl.sample_k
        assert ctl.shed_active("dns") == jctl.shed_active("dns")
        seen.append(ov.STATE_NAMES[got])
    assert set(seen) == set(ov.STATE_NAMES)
    assert ctl.stats()["transitions"] == jctl.stats()["transitions"]
    ctl2 = ov.OverloadController(dataclasses.replace(cfg, overload_enabled=False),
                                 lambda: {"x": 1.0})
    assert ctl2.tick(1e6) == ov.NOMINAL


def test_a_failing_signal_reads_as_no_pressure():
    def boom():
        raise RuntimeError("signal")

    ctl = ov.OverloadController(Config(), boom)
    assert ctl.tick(50.0) == ov.NOMINAL and ctl.counters["signal_errors"] == 1


@pytest.mark.parametrize("order", [["dns"], ["labels", "dns"], ["dns", "dns"], ["bogus"], []])
def test_validate_shed_order_agrees_with_reference(order):
    try:
        want = jov.validate_shed_order(order)
    except ValueError:
        with pytest.raises(ValueError):
            ov.validate_shed_order(order)
    else:
        assert ov.validate_shed_order(order) == want


# -- the feed handoff ---------------------------------------------------------------


def _mux_script(mod):
    """A scripted run of one mux over two queues: steps, ticks that
    overtake them, a full queue that refuses a dead consumer, and the
    sentinel after the queues drain."""
    data = threading.Event()
    qs = [mod.TransferQueue(2, data), mod.TransferQueue(2, data)]
    mux = mod.TransferMux(qs, data)
    out = []
    assert qs[0].put("a0") and qs[0].put("a1")
    assert qs[1].put("b0")
    refused = qs[0].put("a2", alive=lambda: False)  # full, consumer dead
    mux.put_ctl(("window", 1))
    out.append(mux.get(timeout=0.1))
    out.append(mux.get(timeout=0.1))
    mux.put_ctl(None)
    mux.put_ctl(("window", 2))  # behind the sentinel: after the drain
    assert qs[1].put("b1")
    while True:
        item = mux.get(timeout=0.1)
        out.append(item)
        if item is None:
            break
    try:
        mux.get(timeout=0.01)
    except Exception as e:  # queue.Empty once drained
        out.append(type(e).__name__)
    return out, refused


def test_transfer_mux_order_backpressure_and_control_lane_match_reference():
    got, refused = _mux_script(feed)
    want, jrefused = _mux_script(jfeed)
    assert got == want and refused is jrefused is False
    assert got[0] == ("window", 1)


def test_transfer_queue_blocks_until_the_consumer_frees_a_slot():
    data = threading.Event()
    tq = feed.TransferQueue(1, data)
    mux = feed.TransferMux([tq], data)
    assert tq.put(1)
    got = []
    t = threading.Thread(target=lambda: got.append(tq.put(2)))
    t.start()
    time.sleep(0.05)
    assert t.is_alive() and not got  # waits for space
    assert mux.get(timeout=1.0) == 1
    t.join(JOIN_S)
    assert not t.is_alive() and got == [True] and mux.get(timeout=1.0) == 2
    assert tq.wait_s > 0.0


def test_worker_pool_flushes_every_staged_block_and_counts_what_it_cannot_stage():
    built, dropped = [], []

    def build(blocks, n_raw, now_s):
        built.append(n_raw)
        return [("step", b, now_s, len(b)) for b in blocks]

    # Flushes only at stop: nothing frees staging before it.
    pool = feed.FeedWorkerPool(n_workers=3, quantum=1000, staging_blocks=2,
                               flush_interval_s=60.0, flush_max_age_s=60.0,
                               build_steps=build, drop=dropped.append)
    blocks = [np.zeros((n, NUM_FIELDS), np.uint32) for n in (30, 40, 50, 60, 70, 80)]
    pool.start()
    assert [pool.stage(b) for b in blocks] == [True] * 6
    assert not pool.stage(blocks[0])  # every worker's staging is full
    pool.count_drop(30)
    assert pool.max_staging_fill() == 1.0
    pool.stop(timeout=JOIN_S)
    assert not any(w.is_alive() for w in pool.workers)
    got = []
    while True:
        try:
            got.append(pool.mux.get(timeout=0.1))
        except queue.Empty:
            break
    assert sorted(len(it[1]) for it in got) == [30, 40, 50, 60, 70, 80]
    assert sum(built) == 330 and not dropped
    st = pool.stats()
    assert (st["dropped_blocks"], st["dropped_events"]) == (1, 30)
    assert sum(w["events"] for w in st["per_worker"]) == 330


# -- the device proxy ---------------------------------------------------------------


def test_proxy_runs_calls_from_several_threads_in_order():
    proxy = DeviceProxy("cpu")
    seen: list = []
    errors = []

    def caller(i):
        try:
            for j in range(50):
                proxy.submit(seen.append, (i, j))
                if j % 10 == 9:
                    assert proxy.run(lambda: threading.current_thread().name).startswith(
                        "device-proxy")
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not errors and not any(t.is_alive() for t in threads)
    assert proxy.fence(timeout=JOIN_S)
    for i in range(4):
        assert [j for k, j in seen if k == i] == list(range(50))


def test_proxy_runs_reentrant_calls_directly_and_delivers_exceptions():
    proxy = DeviceProxy("cpu")
    assert proxy.run(lambda: proxy.run(lambda: proxy.on_thread())) is True
    assert proxy.run(lambda x, y=0: x + y, 2, y=3) == 5
    with pytest.raises(ZeroDivisionError):
        proxy.run(lambda: 1 // 0)
    proxy.submit(lambda: 1 // 0)  # fire-and-forget: counted, never raised
    assert proxy.fence(timeout=JOIN_S) and proxy.errors == 1
    t = torch.arange(4)
    copy = proxy.run(to_host, {"t": t})
    t += 1  # the copy is the tensor as it was
    assert copy.result()["t"].tolist() == [0, 1, 2, 3]


def test_staging_reuses_a_buffer_only_after_its_copy_completed():
    class Event:
        def __init__(self):
            self.done = False

        def query(self):
            return self.done

    staging = PinnedStaging(torch.device("cpu"))
    a = staging.take(1000)
    staging.give(a, ev := Event())
    b = staging.take(1000)
    assert b.data_ptr() != a.data_ptr() and staging.allocated == 2  # a's copy in flight
    ev.done = True
    c = staging.take(900)
    assert c.data_ptr() == a.data_ptr()
    arr, buf = staging.array((5, 13))
    arr[:] = 7
    out = staging.to_card(arr, buf, torch.device("cpu"))
    assert out.dtype == torch.int32 and out.shape == (5, 13) and int(out.sum()) == 7 * 65
    arr2, buf2 = staging.array((5, 13))
    assert buf2.data_ptr() == buf.data_ptr() and not arr2.any()  # reused, zeroed


# -- the engine's lanes ---------------------------------------------------------------

# The controller is off where every accepted event must be stepped: a
# saturated pipeline (in-flight fill 1.0) would otherwise sample, as the
# reference's does. test_sampling_reaches_the_step_and_the_replay turns it on.
LANES = dict(window_seconds=0.25, flush_interval_s=0.01, flush_max_age_s=0.05,
             flush_max_events=2048, overload_enabled=False)


def _logged(eng, log):
    """Log what the dispatch thread issues, in order: each batch with its
    now_s and n_raw, and each close it submitted (not one it deferred)."""
    dispatch, close = eng._dispatch_sharded, eng._submit_close_window

    def logged_dispatch(sb, now_s, n_raw, sync=True):
        log.append(("step", sb, now_s, n_raw))
        dispatch(sb, now_s, n_raw, sync)

    def logged_close():
        deferred = eng.windows["deferred"]
        close()
        if eng.windows["deferred"] == deferred:
            log.append(("window",))

    eng._dispatch_sharded, eng._submit_close_window = logged_dispatch, logged_close
    published = []
    publish = eng._publish_window

    def logged_publish(win, meta=None):
        published.append((win, meta))
        publish(win, meta)

    eng._publish_window = logged_publish
    return published


def _run_lanes(cfg, windows: int = 6, idle_at: int = 3, block: int = 256, per_window: int = 6,
               devices: list | None = None):
    """Start the lanes (on the CPU, or over ``devices``), produce TrafficGen
    blocks into the sink for ``windows`` windows with a pause of two at
    ``idle_at``, stop. Returns the engine, its log, what it published and
    the rows the sink took."""
    eng = SketchEngine(cfg, device="cpu", devices=devices)
    eng.update_identities(PODS)
    log: list = []
    published = _logged(eng, log)
    seen = []
    eng.add_observer(lambda rec, plugin: seen.append(len(rec)))
    stop = threading.Event()
    lanes = threading.Thread(target=eng.start, args=(stop,), daemon=True)
    lanes.start()
    gen = TrafficGen(n_flows=400, n_pods=48, seed=31)
    accepted = 0
    w = cfg.window_seconds
    try:
        for i in range(windows):
            if i == idle_at:
                # Once all that was accepted is stepped, two ticks with
                # nothing new: the close between them is idle.
                deadline = time.monotonic() + JOIN_S
                while eng.counts.events < accepted and time.monotonic() < deadline:
                    time.sleep(0.01)
                time.sleep(2.2 * w)
            for _ in range(per_window):
                accepted += eng.sink.write_records(gen.batch(block), "gen")
                time.sleep(w / per_window)
        deadline = time.monotonic() + JOIN_S
        while eng.counts.events < accepted and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(2.2 * w)  # a last close of the last fed window
    finally:
        stop.set()
        lanes.join(JOIN_S)
    assert not lanes.is_alive()
    eng.stop()
    return eng, log, published, accepted, sum(seen)


def _replay(cfg, log, devices: list | None = None):
    """The log, synchronously, through a second engine (on the CPU, or over
    ``devices``): its state and the windows it published."""
    eng = SketchEngine(cfg, device="cpu", devices=devices)
    eng.update_identities(PODS)
    published = []
    publish = eng._publish_window
    eng._publish_window = lambda win, meta=None: (published.append((win, meta)),
                                                  publish(win, meta))
    for entry in log:
        if entry[0] == "step":
            eng._dispatch_sharded(*entry[1:])
        else:
            eng._close_window()
    eng._harvest_window(timeout=JOIN_S)
    eng.stop()
    return eng, published


def _same_state(a, b):
    for name, x, y in zip(leaf_names(a), state_to_numpy(a), state_to_numpy(b)):
        if x.dtype == np.float32 and name != "entropy.counts":
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def _same_windows(got, want):
    assert len(got) == len(want)
    for (w, m), (v, n) in zip(got, want):
        for k in ("entropy_bits", "zscore"):
            np.testing.assert_allclose(w[k], v[k], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(w["anomaly"], v["anomaly"])
        assert {k: x for k, x in m.items() if k != "inv_decode"} == {
            k: x for k, x in n.items() if k != "inv_decode"}


@pytest.mark.parametrize("workers", [1, 4], ids=["inline", "four_workers"])
def test_lanes_equal_their_own_synchronous_replay(workers):
    _, cfg = _configs(feed_workers=workers, **LANES)
    eng, log, published, accepted, observed = _run_lanes(cfg)
    assert eng.errors == {} and eng.lost_events == {}
    assert observed == accepted == eng.counts.events
    assert int(to_numpy(eng.state.totals)[0]) == accepted  # one packet a row
    steps = [e for e in log if e[0] == "step"]
    assert len(steps) > 2 and any(e[0] == "window" for e in log)
    assert eng.windows["idle"] >= 1 and eng.windows["end_window"] >= 2
    assert eng.windows["closed"] == eng.windows["end_window"] + eng.windows["idle"]
    stats = eng.feed_stats()
    assert stats["mode"] == ("sharded" if workers > 1 else "inline")
    assert stats["lane_s"]["build"] > 0 and stats["lane_s"]["dispatch"] > 0
    if workers > 1:
        assert stats["dropped_events"] == 0 and len(stats["per_worker"]) == workers
    # Publication in close order: the idle windows are zero, the others
    # carry the events they took.
    assert len(published) == eng.windows["closed"]
    assert sum(m["events"] for _, m in published) == accepted
    for w, m in published:
        if m["events"] == 0:
            assert all(not w[k].any() for k in ("entropy_bits", "anomaly", "zscore"))
    ref, ref_published = _replay(cfg, log)
    _same_state(eng.state, ref.state)
    _same_windows(published, ref_published)
    assert ref.counts == eng.counts
    a, b = eng.snapshot(max_age_s=0, now_s=5000), ref.snapshot(max_age_s=0, now_s=5000)
    for key in ("steps", "events_in"):
        assert a.pop(key) == b.pop(key)
    for name in ("totals", "node_counters", "pod_forward", "active_conns", "ct_totals"):
        assert torch.equal(a[name], b[name]), name


def test_lanes_without_a_pipeline_dispatch_on_the_feed_loop():
    _, cfg = _configs(feed_pipeline_depth=0, **LANES)
    eng, log, published, accepted, _ = _run_lanes(cfg, windows=3, idle_at=1)
    assert eng.errors == {} and eng.feed_stats()["mode"] == "inline"
    assert eng.counts.events == accepted and eng.windows["idle"] >= 1
    ref, ref_published = _replay(cfg, log)
    _same_state(eng.state, ref.state)
    _same_windows(published, ref_published)


def test_sampling_reaches_the_step_and_the_replay():
    """The controller pinned in SAMPLING by an injected signal: k reaches
    every batch and the step rescales; the replay agrees."""
    _, cfg = _configs(feed_workers=2, **dict(LANES, overload_enabled=True))
    eng = SketchEngine(cfg, device="cpu")
    eng.update_identities(PODS)
    eng.overload._signals = lambda: {"injected": 0.8}  # past enter, below shed
    assert eng.overload.tick(now=1e9) == ov.SAMPLING
    log: list = []
    _logged(eng, log)
    sampled = []
    sample = eng.overload.sample_rows

    def logged_sample(rec):
        kept, k = sample(rec)
        sampled.append((rec, kept))
        return kept, k

    eng.overload.sample_rows = logged_sample
    stop = threading.Event()
    lanes = threading.Thread(target=eng.start, args=(stop,), daemon=True)
    lanes.start()
    gen = TrafficGen(n_flows=400, n_pods=48, seed=32)
    blocks = [gen.batch(512) for _ in range(12)]
    for b in blocks:
        b[::3, F.PACKETS] = 70  # heavy rows (>= 64 packets): exempt
        assert eng.sink.write_records(b, "gen") == len(b)
        time.sleep(0.02)
    time.sleep(0.5)
    stop.set()
    lanes.join(JOIN_S)
    assert not lanes.is_alive() and eng.errors == {}
    eng.stop()
    steps = [e[1] for e in log if e[0] == "step"]
    k = cfg.overload_sample_k
    assert steps and all(sb.sample_k == k for sb in steps)
    # The step rescaled exactly the kept non-exempt rows by k.
    kept = np.concatenate([sb.records[0, : int(sb.n_valid[0])] for sb in steps])
    exempt = ov.row_tiers(kept, cfg) > ov.TIER_BACKGROUND
    pk = kept[:, F.PACKETS].astype(np.int64)
    est = int(pk[exempt].sum()) + k * int(pk[~exempt].sum())
    assert int(to_numpy(eng.state.totals)[0]) == est
    # The sampler kept every exempt combined row whole; the estimate is
    # within the Horvitz-Thompson rule of the events offered.
    for rec, out in sampled:
        ex = ov.row_tiers(rec, cfg) > ov.TIER_BACKGROUND
        np.testing.assert_array_equal(out[ov.row_tiers(out, cfg) > ov.TIER_BACKGROUND], rec[ex])
    offered = sum(int(b[:, F.PACKETS].sum()) for b in blocks)
    assert sum(int(r[:, F.PACKETS].sum()) for r, _ in sampled) == offered
    sq = int((pk[~exempt] ** 2).sum())
    assert abs(est - offered) <= 4 * np.sqrt((k - 1) * k * sq)
    ref, _ = _replay(cfg, log)
    _same_state(eng.state, ref.state)


# -- the close lane against the reference ---------------------------------------------


@pytest.mark.parametrize("source", ["flowdict", "invertible"])
def test_idle_close_matches_reference_engine(source):
    """fed, idle, fed: no export, ring offer, decode or end_window at the
    idle close, and a zero window published through the harvest."""
    jcfg, cfg = _configs(heavy_keys_source=source, timetravel_enabled=True)
    jcfg.timetravel_enabled = True
    jeng = JEngine(jcfg, devices=[jax.devices("cpu")[0]])
    eng = SketchEngine(cfg, device="cpu")
    jeng.timetravel_ring.start()
    for e in (jeng, eng):
        e.update_identities(PODS)
    try:
        for i, fed in enumerate((True, False, True)):
            if fed:
                rec = escalating(40 + i)
                jeng.step_records(rec, now_s=100 + i)
                eng.step_records(rec, now_s=100 + i)
            jeng._close_window()
            eng._close_window()
            jeng._harvest_window(timeout=JOIN_S)
            eng._harvest_window(timeout=JOIN_S)
            compare_states(jax.tree.map(lambda x: x[0], jeng.state), eng.state)
            got, want = eng.last_window, jeng.last_window
            assert got["overload"] == want["overload"]
            assert got["overload"]["events"] == (len(rec) if fed else 0)
            for k in ("entropy_bits", "anomaly", "zscore"):
                np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-6)
                if not fed:
                    assert not got[k].any()
            if source == "invertible" and fed:
                assert len(eng.invertible_report()["keys"]) > 0
        assert eng.timetravel_ring.drain(JOIN_S)
        deadline = time.monotonic() + JOIN_S
        while len(jeng.timetravel_ring) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(eng.timetravel_ring) == len(jeng.timetravel_ring) == 2
        assert dict(eng.windows) == {"closed": 3, "idle": 1, "exports": 2, "end_window": 2}
    finally:
        jeng.timetravel_ring.stop()
        eng.stop()


def test_synchronous_close_window_skips_an_idle_window():
    _, cfg = _configs(timetravel_enabled=True, fleet_enabled=True, heavy_keys_source="invertible")
    eng = SketchEngine(cfg, device="cpu")
    eng.update_identities(PODS)
    outs = []
    for i, fed in enumerate((True, False, True)):
        if fed:
            eng.step_records(escalating(50 + i), now_s=200 + i)
        outs.append(eng.close_window(epoch=70 + i))
    assert "export" in outs[0] and "inv" in outs[0] and "export" in outs[2]
    assert outs[1].keys() == zero_window().keys() and not any(v.any() for v in outs[1].values())
    assert eng.timetravel_ring.drain(JOIN_S)
    assert [s[0] for s in eng.timetravel_ring.select(0, 100)] == [70, 72]
    assert eng.windows["end_window"] == 2 and eng.windows["idle"] == 1
    eng.stop()


def test_published_window_calls_the_hook_with_the_wall_clocks_epoch():
    jcfg, cfg = _configs(window_seconds=1000.0)
    jeng = JEngine(jcfg, devices=[jax.devices("cpu")[0]])
    eng = SketchEngine(cfg, device="cpu")
    calls, jcalls = [], []
    eng.anomaly_hook = lambda e, dims: calls.append((e, dims))
    jeng.anomaly_hook = lambda e, dims: jcalls.append((e, dims))
    win = {"entropy_bits": np.ones(3, np.float32), "anomaly": np.array([0, 1, 1], np.float32),
           "zscore": np.zeros(3, np.float32)}
    eng._publish_window(win, {"events": 3})
    jeng._publish_window(win, {"events": 3})
    assert calls == jcalls and calls[0][1] == ["dst_ip", "dst_port"]
    assert eng.last_window["overload"] == {"events": 3}

    def boom(e, dims):
        raise RuntimeError("hook")

    eng.anomaly_hook = boom
    eng._publish_window(win)
    assert eng.errors["anomaly_hook"] == 1


# -- the scrape surface ------------------------------------------------------------------


def test_snapshot_cache_hits_and_expires():
    _, eng = _engines()
    eng.step_records(escalating(60), now_s=300)
    a = eng.snapshot(max_age_s=60.0)
    assert eng.snapshot(max_age_s=60.0) is a  # a hit
    assert a["steps"] == eng.counts.steps and a["events_in"] == 900
    eng.step_records(escalating(61), now_s=301)
    assert eng.snapshot(max_age_s=60.0) is a  # still cached
    time.sleep(0.06)
    b = eng.snapshot(max_age_s=0.05)  # expired
    assert b is not a and b["events_in"] == 1800
    pk = int(escalating(60)[:, F.PACKETS].sum())
    assert int(a["totals"][0]) == pk and int(b["totals"][0]) == pk + int(
        escalating(61)[:, F.PACKETS].sum())
    c = eng.snapshot(max_age_s=0)
    assert c is not b


def test_top_k_conntrack_gc_and_ground_truth_match_reference():
    jeng, eng = _engines(heavy_keys_source="both")
    rows = [escalating(s) for s in (62, 63, 64)]
    for i, rec in enumerate(rows):
        jeng.step_records(rec, now_s=400 + i)
        eng.step_records(rec, now_s=400 + i)
    # "both": the ground truth the harvest scores against.
    assert eng._hk_counts == jeng._hk_counts and len(eng._hk_counts) > 10
    snap = eng.snapshot(max_age_s=0)
    jsnap = jeng.snapshot(max_age_s=0)
    for name, fn in (("flow_hh", "top_flows"), ("svc_hh", "top_services"), ("dns_hh", "top_dns")):
        keys, counts = getattr(eng, fn)(10)
        want_keys, want_counts = topk_from_snapshot(snap, name, 10)
        np.testing.assert_array_equal(keys, want_keys)
        np.testing.assert_array_equal(counts, want_counts)
        np.testing.assert_array_equal(counts, getattr(jeng, fn)(10)[1])
    gc, jgc = eng.conntrack_gc(), jeng.conntrack_gc()
    assert {k: gc[k] for k in ("reports", "packets", "bytes")} == {
        k: jgc[k] for k in ("reports", "packets", "bytes")}
    assert gc["reports"] > 0 and gc["active"] == int(jsnap["active_conns"])
    eng._close_window()
    eng._harvest_window(timeout=JOIN_S)
    assert 0.0 <= eng.invertible_scores["recall"] <= 1.0
    assert eng.invertible_report()["keys"].dtype == np.uint32


def test_replay_provider_captures_the_engines_stream(tmp_path):
    _, cfg = _configs(feed_workers=1, **LANES)
    eng = SketchEngine(cfg, device="cpu")
    eng.update_identities(PODS)
    stop = threading.Event()
    lanes = threading.Thread(target=eng.start, args=(stop,), daemon=True)
    lanes.start()
    gen = TrafficGen(n_flows=50, n_pods=16, seed=33)
    fed = []
    out = tmp_path / "cap.pcap"
    cap = threading.Thread(target=ReplayProvider(engine=eng).capture,
                           args=(str(out),), kwargs=dict(duration_s=1), daemon=True)
    cap.start()
    try:
        while cap.is_alive():
            fed.append(gen.batch(64))
            eng.sink.write_records(fed[-1], "gen")
            time.sleep(0.02)
            cap.join(0.0)
    finally:
        cap.join(JOIN_S)
        stop.set()
        lanes.join(JOIN_S)
    assert not cap.is_alive() and not lanes.is_alive()
    got = decode_pcap_bytes(out.read_bytes()).records
    keys = {(int(r[F.SRC_IP]), int(r[F.DST_IP]), int(r[F.PORTS])) for r in np.concatenate(fed)}
    assert len(got) > 0 and {(int(r[F.SRC_IP]), int(r[F.DST_IP]), int(r[F.PORTS]))
                             for r in got} <= keys


# -- sources and row 12 ------------------------------------------------------------------


def test_pcap_replay_batches_match_reference():
    ref, port = JTrafficGen(mode="pcap_replay"), TrafficGen(mode="pcap_replay")
    total = len(port._replay_src)
    assert total == len(ref._replay_src) > 0
    for n in (1, 100, total, 2 * total + 7, 4096):  # crosses passes: rebased time
        np.testing.assert_array_equal(port.batch(n), ref.batch(n))
    assert port._replay_src.passes_done == ref._replay_src.passes_done >= 3


def test_cms_update_jit_matches_reference():
    rng = np.random.default_rng(70)
    n = 4000
    keys = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32) for _ in range(3)]
    keys[1][: n // 2] = keys[1][n // 2:]  # repeated keys: adds on shared columns
    w = rng.integers(1, 9, n).astype(np.uint32)
    w[rng.random(n) < 0.25] = 0  # masked rows carry weight 0
    w[:4] = 0xFFFFFFF0  # the u32 counters wrap
    ref = JCMS.zeros(depth=4, width=1 << 10, seed=6)
    port = CountMinSketch.zeros(depth=4, width=1 << 10, seed=6, device="cpu")
    for _ in range(2):
        ref = jcms_update_jit(ref, [jnp.asarray(k) for k in keys], jnp.asarray(w))
        out = cms_update_jit(port, [from_numpy(k, "cpu") for k in keys], from_numpy(w, "cpu"))
        assert out is port
    np.testing.assert_array_equal(to_numpy(port.table), np.asarray(ref.table))
