"""Chaos on the port's engine (CPU): every injected fault recovers in
process, with the reference chaos suite's counters and totals
(``tests/test_chaos.py``).

- ``transfer:raise`` on an asynchronous dispatch: degraded drop-and-count
  (``lost_events["degraded"]``, ``degraded_mode``), then the crash-only
  recovery from the checkpoint (``engine_restarts``, ``recovery_seconds``)
  and correct ingest after it: totals 300 + 100;
- ``harvest:hang``: the watchdog supersedes the hung harvest thread
  (``watchdog_stalls``, ``thread_restarts``) and the replacement drains;
- ``checkpoint:corrupt``: the torn write is quarantined, then a cold start;
- a feed worker that raises is restarted under the policy
  (``thread_restarts{thread=feed-worker-i}``) and every later block is
  stepped;
- a recovery whose attempts all fail opens the circuit and latches
  ``recovery_failed``, with the state left on its device.

Every wait is bounded; every test clears the fault layer in teardown.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

import retina_tpu_torch.metrics as port_metrics
from retina_tpu_torch.config import Config
from retina_tpu_torch.convert import state_to_numpy
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.events.schema import NUM_FIELDS, F
from retina_tpu_torch.exporter import Exporter
from retina_tpu_torch.parallel.partition import partition_events
from retina_tpu_torch.runtime import faults
from retina_tpu_torch.runtime.supervisor import Supervisor
from retina_tpu_torch.u32 import to_numpy

POD_NET = 0x0A000000
SMALL = dict(batch_capacity=1 << 10, n_pods=1 << 8, cms_width=1 << 10, topk_slots=1 << 7,
             hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 10,
             identity_slots=1 << 10, flush_interval_s=0.01, window_seconds=0.2)


@pytest.fixture(autouse=True)
def _clean():
    saved = port_metrics._singleton
    port_metrics.reset_for_tests()
    port_metrics.initialize_metrics(Exporter())
    yield
    faults.clear()
    port_metrics._singleton = saved


def small_cfg(**kw) -> Config:
    return Config(**dict(SMALL, **kw))


def mk_records(n: int) -> np.ndarray:
    """The reference chaos suite's records: n forward packets of 100 bytes
    from pods 1-49 to pod 7."""
    rec = np.zeros((n, NUM_FIELDS), np.uint32)
    rec[:, F.SRC_IP] = POD_NET + (np.arange(n) % 49 + 1).astype(np.uint32)
    rec[:, F.DST_IP] = POD_NET + 7
    rec[:, F.PORTS] = (40000 << 16) | 80
    rec[:, F.META] = (6 << 24) | (0x10 << 16) | (2 << 8) | (1 << 4)
    rec[:, F.BYTES] = 100
    rec[:, F.PACKETS] = 1
    rec[:, F.VERDICT] = 1
    rec[:, F.EVENT_TYPE] = 1
    return rec


def _wait(pred, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _engine(cfg, **kw) -> SketchEngine:
    eng = SketchEngine(cfg, device="cpu", **kw)
    eng.update_identities({POD_NET + i: i for i in range(1, 50)})
    return eng


def _totals0(eng) -> int:
    return int(to_numpy(eng.snapshot(max_age_s=0)["totals"])[0])


def _value(metric) -> float:
    return metric._value


def _dispatch_async(eng, n: int = 100) -> None:
    sb = partition_events(mk_records(n), 1, eng.cfg.batch_capacity,
                          min_bucket=eng.cfg.transfer_min_bucket)
    eng._dispatch_sharded(sb, int(time.time()), n, sync=False)


@pytest.mark.parametrize("flow_dict", [False, True], ids=["packed_wire", "flow_dict_wire"])
def test_transfer_fault_triggers_crash_only_recovery(tmp_path, flow_dict):
    cfg = small_cfg(snapshot_dir=str(tmp_path), wire_flow_dict=flow_dict,
                    transfer_min_bucket=64)
    eng = _engine(cfg)
    eng.step_records(mk_records(300))
    assert _totals0(eng) == 300
    # The checkpoint recovery resumes from, not from zero.
    eng.save_snapshot_state(str(tmp_path / "sketch_state.npz"))
    # The hang at `recover` holds the engine degraded long enough to see the
    # drop-and-count.
    faults.configure("transfer:raise@1,recover:hang120")
    _dispatch_async(eng)
    _wait(lambda: eng.degraded, 10.0, "degraded mode entry")
    m = port_metrics.get_metrics()
    assert _value(m.degraded_mode) == 1
    _dispatch_async(eng)
    _wait(lambda: eng.lost_events["degraded"] >= 100, 5.0, "degraded drop-and-count")
    # A lanes' close defers while the state is rebuilt.
    eng._close_window()
    assert eng.windows["deferred"] == 1 and eng.windows["closed"] == 0
    faults.release_hangs()
    _wait(lambda: not eng.degraded, 30.0, "engine recovery")
    assert eng.restarts == 1
    assert not eng.recovery_failed.is_set()
    assert _value(m.engine_restarts) == 1
    assert eng.errors["device_step"] >= 1 and eng.lost_events["device"] == 100
    assert _value(m.degraded_mode) == 0
    assert eng._last_resume_src.startswith("resumed from")
    counts = {s: v for s, _, v in m.recovery_seconds.samples()}
    assert counts["_count"] == 1
    # Post-recovery ingest: checkpointed 300 + fresh 100.
    eng.step_records(mk_records(100))
    assert _totals0(eng) == 400
    eng.stop()


def test_recovery_without_a_checkpoint_cold_starts():
    eng = _engine(small_cfg())
    eng.step_records(mk_records(300))
    faults.configure("transfer:raise@1")
    _dispatch_async(eng)
    _wait(lambda: eng.restarts == 1, 30.0, "engine recovery")
    assert eng._last_resume_src == "cold start" and not eng.degraded
    eng.step_records(mk_records(100))
    assert _totals0(eng) == 100
    eng.stop()


def test_hung_harvest_superseded_by_watchdog():
    cfg = small_cfg(watchdog_deadline_s=0.5, watchdog_interval_s=0.1)
    sup = Supervisor(deadline_s=cfg.watchdog_deadline_s, interval_s=cfg.watchdog_interval_s)
    eng = _engine(cfg, supervisor=sup)
    sup.start()
    try:
        faults.configure("harvest:hang60")
        eng._close_window()  # the harvest picks the window up and hangs
        m = port_metrics.get_metrics()
        _wait(lambda: _value(m.thread_restarts.labels(thread="window-harvest")) >= 1,
              15.0, "the watchdog to supersede the hung harvest thread")
        assert _value(m.watchdog_stalls.labels(thread="window-harvest")) >= 1
        # Free the hung one; the replacement drains the next window.
        faults.clear()
        eng.step_records(mk_records(50))
        eng._close_window()
        _wait(lambda: eng._harvest_q.unfinished_tasks == 0, 10.0,
              "the replacement harvest thread to drain the queue")
        assert eng.windows["end_window"] == 1
    finally:
        sup.stop()
        eng.stop()
    assert sup.heartbeat("window-harvest") is None  # stop() deregisters


def test_corrupt_checkpoint_quarantined_and_cold_start(tmp_path):
    cfg = small_cfg()
    eng = _engine(cfg)
    eng.step_records(mk_records(200))
    assert _totals0(eng) == 200
    path = str(tmp_path / "state.npz")
    faults.configure("checkpoint:corrupt@1")
    eng.save_snapshot_state(path)
    faults.clear()
    eng2 = _engine(cfg)
    assert eng2.load_snapshot_state(path) is False
    assert not os.path.exists(path)
    assert os.path.exists(path + ".bad")
    assert _totals0(eng2) == 0
    eng.save_snapshot_state(path)
    eng3 = _engine(cfg)
    assert eng3.load_snapshot_state(path) is True
    assert _totals0(eng3) == 200


def test_feed_worker_crash_is_restarted_under_the_policy():
    """One feed worker's quantum build raises once: the worker restarts
    after the policy's backoff, thread_restarts counts it, the lost quantum
    is the only loss and every later block is stepped."""
    cfg = small_cfg(feed_workers=2, feed_pipeline_depth=2, restart_backoff_base_s=0.01,
                    restart_backoff_jitter=0.0, flush_max_age_s=0.05, flush_max_events=2048,
                    overload_enabled=False, window_seconds=0.5)
    sup = Supervisor(deadline_s=5.0, interval_s=0.1)
    eng = _engine(cfg, supervisor=sup)
    build = eng._build_quantum
    crashed: list[int] = []

    def flaky_build(blocks, n_raw, now_s):
        if not crashed:
            crashed.append(n_raw)
            raise RuntimeError("injected build failure")
        return build(blocks, n_raw, now_s)

    eng._build_quantum = flaky_build
    stop = threading.Event()
    lanes = threading.Thread(target=eng.start, args=(stop,), daemon=True)
    lanes.start()
    accepted = 0
    try:
        for _ in range(10):
            accepted += eng.sink.write_records(mk_records(200), "gen")
            time.sleep(0.01)
        _wait(lambda: crashed and eng.counts.events == accepted - crashed[0], 20.0,
              "every block after the crash to be stepped")
        pool = eng._feed_pool
        restarted = [w for w in pool.workers if w.restarts]
        assert len(restarted) == 1 and restarted[0].is_alive() and not restarted[0].crashed
        m = port_metrics.get_metrics()
        assert _value(m.thread_restarts.labels(thread=restarted[0].name)) == 1
        assert _value(m.engine_errors.labels(site="feed_worker")) == 1
        assert sup.heartbeat(restarted[0].name) is not None
    finally:
        stop.set()
        lanes.join(30)
    assert not lanes.is_alive()
    assert eng.counts.events == accepted - crashed[0]
    assert int(to_numpy(eng.state.totals)[0]) == accepted - crashed[0]
    assert eng.feed_stats()["per_worker"][0]["restarts"] + \
        eng.feed_stats()["per_worker"][1]["restarts"] == 1
    assert sup.heartbeat("feed-worker-0") is None and sup.heartbeat("engine-feed") is None
    eng.stop()


def test_a_crash_looping_recovery_latches_recovery_failed(tmp_path):
    """Every recovery attempt fails: after restart_max_failures the circuit
    opens, recovery_failed latches, the engine stays degraded, and the
    state stays where it was (no rebuild)."""
    cfg = small_cfg(restart_max_failures=2, restart_backoff_base_s=0.01,
                    restart_backoff_jitter=0.0)
    eng = _engine(cfg)
    eng.step_records(mk_records(100))
    faults.configure("transfer:raise@1,recover:raise")
    _dispatch_async(eng)
    _wait(lambda: eng.recovery_failed.is_set(), 10.0, "the recovery circuit to open")
    assert eng.degraded and eng.restarts == 0 and eng.errors["recovery"] == 2
    assert eng.state.totals.device.type == "cpu" and _totals0(eng) == 100
    # Degraded for good: asynchronous traffic keeps dropping and counting.
    _dispatch_async(eng, 50)
    assert eng.lost_events["degraded"] == 50
    eng.stop()


@pytest.mark.parametrize("error,fatal", [
    (faults.InjectedFault("x"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (RuntimeError("step_rows: CUDA error 700 at launch"), True),
    (RuntimeError("flow-dict wire overflow: 9/8 new, 0/8 known rows"), False),
    (ValueError("leaf shape (3,) != (4,)"), False),
], ids=["injected", "torch_cuda", "wrapper_launch", "bad_batch", "value"])
def test_fatal_device_error_classification(error, fatal):
    assert SketchEngine._fatal_device_error(error) is fatal


def test_out_of_memory_is_fatal():
    import torch

    assert SketchEngine._fatal_device_error(torch.cuda.OutOfMemoryError("CUDA out of memory."))


def test_probe_runs_a_zero_row_dispatch_through_the_step():
    """The recovery's probe steps once with no valid row and leaves the
    state as it was."""
    eng = _engine(small_cfg())
    eng.step_records(mk_records(100))
    before = state_to_numpy(eng.state)
    steps = eng.counts.steps
    eng._dispatch(np.zeros((0, NUM_FIELDS), np.uint32), now_s=int(time.time()))
    assert eng.counts.steps == steps + 1
    after = state_to_numpy(eng.state)
    assert all(np.array_equal(a, b) for a, b in zip(before, after))


def test_backpressure_fault_reaches_the_overload_signals():
    eng = _engine(small_cfg())
    assert "fault" not in eng._overload_signals()
    faults.configure("feed.backpressure:press")
    assert eng._overload_signals()["fault"] == 0.95
    faults.clear()
    eng._degraded.set()
    assert eng._overload_signals()["degraded"] == 1.0
