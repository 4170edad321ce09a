"""The engine's overload signals against the reference engine's (CPU).

The port reads its in-flight signal as the share of the last dwell that the
dispatch thread spent blocked on a full pipeline; the reference reads the
pipeline's fill at the tick. The rules agree where the pipelines agree:

- an idle pipeline reads 0 on both, and every other signal (staging, handoff
  wait, harvest, dispatch latency, the injected fault, degraded mode) is the
  reference's in every case below;
- a saturated pipeline (every slot taken, a dispatch blocked on the next)
  reads 1 on the reference and, once a dwell has passed, past the degrade
  pressure (0.98) on the port;

and differ where the port's pipeline differs from the reference's: a slot
held while the proxy issues a step's launches one by one, with a slot free
whenever a dispatch is ready (the pipeline keeps up), reads its fill (1/3,
2/3) on the reference and 0 on the port. A wait behind one slow dispatch
counts its share of the dwell, not a full tick.
"""

from __future__ import annotations

import threading
import time

import jax
import pytest

from retina_tpu.engine import SketchEngine as JEngine
from retina_tpu.runtime import faults as jfaults
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.runtime import faults
from test_torch_engine import _configs

DWELL = 0.3  # overload_dwell_s of these engines: the in-flight signal's window
JOIN_S = 30.0


@pytest.fixture
def engines():
    jcfg, cfg = _configs(overload_dwell_s=DWELL, feed_pipeline_depth=3)
    jeng = JEngine(jcfg, devices=[jax.devices("cpu")[0]])
    eng = SketchEngine(cfg, device="cpu")
    yield jeng, eng
    faults.clear()
    jfaults.clear()
    eng.stop()


def _take(eng, n: int) -> None:
    """Hold ``n`` slots as ``n`` dispatches on the proxy would."""
    for _ in range(n):
        assert eng._inflight.acquire(timeout=1)
    with eng._busy_lock:
        eng._inflight_busy += n


def _give(eng, n: int) -> None:
    with eng._busy_lock:
        eng._inflight_busy -= n
    for _ in range(n):
        eng._inflight.release()


def _others(sig: dict) -> dict:
    return {k: v for k, v in sig.items() if k not in ("inflight", "dispatch_lat")}


def test_idle_pipeline_reads_the_references_signals(engines):
    jeng, eng = engines
    for _ in range(3):
        got, want = eng._overload_signals(), jeng._overload_signals()
        assert got == want == {"inflight": 0.0, "harvest": 0.0}
    faults.configure("feed.backpressure:press")
    jfaults.configure("feed.backpressure:press")
    assert eng._overload_signals()["fault"] == jeng._overload_signals()["fault"] == 0.95
    eng._degraded.set()
    jeng._degraded.set()
    got, want = eng._overload_signals(), jeng._overload_signals()
    assert got["degraded"] == want["degraded"] == 1.0 and _others(got) == _others(want)
    eng._degraded.clear()


@pytest.mark.parametrize("held", [1, 2])
def test_a_pipeline_that_keeps_up_reads_its_fill_on_the_reference_and_0_here(engines, held):
    jeng, eng = engines
    _take(eng, held)
    with jeng._busy_lock:
        jeng._inflight_busy = held
    try:
        t_end = time.monotonic() + 2 * DWELL
        while time.monotonic() < t_end:
            got, want = eng._overload_signals(), jeng._overload_signals()
            assert want["inflight"] == pytest.approx(held / 3)
            assert got["inflight"] == 0.0
            assert _others(got) == _others(want)
            time.sleep(0.02)
    finally:
        _give(eng, held)


def test_a_saturated_pipeline_reaches_the_degrade_pressure_on_both(engines):
    jeng, eng = engines
    eng._overload_signals()  # the window's first sample
    _take(eng, 3)
    with jeng._busy_lock:
        jeng._inflight_busy = 3
    ran = threading.Event()
    blocked = threading.Thread(target=eng._issue, args=(ran.set, False, 0), daemon=True)
    blocked.start()
    try:
        time.sleep(1.5 * DWELL)
        got, want = eng._overload_signals(), jeng._overload_signals()
        # The window began a moment before the wait did.
        assert want["inflight"] == 1.0
        assert got["inflight"] >= eng.cfg.overload_degrade_pressure
        assert _others(got) == _others(want)
    finally:
        _give(eng, 3)
        blocked.join(JOIN_S)
    assert not blocked.is_alive()
    assert eng._proxy.run(lambda: None) is None  # the proxy ran the queued dispatch
    assert ran.wait(JOIN_S)
    # The finished wait stays in the window for a dwell, then leaves it.
    assert eng._overload_signals()["inflight"] > 0.5
    time.sleep(1.5 * DWELL)
    eng._overload_signals()
    assert eng._overload_signals()["inflight"] == 0.0


def test_one_slow_dispatch_counts_its_share_of_the_dwell(engines):
    """A pipeline full for a tenth of the dwell (one slow dispatch on the
    proxy, as a window close or a merge) reads about a tenth, where the
    reference's fill reads 1 for as long as the slots are taken."""
    jeng, eng = engines
    eng._overload_signals()
    _take(eng, 3)
    blocked = threading.Thread(target=eng._issue, args=(lambda: None, False, 0), daemon=True)
    blocked.start()
    time.sleep(0.1 * DWELL)
    _give(eng, 3)
    blocked.join(JOIN_S)
    assert not blocked.is_alive()
    time.sleep(DWELL)
    share = eng._overload_signals()["inflight"]
    assert 0.0 < share < 0.45
    with jeng._busy_lock:
        jeng._inflight_busy = 3
    assert jeng._overload_signals()["inflight"] == 1.0
