"""The port's supervision tree and fault layer against the reference's
(``runtime/supervisor.py``, ``runtime/faults.py``, the config's checks).

Every case of ``tests/test_supervisor.py`` runs on both packages (the
``impl`` parameter): the heartbeat and its stall escalation, the backoff
schedule, the circuit breaker, the supervised spawn, the fault grammar and
the config's checks. Besides, on the same inputs: the backoff schedule of
``policy_from_config`` equals the reference's exactly for the same config
and ``seed_key``, and ``faults.configure`` accepts and rejects the same
specs and fires on the same hits. Clocks are injected (``scan_once(now)``)
and waits are bounded; every test clears both fault layers in teardown.
"""

from __future__ import annotations

import threading
import time
import types

import pytest

import retina_tpu.metrics as ref_metrics
import retina_tpu_torch.metrics as port_metrics
from retina_tpu.config import Config as JConfig
from retina_tpu.runtime import faults as jfaults
from retina_tpu.runtime import supervisor as jsup
from retina_tpu_torch.config import Config
from retina_tpu_torch.exporter import Exporter
from retina_tpu_torch.runtime import faults
from retina_tpu_torch.runtime import supervisor as sup_mod

IMPLS = {
    "reference": types.SimpleNamespace(
        faults=jfaults, sup=jsup, Config=JConfig,
        counter=lambda c: c._value.get()),
    "port": types.SimpleNamespace(
        faults=faults, sup=sup_mod, Config=Config, counter=lambda c: c._value),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    """A fresh port metrics singleton for the test (the reference's is reset
    by conftest), and both fault layers disarmed after it."""
    saved = port_metrics._singleton
    port_metrics.reset_for_tests()
    port_metrics.initialize_metrics(Exporter())
    yield
    faults.clear()
    jfaults.clear()
    port_metrics._singleton = saved


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _metrics(impl):
    return (ref_metrics if impl.faults is jfaults else port_metrics).get_metrics()


# ------------------------------------------------------------ heartbeat
def test_watchdog_detects_stall_and_escalates_once_per_deadline(impl):
    sup = impl.sup.Supervisor(deadline_s=10.0, interval_s=0.1)
    fired = []
    hb = sup.register("worker", on_stall=lambda: fired.append(1))
    t0 = time.monotonic()
    hb.beat()
    assert sup.scan_once(now=t0 + 5.0) == []
    assert sup.scan_once(now=t0 + 11.0) == ["worker"]
    assert fired == [1]
    assert sup.scan_once(now=t0 + 12.0) == []
    assert sup.scan_once(now=t0 + 22.0) == ["worker"]
    assert hb.stalls == 2
    assert impl.counter(_metrics(impl).watchdog_stalls.labels(thread="worker")) == 2
    hb.beat()
    assert sup.scan_once(now=time.monotonic() + 5.0) == []
    assert sup.summary()["stalled"] == 0
    assert sup.summary()["stalls_total"] == 2


def test_parked_heartbeat_never_counts_as_stalled(impl):
    sup = impl.sup.Supervisor(deadline_s=1.0)
    hb = sup.register("idle")
    hb.park()
    assert sup.scan_once(now=time.monotonic() + 3600.0) == []
    assert hb.stalls == 0
    assert sup.stats()["idle"]["parked"] is True


def test_register_is_takeover_and_preserves_stall_count(impl):
    sup = impl.sup.Supervisor(deadline_s=1.0)
    hb1 = sup.register("t")
    hb1.stalls = 3
    hb2 = sup.register("t")
    assert hb2 is not hb1 and hb2.stalls == 3
    assert sup.heartbeat("t") is hb2
    sup.deregister("t")
    assert sup.heartbeat("t") is None


def test_on_stall_exception_does_not_kill_the_scan(impl):
    sup = impl.sup.Supervisor(deadline_s=0.5)

    def boom():
        raise RuntimeError("escalation handler bug")

    hb = sup.register("bad", on_stall=boom)
    hb.beat()
    assert sup.scan_once(now=time.monotonic() + 2.0) == ["bad"]


# --------------------------------------------------------- restart policy
def test_backoff_schedule_is_exponential_and_capped(impl):
    p = impl.sup.RestartPolicy(base_s=0.1, max_s=0.5, jitter=0.0, max_failures=10)
    delays = []
    for _ in range(5):
        p.note_start()
        delays.append(p.record_failure())
    assert delays == [0.1, 0.2, 0.4, 0.5, 0.5]


def test_backoff_jitter_is_seeded_and_reproducible(impl):
    cfg = impl.Config()
    a = impl.sup.policy_from_config(cfg, seed_key="thread-x")
    b = impl.sup.policy_from_config(cfg, seed_key="thread-x")
    for _ in range(3):
        a.note_start(), b.note_start()
        assert a.record_failure() == b.record_failure()


def test_circuit_opens_after_max_consecutive_failures(impl):
    p = impl.sup.RestartPolicy(base_s=0.01, jitter=0.0, max_failures=3)
    for _ in range(2):
        p.note_start()
        assert p.record_failure() is not None
    p.note_start()
    assert p.record_failure() is None
    assert p.state == "open"
    assert p.stats() == {"state": "open", "consecutive_failures": 3, "restarts": 3}


def test_circuit_half_open_probe_then_reopen_on_crash(impl):
    p = impl.sup.RestartPolicy(base_s=0.01, jitter=0.0, max_failures=1, half_open_after_s=0.05)
    p.note_start()
    assert p.record_failure() is None
    assert p.state == "open"
    assert p.wait_half_open(threading.Event()) is True
    assert p.state == "half_open"
    p.note_start()
    assert p.record_failure() is None
    assert p.state == "open"


def test_circuit_closes_after_healthy_window(impl):
    p = impl.sup.RestartPolicy(base_s=0.01, jitter=0.0, max_failures=1, window_s=0.05,
                               half_open_after_s=0.01)
    p.note_start()
    assert p.record_failure() is None
    assert p.wait_half_open(threading.Event())
    p.note_start()
    time.sleep(0.08)
    assert p.state == "closed"


def test_long_lived_runs_reset_the_consecutive_count(impl):
    p = impl.sup.RestartPolicy(base_s=0.1, max_s=10.0, jitter=0.0, max_failures=3,
                               window_s=0.0)
    for _ in range(10):
        p.note_start()
        assert p.record_failure() == 0.1
    assert p.state == "closed"


def test_wait_half_open_interrupted_by_stop(impl):
    p = impl.sup.RestartPolicy(max_failures=1, half_open_after_s=60.0)
    p.note_start()
    p.record_failure()
    stop = threading.Event()
    stop.set()
    assert p.wait_half_open(stop) is False


# ------------------------------------------------------- supervised spawn
def test_spawn_restarts_crashing_target_until_clean_exit(impl):
    sup = impl.sup.Supervisor()
    stop = threading.Event()
    runs = []
    done = threading.Event()

    def flaky():
        runs.append(1)
        if len(runs) < 3:
            raise RuntimeError("transient")
        done.set()

    pol = impl.sup.RestartPolicy(base_s=0.01, jitter=0.0, max_failures=10)
    t = sup.spawn("flaky", flaky, stop, pol)
    assert done.wait(5.0)
    t.join(timeout=2.0)
    assert len(runs) == 3
    assert impl.counter(_metrics(impl).thread_restarts.labels(thread="flaky")) == 2


def test_spawn_respects_stop_during_backoff(impl):
    sup = impl.sup.Supervisor()
    stop = threading.Event()

    def crash():
        raise RuntimeError("always")

    pol = impl.sup.RestartPolicy(base_s=30.0, jitter=0.0, max_failures=10)
    t = sup.spawn("crashy", crash, stop, pol)
    deadline = time.monotonic() + 5.0
    while pol.restarts == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    stop.set()
    t.join(timeout=2.0)
    assert pol.restarts == 1 and not t.is_alive()


def test_watchdog_thread_escalates_a_real_stall(impl):
    """start()/stop(): the scan thread itself finds a thread that stopped
    beating (bounded wait, no sleeps as the measure)."""
    sup = impl.sup.Supervisor(deadline_s=0.05, interval_s=0.01)
    fired = threading.Event()
    hb = sup.register("stuck", on_stall=fired.set)
    hb.beat()
    sup.start()
    try:
        assert fired.wait(5.0)
    finally:
        sup.stop()
    assert hb.stalls >= 1


# ------------------------------------------------------- fault injection
def test_fault_spec_grammar_and_nth_hit(impl):
    f = impl.faults
    f.configure("transfer:raise@2,checkpoint:corrupt")
    f.inject("transfer")
    with pytest.raises(f.InjectedFault):
        f.inject("transfer")
    f.inject("transfer")
    assert f.should_corrupt("checkpoint")
    assert not f.should_corrupt("transfer")
    st = f.stats()
    assert st["armed"] and st["rules"]["transfer"]["fired"] == 1


def test_fault_hang_released_by_clear(impl):
    f = impl.faults
    f.configure("loop:hang60")
    t0 = time.monotonic()
    entered, done = threading.Event(), threading.Event()

    def hanger():
        entered.set()
        f.inject("loop")
        done.set()

    threading.Thread(target=hanger, daemon=True).start()
    assert entered.wait(5.0)
    f.clear()
    assert done.wait(5.0)
    assert time.monotonic() - t0 < 10.0


def test_fault_spec_rejects_garbage(impl):
    with pytest.raises(ValueError):
        impl.faults.configure("transfer;raise")
    with pytest.raises(ValueError):
        impl.faults.configure("transfer:explode")


def test_config_validates_fault_spec_and_deadlines(impl):
    cfg = impl.Config()
    cfg.fault_spec = "transfer:raise@3,plugin.mock:hang2.5"
    cfg.validate()
    cfg.fault_spec = "not a spec"
    with pytest.raises(ValueError):
        cfg.validate()
    cfg.fault_spec = ""
    cfg.watchdog_deadline_s = 0.0
    with pytest.raises(ValueError):
        cfg.validate()


# ------------------------------------------- the port against the reference
@pytest.mark.parametrize("seed_key", ["engine-recover", "feed-worker-0", "feed-worker-3",
                                      "window-harvest", ""])
@pytest.mark.parametrize("knobs", [
    {}, {"restart_backoff_base_s": 0.05, "restart_backoff_max_s": 1.0,
         "restart_backoff_jitter": 0.5, "restart_max_failures": 8},
    {"restart_backoff_jitter": 0.0, "restart_max_failures": 2},
], ids=["default", "tight", "no_jitter"])
def test_backoff_schedule_equals_the_reference(seed_key, knobs):
    """The same config and seed_key give the same delays, to the bit, and
    the circuit opens at the same failure."""
    cfg, jcfg = Config(**knobs), JConfig(**knobs)
    p = sup_mod.policy_from_config(cfg, seed_key=seed_key)
    q = jsup.policy_from_config(jcfg, seed_key=seed_key)
    got, want = [], []
    for _ in range(cfg.restart_max_failures + 1):
        p.note_start(), q.note_start()
        got.append(p.record_failure())
        want.append(q.record_failure())
    if seed_key:
        assert got == want
    else:
        # No seed_key: an unseeded generator; the schedule's shape agrees.
        assert [x is None for x in got] == [x is None for x in want]
    assert got[-1] is None and p.stats() == q.stats()


SPECS = [
    "", "  ", "transfer:raise", "transfer:raise@3", "harvest:hang", "harvest:hang5",
    "harvest:hang2.5@1", "checkpoint:corrupt@1", "feed.backpressure:press",
    "feed.backpressure:press10", "plugin.packet-parser:raise@2", "transfer:raise@1,recover:hang30",
    "a:raise, b:corrupt ,", "transfer:raise@0",
    "transfer;raise", "transfer:explode", "transfer:raise@x", "transfer", ":raise",
    "transfer:hang-1", "transfer:raise@1@2", "sp ace:raise", "transfer:pressx",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_equals_the_reference(spec):
    """configure accepts and rejects as the reference does; the config's
    check agrees with it; the armed rules match."""
    def outcome(mod, cfg_cls):
        try:
            mod.configure(spec)
            res = ("ok", mod.armed(), mod.stats())
        except ValueError:
            res = ("rejected",)
        cfg = cfg_cls()
        cfg.fault_spec = spec
        try:
            cfg.validate()
            res += ("valid",)
        except ValueError:
            res += ("invalid",)
        mod.clear()
        return res

    got, want = outcome(faults, Config), outcome(jfaults, JConfig)
    assert got == want
    assert (got[0] == "ok") == (got[-1] == "valid")


@pytest.mark.parametrize("spec,site,hits", [
    ("transfer:raise@3", "transfer", 6), ("transfer:raise", "transfer", 4),
    ("transfer:raise@0", "transfer", 3), ("checkpoint:corrupt@2", "checkpoint", 5),
    ("checkpoint:corrupt", "checkpoint", 3), ("transfer:raise@1", "harvest", 3),
    ("x:corrupt@1", "x", 3),
])
def test_fault_firing_equals_the_reference(spec, site, hits):
    """The Nth-hit rule: the same hits fire (raise, or corrupt) in both."""
    def fired(mod):
        mod.configure(spec)
        out = []
        for _ in range(hits):
            if "corrupt" in spec:
                out.append(mod.should_corrupt(site))
                continue
            try:
                mod.inject(site)
                out.append(False)
            except mod.InjectedFault:
                out.append(True)
        st = mod.stats()
        mod.clear()
        return out, st

    assert fired(faults) == fired(jfaults)


def test_pressure_equals_the_reference():
    """A press rule reads True from its first query until cleared; press0.05
    goes False after its bound; both packages alike."""
    for mod in (faults, jfaults):
        mod.configure("feed.backpressure:press")
        assert mod.pressure("feed.backpressure") and mod.pressure("feed.backpressure")
        assert not mod.pressure("other")
        mod.configure("feed.backpressure:press0.05")
        assert mod.pressure("feed.backpressure")
        deadline = time.monotonic() + 5.0
        while mod.pressure("feed.backpressure") and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not mod.pressure("feed.backpressure")
        mod.clear()
        assert not mod.pressure("feed.backpressure") and not mod.armed()
