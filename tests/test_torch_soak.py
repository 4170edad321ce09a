"""The port's endurance soak harness (``soak/``) against the reference's.

Schedules: ``default_schedule`` equal phase by phase and field by field for
the smoke and the full rotation at several totals, and ``validate_schedule``'s
refusals equal on both packages. Presets: the reference test's cross-checks
(``config.validate`` <-> ``PRESETS`` <-> ``MODES`` <-> the docs) on the port's
table, and every preset's batch equal to the reference generator's.
Sentinels: ``evaluate_sentinels`` equal verdict by verdict over the reference
test's fabricated series. The port's ``aot_cache`` sentinel reads the counters
of ``kernels/build.py`` (a hit a library current on disk, a miss an nvcc
compile, an error a failed nvcc run), driven here with a stand-in compiler.
Last, ``run_soak`` through the port's ``Daemon`` on the CPU at the reference
test's 2 x 3.5 s schedule, and its refusal when the fault layer is armed.
"""

from __future__ import annotations

import json
import os
import stat
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import retina_tpu.events.synthetic as ref_synth
import retina_tpu.runtime.faults as ref_faults
import retina_tpu.soak.schedule as ref_schedule
import retina_tpu.soak.sentinels as ref_sentinels
import retina_tpu_torch.config as port_config
import retina_tpu_torch.events.synthetic as port_synth
import retina_tpu_torch.runtime.faults as port_faults
import retina_tpu_torch.soak.schedule as port_schedule
import retina_tpu_torch.soak.sentinels as port_sentinels
from retina_tpu_torch import exporter, metrics
from retina_tpu_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "reference": SimpleNamespace(schedule=ref_schedule, sentinels=ref_sentinels,
                                 faults=ref_faults),
    "port": SimpleNamespace(schedule=port_schedule, sentinels=port_sentinels,
                            faults=port_faults),
}


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


@pytest.fixture
def one_torch_thread():
    """The agent's plain versions on one intra-op thread: at these shapes
    more threads only spin, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- schedules ----------------------------------------------------------------

@pytest.mark.parametrize("smoke,total_s,recovery", [
    (True, 60.0, 30.0), (True, 7.0, 30.0), (True, 40.0, 12.5), (True, 90.0, 30.0),
    (False, 1800.0, 30.0), (False, 3600.0, 30.0), (False, 600.0, 20.0),
    (False, 10_000.0, 30.0), (False, 31.0, 30.0),
])
def test_default_schedule_equals_the_reference(smoke, total_s, recovery):
    ref = ref_schedule.default_schedule(total_s, smoke=smoke, recovery_deadline_s=recovery)
    port = port_schedule.default_schedule(total_s, smoke=smoke,
                                          recovery_deadline_s=recovery)
    assert [dataclass_fields(p) for p in port] == [dataclass_fields(p) for p in ref]
    assert not port_faults.armed()


def dataclass_fields(phase) -> dict:
    return {f: getattr(phase, f) for f in
            ("name", "preset", "duration_s", "fault_spec", "recovery_deadline_s")}


def test_full_rotation_equals_the_reference():
    assert port_schedule._FULL_ROTATION == ref_schedule._FULL_ROTATION


@pytest.mark.parametrize("pkg", PKGS)
def test_smoke_and_full_schedule_shapes(pkg):
    sch = PKGS[pkg].schedule.default_schedule(60.0, smoke=True)
    assert len(sch) == 2 and sum(p.duration_s for p in sch) == pytest.approx(60.0)
    assert len({p.preset for p in sch}) == 2
    (faulted,) = [p for p in sch if p.fault_spec]
    assert "press" in faulted.fault_spec
    full = PKGS[pkg].schedule.default_schedule(3600.0)
    assert len(full) == 12 and len({p.name for p in full}) == 12
    assert [p.preset for p in full[:6]] == [p.preset for p in full[6:]]
    assert sum(1 for p in full[:6] if p.fault_spec) == 4


def _phases(mod, case):
    P = mod.SoakPhase
    return {
        "empty": [],
        "preset": [P("x", "nosuch", 1.0)],
        "duration": [P("x", "zipf", 0.0)],
        "deadline": [P("x", "zipf", 1.0, recovery_deadline_s=-1)],
        "spec": [P("x", "zipf", 1.0, fault_spec="transfer:bogus")],
    }[case]


@pytest.mark.parametrize("case", ["empty", "preset", "duration", "deadline", "spec"])
def test_validate_schedule_refusals_equal_the_reference(case):
    errs = {}
    for pkg, p in PKGS.items():
        with pytest.raises(ValueError) as e:
            p.schedule.validate_schedule(_phases(p.schedule, case))
        errs[pkg] = str(e.value)
        assert not p.faults.armed()  # the dry run always disarms
    assert errs["port"] == errs["reference"]


@pytest.mark.parametrize("total_s", [0.0, -5.0])
def test_default_schedule_refuses_a_nonpositive_total(total_s):
    with pytest.raises(ValueError) as ref_err:
        ref_schedule.default_schedule(total_s)
    with pytest.raises(ValueError) as port_err:
        port_schedule.default_schedule(total_s)
    assert str(port_err.value) == str(ref_err.value)


def test_validate_schedule_refuses_an_armed_layer():
    port_faults.configure("transfer:raise@1")
    try:
        with pytest.raises(RuntimeError, match="disarmed"):
            port_schedule.validate_schedule(
                [port_schedule.SoakPhase("x", "zipf", 1.0, fault_spec="harvest:raise")])
        assert port_faults.armed()  # the caller's spec survives the refusal
    finally:
        port_faults.clear()


# -- presets --------------------------------------------------------------------

def test_port_presets_are_the_single_legal_source():
    assert port_synth.PRESETS == ref_synth.PRESETS
    assert port_synth.MODES == ref_synth.MODES
    for name in port_synth.PRESETS:
        port_config.Config(gen_preset=name).validate()
    with pytest.raises(ValueError, match="gen_preset"):
        port_config.Config(gen_preset="not_a_preset").validate()
    for name, params in port_synth.PRESETS.items():
        assert params.get("mode", "mix") in port_synth.MODES, name
    with open(os.path.join(REPO, "docs", "configuration.md")) as f:
        doc = f.read()
    for name in port_synth.PRESETS:
        assert name in doc, f"preset {name!r} missing from docs"


@pytest.mark.parametrize("preset", sorted(port_synth.PRESETS))
def test_every_port_preset_generates_the_reference_batch(preset):
    kw = dict(n_flows=64, n_pods=16, seed=1)
    port = port_synth.TrafficGen(**kw, **port_synth.PRESETS[preset]).batch(256)
    ref = ref_synth.TrafficGen(**kw, **ref_synth.PRESETS[preset]).batch(256)
    assert port.shape == (256, ref.shape[1])
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


# -- sentinels ------------------------------------------------------------------
# The fabricated series of the reference's tests/test_soak_harness.py, built
# with each package's own Sample and PhaseResult.

def _sample(mod, t, rss, **kw):
    d = dict(t=t, rss_mb=rss, events_in=int(t * 1000), windows_closed=float(t),
             overload_state="NOMINAL", pressure=0.0, fd_entries=100, fd_generation=0,
             recorder_spans=int(t * 10) + 1, recorder_enabled=True,
             aot_hits=5, aot_misses=2, aot_errors=0)
    d.update(kw)
    return mod.Sample(**d)


def _phase(mod, name="p", fault="", closes=30.0, fd_delta=0, recovery=None,
           deadline=30.0, samples=None):
    return mod.PhaseResult(
        name=name, preset="zipf", fault_spec=fault, duration_s=30.0, window_seconds=1.0,
        samples=samples or [_sample(mod, 0.0, 100.0), _sample(mod, 30.0, 100.0)],
        events_delta=10_000, closes_delta=closes, fd_generation_delta=fd_delta,
        recovery_seconds=recovery, recovery_deadline_s=deadline, stage_report={})


def _series(mod, case):
    """(phases, samples, evaluate kwargs) of one fabricated case."""
    S = lambda *a, **k: _sample(mod, *a, **k)  # noqa: E731
    Ph = lambda **k: _phase(mod, **k)  # noqa: E731
    two = [S(0, 100), S(60, 100)]
    p1 = Ph(samples=[S(0, 100), S(30, 100, aot_misses=4)])
    return {
        "flat": ([Ph()], [S(t, 200.0 + (t % 3)) for t in range(0, 120, 2)], {}),
        "leak": ([Ph()], [S(t, 200.0 + 0.5 * t) for t in range(0, 120, 2)], {}),
        "warmup_ramp": ([Ph()], [S(t, 200.0 + min(t, 40) * 2.5)
                                 for t in range(0, 120, 2)], {}),
        "fd_churn": ([Ph(fd_delta=3), Ph(name="q", fd_delta=20)], two, {}),
        "stalled_ok": ([Ph(closes=30.0), Ph(name="f", fault="transfer:raise@3",
                                            closes=1.0)], two, {}),
        "stalled_clean": ([Ph(name="s", closes=2.0)], two, {}),
        "stalled_faulted_dead": ([Ph(name="d", fault="harvest:hang", closes=0.0)], two, {}),
        "recorder_ok": ([Ph()], two, {}),
        "recorder_disabled": ([Ph()], [S(0, 100), S(60, 100, recorder_enabled=False)], {}),
        "recorder_slow": ([Ph()], two, {"recorder_span_cost_us": 80.0}),
        "aot_steady": ([p1, Ph(name="q")], [S(0, 100), S(60, 100, aot_misses=4)], {}),
        "aot_drift": ([p1, Ph(name="q")], [S(0, 100), S(60, 100, aot_misses=9)], {}),
        "aot_errors": ([p1, Ph(name="q")], [S(0, 100), S(60, 100, aot_errors=1)], {}),
        "recovery_fast": ([Ph(fault="transfer:raise@3", recovery=3.0)], two, {}),
        "recovery_late": ([Ph(name="l", fault="harvest:hang2", recovery=45.0)], two, {}),
        "latch_up": ([Ph(fault="transfer:raise@3", recovery=3.0)], two,
                     {"final_overload_state": "SHEDDING"}),
        "no_samples": ([], [], {}),
    }[case]


CASES = ["flat", "leak", "warmup_ramp", "fd_churn", "stalled_ok", "stalled_clean",
         "stalled_faulted_dead", "recorder_ok", "recorder_disabled", "recorder_slow",
         "aot_steady", "aot_drift", "aot_errors", "recovery_fast", "recovery_late",
         "latch_up", "no_samples"]

# Which sentinel each case trips (None: every verdict is green).
FAILS = {"leak": "rss_flat", "fd_churn": "fd_churn", "stalled_clean": "stalled_windows",
         "stalled_faulted_dead": "stalled_windows", "recorder_disabled": "recorder",
         "recorder_slow": "recorder", "aot_drift": "aot_cache", "aot_errors": "aot_cache",
         "recovery_late": "overload_recovery", "latch_up": "overload_recovery",
         "no_samples": "recorder"}


def _evaluate(mod, case):
    phases, samples, kw = _series(mod, case)
    args = dict(rss_slope_bound_mb_per_min=5.0, fd_generations_per_phase=8,
                recorder_span_cost_us=4.0)
    args.update(kw)
    return mod.evaluate_sentinels(phases, samples, **args)


@pytest.mark.parametrize("case", CASES)
def test_evaluate_sentinels_equals_the_reference(case):
    ref = [v.as_dict() for v in _evaluate(ref_sentinels, case)]
    port = [v.as_dict() for v in _evaluate(port_sentinels, case)]
    assert port == ref
    assert tuple(v["sentinel"] for v in port) == port_sentinels.SENTINELS
    failed = {v["sentinel"] for v in port if not v["ok"]}
    assert failed == ({FAILS[case]} if case in FAILS else set())


@pytest.mark.parametrize("case", ["flat", "leak", "warmup_ramp"])
def test_rss_slope_equals_the_reference(case):
    slopes = {pkg: p.sentinels.rss_slope_mb_per_min(_series(p.sentinels, case)[1])
              for pkg, p in PKGS.items()}
    assert slopes["port"] == slopes["reference"]
    if case == "leak":
        assert slopes["port"] == pytest.approx(30.0, rel=0.05)
    else:
        assert slopes["port"] < 5.0


def test_sentinel_names_equal_the_reference():
    assert port_sentinels.SENTINELS == ref_sentinels.SENTINELS


# -- the build counters behind the aot_cache sentinel -------------------------

FAKE_NVCC = """#!/bin/sh
# Stand-in compiler: writes the -o target, or fails for a source named in
# FAKE_NVCC_FAIL.
out=""
src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2;;
    *.cu) src="$1"; shift;;
    *) shift;;
  esac
done
if [ -n "$FAKE_NVCC_FAIL" ] && [ "$(basename "$src" .cu)" = "$FAKE_NVCC_FAIL" ]; then
  echo "error: stand-in refuses $src"; exit 1
fi
echo "ptxas info: stand-in" ; : > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    exe = tmp_path / "nvcc"
    exe.write_text(FAKE_NVCC)
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "nvcc", lambda: str(exe))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_stats", {"hits": 0, "misses": 0, "errors": 0})
    monkeypatch.delenv("FAKE_NVCC_FAIL", raising=False)
    return monkeypatch


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


def test_build_stats_count_misses_then_hits(fake_nvcc):
    n = len(build.KERNELS)
    s0 = build.build_stats()
    paths = build.build_all()
    assert set(paths) == set(build.KERNELS) and all(p.exists() for p in paths.values())
    s1 = build.build_stats()
    assert _delta(s0, s1) == {"hits": 0, "misses": n, "errors": 0}
    build.build_all()  # every library current on disk: all hits
    assert _delta(s1, build.build_stats()) == {"hits": n, "misses": 0, "errors": 0}


def test_build_stats_count_a_failed_compile(fake_nvcc):
    victim = sorted(build.KERNELS)[0]
    fake_nvcc.setenv("FAKE_NVCC_FAIL", victim)
    s0 = build.build_stats()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build_all()
    assert _delta(s0, build.build_stats()) == {
        "hits": 0, "misses": len(build.KERNELS) - 1, "errors": 1}
    fake_nvcc.delenv("FAKE_NVCC_FAIL")
    s1 = build.build_stats()
    build.build_all()  # only the failed one compiles again
    assert _delta(s1, build.build_stats()) == {
        "hits": len(build.KERNELS) - 1, "misses": 1, "errors": 0}


def test_aot_cache_sentinel_reads_the_build_counters(fake_nvcc):
    """A sample carries build_stats(); a rebuild after the first phase (a
    source changed on disk mid-run) is a late miss and fails the sentinel,
    a run that only loads from disk passes."""
    eng = SimpleNamespace(feed_stats=lambda: {}, _events_in=0)
    m = metrics.get_metrics()

    def sample(t0=0.0):
        s = port_sentinels.collect_sample(t0, eng, m)
        stats = build.build_stats()
        assert (s.aot_hits, s.aot_misses, s.aot_errors) == (
            stats["hits"], stats["misses"], stats["errors"])
        return s

    def verdict(phase1_end, last):
        mod = port_sentinels
        p1 = _phase(mod, samples=[phase1_end])
        p2 = _phase(mod, name="q")
        (v,) = [v for v in mod.evaluate_sentinels(
            [p1, p2], [phase1_end, last], rss_slope_bound_mb_per_min=1e9,
            fd_generations_per_phase=8, recorder_span_cost_us=1.0)
            if v.sentinel == "aot_cache"]
        return v

    build.build_all()  # boot: every kernel compiles (misses before phase 1 ends)
    end1 = sample()
    build.build_all()  # a later load: hits only
    v = verdict(end1, sample())
    assert v.ok and v.value == {"errors": 0, "late_misses": 0}
    for p in build.BUILD_DIR.glob("*.so"):
        p.unlink()  # libraries gone: the next load recompiles every kernel
    build.build_all()
    v = verdict(end1, sample())
    assert not v.ok and v.value["late_misses"] == len(build.KERNELS)


# -- run_soak through the port's Daemon on the CPU ----------------------------

def test_soak_config_runs_on_the_card_unless_told():
    from retina_tpu_torch.soak.runner import soak_config

    assert soak_config().device_platform == ""
    from retina_tpu.soak.runner import soak_config as ref_soak_config

    cfg, ref = soak_config(device_platform="cpu"), ref_soak_config()
    for f in ("api_server_addr", "enabled_plugins", "event_source", "synthetic_rate",
              "synthetic_flows", "synthetic_pregen", "mesh_devices", "batch_capacity",
              "n_pods", "cms_width", "topk_slots", "hll_precision", "entropy_buckets",
              "conntrack_slots", "identity_slots", "flow_dict_slots", "window_seconds",
              "metrics_interval_s", "bypass_lookup_ip_of_interest"):
        assert getattr(cfg, f) == getattr(ref, f), f


def test_run_soak_smoke_in_process_on_the_cpu(tmp_path, one_torch_thread):
    from retina_tpu_torch.soak.runner import run_soak, soak_config
    from retina_tpu_torch.soak.schedule import SoakPhase

    cfg = soak_config(device_platform="cpu", soak_artifact_dir=str(tmp_path),
                      soak_rss_slope_mb_per_min=10_000.0)
    sch = [SoakPhase("zipf_clean", "zipf", 3.5),
           SoakPhase("dns_press", "dns_flood", 3.5,
                     fault_spec="feed.backpressure:press1")]
    res = run_soak(cfg=cfg, schedule=sch, log=lambda m: print(m, file=sys.stderr))
    assert res["ok"], res["sentinels"]
    assert all(v["ok"] for v in res["sentinels"].values())
    assert set(res["sentinels"]) == set(port_sentinels.SENTINELS)
    assert len(res["phases"]) == 2 and res["events_total"] > 0
    assert res["phases"][0]["recovery_seconds"] is None
    rec = res["phases"][1]["recovery_seconds"]
    assert rec is not None and rec <= 30.0
    assert res["regimes"] == ["dns_flood", "zipf"]
    assert res["faults"] == ["feed.backpressure:press1"]
    assert res["sentinels"]["aot_cache"]["value"] == {"errors": 0, "late_misses": 0}
    assert os.path.basename(res["artifact"]).startswith("SOAK_")
    with open(res["artifact"]) as f:
        doc = json.load(f)
    assert doc["ok"] is True
    assert set(doc) == {"ok", "smoke", "total_s", "regimes", "faults", "sentinels",
                        "phases", "rss_mb_series", "events_total",
                        "recorder_span_cost_us"}
    assert set(doc["phases"][1]) == {
        "name", "preset", "fault_spec", "duration_s", "events", "window_closes",
        "fd_generation_bumps", "recovery_seconds", "recovery_deadline_s", "rss_mb_end",
        "overload_states", "stage_report"}
    assert not port_faults.armed()
    m = metrics.get_metrics()
    assert m.soak_phases._value == 2


def test_run_soak_refuses_an_armed_fault_layer():
    from retina_tpu_torch.soak.runner import run_soak
    from retina_tpu_torch.soak.schedule import SoakPhase

    port_faults.configure("transfer:raise@1")
    try:
        with pytest.raises(RuntimeError, match="armed"):
            run_soak(schedule=[SoakPhase("x", "zipf", 1.0)], log=lambda m: None)
    finally:
        port_faults.clear()


def test_span_cost_probe_ignores_one_pause_and_catches_a_slow_record_path(monkeypatch):
    """The probe's median batch: one long pause (a full heap collection
    landing in the probe) does not move it, a record path slower on every
    span does."""
    import time

    from retina_tpu_torch.obs.recorder import get_recorder
    from retina_tpu_torch.soak import runner

    rec = get_recorder()
    real = rec.record
    calls = [0]

    def one_pause(*a, **k):
        calls[0] += 1
        if calls[0] == 500:
            time.sleep(0.3)
        return real(*a, **k)

    monkeypatch.setattr(rec, "record", one_pause)
    assert runner._span_cost_probe_us() < 50.0  # mean over 2000 spans: > 150 us

    def slow(*a, **k):
        t = time.perf_counter() + 100e-6
        while time.perf_counter() < t:
            pass
        return real(*a, **k)

    monkeypatch.setattr(rec, "record", slow)
    assert runner._span_cost_probe_us(n=400) >= 100.0
