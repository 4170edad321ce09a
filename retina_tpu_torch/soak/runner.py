"""Soak runner (port of retina_tpu/soak/runner.py): boot the real agent,
walk the phase schedule, hold the sentinels, emit the SOAK_*.json
scorecard.

It boots a full Daemon — HTTP server, plugin manager, engine, supervisor —
exactly like production, then for each
:class:`~retina_tpu_torch.soak.schedule.SoakPhase`:

1. switches the packetparser plugin's traffic regime live
   (``set_regime``),
2. arms the phase's fault spec (runtime/faults.py) and clears it at
   phase end,
3. samples the sentinel inputs once per window
   (soak/sentinels.py :func:`collect_sample`),
4. measures fault recovery: seconds from ``faults.clear()`` to the
   overload controller reporting NOMINAL, held against the phase
   deadline.

The run FAILS (``ok=False``) unless every sentinel is green. The artifact
lands at ``<soak_artifact_dir>/SOAK_<unix-ts>.json`` with per-phase
scorecards (events, window closes, fd churn, recovery_seconds, stage
p50/p99 from the flight recorder) plus the final verdicts.

The agent runs on ``cfg.device_platform``: "" (the default) is the card,
"cpu" the plain versions. The fault layer is process-global: a soak's
presses reach every other engine of the process, so run it alone in its
process.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from typing import Any, Callable

from retina_tpu_torch.common import RetinaEndpoint
from retina_tpu_torch.config import Config
from retina_tpu_torch.obs.recorder import get_recorder
from retina_tpu_torch.runtime import faults
from retina_tpu_torch.soak.schedule import (
    SoakPhase,
    default_schedule,
    validate_schedule,
)
from retina_tpu_torch.soak.sentinels import (
    PhaseResult,
    collect_sample,
    evaluate_sentinels,
)
from retina_tpu_torch.utils import metric_names as mn

Log = Callable[[str], None]


def soak_config(**overrides) -> Config:
    """The stock soak agent config: paced synthetic feed at modest
    shapes (endurance, not peak throughput), live generation so regime
    switches take effect block-by-block, all local devices.
    ``device_platform`` stays "" (the card); pass "cpu" for the plain
    versions."""
    cfg = Config()
    cfg.api_server_addr = "127.0.0.1:0"
    cfg.enabled_plugins = ["packetparser"]
    cfg.event_source = "synthetic"
    cfg.synthetic_rate = 50_000.0
    cfg.synthetic_flows = 5000
    cfg.synthetic_pregen = 0  # regimes switch live; no stale ring
    cfg.mesh_devices = 0
    cfg.batch_capacity = 1 << 12
    cfg.n_pods = 1 << 8
    cfg.cms_width = 1 << 10
    cfg.topk_slots = 1 << 7
    cfg.hll_precision = 8
    cfg.entropy_buckets = 1 << 8
    cfg.conntrack_slots = 1 << 12
    cfg.identity_slots = 1 << 10
    cfg.flow_dict_slots = 1 << 14
    cfg.window_seconds = 1.0
    cfg.metrics_interval_s = 0.5
    cfg.bypass_lookup_ip_of_interest = True
    for k, v in overrides.items():
        setattr(cfg, k, v)
    cfg.validate()
    return cfg


def _span_cost_probe_us(n: int = 2000) -> float:
    """Measured per-span cost of the LIVE recorder's hot path, in
    microseconds. Runs after the soak traffic (rings have wrapped for
    real), on this thread's own ring — the number that would break the
    recorder's overhead bound if the record path degraded with ring
    age.

    The ``n`` spans run in 20 timed batches and the median batch's cost a
    span is the answer: a pause that is not the record
    path's (a full collection of the process heap, which the probe's own
    allocations can trigger and which takes ~0.1 s with torch loaded, or
    a preemption) lands in one batch, while a slower record path slows
    every batch."""
    rec = get_recorder()
    per = max(1, n // 20)
    costs = []
    for _ in range(20):
        t0 = time.perf_counter()
        for _ in range(per):
            b = rec.begin()
            rec.record(mn.STAGE_PUBLISH, b)
        costs.append((time.perf_counter() - t0) / per)
    return statistics.median(costs) * 1e6


def run_soak(
    total_s: float | None = None,
    smoke: bool = False,
    cfg: Config | None = None,
    schedule: list[SoakPhase] | None = None,
    log: Log = print,
    boot_timeout_s: float = 300.0,
) -> dict[str, Any]:
    """Run a full soak; returns the scorecard dict (``ok`` is the
    pass/fail gate; the same dict is written as SOAK_*.json)."""
    from retina_tpu_torch.daemon import Daemon  # late: pulls the engine
    from retina_tpu_torch.metrics import get_metrics

    if cfg is None:
        cfg = soak_config()
    if total_s is None:
        total_s = 60.0 if smoke else cfg.soak_seconds
    if schedule is None:
        if cfg.soak_phase_seconds > 0:
            total_s = cfg.soak_phase_seconds * (2 if smoke else 6)
        schedule = default_schedule(
            total_s, smoke=smoke,
            recovery_deadline_s=cfg.soak_recovery_deadline_s,
        )
    validate_schedule(schedule)
    if faults.armed():
        raise RuntimeError(
            "fault layer already armed (RETINA_FAULT_SPEC?) — the soak "
            "schedule owns fault arming; unset the static spec"
        )
    log(f"soak: {len(schedule)} phases, "
        f"{sum(p.duration_s for p in schedule):.0f}s total, "
        f"regimes {[p.preset for p in schedule]}")

    d = Daemon(cfg)
    for i in range(1, min(cfg.n_pods, 256)):
        d.cm.cache.update_endpoint(RetinaEndpoint(
            name=f"pod-{i}", namespace="default",
            ips=(f"10.0.{(i >> 8) & 0xFF}.{i & 0xFF}",),
        ))
    stop = threading.Event()
    t = threading.Thread(target=d.start, args=(stop,), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + boot_timeout_s
        port = None
        while time.monotonic() < deadline:
            if d.cm.server is not None and d.cm.engine.started.is_set():
                try:
                    port = d.cm.server.port
                    break
                except AssertionError:  # noqa: RT101 — server bound but not yet listening; next poll retries
                    pass
            time.sleep(0.1)
        if port is None:
            raise RuntimeError(
                f"soak: agent did not come up in {boot_timeout_s:.0f}s"
            )
        eng = d.cm.engine
        m = get_metrics()
        log(f"soak: agent up on :{port}")
        t_traffic = time.monotonic()
        while eng._events_in == 0:
            if not t.is_alive():
                raise RuntimeError("soak: agent thread died during boot")
            if time.monotonic() - t_traffic > boot_timeout_s:
                raise RuntimeError(
                    f"soak: no traffic within {boot_timeout_s:.0f}s"
                )
            time.sleep(0.2)
        log(f"soak: first traffic after "
            f"{time.monotonic() - t_traffic:.1f}s")
        plugin = d.cm.pluginmanager.plugins.get("packetparser")

        t0 = time.monotonic()
        all_samples = [collect_sample(t0, eng, m)]
        phase_results: list[PhaseResult] = []
        for phase in schedule:
            if plugin is not None:
                plugin.set_regime(phase.preset)
            s_start = collect_sample(t0, eng, m)
            if phase.fault_spec:
                faults.configure(phase.fault_spec)
                log(f"soak: phase {phase.name!r} preset={phase.preset} "
                    f"fault={phase.fault_spec!r} "
                    f"{phase.duration_s:.0f}s")
            else:
                log(f"soak: phase {phase.name!r} preset={phase.preset} "
                    f"clean {phase.duration_s:.0f}s")
            samples: list[Any] = []
            p_end = time.monotonic() + phase.duration_s
            while time.monotonic() < p_end:
                time.sleep(min(cfg.window_seconds,
                               max(p_end - time.monotonic(), 0.0)))
                samples.append(collect_sample(t0, eng, m))
            recovery_s: float | None = None
            if phase.fault_spec:
                faults.clear()
                t_rec = time.monotonic()
                rec_deadline = t_rec + phase.recovery_deadline_s + 5.0
                while time.monotonic() < rec_deadline:
                    if eng.overload_stats()["state"] == "NOMINAL":
                        break
                    time.sleep(0.2)
                recovery_s = time.monotonic() - t_rec
                m.soak_recovery_seconds.set(recovery_s)
                log(f"soak: phase {phase.name!r} fault cleared; "
                    f"NOMINAL after {recovery_s:.1f}s "
                    f"(deadline {phase.recovery_deadline_s:.0f}s)")
            s_end = collect_sample(t0, eng, m)
            samples.append(s_end)
            all_samples.extend(samples)
            phase_results.append(PhaseResult(
                name=phase.name,
                preset=phase.preset,
                fault_spec=phase.fault_spec,
                duration_s=phase.duration_s,
                window_seconds=cfg.window_seconds,
                samples=samples,
                events_delta=s_end.events_in - s_start.events_in,
                closes_delta=s_end.windows_closed
                - s_start.windows_closed,
                fd_generation_delta=s_end.fd_generation
                - s_start.fd_generation,
                recovery_seconds=recovery_s,
                recovery_deadline_s=phase.recovery_deadline_s,
                stage_report=get_recorder().stage_report(),
            ))
            m.soak_phases.inc()
            log(f"soak: phase {phase.name!r} done: "
                f"{phase_results[-1].events_delta} events, "
                f"{phase_results[-1].closes_delta:.0f} closes, "
                f"rss {s_end.rss_mb:.0f}MB, "
                f"overload {s_end.overload_state}")
        final_state = eng.overload_stats()["state"]
        span_cost_us = _span_cost_probe_us()
    finally:
        faults.clear()
        stop.set()
        t.join(60.0)

    verdicts = evaluate_sentinels(
        phase_results, all_samples,
        rss_slope_bound_mb_per_min=cfg.soak_rss_slope_mb_per_min,
        fd_generations_per_phase=cfg.soak_fd_generations_per_phase,
        recorder_span_cost_us=span_cost_us,
        final_overload_state=final_state,
    )
    for v in verdicts:
        if not v.ok:
            m.soak_sentinel_failures.labels(sentinel=v.sentinel).inc()
        log(f"soak: sentinel {v.sentinel}: "
            f"{'ok' if v.ok else 'FAIL'} — {v.detail}")

    result: dict[str, Any] = {
        "ok": all(v.ok for v in verdicts),
        "smoke": smoke,
        "total_s": round(sum(p.duration_s for p in schedule), 1),
        "regimes": sorted({p.preset for p in schedule}),
        "faults": [p.fault_spec for p in schedule if p.fault_spec],
        "sentinels": {v.sentinel: v.as_dict() for v in verdicts},
        "phases": [
            {
                "name": p.name,
                "preset": p.preset,
                "fault_spec": p.fault_spec,
                "duration_s": round(p.duration_s, 1),
                "events": p.events_delta,
                "window_closes": p.closes_delta,
                "fd_generation_bumps": p.fd_generation_delta,
                "recovery_seconds": (
                    None if p.recovery_seconds is None
                    else round(p.recovery_seconds, 2)
                ),
                "recovery_deadline_s": p.recovery_deadline_s,
                "rss_mb_end": round(p.samples[-1].rss_mb, 1)
                if p.samples else None,
                "overload_states": sorted(
                    {s.overload_state for s in p.samples}
                ),
                # Cumulative-to-phase-end stage p50/p99: diff
                # successive phases to see drift (the artifact keeps
                # every phase's snapshot for exactly that).
                "stage_report": p.stage_report,
            }
            for p in phase_results
        ],
        "rss_mb_series": [round(s.rss_mb, 1) for s in all_samples],
        "events_total": (
            all_samples[-1].events_in - all_samples[0].events_in
        ),
        "recorder_span_cost_us": round(span_cost_us, 2),
    }

    os.makedirs(cfg.soak_artifact_dir, exist_ok=True)
    path = os.path.join(
        cfg.soak_artifact_dir, f"SOAK_{int(time.time())}.json"
    )
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    result["artifact"] = path
    log(f"soak: {'PASS' if result['ok'] else 'FAIL'} — artifact {path}")
    return result
