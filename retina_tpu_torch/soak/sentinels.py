"""Leak/degradation sentinels (port of retina_tpu/soak/sentinels.py): the
invariants a soak samples every window and holds at the end.

Pure evaluation over collected samples — no engine access here, so
every verdict is unit-testable with fabricated series. The runner collects one :class:`Sample`
per window per phase and asks :func:`evaluate_sentinels` for the
verdict set:

- ``rss_flat``      — post-warmup RSS least-squares slope under the
                      configured MB/min bound (a leak integrates; a
                      flat ceiling with noise does not).
- ``fd_churn``      — flow-descriptor dictionary generation bumps per
                      phase bounded (the churn regimes cycle the table
                      by design — unboundedly growing churn means the
                      table is undersized or leaking descriptors).
- ``stalled_windows`` — windows kept closing in every NON-fault phase
                      (fault phases only need the pipeline alive).
- ``recorder``      — flight recorder still enabled, spans still
                      advancing, and the per-span hot-path cost flat
                      after ring wraparound (the drift that would
                      break the existing <3% overhead guard).
- ``aot_cache``     — zero build errors, and no NEW misses after the
                      first phase (mid-soak misses mean kernels are
                      rebuilding). The port compiles nothing ahead of
                      time but its kernels: the counters are
                      ``kernels/build.py``'s (a hit a library current on
                      disk, a miss one nvcc compiled, an error a failed
                      nvcc run), where the reference reads its AOT disk
                      cache.
- ``overload_recovery`` — after every fault clears the controller
                      returned to NOMINAL inside the phase deadline,
                      and the run ends NOMINAL (no hysteresis
                      latch-up).
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any

SENTINELS = ("rss_flat", "fd_churn", "stalled_windows", "recorder",
             "aot_cache", "overload_recovery")


def rss_mb() -> float:
    """Resident set of THIS process in MB (/proc/self/status VmRSS)."""
    with open("/proc/self/status") as f:
        m = re.search(r"VmRSS:\s+(\d+) kB", f.read())
    return int(m.group(1)) / 1024.0 if m else 0.0


@dataclasses.dataclass
class Sample:
    """One sentinel sample (taken roughly once per window)."""

    t: float  # monotonic seconds since soak start
    rss_mb: float
    events_in: int
    windows_closed: float
    overload_state: str
    pressure: float
    fd_entries: int
    fd_generation: int
    recorder_spans: int  # sum of per-thread ring counts
    recorder_enabled: bool
    aot_hits: int
    aot_misses: int
    aot_errors: int


def collect_sample(t0: float, eng, metrics) -> Sample:
    """Snapshot every sentinel input from a live engine. Cheap: a few
    counter reads and one /proc read — safe at window cadence."""
    from retina_tpu_torch.kernels.build import build_stats
    from retina_tpu_torch.obs.recorder import get_recorder

    feed = eng.feed_stats()
    fd = feed.get("flow_dict") or {}
    ov = feed.get("overload") or {}
    rec = get_recorder().stats()
    aot = build_stats()
    return Sample(
        t=time.monotonic() - t0,
        rss_mb=rss_mb(),
        events_in=int(eng._events_in),
        windows_closed=float(metrics.windows_closed._value),
        overload_state=str(ov.get("state", "?")),
        pressure=float(ov.get("pressure", 0.0)),
        fd_entries=int(fd.get("entries", 0)),
        fd_generation=int(fd.get("generation", 0)),
        recorder_spans=sum(rec.get("threads", {}).values()),
        recorder_enabled=bool(rec.get("enabled", False)),
        aot_hits=int(aot.get("hits", 0)),
        aot_misses=int(aot.get("misses", 0)),
        aot_errors=int(aot.get("errors", 0)),
    )


@dataclasses.dataclass
class Verdict:
    sentinel: str
    ok: bool
    value: Any
    detail: str

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def rss_slope_mb_per_min(samples: list[Sample],
                         warmup_frac: float = 0.35) -> float:
    """Least-squares slope of RSS over time, excluding the warmup
    prefix (allocator pools, jit caches and ring buffers legitimately
    grow early — the gate is the POST-warmup ceiling)."""
    tail = samples[int(len(samples) * warmup_frac):]
    if len(tail) < 3:
        return 0.0
    n = len(tail)
    xs = [s.t / 60.0 for s in tail]  # minutes
    ys = [s.rss_mb for s in tail]
    mx = sum(xs) / n
    my = sum(ys) / n
    denom = sum((x - mx) ** 2 for x in xs)
    if denom <= 0:
        return 0.0
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom


@dataclasses.dataclass
class PhaseResult:
    """What the runner measured for one completed phase."""

    name: str
    preset: str
    fault_spec: str
    duration_s: float
    window_seconds: float
    samples: list[Sample]
    events_delta: int
    closes_delta: float
    fd_generation_delta: int
    recovery_seconds: float | None  # None = no fault armed
    recovery_deadline_s: float
    stage_report: dict[str, dict[str, float]]

    @property
    def faulted(self) -> bool:
        return bool(self.fault_spec)


def evaluate_sentinels(
    phases: list[PhaseResult],
    all_samples: list[Sample],
    *,
    rss_slope_bound_mb_per_min: float,
    fd_generations_per_phase: int,
    recorder_span_cost_us: float,
    recorder_span_cost_bound_us: float = 50.0,
    final_overload_state: str = "NOMINAL",
) -> list[Verdict]:
    """The full verdict set over a finished soak. Every sentinel
    reports a value and a human-readable detail; the run passes only
    if every verdict is ok."""
    out: list[Verdict] = []

    slope = rss_slope_mb_per_min(all_samples)
    out.append(Verdict(
        "rss_flat", slope <= rss_slope_bound_mb_per_min, round(slope, 3),
        f"post-warmup RSS slope {slope:.3f} MB/min "
        f"(bound {rss_slope_bound_mb_per_min})",
    ))

    worst_fd = max((p.fd_generation_delta for p in phases), default=0)
    out.append(Verdict(
        "fd_churn", worst_fd <= fd_generations_per_phase, worst_fd,
        f"worst per-phase flow-dict generation bumps {worst_fd} "
        f"(bound {fd_generations_per_phase})",
    ))

    stalled: list[str] = []
    for p in phases:
        expect = max(1.0, 0.5 * p.duration_s / max(p.window_seconds, 1e-9))
        floor = 1.0 if p.faulted else expect
        if p.closes_delta < floor:
            stalled.append(
                f"{p.name}: {p.closes_delta:.0f} closes "
                f"(floor {floor:.0f}{', faulted' if p.faulted else ''})"
            )
    out.append(Verdict(
        "stalled_windows", not stalled, len(stalled),
        "; ".join(stalled) if stalled else
        "windows kept closing in every phase",
    ))

    last = all_samples[-1] if all_samples else None
    spans_ok = (
        last is not None and last.recorder_enabled
        and last.recorder_spans > 0
    )
    cost_ok = recorder_span_cost_us <= recorder_span_cost_bound_us
    out.append(Verdict(
        "recorder", spans_ok and cost_ok,
        round(recorder_span_cost_us, 2),
        f"enabled={getattr(last, 'recorder_enabled', False)} "
        f"spans={getattr(last, 'recorder_spans', 0)} "
        f"span_cost={recorder_span_cost_us:.2f}us "
        f"(bound {recorder_span_cost_bound_us}us)",
    ))

    errors = last.aot_errors if last else 0
    # Misses accrued after the FIRST phase completed = mid-soak
    # recompiles (warm/boot misses are expected and excluded).
    late_misses = 0
    if len(phases) > 1 and phases[0].samples and last:
        late_misses = last.aot_misses - phases[0].samples[-1].aot_misses
    out.append(Verdict(
        "aot_cache", errors == 0 and late_misses == 0,
        {"errors": errors, "late_misses": late_misses},
        f"errors={errors} misses_after_first_phase={late_misses}",
    ))

    late: list[str] = []
    for p in phases:
        if p.recovery_seconds is None:
            continue
        if p.recovery_seconds > p.recovery_deadline_s:
            late.append(
                f"{p.name}: {p.recovery_seconds:.1f}s "
                f"(deadline {p.recovery_deadline_s:.0f}s)"
            )
    latch = final_overload_state != "NOMINAL"
    out.append(Verdict(
        "overload_recovery", not late and not latch,
        {"late": len(late), "final_state": final_overload_state},
        ("; ".join(late) + ("; " if late else "")
         + (f"final state {final_overload_state} (latch-up)" if latch
            else "every fault recovered to NOMINAL")),
    ))
    return out
