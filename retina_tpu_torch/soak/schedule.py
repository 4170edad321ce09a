"""Declarative soak schedules (port of retina_tpu/soak/schedule.py): phase →
traffic regime + fault spec + expected-recovery deadline.

A soak is a LIST of phases, not a single static RETINA_FAULT_SPEC: the
runner arms each phase's spec at phase start (faults.configure), clears
it at phase end (faults.clear), then holds the phase's recovery
deadline against the overload controller's return to NOMINAL. Regimes
come from the events/synthetic.py PRESETS table — the single legal-name
source config.validate also checks — so a schedule can only name
regimes the generator actually implements.
"""

from __future__ import annotations

import dataclasses

from retina_tpu_torch.events.synthetic import PRESETS
from retina_tpu_torch.runtime import faults


@dataclasses.dataclass(frozen=True)
class SoakPhase:
    """One soak phase: run ``preset`` traffic for ``duration_s`` with
    ``fault_spec`` armed (empty = no fault). After the spec clears,
    the overload controller must report NOMINAL within
    ``recovery_deadline_s`` (the no-hysteresis-latch-up sentinel)."""

    name: str
    preset: str
    duration_s: float
    fault_spec: str = ""
    recovery_deadline_s: float = 30.0


def validate_schedule(phases: list[SoakPhase]) -> None:
    """Reject a schedule the runner could not execute: unknown regime
    names, unparseable fault specs (checked against the REAL grammar —
    faults.configure on a scratch arm/clear cycle, so the check cannot
    drift from the injector), nonpositive durations."""
    if not phases:
        raise ValueError("soak schedule is empty")
    for p in phases:
        if p.preset not in PRESETS:
            raise ValueError(
                f"phase {p.name!r}: unknown preset {p.preset!r} "
                f"(legal: {sorted(PRESETS)})"
            )
        if p.duration_s <= 0:
            raise ValueError(
                f"phase {p.name!r}: duration_s must be > 0, "
                f"got {p.duration_s}"
            )
        if p.recovery_deadline_s <= 0:
            raise ValueError(
                f"phase {p.name!r}: recovery_deadline_s must be > 0, "
                f"got {p.recovery_deadline_s}"
            )
        if p.fault_spec:
            armed_before = faults.armed()
            if armed_before:
                raise RuntimeError(
                    "validate_schedule needs the fault layer disarmed "
                    "(a live spec would be clobbered by the dry run)"
                )
            try:
                faults.configure(p.fault_spec)  # parse-only dry run
            finally:
                faults.clear()


# The rotation order for the full schedule: every heavy-tail regime
# from the PSketch set plus the classic zipf/uniform bookends, with
# faults on alternating phases. press<N> bounds itself (the overload
# controller sees sustained synthetic backpressure for N seconds,
# then the signal drops and hysteresis must unwind); raise@N and
# hang<N> exercise the crash-only recovery paths mid-traffic.
_FULL_ROTATION: tuple[tuple[str, str, str], ...] = (
    # (phase name, preset, fault spec)
    ("warm_zipf", "zipf", ""),
    ("dns_flood_press", "dns_flood", "feed.backpressure:press{press}"),
    ("syn_storm", "syn_storm", ""),
    ("churn_transfer_fault", "conntrack_churn", "transfer:raise@3"),
    ("elephant_mice_press", "elephant_mice",
     "feed.backpressure:press{press}"),
    ("uniform_harvest_hang", "uniform", "harvest:hang2@1"),
)


def default_schedule(
    total_s: float,
    smoke: bool = False,
    recovery_deadline_s: float = 30.0,
) -> list[SoakPhase]:
    """The stock rotation sized to ``total_s`` wall-clock.

    ``smoke`` (CI): exactly two phases — one clean heavy-tail regime,
    one regime with a bounded backpressure fault — fitting a <=90 s
    budget. Full mode: the 6-phase rotation repeated to fill
    ``total_s`` (>=30 min on hardware), each pass reusing the same
    phase structure so per-phase scorecards are comparable across
    passes.
    """
    if total_s <= 0:
        raise ValueError(f"total_s must be > 0, got {total_s}")
    if smoke:
        per = total_s / 2.0
        # Press for a third of the phase: long enough to push the
        # controller out of NOMINAL, short enough that recovery (exit
        # dwell included) completes inside the phase tail.
        press = max(2, int(per / 3))
        phases = [
            SoakPhase("zipf_clean", "zipf", per,
                      recovery_deadline_s=recovery_deadline_s),
            SoakPhase("dns_flood_press", "dns_flood", per,
                      fault_spec=f"feed.backpressure:press{press}",
                      recovery_deadline_s=recovery_deadline_s),
        ]
        validate_schedule(phases)
        return phases
    rotation = len(_FULL_ROTATION)
    passes = max(1, round(total_s / (rotation * 300.0)))
    per = total_s / (rotation * passes)
    press = max(5, int(per / 6))
    phases: list[SoakPhase] = []
    for i in range(passes):
        for name, preset, spec in _FULL_ROTATION:
            phases.append(SoakPhase(
                name=f"{name}_p{i}" if passes > 1 else name,
                preset=preset,
                duration_s=per,
                fault_spec=spec.format(press=press),
                recovery_deadline_s=recovery_deadline_s,
            ))
    validate_schedule(phases)
    return phases
