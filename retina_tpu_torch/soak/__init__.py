"""Endurance soak harness (port of retina_tpu/soak/).

Drives the full engine → enrich → window-close → ship pipeline for a
configurable wall-clock duration under a rotating schedule of
heavy-tail traffic regimes (events/synthetic.py PRESETS) and injected
faults (runtime/faults.py), while leak/degradation sentinels sample
invariants every window. The run emits a SOAK_*.json per-phase
scorecard and a hard pass/fail.

- schedule.py — the declarative phase list (regime + fault spec +
  recovery deadline per phase) and the default rotations.
- sentinels.py — invariant samplers and verdicts (flat RSS, bounded
  flow-dict churn, zero stalled windows outside fault phases,
  recorder health after ring wraparound, kernel build stability,
  overload NOMINAL-return).
- runner.py — boots the real Daemon, walks the schedule, writes the
  artifact.
"""

from retina_tpu_torch.soak.schedule import SoakPhase, default_schedule
from retina_tpu_torch.soak.runner import run_soak

__all__ = ["SoakPhase", "default_schedule", "run_soak"]
