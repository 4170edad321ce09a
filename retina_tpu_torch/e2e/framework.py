"""Runner/Job/Step: the scenario execution DSL (port of
retina_tpu/e2e/framework.py).

Reference analog: test/e2e/framework/types/runner.go:11-40 (Runner wraps a
Job, Run() + t-failure propagation), job.go:23-45 (ordered steps, values
map, fail-fast, deferred cleanup steps run even on failure), step.go
(Step interface: Prevalidate/Run/Stop).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

from retina_tpu_torch.log import logger


class StepFailed(AssertionError):
    """A step's contract was not met (scenario assertion failure)."""


class Step:
    """One typed scenario action. Subclasses set ``name`` and implement
    ``run(ctx)``; ``cleanup(ctx)`` (optional) runs in reverse order even
    when an earlier step failed — the job.go deferred-cleanup semantics.
    """

    name = "step"

    def prevalidate(self, ctx: dict[str, Any]) -> None:  # noqa: B027
        """Cheap static checks before anything runs (step.go Prevalidate)."""

    def run(self, ctx: dict[str, Any]) -> None:
        raise NotImplementedError

    def cleanup(self, ctx: dict[str, Any]) -> None:  # noqa: B027
        """Reverse-order teardown; must be idempotent and never raise."""


@dataclasses.dataclass
class Job:
    """Ordered steps sharing a ctx values dict (job.go Values)."""

    name: str
    steps: list[Step] = dataclasses.field(default_factory=list)

    def add(self, *steps: Step) -> "Job":
        self.steps.extend(steps)
        return self

    def run(self) -> dict[str, Any]:
        log = logger("e2e")
        ctx: dict[str, Any] = {"job": self.name}
        for s in self.steps:
            s.prevalidate(ctx)
        started: list[Step] = []
        t_job = time.perf_counter()
        try:
            for s in self.steps:
                t0 = time.perf_counter()
                log.info("[%s] step %s ...", self.name, s.name)
                started.append(s)
                s.run(ctx)
                log.info(
                    "[%s] step %s ok (%.2fs)",
                    self.name, s.name, time.perf_counter() - t0,
                )
            return ctx
        finally:
            for s in reversed(started):
                try:
                    s.cleanup(ctx)
                except Exception:  # noqa: BLE001 — cleanup never raises
                    log.exception("[%s] cleanup of %s failed", self.name, s.name)
            log.info(
                "[%s] done in %.2fs", self.name, time.perf_counter() - t_job
            )


class Runner:
    """Runs a Job and converts failures into test failures (runner.go)."""

    def __init__(self, job: Job):
        self.job = job

    def run(self) -> dict[str, Any]:
        return self.job.run()
