"""E2E scenario framework (port of retina_tpu/e2e/).

Reference analog: test/e2e/framework/types/{runner.go:11-40, job.go:23-45,
step.go} — a Runner executes a Job of typed Steps with fail-fast
semantics and shared values — plus the Prometheus exposition checker with
retry (test/e2e/framework/prometheus/prometheus.go:25-50). Scenarios
(drop, dns, latency, tcpflags; test/e2e/scenarios/*) boot a real agent,
drive traffic, and assert metric series THROUGH the HTTP scrape surface,
never through Python internals.

The reference runs its scenarios against an AKS/kind cluster; with no
cluster in the loop, the agent boots in-process (on the card, or on the
CPU with ``device_platform="cpu"``) and traffic enters through the plugin
sink seam — everything from the feed loop to the exposition text is the
production path. ``perf.py`` is the agent-overhead harness and ``kind.py``
the opt-in cluster harness.
"""

from retina_tpu_torch.e2e.framework import Job, Runner, Step, StepFailed
from retina_tpu_torch.e2e.prometheus import (
    PrometheusChecker,
    parse_exposition,
)
from retina_tpu_torch.e2e.steps import (
    AssertNoCrashes,
    BootAgent,
    InjectRecords,
    RegisterPods,
    ScrapeAssert,
    StopAgent,
    WaitReady,
    WaitWarm,
)

__all__ = [
    "Job",
    "Runner",
    "Step",
    "StepFailed",
    "PrometheusChecker",
    "parse_exposition",
    "AssertNoCrashes",
    "BootAgent",
    "InjectRecords",
    "RegisterPods",
    "ScrapeAssert",
    "StopAgent",
    "WaitReady",
    "WaitWarm",
]
