"""Reusable typed scenario steps (port of retina_tpu/e2e/steps.py).

Reference analog: test/e2e/framework/kubernetes/ (22 reusable steps:
create-agnhost-statefulset, apply network policy, exec-pod, port-forward,
install-retina-helm, no-crashes, ...). The cluster seams become the
in-process agent seams: BootAgent replaces helm-install + daemonset
scheduling, InjectRecords replaces agnhost traffic generation (records
enter through the SAME plugin sink the production sources use), and
ScrapeAssert is the identical scrape-side contract.

The agent runs on ``cfg.device_platform``: "" (the default) is the card,
"cpu" the plain versions. It takes one shard a device, at most
``mesh_devices`` of them, so ``small_agent_config``'s ``mesh_devices = 2``
runs one shard on the CPU and one on a one-card host; the scenarios
assert through the scrape, which does not depend on the shard count.
"""

from __future__ import annotations

import threading
import time
import urllib.request
from typing import Any, Callable

import numpy as np

from retina_tpu_torch.common import RetinaEndpoint
from retina_tpu_torch.config import Config
from retina_tpu_torch.e2e.framework import Step, StepFailed
from retina_tpu_torch.e2e.prometheus import PrometheusChecker


def small_agent_config(**overrides: Any) -> Config:
    """A tiny-shape agent Config that boots fast (on the card unless
    ``device_platform="cpu"`` is among the overrides)."""
    cfg = Config()
    cfg.api_server_addr = "127.0.0.1:0"
    # No plugin-driven sources: scenario traffic enters via InjectRecords
    # through the same sink seam the production sources write to.
    cfg.enabled_plugins = []
    cfg.event_source = "synthetic"
    cfg.mesh_devices = 2
    cfg.batch_capacity = 1 << 10
    cfg.n_pods = 1 << 8
    cfg.cms_width = 1 << 10
    cfg.topk_slots = 1 << 7
    cfg.hll_precision = 8
    cfg.entropy_buckets = 1 << 8
    cfg.conntrack_slots = 1 << 10
    cfg.identity_slots = 1 << 10
    cfg.window_seconds = 0.3
    cfg.metrics_interval_s = 0.2
    cfg.bypass_lookup_ip_of_interest = True
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


class BootAgent(Step):
    """Start a full Daemon in a thread; publish daemon/stop/port to ctx."""

    name = "boot-agent"

    def __init__(self, cfg: Config | None = None, timeout_s: float = 60.0):
        self.cfg = cfg or small_agent_config()
        self.timeout_s = timeout_s

    def run(self, ctx: dict[str, Any]) -> None:
        from retina_tpu_torch.daemon import Daemon

        d = Daemon(self.cfg)
        stop = threading.Event()
        t = threading.Thread(target=d.start, args=(stop,),
                             name="e2e-agent", daemon=True)
        t.start()
        ctx["daemon"], ctx["stop"], ctx["thread"] = d, stop, t
        deadline = time.monotonic() + self.timeout_s
        while time.monotonic() < deadline:
            if d.cm.server is not None and d.cm.engine.started.is_set():
                try:
                    ctx["port"] = d.cm.server.port
                    return
                except AssertionError:  # noqa: RT101 — server port not bound yet; poll loop
                    pass
            if not t.is_alive():
                raise StepFailed("agent thread died during boot")
            time.sleep(0.1)
        raise StepFailed(f"agent did not come up in {self.timeout_s}s")

    def cleanup(self, ctx: dict[str, Any]) -> None:
        if "stop" in ctx:
            ctx["stop"].set()
            ctx["thread"].join(10.0)


class WaitReady(Step):
    """Poll /readyz until 200 (kubelet readiness-probe analog)."""

    name = "wait-ready"

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s

    def run(self, ctx: dict[str, Any]) -> None:
        deadline = time.monotonic() + self.timeout_s
        url = f"http://127.0.0.1:{ctx['port']}/readyz"
        while time.monotonic() < deadline:
            try:
                if urllib.request.urlopen(url, timeout=2).status == 200:
                    return
            except Exception:  # noqa: RT101 — readiness poll; failure = retry
                pass
            time.sleep(0.1)
        raise StepFailed("readyz never turned 200")


class WaitWarm(Step):
    """Wait until the agent's engine is warm. The reference warms its
    bucket grid in the background after ready, and scenarios that assert
    TIME-SENSITIVE behavior (e.g. one anomaly window per wall-clock window)
    wait for it. The port's ``compile()`` builds every kernel and runs the
    boot dispatches before the agent reports ready and nothing warms
    after, so the engine is warm once its feed loop has started; this step
    waits for that, with the same bound."""

    name = "wait-warm"

    def __init__(self, timeout_s: float = 120.0):
        self.timeout_s = timeout_s

    def run(self, ctx: dict[str, Any]) -> None:
        eng = ctx["daemon"].cm.engine
        if not eng.started.wait(self.timeout_s):
            raise StepFailed(
                f"engine feed loop not started in {self.timeout_s}s"
            )


class RegisterPods(Step):
    """Publish pod identities into the cache (the k8s watcher seam)."""

    name = "register-pods"

    def __init__(self, pods: dict[str, str],
                 annotations: dict[str, dict[str, str]] | None = None):
        """pods: name -> ip; annotations: name -> {key: value} (the
        retina.sh=observe opt-in scenarios)."""
        self.pods = pods
        self.annotations = annotations or {}

    def run(self, ctx: dict[str, Any]) -> None:
        d = ctx["daemon"]
        for name, ip in self.pods.items():
            ann = tuple(sorted(self.annotations.get(name, {}).items()))
            d.cm.cache.update_endpoint(
                RetinaEndpoint(name=name, namespace="default", ips=(ip,),
                               annotations=ann)
            )
        # Identity reconcile is debounced; wait for the device table.
        time.sleep(0.2)


class InjectRecords(Step):
    """Feed event records through the plugin sink seam (trafficgen)."""

    name = "inject-records"

    def __init__(self, make: Callable[[], np.ndarray], plugin: str = "e2e"):
        self.make = make
        self.plugin = plugin

    def run(self, ctx: dict[str, Any]) -> None:
        rec = self.make()
        ctx["daemon"].cm.engine.sink.write_records(rec, self.plugin)


class ScrapeAssert(Step):
    """Assert a metric series through the real HTTP scrape surface."""

    name = "scrape-assert"

    def __init__(
        self,
        metric: str,
        labels: dict[str, str] | None = None,
        value: Callable[[float], bool] | float | None = None,
        timeout_s: float = 30.0,
        absent: bool = False,
    ):
        """``absent=True`` asserts the series does NOT exist — one
        scrape, no retry; sequence it AFTER a positive assert so the
        data path is known to have flowed."""
        if absent and value is not None:
            raise ValueError(
                "ScrapeAssert: 'absent' and 'value' are mutually "
                "exclusive — the absent branch never consults value"
            )
        self.metric = metric
        self.labels = labels
        self.value = value
        self.timeout_s = timeout_s
        self.absent = absent
        self.name = f"scrape-assert{'-absent' if absent else ''}:{metric}"

    def run(self, ctx: dict[str, Any]) -> None:
        checker = PrometheusChecker(
            f"http://127.0.0.1:{ctx['port']}/metrics",
            timeout_s=self.timeout_s,
        )
        if self.absent:
            samples = checker.scrape()
            hits = [s for s in checker._match(samples, self.metric,
                                              self.labels)
                    if s.value != 0]
            if hits:
                raise StepFailed(
                    f"expected NO {self.metric}{self.labels} series, "
                    f"found {hits[:3]}"
                )
            return
        sample = checker.check_metric(self.metric, self.labels, self.value)
        ctx.setdefault("samples", {})[self.metric] = sample


class AssertNoCrashes(Step):
    """The no-crashes gate (framework/kubernetes/no-crashes.go): agent
    thread alive, /healthz green, zero plugin reconcile failures."""

    name = "no-crashes"

    def run(self, ctx: dict[str, Any]) -> None:
        if not ctx["thread"].is_alive():
            raise StepFailed("agent thread not alive")
        url = f"http://127.0.0.1:{ctx['port']}/healthz"
        if urllib.request.urlopen(url, timeout=2).status != 200:
            raise StepFailed("healthz not 200")
        if ctx["daemon"].cm.pluginmanager.failed:
            raise StepFailed("plugin manager reports failed plugins")


class StopAgent(Step):
    """Explicit early stop (normally BootAgent.cleanup handles it)."""

    name = "stop-agent"

    def run(self, ctx: dict[str, Any]) -> None:
        ctx["stop"].set()
        ctx["thread"].join(10.0)
        if ctx["thread"].is_alive():
            raise StepFailed("agent did not shut down within 10s")
