"""Metrics module: reconciles a MetricsSpec into metric objects and publishes
them (port of retina_tpu/module/metrics_module.py).

``reconcile`` turns a MetricsConfiguration into metric objects by name,
resetting the advanced registry when the set changes; ``publish_once``
reads the engine's snapshot (``host_snapshot``: u32 leaves as uint32) and
lets each object set its labeled gauges, with per-pod labels shed under
overload SHEDDING; ``start(stop)`` publishes on the reference's adaptive
cadence. The reference's pod and namespace event handlers, which keep the
filter manager's IPs of interest, come with the daemon that wires the bus.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from retina_tpu_torch.config import Config
from retina_tpu_torch.controllers.cache import Cache
from retina_tpu_torch.crd.types import MetricsConfiguration, MetricsSpec
from retina_tpu_torch.exporter import Exporter, get_exporter
from retina_tpu_torch.log import logger
from retina_tpu_torch.module.metric_objects import (
    METRIC_CONSTRUCTORS,
    AdvMetricBase,
    PublishCtx,
    host_snapshot,
)

PUBLISH_INTERVAL_S = 1.0  # metrics_module.go:37 module interval


class MetricsModule:
    def __init__(
        self,
        cfg: Config,
        engine: Any,
        cache: Cache,
        exporter: Optional[Exporter] = None,
        dns_resolver: Any = None,
    ):
        self._log = logger("metricsmodule")
        self.cfg = cfg
        self.engine = engine
        self.cache = cache
        self.exporter = exporter or get_exporter()
        self.dns_resolver = dns_resolver
        self._lock = threading.Lock()
        self._metrics: dict[str, AdvMetricBase] = {}
        self._spec: MetricsSpec = MetricsSpec()
        # Metric objects whose publish raised (each is logged and skipped,
        # as in the reference); a caller that checks an exposition holds
        # this at 0 so that no family can go missing unnoticed.
        self.publish_failures = 0

    # -- reconcile (metrics_module.go:142-175, :205-263) ---------------
    def reconcile(self, conf: MetricsConfiguration) -> None:
        conf.validate()
        with self._lock:
            self._spec = conf.spec
            # Changed metric set ⇒ reset the advanced registry, then
            # recreate objects against the fresh registry.
            self.exporter.reset_advanced()
            self._metrics = {}
            for co in conf.spec.context_options:
                ctor = METRIC_CONSTRUCTORS.get(co.metric_name)
                if ctor is None:
                    self._log.warning("no constructor for %s", co.metric_name)
                    continue
                self._metrics[co.metric_name] = ctor(co, self.exporter)
        self._log.info(
            "metrics module reconciled: %s", sorted(self._metrics)
        )

    def enabled_metrics(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- publish loop --------------------------------------------------
    def publish_once(self) -> None:
        with self._lock:
            metrics = dict(self._metrics)
            spec = self._spec
        if not metrics:
            return
        snap = host_snapshot(self.engine.snapshot())
        shed = getattr(self.engine, "shed_active", None)
        labeler: dict = {}
        if shed is not None and shed("labels"):
            # Overload SHEDDING (runtime/overload.py): per-pod label
            # resolution is the last enrichment stage dropped — pod
            # series publish with index placeholders this pass instead
            # of walking the endpoint cache under saturation. Counted
            # per skipped pass.
            self.engine.overload.note_shed("labels")
        else:
            labeler = self.cache.index_label_map()
        ctx = PublishCtx(
            labeler=labeler,
            namespaces=spec.namespaces,
            dns_resolver=self.dns_resolver,
        )
        for name, m in metrics.items():
            try:
                m.publish(snap, ctx)
            except Exception:
                self.publish_failures += 1
                self._log.exception("metric %s publish failed", name)

    def start(self, stop: threading.Event) -> None:
        # Adaptive cadence: the 1 s module interval
        # (metrics_module.go:37) assumes a publication is cheap. When one
        # costs more (the snapshot's readback shares the link with the
        # feed path's wire; publication and render are host work), back
        # off to 4x its cost, so gauge freshness degrades before feed
        # throughput does, but never beyond 5 s, so pod gauges stay
        # fresh under sustained load.
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                self.publish_once()
            except Exception:
                self._log.exception("publish cycle failed")
            cost = time.perf_counter() - t0
            stop.wait(max(PUBLISH_INTERVAL_S, min(4 * cost, 5.0)))
