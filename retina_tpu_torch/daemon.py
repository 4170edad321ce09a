"""Standard agent daemon: the boot sequence (port of retina_tpu/daemon.py).

Reference analog: cmd/standard/daemon.go:80-323 — Daemon.Start loads
config, sets up zap + telemetry + metrics, builds the controller-runtime
manager, wires pubsub/cache/enricher/filtermanager/metrics-module when
pod-level is on (:239-295), then runs the controller manager until SIGTERM
cancels the context and the Stop cascade runs.

Here: config → logging → ControllerManager (server + engine + plugins +
watchers) → the fleet aggregator role (``fleet_aggregator``) → the
time-travel query route over the engine's ring and the aggregator's
merged-epoch ring, the closed-loop capture and the detector bank → the
fleet query plane (``fleetquery_enabled``: ``GET /fleet/query`` over the
aggregator's ring) → MetricsModule (pod-level) and TracesModule → resume
from the checkpoint → signal-driven stop event. A node with
``fleet_enabled`` ships each window close through its engine's shipper;
with the aggregator in the same process the in-process bus carries the
frames to it. The entry point is
:func:`run_agent`; ``python -m retina_tpu_torch agent`` calls it via the
CLI. The engine runs on ``cfg.device_platform``: "" is the card (and the
daemon raises without one), "cpu" the plain versions. With "" the engine
takes a shard a local card, at most ``mesh_devices`` of them (0: every card).

A config that turns on a part the port does not have yet raises a
``ValueError`` naming its ROADMAP item (:func:`refuse_unported`), never
starts without it: the Hubble relay, identity from a real cluster (a
kubeconfig or an in-cluster service account) and a multi-process mesh.
The reference's ``/debug/trace`` and ``/debug/profile`` routes
(obs/debug.py) are not on the port's agent mux yet either.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Any, Optional

from retina_tpu_torch.config import Config, load_config
from retina_tpu_torch.crd.types import MetricsConfiguration
from retina_tpu_torch.log import logger, setup_logger
from retina_tpu_torch.managers.controllermanager import ControllerManager
from retina_tpu_torch.module.metrics_module import MetricsModule

# The reference daemon's in-cluster check (operator/kubeclient.py): a
# service account is mounted and the apiserver's address is in the env.
_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def in_cluster_available(sa_dir: str = _SA_DIR) -> bool:
    return bool(os.environ.get("KUBERNETES_SERVICE_HOST")) and os.path.exists(
        os.path.join(sa_dir, "token")
    )


def refuse_unported(cfg: Config) -> None:
    """Raise a ValueError, naming the ROADMAP item, for each part of the
    reference daemon that ``cfg`` turns on and the port lacks."""
    parts = []
    if cfg.enable_hubble:
        parts.append("enable_hubble (the Hubble relay, hubble/: ROADMAP §1 item 7)")
    if cfg.kubeconfig or in_cluster_available():
        parts.append("kubeconfig or an in-cluster service account (identity from "
                     "a real cluster, operator/kubewatch.py and the CRD bridge: "
                     "ROADMAP §1 item 7)")
    if cfg.distributed_coordinator:
        parts.append("distributed_coordinator (an agent over several processes, whose "
                     "closes and scrapes must call the mesh's collectives in the same "
                     "order on every rank: ROADMAP §1 item 5)")
    if parts:
        raise ValueError("not ported yet: " + "; ".join(parts))


class Daemon:
    def __init__(self, cfg: Config, apiserver_host: str = ""):
        self.cfg = cfg
        self.log = logger("daemon")
        refuse_unported(cfg)
        if cfg.fault_spec:
            # Deterministic fault injection (chaos testing): armed only
            # when explicitly configured (RETINA_FAULT_SPEC / config).
            from retina_tpu_torch.runtime import faults

            faults.configure(cfg.fault_spec)
            self.log.warning("fault injection armed: %s", cfg.fault_spec)
        self.cm = ControllerManager(cfg, apiserver_host=apiserver_host)
        self.metrics_module: Optional[MetricsModule] = None
        self._mm_thread: Optional[threading.Thread] = None
        # Fleet rollup tier (fleet/): the aggregator role is explicit
        # config. One operator-side process merges the cluster's shipped
        # snapshots on its card.
        self.fleet_aggregator = None
        if cfg.fleet_aggregator:
            from retina_tpu_torch.fleet.aggregator import FleetAggregator

            self.fleet_aggregator = FleetAggregator(
                cfg, device=self.cm.engine.device, supervisor=self.cm.supervisor)
        # Time-travel query tier (timetravel/): one QueryService owns the
        # fold and every ring of this process: the engine's per-window ring
        # and, with the aggregator role, its merged-epoch ring. The closed
        # loop (autocapture) rides the same service.
        self.query_service = None
        self.autocapture = None
        if cfg.timetravel_enabled:
            from retina_tpu_torch.timetravel.query import QueryService

            self.query_service = QueryService(
                cfg, overload=self.cm.engine._overload,
                device=self.cm.engine.device,
            )
            if self.cm.engine.timetravel_ring is not None:
                self.query_service.add_ring(self.cm.engine.timetravel_ring)
            if (self.fleet_aggregator is not None
                    and self.fleet_aggregator.epoch_ring is not None):
                self.query_service.add_ring(self.fleet_aggregator.epoch_ring)
            if cfg.autocapture_enabled:
                from retina_tpu_torch.capture.manager import CaptureManager
                from retina_tpu_torch.capture.providers import ReplayProvider
                from retina_tpu_torch.timetravel.autocapture import AutoCapture

                self.autocapture = AutoCapture(
                    cfg, self.query_service,
                    CaptureManager(ReplayProvider(engine=self.cm.engine)),
                    ring_name="engine",
                )
                self.cm.engine.anomaly_hook = self.autocapture.notify
        # Detector bank (detect/): every registered detector judged at
        # window close over the engine's record tap; accepted firings
        # land in the same closed loop as the entropy hook
        # (AutoCapture.notify) when autocapture is on.
        self.detector_bank = None
        if cfg.detectors_enabled:
            from retina_tpu_torch.detect import build_default_bank
            from retina_tpu_torch.fleet.shipper import window_epoch

            sink = self.autocapture.notify if self.autocapture is not None else None
            self.detector_bank = build_default_bank(
                cfg, sink=sink, device=self.cm.engine.device)

            def _record_tap(records, now_s, _bank=self.detector_bank,
                            _win=cfg.window_seconds):
                _bank.observe(window_epoch(_win), records, now_s=float(now_s))

            self.cm.engine.record_hook = _record_tap
        # Fleet query plane (fleetquery/): cluster-wide range answers over
        # the aggregator's merged-epoch ring when this process has the role.
        self.fleetquery = None
        if cfg.fleetquery_enabled:
            from retina_tpu_torch.fleetquery import FleetQueryService

            self.fleetquery = FleetQueryService(
                cfg, overload=self.cm.engine._overload, device=self.cm.engine.device)
            if (self.fleet_aggregator is not None
                    and self.fleet_aggregator.epoch_ring is not None):
                self.fleetquery.add_ring(self.fleet_aggregator.epoch_ring)
        if cfg.enable_pod_level:
            dns_plugin = self.cm.pluginmanager.plugins.get("dns")
            self.metrics_module = MetricsModule(
                cfg,
                engine=self.cm.engine,
                cache=self.cm.cache,
                filtermanager=self.cm.filtermanager,
                pubsub=self.cm.pubsub,
                dns_resolver=(dns_plugin.resolve if dns_plugin else None),
            )
        # Per-flow trace sampling off the record stream (module/traces):
        # idle until a TracesConfiguration reconcile names targets,
        # queried via /debug/vars -> CLI `trace`.
        from retina_tpu_torch.module.traces import TracesModule

        self.traces_module = TracesModule()
        self.traces_module.attach(self.cm.engine)

    def start(self, stop: threading.Event) -> None:
        self.log.info(
            "starting retina-tpu agent: plugins=%s source=%s pod_level=%s device=%s",
            self.cfg.enabled_plugins, self.cfg.event_source,
            self.cfg.enable_pod_level, self.cm.engine.device,
        )
        self.cm.init()
        if self.cm.server is not None:
            from retina_tpu_torch.module.traces import MAX_EVENTS_PER_TARGET

            self.cm.server.expose_var(
                "traces",
                lambda: self.traces_module.traces(limit=MAX_EVENTS_PER_TARGET),
            )
            self.cm.server.expose_var("traces_stats", self.traces_module.stats)
        if self.query_service is not None and self.cm.server is not None:
            # /timetravel/query + the ring debug var ride the agent mux;
            # registration is a dict insert, safe while the server serves.
            self.query_service.attach(self.cm.server)
        if self.fleetquery is not None and self.cm.server is not None:
            # /fleet/query and the fleetquery debug var, the same shape.
            self.fleetquery.attach(self.cm.server)
        if self.autocapture is not None:
            self.autocapture.start()
        if self.fleet_aggregator is not None:
            self.fleet_aggregator.start()
        if self.metrics_module is not None:
            self.metrics_module.reconcile(MetricsConfiguration.default())
            self._mm_thread = threading.Thread(
                target=self.metrics_module.start, args=(stop,),
                name="metricsmodule", daemon=True,
            )
            self._mm_thread.start()
        if self.cfg.snapshot_dir:
            path = os.path.join(self.cfg.snapshot_dir, "sketch_state.npz")
            if os.path.exists(path):
                # Crash-only contract: load_snapshot_state never raises — an
                # unreadable checkpoint is quarantined to .bad and we
                # cold-start.
                if self.cm.engine.load_snapshot_state(path):
                    self.log.info("resumed sketch state from %s", path)
                else:
                    self.log.warning("checkpoint at %s unusable; cold-starting", path)
        try:
            self.cm.start(stop)  # blocks until stop fires; runs shutdown
        finally:
            if self.fleet_aggregator is not None:
                self.fleet_aggregator.stop()
                ring = self.fleet_aggregator.timetravel_ring
                if ring is not None:
                    ring.stop()
            if self.autocapture is not None:
                self.autocapture.stop()
            if self.detector_bank is not None:
                # Judge the in-progress window before the loop dies.
                self.detector_bank.flush()
            if self.fleetquery is not None:
                self.fleetquery.close()


def run_agent(
    config_path: str | None = None,
    overrides: dict[str, Any] | None = None,
    apiserver_host: str = "",
    install_signals: bool = True,
) -> Daemon:
    """Build + run the agent (blocking). SIGTERM/SIGINT → clean stop."""
    cfg = load_config(config_path, overrides=overrides)
    setup_logger(cfg.log_level, cfg.log_file)
    stop = threading.Event()
    if install_signals:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
    d = Daemon(cfg, apiserver_host=apiserver_host)
    d.start(stop)
    return d
