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
aggregator's ring) → the Hubble control plane (``enable_hubble``: the
plugins' external channel → MonitorAgent → FlowObserver → HubbleServer's
Observer, Peer and, with the aggregator role, Fleet services, and the
hubble metrics mux) → MetricsModule (pod-level) and TracesModule → the
agent's CRD bridge (a kubeconfig or an in-cluster service account:
MetricsConfiguration and TracesConfiguration CRs reconciled into the two
modules) → resume from the checkpoint → the identity watchers (core/v1
pods, services, nodes and, with ``enable_annotations``, namespaces; or
CiliumEndpoints with ``identity_source="cilium"``) feeding the cache →
signal-driven stop event. A pod LIST pushes the filter table once, where
the reference pushes it at each listed pod (:meth:`Daemon._pod_list_scope`,
ROADMAP §3 "Settled"). A node with
``fleet_enabled`` ships each window close through its engine's shipper;
with the aggregator in the same process the in-process bus carries the
frames to it. The entry point is
:func:`run_agent`; ``python -m retina_tpu_torch agent`` calls it via the
CLI. The engine runs on ``cfg.device_platform``: "" is the card (and the
daemon raises without one), "cpu" the plain versions. With "" the engine
takes a shard a local card, at most ``mesh_devices`` of them (0: every card).

A config that turns on a part the port does not have yet raises a
``ValueError`` naming its ROADMAP item (:func:`refuse_unported`), never
starts without it: a multi-process mesh.
The reference's ``/debug/trace`` and ``/debug/profile`` routes
(obs/debug.py) are not on the port's agent mux yet either.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
from typing import Any, Optional

from retina_tpu_torch.common import TOPIC_PODS
from retina_tpu_torch.config import Config, load_config
from retina_tpu_torch.crd.types import MetricsConfiguration, TracesConfiguration
from retina_tpu_torch.log import logger, setup_logger
from retina_tpu_torch.managers.controllermanager import ControllerManager
from retina_tpu_torch.module.metrics_module import MetricsModule
from retina_tpu_torch.operator.kubeclient import in_cluster_available

# The bound on the wait for a pod LIST's events to reach the metrics module
# before its one filter push (a subscriber that hangs longer is logged).
POD_LIST_DELIVERY_S = 120.0


def refuse_unported(cfg: Config) -> None:
    """Raise a ValueError, naming the ROADMAP item, for each part of the
    reference daemon that ``cfg`` turns on and the port lacks."""
    parts = []
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
        # Identity from a real cluster (pkg/k8s watcher analog): core/v1
        # pods/services/nodes land in the cache, so enrichment works
        # without an operator. Selected by an explicit kubeconfig OR
        # automatically when running in-cluster with a service account
        # (the daemonset deployment).
        self.kubewatch = None
        self.ciliumwatch = None
        if cfg.kubeconfig or in_cluster_available():
            from retina_tpu_torch.operator.kubewatch import CoreWatcher

            use_cilium = cfg.identity_source == "cilium"
            self.kubewatch = CoreWatcher(
                self.cm.cache, cfg.kubeconfig,
                namespace=cfg.kube_namespace,
                include_pods=not use_cilium,
                include_namespaces=cfg.enable_annotations,
                pod_list_scope=self._pod_list_scope,
            )
            if use_cilium:
                # Identity from the foreign CNI's objects (cilium-crds
                # interop): CEPs instead of core/v1 pods.
                if cfg.enable_annotations:
                    # CEPs carry identity labels, not pod annotations:
                    # per-POD retina.sh=observe opt-in cannot work in
                    # this mode; namespace-level opt-in still does.
                    self.log.warning(
                        "identity_source=cilium: per-pod observe "
                        "annotations are invisible (CiliumEndpoints "
                        "carry no pod annotations); use the namespace "
                        "annotation instead"
                    )
                from retina_tpu_torch.operator.cilium import CiliumWatcher

                self.ciliumwatch = CiliumWatcher(
                    self.cm.cache, cfg.kubeconfig,
                    namespace=cfg.kube_namespace,
                    list_scope=self._pod_list_scope,
                )
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
        self.monitoragent = None
        self.observer = None
        self.hubble = None
        self.hubble_metrics_server = None
        if cfg.enable_hubble:
            self._init_hubble(cfg)
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
        # Agent-side CRD reconcile (the reference daemon watches its
        # module CRDs itself, pkg/controllers/daemon): a list+watch
        # bridge feeds a local store whose watches drive the metrics +
        # traces modules — without this, only the OPERATOR process would
        # see the CRs and the agent's modules would never reconcile.
        self.crd_bridge = None
        if cfg.kubeconfig or in_cluster_available():
            try:
                from retina_tpu_torch.operator.bridge import KubeBridge
                from retina_tpu_torch.operator.store import CRDStore

                crd_store = CRDStore()
                crd_store.watch("MetricsConfiguration", self._on_metrics_crd)
                crd_store.watch("TracesConfiguration", self._on_traces_crd)
                self.crd_bridge = KubeBridge(
                    crd_store, cfg.kubeconfig,
                    namespace=cfg.kube_namespace,
                    # Only the module CRs: Captures are the operator's
                    # business, and N agents each LISTing every Capture
                    # is pure apiserver load.
                    kinds=["MetricsConfiguration", "TracesConfiguration"],
                )
            except Exception as e:
                self.log.warning("agent CRD bridge unavailable: %s", e)

    @contextlib.contextmanager
    def _pod_list_scope(self):
        """Around a pod LIST's replay (its ADDED events and resync
        deletes): one filter-table push for the whole LIST, made once
        every pod event of the LIST has been delivered to the metrics
        module, where the reference pushes at each event. The metrics
        module derives each decision from the cache's current state, so
        the IPs pushed equal the per-event replay's last push. WATCH
        events outside a LIST push one at a time, as the reference's."""
        with self.cm.filtermanager.deferred_push():
            yield
            if not self.cm.pubsub.wait_delivered(TOPIC_PODS, POD_LIST_DELIVERY_S):
                self.log.warning("a pod LIST's events were not delivered in %.0f s; "
                                 "pushing the filter table now", POD_LIST_DELIVERY_S)

    # -- module CRD reconciles (agent side) ---------------------------
    def _on_metrics_crd(self, event: str, conf: Any) -> None:
        if self.metrics_module is None:
            return
        try:
            if event == "deleted":
                self.metrics_module.reconcile(MetricsConfiguration.default())
            elif event == "applied":
                self.metrics_module.reconcile(conf)
        except Exception:
            self.log.exception("metrics CRD reconcile failed")

    def _on_traces_crd(self, event: str, conf: Any) -> None:
        try:
            if event == "deleted":
                self.traces_module.reconcile(TracesConfiguration())
            elif event == "applied":
                self.traces_module.reconcile(conf)
        except Exception:
            self.log.exception("traces CRD reconcile failed")

    def _init_hubble(self, cfg: Config) -> None:
        """The Hubble CP rides alongside (cmd/hubble cell graph analog):
        plugins mirror events into the external channel; the monitor agent
        fans them out to the flow observer; the gRPC relay serves GetFlows
        (SURVEY.md §3.5)."""
        from retina_tpu_torch.hubble import FlowObserver, HubbleServer, MonitorAgent

        self.monitoragent = MonitorAgent()
        dns_plugin = self.cm.pluginmanager.plugins.get("dns")
        self.observer = FlowObserver(
            capacity=cfg.hubble_ring_capacity,
            cache=self.cm.cache,
            dns_resolver=(dns_plugin.resolve if dns_plugin else None),
        )
        self.monitoragent.register_consumer(self.observer.consume)
        self.cm.pluginmanager.setup_channel(self.monitoragent.channel)

        def _peers() -> list[dict[str, str]]:
            # Peer set = static config peers + the node store (nodes the
            # operator publishes land in the cache), served on the same
            # configured hubble port; with an ephemeral bind fall back to
            # our bound port.
            port = cfg.hubble_addr.rsplit(":", 1)[1]
            if port == "0" and self.hubble is not None:
                port = str(self.hubble.port)
            out = [dict(p) for p in cfg.hubble_peers]
            seen = {p.get("address") for p in out}
            for n in self.cm.cache.list_nodes():
                if n.ip and n.name != cfg.node_name:
                    addr = f"{n.ip}:{port}"
                    if addr not in seen:
                        out.append({"name": n.name, "address": addr})
            return out

        self.hubble = HubbleServer(
            self.observer,
            addr=cfg.hubble_addr,
            peers=_peers,
            node_name=cfg.node_name,
            tls_cert=cfg.hubble_tls_cert,
            tls_key=cfg.hubble_tls_key,
            tls_client_ca=cfg.hubble_tls_client_ca,
            unix_socket=cfg.hubble_sock_path,
            fleet_ingest=(self.fleet_aggregator.ingest
                          if self.fleet_aggregator is not None else None),
        )
        if cfg.hubble_metrics_addr:
            # Dedicated hubble metrics mux (:9965 analog): serves ONLY the
            # hubble registry so scraping both muxes never double-ingests
            # the node/pod families.
            from retina_tpu_torch.exporter import get_exporter
            from retina_tpu_torch.server import Server

            self.hubble_metrics_server = Server(
                cfg.hubble_metrics_addr,
                gather=get_exporter().gather_hubble_text,
                metrics_cache_ttl_s=cfg.metrics_cache_ttl_s,
            )

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
        if self.monitoragent is not None:
            self.monitoragent.start(stop)
        if self.fleet_aggregator is not None:
            self.fleet_aggregator.start()
        if self.hubble is not None:
            self.hubble.start()
            if self.hubble_metrics_server is not None:
                self.hubble_metrics_server.start()
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
        if self.kubewatch is not None:
            self.kubewatch.start()
        if self.ciliumwatch is not None:
            self.ciliumwatch.start()
        if self.crd_bridge is not None:
            self.crd_bridge.start()
        try:
            self.cm.start(stop)  # blocks until stop fires; runs shutdown
        finally:
            if self.crd_bridge is not None:
                self.crd_bridge.stop()
            if self.ciliumwatch is not None:
                self.ciliumwatch.stop()
            if self.kubewatch is not None:
                self.kubewatch.stop()
            if self.hubble is not None:
                self.hubble.stop()
                if self.hubble_metrics_server is not None:
                    self.hubble_metrics_server.stop()
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
