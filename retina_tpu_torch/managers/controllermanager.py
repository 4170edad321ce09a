"""ControllerManager: composes the HTTP server, plugin manager, engine (port
of retina_tpu/managers/controllermanager.py).

Reference analog: pkg/managers/controllermanager — Init builds the HTTP
server and (pod-level) pubsub/cache/enricher (controllermanager.go:71-90);
Start runs server + pluginmanager in an errgroup (:92-120). Here the
"enricher" seam is the SketchEngine feed loop and the identity-table
rebuild wiring (cache → engine), and servermanager is the thin HTTP
wrapper (reference pkg/servermanager). The engine runs on
``cfg.device_platform``: "" is the card (and raises without one), "cpu"
the plain versions.
"""

from __future__ import annotations

import threading
from typing import Optional

from retina_tpu_torch.config import Config
from retina_tpu_torch.controllers.cache import Cache
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.log import logger
from retina_tpu_torch.managers.filtermanager import FilterManager
from retina_tpu_torch.managers.pluginmanager import PluginManager
from retina_tpu_torch.managers.watchermanager import WatcherManager
from retina_tpu_torch.metrics import initialize_metrics
from retina_tpu_torch.pubsub import PubSub
from retina_tpu_torch.runtime import faults
from retina_tpu_torch.runtime.supervisor import Supervisor, policy_from_config
from retina_tpu_torch.server import Server
from retina_tpu_torch.telemetry import new_telemetry
from retina_tpu_torch.watchers.apiserver import ApiServerWatcher
from retina_tpu_torch.watchers.endpoint import EndpointWatcher


class ControllerManager:
    def __init__(self, cfg: Config, apiserver_host: str = ""):
        self._log = logger("controllermanager")
        self.cfg = cfg
        self.pubsub = PubSub()
        self.metrics = initialize_metrics()
        # Root of the supervision tree: every long-lived thread (feed,
        # dispatch, harvest, warm, plugins, checkpointer) registers a
        # heartbeat; the watchdog escalates stalls past the deadline.
        self.supervisor = Supervisor(
            deadline_s=cfg.watchdog_deadline_s,
            interval_s=cfg.watchdog_interval_s,
        )
        self.engine = SketchEngine(cfg, device=cfg.device_platform or None,
                                   supervisor=self.supervisor)
        self.cache = Cache(self.pubsub, max_pods=cfg.n_pods)
        self.filtermanager = FilterManager(self.engine.update_filter_ips)
        self.pluginmanager = PluginManager(
            cfg, sink=self.engine.sink, engine=self.engine
        )
        watchers: list = [EndpointWatcher(self.pubsub)]
        if apiserver_host:
            watchers.append(
                ApiServerWatcher(
                    self.pubsub,
                    host=apiserver_host,
                    filtermanager=self.filtermanager,
                    on_ips=self.engine.set_apiserver_ips,
                )
            )
        self.watchermanager = WatcherManager(watchers)
        self.telemetry = new_telemetry(
            cfg.enable_telemetry, cfg.telemetry_interval_s,
            extra=self.supervisor.summary,
        )
        self.server: Optional[Server] = None
        self._ready = threading.Event()
        self._engine_thread: Optional[threading.Thread] = None
        # One checkpoint write at a time: a periodic save still in flight
        # at shutdown shares the file's temporary name with the final save.
        self._ckpt_lock = threading.Lock()

        # Identity churn → debounced device table rebuild (the enricher's
        # cache lookup seam, enricher.go:102-135, now a device upload).
        self._ident_timer: Optional[threading.Timer] = None
        self.cache.on_identity_change(self._schedule_identity_rebuild)

    def _schedule_identity_rebuild(self) -> None:
        if self._ident_timer is not None:
            self._ident_timer.cancel()
        self._ident_timer = threading.Timer(0.05, self._rebuild_identity)
        self._ident_timer.daemon = True
        self._ident_timer.start()

    def _rebuild_identity(self) -> None:
        try:
            self.engine.update_identities(self.cache.ip_index_map())
        except Exception:
            self._log.exception("identity table rebuild failed")

    # -- lifecycle ----------------------------------------------------
    def init(self) -> None:
        """Build the HTTP server + make the engine ready (controllermanager.go
        Init + the Compile analog: the kernels' build and the boot
        dispatches, ``SketchEngine.compile``)."""
        self.server = Server(
            self.cfg.api_server_addr,
            ready_check=self._ready.is_set,
            healthy_check=lambda: not (
                self.pluginmanager.failed
                or self.engine.recovery_failed.is_set()
            ),
            metrics_cache_ttl_s=self.cfg.metrics_cache_ttl_s,
        )
        self.server.expose_var("pods", self.cache.pod_count)
        self.server.expose_var("filter_ips", self.filtermanager.ip_count)
        self.server.expose_var(
            "engine", lambda: {
                "steps": self.engine.counts.steps,
                "events_in": self.engine._events_in,
                "devices": 1,
                "degraded": self.engine.degraded,
                "restarts": self.engine.restarts,
                "recovery_failed": self.engine.recovery_failed.is_set(),
            }
        )
        self.server.expose_var("supervisor", self.supervisor.stats)
        self.server.expose_var(
            "plugin_supervision", self.pluginmanager.supervision_stats
        )
        self.server.expose_var("faults", faults.stats)
        self.server.expose_var(
            "heartbeat", lambda: self.telemetry.last_heartbeat
        )
        # Sharded-feed backpressure: per-worker fill / staged backlog /
        # handoff wait + drop counters (engine.feed_stats).
        self.server.expose_var("feed", self.engine.feed_stats)
        # Adaptive overload control: state/pressure/signals/shed set
        # (runtime/overload.py; docs/operations.md §6).
        self.server.expose_var("overload", self.engine.overload_stats)
        self.server.expose_var("top_flows", self._top_flows)
        self.server.expose_var("top_services", self._top_services)
        self.server.expose_var("top_dns", self._top_dns)
        self.engine.compile()

    # -- heavy-hitter views for /debug/vars (CLI `top` command) --------
    def _top_flows(self) -> list[list]:
        from retina_tpu_torch.events.schema import u32_to_ip

        keys, counts = self.engine.top_flows(20)
        return [
            [u32_to_ip(int(k[0])), u32_to_ip(int(k[1])),
             int(k[2]) >> 16, int(k[2]) & 0xFFFF, int(k[3]), int(c)]
            for k, c in zip(keys, counts)
        ]

    def _top_services(self) -> list[list]:
        labeler = self.cache.index_label_map()
        keys, counts = self.engine.top_services(20)
        out = []
        for k, c in zip(keys, counts):
            src = labeler.get(int(k[0]))
            dst = labeler.get(int(k[1]))
            out.append([
                src.key() if src else f"pod:{int(k[0])}",
                dst.key() if dst else f"pod:{int(k[1])}",
                int(c),
            ])
        return out

    def _top_dns(self) -> list[list]:
        dns = self.pluginmanager.plugins.get("dns")
        keys, counts = self.engine.top_dns(20)
        return [
            [dns.resolve(int(k[0])) if dns else hex(int(k[0])), int(c)]
            for k, c in zip(keys, counts)
        ]

    def start(self, stop: threading.Event) -> None:
        """Run everything; returns when ``stop`` fires (errgroup shape)."""
        assert self.server is not None, "call init() first"
        self.server.start()
        self.supervisor.start()
        self.telemetry.start_heartbeat()
        self.watchermanager.start(stop)
        self._engine_thread = threading.Thread(
            target=self.engine.start, args=(stop,), name="engine", daemon=True
        )
        self._engine_thread.start()
        self.pluginmanager.start(stop)
        self._ready.set()
        self._log.info("agent ready on %s", self.cfg.api_server_addr)
        # The reference warms the rest of its per-bucket programs here,
        # after ready (start_background_warm). The port compiles no
        # per-bucket programs: compile() built every kernel and ran the
        # boot dispatches before ready, so nothing is left to warm.
        if self.cfg.snapshot_dir and self.cfg.snapshot_interval_s > 0:
            self.supervisor.spawn(
                "checkpointer",
                lambda: self._checkpoint_loop(stop),
                stop,
                policy_from_config(self.cfg, seed_key="checkpointer"),
            )
        stop.wait()
        self.shutdown()

    def _checkpoint_loop(self, stop: threading.Event) -> None:
        """Periodic state snapshot; the shutdown save is the last line of
        defense, this bounds how much a crash-only recovery can lose."""
        path = f"{self.cfg.snapshot_dir}/sketch_state.npz"
        hb = self.supervisor.register("checkpointer")
        try:
            while True:
                hb.park()
                if stop.wait(self.cfg.snapshot_interval_s):
                    return
                hb.beat()
                if self.engine.degraded:
                    continue  # don't snapshot mid-recovery
                with self._ckpt_lock:
                    self.engine.save_snapshot_state(path)
        finally:
            self.supervisor.deregister("checkpointer")

    def shutdown(self) -> None:
        self._ready.clear()
        self.pluginmanager.stop()
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=3.0)
        if self.cfg.snapshot_dir:
            # A proxy still busy past the bound (a hung card call) would
            # hold the save past a termination grace window: skipping it
            # (the next boot starts from the last periodic checkpoint)
            # beats a SIGKILL mid-write.
            if not self.engine._proxy.fence(timeout=15.0):
                self._log.warning(
                    "device proxy busy; skipping shutdown state snapshot"
                )
            else:
                try:
                    with self._ckpt_lock:
                        self.engine.save_snapshot_state(
                            f"{self.cfg.snapshot_dir}/sketch_state.npz"
                        )
                except Exception:
                    self._log.exception("shutdown state snapshot failed")
        if self.server is not None:
            self.server.stop()
        self.supervisor.stop()
        self.telemetry.stop()
        self.pubsub.shutdown()
        self._log.info("agent shut down")
