"""PluginManager: plugin lifecycle + supervision (port of
retina_tpu/managers/pluginmanager.py).

Reference analog: pkg/managers/pluginmanager/pluginmanager.go —
instantiate enabled plugins from the registry (:60-66), Reconcile each
(Generate→Compile→Stop→Init under a 10s SLA, :27-28, :91-113), start each
in an errgroup where any plugin's fatal error tears the whole agent down
for a clean restart (:154-179), broadcast SetupChannel (:206-212), and run
conntrack GC only when packetparser is on (:140-151).

Differences by design: plugins raising UnsupportedPlatform at reconcile
are skipped with a warning (the reference compiles them out per-OS);
reconcile failures are counted in the same
plugin_manager_failed_to_reconcile series.

Supervision: unlike the reference errgroup (one crash tears the whole
agent down), each plugin runs under a restart loop with exponential
backoff and a crash-loop circuit breaker. A crashing plugin is restarted
in place; only a plugin whose circuit opens (persistently crash-looping)
marks the manager ``failed`` so the health endpoint reports unhealthy and
the orchestrator can restart the pod — the process itself stays up and
keeps serving the remaining plugins and the engine.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Optional

from retina_tpu_torch.config import Config
from retina_tpu_torch.log import logger
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import EventSink, Plugin, UnsupportedPlatform
from retina_tpu_torch.runtime import faults
from retina_tpu_torch.runtime.supervisor import RestartPolicy, policy_from_config

RECONCILE_SLA_S = 10.0  # pluginmanager.go:25-28


class PluginManager:
    def __init__(
        self,
        cfg: Config,
        sink: Optional[EventSink] = None,
        engine: Optional[Any] = None,
    ):
        self._log = logger("pluginmanager")
        self.cfg = cfg
        self.engine = engine
        self.plugins: dict[str, Plugin] = {}
        self.errors: list[tuple[str, BaseException]] = []
        self._threads: dict[str, threading.Thread] = {}
        self._stop = threading.Event()
        self._fatal = threading.Event()
        self._policies: dict[str, RestartPolicy] = {}

        import retina_tpu_torch.plugins  # noqa: F401  (self-registration)

        enabled = list(cfg.enabled_plugins)
        # Conntrack GC rides along when packetparser is enabled
        # (pluginmanager.go:140-151).
        if "packetparser" in enabled and "conntrack" not in enabled:
            enabled.append("conntrack")
        for name in enabled:
            ctor = registry.get(name)  # KeyError is fatal, like the reference
            p = ctor(cfg)
            if sink is not None:
                p.set_sink(sink)
            self.plugins[name] = p
        if engine is not None:
            ct = self.plugins.get("conntrack")
            if ct is not None and hasattr(ct, "attach_engine"):
                ct.attach_engine(engine)
            dns = self.plugins.get("dns")
            if dns is not None and hasattr(dns, "observe_records"):
                # Named "dns": the overload controller sheds this
                # observer first under SHEDDING (runtime/overload.py).
                engine.add_observer(
                    lambda rec, plugin: dns.observe_records(rec),
                    name="dns",
                )

    # -- reconcile (pluginmanager.go:91-113) ---------------------------
    def reconcile(self, name: str) -> bool:
        p = self.plugins[name]
        t0 = time.perf_counter()
        try:
            p.generate()
            p.compile()
            p.stop()
            p.init()
        except UnsupportedPlatform as e:
            self._log.warning("plugin %s unsupported here: %s", name, e)
            del self.plugins[name]
            return False
        except Exception:
            get_metrics().plugin_reconcile_failures.labels(plugin=name).inc()
            self._log.exception("plugin %s reconcile failed", name)
            raise
        took = time.perf_counter() - t0
        if took > RECONCILE_SLA_S:
            self._log.warning(
                "plugin %s reconcile took %.1fs (SLA %.0fs)",
                name, took, RECONCILE_SLA_S,
            )
        return True

    def setup_channel(self, q: queue.Queue) -> None:
        """Broadcast the external channel (pluginmanager.go:206-212)."""
        for p in self.plugins.values():
            p.setup_channel(q)

    # -- start/stop (pluginmanager.go:116-193) -------------------------
    def start(self, stop: threading.Event) -> None:
        """Reconcile + launch every plugin; returns once all are running.

        Each plugin runs under a supervised restart loop: a crash is
        restarted with exponential backoff; a crash-looping plugin trips
        its circuit breaker, which marks the manager ``failed`` (and so
        /healthz unhealthy) without tearing the process down.
        """
        self._stop = stop
        for name in list(self.plugins):
            self.reconcile(name)

        for name, p in self.plugins.items():
            self._policies[name] = policy_from_config(
                self.cfg, seed_key=f"plugin.{name}"
            )
            t = threading.Thread(
                target=self._run_supervised,
                args=(name, p, stop),
                name=f"plugin-{name}",
                daemon=True,
            )
            t.start()
            self._threads[name] = t
        self._log.info("started plugins: %s", sorted(self.plugins))

    def _run_supervised(
        self, name: str, p: Plugin, stop: threading.Event
    ) -> None:
        policy = self._policies[name]
        while not stop.is_set():
            policy.note_start()
            try:
                faults.inject(f"plugin.{name}")
                p.start(stop)
                return  # clean exit (stop requested or plugin done)
            except UnsupportedPlatform as e:
                self._log.warning("plugin %s stopped: %s", name, e)
                return
            except Exception as e:
                self._log.exception("plugin %s crashed", name)
                self.errors.append((name, e))
                del self.errors[:-32]  # bounded crash history
            delay = policy.record_failure()
            if delay is None:
                self._log.error(
                    "plugin %s circuit OPEN (crash-looping); waiting for "
                    "half-open probe — /healthz reports unhealthy", name,
                )
                if not policy.wait_half_open(stop):
                    return
                continue
            get_metrics().plugin_restarts.labels(plugin=name).inc()
            self._log.warning(
                "restarting plugin %s in %.2fs (consecutive crashes: %d)",
                name, delay, policy.stats()["consecutive_failures"],
            )
            # Best-effort teardown + re-init so the restart starts clean.
            try:
                p.stop()
            except Exception:
                self._log.warning(
                    "plugin %s stop before restart failed", name,
                    exc_info=True,
                )
            try:
                p.init()
            except Exception:
                self._log.warning(
                    "plugin %s re-init before restart failed", name,
                    exc_info=True,
                )
            stop.wait(delay)

    def stop(self) -> None:
        self._stop.set()
        for name, t in self._threads.items():
            t.join(timeout=2.0)
        for name, p in self.plugins.items():
            try:
                p.stop()
            except Exception:
                self._log.exception("plugin %s stop failed", name)

    @property
    def failed(self) -> bool:
        """Unhealthy when any plugin's restart circuit is not closed.

        The process stays up either way; ``failed`` is surfaced through
        /healthz so the orchestrator decides whether to restart the pod.
        """
        if self._fatal.is_set():
            return True
        return any(
            pol.state != "closed" for pol in self._policies.values()
        )

    def supervision_stats(self) -> dict:
        return {
            name: pol.stats() for name, pol in sorted(self._policies.items())
        }
