"""Self-telemetry: heartbeat with cardinality + process stats (port of
retina_tpu/telemetry.py).

Reference analog: pkg/telemetry/telemetry.go — an AppInsights client that
tracks events/metrics/panics and a heartbeat that self-reports the agent's
own metric cardinality (:170-258) and perf counters (:335-353), with a
noop fallback (noop_telemetry.go) when telemetry is disabled.

No external sink exists here (zero egress), so the "client" writes
structured heartbeat records to the log and exposes the latest heartbeat
via ``last_heartbeat`` (surfaced on /debug/vars). psutil is imported when a heartbeat first reads the
process, never at module import.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from retina_tpu_torch.exporter import Exporter, get_exporter
from retina_tpu_torch.log import logger

_log = logger("telemetry")


class Telemetry:
    """Heartbeat + perf spans (reference TelemetryClient)."""

    def __init__(
        self,
        interval_s: float = 900.0,
        exporter: Optional[Exporter] = None,
        properties: Optional[dict[str, str]] = None,
        extra: Optional[Any] = None,
    ) -> None:
        self._interval = interval_s
        self._exporter = exporter or get_exporter()
        self._props = dict(properties or {})
        # Optional zero-arg callable merged into every heartbeat —
        # used for the supervisor's thread/stall summary.
        self._extra = extra
        self._proc: Any = None  # the psutil process, made at the first heartbeat
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_heartbeat: dict[str, Any] = {}

    # -- cardinality self-report (telemetry.go:196-258) --
    def metrics_cardinality(self) -> int:
        text = self._exporter.gather_text()
        return sum(
            1
            for line in text.splitlines()
            if line and not line.startswith(b"#")
        )

    def heartbeat(self) -> dict[str, Any]:
        if self._proc is None:
            import psutil  # only here: the heartbeat's process counters

            self._proc = psutil.Process()
        with self._proc.oneshot():
            hb: dict[str, Any] = {
                "ts": time.time(),
                "metrics_cardinality": self.metrics_cardinality(),
                "cpu_percent": self._proc.cpu_percent(interval=None),
                "rss_bytes": self._proc.memory_info().rss,
                "num_threads": self._proc.num_threads(),
                **self._props,
            }
        if self._extra is not None:
            try:
                hb.update(self._extra())
            except Exception:
                _log.warning("telemetry extra callable failed", exc_info=True)
        self.last_heartbeat = hb
        _log.info(
            "heartbeat cardinality=%d rss_mb=%.1f threads=%d",
            hb["metrics_cardinality"],
            hb["rss_bytes"] / 1e6,
            hb["num_threads"],
        )
        return hb

    def start_heartbeat(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self._interval):
                try:
                    self.heartbeat()
                except Exception:
                    _log.exception("heartbeat failed")

        self._thread = threading.Thread(
            target=loop, name="telemetry-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()


class NoopTelemetry(Telemetry):
    """Disabled telemetry (reference noop_telemetry.go)."""

    def __init__(self) -> None:
        super().__init__(interval_s=1e9)

    def heartbeat(self) -> dict[str, Any]:
        return {}

    def start_heartbeat(self) -> None:
        pass


def new_telemetry(enabled: bool, interval_s: float = 900.0,
                  **kw: Any) -> Telemetry:
    return Telemetry(interval_s=interval_s, **kw) if enabled else NoopTelemetry()
