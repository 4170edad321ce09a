"""conntrack: shared connection-tracking table + GC loop (a copy of
retina_tpu/plugins/conntrack_gc.py; K17 counts the live connections).

Reference analog: pkg/plugin/conntrack — a 262,144-entry LRU BPF map
updated inline by packetparser's eBPF (``ct_process_packet``,
conntrack.c:344) with a Go-side GC loop expiring stale entries
(conntrack_linux.go:95-163); the plugin manager runs GC only when
packetparser is enabled (pluginmanager.go:140-151).

Here the table lives on device (ops/conntrack.py) and is updated inline by
the pipeline step — same shape as the reference. This plugin is the GC/
stats side: it periodically asks the engine to expire stale connections
(the engine's snapshot, where K17 counts them) and publishes conntrack gauges.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from retina_tpu_torch.config import Config
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin

GC_INTERVAL_S = 15.0  # reference conntrack_linux.go GC cadence


@registry.register
class ConntrackPlugin(Plugin):
    name = "conntrack"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.engine: Optional[Any] = None  # set by pluginmanager wiring

    def attach_engine(self, engine: Any) -> None:
        self.engine = engine

    def gc_once(self) -> dict[str, int]:
        if self.engine is None:
            return {}
        shed = getattr(self.engine, "shed_active", None)
        if shed is not None and shed("conntrack"):
            # Overload SHEDDING (runtime/overload.py): skip the GC +
            # gauge scrape pass — one fewer device round-trip per
            # cadence while the pipeline is saturated. The device
            # table keeps updating inline; entries just age until the
            # shed clears. Counted per skipped pass.
            self.engine.overload.note_shed("conntrack")
            return {}
        stats = self.engine.conntrack_gc()
        if stats:
            m = get_metrics()
            m.conntrack_packets.labels(direction="total").set(
                stats.get("packets", 0)
            )
            m.conntrack_bytes.labels(direction="total").set(
                stats.get("bytes", 0)
            )
            m.active_connections.set(stats.get("active", 0))
        return stats

    def start(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self.gc_once()
            except Exception:
                self.log.exception("conntrack gc failed")
            stop.wait(GC_INTERVAL_S)
