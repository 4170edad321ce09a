"""packetforward: node-level forwarded packet/byte counters (port of
retina_tpu/plugins/packetforward.py).

Reference analog: pkg/plugin/packetforward — a BPF socket filter on eth0
counts {ingress,egress} × {packets,bytes} into a per-CPU map a Go ticker
reads as deltas (packetforward_linux.go, _cprog/packetforward.c:29-58).
Host analog: the kernel already keeps exactly these counters per NIC;
read ``psutil.net_io_counters`` deltas per MetricsInterval and publish the
same two gauge families (psutil is imported on the first read).
"""

from __future__ import annotations

import threading

from retina_tpu_torch.config import Config
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin


@registry.register
class PacketForwardPlugin(Plugin):
    name = "packetforward"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self._prev: tuple[int, int, int, int] | None = None
        self._totals = [0, 0, 0, 0]  # in_pkts, out_pkts, in_bytes, out_bytes

    def _read(self) -> tuple[int, int, int, int]:
        import psutil  # only here: the one plugin that reads NIC counters

        io = psutil.net_io_counters(pernic=self.cfg.capture_iface != "")
        if self.cfg.capture_iface:
            io = io.get(self.cfg.capture_iface)
            if io is None:
                return (0, 0, 0, 0)
        return (io.packets_recv, io.packets_sent, io.bytes_recv, io.bytes_sent)

    def read_and_publish(self) -> None:
        cur = self._read()
        if self._prev is not None:
            # Publish cumulative deltas since plugin start (the reference
            # publishes running totals read from the map; counters reset
            # with the agent either way).
            for i in range(4):
                d = cur[i] - self._prev[i]
                if d > 0:
                    self._totals[i] += d
        self._prev = cur
        m = get_metrics()
        m.forward_count.labels(direction="ingress").set(self._totals[0])
        m.forward_count.labels(direction="egress").set(self._totals[1])
        m.forward_bytes.labels(direction="ingress").set(self._totals[2])
        m.forward_bytes.labels(direction="egress").set(self._totals[3])

    def start(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self.read_and_publish()
            except Exception:
                self.log.exception("packetforward read failed")
            stop.wait(self.cfg.metrics_interval_s)
