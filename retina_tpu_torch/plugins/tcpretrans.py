"""tcpretrans: TCP retransmission accounting (port of
retina_tpu/plugins/tcpretrans.py).

Reference analog: pkg/plugin/tcpretrans — the Inspektor-Gadget tcpretrans
eBPF tracer emits per-socket retransmit flows (tcpretrans_linux.go). Host
analog: node-level RetransSegs deltas from /proc/net/snmp publish the
basic series, and EV_TCP_RETRANS events from packet sources ride the
device pipeline for the per-pod advanced series (pod_retrans rectangle).
"""

from __future__ import annotations

import threading

from retina_tpu_torch.config import Config
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin
from retina_tpu_torch.sources import procfs


@registry.register
class TcpRetransPlugin(Plugin):
    name = "tcpretrans"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.proc_root = "/proc"
        self._base: int | None = None

    def _read(self) -> int:
        return procfs.read_snmp(self.proc_root).get("Tcp", {}).get(
            "RetransSegs", 0
        )

    def init(self) -> None:
        self._base = self._read()

    def read_and_publish(self) -> None:
        cur = self._read()
        base = self._base if self._base is not None else cur
        get_metrics().tcp_connection_stats.labels(
            statistic_name="RetransSegs"
        ).set(max(cur - base, 0))

    def start(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self.read_and_publish()
            except Exception:
                self.log.exception("tcpretrans read failed")
            stop.wait(self.cfg.metrics_interval_s)
