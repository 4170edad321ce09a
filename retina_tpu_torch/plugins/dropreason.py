"""dropreason: packet-drop accounting (port of retina_tpu/plugins/dropreason.py).

Reference analog: pkg/plugin/dropreason — kprobes on nf_hook_slow,
tcp_v4_connect, inet_csk_accept etc. fill a per-CPU metrics map (basic
mode) and a perf ring of drop events (advanced mode),
dropreason_linux.go:296-412. Host analog, same two modes:

- **basic**: a MetricsInterval ticker reads kernel drop counters the host
  actually exposes — softnet drops (/proc/net/softnet_stat) and TcpExt
  listen/overflow drops (/proc/net/netstat) — publishing the same
  drop_count/drop_bytes gauge family keyed by reason.
- **advanced**: drop-verdict events arriving from the packet sources flow
  through the device pipeline (pod_drop rectangles, HLL per-reason
  cardinality), exactly where the reference's perf-ring drop flows end up.
"""

from __future__ import annotations

import threading

from retina_tpu_torch.config import Config
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin
from retina_tpu_torch.sources import procfs

# Reason ids 1..7 used by synthetic/pcap sources map to the reference's
# drop reasons (dropreason kprobe sites); host-derived reasons use
# names. 8..13 carry Cilium dataplane reasons mapped by the
# ciliumeventobserver ingest (sources/cilium_monitor.py) — the reason
# axis is a bounded rectangle (n_drop_reasons=16), so Cilium's sparse
# 130+ id space folds into named buckets instead of clamping to 15.
DROP_REASONS = {
    0: "unknown",
    1: "iptable_rule_drop",
    2: "iptable_nat_drop",
    3: "tcp_connect_basic",
    4: "tcp_accept_basic",
    5: "conntrack_add_drop",
    6: "softnet_drop",
    7: "listen_overflow",
    8: "policy_denied",
    9: "invalid_packet",
    10: "invalid_source_ip",
    11: "conntrack_invalid",
    12: "unsupported_proto",
    13: "cilium_other",
}


@registry.register
class DropReasonPlugin(Plugin):
    name = "dropreason"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.proc_root = "/proc"
        self._base: dict[str, int] = {}

    def _read_host_drops(self) -> dict[str, int]:
        netstat = procfs.read_netstat(self.proc_root)
        tcpext = netstat.get("TcpExt", {})
        return {
            "softnet_drop": procfs.read_softnet_drops(self.proc_root),
            "listen_overflow": tcpext.get("ListenOverflows", 0)
            + tcpext.get("ListenDrops", 0),
            "tcp_accept_basic": tcpext.get("EmbryonicRsts", 0),
        }

    def init(self) -> None:
        self._base = self._read_host_drops()  # count from plugin start

    def read_and_publish(self) -> None:
        m = get_metrics()
        cur = self._read_host_drops()
        for reason, v in cur.items():
            delta = max(v - self._base.get(reason, 0), 0)
            m.drop_count.labels(reason=reason, direction="ingress").set(delta)

    def start(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self.read_and_publish()
            except Exception:
                self.log.exception("dropreason read failed")
            stop.wait(self.cfg.metrics_interval_s)
