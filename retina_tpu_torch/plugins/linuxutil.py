"""linuxutil: host networking stats, no packet path (port of
retina_tpu/plugins/linuxutil.py).

Reference analog: pkg/plugin/linuxutil — a MetricsInterval ticker parses
``/proc/net/netstat`` + ``/proc/net/snmp`` (netstat_stats_linux.go:20-21)
and per-NIC ethtool counters (ethtool_stats_linux.go) into gauges, with an
LRU of NICs that don't support stats. Here the NIC counters come from
``/sys/class/net/*/statistics`` (same numbers, no ioctl) and virtual
interfaces are skipped like the reference skips unsupported ones.
"""

from __future__ import annotations

import threading

from retina_tpu_torch.config import Config
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin
from retina_tpu_torch.sources import procfs

# TCP state gauge comes from SNMP Tcp counters the kernel exposes.
_TCP_STATS = ("ActiveOpens", "PassiveOpens", "AttemptFails", "EstabResets",
              "CurrEstab", "InSegs", "OutSegs", "RetransSegs", "InErrs",
              "OutRsts")
_UDP_STATS = ("InDatagrams", "NoPorts", "InErrors", "OutDatagrams",
              "RcvbufErrors", "SndbufErrors")
_IP_STATS = ("InReceives", "InHdrErrors", "InAddrErrors", "ForwDatagrams",
             "InDiscards", "InDelivers", "OutRequests", "OutDiscards",
             "OutNoRoutes")
_IFACE_STATS = ("rx_bytes", "tx_bytes", "rx_packets", "tx_packets",
                "rx_errors", "tx_errors", "rx_dropped", "tx_dropped")


@registry.register
class LinuxUtilPlugin(Plugin):
    name = "linuxutil"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.proc_root = "/proc"
        self.sys_root = "/sys"
        self._unsupported: set[str] = set()  # LRU-of-unsupported analog

    def read_and_publish(self) -> None:
        m = get_metrics()
        snmp = procfs.read_snmp(self.proc_root)
        netstat = procfs.read_netstat(self.proc_root)
        tcp = {**snmp.get("Tcp", {}), **netstat.get("TcpExt", {})}
        for k in _TCP_STATS:
            if k in tcp:
                m.tcp_connection_stats.labels(statistic_name=k).set(tcp[k])
        udp = snmp.get("Udp", {})
        for k in _UDP_STATS:
            if k in udp:
                m.udp_connection_stats.labels(statistic_name=k).set(udp[k])
        ip = snmp.get("Ip", {})
        for k in _IP_STATS:
            if k in ip:
                m.ip_connection_stats.labels(statistic_name=k).set(ip[k])
        for iface, stats in procfs.read_iface_stats(self.sys_root).items():
            if iface in self._unsupported:
                continue
            if not any(stats.get(s) for s in _IFACE_STATS):
                self._unsupported.add(iface)  # idle/virtual NIC: skip forever
                continue
            for k in _IFACE_STATS:
                if k in stats:
                    m.interface_stats.labels(
                        interface_name=iface, statistic_name=k
                    ).set(stats[k])

    def start(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self.read_and_publish()
            except Exception:
                self.log.exception("linuxutil read failed")
            stop.wait(self.cfg.metrics_interval_s)
