"""infiniband: RDMA NIC counters (port of retina_tpu/plugins/infiniband.py).

Reference analog: pkg/plugin/infiniband — parses
``/sys/class/infiniband/*/ports/*/counters`` and per-interface debug
status params (infiniband_stats_linux.go). Identical here; on hosts
without InfiniBand hardware the sysfs tree is absent and the plugin idles
(the reference behaves the same).
"""

from __future__ import annotations

import threading

from retina_tpu_torch.config import Config
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin
from retina_tpu_torch.sources import procfs


@registry.register
class InfinibandPlugin(Plugin):
    name = "infiniband"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.sys_root = "/sys"

    def read_and_publish(self) -> None:
        m = get_metrics()
        for (dev, port), counters in procfs.read_infiniband_counters(
            self.sys_root
        ).items():
            for stat, v in counters.items():
                m.infiniband_counter_stats.labels(
                    device=dev, port=port, statistic_name=stat
                ).set(v)
        for iface, params in procfs.read_infiniband_status_params(
            self.sys_root
        ).items():
            for p, v in params.items():
                try:
                    m.infiniband_status_params.labels(
                        interface=iface, statistic_name=p
                    ).set(float(v))
                except ValueError:
                    continue  # non-numeric status param

    def start(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self.read_and_publish()
            except Exception:
                self.log.exception("infiniband read failed")
            stop.wait(self.cfg.metrics_interval_s)
