"""API-server watcher (copy of retina_tpu/watchers/apiserver.py).

Reference analog: pkg/watchers/apiserver — periodically resolves the
apiserver hostname to IPs, diffs against the last set, publishes to the
cache and adds the IPs to the filtermanager (apiserver.go:29-60), with DNS
retry (:25-27). Same here, plus pushing the IPs into the engine for the
apiserver-latency matcher (``engine.set_apiserver_ips``: K14's input).
"""

from __future__ import annotations

import socket
from typing import Callable, Optional

from retina_tpu_torch.common import TOPIC_APISERVER, retry
from retina_tpu_torch.events.schema import ip_to_u32
from retina_tpu_torch.log import logger
from retina_tpu_torch.managers.filtermanager import FilterManager
from retina_tpu_torch.pubsub import PubSub


class ApiServerWatcher:
    name = "apiserver"

    def __init__(
        self,
        pubsub: PubSub,
        host: str = "kubernetes.default.svc",
        filtermanager: Optional[FilterManager] = None,
        on_ips: Optional[Callable[[list[int]], None]] = None,
        resolver: Optional[Callable[[str], list[str]]] = None,
    ):
        self._log = logger("watcher.apiserver")
        self._ps = pubsub
        self._host = host
        self._fm = filtermanager
        self._on_ips = on_ips
        self._resolve = resolver or self._dns_resolve
        self._current: set[str] = set()

    @staticmethod
    def _dns_resolve(host: str) -> list[str]:
        infos = socket.getaddrinfo(host, 443, socket.AF_INET)
        return sorted({i[4][0] for i in infos})

    def refresh(self) -> None:
        try:
            ips = set(retry(lambda: self._resolve(self._host), attempts=3,
                            base_delay_s=0.1))
        except OSError as e:
            self._log.warning("apiserver resolve failed: %s", e)
            return
        if ips == self._current:
            return
        added = sorted(ips - self._current)
        removed = sorted(self._current - ips)
        self._current = ips
        self._log.info("apiserver IPs: %s", sorted(ips))
        u32 = [ip_to_u32(ip) for ip in sorted(ips)]
        if self._fm is not None:
            if added:
                self._fm.add_ips([ip_to_u32(i) for i in added],
                                 "apiserver-watcher", "apiserver")
            if removed:
                self._fm.delete_ips([ip_to_u32(i) for i in removed],
                                    "apiserver-watcher", "apiserver")
        if self._on_ips is not None:
            self._on_ips(u32)
        self._ps.publish(TOPIC_APISERVER, sorted(ips))
