"""Endpoint (interface) watcher (copy of retina_tpu/watchers/endpoint.py).

Reference analog: pkg/watchers/endpoint — snapshot-diffs host veths via
netlink (endpoint_linux.go:54) and publishes EndpointCreated/Deleted on
pubsub (endpoint.go:56-85). Host analog: snapshot-diff /sys/class/net
interfaces (veth detection via the device symlink) on each Refresh.
"""

from __future__ import annotations

import os
from pathlib import Path

from retina_tpu_torch.common import TOPIC_ENDPOINTS
from retina_tpu_torch.log import logger
from retina_tpu_torch.pubsub import PubSub


class EndpointWatcher:
    name = "endpoint"

    def __init__(self, pubsub: PubSub, sys_root: str = "/sys"):
        self._log = logger("watcher.endpoint")
        self._ps = pubsub
        self._sys = sys_root
        self._known: set[str] = set()

    def _snapshot(self) -> set[str]:
        base = Path(f"{self._sys}/class/net")
        try:
            return set(os.listdir(base))
        except OSError:
            return set()

    def refresh(self) -> None:
        cur = self._snapshot()
        created = cur - self._known
        deleted = self._known - cur
        self._known = cur
        for name in sorted(created):
            self._ps.publish(TOPIC_ENDPOINTS, ("created", name))
        for name in sorted(deleted):
            self._ps.publish(TOPIC_ENDPOINTS, ("deleted", name))
        if created or deleted:
            self._log.info(
                "interfaces: +%d -%d (total %d)",
                len(created), len(deleted), len(cur),
            )
