"""Monitor agent: external-channel drain + consumer fan-out (port of
retina_tpu/hubble/monitoragent.py).

Reference analog: pkg/monitoragent/monitoragent_linux.go — plugins push
events into the external channel handed out by SetupChannel
(pluginmanager.go:206-212); the monitor agent's SendEvent fans each event
out to registered consumers (:46-47, :160) — the Hubble observer chief
among them. Identical contract here over record blocks.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np

from retina_tpu_torch.log import logger

Consumer = Callable[[np.ndarray], None]


class MonitorAgent:
    def __init__(self, channel_depth: int = 256):
        self._log = logger("monitoragent")
        self.channel: queue.Queue[np.ndarray] = queue.Queue(
            maxsize=channel_depth
        )
        self._consumers: list[Consumer] = []
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def register_consumer(self, fn: Consumer) -> None:
        with self._lock:
            self._consumers.append(fn)

    def send_event(self, records: np.ndarray) -> None:
        """Direct injection (SendEvent analog)."""
        with self._lock:
            consumers = list(self._consumers)
        for c in consumers:
            try:
                c(records)
            except Exception:
                self._log.exception("consumer failed")

    def start(self, stop: threading.Event) -> None:
        def drain() -> None:
            while not stop.is_set():
                try:
                    block = self.channel.get(timeout=0.2)
                except queue.Empty:
                    continue
                self.send_event(block)

        self._thread = threading.Thread(
            target=drain, name="monitoragent", daemon=True
        )
        self._thread.start()
