"""WatcherManager: runs watchers on a refresh ticker (copy of
retina_tpu/managers/watchermanager.py).

Reference analog: pkg/managers/watchermanager — starts each watcher and
calls Refresh on a 30s ticker (watchermanager.go:18-19,66-76).
"""

from __future__ import annotations

import threading

from retina_tpu_torch.log import logger

REFRESH_INTERVAL_S = 30.0


class WatcherManager:
    def __init__(self, watchers: list, interval_s: float = REFRESH_INTERVAL_S):
        self._log = logger("watchermanager")
        self._watchers = watchers
        self._interval = interval_s
        self._thread: threading.Thread | None = None

    def refresh_all(self) -> None:
        for w in self._watchers:
            try:
                w.refresh()
            except Exception:
                self._log.exception(
                    "watcher %s refresh failed", getattr(w, "name", w)
                )

    def start(self, stop: threading.Event) -> None:
        self.refresh_all()  # initial snapshot immediately

        def loop() -> None:
            while not stop.wait(self._interval):
                self.refresh_all()

        self._thread = threading.Thread(
            target=loop, name="watchermanager", daemon=True
        )
        self._thread.start()
