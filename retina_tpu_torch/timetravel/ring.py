"""Bounded ring of per-window sketch snapshots (port of
retina_tpu/timetravel/ring.py).

One ring holds the last ``capacity`` windows of sketch state for one
producer: the engine (one slot a window close) or the fleet aggregator
(one slot a merged epoch). Slots are ``(epoch, arrays, window_s, seeds)``
tuples whose arrays follow the fleet array catalog (``fleet/codec.py``) as
host numpy, so a run of slots is a valid ``RangeFold.fold`` operand and a
slot is RFLT-encodable as it is.

``offer`` runs at the window close and never blocks: it enqueues the
export (tensors on the card, copies taken before ``end_window``, or a
``HostCopy`` of them still landing from the card's stream) and returns; a
worker thread copies it to the host (or waits for the copy) and appends
it. A full
queue drops the slot and counts it in ``dropped``. A producer that holds
host arrays appends them with ``append_host``. The oldest slot is evicted
on append once the ring is full.

Counters are attributes (``appended``, ``evicted``, ``dropped``); the
reference's metrics registry, logger and supervisor are not copied.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
import time
import traceback
from typing import Any

import numpy as np

from retina_tpu_torch.u32 import to_numpy
from retina_tpu_torch.utils.device_proxy import HostCopy


class SnapshotRing:
    """Thread-safe bounded window-snapshot history for one producer."""

    def __init__(self, capacity: int, name: str = "engine", queue_size: int = 4) -> None:
        self.name = name
        self.capacity = max(1, int(capacity))
        self._slots: collections.deque = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, int(queue_size)))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.appended = 0
        self.evicted = 0
        self.dropped = 0  # offers dropped: queue full, stopped, or a failed readback
        self.last_error: str | None = None  # traceback of the last failed readback

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=f"tt-ring-{self.name}",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)  # wake the worker
        except queue_mod.Full:
            pass  # the worker sees _stop after its current item
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
        self._thread = None

    # -- the close path (never blocks) ------------------------------------
    def offer(self, epoch: int, arrays: dict[str, Any], window_s: float,
              seeds: dict[str, int]) -> bool:
        """Enqueue one window's export for the worker to copy to the host;
        False when it was dropped (queue full or ring stopped)."""
        if self._stop.is_set():
            self._drop()
            return False
        try:
            self._q.put_nowait((epoch, arrays, window_s, seeds))
            return True
        except queue_mod.Full:
            self._drop()
            return False

    def _drop(self) -> None:
        with self._lock:
            self.dropped += 1

    def append_host(self, epoch: int, arrays: dict[str, np.ndarray], window_s: float,
                    seeds: dict[str, int]) -> None:
        """Append a slot of host arrays at once (the aggregator, tests)."""
        with self._lock:
            if len(self._slots) == self._slots.maxlen:
                self.evicted += 1
            self._slots.append((int(epoch), arrays, float(window_s), dict(seeds)))
            self.appended += 1

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Wait until every offered slot has been appended or dropped;
        False on timeout."""
        end = time.monotonic() + timeout_s
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                left = end - time.monotonic()
                if left <= 0:
                    return False
                self._q.all_tasks_done.wait(left)
        return True

    # -- the worker -------------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None or self._stop.is_set():
                    if item is not None:
                        self._drop()
                    return
                epoch, arrays, window_s, seeds = item
                if isinstance(arrays, HostCopy):
                    arrays = arrays.result()
                host = {k: v if isinstance(v, np.ndarray) else to_numpy(v)
                        for k, v in arrays.items()}
                self.append_host(epoch, host, window_s, seeds)
            except Exception:  # a failed readback drops the slot, counted
                self._drop()
                self.last_error = traceback.format_exc()
            finally:
                self._q.task_done()

    # -- queries ----------------------------------------------------------
    def select(self, e0: int, e1: int,
               ) -> list[tuple[int, dict[str, np.ndarray], float, dict[str, int]]]:
        """Slots with epoch in ``[e0, e1)``, oldest first (the arrays are
        shared, immutable by convention)."""
        with self._lock:
            return [s for s in self._slots if e0 <= s[0] < e1]

    def span(self) -> tuple[int, int]:
        """(oldest_epoch, newest_epoch) retained, or (-1, -1) when empty."""
        with self._lock:
            if not self._slots:
                return (-1, -1)
            return (self._slots[0][0], self._slots[-1][0])

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def stats(self) -> dict:
        with self._lock:
            depth = len(self._slots)
            oldest = self._slots[0][0] if depth else -1
            newest = self._slots[-1][0] if depth else -1
        return {
            "ring": self.name,
            "capacity": self.capacity,
            "depth": depth,
            "oldest_epoch": oldest,
            "newest_epoch": newest,
            "appended": self.appended,
            "evicted": self.evicted,
            "queue_depth": self._q.qsize(),
        }
