"""The engine's record sink (port of ``QueueSink`` of
retina_tpu/plugins/api.py).

A bounded queue of record blocks, the userspace record channel: a producer
that finds it full drops the block and is told so (``write_records``
returns 0); it never blocks. The engine's feed loop drains it.
"""

from __future__ import annotations

import queue as queue_mod

import numpy as np


class QueueSink:
    """Bounded, drop-on-full sink of (records, plugin) blocks."""

    def __init__(self, max_blocks: int = 1024):
        self.q: queue_mod.Queue[tuple[np.ndarray, str]] = queue_mod.Queue(maxsize=max_blocks)

    def write_records(self, records: np.ndarray, plugin: str) -> int:
        """Rows accepted: all of them, or 0 when the sink is full."""
        try:
            self.q.put_nowait((records, plugin))
            return len(records)
        except queue_mod.Full:
            return 0

    def drain(self, max_blocks: int = 64) -> list[tuple[np.ndarray, str]]:
        out = []
        for _ in range(max_blocks):
            try:
                out.append(self.q.get_nowait())
            except queue_mod.Empty:
                break
        return out
