"""The plugin base and the engine's record sink (port of
retina_tpu/plugins/api.py).

``Plugin`` is the lifecycle every plugin implements (generate, compile,
init, a blocking ``start(stop)``, ``stop``) with its sink and external
channel; ``emit`` writes record blocks to the sink and never blocks, and a
block the sink refuses is counted as lost. ``QueueSink`` is a bounded queue
of record blocks, the userspace record channel: a producer that finds it
full drops the block and is told so (``write_records`` returns 0). The
engine's feed loop drains it.
"""

from __future__ import annotations

import abc
import queue as queue_mod
import threading
from typing import Optional, Protocol

import numpy as np

from retina_tpu_torch.config import Config
from retina_tpu_torch.log import logger


class UnsupportedPlatform(RuntimeError):
    """Raised by plugins that cannot run on this host OS."""


class EventSink(Protocol):
    """Where plugins write decoded event records."""

    def write_records(self, records: np.ndarray, plugin: str) -> int:
        """Append (N, NUM_FIELDS) uint32 rows; returns the rows accepted."""
        ...


class NullSink:
    """Discards everything."""

    def write_records(self, records: np.ndarray, plugin: str) -> int:
        return len(records)


class Plugin(abc.ABC):
    """Base plugin (the reference's ``Plugin``)."""

    name: str = ""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.log = logger(f"plugin.{self.name}")
        self.sink: EventSink = NullSink()
        self.external: Optional[queue_mod.Queue] = None
        self._external_lost = 0

    def generate(self) -> None:  # noqa: B027
        """Derive config. Default: nothing."""

    def compile(self) -> None:  # noqa: B027
        """Build what start needs. Default: nothing."""

    def init(self) -> None:  # noqa: B027
        """Allocate runtime resources. Default: nothing."""

    @abc.abstractmethod
    def start(self, stop: threading.Event) -> None:
        """Blocking loop; must return promptly once ``stop`` is set."""

    def stop(self) -> None:  # noqa: B027
        """Idempotent teardown. Default: nothing."""

    def set_sink(self, sink: EventSink) -> None:
        self.sink = sink

    def setup_channel(self, q: queue_mod.Queue) -> None:
        """The external (Hubble-path) queue."""
        self.external = q

    def emit(self, records: np.ndarray) -> int:
        """Write records to the sink and mirror them to the external channel,
        never blocking; losses are counted. Returns the rows the sink took."""
        if len(records) == 0:
            return 0
        accepted = self.sink.write_records(records, self.name)
        if accepted < len(records):
            self.count_lost("buffered", len(records) - accepted)
        if self.external is not None:
            try:
                self.external.put_nowait(records)
            except queue_mod.Full:
                self._external_lost += len(records)
                self.count_lost("external", len(records))
        return accepted

    def count_lost(self, stage: str, n: int) -> None:
        from retina_tpu_torch.metrics import get_metrics

        get_metrics().lost_events.labels(stage=stage, plugin=self.name).inc(n)


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
