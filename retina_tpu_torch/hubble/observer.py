"""Flow observer: bounded flow ring with follow readers (port of
retina_tpu/hubble/observer.py).

Reference analog: the Hubble observer's ring buffer of decoded flows that
``GetFlows`` serves, with follow semantics (new flows stream as they
arrive) — the same structure the enricher uses internally (Cilium
container.Ring, enricher.go:45-52: bounded, overwrite-oldest, per-reader
cursors that observe loss rather than block the writer).
"""

from __future__ import annotations

import threading
from typing import Any, Iterator, Optional

import numpy as np

from retina_tpu_torch.hubble.flow import FlowFilter, record_to_flow
from retina_tpu_torch.log import logger


class FlowObserver:
    def __init__(self, capacity: int = 4096, cache: Any = None,
                 dns_resolver: Any = None):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be a power of two, got {capacity}")
        self._log = logger("observer")
        self._cap = capacity
        self._ring: list[Optional[dict]] = [None] * capacity
        self._seq = 0  # total flows ever written
        self._lock = threading.Condition()
        self.cache = cache
        self.dns_resolver = dns_resolver
        self.flows_seen = 0
        # Ring entries skipped by lagging readers, summed across readers
        # (per-reader loss is ALSO surfaced in-stream as LostEvent
        # markers; this aggregate only feeds the self-metric gauge).
        self.lost_observed = 0

    # -- writer side (monitoragent consumer) ---------------------------
    def consume(self, records: np.ndarray) -> None:
        """Write raw record rows; decode is LAZY (on read).

        The writer sits on the hot mirror path (every flow the engine
        sees), while readers are few and slow (gRPC streams). Eager
        per-record dict decode capped the writer at ~0.15M flows/s;
        storing (block, row) refs moves the ~µs decode to the reader,
        which only ever materializes the ≤capacity flows it serves."""
        with self._lock:
            for i in range(len(records)):
                self._ring[self._seq & (self._cap - 1)] = (records, i)
                self._seq += 1
            self.flows_seen = self._seq
            self._lock.notify_all()

    def consume_flows(self, flows: list[dict]) -> None:
        """Write already-decoded flow dicts (relay peer ingestion)."""
        with self._lock:
            for f in flows:
                self._ring[self._seq & (self._cap - 1)] = f
                self._seq += 1
            self.flows_seen = self._seq
            self._lock.notify_all()

    # -- lazy decode ----------------------------------------------------
    def _materialize(self, entry, seq: Optional[int] = None) -> dict:
        """Decode a raw ring entry to a flow dict, memoizing the result
        back into the ring slot (decode once, however many readers).

        Semantics note: identity/DNS enrichment happens at FIRST READ,
        not at arrival — if a pod IP is recycled while a flow sits
        unread in the ring, the flow gets the current owner's identity.
        The skew window is bounded by ring residency (capacity flows,
        well under a second at production rates); upstream Hubble has
        the same property between its own ring and its ipcache."""
        if isinstance(entry, tuple):  # (records_block, row_index)
            block, i = entry
            f = record_to_flow(block[i], self.cache, self.dns_resolver)
            if seq is not None:
                with self._lock:
                    slot = seq & (self._cap - 1)
                    if self._ring[slot] is entry:
                        self._ring[slot] = f
            return f
        return entry

    # -- reader side ---------------------------------------------------
    def snapshot_flows(self) -> tuple[list[dict], int]:
        """All currently-buffered flows (oldest first) + the sequence
        cursor to continue from with :meth:`follow_from`. Servers filter
        this list THEN apply last-N windowing, matching upstream Hubble's
        'N most recent matching flows' semantics."""
        with self._lock:
            end = self._seq
            window = min(end, self._cap)
            entries = [
                (i, self._ring[i & (self._cap - 1)])
                for i in range(end - window, end)
            ]
        # Materialize OUTSIDE the lock: decode must never stall writers.
        return [self._materialize(e, seq) for seq, e in entries
                if e is not None], end

    def follow_from(
        self,
        cursor: int,
        stop: Optional[threading.Event] = None,
    ) -> Iterator[tuple[str, Any]]:
        """Follow the ring from ``cursor``: yields ("flow", flow) items
        and ("lost", n) markers when this reader fell behind (the
        upstream in-stream LostEvent contract)."""
        while stop is None or not stop.is_set():
            batch: list = []
            lost = 0
            with self._lock:
                floor = self._seq - self._cap
                if cursor < floor:
                    lost = floor - cursor
                    self.lost_observed += lost
                    cursor = floor
                while cursor < self._seq:
                    f = self._ring[cursor & (self._cap - 1)]
                    if f is not None:
                        batch.append((cursor, f))
                    cursor += 1
                if not batch and not lost:
                    self._lock.wait(timeout=0.2)
            if lost:
                yield ("lost", lost)
            for seq, f in batch:
                yield ("flow", self._materialize(f, seq))

    def get_flows(
        self,
        filter: Optional[FlowFilter] = None,
        last: int = 0,
        follow: bool = False,
        stop: Optional[threading.Event] = None,
        timeout_s: float = 30.0,
        lost_markers: bool = False,
    ) -> Iterator[dict[str, Any]]:
        """Yield flows: the most recent ``last`` (0 = all buffered), then
        keep following if requested. A slow reader skips overwritten
        entries (loss over blocking, like every ring in this system);
        with ``lost_markers`` each skip also yields a
        ``{"lost_events": n}`` marker (the msgpack analog of the
        protobuf surface's LostEvent response) that bypasses the filter
        — consumers distinguish markers by that key."""
        with self._lock:
            end0 = self._seq
            window = min(end0, self._cap, last if last else self._cap)
            cursor = end0 - window
        # Initial buffered window: one bounded scan (a lap between the
        # snapshot and this scan surfaces as a marker too).
        skipped = 0
        with self._lock:
            floor = self._seq - self._cap
            if cursor < floor:
                skipped = floor - cursor
                self.lost_observed += skipped
                cursor = floor
            batch = []
            while cursor < end0:
                f = self._ring[cursor & (self._cap - 1)]
                if f is not None:
                    batch.append((cursor, f))
                cursor += 1
        if skipped and lost_markers:
            yield {"lost_events": int(skipped)}
        for seq, f in batch:
            f = self._materialize(f, seq)
            if filter is None or filter.matches(f):
                yield f
        if not follow:
            return
        # Follow phase: ONE implementation of the skip/account/emit
        # contract lives in follow_from (also the protobuf surface's
        # engine); this just maps its items onto the dict stream.
        for kind, payload in self.follow_from(cursor, stop):
            if stop is not None and stop.is_set():
                return
            if kind == "lost":
                if lost_markers:
                    yield {"lost_events": int(payload)}
            elif filter is None or filter.matches(payload):
                yield payload
