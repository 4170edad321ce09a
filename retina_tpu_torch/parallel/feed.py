"""Sharded multi-worker host feed (port of retina_tpu/parallel/feed.py):
staging, combine/partition workers, and the double-buffered handoff to the
dispatch thread.

The engine's feed loop (the *distributor*) drains the sink and deals raw
record blocks round-robin across N :class:`FeedWorker` threads. Each worker
owns a staging deque, accumulates a flush quantum and runs the CPU-heavy
half of a flush, combine and partition (``SketchEngine._build_quantum``),
off the distributor (the native combiner releases the GIL, so workers
overlap on real cores). Finished items hand off to the one dispatch thread
through a :class:`TransferQueue`: a depth-2 SPSC deque with no lock on the
hot path (deque append and popleft are atomic; events only park a side
that has nothing to do).

The flow dictionary, the wire build and the submission to the card stay on
the dispatch thread: a new descriptor must reach the card's table before
any known row names its slot, so there is one serialization point.

Backpressure never blocks a producer: a block that finds every worker's
staging full is dropped and counted; a worker whose handoff stays full
because the dispatch thread died drops the item through the pool's
``drop`` callback. The reference's Prometheus series (``engine_errors``
for a crash, ``thread_restarts`` for a restart, ``feed_worker_fill``,
``feed_handoff_wait``, ``feed_blocks_dropped``) are set through
``metrics.get_metrics()`` and kept besides as plain counters in ``stats()``.

Supervision, as the reference's: the pool takes the engine's heartbeat
registrar and restart-policy factory (``register_hb``, ``deregister_hb``,
``restart_policy``). Each worker beats while it has staged work, parks
around its idle waits, and restarts its loop under the policy when it
crashes (its staging survives: it lives on the worker object); a crash
loop opens the circuit and the worker stops, and its blocks go to the
other shards. A bare pool runs unsupervised.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.obs.recorder import get_recorder
from retina_tpu_torch.utils import metric_names as mn

_log = logging.getLogger("retina_tpu_torch.feed")

# Handoff depth: one batch being consumed, one built and waiting.
TRANSFER_DEPTH = 2


class TransferQueue:
    """Bounded SPSC handoff (producer: one feed worker or the inline feed;
    consumer: the dispatch thread through :class:`TransferMux`)."""

    __slots__ = ("q", "depth", "space", "data", "wait_s")

    def __init__(self, depth: int, data: threading.Event):
        self.q: deque = deque()
        self.depth = depth
        self.space = threading.Event()
        self.data = data  # shared with the mux: any producer wakes it
        self.wait_s = 0.0  # producer seconds spent waiting for space

    def put(self, item: Any, alive: Optional[Callable[[], bool]] = None) -> bool:
        """Enqueue, waiting for a free slot. False (item not enqueued) once
        ``alive`` goes falsy: the consumer died, the caller drops and
        counts."""
        t0 = None
        while len(self.q) >= self.depth:
            if alive is not None and not alive():
                if t0 is not None:
                    self.wait_s += time.monotonic() - t0
                return False
            if t0 is None:
                t0 = time.monotonic()
            # The timeout bounds the one benign race (space set between the
            # length check and the wait).
            self.space.wait(0.02)
            self.space.clear()
        if t0 is not None:
            self.wait_s += time.monotonic() - t0
        self.q.append(item)
        self.data.set()
        return True


class TransferMux:
    """Single-consumer fan-in over the workers' TransferQueues plus a
    control lane (window ticks, the shutdown sentinel). ``get()`` blocks
    and returns items; ``None`` means shut down.

    The control lane has priority, so window closes stay on cadence under a
    step backlog (a close that overtakes staged batches shifts their events
    into the next window). The sentinel is the exception: it is delivered
    only after every worker queue has drained."""

    def __init__(self, queues: list[TransferQueue], data: threading.Event):
        self._qs = queues
        self._ctl: deque = deque()
        self._data = data
        self._rr = 0

    def put_ctl(self, item: Any) -> None:
        self._ctl.append(item)
        self._data.set()

    def get(self, timeout: float | None = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._ctl and self._ctl[0] is not None:
                return self._ctl.popleft()
            draining = bool(self._ctl)  # the head is the None sentinel
            n = len(self._qs)
            for k in range(n):
                tq = self._qs[(self._rr + k) % n]
                try:
                    item = tq.q.popleft()
                except IndexError:
                    continue
                tq.space.set()
                self._rr = (self._rr + k + 1) % n
                return item
            if draining:
                return self._ctl.popleft()
            if deadline is not None and time.monotonic() >= deadline:
                raise queue_mod.Empty
            self._data.wait(0.002)
            self._data.clear()


class FeedWorker(threading.Thread):
    """One ingest shard: staging deque -> quantum flush -> handoff.

    ``*_in`` counters are written only by the distributor, ``*_out`` only by
    this worker; both are monotonic, so ``pending = in - out`` needs no
    lock (a torn read is only momentarily stale)."""

    def __init__(self, idx: int, pool: "FeedWorkerPool", data: threading.Event):
        super().__init__(name=f"feed-worker-{idx}", daemon=True)
        self.idx = idx
        self.pool = pool
        self.staging: deque = deque()
        self.outq = TransferQueue(pool.depth, data)
        self.wake = threading.Event()
        self.events_in = 0  # distributor-only
        self.blocks_in = 0  # distributor-only
        self.events_out = 0  # worker-only
        self.blocks_out = 0  # worker-only
        # Stamp of the oldest staged block, written by both sides without a
        # lock: a lost store skews one flush-age decision by one block.
        self.first_t = 0.0
        self.fill = 0.0  # the last flush's quantum fill
        self.batches = 0
        self.handoff_dropped = 0  # worker-only: items the consumer lost
        self._wait_pub = 0.0  # handoff wait already published
        self.busy_s = 0.0  # worker-only: seconds in build_steps
        self.restarts = 0  # worker-only: crashes restarted under the policy
        self.crashed = False  # the policy gave up

    # -- distributor side ----------------------------------------------
    def pending_blocks(self) -> int:
        return self.blocks_in - self.blocks_out

    def pending_events(self) -> int:
        return self.events_in - self.events_out

    def push(self, block) -> None:
        if self.pending_events() == 0:
            self.first_t = time.monotonic()
        self.staging.append(block)
        self.blocks_in += 1
        self.events_in += len(block)
        self.wake.set()

    # -- worker side -----------------------------------------------------
    def run(self) -> None:
        """Supervised run: the ingest loop restarts under the pool's
        restart policy when it crashes; a crash loop gives up and lets the
        distributor's liveness check route blocks to the other shards."""
        pool = self.pool
        hb = pool.register_hb(self.name) if pool.register_hb is not None else None
        policy = pool.restart_policy(self.name) if pool.restart_policy is not None else None
        try:
            while True:
                try:
                    self._loop(hb)
                    return
                except Exception:
                    get_metrics().engine_errors.labels(site="feed_worker").inc()
                    delay = policy.record_failure() if policy is not None else None
                    if delay is None:
                        self.crashed = True
                        _log.exception("feed worker %d crash-looping; giving up "
                                       "(blocks route to the other shards)", self.idx)
                        return
                    _log.exception("feed worker %d crashed; restart in %.2fs", self.idx, delay)
                    self.restarts += 1
                    get_metrics().thread_restarts.labels(thread=self.name).inc()
                    if pool.stop_evt.wait(delay):
                        return
        finally:
            if pool.deregister_hb is not None:
                pool.deregister_hb(self.name)

    def _loop(self, hb) -> None:
        while True:
            stopping = self.pool.stop_evt.is_set()
            pend = self.pending_events()
            if pend == 0:
                if stopping:
                    return
                if hb is not None:
                    hb.park()
                self.wake.wait(0.002)
                self.wake.clear()
                continue
            if hb is not None:
                hb.beat()
            age = time.monotonic() - self.first_t
            # The inline feed's flush policy: a full quantum, the hard age
            # bound, or the interval when nothing is in flight.
            if not (pend >= self.pool.quantum or stopping
                    or age >= self.pool.flush_max_age_s
                    or (age >= self.pool.flush_interval_s and self.pool.busy() == 0)):
                self.wake.wait(0.002)
                self.wake.clear()
                continue
            self._flush()

    def _flush(self) -> None:
        blocks = []
        n_raw = 0
        while n_raw < self.pool.quantum:
            try:
                b = self.staging.popleft()
            except IndexError:
                break
            blocks.append(b)
            n_raw += len(b)
        if not blocks:
            return
        # Release staging capacity before the long combine: backpressure
        # tracks what is staged, not what is being crunched.
        self.blocks_out += len(blocks)
        self.events_out += n_raw
        self.first_t = time.monotonic()
        self.fill = n_raw / max(self.pool.quantum, 1)
        rec = get_recorder()
        t0 = time.perf_counter()
        items = self.pool.build_steps(blocks, n_raw, int(time.time()))
        t1 = time.perf_counter()
        self.busy_s += t1 - t0
        rec.record(mn.STAGE_FEED_FILL, t0, t1=t1)
        t0 = rec.begin()
        for it in items:
            if not self.outq.put(it, alive=self.pool.alive):
                self.handoff_dropped += 1
                self.pool.drop(it)
        rec.record(mn.STAGE_STAGING_HANDOFF, t0)
        self.batches += 1
        self._publish_metrics()

    def _publish_metrics(self) -> None:
        m = get_metrics()
        w = str(self.idx)
        m.feed_worker_fill.labels(worker=w).set(self.fill)
        # The counter takes the wait since the last publication.
        wait = self.outq.wait_s
        m.feed_handoff_wait.labels(worker=w).inc(max(0.0, wait - self._wait_pub))
        self._wait_pub = wait

    def stat(self) -> dict[str, Any]:
        return {
            "worker": self.idx,
            "fill": round(self.fill, 3),
            "staged_blocks": self.pending_blocks(),
            "staged_events": self.pending_events(),
            "handoff_wait_s": round(self.outq.wait_s, 3),
            "batches": self.batches,
            "events": self.events_out,
            "handoff_dropped": self.handoff_dropped,
            "busy_s": self.busy_s,
            "restarts": self.restarts,
            "crashed": self.crashed,
        }


class FeedWorkerPool:
    """N feed workers and the mux the dispatch thread consumes.

    ``build_steps(blocks, n_raw, now_s) -> list[item]`` is the engine's
    combine and partition (pure host work, safe concurrently); ``drop(item)``
    takes any finished item the dispatch side will never consume, so the
    loss is counted; ``busy()`` is the in-flight dispatch count (interval
    flush gating); ``alive()`` the dispatch thread's liveness."""

    def __init__(
        self,
        n_workers: int,
        quantum: int,
        staging_blocks: int,
        flush_interval_s: float,
        flush_max_age_s: float,
        build_steps: Callable[[list, int, int], list],
        drop: Callable[[Any], None],
        busy: Callable[[], int] = lambda: 0,
        alive: Callable[[], bool] = lambda: True,
        depth: int = TRANSFER_DEPTH,
        register_hb: Optional[Callable[[str], Any]] = None,
        deregister_hb: Optional[Callable[[str], None]] = None,
        restart_policy: Optional[Callable[[str], Any]] = None,
    ):
        self.quantum = max(1, int(quantum))
        self.staging_blocks = max(1, int(staging_blocks))
        self.flush_interval_s = flush_interval_s
        self.flush_max_age_s = flush_max_age_s
        self.build_steps = build_steps
        self.drop = drop
        self.busy = busy
        self.alive = alive
        self.depth = max(1, int(depth))
        # The supervision seams (the engine's heartbeat registrar and its
        # restart-policy factory); a bare pool runs unsupervised.
        self.register_hb = register_hb
        self.deregister_hb = deregister_hb
        self.restart_policy = restart_policy
        self.stop_evt = threading.Event()
        data = threading.Event()
        self.workers = [FeedWorker(i, self, data) for i in range(max(1, n_workers))]
        self.mux = TransferMux([w.outq for w in self.workers], data)
        self._rr = 0
        # Distributor-only: blocks no worker could take.
        self.staging_dropped_blocks = 0
        self.staging_dropped_events = 0

    def start(self) -> None:
        for w in self.workers:
            w.start()

    def stage(self, block) -> bool:
        """Deal one raw block to a worker (round-robin, skipping full or dead
        shards). False (the caller drops and counts) only when every worker
        is saturated or gone."""
        n = len(self.workers)
        for k in range(n):
            w = self.workers[(self._rr + k) % n]
            if w.is_alive() and w.pending_blocks() < self.staging_blocks:
                self._rr = (self._rr + k + 1) % n
                w.push(block)
                return True
        return False

    def count_drop(self, n_events: int) -> None:
        """Account a block no worker could take."""
        self.staging_dropped_blocks += 1
        self.staging_dropped_events += n_events
        get_metrics().feed_blocks_dropped.labels(worker=str(self._rr % len(self.workers))).inc()

    def stop(self, timeout: float = 30.0) -> None:
        """Signal stop and join the workers; each flushes its staged quantum
        first (the dispatch thread keeps consuming until the sentinel,
        which the engine sends after this returns)."""
        self.stop_evt.set()
        deadline = time.monotonic() + timeout
        for w in self.workers:
            w.wake.set()
        for w in self.workers:
            w.join(max(0.0, deadline - time.monotonic()))
            if w.is_alive():
                _log.error("feed worker %d did not stop in time", w.idx)

    # -- pressure signals (runtime/overload.py) ---------------------------
    def max_staging_fill(self) -> float:
        """Worst per-worker staging occupancy in [0, 1]."""
        if not self.workers:
            return 0.0
        return max(w.pending_blocks() / self.staging_blocks for w in self.workers)

    def handoff_wait_total(self) -> float:
        """Producer seconds spent waiting on a full handoff, summed."""
        return sum(w.outq.wait_s for w in self.workers)

    def stats(self) -> dict[str, Any]:
        return {
            "workers": len(self.workers),
            "mode": "sharded",
            "quantum": self.quantum,
            "dropped_blocks": self.staging_dropped_blocks,
            "dropped_events": self.staging_dropped_events,
            "per_worker": [w.stat() for w in self.workers],
        }
