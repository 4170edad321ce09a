"""Always-on pipeline flight recorder (a copy of retina_tpu/obs/recorder.py).

Every pipeline stage (the fixed registry `utils/metric_names.STAGES`)
reports begin/end spans here, keyed by **window epoch as the trace
ID**, so one window's wall-clock lineage is followable across the feed
workers, the dispatch thread, the device proxy and the harvest thread.
The clock is the host's (``time.perf_counter``): a span on the device
proxy covers the host time of issuing the card work, not the card's time
(the engine's ``FeedStages`` reads that by CUDA events).

Overhead contract: the hot path takes **no locks and allocates
nothing** — each thread owns a preallocated ring of mutable span slots
(created once, registered under a creation-time-only lock) and a
sampling counter (`cfg.trace_sample_every`); a skipped span costs one
increment and one modulo. Ring readers (``spans``, ``chrome_trace``,
``stage_report``) tolerate torn slots by construction: a slot is a
[stage, t0, t1, trace_id] list overwritten in place, and a half-written
slot merely yields one bogus span in a diagnostic dump — never an
exception on the writer.

Sampled spans additionally observe the `tpu_stage_seconds{stage}`
histogram (cached child per stage), which is what the per-stage
p50/p99 exposition reads.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from retina_tpu_torch.utils import metric_names as mn

# Spans retained per thread ring by default (each slot is 4 python
# refs; 4096 spans x ~10 threads is well under a MB).
DEFAULT_CAPACITY = 4096


class _ThreadRing:
    """One thread's preallocated span ring. Single-writer by
    construction (thread-local); read racily by dump/report paths."""

    __slots__ = ("name", "slots", "pos", "count", "tick")

    def __init__(self, name: str, capacity: int) -> None:
        self.name = name
        # slot = [stage, t0, t1, trace_id]; stage None = never written.
        self.slots: list[list[Any]] = [
            [None, 0.0, 0.0, -1] for _ in range(capacity)
        ]
        self.pos = 0
        self.count = 0  # total spans recorded (wrap diagnostic)
        self.tick = 0  # sampling counter (begin() gate)


class FlightRecorder:
    """Per-thread span rings + the drain/report API over them."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        sample_every: int = 1,
        enabled: bool = True,
    ) -> None:
        self.capacity = max(16, int(capacity))
        self.sample_every = max(1, int(sample_every))
        self.enabled = bool(enabled)
        self._local = threading.local()
        self._rings: list[_ThreadRing] = []
        self._rings_lock = threading.Lock()  # ring creation only
        self._hist: dict[str, Any] = {}  # stage -> histogram child
        self._hist_lock = threading.Lock()
        self._metrics_broken = False

    # -- hot path ------------------------------------------------------
    def _ring(self) -> _ThreadRing:
        r = getattr(self._local, "ring", None)
        if r is None:
            r = _ThreadRing(
                threading.current_thread().name, self.capacity
            )
            self._local.ring = r
            with self._rings_lock:
                self._rings.append(r)  # one ring a producer thread, at its first span
        return r

    def begin(self) -> float:  # hot-path: event
        """Sampling gate + span start timestamp.

        Returns 0.0 when this span is sampled out (or the recorder is
        off) — pass the value straight to :meth:`record`, which treats
        0.0 as "skip". One counter increment per call; no locks."""
        if not self.enabled:
            return 0.0
        r = self._ring()
        r.tick += 1
        if r.tick % self.sample_every:
            return 0.0
        return time.perf_counter()

    def record(  # hot-path: event
        self,
        stage: str,
        t0: float,
        trace_id: int = -1,
        t1: float | None = None,
    ) -> None:
        """Complete a span started by :meth:`begin` (t0 == 0.0 is a
        sampled-out span: returns immediately). Call sites that already
        hold both timestamps (the engine's existing transfer/step
        timing) pass ``t1`` explicitly and skip the begin() gate."""
        if not t0 or not self.enabled:
            return
        if t1 is None:
            t1 = time.perf_counter()
        r = self._ring()
        slot = r.slots[r.pos]
        slot[0] = stage
        slot[1] = t0
        slot[2] = t1
        slot[3] = trace_id
        r.pos = (r.pos + 1) % len(r.slots)
        r.count += 1
        self._observe(stage, t1 - t0)

    def _observe(self, stage: str, dt: float) -> None:
        child = self._hist.get(stage)
        if child is None:
            if self._metrics_broken:
                return
            try:
                from retina_tpu_torch.metrics import get_metrics

                with self._hist_lock:
                    child = self._hist.get(stage)
                    if child is None:
                        child = get_metrics().stage_seconds.labels(
                            stage=stage
                        )
                        self._hist[stage] = child
            except Exception:  # never take a stage down: drop the exposition, keep spans
                self._metrics_broken = True
                return
        child.observe(dt)

    # -- drain / report (diagnostic paths; racy-read tolerant) ---------
    def spans(self, last: int | None = None) -> list[dict[str, Any]]:
        """All retained spans, oldest first. ``last`` keeps only the N
        newest (by end timestamp)."""
        out: list[dict[str, Any]] = []
        with self._rings_lock:
            rings = list(self._rings)
        for r in rings:
            for slot in r.slots:
                stage, t0, t1, tid = slot
                if stage is None or t1 < t0:
                    continue  # unwritten or torn slot
                out.append({
                    "stage": stage, "t0": t0, "t1": t1,
                    "trace_id": tid, "thread": r.name,
                })
        out.sort(key=lambda s: s["t1"])
        if last is not None and last >= 0:
            out = out[-last:]
        return out

    def chrome_trace(self, last: int | None = None) -> dict[str, Any]:
        """Chrome trace-event JSON (load in Perfetto / chrome://tracing):
        one complete ("ph": "X") event per span, tid = recording thread,
        trace id in args."""
        spans = self.spans(last)
        base = spans[0]["t0"] if spans else 0.0
        tids: dict[str, int] = {}
        events = []
        for s in spans:
            tid = tids.setdefault(s["thread"], len(tids) + 1)
            events.append({
                "name": s["stage"],
                "cat": "retina",
                "ph": "X",
                "ts": (s["t0"] - base) * 1e6,
                "dur": (s["t1"] - s["t0"]) * 1e6,
                "pid": 1,
                "tid": tid,
                "args": {"trace_id": s["trace_id"]},
            })
        meta = [
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
             "args": {"name": name}}
            for name, tid in tids.items()
        ]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms"}

    def stage_report(
        self, last: int | None = None
    ) -> dict[str, dict[str, float]]:
        """Critical-path report: per-stage count/total/p50/p99 seconds
        over the retained spans, in pipeline (registry) order."""
        by_stage: dict[str, list[float]] = {}
        for s in self.spans(last):
            by_stage.setdefault(s["stage"], []).append(s["t1"] - s["t0"])
        out: dict[str, dict[str, float]] = {}
        order = {name: i for i, name in enumerate(mn.STAGES)}
        for stage in sorted(by_stage, key=lambda n: order.get(n, 99)):
            durs = sorted(by_stage[stage])
            n = len(durs)
            out[stage] = {
                "count": n,
                "total_s": sum(durs),
                "p50_s": durs[n // 2],
                "p99_s": durs[min(n - 1, (n * 99) // 100)],
            }
        return out

    def stats(self) -> dict[str, Any]:
        with self._rings_lock:
            rings = list(self._rings)
        return {
            "enabled": self.enabled,
            "sample_every": self.sample_every,
            "capacity": self.capacity,
            "threads": {r.name: r.count for r in rings},
        }


# -- process singleton -------------------------------------------------
# Always-on by default: a recorder at sample_every=1 costs two
# perf_counter calls and four list writes per span, and spans are
# per-flush/per-window cadence, not per-event.
_singleton = FlightRecorder()
_singleton_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    return _singleton


def initialize_recorder(
    capacity: int = DEFAULT_CAPACITY,
    sample_every: int = 1,
    enabled: bool = True,
) -> FlightRecorder:
    """Replace the process recorder with one built from config (engine
    boot). Threads re-acquire their rings lazily on the next span."""
    global _singleton
    with _singleton_lock:
        _singleton = FlightRecorder(
            capacity=capacity, sample_every=sample_every, enabled=enabled
        )
        return _singleton
