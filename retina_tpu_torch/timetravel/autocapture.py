"""Closed loop: detection -> attribution -> evidence (port of
retina_tpu/timetravel/autocapture.py).

A detection at window epoch W (the engine's entropy anomaly flags, or the
detector bank's winner) calls ``notify``, which only enqueues, so the
closing thread never waits. The worker waits for the lookahead windows to
land in the snapshot ring, range-queries ``[W - lookback, W + lookahead +
1)`` (``QueryService.query_range``: the fold, K8 and K9, and the
span-summed invertible decode), and records a targeted capture of only the
attributed sources through the capture subsystem (``CaptureManager`` with a
``ReplayProvider`` and a ``synthesize_filter`` filter).

Trigger storms are damped two ways: a cooldown
(``autocapture_cooldown_s``), and the one-deep trigger queue, which drops
(and counts) a detection that arrives while a capture is in flight.

Counters, as the reference's series: ``autocapture_triggered``,
``autocapture_suppressed`` (per reason: "cooldown", "busy", "no_keys"),
``autocapture_completed``, ``autocapture_failed``, and the last capture's
``autocapture_attributed_keys``, ``autocapture_artifact_bytes`` and
``autocapture_last_epoch``.
"""

from __future__ import annotations

import collections
import logging
import os
import queue as queue_mod
import threading
import time
from typing import Any

import numpy as np

from retina_tpu_torch.capture.manager import CaptureManager
from retina_tpu_torch.capture.translator import CaptureJob, synthesize_filter
from retina_tpu_torch.events.schema import u32_to_ip
from retina_tpu_torch.timetravel.query import QueryService


class AutoCapture:
    """One per node agent: the trigger queue and the capture worker."""

    def __init__(self, cfg, query: QueryService, manager: CaptureManager,
                 ring_name: str = "engine") -> None:
        self.cfg = cfg
        self.log = logging.getLogger("retina_tpu_torch.timetravel.autocapture")
        self._query = query
        self._ring_name = ring_name
        self._manager = manager
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=1)
        self._lock = threading.Lock()
        self._last_trigger = -float("inf")  # monotonic; the cooldown's base
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.captures: list[dict] = []  # the last few completed captures
        self.autocapture_triggered = 0
        self.autocapture_suppressed: collections.Counter = collections.Counter()
        self.autocapture_completed = 0
        self.autocapture_failed = 0
        self.autocapture_attributed_keys = 0
        self.autocapture_artifact_bytes = 0
        self.autocapture_last_epoch = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="autocapture", daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        self._q.put(None)  # wake the worker
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
        self._thread = None

    # -- detector entry (the closing thread; never blocks) ------------------
    def notify(self, epoch: int, dims: list[str]) -> bool:
        """A detection at window ``epoch`` on ``dims``. Returns True when a
        capture was enqueued."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_trigger < float(self.cfg.autocapture_cooldown_s):
                self.autocapture_suppressed["cooldown"] += 1
                return False
            self._last_trigger = now
        try:
            self._q.put_nowait((int(epoch), list(dims)))
        except queue_mod.Full:
            with self._lock:
                self.autocapture_suppressed["busy"] += 1
            return False
        with self._lock:
            self.autocapture_triggered += 1
        self.log.warning("detection on %s at epoch %d: autocapture queued",
                         ",".join(dims), epoch)
        return True

    # -- worker ------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            item = self._q.get()
            if item is None or self._stop.is_set():
                break
            epoch, dims = item
            try:
                self._capture_one(epoch, dims)
            except Exception:
                with self._lock:
                    self.autocapture_failed += 1
                self.log.exception("autocapture for epoch %d failed", epoch)

    def _await_lookahead(self, want_epoch: int) -> None:
        """Wait (bounded) for the lookahead windows to land in the ring, so
        the query covers traffic after the detection too."""
        ring = self._query.rings.get(self._ring_name)
        if ring is None:
            return
        window_s = float(getattr(self.cfg, "window_seconds", 1.0))
        lookahead = int(self.cfg.autocapture_lookahead_windows)
        deadline = time.monotonic() + max(2.0 * (lookahead + 1) * window_s, 1.0)
        while not self._stop.is_set() and time.monotonic() < deadline:
            if ring.span()[1] >= want_epoch:
                return
            self._stop.wait(0.05)

    def _capture_one(self, epoch: int, dims: list[str]) -> None:
        cfg = self.cfg
        e0 = epoch - int(cfg.autocapture_lookback_windows)
        e1 = epoch + int(cfg.autocapture_lookahead_windows) + 1
        self._await_lookahead(e1 - 1)
        t0 = time.monotonic()
        res = self._query.query_range(self._ring_name, e0, e1)
        query_s = time.monotonic() - t0
        dec = (res or {}).get("decode")
        if dec is None or not len(dec["keys"]):
            with self._lock:
                self.autocapture_suppressed["no_keys"] += 1
            self.log.warning("detection at epoch %d: nothing attributable in [%d, %d)",
                             epoch, e0, e1)
            return
        srcs, pkts = dec["sources"]
        n_src = int(cfg.autocapture_max_sources)
        ips = [u32_to_ip(int(s)) for s in srcs[:n_src]]
        filt = synthesize_filter(ips)
        out_dir = cfg.autocapture_output_dir
        os.makedirs(out_dir, exist_ok=True)
        job = CaptureJob(
            capture_name=f"auto-{epoch}",
            namespace="retina",
            node_name=cfg.node_name or "local",
            filter_expr=filt,
            duration_s=int(cfg.autocapture_duration_s),
            max_size_mb=int(cfg.autocapture_max_size_mb),
            packet_size_bytes=0,
            output={"host_path": out_dir},
            include_metadata=False,
        )
        t1 = time.monotonic()
        artifacts = self._manager.run_job(job)
        size = sum(os.path.getsize(a) for a in artifacts if os.path.isfile(a))
        record: dict[str, Any] = {
            "epoch": epoch,
            "dims": dims,
            "range": (e0, e1),
            "windows": int((res or {}).get("windows", 0)),
            "attributed_keys": int(len(dec["keys"])),
            "sources": [(u32_to_ip(int(s)), int(p))
                        for s, p in zip(srcs[:n_src], np.asarray(pkts)[:n_src])],
            "filter": filt,
            "artifacts": artifacts,
            "artifact_bytes": int(size),
            "query_seconds": query_s,
            "capture_seconds": time.monotonic() - t1,
        }
        with self._lock:
            self.captures.append(record)
            del self.captures[:-8]
            self.autocapture_completed += 1
            self.autocapture_attributed_keys = len(dec["keys"])
            self.autocapture_artifact_bytes = size
            self.autocapture_last_epoch = epoch
        self.log.warning("autocapture complete: epoch %d, %d keys, %d sources, %d bytes -> %s",
                         epoch, len(dec["keys"]), len(ips), size, artifacts)
