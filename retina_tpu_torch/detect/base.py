"""Detector registry and window-aligned detector bank (port of
retina_tpu/detect/base.py).

A ``Detector`` accumulates host features for the current window
(``add_records``), scores the closed window through its program on the
bank's device, and judges the score two ways: against an absolute floor
(``fire_thresh``), and by an ``AnomalyEWMA`` z-flag past ``z_thresh``,
floored by ``min_score``.

The ``DetectorBank`` closes a window when the epoch rolls over, applies
each detector's cooldown, arbitrates simultaneous firings by priority (the
capture queue is one deep, so one detection a window reaches the sink),
and hands the winner to the sink (``AutoCapture.notify``). It judges the
built-in detectors (``BATCHED``, by exact class) together: their scores
and anomaly EWMA are one ``kops.bank_close`` call a close with one host
wait (one launch for up to eight of them), on a state the bank owns (one
tensor a field; each such detector's ``_ewma`` is a view of its slot).
Every other detector is judged alone. The reference's Prometheus series
are set through ``metrics.get_metrics()`` as the reference sets them, and
kept besides as plain counters on the bank, under the reference's names.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.ops.entropy import AnomalyEWMA

_log = logging.getLogger("retina_tpu_torch.detect")

# Records accumulated per window at most (the record tap's memory bound).
MAX_WINDOW_RECORDS = 1 << 16
# The detector classes the bank judges in one kops.bank_close, by exact
# class (a subclass may override ``score`` and is judged alone): class ->
# the kernel's slot kind. Each has ``bank_input()``: its window's features
# for the kernel, or None where ``score`` would return None.
BATCHED: dict[type, int] = {}
_JUDGE, _FAILED = object(), object()  # a detector to judge alone; one that raised


@dataclasses.dataclass(frozen=True)
class Detection:
    """One accepted firing, in AutoCapture.notify terms."""

    detector: str
    epoch: int
    score: float
    zscore: float
    dims: tuple[str, ...]
    priority: int


class Detector:
    """Base class; subclasses are registered with ``@register``."""

    name = "base"
    priority = 0  # higher wins same-window arbitration
    dims: tuple[str, ...] = ("src_ip",)  # capture-pivot dimensions
    fire_thresh = float("inf")  # absolute firing floor
    min_score = 0.0  # adaptive (z-path) firing floor

    def __init__(self, z_thresh: float = 8.0, min_windows: int = 3, cooldown_s: float = 60.0,
                 device: torch.device | str | None = None) -> None:
        self.z_thresh = float(z_thresh)
        self.min_windows = int(min_windows)
        self.cooldown_s = float(cooldown_s)
        self.device = resolve_device(device)
        self._ewma = AnomalyEWMA.zeros(1, device=self.device)
        self.last_score = 0.0
        self.last_z = 0.0
        self.begin_window()

    # -- per-window feature accumulation (host, record tap) ---------------
    def begin_window(self) -> None:
        raise NotImplementedError

    def add_records(self, rec: np.ndarray, extras: Optional[dict] = None) -> None:
        raise NotImplementedError

    def score(self) -> float | None:
        """Score the accumulated window; None = not enough signal to judge
        (the EWMA baseline does not advance on such windows)."""
        raise NotImplementedError

    # -- judgment ------------------------------------------------------------
    def judge(self, epoch: int) -> Detection | None:
        s = self.score()
        if s is None:
            return None
        new, flags, z = self._ewma.observe(
            torch.tensor([s], dtype=torch.float32, device=self.device),
            z_thresh=self.z_thresh, min_windows=self.min_windows)
        # In place: ``_ewma`` may view the state of a bank.
        for dst, src in ((self._ewma.mean, new.mean), (self._ewma.var, new.var),
                         (self._ewma.n_obs, new.n_obs)):
            dst.copy_(src)
        return self._verdict(epoch, s, float(z[0]), bool(flags[0]))

    def _verdict(self, epoch: int, s: float, z: float, flag: bool) -> Detection | None:
        """Record the judged score and z; the detection if it fires."""
        self.last_score = float(s)
        self.last_z = z
        fired = s >= self.fire_thresh or (flag and s >= self.min_score)
        if not fired:
            return None
        return Detection(detector=self.name, epoch=int(epoch), score=self.last_score,
                         zscore=self.last_z, dims=self.dims, priority=self.priority)


# -- registry ----------------------------------------------------------------

_REGISTRY: dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator: add a Detector subclass to the inventory.
    Re-registering a class is idempotent; two classes claiming one name
    raise."""
    prev = _REGISTRY.get(cls.name)
    if prev is not None and prev is not cls:
        raise ValueError(f"detector {cls.name!r} registered twice: "
                         f"{prev.__qualname__} and {cls.__qualname__}")
    _REGISTRY[cls.name] = cls
    return cls


def registered() -> dict[str, type]:
    """The full inventory (the builtin detectors imported first)."""
    from retina_tpu_torch.detect import detectors  # noqa: F401

    return dict(_REGISTRY)


# -- the bank ------------------------------------------------------------------


class DetectorBank:
    """Window-aligned evaluation of many detectors toward one sink.

    Counters, as the reference's series: ``detector_score`` and
    ``detector_zscore`` (last value per detector), ``detector_fired``
    (per detector), ``detector_suppressed`` (per (detector, reason):
    "disabled", "cooldown", "arbitration") and ``detector_last_epoch``
    (per detector)."""

    def __init__(self, detectors: list[Detector],
                 sink: Optional[Callable[[int, list[str]], Any]] = None,
                 enabled: bool = True) -> None:
        self.detectors = list(detectors)
        self.sink = sink
        self.enabled = enabled
        self._epoch: int | None = None
        self._window_rows = 0
        self._last_fire: dict[str, float] = {}
        self._lock = threading.Lock()
        self.fired: list[Detection] = []  # last accepted firings
        self.detector_score: dict[str, float] = {}
        self.detector_zscore: dict[str, float] = {}
        self.detector_fired: collections.Counter = collections.Counter()
        self.detector_suppressed: collections.Counter = collections.Counter()
        self.detector_last_epoch: dict[str, int] = {}
        # The batched detectors: those of BATCHED on the first one's device.
        batched = [d for d in self.detectors if type(d) in BATCHED]
        self._batched = [d for d in batched if d.device == batched[0].device]
        self._state: tuple[torch.Tensor, ...] = ()
        self._io = None
        if self._batched:
            self._state = tuple(torch.cat([getattr(d._ewma, f) for d in self._batched])
                                for f in ("mean", "var", "n_obs"))
            for i, d in enumerate(self._batched):
                d._ewma = AnomalyEWMA(*(t[i:i + 1] for t in self._state), alpha=d._ewma.alpha)
            if self._state[0].device.type == "cuda":
                self._io = kops.BankCloseIO(self._state[0].device, len(self._batched))

    def observe(self, epoch: int, records: np.ndarray | None, extras: Optional[dict] = None,
                now_s: float | None = None) -> list[Detection]:
        """Feed one record block for window ``epoch``. Rolling to a new
        epoch closes the previous window (score, judge, arbitrate);
        returns the detections accepted for the closed window."""
        with self._lock:
            out: list[Detection] = []
            if self._epoch is not None and epoch != self._epoch:
                out = self._close(self._epoch, now_s)
            if self._epoch != epoch:
                self._epoch = int(epoch)
                self._window_rows = 0
                for d in self.detectors:
                    d.begin_window()
            if records is not None and len(records):
                room = MAX_WINDOW_RECORDS - self._window_rows
                if room > 0:
                    block = records[:room]
                    self._window_rows += len(block)
                    for d in self.detectors:
                        d.add_records(block, extras)
            return out

    def flush(self, now_s: float | None = None) -> list[Detection]:
        """Close the window in progress without starting a new one."""
        with self._lock:
            if self._epoch is None:
                return []
            out = self._close(self._epoch, now_s)
            self._epoch = None
            return out

    def _close(self, epoch: int, now_s: float | None) -> list[Detection]:
        """Judge, cool down, arbitrate and sink one window (under _lock)."""
        now = float(now_s) if now_s is not None else time.time()
        m = get_metrics()
        cands: list[Detection] = []
        judged = self._judge_batched(epoch)
        for d in self.detectors:
            det = judged.get(id(d), _JUDGE)
            if det is _FAILED:
                continue
            if det is _JUDGE:
                try:
                    det = d.judge(epoch)
                except Exception:
                    _log.exception("detector %s failed", d.name)
                    continue
            self.detector_score[d.name] = d.last_score
            self.detector_zscore[d.name] = d.last_z
            m.detector_score.labels(detector=d.name).set(d.last_score)
            m.detector_zscore.labels(detector=d.name).set(d.last_z)
            if det is None:
                continue
            if not self.enabled:
                self._suppress(m, d.name, "disabled")
                continue
            last = self._last_fire.get(d.name)
            if last is not None and (now - last) < d.cooldown_s:
                self._suppress(m, d.name, "cooldown")
                continue
            cands.append(det)
        if not cands:
            return []
        cands.sort(key=lambda c: -c.priority)
        winner = cands[0]
        for c in cands[1:]:
            self._suppress(m, c.detector, "arbitration")
        self._last_fire[winner.detector] = now
        self.detector_fired[winner.detector] += 1
        self.detector_last_epoch[winner.detector] = winner.epoch
        m.detector_fired.labels(detector=winner.detector).inc()
        m.detector_last_epoch.labels(detector=winner.detector).set(winner.epoch)
        self.fired.append(winner)
        del self.fired[:-16]
        if self.sink is not None:
            try:
                self.sink(winner.epoch, list(winner.dims))
            except Exception:
                _log.exception("detector sink failed")
        return [winner]

    def _judge_batched(self, epoch: int) -> dict[int, Any]:
        """Judge the batched detectors in one ``kops.bank_close``: {id(d):
        detection, None, or _FAILED for a detector whose features or the
        call raised (logged)}."""
        out: dict[int, Any] = {}
        if not self._batched:
            return out
        inputs = []
        for d in self._batched:
            try:
                inputs.append(d.bank_input())
            except Exception:
                _log.exception("detector %s failed", d.name)
                inputs.append(None)
                out[id(d)] = _FAILED
        slots = [(BATCHED[type(d)], x, d.z_thresh, d.min_windows, d._ewma.alpha)
                 for d, x in zip(self._batched, inputs)]
        try:
            score, z, flag = kops.bank_close(slots, *self._state, io=self._io)
        except Exception:
            for d in self._batched:
                if id(d) not in out:
                    _log.exception("detector %s failed", d.name)
            return {id(d): _FAILED for d in self._batched}
        for d, x, s, zs, f in zip(self._batched, inputs, score.tolist(), z.tolist(),
                                  flag.tolist()):
            if id(d) not in out:
                out[id(d)] = None if x is None else d._verdict(epoch, s, zs, f)
        return out

    def _suppress(self, m, name: str, reason: str) -> None:
        self.detector_suppressed[(name, reason)] += 1
        m.detector_suppressed.labels(detector=name, reason=reason).inc()


def build_default_bank(cfg=None, sink: Optional[Callable[[int, list[str]], Any]] = None,
                       device: torch.device | str | None = None) -> DetectorBank:
    """Every registered detector at the config's judgment knobs, on
    ``device`` (the card unless the caller names another)."""
    z = float(getattr(cfg, "detector_z_thresh", 8.0))
    mw = int(getattr(cfg, "detector_min_windows", 3))
    cd = float(getattr(cfg, "detector_cooldown_s", 60.0))
    dev = resolve_device(device)
    dets = [cls(z_thresh=z, min_windows=mw, cooldown_s=cd, device=dev)
            for _, cls in sorted(registered().items())]
    return DetectorBank(dets, sink=sink)
