"""Closed-loop overload controller (port of retina_tpu/runtime/overload.py).

The controller watches normalized pressure signals the engine feeds it
(per-worker staging fill, the share of time dispatches wait on a full
pipeline, handoff wait rate, harvest lag, dispatch latency) and moves the
pipeline through explicit states with hysteresis::

    NOMINAL --p>=enter--> SAMPLING --p>=shed--> SHEDDING --p>=degrade--> DEGRADED
       <--p<=exit for dwell_s-- (one level per dwell period)

* ``SAMPLING``: the feed keeps 1-in-k of the combined rows. Rows above
  ``TIER_BACKGROUND`` (heavy-hitter candidates of at least
  ``overload_exempt_packets`` packets, apiserver latency probes, the
  priority IP class) are exempt; the step rescales the surviving non-exempt
  rows by k (``models/pipeline.py`` ``sample_exempt``), so every
  packet-weighted estimate stays unbiased (Horvitz-Thompson): exempt rows
  are kept whole, and of the non-exempt rows, taken in offer order across
  calls, exactly one in every k is kept (a rotating phase), so the
  estimate E = (exempt weight) + k x (kept non-exempt weight) has the
  offered weight as its mean. Its variance is at most
  (k - 1) x (sum of the squared non-exempt row weights offered), which
  k x (the same sum over the kept rows) estimates; a check holds
  |E - offered| within 4 standard deviations of that.
* ``SHEDDING``: enrichment stages are dropped in ``overload_shed_order``
  (dns, conntrack, labels), one more per ``overload_shed_escalate_s``.
* ``DEGRADED``: every stage shed and sampling on.

The reference's series (``overload_state``, ``events_sampled``,
``accuracy_debt``, ``events_shed``) are set through ``metrics.get_metrics()``
as the reference sets them, and kept besides as plain counters
(``counters``) read through ``stats()``. Pure host numpy; the engine calls ``tick``
from its feed loop and ``sample_rows`` from the feed workers.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Iterable

import numpy as np

from retina_tpu_torch.events.schema import F
from retina_tpu_torch.metrics import get_metrics

_log = logging.getLogger("retina_tpu_torch.overload")

NOMINAL, SAMPLING, SHEDDING, DEGRADED = 0, 1, 2, 3
STATE_NAMES = ("NOMINAL", "SAMPLING", "SHEDDING", "DEGRADED")

# Enrichment stages sheddable in SHEDDING, cheapest to lose first.
SHED_STAGES = ("dns", "conntrack", "labels")

# The priority-tier lattice: higher tiers are exempt from sampling.
TIER_BACKGROUND = 0  # sampled 1-in-k under SAMPLING and above
TIER_PRIORITY = 1  # the priority IP class (mask match)
TIER_HEAVY = 2  # heavy-hitter candidates (packet weight)
TIER_CONTROL = 3  # apiserver latency probes


def priority_class_np(src_ip: np.ndarray, dst_ip: np.ndarray, mask: int,
                      match: int) -> np.ndarray:
    """Host mirror of ``models.pipeline.priority_class``: the sampler drops
    rows with this predicate and the step rescales with its twin, so the
    two must agree. mask 0 disables the class."""
    if mask == 0:
        return np.zeros(src_ip.shape, bool)
    m, v = np.uint32(mask), np.uint32(match)
    return ((src_ip & m) == v) | ((dst_ip & m) == v)


def row_tiers(rec: np.ndarray, cfg) -> np.ndarray:
    """(N,) uint8 TIER_* of combined rows, the highest each qualifies for;
    exempt from sampling is ``tier > TIER_BACKGROUND``."""
    tiers = np.zeros(rec.shape[0], np.uint8)
    tiers[
        priority_class_np(
            rec[:, F.SRC_IP], rec[:, F.DST_IP],
            int(getattr(cfg, "overload_priority_ip_mask", 0)),
            int(getattr(cfg, "overload_priority_ip_match", 0)),
        )
    ] = TIER_PRIORITY
    tiers[rec[:, F.PACKETS] >= np.uint32(cfg.overload_exempt_packets)] = TIER_HEAVY
    tiers[(rec[:, F.TSVAL] | rec[:, F.TSECR]) != 0] = TIER_CONTROL
    return tiers


class OverloadController:
    """State machine and host-side sampler. Thread-safe: ``tick`` runs on
    the feed loop, ``sample_rows`` and ``shed_active`` on the feed workers
    and plugin threads."""

    def __init__(self, cfg, signals: Callable[[], dict[str, float]] | None = None) -> None:
        self.cfg = cfg
        self._signals = signals or (lambda: {})
        self._lock = threading.Lock()
        self._state = NOMINAL
        self._shed_level = 0
        self._pressure = 0.0
        self._sigvals: dict[str, float] = {}
        self._last_tick = 0.0
        self._below_since: float | None = None
        self._shed_above_since: float | None = None
        self._transitions = 0
        self._last_change = time.monotonic()
        self._phase = 0  # rotating 1-in-k phase; guarded by _lock
        # Window-scoped accounting, snapshot and reset at each close.
        self._win_sampled = 0  # events dropped
        self._win_kept = 0  # events admitted
        self._win_priority = 0  # priority-tier events
        # The reference's metrics: events_sampled, accuracy_debt,
        # events_shed:<stage>, signal_errors.
        self.counters: collections.Counter = collections.Counter()

    # -- state machine -------------------------------------------------
    def tick(self, now: float | None = None) -> int:
        """Advance the state machine from the current pressure signals; a
        no-op when called faster than ``overload_tick_s``."""
        cfg = self.cfg
        if not getattr(cfg, "overload_enabled", True):
            return self._state
        now = time.monotonic() if now is None else now
        if now - self._last_tick < cfg.overload_tick_s:
            return self._state
        self._last_tick = now
        try:
            sig = self._signals() or {}
        except Exception:
            _log.exception("overload signal read failed")
            with self._lock:
                self.counters["signal_errors"] += 1
            sig = {}
        p = max(sig.values(), default=0.0)
        with self._lock:
            self._pressure = p
            self._sigvals = dict(sig)
            self._advance(p, now)
            return self._state

    def _advance(self, p: float, now: float) -> None:
        cfg = self.cfg
        # Escalation is immediate.
        target = NOMINAL
        if p >= cfg.overload_enter_pressure:
            target = SAMPLING
        if p >= cfg.overload_shed_pressure:
            target = SHEDDING
        if p >= cfg.overload_degrade_pressure:
            target = DEGRADED
        if target > self._state:
            self._set_state(target, p, now)
            self._below_since = None
            self._shed_above_since = now
            return
        # De-escalation: one level per dwell period at or below exit.
        if self._state > NOMINAL and p <= cfg.overload_exit_pressure:
            if self._below_since is None:
                self._below_since = now
            elif now - self._below_since >= cfg.overload_dwell_s:
                self._set_state(self._state - 1, p, now)
                self._below_since = now
        else:
            self._below_since = None
        # Within SHEDDING, widen the shed set one stage per escalate period.
        if self._state == SHEDDING and p >= cfg.overload_shed_pressure:
            if self._shed_above_since is None:
                self._shed_above_since = now
            elif (now - self._shed_above_since >= cfg.overload_shed_escalate_s
                  and self._shed_level < len(self._shed_order())):
                self._shed_level += 1
                self._shed_above_since = now
                _log.warning("overload: shedding widened to %s (pressure %.2f)",
                             list(self._shed_order()[: self._shed_level]), p)
        elif self._state != SHEDDING:
            self._shed_above_since = None

    def _set_state(self, state: int, p: float, now: float) -> None:
        old = self._state
        self._state = state
        self._transitions += 1
        self._last_change = now
        if state >= SHEDDING:
            self._shed_level = max(1, self._shed_level)
        if state == DEGRADED:
            self._shed_level = len(self._shed_order())
        if state < SHEDDING:
            self._shed_level = 0
        get_metrics().overload_state.set(state)
        log = _log.warning if state > old else _log.info
        log("overload: %s -> %s (pressure %.2f, signals %s)", STATE_NAMES[old],
            STATE_NAMES[state], p, {k: round(v, 3) for k, v in self._sigvals.items()})

    def _shed_order(self) -> tuple[str, ...]:
        return tuple(getattr(self.cfg, "overload_shed_order", SHED_STAGES))

    # -- read side -------------------------------------------------------
    @property
    def state(self) -> int:
        return self._state

    @property
    def state_name(self) -> str:
        return STATE_NAMES[self._state]

    @property
    def sample_k(self) -> int:
        if self._state >= SAMPLING:
            return max(1, int(self.cfg.overload_sample_k))
        return 1

    def shed_stages(self) -> tuple[str, ...]:
        return self._shed_order()[: self._shed_level]

    def shed_active(self, stage: str) -> bool:
        return stage in self._shed_order()[: self._shed_level]

    # -- the sampler (feed-worker side) ------------------------------------
    def sample_rows(self, rec: np.ndarray) -> tuple[np.ndarray, int]:
        """Priority-aware 1-in-k sampling of combined rows, after the
        combine (a row's packet weight is final) and before partitioning.
        Returns ``(kept_rows, k)``, k = 1 when not sampling."""
        k = self.sample_k
        n = rec.shape[0]
        if k <= 1 or n == 0:
            if n:
                kept_ev = int(rec[:, F.PACKETS].sum())
                with self._lock:
                    self._win_kept += kept_ev
            return rec, 1
        pk = rec[:, F.PACKETS]
        tiers = row_tiers(rec, self.cfg)
        exempt = tiers > TIER_BACKGROUND
        idx = np.nonzero(~exempt)[0]
        # The phase under the lock: feed workers sample concurrently.
        with self._lock:
            phase = self._phase
            self._phase = (phase + idx.size) % k
        keep = exempt.copy()
        keep[idx[(np.arange(idx.size) + phase) % k == 0]] = True
        kept = rec[keep]
        dropped_ev = int(pk.sum()) - int(kept[:, F.PACKETS].sum())
        # Weight the step synthesizes back by the x k rescale of the kept
        # non-exempt rows: the estimated, not observed, share.
        debt = (k - 1) * int(kept[~exempt[keep], F.PACKETS].sum())
        if dropped_ev:
            m = get_metrics()
            m.events_sampled.inc(dropped_ev)
            if debt:
                m.accuracy_debt.inc(debt)
        kept_ev = int(kept[:, F.PACKETS].sum())
        pri_ev = int(pk[tiers == TIER_PRIORITY].sum())
        with self._lock:
            self.counters["events_sampled"] += dropped_ev
            self.counters["accuracy_debt"] += debt
            self._win_sampled += dropped_ev
            self._win_kept += kept_ev
            self._win_priority += pri_ev
        return kept, k

    def note_shed(self, stage: str, amount: int = 1) -> None:
        """Count one shed enrichment unit (events for dns, passes for
        conntrack and labels)."""
        if amount:
            get_metrics().events_shed.labels(stage=stage).inc(amount)
            with self._lock:
                self.counters[f"events_shed:{stage}"] += amount

    # -- window annotation -------------------------------------------------
    def window_annotation(self) -> dict:
        """Snapshot and reset the window's sampling accounting; the engine
        attaches it to every closed window."""
        with self._lock:
            sampled, kept = self._win_sampled, self._win_kept
            priority = self._win_priority
            self._win_sampled = self._win_kept = self._win_priority = 0
            total = sampled + kept
            return {
                "overload_state": STATE_NAMES[self._state],
                "sampled_fraction": (sampled / total) if total else 0.0,
                "events_sampled": sampled,
                "priority_exempt_events": priority,
                "shed": list(self.shed_stages()),
            }

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": STATE_NAMES[self._state],
                "pressure": round(self._pressure, 4),
                "signals": {k: round(v, 4) for k, v in self._sigvals.items()},
                "sample_k": self.sample_k,
                "shed": list(self.shed_stages()),
                "transitions": self._transitions,
                "since_change_s": round(time.monotonic() - self._last_change, 1),
                "counters": dict(self.counters),
            }


def validate_shed_order(order: Iterable[str]) -> tuple[str, ...]:
    """Config-time check: distinct stages, each a known one."""
    order = tuple(order)
    if len(set(order)) != len(order):
        raise ValueError(f"overload_shed_order has duplicates: {order}")
    unknown = set(order) - set(SHED_STAGES)
    if unknown:
        raise ValueError(
            f"unknown overload shed stage(s) {sorted(unknown)}; known: {list(SHED_STAGES)}")
    return order
