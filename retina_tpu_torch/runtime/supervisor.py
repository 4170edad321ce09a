"""Supervision tree for the agent's long-lived threads (a copy of
retina_tpu/runtime/supervisor.py).

Three cooperating pieces, kept deliberately dependency-light so the
engine can use them standalone (tests construct a SketchEngine without
a ControllerManager):

  Heartbeat      — a per-thread liveness cell. The owning thread calls
                   ``beat()`` each loop iteration and ``park()`` right
                   before an intentional blocking wait (queue.get,
                   Event.wait, a device fence) so the watchdog does not
                   mistake idleness for a stall.
  Supervisor     — the registry + watchdog scan thread. A heartbeat
                   whose age exceeds its deadline while not parked is a
                   stall: logged, counted in ``watchdog_stalls`` and
                   escalated through the heartbeat's ``on_stall``
                   callback (e.g. the engine replaces a hung harvest
                   thread). Escalation re-fires once per deadline while
                   the stall persists and re-arms on the next beat.
  RestartPolicy  — exponential backoff + jitter with a crash-loop
                   circuit breaker (closed → open after
                   ``max_failures`` consecutive crashes → half_open
                   probe after ``half_open_after_s`` → closed again
                   once a probe run stays healthy for ``window_s``).

``Supervisor.spawn`` ties them together into a supervised thread: the
target is restarted under the policy until it returns cleanly, the
stop event fires, or the circuit gives up to half-open probing.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Callable, Dict, Optional

from retina_tpu_torch.log import logger

_log = logger("supervisor")


class Heartbeat:
    """Liveness cell for one long-lived thread.

    ``beat()`` is wait-free for the owner (a monotonic-clock store);
    the watchdog reads it from its own thread. ``park()`` marks the
    thread as intentionally blocked so idle waits never count as
    stalls — only work that *started* (a beat after the last park) and
    then stopped making progress does.
    """

    __slots__ = ("name", "deadline_s", "on_stall", "_last", "_parked",
                 "_stalled_since", "_last_escalation", "stalls")

    def __init__(self, name: str, deadline_s: float = 30.0,
                 on_stall: Optional[Callable[[], None]] = None):
        self.name = name
        self.deadline_s = float(deadline_s)
        self.on_stall = on_stall
        self._last = time.monotonic()
        self._parked = False
        self._stalled_since: Optional[float] = None
        self._last_escalation = 0.0
        self.stalls = 0

    def beat(self) -> None:
        self._last = time.monotonic()
        self._parked = False
        self._stalled_since = None

    def park(self) -> None:
        """Declare an intentional blocking wait (queue.get / Event.wait
        / device fence). The watchdog skips parked heartbeats."""
        self._last = time.monotonic()
        self._parked = True

    @property
    def parked(self) -> bool:
        return self._parked

    def age(self, now: Optional[float] = None) -> float:
        return (time.monotonic() if now is None else now) - self._last

    def stats(self) -> dict:
        return {
            "age_s": round(self.age(), 3),
            "deadline_s": self.deadline_s,
            "parked": self._parked,
            "stalled": self._stalled_since is not None,
            "stalls": self.stalls,
        }


class RestartPolicy:
    """Exponential backoff + crash-loop circuit breaker.

    States: ``closed`` (normal; crashes get a backoff delay),
    ``open`` (``max_failures`` consecutive crashes — the caller should
    stop hammering and surface unhealthy), ``half_open`` (one probe
    run allowed; a crash re-opens, staying healthy for ``window_s``
    closes). A run that lives longer than ``window_s`` resets the
    consecutive-failure count, so sporadic crashes spread over time
    never open the circuit.
    """

    def __init__(self, base_s: float = 0.2, max_s: float = 30.0,
                 jitter: float = 0.2, max_failures: int = 5,
                 window_s: float = 60.0, half_open_after_s: float = 30.0,
                 seed: Optional[int] = None):
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.max_failures = int(max_failures)
        self.window_s = float(window_s)
        self.half_open_after_s = float(half_open_after_s)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._started: Optional[float] = None
        self.restarts = 0  # total crashes recorded over the lifetime

    # -- state ---------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_close_locked(time.monotonic())
            return self._state

    def _maybe_close_locked(self, now: float) -> None:
        # A half-open probe that has stayed up past the healthy window
        # closes the circuit; same window resets closed-state streaks.
        if self._started is None:
            return
        if now - self._started >= self.window_s:
            self._consecutive = 0
            if self._state == "half_open":
                self._state = "closed"

    def note_start(self) -> None:
        """Record that a supervised run (or probe) just started."""
        with self._lock:
            self._started = time.monotonic()

    def record_failure(self) -> Optional[float]:
        """Record a crash. Returns the backoff delay to wait before the
        next attempt, or ``None`` when the circuit just opened (caller
        should go unhealthy and fall back to half-open probing)."""
        now = time.monotonic()
        with self._lock:
            self._maybe_close_locked(now)
            self.restarts += 1
            self._started = None
            if self._state == "half_open":
                self._state = "open"
                return None
            self._consecutive += 1
            if self._consecutive >= self.max_failures:
                self._state = "open"
                return None
            d = min(self.base_s * (2.0 ** (self._consecutive - 1)),
                    self.max_s)
            return d * (1.0 + self.jitter * self._rng.random())

    def wait_half_open(self, stop: threading.Event) -> bool:
        """Block (stop-interruptibly) until the half-open probe window,
        then transition open → half_open. False if stop fired."""
        if stop.wait(self.half_open_after_s):
            return False
        with self._lock:
            if self._state == "open":
                self._state = "half_open"
        return True

    def reset(self) -> None:
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._started = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "restarts": self.restarts,
            }


def policy_from_config(cfg, seed_key: str = "") -> RestartPolicy:
    """Build a RestartPolicy from the agent Config knobs. ``seed_key``
    derives a stable per-thread jitter seed so backoff schedules are
    reproducible across runs (and decorrelated across threads)."""
    seed = zlib.crc32(seed_key.encode()) if seed_key else None
    return RestartPolicy(
        base_s=cfg.restart_backoff_base_s,
        max_s=cfg.restart_backoff_max_s,
        jitter=cfg.restart_backoff_jitter,
        max_failures=cfg.restart_max_failures,
        window_s=cfg.restart_window_s,
        half_open_after_s=cfg.circuit_half_open_s,
        seed=seed,
    )


class Supervisor:
    """Heartbeat registry + watchdog.

    Threads register once (idempotent by name — a replacement thread
    re-registering under the same name takes over the cell) and beat;
    the watchdog scans every ``interval_s`` and escalates stalls. The
    watchdog itself is crash-proof: a throwing ``on_stall`` callback is
    contained and counted, never kills the scan loop.
    """

    def __init__(self, deadline_s: float = 30.0, interval_s: float = 0.5):
        self.deadline_s = float(deadline_s)
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._beats: Dict[str, Heartbeat] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- registry ------------------------------------------------------
    def register(self, name: str, deadline_s: Optional[float] = None,
                 on_stall: Optional[Callable[[], None]] = None) -> Heartbeat:
        hb = Heartbeat(name, deadline_s or self.deadline_s, on_stall)
        with self._lock:
            old = self._beats.get(name)
            if old is not None:
                hb.stalls = old.stalls  # cumulative across replacements
            self._beats[name] = hb
        return hb

    def deregister(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)

    def heartbeat(self, name: str) -> Optional[Heartbeat]:
        with self._lock:
            return self._beats.get(name)

    # -- watchdog ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, name="watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, 2 * self.interval_s))
        self._thread = None

    def _watch(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scan_once()
            except Exception:
                _log.exception("watchdog scan failed")

    def scan_once(self, now: Optional[float] = None) -> list:
        """One watchdog pass; returns the names escalated this pass
        (exposed for deterministic tests)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            beats = list(self._beats.values())
        escalated = []
        for hb in beats:
            if hb.parked or hb.age(now) <= hb.deadline_s:
                continue
            # Escalate at most once per deadline while the stall lasts.
            if now - hb._last_escalation < hb.deadline_s:
                continue
            hb._last_escalation = now
            if hb._stalled_since is None:
                hb._stalled_since = now
            hb.stalls += 1
            escalated.append(hb.name)
            _log.error(
                "watchdog: thread %s stalled (no beat for %.1fs, "
                "deadline %.1fs)", hb.name, hb.age(now), hb.deadline_s,
            )
            self._count_stall(hb.name)
            if hb.on_stall is not None:
                try:
                    hb.on_stall()
                except Exception:
                    _log.exception(
                        "watchdog: on_stall for %s failed", hb.name
                    )
        return escalated

    @staticmethod
    def _count_stall(name: str) -> None:
        # Late import keeps bare unit tests from paying the exporter
        # registry cost until a stall actually happens.
        from retina_tpu_torch.metrics import get_metrics

        get_metrics().watchdog_stalls.labels(thread=name).inc()

    # -- supervised threads -------------------------------------------
    def spawn(self, name: str, target: Callable[[], None],
              stop: threading.Event,
              policy: Optional[RestartPolicy] = None) -> threading.Thread:
        """Run ``target`` on a named daemon thread, restarting it under
        ``policy`` when it raises. A clean return ends supervision; an
        open circuit falls back to half-open probing until stop."""
        pol = policy or RestartPolicy()

        def _runner() -> None:
            while not stop.is_set():
                pol.note_start()
                try:
                    target()
                    return
                except Exception:
                    if stop.is_set():
                        return
                    delay = pol.record_failure()
                    if delay is None:
                        _log.exception(
                            "supervised thread %s crash-looping; circuit "
                            "OPEN (half-open probe in %.0fs)",
                            name, pol.half_open_after_s,
                        )
                        if not pol.wait_half_open(stop):
                            return
                        continue
                    _log.exception(
                        "supervised thread %s crashed; restart in %.2fs",
                        name, delay,
                    )
                    self._count_restart(name)
                    if stop.wait(delay):
                        return

        t = threading.Thread(target=_runner, name=name, daemon=True)
        t.start()
        return t

    @staticmethod
    def _count_restart(name: str) -> None:
        from retina_tpu_torch.metrics import get_metrics

        get_metrics().thread_restarts.labels(thread=name).inc()

    # -- introspection -------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {name: hb.stats() for name, hb in self._beats.items()}

    def summary(self) -> dict:
        with self._lock:
            beats = list(self._beats.values())
        return {
            "threads": len(beats),
            "stalled": sum(
                1 for hb in beats if hb._stalled_since is not None
            ),
            "stalls_total": sum(hb.stalls for hb in beats),
        }
