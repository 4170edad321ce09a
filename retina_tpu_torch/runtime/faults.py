"""Deterministic fault injection for the chaos suite (a copy of
retina_tpu/runtime/faults.py).

Armed by ``configure(spec)`` (the reference's daemon passes
``cfg.fault_spec``; the port has no daemon yet, so its tests and
chip_smoke.py call it) with a comma-separated spec; each entry is
``site:action[@N]``:

    transfer:raise@3            raise InjectedFault on the 3rd transfer
    harvest:hang@1              hang the harvest thread on its 1st item
    plugin.packetparser:raise@1 crash the plugin's 1st start attempt
    checkpoint:corrupt@1        torn-write the next checkpoint save
    feed.backpressure:press     synthetic queue saturation (sustained)

Actions: ``raise`` (InjectedFault), ``hang`` (block on a module Event
until ``release_hangs()``/``clear()``; ``hang5`` bounds it to 5 s),
``corrupt`` (queried by the checkpoint writer via ``should_corrupt``),
``press`` (sustained saturation queried via ``pressure`` — active from
the first query until ``clear()``, or for ``press5`` = 5 s; drives the
overload controller, runtime/overload.py).
``@N`` fires on exactly the Nth hit of that site; ``@0`` / omitted
fires on every hit. Disarmed (the default) every hook is a single
boolean check — zero cost on the hot path.

This module is intentionally global state: the hooks live deep in the
engine/plugin hot paths where threading a handle through would touch
every constructor. ``configure``/``clear`` own the lifecycle; tests
must ``clear()`` in teardown.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Optional

from retina_tpu_torch.log import logger

_log = logger("faults")


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise`` rule — recovery paths treat it as
    an unrecoverable device/runtime error."""


class _Rule:
    __slots__ = ("site", "action", "nth", "hang_s", "hits", "fired",
                 "since")

    def __init__(self, site: str, action: str, nth: int,
                 hang_s: Optional[float]):
        self.site = site
        self.action = action
        self.nth = nth
        self.hang_s = hang_s  # also the press duration for "press"
        self.hits = 0
        self.fired = 0
        self.since: Optional[float] = None  # first press query (monotonic)


_lock = threading.Lock()
_rules: Dict[str, _Rule] = {}
_armed = False  # fast-path gate: hooks return immediately when False
_unhang = threading.Event()

_ENTRY = re.compile(
    r"^(?P<site>[\w.\-]+):(?P<action>raise|corrupt"
    r"|hang(?P<hang_s>\d+(\.\d+)?)?"
    r"|press(?P<press_s>\d+(\.\d+)?)?)"
    r"(?:@(?P<nth>\d+))?$"
)


def configure(spec: str) -> None:
    """Arm the layer from a spec string; empty/blank disarms."""
    global _armed
    entries: Dict[str, _Rule] = {}
    for raw in (spec or "").split(","):
        raw = raw.strip()
        if not raw:
            continue
        m = _ENTRY.match(raw)
        if m is None:
            raise ValueError(
                f"bad fault spec entry {raw!r} "
                "(want site:action[@N], action in "
                "raise|hang[secs]|corrupt|press[secs])"
            )
        action = m.group("action")
        hang_s: Optional[float] = None
        if action.startswith("hang"):
            hang_s = float(m.group("hang_s")) if m.group("hang_s") else None
            action = "hang"
        elif action.startswith("press"):
            hang_s = float(m.group("press_s")) if m.group("press_s") else None
            action = "press"
        entries[m.group("site")] = _Rule(
            m.group("site"), action, int(m.group("nth") or 0), hang_s
        )
    with _lock:
        _unhang.set()  # free anything hung by a previous spec
        _rules.clear()
        _rules.update(entries)
        _armed = bool(entries)
        if _armed:
            _unhang.clear()
    if entries:
        _log.warning(
            "fault injection ARMED: %s",
            ",".join(f"{r.site}:{r.action}@{r.nth}" for r in entries.values()),
        )


def clear() -> None:
    """Disarm and release any hung threads."""
    global _armed
    with _lock:
        _armed = False
        _rules.clear()
        _unhang.set()


def release_hangs() -> None:
    """Unblock threads currently parked in a ``hang`` rule without
    disarming the remaining rules."""
    _unhang.set()


def armed() -> bool:
    return _armed


def inject(site: str) -> None:
    """Hot-path hook: no-op unless armed with a matching rule whose
    Nth hit this is. ``raise`` rules raise InjectedFault; ``hang``
    rules block until released (or their bound elapses)."""
    if not _armed:
        return
    with _lock:
        r = _rules.get(site)
        if r is None:
            return
        r.hits += 1
        if r.nth and r.hits != r.nth:
            return
        r.fired += 1
        action, hang_s, hit = r.action, r.hang_s, r.hits
    if action == "raise":
        raise InjectedFault(f"injected fault at {site} (hit {hit})")
    if action == "hang":
        _log.warning("injected hang at %s (hit %d)", site, hit)
        _unhang.wait(hang_s)


def should_corrupt(site: str) -> bool:
    """Queried by writers (checkpoint save) that implement corruption
    themselves; True on the armed Nth hit of a ``corrupt`` rule."""
    if not _armed:
        return False
    with _lock:
        r = _rules.get(site)
        if r is None or r.action != "corrupt":
            return False
        r.hits += 1
        if r.nth and r.hits != r.nth:
            return False
        r.fired += 1
        return True


def pressure(site: str) -> bool:
    """Sustained query-style saturation: True while an armed ``press``
    rule for ``site`` is active. Unlike ``inject`` this does not
    consume hits one-shot — the overload controller polls it every
    tick; an unbounded rule stays active until ``clear()``, a bounded
    one (``press5``) for that many seconds after its first query."""
    if not _armed:
        return False
    import time as _time

    with _lock:
        r = _rules.get(site)
        if r is None or r.action != "press":
            return False
        r.hits += 1
        now = _time.monotonic()
        if r.since is None:
            r.since = now
            r.fired += 1
            _log.warning("injected backpressure at %s active", site)
        if r.hang_s is not None and now - r.since > r.hang_s:
            return False
        return True


def stats() -> dict:
    with _lock:
        return {
            "armed": _armed,
            "rules": {
                s: {"action": r.action, "nth": r.nth,
                    "hits": r.hits, "fired": r.fired}
                for s, r in _rules.items()
            },
        }
