"""FilterManager: refcounted IPs-of-interest façade (a copy of
retina_tpu/managers/filtermanager.py).

Reference analog: pkg/managers/filtermanager — a singleton façade over the
BPF LPM filter map with a refcounting cache keyed by (IP, requestor,
ruleID) and exponential-backoff retry on map writes
(manager_linux.go:31-100). Here the "map" is the engine's device-side
filter IdentityMap (pipeline masks events whose endpoints match neither a
pod identity nor this set — models/pipeline.py filter block); writes are
debounced rebuilds of that table.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

from retina_tpu_torch.common import retry
from retina_tpu_torch.log import logger


class FilterManager:
    def __init__(
        self,
        apply_fn: Optional[Callable[[set[int]], None]] = None,
        max_retries: int = 5,
    ):
        """``apply_fn`` receives the full IP set on every change —
        typically ``engine.update_filter_ips``."""
        self._log = logger("filtermanager")
        self._lock = threading.Lock()
        # ip -> {(requestor, rule_id)}
        self._refs: dict[int, set[tuple[str, str]]] = {}
        self._apply = apply_fn
        self._retries = max_retries
        self._deferring = 0
        self._dirty = False

    def _push(self) -> None:
        if self._apply is None:
            return
        with self._lock:
            ips = set(self._refs)
        # Retry covers TRANSIENT device-write failures only; overflow is
        # handled inside the engine (clamp + lost_table_entries counter,
        # engine.update_filter_ips) because backoff can't fix a
        # deterministic condition. A final failure is logged, never
        # raised into the pubsub callback that triggered the push — the
        # reference likewise counts failures and stays up
        # (manager_linux.go:62-100).
        try:
            retry(lambda: self._apply(ips), attempts=self._retries,
                  base_delay_s=0.05)
        except Exception:
            from retina_tpu_torch.metrics import get_metrics

            get_metrics().filter_push_failures.inc()
            self._log.exception(
                "filter push failed after %d attempts (%d IPs)",
                self._retries, len(ips),
            )

    def _maybe_push(self) -> None:
        with self._lock:
            if self._deferring:
                self._dirty = True
                return
        self._push()

    @contextlib.contextmanager
    def deferred_push(self):
        """Batch many add/delete calls into ONE table push — e.g. a
        namespace annotation toggle resyncing every pod in it."""
        with self._lock:
            self._deferring += 1
        try:
            yield
        finally:
            with self._lock:
                self._deferring -= 1
                do = self._deferring == 0 and self._dirty
                if do:
                    self._dirty = False
            if do:
                self._push()

    def add_ips(self, ips: list[int], requestor: str, rule_id: str) -> None:
        """Refcounted add (manager_linux.go AddIPs :62-100)."""
        changed = False
        with self._lock:
            for ip in ips:
                refs = self._refs.setdefault(ip, set())
                if not refs:
                    changed = True
                refs.add((requestor, rule_id))
        if changed:
            self._maybe_push()

    def delete_ips(self, ips: list[int], requestor: str, rule_id: str) -> None:
        """Deletes only when the last (requestor, rule) drops its ref."""
        changed = False
        with self._lock:
            for ip in ips:
                refs = self._refs.get(ip)
                if refs is None:
                    continue
                refs.discard((requestor, rule_id))
                if not refs:
                    del self._refs[ip]
                    changed = True
        if changed:
            self._maybe_push()

    def has_ip(self, ip: int) -> bool:
        with self._lock:
            return ip in self._refs

    def ip_count(self) -> int:
        with self._lock:
            return len(self._refs)
