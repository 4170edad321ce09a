"""Traces module: per-flow trace sampling (copy of retina_tpu/module/traces.py).

Reference analog: pkg/module/traces — a skeleton that only stores
``TracesSpec`` reconciles (traces_module.go; the trace pipeline itself
never landed). This module goes further while keeping the same CRD
surface: a reconciled spec compiles into vectorized record matchers, an
engine observer samples matching rows off the live feed (bounded rings,
per-mille sampling — the observer runs on the feed thread and must stay
O(numpy) per block), and the sampled flow traces are queryable through
``/debug/vars`` (CLI ``retina-tpu trace``).

TracesSpec mapping (crd/types.py):
- ``trace_targets``: list of {"name", "ips": [dotted-quads],
  "ports": [ints], "protocols": ["tcp"|"udp"]} — a row matches a target
  if src OR dst IP is listed (empty = any), and similarly for ports /
  protocols.
- ``trace_points``: subset of {"ingress", "egress"} (empty = both),
  matched against the record's traffic direction.
- ``sampling_rate_per_mille``: 0 or 1000 = keep every matching row;
  else keep rows whose flow hash falls under rate/1000 — sampling is
  per FLOW (hash of the canonical 5-tuple), so a sampled flow's whole
  trace is kept rather than random rows of many flows.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any

import numpy as np

from retina_tpu_torch.crd.types import TracesConfiguration, TracesSpec
from retina_tpu_torch.events.schema import (
    DIR_EGRESS,
    DIR_INGRESS,
    F,
    PROTO_TCP,
    PROTO_UDP,
    ip_to_u32,
    u32_to_ip,
)
from retina_tpu_torch.log import logger

MAX_EVENTS_PER_TARGET = 512  # bounded ring per target
MAX_ROWS_PER_BLOCK = 64  # per-block cap: the observer must stay cheap

_PROTO = {"tcp": PROTO_TCP, "udp": PROTO_UDP}
_DIR = {"ingress": DIR_INGRESS, "egress": DIR_EGRESS}


class _Target:
    __slots__ = ("name", "ips", "ports", "protos")

    def __init__(self, name: str, ips: set[int], ports: set[int],
                 protos: set[int]):
        self.name = name
        # Arrays precomputed HERE: observe() runs per record block on
        # the feed thread and must not rebuild them per call.
        self.ips = (
            np.fromiter(ips, np.uint32, len(ips)) if ips else None
        )
        self.ports = (
            np.fromiter(ports, np.uint32, len(ports)) if ports else None
        )
        self.protos = protos


class TracesModule:
    def __init__(self) -> None:
        self._log = logger("tracesmodule")
        self._lock = threading.Lock()
        self._spec: TracesSpec | None = None
        self._targets: list[_Target] = []
        self._dirs: set[int] = set()
        self._per_mille = 1000
        self._rings: dict[str, collections.deque] = {}
        self._matched = 0

    # -- wiring --------------------------------------------------------
    def attach(self, engine: Any) -> None:
        """Register as an engine observer (the dns/hubble seam) — every
        accepted record block flows through :meth:`observe`."""
        engine.add_observer(self.observe)

    # -- reconcile (traces_module.go Reconcile analog) -----------------
    def reconcile(self, conf: TracesConfiguration) -> None:
        targets: list[_Target] = []
        for i, t in enumerate(conf.spec.trace_targets):
            try:
                ips = {ip_to_u32(ip) for ip in t.get("ips", [])}
                ports = {int(p) for p in t.get("ports", [])}
                protos = {
                    _PROTO[p.lower()]
                    for p in t.get("protocols", [])
                    if p.lower() in _PROTO
                }
                targets.append(
                    _Target(str(t.get("name", f"target-{i}")),
                            ips, ports, protos)
                )
            except (ValueError, AttributeError, TypeError) as e:
                self._log.warning("trace target %d invalid: %s", i, e)
        dirs = {_DIR[p] for p in conf.spec.trace_points if p in _DIR}
        rate = int(conf.spec.sampling_rate_per_mille) or 1000
        with self._lock:
            self._spec = conf.spec
            self._targets = targets
            self._dirs = dirs
            self._per_mille = max(1, min(rate, 1000))
            self._rings = {
                t.name: self._rings.get(
                    t.name,
                    collections.deque(maxlen=MAX_EVENTS_PER_TARGET),
                )
                for t in targets
            }
        self._log.info(
            "traces reconciled: %d target(s), points=%s, %d/1000 flows",
            len(targets),
            sorted(conf.spec.trace_points) or "any",
            self._per_mille,
        )

    def active_spec(self) -> TracesSpec | None:
        with self._lock:
            return self._spec

    # -- sampling (engine observer; feed thread — stay vectorized) -----
    def observe(self, rec: np.ndarray, plugin: str) -> None:
        with self._lock:
            targets = self._targets
            dirs = self._dirs
            per_mille = self._per_mille
        if not targets or len(rec) == 0:
            return
        src = rec[:, F.SRC_IP]
        dst = rec[:, F.DST_IP]
        ports = rec[:, F.PORTS]
        sport = ports >> np.uint32(16)
        dport = ports & np.uint32(0xFFFF)
        meta = rec[:, F.META]
        proto = meta >> np.uint32(24)
        direction = (meta >> np.uint32(4)) & np.uint32(0xF)
        base = np.ones(len(rec), bool)
        if dirs:
            dmask = np.zeros(len(rec), bool)
            for d in dirs:
                dmask |= direction == d
            base &= dmask
        if per_mille < 1000:
            # Flow-consistent sampling: hash the canonical 5-tuple so a
            # sampled flow keeps its WHOLE trace across blocks.
            from retina_tpu_torch.parallel.partition import canonical_conn_hash

            base &= (
                canonical_conn_hash(rec) % np.uint32(1000)
            ) < np.uint32(per_mille)
        if not base.any():
            return
        now = time.time()
        for tgt in targets:
            m = base
            if tgt.ips is not None:
                m = m & (np.isin(src, tgt.ips) | np.isin(dst, tgt.ips))
            if tgt.ports is not None:
                m = m & (
                    np.isin(sport, tgt.ports)
                    | np.isin(dport, tgt.ports)
                )
            if tgt.protos:
                pmask = np.zeros(len(rec), bool)
                for p in tgt.protos:
                    pmask |= proto == p
                m = m & pmask
            idx = np.flatnonzero(m)[:MAX_ROWS_PER_BLOCK]
            if len(idx) == 0:
                continue
            rows = rec[idx]
            events = [
                {
                    "ts": now,
                    "plugin": plugin,
                    "src": u32_to_ip(int(r[F.SRC_IP])),
                    "dst": u32_to_ip(int(r[F.DST_IP])),
                    "sport": int(r[F.PORTS]) >> 16,
                    "dport": int(r[F.PORTS]) & 0xFFFF,
                    "proto": int(r[F.META]) >> 24,
                    "direction": (int(r[F.META]) >> 4) & 0xF,
                    "verdict": int(r[F.VERDICT]),
                    "drop_reason": int(r[F.DROP_REASON]),
                    "event_type": int(r[F.EVENT_TYPE]),
                    "bytes": int(r[F.BYTES]),
                    "packets": int(r[F.PACKETS]),
                }
                for r in rows
            ]
            with self._lock:
                ring = self._rings.get(tgt.name)
                if ring is not None:
                    ring.extend(events)
                    self._matched += len(events)

    # -- query (CLI `trace` via /debug/vars) ---------------------------
    def traces(self, target: str | None = None,
               limit: int = 100) -> dict[str, list[dict]]:
        with self._lock:
            names = [target] if target else list(self._rings)
            return {
                n: list(self._rings[n])[-limit:]
                for n in names
                if n in self._rings
            }

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "targets": [t.name for t in self._targets],
                "events_sampled": self._matched,
                "per_target": {n: len(r) for n, r in self._rings.items()},
            }
