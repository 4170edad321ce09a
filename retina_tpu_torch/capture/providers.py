"""Capture providers (copy of ``ReplayProvider`` and ``_apply_filter`` of
retina_tpu/capture/providers.py).

``ReplayProvider`` captures from a record stream by re-encoding a window
of its records as packets into a synthesized pcap: the faithful capture
when the agent's packets never touch this host's NICs. Its ``engine=``
path watches the engine's feed loop through an observer
(``SketchEngine.add_observer``) for up to ``duration_s``; its ``source=``
path pulls blocks from a callable.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable

import numpy as np

from retina_tpu_torch.events.schema import F, u32_to_ip


class CaptureError(RuntimeError):
    pass


class ReplayProvider:
    """Capture a record stream into a pcap."""

    name = "replay"

    def __init__(self, engine=None, source: Callable[[], np.ndarray] | None = None):
        self._engine = engine
        self._source = source

    @staticmethod
    def available() -> bool:
        return True

    def capture(self, out_path: str, filter_expr: str = "", iface: str = "",
                duration_s: int = 60, max_size_mb: int = 100, packet_size: int = 0) -> None:
        from retina_tpu_torch.sources.pcapdecode import synthesize_pcap

        records: list[np.ndarray] = []
        max_events = max_size_mb * 1024 * 1024 // 80
        if self._engine is not None:
            done, closed = threading.Event(), threading.Event()
            lock = threading.Lock()

            def obs(rec: np.ndarray, plugin: str) -> None:
                with lock:
                    if closed.is_set():
                        return
                    if sum(len(r) for r in records) < max_events:
                        records.append(rec.copy())
                    else:
                        done.set()

            self._engine.add_observer(obs)
            done.wait(duration_s)
            # Observers are append-only, as the reference's: this one goes
            # inert when the window ends.
            with lock:
                closed.set()
        elif self._source is not None:
            t_end = time.monotonic() + min(duration_s, 5)
            while time.monotonic() < t_end and sum(len(r) for r in records) < max_events:
                records.append(self._source())
        if not records:
            raise CaptureError("no events observed during capture window")
        rec = np.concatenate(records)[:max_events]
        pkts = [
            dict(
                src_ip=int(r[F.SRC_IP]), dst_ip=int(r[F.DST_IP]),
                sport=int(r[F.PORTS]) >> 16, dport=int(r[F.PORTS]) & 0xFFFF,
                proto=int(r[F.META]) >> 24,
                tcp_flags=(int(r[F.META]) >> 16) & 0xFF,
                ts_ns=(int(r[F.TS_HI]) << 32) | int(r[F.TS_LO]),
                tsval=int(r[F.TSVAL]), tsecr=int(r[F.TSECR]),
            )
            for r in rec
        ]
        if filter_expr:
            pkts = _apply_filter(pkts, filter_expr)
        with open(out_path, "wb") as fh:
            fh.write(synthesize_pcap(pkts))


def _apply_filter(pkts: list[dict], expr: str) -> list[dict]:
    """Host and port filter evaluation for replay captures (the
    expressions of translator.synthesize_filter)."""
    hosts = set(re.findall(r"host (\d+\.\d+\.\d+\.\d+)", expr))
    ports = {int(p) for p in re.findall(r"port (\d+)", expr)}

    def keep(p: dict) -> bool:
        ok = True
        if hosts:
            ok &= (u32_to_ip(p["src_ip"]) in hosts or u32_to_ip(p["dst_ip"]) in hosts)
        if ports:
            ok &= p["sport"] in ports or p["dport"] in ports
        return ok

    return [p for p in pkts if keep(p)]
