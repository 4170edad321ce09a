"""ciliumeventobserver: ingest flows from a real Cilium dataplane (port of
retina_tpu/plugins/ciliumeventobserver.py).

Reference analog: pkg/plugin/ciliumeventobserver/ciliumeventobserver_linux.go
:49-200 — dial Cilium's monitor unix socket, gob-decode
``payload.Payload`` values, parse the embedded BPF perf events into
flows, and feed them to the enricher. Differences by design: the gob
decode is an incremental pure-Python codec (sources/gobcodec.py), the
perf-event headers parse into the shared record schema, and the embedded
packets batch-decode through the SAME vectorized packet decoder as every
other source (sources/cilium_monitor.py) — so Cilium-origin flows enter
the device pipeline as one more batched record stream, not a per-event
object path.

Wire-compat note: a generalized high-rate path for OTHER producers (our
own agents, replay tools) exists separately as ``externalevents``
(length-prefixed msgpack frames); THIS plugin speaks Cilium's actual
socket protocol so it can attach to an unmodified Cilium agent.
"""

from __future__ import annotations

import socket
import threading
import time

from retina_tpu_torch.config import Config
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin
from retina_tpu_torch.sources.cilium_monitor import (
    PAYLOAD_EVENT_SAMPLE,
    PAYLOAD_RECORD_LOST,
    events_to_records,
    parse_perf_sample,
)
from retina_tpu_torch.sources.gobcodec import GobError, GobStreamDecoder

# Reference constants (ciliumeventobserver_linux.go:24-29).
MAX_ATTEMPTS = 5
RETRY_DELAY_S = 12.0
BATCH_FRAMES = 2048  # flush the parsed-event batch at this size
BATCH_INTERVAL_S = 0.05  # ...or this age, whichever first


@registry.register
class CiliumEventObserverPlugin(Plugin):
    name = "ciliumeventobserver"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self._retry_delay = RETRY_DELAY_S
        self._max_attempts = MAX_ATTEMPTS

    def generate(self) -> None:
        if not self.cfg.monitor_sock_path:
            raise ValueError(
                "ciliumeventobserver: monitor_sock_path not set"
            )

    def _connect(self, stop: threading.Event) -> socket.socket | None:
        """Dial with bounded retry (reference connect(), :130-152)."""
        for attempt in range(1, self._max_attempts + 1):
            if stop.is_set():
                return None
            try:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.settimeout(0.2)
                s.connect(self.cfg.monitor_sock_path)
                self.log.info(
                    "connected to cilium monitor %s",
                    self.cfg.monitor_sock_path,
                )
                return s
            except OSError as e:
                self.log.warning(
                    "monitor connect attempt %d/%d failed: %s",
                    attempt, self._max_attempts, e,
                )
                if attempt < self._max_attempts:
                    stop.wait(self._retry_delay)
        self.log.error(
            "failed to connect to cilium monitor after %d attempts",
            self._max_attempts,
        )
        return None

    def _flush(self, batch: list) -> None:
        rec, dns_names = events_to_records(batch)
        if dns_names:
            from retina_tpu_torch.plugins.framing import publish_dns_names

            publish_dns_names(dns_names)
        if len(rec):
            self.emit(rec)
        batch.clear()

    def _consume_payload(self, pl: object, batch: list) -> None:
        if not isinstance(pl, dict):
            self.count_lost("parser", 1)
            return
        ptype = pl.get("Type", 0)
        if ptype == PAYLOAD_RECORD_LOST:
            # The dataplane itself dropped perf records before the
            # socket — surface it like the reference does (:171-173).
            self.count_lost("kernel", int(pl.get("Lost", 0)) or 1)
            return
        if ptype != PAYLOAD_EVENT_SAMPLE:
            self.count_lost("parser", 1)
            return
        ev = parse_perf_sample(bytes(pl.get("Data", b"")))
        if ev is None:
            # Debug/agent/L7 message types carry no packet; not a loss.
            return
        batch.append(ev)

    def start(self, stop: threading.Event) -> None:
        while not stop.is_set():
            conn = self._connect(stop)
            if conn is None:
                return
            try:
                self._monitor_loop(conn, stop)
            finally:
                conn.close()
            # EOF/decode failure: reconnect from scratch (reference
            # Start loop re-dials after monitorLoop returns, :96-106).

    def _monitor_loop(
        self, conn: socket.socket, stop: threading.Event
    ) -> None:
        dec = GobStreamDecoder()
        batch: list = []
        last_flush = time.monotonic()
        try:
            while not stop.is_set():
                try:
                    data = conn.recv(1 << 16)
                    if not data:
                        self.log.info("monitor socket EOF")
                        return
                except (TimeoutError, socket.timeout):
                    data = b""
                except OSError as e:
                    self.log.warning("monitor socket error: %s", e)
                    return
                if data:
                    try:
                        for pl in dec.feed(data):
                            self._consume_payload(pl, batch)
                    except GobError as e:
                        # Un-resynchronizable: gob framing is stateful,
                        # so drop the connection and re-dial (the
                        # reference counts and continues only for
                        # per-payload decode errors; a framing error
                        # likewise breaks its stream).
                        self.log.warning("gob stream error: %s", e)
                        self.count_lost("parser", 1)
                        return
                now = time.monotonic()
                if len(batch) >= BATCH_FRAMES or (
                    batch and now - last_flush >= BATCH_INTERVAL_S
                ):
                    self._flush(batch)
                    last_flush = now
        finally:
            # Every exit path (EOF, socket error, gob desync, stop)
            # flushes events already parsed — they are intact, and
            # dropping them silently would violate the drop-and-count
            # rule without even the count.
            if batch:
                self._flush(batch)
