"""externalevents: ingest records from an external process (port of
retina_tpu/plugins/externalevents.py).

Reference analog: pkg/plugin/ciliumeventobserver — connects to another
dataplane's monitor unix socket, decodes its payloads, and re-emits them
as Retina flows (ciliumeventobserver_linux.go). Generalized here: a unix
socket server accepting length-prefixed msgpack frames
``{"records": <bytes of (N,16) uint32 le>, "dns_names": {hash: name}}``
from any producer (another agent, a Go control plane, a replay tool),
re-emitted into the sink.
"""

from __future__ import annotations

import os
import socket
import threading

from retina_tpu_torch.config import Config
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin
from retina_tpu_torch.plugins.framing import (  # noqa: F401 — re-exported API
    MAX_FRAME,
    decode_record_frame,
    publish_dns_names,
    read_frames,
    send_frame,
)


@registry.register
class ExternalEventsPlugin(Plugin):
    name = "externalevents"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self._server: socket.socket | None = None

    def init(self) -> None:
        path = self.cfg.external_socket
        try:
            os.unlink(path)
        except OSError:  # noqa: RT101 — stale socket may not exist
            pass
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(path)
        self._server.listen(4)
        self._server.settimeout(0.2)
        self.log.info("listening on %s", path)

    def _serve_conn(self, conn: socket.socket, stop: threading.Event) -> None:
        conn.settimeout(0.2)
        try:
            read_frames(conn, stop, self._handle_frame, self.log)
        finally:
            conn.close()

    def _handle_frame(self, frame: bytes) -> None:
        try:
            rec, names = decode_record_frame(frame)
        except Exception:
            self.count_lost("decode", 1)
            self.log.exception("bad external frame")
            return
        publish_dns_names(names)
        self.emit(rec)

    def start(self, stop: threading.Event) -> None:
        assert self._server is not None
        workers: list[threading.Thread] = []
        while not stop.is_set():
            try:
                conn, _ = self._server.accept()
            except (TimeoutError, socket.timeout):
                continue
            except OSError:
                break
            t = threading.Thread(
                target=self._serve_conn, args=(conn, stop), daemon=True
            )
            t.start()
            workers.append(t)
        for t in workers:
            t.join(timeout=1.0)

    def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None
            try:
                os.unlink(self.cfg.external_socket)
            except OSError:  # noqa: RT101 — socket already removed
                pass
