"""Shared record-frame wire format (port of retina_tpu/plugins/framing.py).

One framing for every socket-based record producer and consumer
(the externalevents server and its producers): a little-endian u32 length
prefix, then a MessagePack document ``{"records": <bytes of (N, 16) uint32
le>, "dns_names": {hash: name}}``, byte for byte the reference's. The
document is packed and read by the port's own MessagePack subset
(``utils/_msgpack.py``): the port does not import ``msgpack``.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable

import numpy as np

from retina_tpu_torch.events.schema import NUM_FIELDS
from retina_tpu_torch.utils import _msgpack

MAX_FRAME = 64 << 20


def encode_record_frame(records: np.ndarray, dns_names: dict[int, str] | None = None) -> bytes:
    """A record block as one frame: the length prefix and the document."""
    payload = _msgpack.packb({
        "records": np.ascontiguousarray(records, np.uint32).tobytes(),
        "dns_names": dns_names or {},
    })
    return struct.pack("<I", len(payload)) + payload


def send_frame(sock: socket.socket, records: np.ndarray,
               dns_names: dict[int, str] | None = None) -> None:
    """Producer-side helper: ship a record block."""
    sock.sendall(encode_record_frame(records, dns_names))


def decode_record_frame(frame: bytes) -> tuple[np.ndarray, dict[int, str]]:
    """Frame payload -> ((N, 16) uint32 records, dns_names). Raises on a
    malformed frame; callers count the loss."""
    doc = _msgpack.unpackb(frame, strict_map_key=False)
    rec = np.frombuffer(doc["records"], np.uint32).reshape(-1, NUM_FIELDS).copy()
    return rec, dict(doc.get("dns_names") or {})


def read_frames(conn: socket.socket, stop: threading.Event, on_frame: Callable[[bytes], None],
                log) -> None:
    """Drain frames from a connected socket until EOF, error, stop, or an
    oversized frame (which poisons the length stream: the connection is
    abandoned, as the reference drops a desynced monitor socket)."""
    buf = b""
    while not stop.is_set():
        try:
            chunk = conn.recv(1 << 20)
        except (TimeoutError, socket.timeout):
            continue
        except OSError:
            return
        if not chunk:
            return
        buf += chunk
        while len(buf) >= 4:
            (n,) = struct.unpack_from("<I", buf)
            if n > MAX_FRAME:
                log.error("frame too large (%d bytes); dropping conn", n)
                return
            if len(buf) < 4 + n:
                break
            frame, buf = buf[4:4 + n], buf[4 + n:]
            on_frame(frame)


def publish_dns_names(names: dict[int, str]) -> None:
    """Feed decoded qname strings to the DNS plugin's string table."""
    if not names:
        return
    from retina_tpu_torch.plugins.dns import TOPIC_DNS_NAMES
    from retina_tpu_torch.pubsub import get_pubsub

    get_pubsub().publish(TOPIC_DNS_NAMES, dict(names))
