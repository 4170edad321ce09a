"""Fixed-width flow-event record schema (copy of retina_tpu/events/schema.py).

One event is NUM_FIELDS u32 lanes; a batch is a (B, NUM_FIELDS) array. In
the port a batch is an int32 tensor holding the u32 bit patterns.

==  =============  =====================================================
ix  name           meaning
==  =============  =====================================================
0   TS_LO          low 32 bits of nanosecond timestamp
1   TS_HI          high 32 bits of nanosecond timestamp
2   SRC_IP         IPv4 source, host byte order
3   DST_IP         IPv4 destination, host byte order
4   PORTS          src_port << 16 | dst_port
5   META           proto << 24 | tcp_flags << 16 | obs_point << 8
                   | direction << 4 | is_reply
6   BYTES          L3 length of the packet/flow-report
7   PACKETS        packet count (1 per packet, N for combined rows)
8   VERDICT        flow verdict (FORWARDED / DROPPED / ...)
9   DROP_REASON    drop reason id (valid when VERDICT == DROPPED)
10  TSVAL          TCP timestamp option TSval
11  TSECR          TCP timestamp option TSecr
12  DNS            qtype << 16 | rcode << 8 | dns_event_kind
13  DNS_QHASH      32-bit hash of the DNS query name
14  EVENT_TYPE     EV_* discriminator (forward/drop/dns/retrans/...)
15  IFINDEX        interface index the event was observed on
==  =============  =====================================================
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


class F:
    """Column indices of the event record."""

    TS_LO = 0
    TS_HI = 1
    SRC_IP = 2
    DST_IP = 3
    PORTS = 4
    META = 5
    BYTES = 6
    PACKETS = 7
    VERDICT = 8
    DROP_REASON = 9
    TSVAL = 10
    TSECR = 11
    DNS = 12
    DNS_QHASH = 13
    EVENT_TYPE = 14
    IFINDEX = 15


NUM_FIELDS = 16
RECORD_BYTES = NUM_FIELDS * 4

# Observation points.
OP_TO_STACK = 0
OP_TO_ENDPOINT = 1
OP_FROM_NETWORK = 2
OP_TO_NETWORK = 3

# Traffic direction.
DIR_UNKNOWN = 0
DIR_INGRESS = 1
DIR_EGRESS = 2

# Verdicts.
VERDICT_UNKNOWN = 0
VERDICT_FORWARDED = 1
VERDICT_DROPPED = 2

# Event types.
EV_FORWARD = 0
EV_DROP = 1
EV_DNS_REQ = 2
EV_DNS_RESP = 3
EV_TCP_RETRANS = 4

PROTO_TCP = 6
PROTO_UDP = 17

# TCP flag bits, standard wire order.
TCP_FIN = 1 << 0
TCP_SYN = 1 << 1
TCP_RST = 1 << 2
TCP_PSH = 1 << 3
TCP_ACK = 1 << 4
TCP_URG = 1 << 5
TCP_ECE = 1 << 6
TCP_CWR = 1 << 7


def ip_to_u32(ip: str) -> int:
    """u32 of a dotted-quad IPv4 address."""
    a, b, c, d = (int(x) for x in ip.split("."))
    return (a << 24) | (b << 16) | (c << 8) | d


def u32_to_ip(v: int) -> str:
    """Dotted quad of a u32 IPv4 address."""
    return f"{(v >> 24) & 0xFF}.{(v >> 16) & 0xFF}.{(v >> 8) & 0xFF}.{v & 0xFF}"

TCP_FLAG_NAMES = {
    TCP_FIN: "FIN",
    TCP_SYN: "SYN",
    TCP_RST: "RST",
    TCP_PSH: "PSH",
    TCP_ACK: "ACK",
    TCP_URG: "URG",
    TCP_ECE: "ECE",
    TCP_CWR: "CWR",
}


def pack_meta(
    proto: int,
    tcp_flags: int = 0,
    obs_point: int = OP_FROM_NETWORK,
    direction: int = DIR_UNKNOWN,
    is_reply: int = 0,
) -> int:
    return (
        ((proto & 0xFF) << 24)
        | ((tcp_flags & 0xFF) << 16)
        | ((obs_point & 0xFF) << 8)
        | ((direction & 0xF) << 4)
        | (is_reply & 0xF)
    )


def pack_ports(src_port: int, dst_port: int) -> int:
    return ((src_port & 0xFFFF) << 16) | (dst_port & 0xFFFF)


def obs_point_to_direction(obs_point: int) -> int:
    """Observation point -> traffic direction (flow_utils.go:72-92)."""
    if obs_point in (OP_TO_STACK, OP_TO_NETWORK):
        return DIR_EGRESS
    if obs_point in (OP_TO_ENDPOINT, OP_FROM_NETWORK):
        return DIR_INGRESS
    return DIR_UNKNOWN


# ---------------------------------------------------------------------------
# Batches


@dataclasses.dataclass
class EventBatch:
    """A fixed-capacity batch of event records plus a validity count.

    ``records`` is always shaped (capacity, NUM_FIELDS) so every batch of a
    given capacity hits the same compiled executable; ``n_valid`` marks how
    many leading rows are real. Device kernels mask on an iota < n_valid
    comparison instead of slicing (dynamic shapes would force recompiles —
    the reference's analog constraint is its fixed 32-page perf buffers,
    packetparser types_linux.go:67-69).
    """

    records: np.ndarray  # (capacity, NUM_FIELDS) uint32
    n_valid: int

    def __post_init__(self) -> None:
        assert self.records.ndim == 2 and self.records.shape[1] == NUM_FIELDS
        assert self.records.dtype == np.uint32
        assert 0 <= self.n_valid <= self.records.shape[0]

    @property
    def capacity(self) -> int:
        return int(self.records.shape[0])

    @classmethod
    def empty(cls, capacity: int) -> "EventBatch":
        return cls(np.zeros((capacity, NUM_FIELDS), np.uint32), 0)

    def valid_rows(self) -> np.ndarray:
        return self.records[: self.n_valid]


class EventBuilder:
    """Host-side builder producing EventBatches from per-event calls.

    This sits where the reference's perf-ring decode workers sit
    (packetparser_linux.go:556-652): per-event ingestion on the host,
    emitting dense batches for the device.
    """

    def __init__(self, capacity: int):
        self._batch = EventBatch.empty(capacity)
        self._full: list[EventBatch] = []

    def add(
        self,
        *,
        ts_ns: int = 0,
        src_ip: int = 0,
        dst_ip: int = 0,
        src_port: int = 0,
        dst_port: int = 0,
        proto: int = PROTO_TCP,
        tcp_flags: int = 0,
        obs_point: int = OP_FROM_NETWORK,
        is_reply: int = 0,
        bytes_: int = 0,
        packets: int = 1,
        verdict: int = VERDICT_FORWARDED,
        drop_reason: int = 0,
        tsval: int = 0,
        tsecr: int = 0,
        dns: int = 0,
        dns_qhash: int = 0,
        event_type: int = EV_FORWARD,
        ifindex: int = 0,
    ) -> None:
        b = self._batch
        if b.n_valid == b.capacity:
            self._full.append(b)
            self._batch = b = EventBatch.empty(b.capacity)
        row = b.records[b.n_valid]
        row[F.TS_LO] = ts_ns & 0xFFFFFFFF
        row[F.TS_HI] = (ts_ns >> 32) & 0xFFFFFFFF
        row[F.SRC_IP] = src_ip
        row[F.DST_IP] = dst_ip
        row[F.PORTS] = pack_ports(src_port, dst_port)
        row[F.META] = pack_meta(
            proto, tcp_flags, obs_point, obs_point_to_direction(obs_point), is_reply
        )
        row[F.BYTES] = bytes_
        row[F.PACKETS] = packets
        row[F.VERDICT] = verdict
        row[F.DROP_REASON] = drop_reason
        row[F.TSVAL] = tsval
        row[F.TSECR] = tsecr
        row[F.DNS] = dns
        row[F.DNS_QHASH] = dns_qhash
        row[F.EVENT_TYPE] = event_type
        row[F.IFINDEX] = ifindex
        b.n_valid += 1

    def drain(self) -> Iterator[EventBatch]:
        """Yield all full batches plus the current partial one."""
        full, self._full = self._full, []
        yield from full
        if self._batch.n_valid:
            out, self._batch = self._batch, EventBatch.empty(self._batch.capacity)
            yield out
