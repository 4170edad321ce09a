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
