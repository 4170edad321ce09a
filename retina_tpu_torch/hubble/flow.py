"""Record → flow decoding for export (port of retina_tpu/hubble/flow.py).

Reference analog: pkg/hubble/parser — layer34 (parser/layer34) decodes
L3/L4 + verdict/direction, seven (parser/seven) decorates DNS, and the
common decoder attaches identity from the ipcache (common/decoder.go).
Here the record already carries L3/L4; enrichment attaches pod metadata
from the cache by IP (``controllers/cache.py``), and DNS names resolve
through the host string table (the dns plugin's ``resolve``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from retina_tpu_torch.events.schema import (
    EV_DNS_REQ,
    EV_DNS_RESP,
    EV_TCP_RETRANS,
    F,
    TCP_FLAG_NAMES,
    u32_to_ip,
)

_VERDICTS = {0: "VERDICT_UNKNOWN", 1: "FORWARDED", 2: "DROPPED"}
_DIRECTIONS = {0: "TRAFFIC_DIRECTION_UNKNOWN", 1: "INGRESS", 2: "EGRESS"}
_PROTOS = {6: "TCP", 17: "UDP", 1: "ICMP"}
_EVENT_TYPES = {0: "flow", 1: "drop", 2: "dns_request", 3: "dns_response",
                4: "tcp_retransmit"}


def _endpoint_dict(ep: Any) -> dict[str, Any]:
    if ep is None:
        return {}
    return {
        "namespace": getattr(ep, "namespace", ""),
        "pod_name": getattr(ep, "name", ""),
        "labels": [f"{k}={v}" for k, v in getattr(ep, "labels", ())],
        "workloads": [getattr(ep, "workload", lambda: "")()],
    }


def record_to_flow(
    rec: np.ndarray,
    cache: Any = None,
    dns_resolver: Any = None,
) -> dict[str, Any]:
    """One (NUM_FIELDS,) record → a Hubble-flow-shaped dict."""
    meta = int(rec[F.META])
    proto = meta >> 24
    flags = (meta >> 16) & 0xFF
    src_ip = u32_to_ip(int(rec[F.SRC_IP]))
    dst_ip = u32_to_ip(int(rec[F.DST_IP]))
    ports = int(rec[F.PORTS])
    ev = int(rec[F.EVENT_TYPE])
    flow: dict[str, Any] = {
        "time_ns": (int(rec[F.TS_HI]) << 32) | int(rec[F.TS_LO]),
        "verdict": _VERDICTS.get(int(rec[F.VERDICT]), "VERDICT_UNKNOWN"),
        "ip": {"source": src_ip, "destination": dst_ip},
        "l4": {
            "protocol": _PROTOS.get(proto, str(proto)),
            "source_port": ports >> 16,
            "destination_port": ports & 0xFFFF,
        },
        "traffic_direction": _DIRECTIONS.get((meta >> 4) & 0xF,
                                             "TRAFFIC_DIRECTION_UNKNOWN"),
        "event_type": _EVENT_TYPES.get(ev, str(ev)),
        "is_reply": bool(meta & 0xF),
        "bytes": int(rec[F.BYTES]),
        "packets": int(rec[F.PACKETS]),
    }
    if proto == 6:
        flow["l4"]["flags"] = [
            name for bit, name in TCP_FLAG_NAMES.items() if flags & bit
        ]
    if int(rec[F.VERDICT]) == 2:
        flow["drop_reason"] = int(rec[F.DROP_REASON])
    if ev in (EV_DNS_REQ, EV_DNS_RESP):
        dns_col = int(rec[F.DNS])
        q: dict[str, Any] = {
            "qtype": dns_col >> 16,
            "rcode": (dns_col >> 8) & 0xFF,
        }
        if dns_resolver is not None:
            q["query"] = dns_resolver(int(rec[F.DNS_QHASH]))
        flow["l7_dns"] = q
    if ev == EV_TCP_RETRANS:
        flow["tcp_retransmit"] = True
    if cache is not None:
        flow["source"] = _endpoint_dict(cache.get_obj_by_ip(src_ip))
        flow["destination"] = _endpoint_dict(cache.get_obj_by_ip(dst_ip))
    return flow


class FlowFilter:
    """Subset of Hubble's FlowFilter: pod/namespace/verdict/protocol/
    port/ip/event_type allow-matching (any-of within a field, all-of
    across fields). ``ip`` is an EXACT match against either endpoint —
    unlike the gRPC path (proto.py _one_filter_matches), whose
    source_ip/destination_ip are independent prefix matches.
    ``event_type`` matches the flow's event_type name (flow, drop,
    dns_request, dns_response, tcp_retransmit — the `hubble observe
    --type` analog). ``since_ns``/``until_ns`` bound the flow's
    timestamp (the GetFlowsRequest since/until analog; unstamped flows
    carry time_ns 0 and fall outside any since bound)."""

    def __init__(
        self,
        pod: Optional[str] = None,
        namespace: Optional[str] = None,
        verdict: Optional[str] = None,
        protocol: Optional[str] = None,
        port: Optional[int] = None,
        ip: Optional[str] = None,
        event_type: Optional[str] = None,
        since_ns: Optional[int] = None,
        until_ns: Optional[int] = None,
    ):
        self.pod = pod
        self.namespace = namespace
        self.verdict = verdict
        self.protocol = protocol
        self.port = port
        self.ip = ip
        self.event_type = event_type
        self.since_ns = since_ns
        self.until_ns = until_ns

    def to_dict(self) -> dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if v is not None}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FlowFilter":
        return cls(**{
            k: d.get(k) for k in
            ("pod", "namespace", "verdict", "protocol", "port", "ip",
             "event_type", "since_ns", "until_ns")
        })

    def matches(self, flow: dict[str, Any]) -> bool:
        if self.verdict and flow.get("verdict") != self.verdict:
            return False
        if self.protocol and flow.get("l4", {}).get("protocol") != self.protocol:
            return False
        if self.port is not None:
            l4 = flow.get("l4", {})
            if self.port not in (l4.get("source_port"),
                                 l4.get("destination_port")):
                return False
        if self.pod:
            names = {flow.get("source", {}).get("pod_name"),
                     flow.get("destination", {}).get("pod_name")}
            if self.pod not in names:
                return False
        if self.namespace:
            nss = {flow.get("source", {}).get("namespace"),
                   flow.get("destination", {}).get("namespace")}
            if self.namespace not in nss:
                return False
        if self.ip:
            ips = flow.get("ip", {})
            if self.ip not in (ips.get("source"), ips.get("destination")):
                return False
        if self.event_type and flow.get("event_type") != self.event_type:
            return False
        if self.since_ns is not None or self.until_ns is not None:
            t = int(flow.get("time_ns", 0))
            if self.since_ns is not None and t < self.since_ns:
                return False
            if self.until_ns is not None and t > self.until_ns:
                return False
        return True
