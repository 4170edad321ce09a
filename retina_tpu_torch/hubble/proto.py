"""Cilium Hubble wire-compatible protobuf messages, built at runtime (port
of retina_tpu/hubble/proto.py).

Reference analog: pkg/hubble serves the Cilium Observer API — protobuf
messages from cilium's api/v1/{flow/flow.proto, observer/observer.proto,
peer/peer.proto} over gRPC (hubble_linux.go:52-99). This image has no
protoc and no cilium python package, but it does have google.protobuf, so
the descriptors are hand-rolled here as FileDescriptorProtos with the
SAME package/message/field names and FIELD NUMBERS as upstream (the
subset Retina populates — cilium/cilium api/v1/flow/flow.proto field
numbering: time=1, verdict=2, IP=5, l4=6, source=8, destination=9,
Type=10, node_name=11, l7=15, event_type=19, traffic_direction=24,
is_reply=28, uuid=34). A stock Hubble client (hubble CLI / relay) speaks
this wire format: method names `/observer.Observer/GetFlows`,
`/observer.Observer/ServerStatus`, `/peer.Peer/Notify`.

Unknown-to-us upstream fields are simply absent (proto3 semantics make
them defaults); fields we emit decode correctly on any conforming client.

The descriptors are the reference's, field for field. They are built at the
first use of a message class (a module attribute such as ``Flow`` or
``GetFlowsRequest``, or a function below that makes one), never at import:
``google.protobuf`` is imported then, so the port's modules import without
it, and a server without it fails when it is built (``HubbleServer``
registers these handlers in its constructor).
"""

from __future__ import annotations

import functools
from typing import Any

_MESSAGES = {
    "Flow": "flow.Flow",
    "FlowFilterPB": "flow.FlowFilter",
    "LostEvent": "flow.LostEvent",
    "GetFlowsRequest": "observer.GetFlowsRequest",
    "GetFlowsResponse": "observer.GetFlowsResponse",
    "ServerStatusRequest": "observer.ServerStatusRequest",
    "ServerStatusResponse": "observer.ServerStatusResponse",
    "NotifyRequest": "peer.NotifyRequest",
    "ChangeNotification": "peer.ChangeNotification",
}


@functools.cache
def _classes() -> dict[str, Any]:
    """Build the private descriptor pool and its message classes (once)."""
    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory
    from google.protobuf import timestamp_pb2, wrappers_pb2

    _pool = descriptor_pool.DescriptorPool()
    # google well-known types must exist in our private pool.
    for wkt in (timestamp_pb2, wrappers_pb2):
        fdp = descriptor_pb2.FileDescriptorProto()
        wkt.DESCRIPTOR.CopyToProto(fdp)
        _pool.Add(fdp)

    _T = descriptor_pb2.FieldDescriptorProto

    def _field(name: str, number: int, ftype: int, label: int = 1,
               type_name: str = "", oneof_index: int | None = None):
        f = _T(name=name, number=number, type=ftype, label=label)
        if type_name:
            f.type_name = type_name
        if oneof_index is not None:
            f.oneof_index = oneof_index
        return f

    def _msg(name: str, fields: list, oneofs: list[str] | None = None):
        m = descriptor_pb2.DescriptorProto(name=name)
        m.field.extend(fields)
        for o in oneofs or []:
            m.oneof_decl.add(name=o)
        return m

    def _enum(name: str, values: dict[str, int]):
        e = descriptor_pb2.EnumDescriptorProto(name=name)
        for vname, vnum in values.items():
            e.value.add(name=vname, number=vnum)
        return e

    _TS = ".google.protobuf.Timestamp"
    _BOOLV = ".google.protobuf.BoolValue"

    # ---------------------------------------------------------------------
    # flow.proto (package flow) — upstream cilium/api/v1/flow/flow.proto
    # ---------------------------------------------------------------------
    _flow_fdp = descriptor_pb2.FileDescriptorProto(
        name="flow/flow.proto",
        package="flow",
        syntax="proto3",
        dependency=["google/protobuf/timestamp.proto",
                    "google/protobuf/wrappers.proto"],
    )
    _flow_fdp.enum_type.extend([
        _enum("FlowType", {"UNKNOWN_TYPE": 0, "L3_L4": 1, "L7": 2, "SOCK": 3}),
        _enum("Verdict", {
            "VERDICT_UNKNOWN": 0, "FORWARDED": 1, "DROPPED": 2, "ERROR": 3,
            "AUDIT": 4, "REDIRECTED": 5, "TRACED": 6, "TRANSLATED": 7,
        }),
        _enum("TrafficDirection", {
            "TRAFFIC_DIRECTION_UNKNOWN": 0, "INGRESS": 1, "EGRESS": 2,
        }),
        _enum("IPVersion", {"IP_NOT_USED": 0, "IPv4": 1, "IPv6": 2}),
        _enum("L7FlowType", {
            "UNKNOWN_L7_TYPE": 0, "REQUEST": 1, "RESPONSE": 2, "SAMPLE": 3,
        }),
    ])
    _flow_fdp.message_type.extend([
        _msg("IP", [
            _field("source", 1, _T.TYPE_STRING),
            _field("destination", 2, _T.TYPE_STRING),
            _field("ipVersion", 3, _T.TYPE_ENUM, type_name=".flow.IPVersion"),
        ]),
        _msg("TCPFlags", [
            _field(n, i + 1, _T.TYPE_BOOL) for i, n in enumerate(
                ["FIN", "SYN", "RST", "PSH", "ACK", "URG", "ECE", "CWR", "NS"]
            )
        ]),
        _msg("TCP", [
            _field("source_port", 1, _T.TYPE_UINT32),
            _field("destination_port", 2, _T.TYPE_UINT32),
            _field("flags", 3, _T.TYPE_MESSAGE, type_name=".flow.TCPFlags"),
        ]),
        _msg("UDP", [
            _field("source_port", 1, _T.TYPE_UINT32),
            _field("destination_port", 2, _T.TYPE_UINT32),
        ]),
        _msg("ICMPv4", [
            _field("type", 1, _T.TYPE_UINT32),
            _field("code", 2, _T.TYPE_UINT32),
        ]),
        _msg("Layer4", [
            _field("TCP", 1, _T.TYPE_MESSAGE, type_name=".flow.TCP",
                   oneof_index=0),
            _field("UDP", 2, _T.TYPE_MESSAGE, type_name=".flow.UDP",
                   oneof_index=0),
            _field("ICMPv4", 3, _T.TYPE_MESSAGE, type_name=".flow.ICMPv4",
                   oneof_index=0),
        ], oneofs=["protocol"]),
        _msg("Workload", [
            _field("name", 1, _T.TYPE_STRING),
            _field("kind", 2, _T.TYPE_STRING),
        ]),
        _msg("Endpoint", [
            _field("ID", 1, _T.TYPE_UINT32),
            _field("identity", 2, _T.TYPE_UINT32),
            _field("namespace", 3, _T.TYPE_STRING),
            _field("labels", 4, _T.TYPE_STRING, label=3),
            _field("pod_name", 5, _T.TYPE_STRING),
            _field("workloads", 6, _T.TYPE_MESSAGE, label=3,
                   type_name=".flow.Workload"),
            _field("cluster_name", 7, _T.TYPE_STRING),
        ]),
        _msg("DNS", [
            _field("query", 1, _T.TYPE_STRING),
            _field("ips", 2, _T.TYPE_STRING, label=3),
            _field("ttl", 3, _T.TYPE_UINT32),
            _field("cnames", 4, _T.TYPE_STRING, label=3),
            _field("observation_source", 5, _T.TYPE_STRING),
            _field("rcode", 6, _T.TYPE_UINT32),
            _field("qtypes", 7, _T.TYPE_STRING, label=3),
            _field("rrtypes", 8, _T.TYPE_STRING, label=3),
        ]),
        _msg("Layer7", [
            _field("type", 1, _T.TYPE_ENUM, type_name=".flow.L7FlowType"),
            _field("latency_ns", 2, _T.TYPE_UINT64),
            _field("dns", 100, _T.TYPE_MESSAGE, type_name=".flow.DNS",
                   oneof_index=0),
        ], oneofs=["record"]),
        _msg("CiliumEventType", [
            _field("type", 1, _T.TYPE_INT32),
            _field("sub_type", 2, _T.TYPE_INT32),
        ]),
        _msg("Flow", [
            _field("time", 1, _T.TYPE_MESSAGE, type_name=_TS),
            _field("verdict", 2, _T.TYPE_ENUM, type_name=".flow.Verdict"),
            _field("drop_reason", 3, _T.TYPE_UINT32),
            _field("IP", 5, _T.TYPE_MESSAGE, type_name=".flow.IP"),
            _field("l4", 6, _T.TYPE_MESSAGE, type_name=".flow.Layer4"),
            _field("source", 8, _T.TYPE_MESSAGE, type_name=".flow.Endpoint"),
            _field("destination", 9, _T.TYPE_MESSAGE,
                   type_name=".flow.Endpoint"),
            _field("Type", 10, _T.TYPE_ENUM, type_name=".flow.FlowType"),
            _field("node_name", 11, _T.TYPE_STRING),
            _field("source_names", 13, _T.TYPE_STRING, label=3),
            _field("destination_names", 14, _T.TYPE_STRING, label=3),
            _field("l7", 15, _T.TYPE_MESSAGE, type_name=".flow.Layer7"),
            _field("reply", 16, _T.TYPE_BOOL),
            _field("event_type", 19, _T.TYPE_MESSAGE,
                   type_name=".flow.CiliumEventType"),
            _field("traffic_direction", 24, _T.TYPE_ENUM,
                   type_name=".flow.TrafficDirection"),
            _field("drop_reason_desc", 27, _T.TYPE_UINT32),
            _field("is_reply", 28, _T.TYPE_MESSAGE, type_name=_BOOLV),
            _field("uuid", 34, _T.TYPE_STRING),
            _field("Summary", 100000, _T.TYPE_STRING),
        ]),
        _msg("FlowFilter", [
            _field("uuid", 29, _T.TYPE_STRING, label=3),
            _field("source_ip", 1, _T.TYPE_STRING, label=3),
            _field("source_pod", 2, _T.TYPE_STRING, label=3),
            _field("destination_ip", 5, _T.TYPE_STRING, label=3),
            _field("destination_pod", 6, _T.TYPE_STRING, label=3),
            _field("verdict", 9, _T.TYPE_ENUM, label=3,
                   type_name=".flow.Verdict"),
            _field("source_port", 11, _T.TYPE_STRING, label=3),
            _field("destination_port", 12, _T.TYPE_STRING, label=3),
            _field("protocol", 15, _T.TYPE_STRING, label=3),
        ]),
        _msg("LostEvent", [
            _field("source", 1, _T.TYPE_ENUM,
                   type_name=".flow.LostEventSource"),
            _field("num_events_lost", 2, _T.TYPE_UINT64),
        ]),
    ])
    _flow_fdp.enum_type.add(name="LostEventSource").value.add(
        name="UNKNOWN_LOST_EVENT_SOURCE", number=0)
    _flow_fdp.enum_type[-1].value.add(name="PERF_EVENT_RING_BUFFER", number=1)
    _flow_fdp.enum_type[-1].value.add(name="OBSERVER_EVENTS_QUEUE", number=2)
    _flow_fdp.enum_type[-1].value.add(name="HUBBLE_RING_BUFFER", number=3)
    _pool.Add(_flow_fdp)

    # ---------------------------------------------------------------------
    # observer.proto (package observer)
    # ---------------------------------------------------------------------
    _obs_fdp = descriptor_pb2.FileDescriptorProto(
        name="observer/observer.proto",
        package="observer",
        syntax="proto3",
        dependency=["flow/flow.proto", "google/protobuf/timestamp.proto"],
    )
    _obs_fdp.message_type.extend([
        _msg("GetFlowsRequest", [
            _field("number", 1, _T.TYPE_UINT64),
            _field("whitelist", 2, _T.TYPE_MESSAGE, label=3,
                   type_name=".flow.FlowFilter"),
            _field("blacklist", 3, _T.TYPE_MESSAGE, label=3,
                   type_name=".flow.FlowFilter"),
            _field("follow", 4, _T.TYPE_BOOL),
            _field("since", 7, _T.TYPE_MESSAGE, type_name=_TS),
            _field("until", 8, _T.TYPE_MESSAGE, type_name=_TS),
            _field("first", 9, _T.TYPE_BOOL),
        ]),
        _msg("GetFlowsResponse", [
            _field("flow", 1, _T.TYPE_MESSAGE, type_name=".flow.Flow",
                   oneof_index=0),
            _field("lost_events", 3, _T.TYPE_MESSAGE,
                   type_name=".flow.LostEvent", oneof_index=0),
            _field("node_name", 1000, _T.TYPE_STRING),
            _field("time", 1001, _T.TYPE_MESSAGE, type_name=_TS),
        ], oneofs=["response_types"]),
        _msg("ServerStatusRequest", []),
        _msg("ServerStatusResponse", [
            _field("num_flows", 1, _T.TYPE_UINT64),
            _field("max_flows", 2, _T.TYPE_UINT64),
            _field("seen_flows", 3, _T.TYPE_UINT64),
            _field("uptime_ns", 4, _T.TYPE_UINT64),
            _field("version", 7, _T.TYPE_STRING),
            _field("flows_rate", 8, _T.TYPE_DOUBLE),
        ]),
    ])
    _obs_fdp.service.add(name="Observer").method.add(
        name="GetFlows",
        input_type=".observer.GetFlowsRequest",
        output_type=".observer.GetFlowsResponse",
        server_streaming=True,
    )
    _obs_fdp.service[0].method.add(
        name="ServerStatus",
        input_type=".observer.ServerStatusRequest",
        output_type=".observer.ServerStatusResponse",
    )
    _pool.Add(_obs_fdp)

    # ---------------------------------------------------------------------
    # peer.proto (package peer)
    # ---------------------------------------------------------------------
    _peer_fdp = descriptor_pb2.FileDescriptorProto(
        name="peer/peer.proto", package="peer", syntax="proto3",
    )
    _peer_fdp.enum_type.append(_enum("ChangeNotificationType", {
        "UNKNOWN": 0, "PEER_ADDED": 1, "PEER_DELETED": 2, "PEER_UPDATED": 3,
    }))
    _peer_fdp.message_type.extend([
        _msg("NotifyRequest", []),
        _msg("TLS", [
            _field("enabled", 1, _T.TYPE_BOOL),
            _field("server_name", 2, _T.TYPE_STRING),
        ]),
        _msg("ChangeNotification", [
            _field("name", 1, _T.TYPE_STRING),
            _field("address", 2, _T.TYPE_STRING),
            _field("type", 3, _T.TYPE_ENUM,
                   type_name=".peer.ChangeNotificationType"),
            _field("tls", 4, _T.TYPE_MESSAGE, type_name=".peer.TLS"),
        ]),
    ])
    _peer_fdp.service.add(name="Peer").method.add(
        name="Notify",
        input_type=".peer.NotifyRequest",
        output_type=".peer.ChangeNotification",
        server_streaming=True,
    )
    _pool.Add(_peer_fdp)

    return {
        name: message_factory.GetMessageClass(_pool.FindMessageTypeByName(full))
        for name, full in _MESSAGES.items()
    }


def __getattr__(name: str) -> Any:
    if name in _MESSAGES:
        return _classes()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


OBSERVER_SERVICE_PB = "observer.Observer"
PEER_SERVICE_PB = "peer.Peer"

_VERDICT_NUM = {"VERDICT_UNKNOWN": 0, "FORWARDED": 1, "DROPPED": 2}
_DIR_NUM = {"TRAFFIC_DIRECTION_UNKNOWN": 0, "INGRESS": 1, "EGRESS": 2}
# CiliumEventType.type numbering follows the monitor message types the
# reference stamps (pkg/utils/flow_utils.go:102-104 trace, :292-295
# drop with sub_type = drop reason, :193-195 access-log for L7/DNS;
# numeric values per cilium pkg/monitor/api/types.go iota order, see
# sources/cilium_monitor.py). tcp_retransmit has no Cilium analog: it
# rides trace with sub_type 1 — Cilium's trace sub_types are
# observation points, which this wire does not otherwise carry, so the
# slot is free (documented divergence).
_ET_DROP, _ET_TRACE, _ET_L7 = 1, 4, 5
_ET_SUB_RETRANS = 1
_EVENT_TYPE_NUM = {"flow": _ET_TRACE, "drop": _ET_DROP,
                   "dns_request": _ET_L7, "dns_response": _ET_L7,
                   "tcp_retransmit": _ET_TRACE}
# DNS record-type names (upstream clients filter/group on these, not on
# numeric qtypes).
_QTYPE_NAMES = {1: "A", 2: "NS", 5: "CNAME", 6: "SOA", 12: "PTR",
                15: "MX", 16: "TXT", 28: "AAAA", 33: "SRV", 255: "ANY"}


def flow_dict_to_proto(f: dict[str, Any], node_name: str = "") -> Any:
    """Internal flow dict (hubble/flow.py record_to_flow) → flow.Flow."""
    msg = _classes()["Flow"]()
    t = int(f.get("time_ns", 0))
    msg.time.seconds = t // 1_000_000_000
    msg.time.nanos = t % 1_000_000_000
    msg.verdict = _VERDICT_NUM.get(f.get("verdict", ""), 0)
    msg.traffic_direction = _DIR_NUM.get(f.get("traffic_direction", ""), 0)
    ip = f.get("ip", {})
    msg.IP.source = ip.get("source", "")
    msg.IP.destination = ip.get("destination", "")
    msg.IP.ipVersion = 1
    l4 = f.get("l4", {})
    proto = l4.get("protocol", "")
    if proto == "TCP":
        msg.l4.TCP.source_port = int(l4.get("source_port", 0))
        msg.l4.TCP.destination_port = int(l4.get("destination_port", 0))
        for name in l4.get("flags", []):
            if name in ("FIN", "SYN", "RST", "PSH", "ACK", "URG", "ECE",
                        "CWR"):
                setattr(msg.l4.TCP.flags, name, True)
    elif proto == "UDP":
        msg.l4.UDP.source_port = int(l4.get("source_port", 0))
        msg.l4.UDP.destination_port = int(l4.get("destination_port", 0))
    msg.Type = 1  # L3_L4
    # Relay-ingested flows carry their ORIGIN node; only flows born on
    # this node get stamped with the local name.
    msg.node_name = f.get("node_name") or node_name
    if f.get("drop_reason") is not None:
        msg.drop_reason = int(f["drop_reason"])
        msg.drop_reason_desc = int(f["drop_reason"])
    for side, field in (("source", msg.source), ("destination",
                                                 msg.destination)):
        ep = f.get(side) or {}
        field.namespace = ep.get("namespace", "")
        field.pod_name = ep.get("pod_name", "")
        for lbl in ep.get("labels", []):
            field.labels.append(lbl)
        for w in ep.get("workloads", []):
            if w:
                field.workloads.add(name=w)
    dns = f.get("l7_dns")
    if dns is not None:
        msg.l7.type = 1 if f.get("event_type") == "dns_request" else 2
        if dns.get("query"):
            msg.l7.dns.query = str(dns["query"])
        msg.l7.dns.rcode = int(dns.get("rcode", 0))
        qt = dns.get("qtype")
        if qt is not None:
            # Numeric qtype from the decoder; already-named qtype when a
            # relay round-trips a flow it ingested from a peer.
            if isinstance(qt, int) or str(qt).isdigit():
                msg.l7.dns.qtypes.append(_QTYPE_NAMES.get(int(qt), str(qt)))
            else:
                msg.l7.dns.qtypes.append(str(qt))
    et = f.get("event_type", "flow")
    msg.event_type.type = _EVENT_TYPE_NUM.get(et, _ET_TRACE)
    if et == "drop":
        msg.event_type.sub_type = int(f.get("drop_reason") or 0)
    elif et == "tcp_retransmit":
        msg.event_type.sub_type = _ET_SUB_RETRANS
    msg.is_reply.value = bool(f.get("is_reply", False))
    msg.reply = bool(f.get("is_reply", False))
    return msg


_VERDICT_NAME = {v: k for k, v in _VERDICT_NUM.items()}
_DIR_NAME = {v: k for k, v in _DIR_NUM.items()}


def flow_proto_to_dict(msg: Any) -> dict[str, Any]:
    """flow.Flow → internal flow dict (inverse of flow_dict_to_proto);
    the relay stores peer flows in its local FlowObserver ring this way.
    """
    f: dict[str, Any] = {
        "time_ns": msg.time.seconds * 1_000_000_000 + msg.time.nanos,
        "verdict": _VERDICT_NAME.get(msg.verdict, "VERDICT_UNKNOWN"),
        "traffic_direction": _DIR_NAME.get(
            msg.traffic_direction, "TRAFFIC_DIRECTION_UNKNOWN"
        ),
        "ip": {"source": msg.IP.source, "destination": msg.IP.destination},
        "node_name": msg.node_name,
        "is_reply": msg.is_reply.value,
    }
    which = msg.l4.WhichOneof("protocol")
    if which:
        l4msg = getattr(msg.l4, which)
        l4: dict[str, Any] = {
            "protocol": which,
            "source_port": l4msg.source_port,
            "destination_port": l4msg.destination_port,
        }
        if which == "TCP":
            l4["flags"] = [
                n for n in ("FIN", "SYN", "RST", "PSH", "ACK", "URG",
                            "ECE", "CWR")
                if getattr(l4msg.flags, n)
            ]
        f["l4"] = l4
    if msg.verdict == 2:
        f["drop_reason"] = msg.drop_reason
    for side, field in (("source", msg.source),
                        ("destination", msg.destination)):
        if field.pod_name or field.namespace:
            f[side] = {
                "namespace": field.namespace,
                "pod_name": field.pod_name,
                "labels": list(field.labels),
                "workloads": [w.name for w in field.workloads],
            }
    if msg.l7.WhichOneof("record") == "dns":
        f["l7_dns"] = {
            "query": msg.l7.dns.query,
            "rcode": msg.l7.dns.rcode,
            "qtype": list(msg.l7.dns.qtypes)[0] if msg.l7.dns.qtypes else None,
        }
        f["event_type"] = ("dns_request" if msg.l7.type == 1
                           else "dns_response")
    elif msg.event_type.type == _ET_DROP:
        f["event_type"] = "drop"
    elif (msg.event_type.type == _ET_TRACE
          and msg.event_type.sub_type == _ET_SUB_RETRANS):
        f["event_type"] = "tcp_retransmit"
        f["tcp_retransmit"] = True
    else:
        f["event_type"] = "flow"
    return f


def proto_filter_matches(filters: list, flow_msg: Any) -> bool:
    """Hubble whitelist semantics: ANY filter matches; within a filter,
    every populated field must match (any-of across repeated values)."""
    if not filters:
        return True
    for flt in filters:
        if _one_filter_matches(flt, flow_msg):
            return True
    return False


def _one_filter_matches(flt: Any, m: Any) -> bool:
    def any_prefix(vals, actual):
        return not vals or any(actual.startswith(v) for v in vals)

    if not any_prefix(list(flt.source_ip), m.IP.source):
        return False
    if not any_prefix(list(flt.destination_ip), m.IP.destination):
        return False
    if not any_prefix(list(flt.source_pod),
                      f"{m.source.namespace}/{m.source.pod_name}"):
        return False
    if not any_prefix(list(flt.destination_pod),
                      f"{m.destination.namespace}/{m.destination.pod_name}"):
        return False
    if list(flt.verdict) and m.verdict not in list(flt.verdict):
        return False
    which = m.l4.WhichOneof("protocol") or ""
    if list(flt.protocol) and which.lower() not in [
        p.lower() for p in flt.protocol
    ]:
        return False
    if list(flt.source_port) or list(flt.destination_port):
        l4 = getattr(m.l4, which) if which else None
        sp = str(getattr(l4, "source_port", "")) if l4 else ""
        dp = str(getattr(l4, "destination_port", "")) if l4 else ""
        if list(flt.source_port) and sp not in list(flt.source_port):
            return False
        if list(flt.destination_port) and dp not in list(flt.destination_port):
            return False
    return True
