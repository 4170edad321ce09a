"""Hubble gRPC flow relay: Observer, Peer and Fleet services (port of
retina_tpu/hubble/server.py).

Reference analog: pkg/hubble/hubble_linux.go:52-99 — the Retina-flavored
Hubble server exposing the flow gRPC API on :4244 (relay), a peer service
for node discovery, TLS options, and hubble_* self metrics on :9965.

TWO wire surfaces share the port:
- **Cilium-compatible protobuf** (hubble/proto.py): services
  ``observer.Observer`` (GetFlows streaming, ServerStatus) and
  ``peer.Peer`` (Notify streaming) with upstream message/field numbering
  — a stock Hubble relay/CLI client speaks this.
- **legacy msgpack** (service ``retina.Observer``/``retina.Peer``) kept
  for the in-tree lightweight client below.

TLS: pass ``tls_cert``/``tls_key`` (PEM paths) to serve with
``grpc.ssl_server_credentials`` (+ optional ``tls_client_ca`` for mTLS) —
the reference's hubble TLS options.

``grpc`` is imported when a server or a client is built, never at module
import (an agent without the Hubble plane needs no gRPC), and the msgpack
frames are the port's own MessagePack subset (``utils/_msgpack.py``), byte
for byte the reference's ``msgpack.packb(..., use_bin_type=True)``.

Self-metrics: ``hubble_flows_processed_total``, ``hubble_seen_flows``,
``hubble_lost_events_total``, ``hubble_get_flows_requests_total`` in the
default registry; the daemon additionally serves a dedicated metrics mux
(:9965 analog) when ``hubble_metrics_addr`` is configured.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent import futures
from typing import Any, Callable, Iterator, Optional

from retina_tpu_torch.hubble.flow import FlowFilter
from retina_tpu_torch.hubble.observer import FlowObserver
from retina_tpu_torch.log import logger
from retina_tpu_torch.utils import _msgpack

_pack = _msgpack.packb


def _unpack(raw: bytes) -> Any:
    return _msgpack.unpackb(raw, strict_map_key=False)


OBSERVER_SERVICE = "retina.Observer"
PEER_SERVICE = "retina.Peer"
# Fleet rollup tier (fleet/): nodes Ship encoded sketch snapshots to the
# aggregator through the relay endpoint instead of raw samples. Raw-bytes
# unary RPC — the RFLT frame (fleet/codec.py) is the wire format, so the
# relay never unpacks the arrays.
FLEET_SERVICE = "retina.Fleet"


class HubbleServer:
    def __init__(
        self,
        observer: FlowObserver,
        addr: str = "127.0.0.1:4244",
        peers: Optional[list[dict[str, str]]] = None,
        max_workers: int = 8,
        node_name: str = "",
        tls_cert: str = "",
        tls_key: str = "",
        tls_client_ca: str = "",
        unix_socket: str = "",
        fleet_ingest: Optional[Callable[[bytes], bool]] = None,
    ):
        import grpc

        self._log = logger("hubble")
        self.observer = observer
        self.addr = addr
        self.unix_socket = unix_socket
        # ``peers`` may be a static list or a zero-arg callable returning
        # the CURRENT peer set (daemon wires the node store in, so peer
        # listings track cluster membership instead of boot-time config).
        self.peers = peers if peers is not None else []
        self.node_name = node_name
        # Operator wiring: FleetAggregator.ingest when this relay fronts
        # the aggregator; None on plain per-node relays (Ship → error).
        self.fleet_ingest = fleet_ingest
        self._t0 = time.time_ns()
        self._stop = threading.Event()
        self._init_self_metrics()
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self._server.add_generic_rpc_handlers(
            [self._make_handlers(), self._make_pb_handlers()]
        )
        if tls_cert and tls_key:
            with open(tls_key, "rb") as f:
                key = f.read()
            with open(tls_cert, "rb") as f:
                cert = f.read()
            root = None
            require_client = False
            if tls_client_ca:
                with open(tls_client_ca, "rb") as f:
                    root = f.read()
                require_client = True
            creds = grpc.ssl_server_credentials(
                [(key, cert)], root_certificates=root,
                require_client_auth=require_client,
            )
            self.port = self._server.add_secure_port(addr, creds)
            self.tls = True
        else:
            self.port = self._server.add_insecure_port(addr)
            self.tls = False
        if unix_socket:
            # Local-client endpoint beside TCP, like Hubble's
            # unix:///var/run/cilium/hubble.sock (SURVEY §3.5; the
            # reference daemon serves both). Always insecure: the socket
            # is permission-guarded by the filesystem, and local CLIs
            # (hubble observe) dial it without TLS.
            import os

            try:
                os.unlink(unix_socket)
            except OSError:  # noqa: RT101 — stale socket may not exist
                pass
            self._server.add_insecure_port(f"unix:{unix_socket}")

    def _init_self_metrics(self) -> None:
        """hubble_* families in the DEDICATED hubble registry (served by
        the :9965-analog mux, not the combined gatherer). Created once per
        exporter and cached on it: re-constructing the server (agent
        restart in-process, sequential e2e boots) must not raise
        Duplicated timeseries."""
        from retina_tpu_torch.exporter import get_exporter

        exp = get_exporter()
        fams = getattr(exp, "_hubble_families", None)
        if fams is None:
            fams = {
                "seen": exp.new_hubble_gauge(
                    "hubble_seen_flows", [],
                    "flows ever written to the ring",
                ),
                "lost": exp.new_hubble_gauge(
                    "hubble_lost_events_total", ["source"],
                    "ring entries skipped by lagging readers "
                    "(summed across readers)",
                ),
                "requests": exp.new_hubble_counter(
                    "hubble_get_flows_requests_total", ["surface"],
                    "GetFlows calls served",
                ),
                "served": exp.new_hubble_counter(
                    "hubble_flows_processed_total",
                    ["type", "subtype", "verdict"],
                    "flows served to clients",
                ),
            }
            exp._hubble_families = fams
        self.m_seen = fams["seen"]
        self.m_lost = fams["lost"]
        self.m_requests = fams["requests"]
        self.m_served = fams["served"]
        # Scrape-time evaluation: gauges read the live observer, so the
        # mux reports fresh values without any RPC having to run first.
        self.m_seen.set_function(lambda: self.observer.flows_seen)
        self.m_lost.labels(source="HUBBLE_RING_BUFFER").set_function(
            lambda: self.observer.lost_observed
        )

    # -- service implementation ---------------------------------------
    def _get_flows(self, request: bytes, ctx) -> Iterator[bytes]:
        self.m_requests.labels(surface="msgpack").inc()
        req = _unpack(request) if request else {}
        filt = (
            FlowFilter.from_dict(req["filter"]) if req.get("filter") else None
        )
        stop = threading.Event()
        ctx.add_callback(stop.set)

        def gen():
            for flow in self.observer.get_flows(
                filter=filt,
                last=int(req.get("last", 0)),
                follow=bool(req.get("follow", False)),
                stop=stop,
                lost_markers=bool(req.get("lost_markers", False)),
            ):
                if stop.is_set():
                    return
                yield _pack(flow)

        return gen()

    def _server_status(self, request: bytes, ctx) -> bytes:
        return _pack(
            {
                "num_flows": min(self.observer.flows_seen,
                                 self.observer._cap),
                "max_flows": self.observer._cap,
                "seen_flows": self.observer.flows_seen,
                "uptime_ns": time.time_ns() - self._t0,
            }
        )

    def _peer_list(self) -> list[dict[str, str]]:
        return list(self.peers()) if callable(self.peers) else list(self.peers)

    def _list_peers(self, request: bytes, ctx) -> bytes:
        return _pack({"peers": self._peer_list()})

    def _fleet_ship(self, request: bytes, ctx) -> bytes:  # hot-path: transport
        """Unary Ship: one RFLT frame in, {"ok": bool} out. Accepted
        means decoded + buffered (or merged); a False ok surfaces drop
        reasons the node side can count without parsing relay logs."""
        if self.fleet_ingest is None:
            return _pack({"ok": False, "error": "no aggregator here"})
        try:
            return _pack({"ok": bool(self.fleet_ingest(request))})
        except Exception as e:  # noqa: BLE001 — relay must answer
            self._log.exception("fleet ingest failed")
            return _pack({"ok": False, "error": repr(e)})

    def _make_handlers(self):
        import grpc

        bypass = lambda x: x  # noqa: E731 — already-packed bytes
        observer = grpc.method_handlers_generic_handler(
            OBSERVER_SERVICE,
            {
                "GetFlows": grpc.unary_stream_rpc_method_handler(
                    self._get_flows,
                    request_deserializer=bypass,
                    response_serializer=bypass,
                ),
                "ServerStatus": grpc.unary_unary_rpc_method_handler(
                    self._server_status,
                    request_deserializer=bypass,
                    response_serializer=bypass,
                ),
            },
        )
        peer = grpc.method_handlers_generic_handler(
            PEER_SERVICE,
            {
                "ListPeers": grpc.unary_unary_rpc_method_handler(
                    self._list_peers,
                    request_deserializer=bypass,
                    response_serializer=bypass,
                ),
            },
        )
        fleet = grpc.method_handlers_generic_handler(
            FLEET_SERVICE,
            {
                "Ship": grpc.unary_unary_rpc_method_handler(
                    self._fleet_ship,
                    request_deserializer=bypass,
                    response_serializer=bypass,
                ),
            },
        )

        class Multi(grpc.GenericRpcHandler):
            def service(self, details):
                return (
                    observer.service(details)
                    or peer.service(details)
                    or fleet.service(details)
                )

        return Multi()

    # -- Cilium-compatible protobuf surface ---------------------------
    def _pb_get_flows(self, request, ctx) -> Iterator[Any]:
        from retina_tpu_torch.hubble import proto as pb

        self.m_requests.labels(surface="protobuf").inc()
        stop = threading.Event()
        ctx.add_callback(stop.set)
        whitelist = list(request.whitelist)
        blacklist = list(request.blacklist)
        last = int(request.number)
        # GetFlowsRequest since/until (flows carry time_ns; an unset
        # Timestamp is all-zero, meaning unbounded).
        since_ns = (request.since.seconds * 1_000_000_000
                    + request.since.nanos) if request.HasField("since") else 0
        until_ns = (request.until.seconds * 1_000_000_000
                    + request.until.nanos) if request.HasField("until") else 0

        def in_window(flow) -> bool:
            t = int(flow.get("time_ns", 0))
            return not ((since_ns and t < since_ns)
                        or (until_ns and t > until_ns))

        def passes(msg) -> bool:
            if not pb.proto_filter_matches(whitelist, msg):
                return False
            if blacklist and pb.proto_filter_matches(blacklist, msg):
                return False
            return True

        def to_resp(flow, msg):
            self.m_served.labels(
                type="L3_L4",
                subtype=flow.get("event_type", "flow"),
                verdict=flow.get("verdict", "VERDICT_UNKNOWN"),
            ).inc()
            resp = pb.GetFlowsResponse()
            resp.flow.CopyFrom(msg)
            resp.node_name = self.node_name
            resp.time.CopyFrom(msg.time)
            return resp

        # Filter the buffered window FIRST, then apply last-N — upstream
        # Hubble returns the N most recent MATCHING flows, not matches
        # within the N most recent raw entries.
        buffered, cursor = self.observer.snapshot_flows()
        matching = []
        for flow in buffered:
            # Time bounds come first: they need no proto conversion.
            if not in_window(flow):
                continue
            msg = pb.flow_dict_to_proto(flow, node_name=self.node_name)
            if passes(msg):
                matching.append((flow, msg))
        if last:
            matching = matching[-last:]
        for flow, msg in matching:
            if stop.is_set():
                return
            yield to_resp(flow, msg)

        if not request.follow:
            return
        for kind, payload in self.observer.follow_from(cursor, stop):
            if stop.is_set():
                return
            if kind == "lost":
                resp = pb.GetFlowsResponse()
                resp.lost_events.source = 3  # HUBBLE_RING_BUFFER
                resp.lost_events.num_events_lost = int(payload)
                yield resp
                continue
            if not in_window(payload):
                if until_ns and int(payload.get("time_ns", 0)) > until_ns:
                    # Timestamps advance batch over batch: nothing after
                    # the until bound can ever match — end the stream
                    # instead of pinning a server worker forever.
                    return
                continue
            msg = pb.flow_dict_to_proto(payload, node_name=self.node_name)
            if passes(msg):
                yield to_resp(payload, msg)

    def _pb_server_status(self, request, ctx):
        from retina_tpu_torch.hubble import proto as pb

        return pb.ServerStatusResponse(
            num_flows=min(self.observer.flows_seen, self.observer._cap),
            max_flows=self.observer._cap,
            seen_flows=self.observer.flows_seen,
            uptime_ns=time.time_ns() - self._t0,
            version="retina-tpu",
        )

    def _pb_notify(self, request, ctx) -> Iterator[Any]:
        """peer.Peer/Notify: stream the current peer set as PEER_ADDED
        notifications, then keep the stream open for changes (static set
        here completes the initial sync and waits)."""
        from retina_tpu_torch.hubble import proto as pb

        stop = threading.Event()
        ctx.add_callback(stop.set)
        sent: set[str] = set()
        while not stop.is_set():
            for p in self._peer_list():
                addr = p.get("address", "")
                if addr and addr not in sent:
                    sent.add(addr)
                    yield pb.ChangeNotification(
                        name=p.get("name", ""), address=addr,
                        type=1,  # PEER_ADDED
                    )
            # Poll for membership changes (node store updates) while the
            # stream is open — the reference peer service pushes changes
            # the same way.
            stop.wait(0.5)

    def _make_pb_handlers(self):
        import grpc

        from retina_tpu_torch.hubble import proto as pb

        observer = grpc.method_handlers_generic_handler(
            pb.OBSERVER_SERVICE_PB,
            {
                "GetFlows": grpc.unary_stream_rpc_method_handler(
                    self._pb_get_flows,
                    request_deserializer=pb.GetFlowsRequest.FromString,
                    response_serializer=lambda m: m.SerializeToString(),
                ),
                "ServerStatus": grpc.unary_unary_rpc_method_handler(
                    self._pb_server_status,
                    request_deserializer=pb.ServerStatusRequest.FromString,
                    response_serializer=lambda m: m.SerializeToString(),
                ),
            },
        )
        peer = grpc.method_handlers_generic_handler(
            pb.PEER_SERVICE_PB,
            {
                "Notify": grpc.unary_stream_rpc_method_handler(
                    self._pb_notify,
                    request_deserializer=pb.NotifyRequest.FromString,
                    response_serializer=lambda m: m.SerializeToString(),
                ),
            },
        )

        class Multi(grpc.GenericRpcHandler):
            def service(self, details):
                return observer.service(details) or peer.service(details)

        return Multi()

    def start(self) -> None:
        self._server.start()
        self._log.info("hubble flow relay on port %d", self.port)

    def stop(self, grace: float = 1.0) -> None:
        self._stop.set()
        self._server.stop(grace)


class HubbleClient:
    """Client for the flow relay (the hubble CLI / relay peer side)."""

    def __init__(self, addr: str = "127.0.0.1:4244"):
        import grpc

        self._chan = grpc.insecure_channel(addr)
        bypass = lambda x: x  # noqa: E731 — raw bytes both ways
        self._get_flows = self._chan.unary_stream(
            f"/{OBSERVER_SERVICE}/GetFlows",
            request_serializer=bypass, response_deserializer=bypass,
        )
        self._status = self._chan.unary_unary(
            f"/{OBSERVER_SERVICE}/ServerStatus",
            request_serializer=bypass, response_deserializer=bypass,
        )
        self._peers = self._chan.unary_unary(
            f"/{PEER_SERVICE}/ListPeers",
            request_serializer=bypass, response_deserializer=bypass,
        )

    def get_flows(
        self,
        filter: Optional[FlowFilter] = None,
        last: int = 0,
        follow: bool = False,
        timeout: Optional[float] = None,
        lost_markers: bool = False,
    ) -> Iterator[dict[str, Any]]:
        """With ``lost_markers``, ring-overwrite skips surface as
        ``{"lost_events": n}`` dicts interleaved with the flows."""
        req = {"last": last, "follow": follow}
        if lost_markers:
            req["lost_markers"] = True
        if filter is not None:
            req["filter"] = filter.to_dict()
        for raw in self._get_flows(_pack(req), timeout=timeout):
            yield _unpack(raw)

    def server_status(self) -> dict[str, Any]:
        return _unpack(self._status(_pack({}), timeout=5))

    def list_peers(self) -> list[dict[str, str]]:
        return _unpack(self._peers(_pack({}), timeout=5))["peers"]

    def close(self) -> None:
        self._chan.close()


class FleetShipClient:
    """Node-side client for the relay's retina.Fleet/Ship endpoint.
    Sends already-encoded RFLT frames; the shipper owns retry/drop
    policy, this class only moves bytes."""

    def __init__(self, addr: str, timeout_s: float = 5.0):
        import grpc

        self._chan = grpc.insecure_channel(addr)
        self._timeout = timeout_s
        bypass = lambda x: x  # noqa: E731 — raw bytes both ways
        self._ship = self._chan.unary_unary(
            f"/{FLEET_SERVICE}/Ship",
            request_serializer=bypass, response_deserializer=bypass,
        )

    def ship(self, frame: bytes) -> bool:
        resp = _unpack(self._ship(frame, timeout=self._timeout))
        return bool(resp.get("ok", False))

    def close(self) -> None:
        self._chan.close()
