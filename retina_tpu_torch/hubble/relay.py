"""Hubble relay: cluster-wide flow aggregation across node agents (port of
retina_tpu/hubble/relay.py).

Reference analog: the Hubble relay of the reference's Hubble control
plane (docs/01-Introduction/02-architecture.md, Hubble CP section; gRPC
:4244 per node + a cluster relay fanning in peers discovered through the
peer service). Here: the relay discovers peers from a static config list
AND/OR by subscribing to a seed agent's ``peer.Peer/Notify`` stream, then
opens a follow ``observer.Observer/GetFlows`` stream to every peer,
funnels all flows into a local ring, and serves the SAME Cilium-compatible
Observer surface — so a client pointed at the relay sees cluster-wide
flows with per-node ``node_name`` attribution.

Failure behavior mirrors the system rule: a peer that drops its stream is
retried with backoff; flows lost while disconnected are just lost (the
per-node agents account their own loss). ``grpc`` is imported when a
follower or the discovery loop dials a peer, never at module import.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from retina_tpu_torch.hubble.observer import FlowObserver
from retina_tpu_torch.hubble.server import HubbleServer
from retina_tpu_torch.log import logger


class HubbleRelay:
    def __init__(
        self,
        peers: Optional[list[dict[str, str]]] = None,
        discover_from: str = "",
        addr: str = "127.0.0.1:4245",
        capacity: int = 1 << 12,
        node_name: str = "relay",
        retry_s: float = 1.0,
    ):
        self._log = logger("relay")
        self.observer = FlowObserver(capacity=capacity)
        self._static_peers = list(peers or [])
        self._discover_from = discover_from
        self._retry_s = retry_s
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._peer_lock = threading.Lock()
        self._connected: dict[str, str] = {}  # address -> name
        self._channels: dict[str, Any] = {}  # grpc.Channel
        # The relay's OWN peer service reflects the live followed set
        # (static + discovered), so chained relays/clients see real
        # cluster membership, not boot-time config.
        self.server = HubbleServer(
            self.observer, addr=addr, node_name=node_name,
            peers=self.peer_list,
        )
        # Loss reported BY peers (their ring lapped this relay): without
        # this the cluster view silently reads complete while a node
        # dropped flows on the way here.
        self.peer_lost = 0
        self.server.m_lost.labels(source="PEER_STREAM").set_function(
            lambda: self.peer_lost
        )

    def peer_list(self) -> list[dict[str, str]]:
        with self._peer_lock:
            return [
                {"name": name, "address": addr}
                for addr, name in self._connected.items()
            ]

    @property
    def port(self) -> int:
        return self.server.port

    # -- peer ingestion -------------------------------------------------
    def _follow_peer(self, name: str, address: str) -> None:
        import grpc

        from retina_tpu_torch.hubble import proto as pb

        while not self._stop.is_set():
            chan = None
            try:
                chan = grpc.insecure_channel(address)
                with self._peer_lock:
                    self._channels[address] = chan
                get_flows = chan.unary_stream(
                    "/observer.Observer/GetFlows",
                    request_serializer=lambda m: m.SerializeToString(),
                    response_deserializer=pb.GetFlowsResponse.FromString,
                )
                stream = get_flows(pb.GetFlowsRequest(follow=True))
                self._log.info("relay following peer %s at %s", name, address)
                for resp in stream:
                    if self._stop.is_set():
                        stream.cancel()
                        break
                    kind = resp.WhichOneof("response_types")
                    if kind == "lost_events":
                        n = int(resp.lost_events.num_events_lost)
                        with self._peer_lock:  # one follower per peer
                            self.peer_lost += n
                        self._log.warning(
                            "peer %s reported %d flows lost", name, n
                        )
                        continue
                    if kind != "flow":
                        continue
                    # Per-response flush: a quiet peer's flows must not
                    # sit in a local batch on the never-ending stream.
                    self.observer.consume_flows(
                        [pb.flow_proto_to_dict(resp.flow)]
                    )
            except Exception as e:  # noqa: BLE001 — follower never dies
                if self._stop.is_set():
                    return
                code = e.code() if isinstance(e, grpc.RpcError) else e
                self._log.warning(
                    "peer %s stream failed (%s); retrying in %.1fs",
                    name, code, self._retry_s,
                )
            finally:
                if chan is not None:
                    chan.close()
            self._stop.wait(self._retry_s)

    def _discover(self) -> None:
        """Subscribe to the seed agent's peer service; every PEER_ADDED
        notification spawns a follower (the reference relay watches the
        peer service the same way)."""
        import grpc

        from retina_tpu_torch.hubble import proto as pb

        while not self._stop.is_set():
            chan = None
            try:
                chan = grpc.insecure_channel(self._discover_from)
                with self._peer_lock:
                    self._channels["__discovery__"] = chan
                notify = chan.unary_stream(
                    "/peer.Peer/Notify",
                    request_serializer=lambda m: m.SerializeToString(),
                    response_deserializer=pb.ChangeNotification.FromString,
                )
                for note in notify(pb.NotifyRequest()):
                    if self._stop.is_set():
                        break
                    if note.type == 1:  # PEER_ADDED
                        self.add_peer(note.name, note.address)
            except Exception as e:  # noqa: BLE001 — discovery never dies
                if self._stop.is_set():
                    return
                code = e.code() if isinstance(e, grpc.RpcError) else e
                self._log.warning(
                    "peer discovery via %s failed (%s); retrying in %.1fs",
                    self._discover_from, code, self._retry_s,
                )
            finally:
                if chan is not None:
                    chan.close()
            self._stop.wait(self._retry_s)

    def add_peer(self, name: str, address: str) -> None:
        with self._peer_lock:
            if address in self._connected:
                return
            self._connected[address] = name
        t = threading.Thread(
            target=self._follow_peer, args=(name, address),
            name=f"relay-peer-{name}", daemon=True,
        )
        t.start()
        self._threads.append(t)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self.server.start()
        for p in self._static_peers:
            self.add_peer(p.get("name", p["address"]), p["address"])
        if self._discover_from:
            t = threading.Thread(
                target=self._discover, name="relay-discovery", daemon=True
            )
            t.start()
            self._threads.append(t)
        self._log.info(
            "hubble relay on port %d (%d static peers%s)",
            self.port, len(self._static_peers),
            f", discovery via {self._discover_from}"
            if self._discover_from else "",
        )

    def stop(self) -> None:
        self._stop.set()
        self.server.stop()
        # Closing the channels aborts blocked stream iterations so the
        # follower/discovery threads exit promptly instead of waiting
        # out their joins.
        with self._peer_lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for chan in channels:
            try:
                chan.close()
            except Exception:  # noqa: BLE001, RT101 — shutdown path; a half-closed peer socket is expected
                pass
        for t in self._threads:
            t.join(2.0)
