"""The client side of the relay's ``retina.Fleet/Ship`` RPC (port of
``FLEET_SERVICE`` and ``FleetShipClient`` of retina_tpu/hubble/server.py).

Nodes ship encoded sketch snapshots to the aggregator through the relay
endpoint instead of raw samples: a raw-bytes unary RPC whose request is the
RFLT frame (``fleet/codec.py``), so the relay never unpacks the arrays, and
whose reply is a msgpack ``{"ok": bool}``, read here with the port's own
MessagePack subset (``utils/_msgpack.py``).

``grpc`` is imported when a client is built, never at module import: an
agent that ships over the in-process bus needs no gRPC. Without it, building
a client raises, and the shipper counts that as a failed send (its circuit
opens and the frame spools); it never falls back to the bus.

``HubbleServer`` (the Observer, Peer and Fleet services), the flow observer
and the rest of the reference's hubble/ wait for ROADMAP §1 item 7.
"""

from __future__ import annotations

from retina_tpu_torch.utils import _msgpack

# Fleet rollup tier (fleet/): the relay's Ship endpoint.
FLEET_SERVICE = "retina.Fleet"


class FleetShipClient:
    """Node-side client for the relay's retina.Fleet/Ship endpoint. Sends
    already-encoded RFLT frames; the shipper owns the retry and drop
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
        resp = _msgpack.unpackb(self._ship(frame, timeout=self._timeout))
        return bool(resp.get("ok", False))

    def close(self) -> None:
        self._chan.close()
