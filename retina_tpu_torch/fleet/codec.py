"""Versioned wire codec for fleet sketch snapshots (port of
retina_tpu/fleet/codec.py; the frame layout, catalog and header are the
reference's, byte for byte, and the header is packed by the port's own
MessagePack subset, ``utils/_msgpack.py``).

One snapshot is the device-merged sketch state of one node for one
closed window: CM tables, heavy-hitter candidate tables, HLL register
banks, the entropy histograms, and the window totals. "Sketchy With a
Chance of Adoption" (PAPERS.md) is the design argument: the sketches
are the compressed, *mergeable* representation, so the fleet tier ships
them instead of samples and the operator merges losslessly.

Frame layout (little-endian throughout)::

    b"RFLT" | u8 version | u32 header_len | header (msgpack) | payload

The header carries node/tenant/priority/epoch/seq/window metadata, the
sketch seeds (hash-function identity — merging sketches built with
different seeds is meaningless and is refused at ingest), and an array
directory of ``{name, wire dtype, target dtype, shape}`` records; the
payload is the arrays' raw bytes concatenated in directory order.

HLL register banks hold values 0..33 by construction (rank of a 32-bit
hash) but live as uint32 on device for scatter-dtype uniformity; the
codec packs them to uint8 on the wire (4x smaller — at production
shapes the per-pod bank is the largest array in the frame) and restores
uint32 on decode, so round-trip is value-exact.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from retina_tpu_torch.utils import _msgpack

MAGIC = b"RFLT"
VERSION = 1

# In-process pubsub topics (pubsub.py). Snapshot payloads are bytes,
# exactly what the gRPC Ship RPC carries, so the in-process and relay
# transports are interchangeable.
FLEET_TOPIC = "fleet/snapshots"
ROLLUP_TOPIC = "fleet/rollups"

# v1 array catalog: name -> (device dtype, wire dtype). Encoders may
# ship any subset (the aggregator merges what every node in the epoch
# actually sent), but names outside the catalog are a decode error —
# the catalog IS the schema.
ARRAY_CATALOG: dict[str, tuple[str, str]] = {
    "flow_cms": ("uint32", "uint32"),
    "flow_keys": ("uint32", "uint32"),
    "flow_counts": ("uint32", "uint32"),
    "svc_cms": ("uint32", "uint32"),
    "svc_keys": ("uint32", "uint32"),
    "svc_counts": ("uint32", "uint32"),
    "dns_cms": ("uint32", "uint32"),
    "dns_keys": ("uint32", "uint32"),
    "dns_counts": ("uint32", "uint32"),
    "hll_flows": ("uint32", "uint8"),
    "hll_src_per_pod": ("uint32", "uint8"),
    "entropy": ("float32", "float32"),
    "totals": ("uint32", "uint32"),
    # Invertible sketch regions (ops/invertible.py): pure-sum bit-plane
    # counters — the aggregator decodes cluster-wide heavy keys from the
    # MERGED arrays, so no node ever ships raw keys.
    "inv_flow_planes": ("uint32", "uint32"),
    "inv_flow_weights": ("uint32", "uint32"),
    "inv_hi_planes": ("uint32", "uint32"),
    "inv_hi_weights": ("uint32", "uint32"),
}

class FleetDecodeError(ValueError):
    """Raised on any malformed fleet frame (bad magic/version/length,
    unknown array, dtype/shape mismatch). The aggregator counts these
    and drops the frame — a misbehaving node must never take down the
    rollup tier."""


@dataclasses.dataclass
class FleetSnapshot:
    """Decoded (or to-encode) snapshot: metadata + host arrays."""

    node: str
    tenant: str
    priority: int  # higher = more important; shed LAST
    epoch: int  # window epoch (aligned across nodes)
    seq: int  # per-node monotonic ship counter (duplicate detection)
    window_s: float
    seeds: dict[str, int]  # sketch hash seeds (merge identity)
    arrays: dict[str, np.ndarray]
    # Optional trace context (obs/recorder.py): the window-epoch trace
    # ID plus origin metadata, so the aggregator's merge span joins the
    # shipping node's span lineage. Absent on frames from older nodes
    # (and omitted from the wire when None), so the codec stays
    # compatible in both directions: old decoders ignore the unknown
    # msgpack key, this decoder tolerates its absence.
    trace: dict | None = None
    # Seed generation: bumped by a live seed rotation. Sketches only
    # merge within one generation; the aggregator quarantines
    # cross-generation frames per epoch instead of permanently
    # quarantining a rotated node. Same compatibility pattern as
    # ``trace``: omitted from the wire when 0, so pre-rotation frames
    # stay byte-identical and decode as generation 0.
    seed_gen: int = 0
    # Rollup tier of the ENCODER: 0 = node agent, 1 = zone aggregator
    # re-ship, 2+ = higher tiers. Informational (the merge algebra is
    # tier-blind — an aggregator's output is a valid node snapshot);
    # omitted from the wire when 0.
    tier: int = 0

    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.arrays.values())


def encode_snapshot(snap: FleetSnapshot) -> bytes:
    """Serialize to one wire frame. Arrays are packed in sorted-name
    order so encoding is deterministic (byte-identical for equal
    snapshots)."""
    directory = []
    chunks = []
    for name in sorted(snap.arrays):
        if name not in ARRAY_CATALOG:
            raise ValueError(f"array {name!r} not in fleet catalog v1")
        target, wire = ARRAY_CATALOG[name]
        arr = np.asarray(snap.arrays[name])
        if arr.dtype != np.dtype(target):
            raise ValueError(
                f"array {name!r} must be {target}, got {arr.dtype}"
            )
        wired = np.ascontiguousarray(arr.astype(wire, copy=False))
        directory.append({
            "n": name, "d": wire, "t": target, "s": list(arr.shape),
        })
        chunks.append(wired.tobytes())
    hdr: dict = {
        "v": VERSION,
        "node": snap.node,
        "tenant": snap.tenant,
        "prio": int(snap.priority),
        "epoch": int(snap.epoch),
        "seq": int(snap.seq),
        "win_s": float(snap.window_s),
        "seeds": {k: int(v) for k, v in snap.seeds.items()},
        "arrays": directory,
    }
    if snap.trace is not None:
        # Optional trace context: omitted entirely when unset so frames
        # from trace-less encoders stay byte-identical to v1-as-shipped.
        hdr["trace"] = snap.trace
    if snap.seed_gen:
        # Optional like trace: generation 0 frames stay byte-identical
        # to pre-rotation v1 frames in both directions.
        hdr["sgen"] = int(snap.seed_gen)
    if snap.tier:
        hdr["tier"] = int(snap.tier)
    header = _msgpack.packb(hdr)
    return b"".join(
        [MAGIC, bytes([VERSION]), struct.pack("<I", len(header)), header]
        + chunks
    )


def decode_snapshot(frame: bytes) -> FleetSnapshot:
    """Parse + validate one wire frame (inverse of encode_snapshot)."""
    if len(frame) < 9 or frame[:4] != MAGIC:
        raise FleetDecodeError("bad magic")
    if frame[4] != VERSION:
        raise FleetDecodeError(f"unsupported fleet version {frame[4]}")
    (hlen,) = struct.unpack_from("<I", frame, 5)
    if 9 + hlen > len(frame):
        raise FleetDecodeError("truncated header")
    try:
        hdr = _msgpack.unpackb(frame[9:9 + hlen])
    except Exception as e:
        raise FleetDecodeError(f"header unpack failed: {e}") from e
    if not isinstance(hdr, dict) or hdr.get("v") != VERSION:
        raise FleetDecodeError("header version mismatch")
    arrays: dict[str, np.ndarray] = {}
    off = 9 + hlen
    for rec in hdr.get("arrays", ()):
        name = rec.get("n")
        if name not in ARRAY_CATALOG:
            raise FleetDecodeError(f"unknown array {name!r}")
        target, wire = ARRAY_CATALOG[name]
        if rec.get("d") != wire or rec.get("t") != target:
            raise FleetDecodeError(f"array {name!r} dtype mismatch")
        shape = tuple(int(x) for x in rec.get("s", ()))
        n = int(np.prod(shape)) if shape else 1
        nbytes = n * np.dtype(wire).itemsize
        if off + nbytes > len(frame):
            raise FleetDecodeError(f"array {name!r} truncated")
        buf = np.frombuffer(frame, dtype=wire, count=n, offset=off)
        arrays[name] = buf.reshape(shape).astype(target, copy=False)
        off += nbytes
    if off != len(frame):
        raise FleetDecodeError(
            f"{len(frame) - off} trailing bytes after payload"
        )
    try:
        return FleetSnapshot(
            node=str(hdr["node"]),
            tenant=str(hdr["tenant"]),
            priority=int(hdr["prio"]),
            epoch=int(hdr["epoch"]),
            seq=int(hdr["seq"]),
            window_s=float(hdr["win_s"]),
            seeds={str(k): int(v) for k, v in hdr["seeds"].items()},
            arrays=arrays,
            trace=(dict(hdr["trace"])
                   if isinstance(hdr.get("trace"), dict) else None),
            seed_gen=int(hdr.get("sgen", 0)),
            tier=int(hdr.get("tier", 0)),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise FleetDecodeError(f"bad header field: {e}") from e
