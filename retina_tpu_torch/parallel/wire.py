"""The host-to-card wire format (port of retina_tpu/parallel/wire.py).

Records cross the link packed: 12 u32 lanes instead of the schema's 16,
unpacked back to 16 lanes on the card.

==  =========  ========================================================
ix  name       contents
==  =========  ========================================================
0   TS_REL     1 + nanoseconds since the batch base timestamp (u32,
               saturating); 0 means "no timestamp" and unpacks to ts 0
1   SRC_IP     = schema F.SRC_IP
2   DST_IP     = schema F.DST_IP
3   PORTS      = schema F.PORTS
4   META       = schema F.META
5   BYTES      = schema F.BYTES
6   PACKETS    = schema F.PACKETS
7   MISC       VERDICT(3b) << 29 | DROP_REASON(8b) << 21 |
               EVENT_TYPE(4b) << 17 | IFINDEX(17b)   (each saturating)
8   TSVAL      = schema F.TSVAL
9   TSECR      = schema F.TSECR
10  DNS        = schema F.DNS
11  DNS_QHASH  = schema F.DNS_QHASH
==  =========  ========================================================

The batch base timestamp travels as two u32 scalars (lo, hi) beside the
array. With the flow dictionary (parallel/flowdict.py) a flush splits into
a new wire of 13 lanes ([id | the 12 lanes above]) and a known wire: v3
is two lanes [id | packets << id_bits, bytes], v4 (the default) a dense
bitstream of (id_bits + 10 + 22)-bit rows.

The host side is copied from the reference (``pack_records`` runs the
port's native packer on 2-D batches and raises if it cannot load). The
card side is kernel K7 (``kernels/csrc/ingest.cu``); this module holds its
plain versions: ``unpack_records_plain`` and ``dense_known_unpack_plain``
(the reference's ``unpack_records_device`` and ``dense_known_unpack_device``)
and the three ingest functions built on them. They take int32 tensors of
u32 bit patterns and compute in int64 masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from retina_tpu_torch.events.schema import F, NUM_FIELDS
from retina_tpu_torch.u32 import M32, narrow, widen

PACKED_FIELDS = 12

_U32 = np.uint64(0xFFFFFFFF)


def batch_ts_base(records: np.ndarray) -> np.uint64:
    """Minimum nonzero 64-bit timestamp of the batch (0 if none): the
    TS_REL base shared by every wire array cut from one flush."""
    ts = (records[..., F.TS_HI].astype(np.uint64) << np.uint64(32)) | records[
        ..., F.TS_LO
    ].astype(np.uint64)
    nz = ts[ts > 0]
    return np.uint64(nz.min()) if len(nz) else np.uint64(0)


def ts_rel(records: np.ndarray, base: np.uint64) -> np.ndarray:
    """Biased relative timestamps: 1 + ns since ``base`` (saturating), 0
    for unstamped rows: the TS_REL lane."""
    ts = (records[..., F.TS_HI].astype(np.uint64) << np.uint64(32)) | records[
        ..., F.TS_LO
    ].astype(np.uint64)
    return np.where(
        ts > 0,
        np.minimum(ts - base, _U32 - np.uint64(1)) + np.uint64(1),
        0,
    ).astype(np.uint32)


def known_rows(rows: np.ndarray, ids: np.ndarray, id_bits: int, out: np.ndarray) -> None:
    """Fill the v3 known-row wire in place:
    ``word0 = flow_id | packets << id_bits``, ``word1 = bytes``."""
    out[:, 0] = ids | (rows[:, F.PACKETS] << id_bits)
    out[:, 1] = rows[:, F.BYTES]


# -- v4 dense known-row bitstream -------------------------------------
#
# Each known row is (id_bits + DENSE_PK_BITS + DENSE_BY_BITS) contiguous
# bits, ``id | packets << id_bits | bytes << (id_bits + DENSE_PK_BITS)``,
# streamed into one u32 word array; rows whose PACKETS or BYTES overflow
# their lane escalate to the new side. The +1 pad word keeps the card's
# two-word gather in bounds for the last row.

DENSE_PK_BITS = 10
DENSE_BY_BITS = 22


def dense_row_bits(id_bits: int) -> int:
    """Bits per dense known row; <= 64 for id_bits <= 32."""
    return int(id_bits) + DENSE_PK_BITS + DENSE_BY_BITS


def dense_words(n_rows: int, id_bits: int) -> int:
    """u32 words for ``n_rows`` dense known rows, with the pad word."""
    return (int(n_rows) * dense_row_bits(id_bits) + 31) // 32 + 1


def dense_known_rows(rows: np.ndarray, ids: np.ndarray, id_bits: int,
                     out: np.ndarray) -> None:
    """Numpy twin of the native dense build's known side: OR the dense bit
    rows into the ZEROED 1-D u32 ``out`` stream in row order. Packets must
    be < 2**DENSE_PK_BITS and bytes < 2**DENSE_BY_BITS."""
    k = len(rows)
    if k == 0:
        return
    rb = dense_row_bits(id_bits)
    v = (
        ids.astype(np.uint64)
        | (rows[:, F.PACKETS].astype(np.uint64) << np.uint64(id_bits))
        | (rows[:, F.BYTES].astype(np.uint64) << np.uint64(id_bits + DENSE_PK_BITS))
    )
    p = np.arange(k, dtype=np.uint64) * np.uint64(rb)
    wi = (p >> np.uint64(5)).astype(np.int64)
    sh = p & np.uint64(31)
    # A <= 64-bit value shifted by <= 31 spans <= 3 words.
    lo = ((v & _U32) << sh) & _U32
    mid = (v >> (np.uint64(32) - sh)) & _U32  # sh == 0 -> v >> 32: word 1
    hi_sh = np.where(sh > 0, np.uint64(64) - sh, np.uint64(63))
    hi = np.where(sh > 0, v >> hi_sh, np.uint64(0))
    np.bitwise_or.at(out, wi, lo.astype(np.uint32))
    np.bitwise_or.at(out, wi + 1, mid.astype(np.uint32))
    np.bitwise_or.at(out, wi + 2, hi.astype(np.uint32))


def dense_known_unpack_numpy(words: np.ndarray, n_rows: int, id_bits: int,
                             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host reader of the dense stream: (ids, packets, bytes)."""
    rb = dense_row_bits(id_bits)
    i = np.arange(n_rows, dtype=np.uint32)

    def field(off: int, width: int) -> np.ndarray:
        p = i * np.uint32(rb) + np.uint32(off)
        wi = (p >> np.uint32(5)).astype(np.int64)
        sh = p & np.uint32(31)
        lo = words[..., wi] >> sh
        up = words[..., wi + 1]
        up = np.where(sh > 0, up << ((np.uint32(32) - sh) & np.uint32(31)), 0).astype(np.uint32)
        return (lo | up) & np.uint32((1 << width) - 1)

    return (
        field(0, id_bits),
        field(id_bits, DENSE_PK_BITS),
        field(id_bits + DENSE_PK_BITS, DENSE_BY_BITS),
    )


def pack_records(records: np.ndarray, base: np.uint64 | None = None,
                 ) -> tuple[np.ndarray, np.uint32, np.uint32]:
    """(..., 16) u32 -> ((..., 12) u32, base_lo, base_hi).

    The base defaults to the minimum valid timestamp of this array; pass
    one when several wire arrays of one flush must share it. A 2-D batch
    goes through the native packer (``native/pack.cpp``), as in the
    reference; other shapes take the numpy lanes below.
    """
    if records.ndim == 2:
        from retina_tpu_torch.native import pack_native

        out, nbase = pack_native(records, None if base is None else int(base))
        nbase = np.uint64(nbase)
        return out, np.uint32(nbase & _U32), np.uint32(nbase >> np.uint64(32))
    if base is None:
        base = batch_ts_base(records)
    rel = ts_rel(records, base)
    out = np.empty(records.shape[:-1] + (PACKED_FIELDS,), np.uint32)
    out[..., 0] = rel
    out[..., 1] = records[..., F.SRC_IP]
    out[..., 2] = records[..., F.DST_IP]
    out[..., 3] = records[..., F.PORTS]
    out[..., 4] = records[..., F.META]
    out[..., 5] = records[..., F.BYTES]
    out[..., 6] = records[..., F.PACKETS]
    out[..., 7] = (
        (np.minimum(records[..., F.VERDICT], 7) << np.uint32(29))
        | (np.minimum(records[..., F.DROP_REASON], 255) << np.uint32(21))
        | (np.minimum(records[..., F.EVENT_TYPE], 15) << np.uint32(17))
        | np.minimum(records[..., F.IFINDEX], 0x1FFFF)
    )
    out[..., 8] = records[..., F.TSVAL]
    out[..., 9] = records[..., F.TSECR]
    out[..., 10] = records[..., F.DNS]
    out[..., 11] = records[..., F.DNS_QHASH]
    return out, np.uint32(base & _U32), np.uint32(base >> np.uint64(32))


def unpack_records_numpy(packed: np.ndarray, base_lo, base_hi) -> np.ndarray:
    """Host mirror of the card's unpack (tests)."""
    rel = packed[..., 0]
    relm1 = (rel - np.uint32(1)).astype(np.uint32)  # wraps for rel == 0
    ts_lo = (np.uint32(base_lo) + relm1).astype(np.uint32)
    carry = (ts_lo < relm1).astype(np.uint32)
    stamped = rel > 0
    misc = packed[..., 7]
    out = np.empty(packed.shape[:-1] + (NUM_FIELDS,), np.uint32)
    out[..., F.TS_LO] = np.where(stamped, ts_lo, 0)
    out[..., F.TS_HI] = np.where(stamped, np.uint32(base_hi) + carry, 0)
    out[..., F.SRC_IP] = packed[..., 1]
    out[..., F.DST_IP] = packed[..., 2]
    out[..., F.PORTS] = packed[..., 3]
    out[..., F.META] = packed[..., 4]
    out[..., F.BYTES] = packed[..., 5]
    out[..., F.PACKETS] = packed[..., 6]
    out[..., F.VERDICT] = misc >> 29
    out[..., F.DROP_REASON] = (misc >> 21) & np.uint32(0xFF)
    out[..., F.EVENT_TYPE] = (misc >> 17) & np.uint32(0xF)
    out[..., F.IFINDEX] = misc & np.uint32(0x1FFFF)
    out[..., F.TSVAL] = packed[..., 8]
    out[..., F.TSECR] = packed[..., 9]
    out[..., F.DNS] = packed[..., 10]
    out[..., F.DNS_QHASH] = packed[..., 11]
    return out


# -- the card side: plain versions of kernel K7 --------------------------


def _unpack64(p: torch.Tensor, base_lo: int, base_hi: int) -> torch.Tensor:
    """(n, 12) int64 u32 values -> (n, 16) int64 u32 values."""
    rel = p[:, 0]
    relm1 = (rel - 1) & M32  # wraps for rel == 0; masked below
    ts_lo = (int(base_lo) + relm1) & M32
    carry = (ts_lo < relm1).to(torch.int64)
    stamped = rel > 0
    misc = p[:, 7]
    cols = [None] * NUM_FIELDS
    cols[F.TS_LO] = torch.where(stamped, ts_lo, 0)
    cols[F.TS_HI] = torch.where(stamped, (int(base_hi) + carry) & M32, 0)
    cols[F.SRC_IP] = p[:, 1]
    cols[F.DST_IP] = p[:, 2]
    cols[F.PORTS] = p[:, 3]
    cols[F.META] = p[:, 4]
    cols[F.BYTES] = p[:, 5]
    cols[F.PACKETS] = p[:, 6]
    cols[F.VERDICT] = misc >> 29
    cols[F.DROP_REASON] = (misc >> 21) & 0xFF
    cols[F.EVENT_TYPE] = (misc >> 17) & 0xF
    cols[F.IFINDEX] = misc & 0x1FFFF
    cols[F.TSVAL] = p[:, 8]
    cols[F.TSECR] = p[:, 9]
    cols[F.DNS] = p[:, 10]
    cols[F.DNS_QHASH] = p[:, 11]
    return torch.stack(cols, dim=1)


def unpack_records_plain(packed: torch.Tensor, base_lo: int, base_hi: int) -> torch.Tensor:
    """(n, 12) packed int32 lanes + the base -> (n, 16) int32 records."""
    return narrow(_unpack64(widen(packed), base_lo, base_hi))


def dense_known_unpack_plain(words: torch.Tensor, n_rows: int, id_bits: int,
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(W,) int32 dense stream -> (ids, packets, bytes), each (n_rows,)
    int64: two-word gathers per field, every field <= 32 bits wide."""
    rb = dense_row_bits(id_bits)
    w = widen(words)
    i = torch.arange(n_rows, dtype=torch.int64, device=words.device)

    def field(off: int, width: int) -> torch.Tensor:
        p = i * rb + off
        wi = p >> 5
        sh = p & 31
        lo = w[wi] >> sh
        up = torch.where(sh > 0, (w[wi + 1] << (32 - sh)) & M32, 0)
        return (lo | up) & ((1 << width) - 1)

    return (
        field(0, id_bits),
        field(id_bits, DENSE_PK_BITS),
        field(id_bits + DENSE_PK_BITS, DENSE_BY_BITS),
    )


def _windows_buffer(full: torch.Tensor, n_out: int) -> torch.Tensor:
    """(bucket, 16) int64 rows -> (n_out, 16) int32, zero past bucket."""
    out = torch.zeros((n_out, NUM_FIELDS), dtype=torch.int32, device=full.device)
    out[: full.shape[0]] = narrow(full)
    return out


def ingest_packed_plain(wire: torch.Tensor, packed: bool, base_lo: int, base_hi: int,
                        n_out: int) -> torch.Tensor:
    """Plain version of K7 ingest_packed: the (bucket, 12) packed wire
    unpacked (or the (bucket, 16) wire copied) into a zeroed (n_out, 16)
    buffer of step windows."""
    w = widen(wire)
    return _windows_buffer(_unpack64(w, base_lo, base_hi) if packed else w, n_out)


def ingest_new_plain(wire: torch.Tensor, table: torch.Tensor, base_lo: int, base_hi: int,
                     n_out: int) -> torch.Tensor:
    """Plain version of K7 ingest_new: scatter the 12 lanes of every one of
    the (bucket, 13) wire's rows into ``table`` (slots, 12) at their id, in
    place (where an id repeats, the last row in batch order wins; ids past
    the table are dropped), then unpack the lanes into the windows."""
    slots = table.shape[0]
    ids = widen(wire[:, 0])
    lanes = wire[:, 1:]
    rows = torch.arange(ids.shape[0], dtype=torch.int64, device=wire.device)
    inside = ids < slots
    last = torch.full((slots,), -1, dtype=torch.int64, device=wire.device)
    last.scatter_reduce_(0, ids[inside], rows[inside], "amax")
    win = inside & (last[ids.clamp(max=slots - 1)] == rows)
    table[ids[win]] = lanes[win]
    return _windows_buffer(_unpack64(widen(lanes), base_lo, base_hi), n_out)


def ingest_known_plain(wire: torch.Tensor, bucket: int, dense: bool, id_bits: int,
                       table: torch.Tensor, ts_rel_flag: int, base_lo: int, base_hi: int,
                       n_out: int) -> torch.Tensor:
    """Plain version of K7 ingest_known: decode (id, packets, bytes) of the
    ``bucket`` rows from the v4 stream (``dense``) or the (bucket, 2) v3
    wire, gather each row's 12 lanes from ``table`` (ids past it read the
    last slot), overlay PACKETS, BYTES and TS_REL (the flush's flag), and
    unpack into the windows."""
    if dense:
        ids, pk, by = dense_known_unpack_plain(wire, bucket, id_bits)
    else:
        w = widen(wire)
        ids = w[:, 0] & ((1 << id_bits) - 1)
        pk = w[:, 0] >> id_bits
        by = w[:, 1]
    desc = widen(table[ids.clamp(max=table.shape[0] - 1)])
    desc[:, 6] = pk
    desc[:, 5] = by
    desc[:, 0] = int(ts_rel_flag) & M32
    return _windows_buffer(_unpack64(desc, base_lo, base_hi), n_out)
