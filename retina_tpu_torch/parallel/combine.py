"""Host-side record combining (copy of retina_tpu/parallel/combine.py).

Before records cross the host-to-card link, identical flow descriptors of
one flush are merged into one record carrying the summed PACKETS and BYTES
(saturating at 2^32 - 1) and the latest timestamp: the analog of the
reference agent's eBPF-map pre-aggregation. Every aggregator weights by
F.PACKETS, so feeding the combined rows gives the same state as feeding
the raw rows. The key is every column except the weights and timestamps.

``combine_records`` and ``combine_blocks`` run the port's native copy
(``native/combine.cpp``); if it cannot be built they raise, never falling
back to numpy. ``combine_records_numpy`` is the twin the tests hold the
native combiner against: it sorts by a descriptor hash, so it may split a
group whose descriptors' hashes collide and its row order differs.
"""

from __future__ import annotations

import numpy as np

from retina_tpu_torch.events.schema import F, NUM_FIELDS
from retina_tpu_torch.ops.hashing import hash_cols_np

# Group key: every column EXCEPT the accumulated weights and timestamps.
# TSVAL/TSECR stay in the key: the latency match needs their exact values.
KEY_COLS = (
    F.SRC_IP,
    F.DST_IP,
    F.PORTS,
    F.META,
    F.VERDICT,
    F.DROP_REASON,
    F.TSVAL,
    F.TSECR,
    F.DNS,
    F.DNS_QHASH,
    F.EVENT_TYPE,
    F.IFINDEX,
)

_U32_MAX = np.uint64(0xFFFFFFFF)


def combine_records_numpy(records: np.ndarray) -> np.ndarray:
    """Pure-numpy combine: sort by descriptor hash + segmented reduce.

    PACKETS/BYTES sum (saturating), the timestamp is the group's latest.
    Returns the input itself when nothing merges; rows come in hash order.
    """
    n = len(records)
    if n <= 1:
        return records
    if records.shape[1] != NUM_FIELDS:
        raise ValueError(f"expected (N, {NUM_FIELDS}) records, got {records.shape}")
    h = hash_cols_np([records[:, c] for c in KEY_COLS], seed=0xC0B1)
    order = np.argsort(h, kind="stable")
    r = records[order]
    # A group boundary is any key column differing from the previous
    # sorted row; equal keys hash equally, so they are adjacent unless a
    # colliding descriptor interleaves (which can only split a group).
    bounds = np.empty(n, bool)
    bounds[0] = True
    acc = np.zeros(n - 1, bool)
    for c in KEY_COLS:
        col = r[:, c]
        acc |= col[1:] != col[:-1]
    bounds[1:] = acc
    starts = np.flatnonzero(bounds)
    if len(starts) == n:
        return records
    out = r[starts].copy()
    pkts = np.add.reduceat(r[:, F.PACKETS].astype(np.uint64), starts)
    byts = np.add.reduceat(r[:, F.BYTES].astype(np.uint64), starts)
    out[:, F.PACKETS] = np.minimum(pkts, _U32_MAX).astype(np.uint32)
    out[:, F.BYTES] = np.minimum(byts, _U32_MAX).astype(np.uint32)
    ts = (r[:, F.TS_HI].astype(np.uint64) << np.uint64(32)) | r[:, F.TS_LO].astype(np.uint64)
    tmax = np.maximum.reduceat(ts, starts)
    out[:, F.TS_LO] = (tmax & _U32_MAX).astype(np.uint32)
    out[:, F.TS_HI] = (tmax >> np.uint64(32)).astype(np.uint32)
    return out


def combine_records(records: np.ndarray) -> np.ndarray:
    """(N, 16) -> (G, 16) with identical descriptors merged (native
    single-pass hash combiner, in order of first appearance)."""
    from retina_tpu_torch.native import combine_native

    return combine_native(records)


def combine_blocks(blocks: list[np.ndarray]) -> np.ndarray:
    """Combine a list of record blocks (one flush quantum) without
    concatenating them first. The key -> (packets, bytes, latest ts) map
    equals ``combine_records(np.concatenate(blocks))``; the row order does
    too on one thread, and is the stripes' order on the multi-consumer
    path (rows are partitioned and re-bucketed right after). Blocks are
    made C-contiguous uint32 first."""
    from retina_tpu_torch.native import (
        combine_native_blocks,
        combine_native_blocks_striped,
        get_combine_threads,
    )

    blocks = [np.ascontiguousarray(b, np.uint32) for b in blocks]
    total = sum(len(b) for b in blocks)
    n_threads = get_combine_threads()
    if n_threads > 1 and total >= 2 * (1 << 15):
        # T stripe workers each combine one key-hash stripe of the list.
        return combine_native_blocks_striped(blocks, n_threads)
    if len(blocks) == 1:
        return combine_records(blocks[0])
    return combine_native_blocks(blocks)
