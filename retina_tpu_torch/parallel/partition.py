"""Host-side partitioning of event records (copy of retina_tpu/parallel/partition.py).

Connection-consistent sharding: both directions of a connection land on
the same device, so per-device conntrack tables never see half a
connection; the key is the canonical (sorted-endpoint) hash that conntrack
uses. One (N, F) host batch becomes a (D, B, F) batch with per-device
validity counts and drop accounting (rows that do not fit are dropped and
counted, never blocked on). The hashes are the port's numpy mirror
(``ops/hashing.py``), bit-identical to the reference's.

The port runs one card, so its engine calls this with D = 1 and keeps the
(1, B, F) layout, so that the dispatch code reads like the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from retina_tpu_torch.events.schema import F, NUM_FIELDS
from retina_tpu_torch.ops.hashing import hash_cols_np


def canonical_conn_hash(records: np.ndarray, seed: int = 0x5A) -> np.ndarray:
    """(N, F) records -> (N,) direction-independent connection hashes."""
    src, dst = records[:, F.SRC_IP], records[:, F.DST_IP]
    ports = records[:, F.PORTS]
    proto = records[:, F.META] >> np.uint32(24)
    sp, dp = ports >> np.uint32(16), ports & np.uint32(0xFFFF)
    fwd = (src < dst) | ((src == dst) & (sp <= dp))
    a_ip = np.where(fwd, src, dst).astype(np.uint32)
    b_ip = np.where(fwd, dst, src).astype(np.uint32)
    a_pt = np.where(fwd, sp, dp).astype(np.uint32)
    b_pt = np.where(fwd, dp, sp).astype(np.uint32)
    return hash_cols_np([a_ip, b_ip, (a_pt << np.uint32(16)) | b_pt, proto], seed)


@dataclasses.dataclass
class ShardedBatch:
    """One host batch split across D devices."""

    records: np.ndarray  # (D, B, NUM_FIELDS) uint32
    n_valid: np.ndarray  # (D,) uint32
    lost: int  # events dropped because a shard overflowed (sum of the
    # dropped rows' F.PACKETS: a combined row stands for many events)
    events: int = 0  # events the kept rows stand for (same weighting)
    sample_k: int = 1  # overload 1-in-k applied before partitioning; 1 =
    # unsampled


def _next_bucket(n: int) -> int:
    """Smallest m * 2^k >= n with mantissa m in {4, 6}: transfer shapes
    within 50% of the payload, two shapes per octave."""
    if n <= 4:
        return max(n, 1)
    k = (n - 1).bit_length() - 3  # so that 4*2^k <= n-1 < 8*2^k
    step = 1 << (k + 1)  # multiples of 2^(k+1): mantissa 4 or 6
    return ((n + step - 1) // step) * step


def partition_events(
    records: np.ndarray,
    n_devices: int,
    capacity: int,
    min_bucket: int | None = None,
) -> ShardedBatch:
    """Split (N, F) valid records into a (D, B', F) sharded batch.

    ``min_bucket=None`` gives B' = capacity; with an integer, B' is the
    smallest bucket (``_next_bucket``) >= max(shard fill, min_bucket),
    capped at capacity. Rows past capacity are dropped and counted in
    ``lost`` by their packet weight.

    For ``n_devices == 1`` a bucket-full contiguous batch comes back as a
    zero-copy view of ``records``: consume it before reusing the buffer.
    """
    if records.ndim != 2 or records.shape[1] < NUM_FIELDS:
        raise ValueError(f"expected (N, >={NUM_FIELDS}) records, got {records.shape}")
    width = records.shape[1]

    def bucket_for(n_max: int) -> int:
        if min_bucket is None:
            return capacity
        return min(_next_bucket(max(n_max, min_bucket)), capacity)

    if n_devices == 1:
        # One shard takes everything: no connection hashing, and a full
        # batch is a zero-copy reshape.
        n = min(len(records), capacity)
        lost = int(records[n:, F.PACKETS].astype(np.uint64).sum())
        kept = int(records[:n, F.PACKETS].astype(np.uint64).sum())
        b = bucket_for(n)
        if n == b:
            out = np.ascontiguousarray(records[:n], np.uint32)
            out = out.reshape(1, b, width)
        else:
            out = np.zeros((1, b, width), np.uint32)
            out[0, :n] = records[:n]
        return ShardedBatch(records=out, n_valid=np.array([n], np.uint32),
                            lost=lost, events=kept)
    n_valid = np.zeros((n_devices,), np.uint32)
    lost = 0
    kept = 0
    if len(records):
        dev = canonical_conn_hash(records) % np.uint32(n_devices)
        counts = np.bincount(dev, minlength=n_devices)
        b = bucket_for(int(min(counts.max(), capacity)))
        out = np.zeros((n_devices, b, width), np.uint32)
        total = int(records[:, F.PACKETS].astype(np.uint64).sum())
        for d in range(n_devices):
            rows = records[dev == d]
            n = min(len(rows), capacity)
            out[d, :n] = rows[:n]
            n_valid[d] = n
            lost += int(rows[n:, F.PACKETS].astype(np.uint64).sum())
        kept = total - lost
    else:
        out = np.zeros((n_devices, bucket_for(0), width), np.uint32)
    return ShardedBatch(records=out, n_valid=n_valid, lost=lost, events=kept)
