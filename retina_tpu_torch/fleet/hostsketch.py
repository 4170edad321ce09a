"""Pure-numpy node-window sketch builder (torch-free child processes; port
of retina_tpu/fleet/hostsketch.py).

The churn harness (fleet/churn.py) runs ≥64 node agents as separate OS
processes; importing torch in every child costs seconds of startup and
hundreds of MB each, and the child never touches a device. This module
builds the full RFLT array catalog with numpy only, mirroring the
device builders bit-for-bit where the algebra demands it, and its arrays
are bit-identical to the reference's:

- CMS tables, HLL register banks, and entropy histograms are
  BIT-IDENTICAL to ops/countmin.py / ops/hyperloglog.py /
  ops/entropy.py (same fmix32 hash family via ops/hashing_np.py's
  ``*_np`` mirrors, same index math, wrapping uint32 adds).
- Heavy-hitter candidate tables reproduce the device's two-pass
  scatter-max/winner-write. On equal-estimate ties the device scatter
  keeps an unspecified winning lane; this builder keeps the last batch
  row, which is a valid candidate of equal count — the documented
  contract (ops/topk.py), so counts match exactly and key rows match
  on any tie-free batch.

Shapes/seeds are the fleet dryrun's (fleet/dryrun.py) so frames from
real child processes and simulated in-process agents are
interchangeable on the wire.

Traffic generation lives here too: :func:`epoch_traffic` derives one
node-epoch's flows from ``default_rng((run_seed, node_index, epoch))``,
so the harness parent recomputes EXACT per-flow ground truth for any
(node, epoch) pair without any IPC — restart-safe by construction (a
respawned node regenerates the same stream).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from retina_tpu_torch.ops.hashing_np import hash_cols_np, reduce_range_np

# Mirror of fleet/dryrun.py's simulated-agent shapes (the dryrun cannot
# import from here being re-exported back without a cycle risk, so the
# authoritative values are asserted equal in tests/test_torch_churn.py).
SLOTS = 1 << 10
WIDTH = 1 << 12
DEPTH = 4
PODS = 16
HLL_FLOWS_P = 10
HLL_POD_P = 6
ENTROPY_BUCKETS = 1 << 10

BASE_SEEDS = {
    "flow": 1, "svc": 2, "dns": 3,
    "hll_flows": 4, "hll_src_per_pod": 6, "entropy": 7,
}

# Slot/register hash-chain constants (must match ops/topk.py,
# ops/hyperloglog.py, ops/entropy.py).
_TOPK_SALT = 0x70CC
_HLL_SALT = 0xC0FFEE
_ENT_SALT = 0xE17209


def rotated_seeds(gen: int) -> dict[str, int]:
    """Seed set for one rotation generation (gen 0 = BASE_SEEDS).

    A rotation re-keys every hash family at once; the +1000·gen offset
    keeps generations disjoint while staying deterministic fleet-wide.
    """
    return {k: v + 1000 * int(gen) for k, v in BASE_SEEDS.items()}


def cms_update_np(
    table: np.ndarray, key_cols: list[np.ndarray],
    weights: np.ndarray, seed: int,
) -> np.ndarray:
    """In-place plain Count-Min add (ops/countmin.py twin)."""
    depth, width = table.shape
    seeds = (
        np.arange(1, depth + 1, dtype=np.uint32) + np.uint32(seed)
    ).reshape(depth, 1)
    h = hash_cols_np([c[None, :] for c in key_cols], seeds)
    idx = reduce_range_np(h, width)  # (depth, B)
    wts = weights.astype(table.dtype)
    for d in range(depth):
        np.add.at(table[d], idx[d], wts)
    return table


def cms_query_np(
    table: np.ndarray, key_cols: list[np.ndarray], seed: int
) -> np.ndarray:
    """Point estimates: min over depth rows (ops/countmin.py twin)."""
    depth, width = table.shape
    seeds = (
        np.arange(1, depth + 1, dtype=np.uint32) + np.uint32(seed)
    ).reshape(depth, 1)
    idx = reduce_range_np(
        hash_cols_np([c[None, :] for c in key_cols], seeds), width
    )
    return np.min(
        np.take_along_axis(table, idx.astype(np.int64), axis=1), axis=0
    )


def topk_update_np(
    key_rows: np.ndarray, counts: np.ndarray,
    key_cols: list[np.ndarray], estimates: np.ndarray, seed: int,
) -> None:
    """In-place candidate-table offer (ops/topk.py update twin):
    scatter-max estimates into slot counts, then winner rows (estimate
    == post-max slot count, estimate > 0) overwrite slot keys."""
    s = counts.shape[0]
    slot = reduce_range_np(
        hash_cols_np(key_cols, np.uint32(_TOPK_SALT) + np.uint32(seed)), s
    )
    est = estimates.astype(np.uint32)
    np.maximum.at(counts, slot, est)
    win = (est == counts[slot]) & (est > 0)
    rows = np.stack(key_cols, axis=1).astype(np.uint32)
    key_rows[slot[win]] = rows[win]


def hll_update_np(
    registers: np.ndarray, key_cols: list[np.ndarray],
    group: np.ndarray, seed: int,
) -> None:
    """In-place HLL register scatter-max (ops/hyperloglog.py twin;
    every batch row observed — callers pre-filter masked rows)."""
    g, m = registers.shape
    h = hash_cols_np(key_cols, np.uint32(_HLL_SALT) + np.uint32(seed))
    idx = reduce_range_np(h, m)
    p = int(m).bit_length() - 1
    rest = h >> np.uint32(p)
    folded = rest.copy()
    for shift in (1, 2, 4, 8, 16):
        folded |= folded >> np.uint32(shift)
    hsb = np.bitwise_count(folded).astype(np.int64) - 1  # -1 if rest==0
    rho = ((32 - p) - hsb).astype(np.uint32)
    np.maximum.at(
        registers.reshape(-1),
        group.astype(np.uint64) * np.uint64(m) + idx.astype(np.uint64),
        rho,
    )


def entropy_update_np(
    hist: np.ndarray, key_cols: list[np.ndarray],
    group: np.ndarray, weights: np.ndarray, seed: int,
) -> None:
    """In-place hashed-histogram add (ops/entropy.py twin)."""
    g, k = hist.shape
    h = hash_cols_np(key_cols, np.uint32(_ENT_SALT) + np.uint32(seed))
    idx = reduce_range_np(h, k)
    np.add.at(
        hist.reshape(-1),
        group.astype(np.uint64) * np.uint64(k) + idx.astype(np.uint64),
        weights.astype(np.float32),
    )


def sketch_arrays_np(
    keys: np.ndarray, w: np.ndarray, seeds: dict[str, int],
) -> dict[str, np.ndarray]:
    """One node-window's full wire array catalog from (B, 4) uint32 keys
    + integer weights — the numpy twin of dryrun._sketch_arrays."""
    cols = [np.ascontiguousarray(keys[:, i], np.uint32) for i in range(4)]
    wu = w.astype(np.uint32)
    out: dict[str, np.ndarray] = {}
    for fam, fam_cols in (
        ("flow", cols), ("svc", cols[:2]), ("dns", [cols[3]]),
    ):
        seed = int(seeds[fam])
        cms = np.zeros((DEPTH, WIDTH), np.uint32)
        cms_update_np(cms, fam_cols, wu, seed)
        est = cms_query_np(cms, fam_cols, seed)
        est = np.where(wu > 0, est, np.uint32(0))
        key_rows = np.zeros((SLOTS, len(fam_cols)), np.uint32)
        counts = np.zeros((SLOTS,), np.uint32)
        topk_update_np(key_rows, counts, fam_cols, est, seed)
        out[f"{fam}_cms"] = cms
        out[f"{fam}_keys"] = key_rows
        out[f"{fam}_counts"] = counts
    hllf = np.zeros((1, 1 << HLL_FLOWS_P), np.uint32)
    hll_update_np(
        hllf, cols, np.zeros(len(w), np.int64), int(seeds["hll_flows"])
    )
    out["hll_flows"] = hllf
    hllp = np.zeros((PODS, 1 << HLL_POD_P), np.uint32)
    pods = (cols[1] % np.uint32(PODS)).astype(np.int64)
    hll_update_np(hllp, [cols[0]], pods, int(seeds["hll_src_per_pod"]))
    out["hll_src_per_pod"] = hllp
    ent = np.zeros((3, ENTROPY_BUCKETS), np.float32)
    for g, c in enumerate((cols[0], cols[1], cols[3])):
        entropy_update_np(
            ent, [c], np.full(len(w), g, np.int64), w,
            int(seeds["entropy"]),
        )
    out["entropy"] = ent
    totals = np.zeros(8, np.uint32)
    totals[0] = np.uint32(min(int(w.sum()), 0xFFFFFFFF))
    out["totals"] = totals
    return out


# -- deterministic traffic (shared child/parent ground truth) ----------

def heavy_keys(run_seed: int, n: int) -> np.ndarray:
    """Fleet-global heavy flow keys: every node carries a share every
    epoch, so cluster totals exist on no single node."""
    rng = np.random.default_rng((int(run_seed), 999_999))
    return rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)


def epoch_traffic(
    run_seed: int, node_index: int, epoch: int,
    n_heavy: int, n_light: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(keys (B, 4) uint32, weights (B,) int64) for one node-epoch.

    Seeded by (run_seed, node_index, epoch): any party — the child that
    ships it, the parent that scores it, a respawned replacement after
    a restart — regenerates the identical stream.
    """
    rng = np.random.default_rng(
        (int(run_seed), int(node_index), int(epoch))
    )
    hk = heavy_keys(run_seed, n_heavy)
    hw = rng.integers(100, 200, size=n_heavy)
    lkeys = rng.integers(0, 2**32, size=(n_light, 4), dtype=np.uint32)
    lw = rng.integers(1, 4, size=n_light)
    keys = np.concatenate([hk, lkeys])
    w = np.concatenate([hw, lw]).astype(np.int64)
    return keys, w


def exact_counter(
    run_seed: int, node_index: int, epoch: int,
    n_heavy: int, n_light: int,
) -> Counter:
    """Exact per-flow Counter for one node-epoch (scoring side)."""
    keys, w = epoch_traffic(run_seed, node_index, epoch, n_heavy, n_light)
    c: Counter = Counter()
    for row, wt in zip(keys, w):
        c[tuple(int(x) for x in row)] += int(wt)
    return c
