"""Heavy-hitter candidate tracking (port of retina_tpu/ops/topk.py).

A Count-Min sketch absorbs every event; a slot table keeps, per hash
slot, the best key seen so far with its CMS estimate. Per batch: scatter-max
the estimates into the slot counts, then the rows whose estimate equals
their slot's new count write their key row.

Where several rows win one slot (equal estimates), the reference leaves the
winner unspecified. The port fixes one rule, in the kernel and in the plain
version alike: **the last winning row in batch order writes the slot**.
Any winner is a valid candidate of equal count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.ops.countmin import CountMinSketch, query_plain, update_plain
from retina_tpu_torch.ops.hashing import hash_cols, reduce_range
from retina_tpu_torch.u32 import narrow, to_numpy, widen


def slots(n_slots: int, seed: int, key_cols: list[torch.Tensor]) -> torch.Tensor:
    """(B,) int64 slot of each key."""
    return reduce_range(hash_cols(key_cols, 0x70CC + seed), n_slots)


def table_update_plain(key_rows: torch.Tensor, counts: torch.Tensor, seed: int,
                       key_cols: list[torch.Tensor], estimates: torch.Tensor) -> None:
    """Offer (B,) keys with u32 ``estimates`` (0 for masked rows), in place."""
    s = counts.shape[0]
    slot = slots(s, seed, key_cols)
    est = widen(estimates)
    new = widen(counts).scatter_reduce(0, slot, est, "amax")
    win = (est == new[slot]) & (est > 0)
    rows = torch.arange(est.shape[0], device=est.device)
    winner = torch.full((s,), -1, dtype=torch.int64, device=est.device)
    winner.scatter_reduce_(0, slot, torch.where(win, rows, -1), "amax")
    has = winner >= 0
    keys = torch.stack([narrow(widen(c)) for c in key_cols], dim=1)
    key_rows.copy_(torch.where(has[:, None], keys[winner.clamp(min=0)], key_rows))
    counts.copy_(narrow(new))


def hh_update_plain(cms_table: torch.Tensor, cms_seed: int, key_rows: torch.Tensor,
                    counts: torch.Tensor, table_seed: int,
                    key_cols: list[torch.Tensor], weights: torch.Tensor) -> None:
    """Plain version of K2 (kernels/csrc/hh_update.cu)."""
    update_plain(cms_table, cms_seed, key_cols, weights)
    est = query_plain(cms_table, cms_seed, key_cols)
    est = torch.where(widen(weights) > 0, est, 0)
    table_update_plain(key_rows, counts, table_seed, key_cols, est)


@dataclasses.dataclass
class TopKTable:
    """Candidate table: (S, C) key rows + (S,) estimated counts, u32."""

    key_rows: torch.Tensor
    counts: torch.Tensor
    seed: int = 0

    @classmethod
    def zeros(cls, n_key_cols: int, n_slots: int = 1 << 11, seed: int = 0,
              device: torch.device | str = "cpu") -> "TopKTable":
        if n_slots & (n_slots - 1):
            raise ValueError("n_slots must be a power of two")
        return cls(
            key_rows=torch.zeros((n_slots, n_key_cols), dtype=torch.int32, device=device),
            counts=torch.zeros((n_slots,), dtype=torch.int32, device=device),
            seed=seed,
        )

    @property
    def n_slots(self) -> int:
        return int(self.counts.shape[0])

    def update(self, key_cols: list[torch.Tensor], estimates: torch.Tensor) -> "TopKTable":
        """Offer (B,) keys with CMS ``estimates`` (0 for masked rows)."""
        table_update_plain(self.key_rows, self.counts, self.seed, key_cols, estimates)
        return self

    def top_k_host(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Host-side reconciliation: (keys (k', C), counts (k',)) u32."""
        counts = to_numpy(self.counts)
        keys = to_numpy(self.key_rows)
        order = np.argsort(counts)[::-1][:k]
        sel = counts[order] > 0
        return keys[order][sel], counts[order][sel]

    def reset(self) -> "TopKTable":
        self.key_rows.zero_()
        self.counts.zero_()
        return self


@dataclasses.dataclass
class HeavyHitterSketch:
    """CMS + candidate table glued into one streaming top-k tracker."""

    cms: CountMinSketch
    table: TopKTable

    @classmethod
    def zeros(cls, n_key_cols: int, depth: int = 4, width: int = 1 << 15,
              n_slots: int = 1 << 11, seed: int = 0,
              device: torch.device | str = "cpu") -> "HeavyHitterSketch":
        return cls(
            cms=CountMinSketch.zeros(depth, width, seed=seed, device=device),
            table=TopKTable.zeros(n_key_cols, n_slots, seed=seed, device=device),
        )

    def update(self, key_cols: list[torch.Tensor], weights: torch.Tensor) -> "HeavyHitterSketch":
        """One batch through K2, in place."""
        kops.hh_update(self.cms.table, self.cms.seed, self.table.key_rows,
                       self.table.counts, self.table.seed, key_cols, weights)
        return self

    def reset(self) -> "HeavyHitterSketch":
        self.cms.reset()
        self.table.reset()
        return self
