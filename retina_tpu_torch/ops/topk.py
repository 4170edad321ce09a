"""Heavy-hitter candidate tracking (port of retina_tpu/ops/topk.py).

A Count-Min sketch absorbs every event; a slot table keeps, per hash
slot, the best key seen so far with its CMS estimate. Per batch: scatter-max
the estimates into the slot counts, then the rows whose estimate equals
their slot's new count write their key row.

Where several rows win one slot (equal estimates), the reference leaves the
winner unspecified. The port fixes one rule, in the kernel and in the plain
version alike: **the last winning row in batch order writes the slot**.
Any winner is a valid candidate of equal count.

``TopKTable.merge`` is the reference's join: per slot the greater (count,
key row) pair, compared as u32, count first, then the key columns in
order. The port holds u32 as int32 bit patterns, so every compare widens
to int64 first; a signed compare would flip keys with the top bit set.
The order is total, so N tables chained pairwise give the per-slot
maximum over N: ``topk_join_plain`` chains the merges, and K9
(``kernels/csrc/topk_join.cu``) takes the maximum in one pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from retina_tpu_torch._device import resolve_device
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


def _take_other(counts_a: torch.Tensor, keys_a: torch.Tensor, counts_b: torch.Tensor,
                keys_b: torch.Tensor) -> torch.Tensor:
    """(S,) bool: slot s takes b's (count, key row), the greater under the
    unsigned lexicographic order of the reference's merge."""
    a_c, b_c = widen(counts_a), widen(counts_b)
    ka, kb = widen(keys_a), widen(keys_b)
    diff = ka != kb
    first = diff.to(torch.int32).argmax(dim=1, keepdim=True)  # first differing column
    b_key_greater = diff.any(dim=1) & (kb.gather(1, first)[:, 0] > ka.gather(1, first)[:, 0])
    return (b_c > a_c) | ((b_c == a_c) & b_key_greater)


def topk_join_plain(keys: torch.Tensor, counts: torch.Tensor,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: (N, S, C) keys and (N, S) counts joined by the
    reference's pairwise merge, chained over the N tables in order."""
    out_keys, out_counts = keys[0].clone(), counts[0].clone()
    for k in range(1, keys.shape[0]):
        take = _take_other(out_counts, out_keys, counts[k], keys[k])
        out_keys = torch.where(take[:, None], keys[k], out_keys)
        out_counts = torch.where(take, counts[k], out_counts)
    return out_keys, out_counts


@dataclasses.dataclass
class TopKTable:
    """Candidate table: (S, C) key rows + (S,) estimated counts, u32."""

    key_rows: torch.Tensor
    counts: torch.Tensor
    seed: int = 0

    @classmethod
    def zeros(cls, n_key_cols: int, n_slots: int = 1 << 11, seed: int = 0,
              device: torch.device | str | None = None) -> "TopKTable":
        if n_slots & (n_slots - 1):
            raise ValueError("n_slots must be a power of two")
        device = resolve_device(device)
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

    def merge(self, other: "TopKTable") -> "TopKTable":
        """The join of two tables of one seed: per slot the greater (count,
        key row) under the unsigned order (see the module docstring)."""
        if self.seed != other.seed:
            raise ValueError(f"TopKTable seed mismatch: {self.seed} != {other.seed}")
        take = _take_other(self.counts, self.key_rows, other.counts, other.key_rows)
        return dataclasses.replace(
            self,
            key_rows=torch.where(take[:, None], other.key_rows, self.key_rows),
            counts=torch.where(take, other.counts, self.counts),
        )

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
              device: torch.device | str | None = None) -> "HeavyHitterSketch":
        device = resolve_device(device)
        return cls(
            cms=CountMinSketch.zeros(depth, width, seed=seed, device=device),
            table=TopKTable.zeros(n_key_cols, n_slots, seed=seed, device=device),
        )

    def update(self, key_cols: list[torch.Tensor], weights: torch.Tensor) -> "HeavyHitterSketch":
        """One batch through K2, in place."""
        update_many([(self, key_cols, weights)])
        return self

    def merge(self, other: "HeavyHitterSketch") -> "HeavyHitterSketch":
        """CMS tables add; candidate tables join."""
        return HeavyHitterSketch(cms=self.cms.merge(other.cms),
                                 table=self.table.merge(other.table))

    def reset(self) -> "HeavyHitterSketch":
        self.cms.reset()
        self.table.reset()
        return self


def update_many(updates: list[tuple[HeavyHitterSketch, list[torch.Tensor], torch.Tensor]],
                ) -> None:
    """Up to three sketches, each with its (B,) key columns and weights of
    one batch, through one call of K2 (three launches in all), in place;
    each ends as its own ``update`` would leave it."""
    kops.hh_update_many([(hh.cms.table, hh.cms.seed, hh.table.key_rows, hh.table.counts,
                          hh.table.seed, cols, w) for hh, cols, w in updates])
