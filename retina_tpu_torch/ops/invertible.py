"""Invertible sketch: recover heavy-flow keys from counter state (port of
retina_tpu/ops/invertible.py).

  planes  (D, W, 32(C+1)) u32  planes[d, w, b] += weight for every update
                               whose key (C u32 columns, then a 32-bit
                               checksum of them) has bit b set
  weights (D, W)          u32  total update weight per bucket

``update`` is K6 (``kernels/csrc/inv_update.cu``; plain version
``update_plain``); ``update_pair`` runs it once for two sketches of a batch
whose rows a selector lane splits (plain version ``update_pair_plain``).
``decode`` is K15 (``kernels/csrc/inv_decode.cu``; plain version
``decode_plain``, and ``decode_many_plain`` for its entry that decodes a
window close's or a range query's regions in one launch): one pass over the
D·W buckets. A bucket where one key owns a strict majority of the weight
yields that key bit by bit (majorities compared as u32); it is accepted
only if its checksum matches and it re-hashes to its own bucket.
``merge`` adds two sketches of one seed (torch ops, wrapping);
``decode_verified`` counts and filters its keys through one job of the CMS
query, K10 (``kops.cms_query_many``).
"""

from __future__ import annotations

import dataclasses

import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.ops.hashing import hash_cols, reduce_range
from retina_tpu_torch.u32 import M32, narrow, widen

CHECK_BITS = 32
# Seed offset of the checksum plane: differs from every row seed, so the
# checksum bits are independent of the bucket placement.
CHECK_SEED = 0x1C3A9F71


def n_planes(n_key_cols: int) -> int:
    """Total bit planes for C u32 key columns + the checksum plane."""
    return 32 * n_key_cols + CHECK_BITS


def indices(depth: int, width: int, seed: int, key_cols: list[torch.Tensor]) -> torch.Tensor:
    """(R,) key columns -> (depth, R) int64 bucket indices."""
    dev = key_cols[0].device
    seeds = ((torch.arange(1, depth + 1, dtype=torch.int64, device=dev) + seed) & M32
             ).reshape(depth, 1)
    return reduce_range(hash_cols([c[None, :] for c in key_cols], seeds), width)


def bits(key_cols: list[torch.Tensor], seed: int) -> torch.Tensor:
    """(R,) key columns -> (R, 32(C+1)) int64 0/1: key bits, then checksum bits."""
    shifts = torch.arange(32, dtype=torch.int64, device=key_cols[0].device)
    check = hash_cols(key_cols, (CHECK_SEED + seed) & M32)
    return torch.cat([(widen(c)[:, None] >> shifts) & 1 for c in [*key_cols, check]], dim=1)


def update_plain(planes: torch.Tensor, weights_table: torch.Tensor, seed: int,
                 key_cols: list[torch.Tensor], weights: torch.Tensor) -> None:
    """Plain version of K6: add ``weights`` at the keys, in place (wraps).
    Rows of weight 0 add nothing, so they are dropped first."""
    d, w, nb = planes.shape
    keep = torch.nonzero(weights != 0).squeeze(1)
    key_cols = [c[keep] for c in key_cols]
    wts = widen(weights[keep])
    flat = (indices(d, w, seed, key_cols)
            + (torch.arange(d, device=planes.device) * w)[:, None]).reshape(-1)
    vals = narrow(bits(key_cols, seed) * wts[:, None])
    planes.view(-1, nb).index_add_(0, flat, vals.repeat(d, 1))
    weights_table.view(-1).index_add_(0, flat, narrow(wts).repeat(d))


def update_pair_plain(regions: list[tuple[torch.Tensor, torch.Tensor, int]],
                      key_cols: list[torch.Tensor], weights: torch.Tensor,
                      select: torch.Tensor | None) -> None:
    """Plain version of K6 over one or two (planes, weights, seed) regions,
    in place: with two, rows whose ``select`` is not 0 add to the second and
    the rest to the first, as the reference step's two updates under
    ``where(is_priority, ...)``; with one, every row adds to it."""
    if select is None:
        (planes, weights_table, seed), = regions
        return update_plain(planes, weights_table, seed, key_cols, weights)
    pick = select != 0
    for (planes, weights_table, seed), w in zip(
            regions, (torch.where(pick, 0, weights), torch.where(pick, weights, 0))):
        update_plain(planes, weights_table, seed, key_cols, w)


def decode_plain(planes: torch.Tensor, weights: torch.Tensor, seed: int,
                 n_key_cols: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K15: the majority key of every bucket as (cols
    (C, D*W) int32, ok bool (D*W,)); see kernels.ops.inv_decode."""
    d, w, _ = planes.shape
    p = widen(planes)
    maj = (p > ((widen(weights)[:, :, None] - p) & M32)).to(torch.int64)
    shifts = 1 << torch.arange(32, dtype=torch.int64, device=p.device)
    words = [(maj[:, :, 32 * i: 32 * (i + 1)] * shifts).sum(dim=2).reshape(-1)
             for i in range(n_key_cols + 1)]
    cols, check = words[:-1], words[-1]
    check_ok = check == hash_cols(cols, (CHECK_SEED + seed) & M32)
    rehash = indices(d, w, seed, cols)  # (d, d*w)
    own_row = torch.arange(d, device=p.device).repeat_interleave(w)
    own_idx = rehash[own_row, torch.arange(d * w, device=p.device)]
    bucket_pos = torch.arange(w, device=p.device).repeat(d)
    ok = (weights.reshape(-1) != 0) & check_ok & (own_idx == bucket_pos)
    return narrow(torch.stack(cols)), ok


def decode_many_plain(regions: list[tuple[torch.Tensor, torch.Tensor, int, int]],
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K15's many-region entry: each region (planes,
    weights, seed, tier) decoded by ``decode_plain``, end to end as (keys
    (M, C) int32, ok (M,) bool, tier (M,) int32); see
    kernels.ops.inv_decode_many."""
    keys, oks, tiers = [], [], []
    for planes, weights, seed, tier in regions:
        n_key_cols = planes.shape[2] // 32 - 1
        cols, ok = decode_plain(planes, weights, int(seed) & M32, n_key_cols)
        keys.append(cols.t())
        oks.append(ok)
        tiers.append(torch.full(ok.shape, int(tier), dtype=torch.int32, device=ok.device))
    return torch.cat(keys), torch.cat(oks), torch.cat(tiers)


@dataclasses.dataclass
class InvertibleSketch:
    """Bit-plane invertible sketch over C-column u32 keys."""

    planes: torch.Tensor  # (D, W, 32(C+1)) u32
    weights: torch.Tensor  # (D, W) u32
    seed: int = 0

    @classmethod
    def zeros(cls, depth: int = 2, width: int = 1 << 12, n_key_cols: int = 4,
              seed: int = 0, device: torch.device | str | None = None) -> "InvertibleSketch":
        if width & (width - 1):
            raise ValueError("width must be a power of two")
        device = resolve_device(device)
        return cls(
            planes=torch.zeros((depth, width, n_planes(n_key_cols)), dtype=torch.int32,
                               device=device),
            weights=torch.zeros((depth, width), dtype=torch.int32, device=device),
            seed=seed,
        )

    @property
    def n_key_cols(self) -> int:
        return (int(self.planes.shape[2]) - CHECK_BITS) // 32

    def update(self, key_cols: list[torch.Tensor], weights: torch.Tensor) -> "InvertibleSketch":
        """Add ``weights`` (masked rows carry 0) at the keys through K6, in place."""
        kops.inv_update(self.planes, self.weights, self.seed, key_cols, weights)
        return self

    def decode(self) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
        """Majority key of every bucket: (key_cols [C int32 (D*W,)], weight
        int32 (D*W,), ok bool (D*W,)). ``ok`` marks buckets whose key
        passed the checksum and re-hashes to its own bucket (K15)."""
        cols, ok = kops.inv_decode(self.planes, self.weights, self.seed, self.n_key_cols)
        return list(cols), self.weights.reshape(-1).clone(), ok

    def merge(self, other: "InvertibleSketch") -> "InvertibleSketch":
        """Elementwise add (u32, wrapping) of two sketches of one seed."""
        if self.seed != other.seed:
            raise ValueError(f"invertible seed mismatch: {self.seed} != {other.seed}")
        return dataclasses.replace(self, planes=self.planes + other.planes,
                                   weights=self.weights + other.weights)

    def reset(self) -> "InvertibleSketch":
        self.planes.zero_()
        self.weights.zero_()
        return self


def update_pair(lo: InvertibleSketch, hi: InvertibleSketch, key_cols: list[torch.Tensor],
                weights: torch.Tensor, select: torch.Tensor) -> None:
    """Add ``weights`` at the keys, in place, through one call of K6: rows
    whose ``select`` is not 0 to ``hi``, the rest to ``lo``."""
    kops.inv_update_pair([(lo.planes, lo.weights, lo.seed), (hi.planes, hi.weights, hi.seed)],
                         key_cols, weights, select)


def decode_verified(inv: InvertibleSketch, cms, min_weight: int = 0,
                    ) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Decode, then verify against a CMS over the same key columns: the
    count is the CMS point estimate, and keys whose estimate is under
    ``min_weight`` are rejected. Returns (key_cols, est int32 (D*W,),
    ok (D*W,)). The query and the filter are one job of K10
    (``kops.cms_query_many``)."""
    cols, ok = kops.inv_decode(inv.planes, inv.weights, inv.seed, inv.n_key_cols)
    cols = list(cols)
    est, ok = kops.cms_query_many([(cms.table, cms.seed, cols, ok, min_weight)])
    return cols, est, ok
