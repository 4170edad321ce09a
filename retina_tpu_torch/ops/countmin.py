"""Count-Min sketch (port of retina_tpu/ops/countmin.py).

State is a (depth, width) int32 table of u32 counts. ``update`` and
``query`` here are plain PyTorch: they are the Count-Min half of the plain
version of K2 (``kernels/csrc/hh_update.cu``), which the pipeline reaches
through ``HeavyHitterSketch.update``.
"""

from __future__ import annotations

import dataclasses

import torch

from retina_tpu_torch.ops.hashing import hash_cols, reduce_range
from retina_tpu_torch.u32 import M32, narrow, widen


def indices(table: torch.Tensor, seed: int, key_cols: list[torch.Tensor]) -> torch.Tensor:
    """(B,) key columns -> (depth, B) int64 column indices."""
    d, w = table.shape
    seeds = (
        torch.arange(1, d + 1, dtype=torch.int64, device=table.device) + seed
    ).reshape(d, 1)
    return reduce_range(hash_cols([c[None, :] for c in key_cols], seeds), w)


def update_plain(table: torch.Tensor, seed: int, key_cols: list[torch.Tensor],
                 weights: torch.Tensor) -> None:
    """Add u32 ``weights`` at the keys into every row, in place (wraps)."""
    d, w = table.shape
    cols = indices(table, seed, key_cols)
    flat = cols + (torch.arange(d, device=table.device) * w)[:, None]
    wts = narrow(widen(weights)).expand(d, -1)
    table.view(-1).index_add_(0, flat.reshape(-1), wts.reshape(-1))


def query_plain(table: torch.Tensor, seed: int, key_cols: list[torch.Tensor]) -> torch.Tensor:
    """(B,) int64 point estimates: min over the rows."""
    cols = indices(table, seed, key_cols)
    return widen(torch.gather(table, 1, cols)).min(dim=0).values


@dataclasses.dataclass
class CountMinSketch:
    """Plain Count-Min: table (depth, width) u32 counts."""

    table: torch.Tensor
    seed: int = 0

    @classmethod
    def zeros(cls, depth: int = 4, width: int = 1 << 15, seed: int = 0,
              device: torch.device | str = "cpu") -> "CountMinSketch":
        if width & (width - 1):
            raise ValueError("width must be a power of two")
        return cls(torch.zeros((depth, width), dtype=torch.int32, device=device), seed)

    @property
    def depth(self) -> int:
        return int(self.table.shape[0])

    @property
    def width(self) -> int:
        return int(self.table.shape[1])

    def update(self, key_cols: list[torch.Tensor], weights: torch.Tensor) -> "CountMinSketch":
        """Add ``weights`` (masked rows carry 0) at the keys, in place."""
        update_plain(self.table, self.seed, key_cols, weights)
        return self

    def query(self, key_cols: list[torch.Tensor]) -> torch.Tensor:
        return query_plain(self.table, self.seed, key_cols)

    def reset(self) -> "CountMinSketch":
        self.table.zero_()
        return self

    def total(self) -> torch.Tensor:
        """Total inserted weight mod 2^32 (row 0 sum)."""
        return widen(self.table[0]).sum() & M32
