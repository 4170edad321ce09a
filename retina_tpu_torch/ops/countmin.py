"""Count-Min sketch (port of retina_tpu/ops/countmin.py).

State is a (depth, width) int32 table of u32 counts. ``update_plain`` and
``query_plain`` are the Count-Min half of the plain version of K2
(``kernels/csrc/hh_update.cu``), which the pipeline reaches through
``HeavyHitterSketch.update``. ``CountMinSketch.query`` goes through K10
(``kernels/csrc/cms_query.cu``), whose plain version is ``query_plain``,
and so do the verified decodes (``kops.cms_query_many``: several queries
and ``decode_verified``'s filter in one launch), whose plain version is
``query_many_plain``;
``CountMinSketch.update`` and ``cms_update_jit`` (row 12 of the device
programs, the reference's standalone jitted update) through K2's add phase
alone (``cms_update`` in ``kernels/csrc/hh_update.cu``), whose plain
version is ``update_plain``.
``merge`` is the reference's elementwise add (wrapping), in torch ops; the
N-way fold of many tables is K8 (``timetravel/fold.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.kernels import ops as kops
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


def query_many_plain(jobs) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kops.cms_query_many``: per job (table, seed,
    key_cols, ok, min_weight) the point estimates, then ``decode_verified``'s
    filter (ok & est >= min_weight, unsigned; est where ok, else 0) with a
    missing mask taken as all true; (est int32, ok bool) of the jobs end to
    end."""
    ests, oks = [], []
    for table, seed, key_cols, ok, min_weight in jobs:
        est = query_plain(table, seed, key_cols)
        keep = est >= (int(min_weight) & M32)
        if ok is not None:
            keep = ok & keep
        ests.append(narrow(torch.where(keep, est, 0)))
        oks.append(keep)
    return torch.cat(ests), torch.cat(oks)


@dataclasses.dataclass
class CountMinSketch:
    """Plain Count-Min: table (depth, width) u32 counts."""

    table: torch.Tensor
    seed: int = 0

    @classmethod
    def zeros(cls, depth: int = 4, width: int = 1 << 15, seed: int = 0,
              device: torch.device | str | None = None) -> "CountMinSketch":
        if width & (width - 1):
            raise ValueError("width must be a power of two")
        return cls(torch.zeros((depth, width), dtype=torch.int32,
                               device=resolve_device(device)), seed)

    @property
    def depth(self) -> int:
        return int(self.table.shape[0])

    @property
    def width(self) -> int:
        return int(self.table.shape[1])

    def update(self, key_cols: list[torch.Tensor], weights: torch.Tensor) -> "CountMinSketch":
        """Add u32 ``weights`` (masked rows carry 0) at the (B,) key columns
        (int32 bit patterns), in place."""
        kops.cms_update(self.table, self.seed, key_cols, weights)
        return self

    def query(self, key_cols: list[torch.Tensor]) -> torch.Tensor:
        """(B,) int64 point estimates of (B,) integer key columns (u32
        values), through K10, which reads int32 bit patterns."""
        cols = [c if c.dtype == torch.int32 else narrow(c) for c in key_cols]
        return widen(kops.cms_query(self.table, self.seed, cols))

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        """Elementwise add (u32, wrapping): a new sketch."""
        return dataclasses.replace(self, table=self.table + other.table)

    def reset(self) -> "CountMinSketch":
        self.table.zero_()
        return self

    def total(self) -> torch.Tensor:
        """Total inserted weight mod 2^32 (row 0 sum)."""
        return widen(self.table[0]).sum() & M32


def cms_update_jit(sketch: CountMinSketch, key_cols: list[torch.Tensor],
                   weights: torch.Tensor) -> CountMinSketch:
    """The standalone update (the reference's jit donates the old table; the
    port updates it in place) through ``cms_update``."""
    return sketch.update(key_cols, weights)
