"""HyperLogLog register banks (port of retina_tpu/ops/hyperloglog.py).

A (G, 2^p) u32 bank holds G independent sketches. ``update`` goes through
K3 (``kernels/csrc/hll_update.cu``); ``update_plain`` is its plain version.
``update_many`` updates up to three banks of one batch in one launch of K3.
``estimate`` goes through K17 (``kernels/csrc/snapshot_readout.cu``);
``estimate_plain`` is its plain version. ``merge`` is the reference's
elementwise u32 max, in torch ops.
"""

from __future__ import annotations

import dataclasses

import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.ops.hashing import hash_cols, reduce_range
from retina_tpu_torch.u32 import M32, narrow, widen


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def update_plain(registers: torch.Tensor, seed: int, key_cols: list[torch.Tensor],
                 group: torch.Tensor | None, mask: torch.Tensor) -> None:
    """Plain version of K3, in place: scatter-max rho into
    registers[group, low p bits of the hash]; masked rows are rho 0 and
    indices past the bank are dropped."""
    g, m = registers.shape
    p = m.bit_length() - 1
    h = hash_cols(key_cols, 0xC0FFEE + seed)
    rest = h >> p
    # floor(log2(rest)) exactly: frexp of a float64 (exact below 2^53)
    # gives rest = f * 2^e with f in [0.5, 1); rest == 0 gives e == 0.
    hsb = torch.frexp(rest.to(torch.float64)).exponent.to(torch.int64) - 1
    rho = torch.where(mask != 0, (32 - p) - hsb, 0)
    grp = widen(group) if group is not None else 0
    flat = (grp * m + reduce_range(h, m)) & M32
    keep = flat < g * m
    registers.view(-1).scatter_reduce_(
        0, torch.where(keep, flat, 0), torch.where(keep, rho, 0).to(torch.int32), "amax"
    )


def estimate_plain(registers: torch.Tensor) -> torch.Tensor:
    """Plain version of K17's estimate: (G,) float32 cardinalities of a
    (G, m) register bank, with the small-range (linear counting)
    correction."""
    m = int(registers.shape[1])
    regs = registers.to(torch.float32)
    raw = _alpha(m) * m * m / torch.exp2(-regs).sum(dim=1)
    zeros = (registers == 0).sum(dim=1).to(torch.float32)
    lc = m * torch.log(m / torch.clamp(zeros, min=1e-9))
    use_lc = (raw <= 2.5 * m) & (zeros > 0)
    return torch.where(use_lc, lc, raw)


@dataclasses.dataclass
class HyperLogLog:
    """Bank of G HLL sketches with M = 2^p registers each."""

    registers: torch.Tensor  # (G, M) int32, values 0..33
    seed: int = 0

    @classmethod
    def zeros(cls, n_groups: int = 1, precision: int = 12, seed: int = 0,
              device: torch.device | str | None = None) -> "HyperLogLog":
        return cls(torch.zeros((n_groups, 1 << precision), dtype=torch.int32,
                               device=resolve_device(device)), seed)

    @property
    def n_groups(self) -> int:
        return int(self.registers.shape[0])

    @property
    def m(self) -> int:
        return int(self.registers.shape[1])

    def update(self, key_cols: list[torch.Tensor], group: torch.Tensor | None,
               mask: torch.Tensor) -> "HyperLogLog":
        """Observe (B,) keys in (B,) group slots (None: group 0); rows with
        mask 0 are skipped. In place, through K3."""
        kops.hll_update(self.registers, self.seed, key_cols, group, mask)
        return self

    def estimate(self) -> torch.Tensor:
        """(G,) float32 cardinality estimates with small-range correction
        (K17)."""
        return kops.hll_estimate(self.registers)

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        """Register-wise u32 max: a new bank."""
        return dataclasses.replace(
            self, registers=narrow(torch.maximum(widen(self.registers), widen(other.registers))))

    def reset(self) -> "HyperLogLog":
        self.registers.zero_()
        return self


def update_many(updates: list[tuple[HyperLogLog, list[torch.Tensor], torch.Tensor | None,
                                    torch.Tensor, torch.Tensor | None]]) -> None:
    """Up to three banks, each with its (B,) key columns, group (None: group
    0), mask and second mask (ANDed with the first; None: none) of one
    batch, through one launch of K3, in place; each ends as its own
    ``update`` with the mask ``mask & mask2`` would leave it."""
    kops.hll_update_many([(h.registers, h.seed, cols, group, mask, mask2)
                          for h, cols, group, mask, mask2 in updates])
