"""Streaming entropy over hashed histograms (port of retina_tpu/ops/entropy.py).

``EntropyWindow`` is a (G, K) float32 bank of hashed histograms for one
window. Its ``update`` takes one key column per group and fills every group
in one pass through K4 (``kernels/csrc/entropy_update.cu``): it is the
reference's per-group ``update`` calls of the pipeline step (src IP into
group 0, dst IP into 1, dst port into 2) made at once. ``entropy_bits``
goes through K16's read-only entry (``kernels/csrc/window_close.cu``);
``entropy_bits_plain`` is its plain version. ``merge`` adds two windows'
histograms (torch ops). ``AnomalyEWMA`` keeps the per-group EWMA baseline
and flags z-score outliers; its ``observe`` is the plain version of K16's
EWMA (the window close runs it in the kernel) and the detector bank's
baseline.
"""

from __future__ import annotations

import dataclasses

import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.ops.hashing import hash_cols, reduce_range
from retina_tpu_torch.u32 import widen


def update_plain(counts: torch.Tensor, seed: int, key_cols: list[torch.Tensor],
                 weights: torch.Tensor) -> None:
    """Plain version of K4, in place: group g adds the u32 weights,
    converted to f32, at the hash of key column g."""
    k = counts.shape[1]
    w = widen(weights).to(torch.float32)
    for g, col in enumerate(key_cols):
        idx = reduce_range(hash_cols([col], 0xE17209 + seed), k)
        counts[g].index_add_(0, idx, w)


def entropy_bits_plain(counts: torch.Tensor) -> torch.Tensor:
    """Plain version of K16's bits: (G,) plug-in Shannon entropy in bits of
    each row of a (G, K) float32 histogram bank, summed in float64 and
    rounded to float32 once, as K16 does, so that the two agree bit for bit
    however each groups its sums."""
    c = counts.double()
    n = c.sum(dim=1, keepdim=True)
    p = c / torch.clamp(n, min=1.0)
    terms = torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-30)), 0.0)
    return (-terms.sum(dim=1)).float()


@dataclasses.dataclass
class EntropyWindow:
    """Bank of G hashed histograms, (G, K) float32 counts for one window."""

    counts: torch.Tensor
    seed: int = 0

    @classmethod
    def zeros(cls, n_groups: int = 1, n_buckets: int = 1 << 12, seed: int = 0,
              device: torch.device | str | None = None) -> "EntropyWindow":
        return cls(torch.zeros((n_groups, n_buckets), dtype=torch.float32,
                               device=resolve_device(device)), seed)

    @property
    def n_buckets(self) -> int:
        return int(self.counts.shape[1])

    def update(self, key_cols: list[torch.Tensor], weights: torch.Tensor) -> "EntropyWindow":
        """Group g hashes ``key_cols[g]``; every group takes ``weights``."""
        kops.entropy_update(self.counts, self.seed, key_cols, weights)
        return self

    def entropy_bits(self) -> torch.Tensor:
        """(G,) plug-in Shannon entropy in bits of each histogram (K16)."""
        return kops.entropy_bits(self.counts)

    def merge(self, other: "EntropyWindow") -> "EntropyWindow":
        """Elementwise float32 add: a new window."""
        return dataclasses.replace(self, counts=self.counts + other.counts)

    def reset(self) -> "EntropyWindow":
        self.counts.zero_()
        return self


@dataclasses.dataclass
class AnomalyEWMA:
    """Per-group EWMA + variance tracker for entropy z-score flags."""

    mean: torch.Tensor  # (G,) float32
    var: torch.Tensor  # (G,) float32
    n_obs: torch.Tensor  # (G,) float32 windows observed
    alpha: float = 0.1

    @classmethod
    def zeros(cls, n_groups: int = 1, alpha: float = 0.1,
              device: torch.device | str | None = None) -> "AnomalyEWMA":
        device = resolve_device(device)
        z = lambda: torch.zeros((n_groups,), dtype=torch.float32, device=device)
        return cls(mean=z(), var=z(), n_obs=z(), alpha=alpha)

    def observe(self, h: torch.Tensor, z_thresh: float = 4.0, min_windows: int = 10,
                active: torch.Tensor | bool = True,
                ) -> tuple["AnomalyEWMA", torch.Tensor, torch.Tensor]:
        """Returns (new_state, anomaly_flags (G,) bool, z_scores (G,)).

        Idle windows (``active`` False) are skipped entirely: no flag, no
        baseline update, no warmup credit. Anomalous windows do not enter
        the baseline; the first observation seeds the mean outright."""
        active = torch.broadcast_to(torch.as_tensor(active, device=h.device), h.shape)
        warm = self.n_obs >= min_windows
        std = torch.sqrt(torch.clamp(self.var, min=1e-12))
        z = torch.where(warm & active, (h - self.mean) / torch.clamp(std, min=1e-3),
                        torch.zeros_like(h))
        flag = warm & active & (z.abs() > z_thresh)
        first = self.n_obs == 0
        a = torch.where(
            flag | ~active, torch.zeros_like(h),
            torch.where(first, torch.ones_like(h), torch.full_like(h, self.alpha)),
        )
        delta = h - self.mean
        new_mean = self.mean + a * delta
        new_var = torch.where(first & active, torch.zeros_like(h),
                              (1 - a) * (self.var + a * delta * delta))
        return (
            AnomalyEWMA(mean=new_mean, var=new_var,
                        n_obs=self.n_obs + active.to(self.n_obs.dtype), alpha=self.alpha),
            flag,
            z,
        )
