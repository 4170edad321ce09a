"""32-bit hashing, bit-identical to retina_tpu/ops/hashing.py.

These are the plain versions of ``kernels/csrc/hash.cuh``: murmur3's fmix32
finalizer over boost-style combined u32 columns, reduced onto a power-of-two
range by a mask. The torch functions take int32 bit patterns or int64 u32
values and return int64 values in [0, 2^32); products are split so no
int64 product overflows. The ``*_np`` functions, the numpy mirror, live
in ``hashing_np.py`` (no torch import) and are re-exported here.
"""

from __future__ import annotations

import torch

from retina_tpu_torch.ops.hashing_np import (  # noqa: F401 (the numpy mirror)
    PHI32,
    fmix32_np,
    hash_cols_np,
    reduce_range_np,
)
from retina_tpu_torch.u32 import M32, widen


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) without an int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer: full-avalanche 32-bit mix."""
    x = widen(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_cols(cols: list[torch.Tensor], seed) -> torch.Tensor:
    """Hash several u32 columns into one, elementwise.

    ``seed`` is an int or an integer tensor broadcastable against the
    columns, so an (R, 1) seed tensor yields R independent hashes of a
    (B,) batch in one pass.
    """
    if isinstance(seed, torch.Tensor):
        h = _mul32(widen(seed), PHI32)
    else:
        h = (int(seed) * PHI32) & M32
    for c in cols:
        c = widen(c)
        h = fmix32(h ^ ((c + PHI32 + (h << 6) + (h >> 2)) & M32))
    return h


def hash_family(key: torch.Tensor, n_hashes: int, seed: int = 0) -> torch.Tensor:
    """(B,) u32 keys -> (n_hashes, B) independent u32 hashes."""
    seeds = (
        torch.arange(1, n_hashes + 1, dtype=torch.int64, device=key.device) + seed
    ).reshape(n_hashes, 1)
    return hash_cols([key[None, :]], seeds)


def reduce_range(h: torch.Tensor, width: int) -> torch.Tensor:
    """Map u32 hashes onto [0, width), width a power of two."""
    if width & (width - 1):
        raise ValueError(f"width must be a power of two, got {width}")
    return h & (width - 1)
