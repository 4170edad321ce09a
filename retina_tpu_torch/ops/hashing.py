"""32-bit hashing, bit-identical to retina_tpu/ops/hashing.py.

These are the plain versions of ``kernels/csrc/hash.cuh``: murmur3's fmix32
finalizer over boost-style combined u32 columns, reduced onto a power-of-two
range by a mask. The torch functions take int32 bit patterns or int64 u32
values and return int64 values in [0, 2^32); products are split so no
int64 product overflows. The ``*_np`` functions are the numpy mirror.
"""

from __future__ import annotations

import numpy as np
import torch

from retina_tpu_torch.u32 import M32, widen

PHI32 = 0x9E3779B9


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


# -- numpy mirror --------------------------------------------------------


def fmix32_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x = x ^ (x >> np.uint32(13))
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    return x ^ (x >> np.uint32(16))


def hash_cols_np(cols: list[np.ndarray], seed) -> np.ndarray:
    h = (np.asarray(seed, np.uint32) * np.uint32(PHI32)).astype(np.uint32)
    for c in cols:
        c = np.asarray(c, np.uint32)
        h = fmix32_np(
            h ^ (c + np.uint32(PHI32) + (h << np.uint32(6)) + (h >> np.uint32(2))).astype(
                np.uint32
            )
        )
    return h


def reduce_range_np(h: np.ndarray, width: int) -> np.ndarray:
    if width & (width - 1):
        raise ValueError(f"width must be a power of two, got {width}")
    return h & np.uint32(width - 1)
