"""The numpy mirror of ``ops/hashing.py``'s 32-bit hashes, bit-identical
to retina_tpu/ops/hashing_np.py, in a module that imports no torch: the
churn harness's node-agent children (``fleet/hostsketch.py``,
``fleet/node_agent.py``) hash with it and never load torch.
``ops/hashing.py`` re-exports these names."""

from __future__ import annotations

import numpy as np

PHI32 = 0x9E3779B9


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
