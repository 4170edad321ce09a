"""Invertible sketch state (port of the state of retina_tpu/ops/invertible.py).

The pipeline state carries two invertible sketches (1-wide placeholders
unless ``enable_invertible``), so their arrays are here with the
reference's shapes. ``update`` and decoding are not ported yet: see
ROADMAP.md, the invertible item of the port's queue.
"""

from __future__ import annotations

import dataclasses

import torch

CHECK_BITS = 32


def n_planes(n_key_cols: int) -> int:
    """Total bit planes for C u32 key columns + the checksum plane."""
    return 32 * n_key_cols + CHECK_BITS


@dataclasses.dataclass
class InvertibleSketch:
    planes: torch.Tensor  # (D, W, B) u32
    weights: torch.Tensor  # (D, W) u32
    seed: int = 0

    @classmethod
    def zeros(cls, depth: int = 2, width: int = 1 << 12, n_key_cols: int = 4,
              seed: int = 0, device: torch.device | str = "cpu") -> "InvertibleSketch":
        return cls(
            planes=torch.zeros((depth, width, n_planes(n_key_cols)), dtype=torch.int32,
                               device=device),
            weights=torch.zeros((depth, width), dtype=torch.int32, device=device),
            seed=seed,
        )

    def update(self, *args, **kwargs):
        raise NotImplementedError(
            "InvertibleSketch.update is not ported yet (ROADMAP.md, port queue: "
            "invertible sketch)"
        )
