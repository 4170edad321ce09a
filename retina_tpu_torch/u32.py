"""u32 lanes carried in int32 tensors (see the package docstring).

``widen`` turns int32 bit patterns (or int64 values) into int64 values in
[0, 2^32); ``narrow`` stores int64 values back as int32 bit patterns,
wrapping mod 2^32 exactly as a u32 store would.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def widen(t: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int64 u32 values in [0, 2^32)."""
    return t.to(torch.int64) & M32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 u32 bit patterns (mod 2^32)."""
    x = x.to(torch.int64) & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def from_numpy(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """uint32 (or float32) numpy array -> int32 (float32) tensor on device."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy()).to(device)
    return torch.from_numpy(a.astype(np.uint32).view(np.int32).copy()).to(device)


def to_numpy(t: torch.Tensor | np.ndarray) -> np.ndarray:
    """int32 tensor (or array) -> uint32 numpy copy; floats keep their type."""
    a = np.array(t) if isinstance(t, np.ndarray) else np.array(t.detach().cpu().numpy())
    return a.view(np.uint32) if a.dtype == np.int32 else a
