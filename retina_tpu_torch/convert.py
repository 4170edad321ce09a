"""Carry state between the JAX reference and the port.

The reference's ``PipelineState`` and ``IdentityMap`` are pytrees; flattened
(``jax.tree_util.tree_leaves``) and read with ``np.asarray`` they become a
list of numpy arrays in dataclass-field order, depth first. The port's
dataclasses keep the same fields in the same order, with the static fields
(seeds, alpha) outside the leaves, so the two line up leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import numpy as np
import torch

from retina_tpu_torch.u32 import from_numpy, to_numpy

T = TypeVar("T")


def tensor_leaves(obj: Any) -> list[torch.Tensor]:
    """The tensors of a port state object, in the reference's leaf order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        out: list[torch.Tensor] = []
        for f in dataclasses.fields(obj):
            out += tensor_leaves(getattr(obj, f.name))
        return out
    return []


def state_to_numpy(state: Any) -> list[np.ndarray]:
    """Port state -> the reference's flattened leaves (u32 as uint32)."""
    return [to_numpy(t) for t in tensor_leaves(state)]


def state_from_numpy(leaves: list[np.ndarray], like: T) -> T:
    """The reference's flattened leaves -> a port state shaped like ``like``
    (a PipelineState or IdentityMap of the port, which supplies the
    structure, the static fields and the device)."""
    it = iter(leaves)

    def rebuild(obj):
        if isinstance(obj, torch.Tensor):
            a = np.asarray(next(it))
            if a.shape != tuple(obj.shape):
                raise ValueError(f"leaf shape {a.shape} != {tuple(obj.shape)}")
            return from_numpy(a, obj.device)
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(
                obj, **{f.name: rebuild(getattr(obj, f.name))
                        for f in dataclasses.fields(obj) if f.init}
            )
        return obj

    out = rebuild(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the state has tensors")
    return out
