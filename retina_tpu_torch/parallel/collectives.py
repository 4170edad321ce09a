"""The reference's ``psum``, ``pmax`` and ``all_gather`` over a shard mesh
(``parallel/mesh.py``), in two levels:

1. in the process: each local shard's leaf is copied to the lead shard's
   device (a peer copy where the cards differ) and stacked in shard order;
   the stacks are folded by K8 (``kops.fold_many``, one launch for every
   array of a merge): a wrapping u32 sum, an f32 sum in shard order, or a
   u32 max. A gather keeps the stack;
2. across processes, where the mesh has a group: ``dist.all_reduce``
   (SUM or MAX) in place on the folded leaf, and
   ``dist.all_gather_into_tensor`` of the stacks, in rank order, so a
   gathered leaf's row is its global shard index (NCCL where each rank has
   its own card, gloo on the CPU).

u32 leaves stay int32 bit patterns through both levels, and their sums wrap
mod 2^32 as the reference's u32 ``psum`` does (two's complement adds; gloo's
and NCCL's int32 sums wrap too; neither takes ``torch.uint32``). A MAX over
int32 patterns is exact only where every value is below 2^31: it merges the
HLL ranks alone. Two-limb counters (``ct_totals``) are gathered, never
summed, since a summed low limb loses its carry. f32 sums are exact while a
bucket stays below 2^24, whatever the order the ranks add in.

There is no fallback: a collective that fails raises.
"""

from __future__ import annotations

import torch

from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.parallel.mesh import Mesh

# K8's reductions, and the collective of each across processes.
REDUCE_OPS = ("sum_u32", "sum_f32", "max_u32")


def stack_on_lead(mesh: Mesh, leaves: list[torch.Tensor]) -> torch.Tensor:
    """The local shards' leaves stacked in shard order, (L, *shape), on the
    lead device: one stack on one device, a copy a shard otherwise."""
    lead = mesh.lead
    if all(t.device == lead for t in leaves):
        return torch.stack(leaves)
    out = torch.empty((len(leaves),) + tuple(leaves[0].shape), dtype=leaves[0].dtype,
                      device=lead)
    for i, t in enumerate(leaves):
        out[i].copy_(t)
    return out


def reduce_many(mesh: Mesh, items: list[tuple[list[torch.Tensor], str]]) -> list[torch.Tensor]:
    """Merge several leaves over the mesh: each item is (one leaf a local
    shard, op in ``REDUCE_OPS``); the result is each merged leaf, a new
    tensor on the lead device. Every in-process fold is one K8 launch."""
    for _, op in items:
        if op not in REDUCE_OPS:
            raise ValueError(f"reduce op must be one of {REDUCE_OPS}, got {op!r}")
    if mesh.local_size > 1:
        outs = kops.fold_many([(stack_on_lead(mesh, leaves), op) for leaves, op in items])
    else:
        outs = [leaves[0].clone() for leaves, _ in items]
    if mesh.group is not None:
        import torch.distributed as dist

        for t, (_, op) in zip(outs, items):
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max_u32" else dist.ReduceOp.SUM,
                            group=mesh.group)
    return outs


def psum(mesh: Mesh, leaves: list[torch.Tensor]) -> torch.Tensor:
    """The sum of one leaf over the mesh (u32 wrapping, or f32)."""
    op = "sum_f32" if leaves[0].dtype == torch.float32 else "sum_u32"
    return reduce_many(mesh, [(leaves, op)])[0]


def pmax(mesh: Mesh, leaves: list[torch.Tensor]) -> torch.Tensor:
    """The max of one leaf of u32 values below 2^31 over the mesh."""
    return reduce_many(mesh, [(leaves, "max_u32")])[0]


def gather_many(mesh: Mesh, items: list[list[torch.Tensor]]) -> list[torch.Tensor]:
    """Gather several leaves over the mesh: each item has one leaf a local
    shard; the result is each leaf stacked in global shard order, (size,
    *shape), on the lead device."""
    outs = [stack_on_lead(mesh, leaves) for leaves in items]
    if mesh.group is not None:
        import torch.distributed as dist

        for i, local in enumerate(outs):
            full = torch.empty((mesh.size,) + tuple(local.shape[1:]), dtype=local.dtype,
                               device=local.device)
            dist.all_gather_into_tensor(full, local, group=mesh.group)
            outs[i] = full
    return outs
