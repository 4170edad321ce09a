"""The shard mesh of sharded telemetry (port of retina_tpu/parallel/mesh.py).

Events are hash-partitioned across shards, every shard runs the same
pipeline step on its own state, and the merges are collectives
(``parallel/collectives.py``). A mesh is the ordered list of this process's
shard devices, plus an optional ``torch.distributed`` process group when
the mesh spans several processes:

- the list may name one card (or the CPU) several times: D shards on one
  device, the counterpart of the reference's virtual CPU devices;
- the global shard index is rank x local shards + i, and ``size`` is the
  world size x local shards;
- the axis names are the reference's: ``("chip",)`` for one host,
  ``("node", "chip")`` with ``n_nodes``, and ``("data",)`` for the batch
  mesh of the engine. A collective reduces over every axis, as the
  reference's do over ``ShardedTelemetry.axes``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from retina_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shard devices of this process, in shard order, and the process
    group the mesh spans (None: this process alone)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("chip",)
    group: Any = None

    @property
    def lead(self) -> torch.device:
        """The device of local shard 0, where the merges land."""
        return self.devices[0]

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def world(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """Shards over every process of the mesh."""
        return self.world * self.local_size

    def global_index(self, i: int) -> int:
        """The global index of local shard ``i``."""
        return self.rank * self.local_size + i


def local_devices(devices: Sequence[torch.device | str] | None = None) -> list[torch.device]:
    """``devices`` as torch devices; by default every local card. With no
    card and no devices named this raises, as every entry point does."""
    if devices is None:
        resolve_device(None)  # raises without a card
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    # "cuda" names the current card, as tensors made there report it.
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def make_mesh(devices: Sequence[torch.device | str] | None = None,
              n_nodes: int | None = None, group: Any = None) -> Mesh:
    """The telemetry mesh over ``devices`` (default: every local card) and
    ``group``. With ``n_nodes``, a 2-D ("node", "chip") mesh, whose size
    must split into that many nodes; otherwise 1-D ("chip",)."""
    mesh = Mesh(tuple(local_devices(devices)), ("chip",), group)
    if n_nodes is not None:
        if mesh.size % n_nodes:
            raise ValueError(f"{mesh.size} shards do not split into {n_nodes} nodes")
        mesh = dataclasses.replace(mesh, axis_names=("node", "chip"))
    return mesh


def batch_mesh(devices: Sequence[torch.device | str] | None = None, group: Any = None) -> Mesh:
    """The 1-D ingest mesh, named for what is sharded over it: the event
    batch (``("data",)``). The same shards as ``make_mesh(devices)``."""
    return Mesh(tuple(local_devices(devices)), ("data",), group)
