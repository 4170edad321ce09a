"""One rank of the port's sharded telemetry over two gloo processes.

Run as: python tests/_torch_sharded_child.py <mode> <rank> <init file> <in.npz> <out.npz>

Each of the 2 processes owns 2 shards on the CPU, so the mesh spans 4
(global shard = rank x 2 + i), and the merges cross processes through
``torch.distributed`` (gloo, ``init_method=file://``, a 60 s timeout so a
hang fails instead of waiting). Imports only the port, torch and numpy.

Modes:
- ``parity``: step the partitioned batches of ``in.npz`` (this rank's two
  shards of each (4, B, 16) batch), then per window write the snapshot, the
  export, the decode and the close's outputs to ``out.npz``;
- ``wrap``: merge the leaves of ``in.npz`` (one a global shard) with
  ``psum``, ``pmax`` and ``gather`` and write the merged leaves.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from retina_tpu_torch.models.identity import IdentityMap  # noqa: E402
from retina_tpu_torch.models.pipeline import PipelineConfig  # noqa: E402
from retina_tpu_torch.parallel import collectives  # noqa: E402
from retina_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from retina_tpu_torch.parallel.telemetry import ShardedTelemetry  # noqa: E402
from retina_tpu_torch.u32 import from_numpy, to_numpy  # noqa: E402

LOCAL = 2


def flat(prefix: str, tree, out: dict) -> None:
    """A nested dict of tensors -> ``out[prefix.key.key]`` numpy arrays."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(f"{prefix}.{k}", v, out)
    else:
        out[prefix] = to_numpy(tree) if tree.dtype != torch.bool else tree.numpy()


def parity(rank: int, inp, out: dict) -> None:
    cfg = PipelineConfig(**json.loads(str(inp["config"])))
    pods = {int(k): int(v) for k, v in json.loads(str(inp["pods"])).items()}
    mesh = make_mesh(["cpu"] * LOCAL, group=dist.group.WORLD)
    assert mesh.size == 4 and mesh.global_index(0) == LOCAL * rank
    tel = ShardedTelemetry(cfg, mesh)
    ident = IdentityMap.build_host(pods, n_slots=1 << 8, device="cpu")
    states = tel.init_state()
    mine = slice(LOCAL * rank, LOCAL * (rank + 1))
    for w in range(int(inp["n_windows"])):
        for i in range(int(inp["n_batches"])):
            key = f"w{w}.b{i}"
            recs = [from_numpy(r, "cpu") for r in inp[f"{key}.records"][mine]]
            states, summ = tel.step(states, recs, inp[f"{key}.n_valid"][mine],
                                    int(inp[f"{key}.now"]), ident,
                                    apiserver_ip=int(inp["api"]), lost=int(inp[f"{key}.lost"]))
            flat(f"{key}.summary", summ, out)
        now = int(inp[f"w{w}.now"])
        flat(f"w{w}.snapshot", tel.snapshot(states, now), out)
        flat(f"w{w}.snapshot_host", tel.snapshot_host(states, now), out)
        flat(f"w{w}.export", tel.fleet_export(states), out)
        if cfg.enable_invertible:
            flat(f"w{w}.decode", tel.inv_decode(states, 3), out)
        states, win = tel.end_window(states)
        flat(f"w{w}.window", win, out)


def wrap(rank: int, inp, out: dict) -> None:
    mesh = make_mesh(["cpu"] * LOCAL, group=dist.group.WORLD)
    mine = range(LOCAL * rank, LOCAL * (rank + 1))

    def leaves(name):
        a = inp[name]
        return [from_numpy(a[g], "cpu") for g in mine]

    out["sum"] = to_numpy(collectives.psum(mesh, leaves("sum")))
    out["sum_f32"] = to_numpy(collectives.psum(mesh, leaves("sum_f32")))
    out["max"] = to_numpy(collectives.pmax(mesh, leaves("max")))
    out["gather"] = to_numpy(collectives.gather_many(mesh, [leaves("gather")])[0])


def main() -> None:
    mode, rank, init, inp_path, out_path = sys.argv[1:6]
    rank = int(rank)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out: dict = {}
        with np.load(inp_path) as inp:
            {"parity": parity, "wrap": wrap}[mode](rank, inp, out)
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
