"""Sketch-state checkpoint/resume (port of retina_tpu/checkpoint.py).

The reference's persistent state is pinned BPF maps that survive agent
restarts; here it is the card-resident sketch state: written to disk on
demand (or every snapshot_interval_s once the managers are ported) and
restored on boot or by the engine's crash-only recovery.

Format, the reference's exactly: one ``.npz`` of the state's leaves in the
reference's flatten order (``convert.state_to_numpy``: u32 leaves as
``uint32``, floats as ``float32``) under ``leaf_0..leaf_{n-1}``, and
``__config__``, the JSON fingerprint of ``PipelineConfig``. The two
packages' ``PipelineConfig`` fingerprint alike, so a file written by either
loads in the other. A config mismatch (different table shapes) refuses to
load.

At D shards (the engine's ``ShardedTelemetry``) each leaf carries a leading
device axis of D, as the reference writes a D-device state
(``stack_shards``). At one shard the leaves have no device axis, as the
port has always written them; a file with a device axis of 1 (the
reference engine's at one device) loads too.

The state is updated in place by the kernels, so ``save_state`` takes host
arrays or a state nobody steps while it runs; the engine hands it a copy
taken on its device proxy, in order with the steps
(``SketchEngine.save_snapshot_state``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from retina_tpu_torch.convert import state_from_numpy, state_to_numpy, tensor_leaves
from retina_tpu_torch.log import logger
from retina_tpu_torch.runtime import faults

_log = logger("checkpoint")


def _fingerprint(pcfg) -> str:
    return json.dumps(dataclasses.asdict(pcfg), sort_keys=True)


def stack_shards(shards: list[list[np.ndarray]]) -> list[np.ndarray]:
    """Each shard's leaves (``state_to_numpy``) -> the D-shard file's
    leaves: leaf i of every shard stacked, (D, *shape)."""
    return [np.stack(leaves) for leaves in zip(*shards)]


def save_state(path: str, state: Any, pcfg) -> None:
    """Atomic checkpoint write: full npz to a same-directory temp file,
    fsync, then rename over ``path`` — a crash mid-write leaves the old
    checkpoint intact, never a torn one. ``state`` is a port state or its
    leaves as numpy arrays (``state_to_numpy``)."""
    host = state if isinstance(state, list) else state_to_numpy(state)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    np.savez_compressed(
        tmp,
        __config__=np.frombuffer(_fingerprint(pcfg).encode(), np.uint8),
        **{f"leaf_{i}": a for i, a in enumerate(host)},
    )
    # np.savez appends .npz when missing; normalize then atomically swap.
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    if faults.should_corrupt("checkpoint"):
        # Chaos hook: simulate the torn write the tmp+rename protocol
        # exists to prevent, so load_state's corruption path is
        # exercised end to end.
        size = os.path.getsize(actual_tmp)
        with open(actual_tmp, "r+b") as fh:
            fh.truncate(max(16, size // 2))
    with open(actual_tmp, "rb") as fh:
        os.fsync(fh.fileno())
    os.replace(actual_tmp, path)
    _log.info("state checkpoint written: %s (%d leaves)", path, len(host))


def _quarantine(path: str, why: str) -> None:
    _log.warning(
        "checkpoint unusable (%s): %s — quarantining to %s.bad and "
        "cold-starting", why, path, path,
    )
    try:
        os.replace(path, path + ".bad")
    except OSError:
        _log.warning("could not quarantine %s", path, exc_info=True)


def _leaf_spec(t) -> tuple[tuple[int, ...], np.dtype]:
    """A port leaf's shape and the numpy dtype the file stores it as."""
    return tuple(t.shape), np.dtype(np.float32 if t.is_floating_point() else np.uint32)


def load_state(path: str, sharded, pcfg):
    """Restore into a zero state built by ``sharded.init_state()``: one
    state (a ``Telemetry``'s or a pipeline's), or a list of one a shard (the
    engine's ``ShardedTelemetry``; each shard's on its device), the file's
    leaves then (D, *shape), or without the axis at D = 1.

    Crash-only contract: a missing, truncated, corrupt, or
    fingerprint-mismatched checkpoint never raises — the bad file is
    quarantined to ``path + ".bad"`` and a clean zero state is
    returned. Returns ``(state, resumed)`` where ``resumed`` is False
    on any cold start.
    """
    zero = sharded.init_state()
    shards = zero if isinstance(zero, list) else [zero]
    n_dev = len(shards)
    if not os.path.exists(path):
        return zero, False
    try:
        with np.load(path) as z:
            stored_cfg = bytes(z["__config__"]).decode()
            if stored_cfg != _fingerprint(pcfg):
                _quarantine(path, "config fingerprint mismatch — table shapes changed")
                return zero, False
            loaded = []
            for i, leaf in enumerate(tensor_leaves(shards[0])):
                a = z[f"leaf_{i}"]
                shape, dtype = _leaf_spec(leaf)
                if n_dev == 1 and a.shape == (1,) + shape:
                    a = a[0]
                elif n_dev > 1:
                    shape = (n_dev,) + shape
                if a.shape != shape or a.dtype != dtype:
                    _quarantine(
                        path,
                        f"leaf {i} shape/dtype mismatch "
                        f"({a.shape}/{a.dtype} vs {shape}/{dtype})",
                    )
                    return zero, False
                loaded.append(a)
    except Exception as e:
        # zipfile/np.load raise a zoo of types on truncated or garbage
        # files (BadZipFile, EOFError, KeyError, OSError, ValueError);
        # all of them mean the same thing here: not a usable checkpoint.
        _quarantine(path, f"{type(e).__name__}: {e}")
        return zero, False
    if n_dev > 1:
        state = [state_from_numpy([a[d] for a in loaded], st) for d, st in enumerate(shards)]
    else:
        state = state_from_numpy(loaded, shards[0])
        state = [state] if isinstance(zero, list) else state
    _log.info("state checkpoint restored: %s", path)
    return state, True
