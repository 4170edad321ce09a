"""The port's churn harness (retina_tpu_torch/fleet/{hostsketch,node_agent,
churn}.py) against the reference's, on the CPU.

``hostsketch``'s traffic, seeds and numpy sketches are equal to the
reference's and each encoded RFLT frame is byte-equal; the node agent's
READY / ROTATE / STOP -> STATS protocol runs in a child whose
``sys.modules['torch']`` is None (the child is torch-free), and the frames
it ships over the port's ``HubbleServer`` are the reference hostsketch's
for their epochs; a small ``run_churn_dryrun`` (4 node processes, 2 zones,
the aggregators on the CPU) returns ``ok`` within a deadline of its own.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from retina_tpu.fleet import codec as rcodec
from retina_tpu.fleet import hostsketch as rhs
from retina_tpu.ops import hashing_np as rhash
from retina_tpu_torch import exporter, metrics
from retina_tpu_torch.fleet import codec as pcodec
from retina_tpu_torch.fleet import dryrun as pdryrun
from retina_tpu_torch.fleet import hostsketch as phs
from retina_tpu_torch.hubble import FlowObserver, HubbleServer
from retina_tpu_torch.ops import hashing, hashing_np
from tests.procutil import LineReader, wait_until

REPO = Path(__file__).resolve().parent.parent
CASES = [(0, 0, 1_792_000_000, 0), (0, 5, 1_792_000_001, 1), (7, 63, 1_792_000_123, 2),
         (123, 17, 5, 3)]


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


def test_hostsketch_shapes_and_seeds_match_reference_and_dryrun():
    for name in ("SLOTS", "WIDTH", "DEPTH", "PODS", "HLL_FLOWS_P", "HLL_POD_P",
                 "ENTROPY_BUCKETS", "BASE_SEEDS", "_TOPK_SALT", "_HLL_SALT", "_ENT_SALT"):
        assert getattr(phs, name) == getattr(rhs, name), name
    assert (phs.SLOTS, phs.WIDTH, phs.DEPTH, phs.PODS) == (
        pdryrun._SLOTS, pdryrun._WIDTH, pdryrun._DEPTH, pdryrun._PODS)
    for gen in range(4):
        assert phs.rotated_seeds(gen) == rhs.rotated_seeds(gen)


def test_numpy_hash_mirror_matches_reference():
    rng = np.random.default_rng(11)
    cols = [rng.integers(0, 2**32, 1000, dtype=np.uint32) for _ in range(4)]
    seeds = np.arange(1, 5, dtype=np.uint32).reshape(4, 1) + np.uint32(1000)
    for s in (0, 7, 0xFFFFFFFF, seeds):
        got = hashing_np.hash_cols_np([c[None, :] if np.ndim(s) else c for c in cols], s)
        want = rhash.hash_cols_np([c[None, :] if np.ndim(s) else c for c in cols], s)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(hashing_np.reduce_range_np(got, 1 << 12),
                                      rhash.reduce_range_np(want, 1 << 12))
    np.testing.assert_array_equal(hashing_np.fmix32_np(cols[0]), rhash.fmix32_np(cols[0]))
    assert hashing.hash_cols_np is hashing_np.hash_cols_np  # re-exported


@pytest.mark.parametrize("seed,node,epoch,gen", CASES)
def test_epoch_sketches_and_frames_match_reference(seed, node, epoch, gen):
    keys, w = phs.epoch_traffic(seed, node, epoch, 40, 64)
    rkeys, rw = rhs.epoch_traffic(seed, node, epoch, 40, 64)
    np.testing.assert_array_equal(keys, rkeys)
    np.testing.assert_array_equal(w, rw)
    assert w.dtype == rw.dtype and keys.dtype == rkeys.dtype
    np.testing.assert_array_equal(phs.heavy_keys(seed, 40), rhs.heavy_keys(seed, 40))
    assert phs.exact_counter(seed, node, epoch, 40, 64) == rhs.exact_counter(
        seed, node, epoch, 40, 64)
    seeds = phs.rotated_seeds(gen)
    arrays = phs.sketch_arrays_np(keys, w, seeds)
    rarrays = rhs.sketch_arrays_np(rkeys, rw, rhs.rotated_seeds(gen))
    assert sorted(arrays) == sorted(rarrays)
    for name, arr in arrays.items():
        assert arr.dtype == rarrays[name].dtype and arr.shape == rarrays[name].shape, name
        np.testing.assert_array_equal(arr, rarrays[name], err_msg=name)
    assert arrays["flow_counts"].any() and arrays["entropy"].any()
    common = dict(node=f"node{node:03d}", tenant=f"tenant{node % 4}", priority=node % 4,
                  epoch=epoch, seq=3, window_s=1.0, seeds=dict(seeds), seed_gen=gen)
    frame = pcodec.encode_snapshot(pcodec.FleetSnapshot(arrays=arrays, **common))
    assert frame == rcodec.encode_snapshot(rcodec.FleetSnapshot(arrays=rarrays, **common))


def test_empty_window_sketch_matches_reference():
    """The harness's prewarm epochs: a zero-row window."""
    for gen in (0, 1):
        got = phs.sketch_arrays_np(np.zeros((0, 4), np.uint32), np.zeros(0, np.uint32),
                                   phs.rotated_seeds(gen))
        want = rhs.sketch_arrays_np(np.zeros((0, 4), np.uint32), np.zeros(0, np.uint32),
                                    rhs.rotated_seeds(gen))
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


CHILD = (
    "import runpy, sys\n"
    "sys.modules['torch'] = None\n"
    "sys.argv = ['node_agent'] + sys.argv[1:]\n"
    "runpy.run_module('retina_tpu_torch.fleet.node_agent', run_name='__main__')\n"
)


def test_node_agent_protocol_in_a_torch_free_child():
    frames: list[bytes] = []
    lock = threading.Lock()

    def ingest(frame: bytes) -> bool:
        with lock:
            frames.append(frame)
        return True

    srv = HubbleServer(FlowObserver(), "127.0.0.1:0", fleet_ingest=ingest)
    srv.start()
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, "--node-index", "5", "--relay",
         f"127.0.0.1:{srv.port}", "--interval", "0.2", "--seed", "3", "--heavy", "8",
         "--light", "16"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=REPO)
    reader = LineReader(proc)
    try:
        ready = reader.expect("READY ", deadline_s=120.0)
        assert ready.startswith(f"READY node=node005 pid={proc.pid}")

        def decoded():
            with lock:
                return [pcodec.decode_snapshot(f) for f in frames]

        assert wait_until(lambda: len(decoded()) >= 2, deadline_s=60.0)
        proc.stdin.write("ROTATE 1\n")
        proc.stdin.flush()
        assert wait_until(lambda: any(s.seed_gen == 1 for s in decoded()), deadline_s=60.0)
        proc.stdin.write("STOP\n")
        proc.stdin.flush()
        stats = json.loads(reader.expect("STATS ", deadline_s=60.0)[len("STATS "):])
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        srv.stop()
    snaps = decoded()
    assert stats["node"] == "node005" and stats["seed_gen"] == 1
    assert stats["n_offered"] == len(stats["offered"]) >= 3
    assert stats["shipped"] == len(snaps) == sum(o["queued"] for o in stats["offered"])
    assert stats["spool_depth"] == 0
    assert set(stats["memory_kb"]) <= {"VmHWM", "VmRSS"}
    assert all(v > 0 for v in stats["memory_kb"].values())
    assert sorted(stats["ship_tids"]) == sorted(s.epoch for s in snaps)
    gens = [s.seed_gen for s in snaps]
    assert gens == sorted(gens) and gens[0] == 0 and gens[-1] == 1
    # Each frame is the reference hostsketch's window for its epoch.
    for s in snaps:
        keys, w = rhs.epoch_traffic(3, 5, s.epoch, 8, 16)
        want = rhs.sketch_arrays_np(keys, w, rhs.rotated_seeds(s.seed_gen))
        assert s.seeds == rhs.rotated_seeds(s.seed_gen)
        assert (s.tenant, s.priority) == ("tenant1", 1)
        for name, arr in want.items():
            np.testing.assert_array_equal(s.arrays[name], arr, err_msg=name)


def test_small_churn_dryrun_is_ok_within_its_deadline():
    from retina_tpu_torch.fleet.churn import run_churn_dryrun

    box: dict = {}

    def run() -> None:
        box["res"] = run_churn_dryrun(nodes=4, zones=2, device="cpu")

    t = threading.Thread(target=run, name="churn", daemon=True)
    t.start()
    t.join(timeout=300.0)
    assert not t.is_alive(), "run_churn_dryrun did not finish within 300 s"
    res = box["res"]
    assert res["ok"], {k: res[k] for k in (
        "recall_min", "epochs_scored", "child_spool_replayed", "reship_spool_replayed",
        "no_silent_frame_loss", "rotation_readmitted_all", "trace_lineage_ok",
        "scrape_p99_s", "events")}
    assert res["recall_min"] >= 0.95 and res["trace_lineage_ok"]
    assert res["zone_merge_s"]["n"] > 0 and res["root_merge_s"]["n"] > 0
    assert len(res["restarted"]) == 1


def test_churn_rejects_an_uneven_fleet():
    from retina_tpu_torch.fleet.churn import run_churn_dryrun

    with pytest.raises(ValueError, match="nodes % zones"):
        run_churn_dryrun(nodes=5, zones=2, device="cpu")
