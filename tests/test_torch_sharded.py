"""The port's sharded telemetry and engine over D shards against the
reference's over D devices (CPU).

The reference runs on ``jax.devices()[:4]`` (conftest's virtual CPU
devices); the port on ``["cpu"] * 4``, four shards on one device, in one
process or as two gloo processes of two shards each. Both are fed the same
connection-partitioned batches (``partition_events``). Tolerances, as
ROADMAP §3 "Floats": integers exactly (u32 leaves as int32 bit patterns),
entropy bits and HLL estimates within rtol 1e-5, z-scores within atol 1e-4.
The wrap rules of the collectives (u32 sums past 2^31 and 2^32, the HLL
max, the two-limb ``ct_totals`` gathered) and D-shard checkpoints in the
reference's layout are held too.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from retina_tpu.checkpoint import load_state as jload_state
from retina_tpu.checkpoint import save_state as jsave_state
from retina_tpu.config import Config as JEngineConfig
from retina_tpu.engine import SketchEngine as JEngine
from retina_tpu.events.synthetic import TrafficGen as JTrafficGen
from retina_tpu.models.identity import IdentityMap as JIdentityMap
from retina_tpu.models.pipeline import PipelineConfig as JConfig
from retina_tpu.parallel.mesh import make_mesh as jmake_mesh
from retina_tpu.parallel.partition import partition_events as jpartition
from retina_tpu.parallel.telemetry import ShardedTelemetry as JSharded
from retina_tpu.parallel.telemetry import topk_from_snapshot as jtopk_from_snapshot
from retina_tpu_torch import checkpoint
from retina_tpu_torch.config import Config
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig
from retina_tpu_torch.parallel import collectives
from retina_tpu_torch.parallel.mesh import batch_mesh, make_mesh
from retina_tpu_torch.parallel.partition import partition_events
from retina_tpu_torch.parallel.telemetry import ShardedTelemetry, topk_from_snapshot
from retina_tpu_torch.u32 import from_numpy, to_numpy
from test_torch_pipeline import API, B, PODS, SMALL, SMALL_CUTS, clock, compare_states, traffic
from test_torch_telemetry import _compare_dicts, _compare_snapshots
from test_torch_wire import reference_native  # noqa: F401 (a fixture)

D = 4
CUTS = {"no_conntrack": SMALL, **SMALL_CUTS}


def _feed(kw, seed, n_windows=3, n_batches=3):
    """Each window's partitioned batches (``ShardedBatch``): ``n_batches``
    batches of 2B rows each over D shards of B/2 rows, so a shard hotter
    than the mean overflows and loses rows."""
    out = []
    for w in range(n_windows):
        win = []
        for rec in traffic(seed + w, n_batches, n=2 * B):
            sb = partition_events(rec, D, B // 2)
            jsb = jpartition(rec, D, B // 2)
            np.testing.assert_array_equal(sb.records, jsb.records)
            assert sb.lost == jsb.lost
            win.append(sb)
        out.append(win)
    return out


def _pair(kw):
    ref = JSharded(JConfig(**kw), jmake_mesh(jax.devices()[:D]))
    port = ShardedTelemetry(PipelineConfig(**kw), make_mesh(["cpu"] * D))
    return ref, port


def _compare_windows(jwin, twin):
    np.testing.assert_allclose(twin["entropy_bits"].numpy(), np.asarray(jwin["entropy_bits"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(twin["anomaly"].numpy(), np.asarray(jwin["anomaly"]))
    np.testing.assert_allclose(twin["zscore"].numpy(), np.asarray(jwin["zscore"]), atol=1e-4)


def _compare_export(jx, tx):
    assert set(jx) == set(tx)
    for k, ref in jx.items():
        ref = np.asarray(ref)
        port = to_numpy(tx[k])
        assert ref.shape == port.shape, k
        np.testing.assert_array_equal(port.astype(ref.dtype), ref, err_msg=k)


@pytest.mark.parametrize("cut", list(CUTS))
def test_sharded_telemetry_matches_the_reference_over_four_devices(cut):
    kw = CUTS[cut]
    ref, port = _pair(kw)
    js, ts = ref.init_state(), port.init_state()
    ji = JIdentityMap.build_host(PODS, n_slots=1 << 8)
    ti = IdentityMap.build_host(PODS, n_slots=1 << 8, device="cpu")
    for w, win in enumerate(_feed(kw, 41)):
        for i, sb in enumerate(win):
            js, jout = ref.step(js, sb.records, sb.n_valid, clock(w, i), ji, apiserver_ip=API,
                                lost=sb.lost)
            ts, tout = port.step(ts, [from_numpy(r, "cpu") for r in sb.records], sb.n_valid,
                                 clock(w, i), ti, apiserver_ip=API, lost=sb.lost)
            _compare_dicts(jout, tout)
        now = clock(w, len(win))
        _compare_snapshots(ref.snapshot(js, now), port.snapshot(ts, now))
        _compare_snapshots(ref.snapshot_host(js, now), port.snapshot_host(ts, now))
        _compare_export(ref.fleet_export(js), port.fleet_export(ts))
        if kw.get("enable_invertible"):
            for min_weight in (0, 3):
                _compare_dicts(ref.inv_decode(js, min_weight), port.inv_decode(ts, min_weight))
        js, jwin = ref.end_window(js)
        ts, twin = port.end_window(ts)
        _compare_windows(jwin, twin)
    jsnap, tsnap = ref.snapshot(js, 0), port.snapshot(ts, 0)
    lost = sum(sb.lost for win in _feed(kw, 41) for sb in win)
    assert lost > 0 and int(to_numpy(tsnap["totals"])[7]) == lost
    for name in ("flow_hh", "svc_hh", "dns_hh"):
        jk, jc = jtopk_from_snapshot(jsnap, name, 20)
        tk, tc = topk_from_snapshot(tsnap, name, 20)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tk, jk)


# -- the engine over D shards ----------------------------------------------------------

ENGINE_SMALL = dict(
    batch_capacity=1 << 9, n_pods=64, cms_width=1 << 10, cms_depth=4, topk_slots=1 << 6,
    hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 8, identity_slots=1 << 8,
    flow_dict_slots=1 << 12, transfer_min_bucket=64, feed_coalesce_windows=2,
)
ENGINE_CASES = {
    "flowdict_v4": {},
    "flowdict_v3_high": dict(wire_dense_known=False, data_aggregation_level="high"),
    "invertible": dict(heavy_keys_source="invertible"),
}
NOW = 1_000


def _engines(**kw):
    jcfg, cfg = JEngineConfig(), Config()
    for k, v in dict(ENGINE_SMALL, **kw).items():
        setattr(jcfg, k, v)
        setattr(cfg, k, v)
    jeng = JEngine(jcfg, devices=jax.devices()[:D])
    eng = SketchEngine(cfg, devices=["cpu"] * D)
    jeng.update_identities(PODS)
    eng.update_identities(PODS)
    return jeng, eng


def _compare_engine_states(jeng, eng):
    assert len(eng.states) == D
    for d in range(D):
        compare_states(jax.tree.map(lambda x, d=d: x[d], jeng.state), eng.states[d])


def _partition_lost(jeng) -> float:
    from retina_tpu.metrics import get_metrics

    return get_metrics().lost_events.labels(stage="partition", plugin="engine")._value.get()


@pytest.mark.usefixtures("reference_native")
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_over_four_shards_matches_the_reference_engine(case):
    """Quanta through ``_build_quantum`` and ``_dispatch_sharded`` (the
    flush) and blocks past a shard's capacity through ``step_records`` on
    both engines: every shard's state, the merged snapshot, the export, the
    decode and each close agree, and so do the partition losses."""
    jeng, eng = _engines(**ENGINE_CASES[case])
    assert eng.n_devices == D and eng.mesh.axis_names == ("data",)
    gen = JTrafficGen(n_flows=1500, n_pods=48, seed=61)
    for w in range(3):
        blocks = [gen.batch(700) for _ in range(3)]
        n_raw = sum(len(b) for b in blocks)
        for item in jeng._build_quantum(blocks, n_raw, 100 + 10 * w):
            jeng._dispatch_sharded(*item[1:])
        eng.flush(blocks, 100 + 10 * w)
        over = gen.batch(4 * ENGINE_SMALL["batch_capacity"] + 300)
        jeng.step_records(over, now_s=101 + 10 * w)
        eng.step_records(over, now_s=101 + 10 * w)
        _compare_engine_states(jeng, eng)
        _compare_snapshots(jeng.sharded.snapshot(jeng.state, NOW + w),
                           eng.telemetry.snapshot(eng.states, NOW + w))
        snap = eng.snapshot(max_age_s=0, now_s=NOW + w)
        _compare_snapshots(jeng.sharded.snapshot(jeng.state, NOW + w),
                           {k: v for k, v in snap.items() if k not in ("steps", "events_in")})
        _compare_export(jeng.sharded.fleet_export(jeng.state), eng.telemetry.fleet_export(eng.states))
        if eng.pcfg.enable_invertible:
            jdec = jeng.sharded.inv_decode(jeng.state, eng.cfg.invertible_min_weight)
        jeng.state, jwin = jeng.sharded.end_window(jeng.state)
        out = eng.close_window(epoch=w)
        _compare_windows(jwin, out)
        if eng.pcfg.enable_invertible:
            _compare_dicts(jdec, out["inv"])
        _compare_engine_states(jeng, eng)
    assert eng.lost_events["partition"] == _partition_lost(jeng) > 0
    assert int(to_numpy(eng.snapshot(max_age_s=0)["totals"])[7]) == eng.lost_events["partition"]


# -- two gloo processes of two shards ----------------------------------------------------

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_sharded_child.py")


def _spawn(mode: str, tmp_path, inputs: dict) -> list[dict]:
    """Run both ranks of ``_torch_sharded_child.py`` on ``inputs``; each
    rank's outputs."""
    inp = tmp_path / "in.npz"
    np.savez(inp, **inputs)
    init = tmp_path / "pg_init"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(CHILD)))
    procs = [subprocess.Popen([sys.executable, CHILD, mode, str(r), str(init), str(inp),
                               str(tmp_path / f"out{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = []
    for r in range(2):
        with np.load(tmp_path / f"out{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def _flat_ref(prefix: str, tree, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_ref(f"{prefix}.{k}", v, out)
    else:
        out[prefix] = np.asarray(tree)


def test_two_gloo_processes_of_two_shards_match_the_reference(tmp_path):
    """2 ranks x 2 shards (gloo) against the reference's 4-device
    ShardedTelemetry over the same batches: step summaries, snapshots,
    exports, decodes and closes, on both ranks."""
    import json

    kw = CUTS["invertible"]
    feed = _feed(kw, 71, n_windows=2, n_batches=2)
    ref = JSharded(JConfig(**kw), jmake_mesh(jax.devices()[:D]))
    ji = JIdentityMap.build_host(PODS, n_slots=1 << 8)
    js = ref.init_state()
    inputs = {"config": json.dumps(kw), "pods": json.dumps({str(k): v for k, v in PODS.items()}),
              "api": API, "n_windows": len(feed), "n_batches": len(feed[0])}
    want: dict = {}
    for w, win in enumerate(feed):
        for i, sb in enumerate(win):
            key = f"w{w}.b{i}"
            inputs.update({f"{key}.records": sb.records, f"{key}.n_valid": sb.n_valid,
                           f"{key}.now": clock(w, i), f"{key}.lost": sb.lost})
            js, jout = ref.step(js, sb.records, sb.n_valid, clock(w, i), ji, apiserver_ip=API,
                                lost=sb.lost)
            _flat_ref(f"{key}.summary", jout, want)
        now = clock(w, len(win))
        inputs[f"w{w}.now"] = now
        _flat_ref(f"w{w}.snapshot", ref.snapshot(js, now), want)
        _flat_ref(f"w{w}.snapshot_host", ref.snapshot_host(js, now), want)
        _flat_ref(f"w{w}.export", ref.fleet_export(js), want)
        _flat_ref(f"w{w}.decode", ref.inv_decode(js, 3), want)
        js, jwin = ref.end_window(js)
        _flat_ref(f"w{w}.window", jwin, want)
    assert sum(sb.lost for win in feed for sb in win) > 0
    for rank, got in enumerate(_spawn("parity", tmp_path, inputs)):
        assert set(got) == set(want), rank
        for k, r in want.items():
            p = got[k]
            assert p.shape == r.shape, (rank, k)
            if k.endswith(".zscore"):
                np.testing.assert_allclose(p, r, atol=1e-4, err_msg=f"{rank} {k}")
            elif r.dtype == np.float32 and not k.endswith((".entropy", ".entropy.counts")):
                np.testing.assert_allclose(p, r, rtol=1e-5, err_msg=f"{rank} {k}")
            else:
                np.testing.assert_array_equal(p.astype(r.dtype), r, err_msg=f"{rank} {k}")


def test_collectives_wrap_and_gather_across_two_gloo_processes(tmp_path):
    """u32 sums across ranks wrap mod 2^32 as the reference's psum (a bucket
    past 2^31, one past 2^32), f32 sums are exact below 2^24, the HLL max
    takes the largest rank, and ct_totals' two limbs are gathered in global
    shard order, never summed."""
    rng = np.random.default_rng(5)
    sums = np.zeros((D, 3), np.uint32)
    sums[:, 0] = 0x2400_0000  # 4 x -> 0x9000_0000, past 2^31
    sums[:, 1] = 0x4800_0000  # 4 x -> 0x1_2000_0000, wraps past 2^32
    sums[:, 2] = rng.integers(0, 1 << 32, D, dtype=np.uint64)
    f32 = rng.integers(0, 1 << 21, (D, 5)).astype(np.float32)
    ranks = rng.integers(0, 32, (D, 2, 16)).astype(np.uint32)
    limbs = rng.integers(0, 1 << 32, (D, 4), dtype=np.uint64).astype(np.uint32)
    inputs = {"sum": sums, "sum_f32": f32, "max": ranks, "gather": limbs}
    want_sum = (sums.astype(np.uint64).sum(axis=0) & 0xFFFFFFFF).astype(np.uint32)
    assert want_sum[0] == 0x9000_0000 and want_sum[1] == 0x2000_0000
    for got in _spawn("wrap", tmp_path, inputs):
        np.testing.assert_array_equal(got["sum"], want_sum)
        np.testing.assert_array_equal(got["sum_f32"], f32.sum(axis=0))
        np.testing.assert_array_equal(got["max"], ranks.max(axis=0))
        np.testing.assert_array_equal(got["gather"], limbs)


def test_collectives_in_one_process_wrap_and_keep_shard_order():
    """The in-process level alone (four shards, no group): K8's plain
    version sums u32 bit patterns mod 2^32, maxes ranks, and a gather keeps
    shard order."""
    mesh = make_mesh(["cpu"] * D)
    vals = [from_numpy(np.array([0x6000_0000, 0x3000_0000, d], np.uint32), "cpu")
            for d in range(D)]
    got = to_numpy(collectives.psum(mesh, vals))
    np.testing.assert_array_equal(got, [0x8000_0000, 0xC000_0000, 6])
    regs = [torch.tensor([[d, 7 - d]], dtype=torch.int32) for d in range(D)]
    np.testing.assert_array_equal(collectives.pmax(mesh, regs).numpy(), [[3, 7]])
    g, = collectives.gather_many(mesh, [[torch.full((2,), d, dtype=torch.int32)
                                          for d in range(D)]])
    np.testing.assert_array_equal(g.numpy(), np.repeat(np.arange(D), 2).reshape(D, 2))
    with pytest.raises(ValueError, match="reduce op"):
        collectives.reduce_many(mesh, [(vals, "min_u32")])


def test_mesh_shapes_and_indices():
    m = make_mesh(["cpu"] * D)
    assert (m.axis_names, m.size, m.local_size, m.world, m.rank) == (("chip",), D, D, 1, 0)
    assert [m.global_index(i) for i in range(D)] == list(range(D))
    assert make_mesh(["cpu"] * D, n_nodes=2).axis_names == ("node", "chip")
    with pytest.raises(ValueError, match="split"):
        make_mesh(["cpu"] * 3, n_nodes=2)
    assert batch_mesh(["cpu"] * 2).axis_names == ("data",)
    with pytest.raises(ValueError):
        make_mesh([])


def _four_local_cards(monkeypatch):
    """Every local card, as the engine lists them, is D CPU shards (a host
    with D cards, without one)."""
    from retina_tpu_torch import engine as engine_mod
    from retina_tpu_torch.parallel.mesh import local_devices

    monkeypatch.setattr(engine_mod, "local_devices",
                        lambda devices=None: local_devices(["cpu"] * D if devices is None
                                                           else devices))


def test_engine_shards_follow_devices_device_and_mesh_devices(monkeypatch):
    """``devices`` as named, ``device`` alone, or every local card, capped by
    ``mesh_devices`` as the reference's ``devices[:mesh_devices]``."""
    cfg = Config(**ENGINE_SMALL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SketchEngine(cfg)
    assert SketchEngine(cfg, device="cpu").n_devices == 1
    assert SketchEngine(Config(**ENGINE_SMALL, mesh_devices=3), device="cpu").n_devices == 1
    eng = SketchEngine(Config(**ENGINE_SMALL, mesh_devices=2), devices=["cpu"] * D)
    assert eng.n_devices == 2 and len(eng.states) == 2
    with pytest.raises(AttributeError, match="states"):
        eng.state  # noqa: B018
    with pytest.raises(ValueError, match="mesh_devices"):
        Config(mesh_devices=-1).validate()
    _four_local_cards(monkeypatch)
    assert SketchEngine(cfg).n_devices == D
    assert SketchEngine(Config(**ENGINE_SMALL, mesh_devices=3)).n_devices == 3


def _fed_pair(tmp_path):
    jeng, eng = _engines()
    gen = JTrafficGen(n_flows=900, n_pods=48, seed=81)
    for i in range(2):
        rec = gen.batch(3 * ENGINE_SMALL["batch_capacity"])
        jeng.step_records(rec, now_s=300 + i)
        eng.step_records(rec, now_s=300 + i)
    return jeng, eng


def test_a_four_shard_checkpoint_crosses_between_the_packages(tmp_path):
    """The reference's D-device checkpoint (each leaf (D, *shape)) loads into
    the port's engine at D shards, and the port's into the reference's."""
    jeng, eng = _fed_pair(tmp_path)
    jpath, path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jsave_state(jpath, jeng.state, jeng.pcfg)
    fresh = SketchEngine(eng.cfg, devices=["cpu"] * D)
    assert fresh.load_snapshot_state(jpath)
    _compare_engine_states(jeng, fresh)
    eng.save_snapshot_state(path)
    with np.load(path) as z:
        assert z["leaf_0"].shape[0] == D
    jstate, resumed = jload_state(path, jeng.sharded, jeng.pcfg)
    assert resumed
    for d in range(D):
        compare_states(jax.tree.map(lambda x, d=d: x[d], jstate), eng.states[d])


def test_checkpoint_shard_counts_must_agree_and_one_shard_files_load(tmp_path):
    """A four-shard file refuses a two-shard engine (quarantined, cold
    start); a one-shard file without the device axis (the port's format
    before shards) and one with an axis of 1 (the reference engine's at one
    device) both load into a one-shard engine."""
    jeng, eng = _fed_pair(tmp_path)
    path = str(tmp_path / "four.npz")
    eng.save_snapshot_state(path)
    two = SketchEngine(dataclasses.replace(eng.cfg, mesh_devices=2), devices=["cpu"] * D)
    assert not two.load_snapshot_state(path) and os.path.exists(path + ".bad")
    one = SketchEngine(eng.cfg, device="cpu")
    one.step_records(traffic(82, 1)[0], now_s=5)
    flat_path, axis_path = str(tmp_path / "flat.npz"), str(tmp_path / "axis.npz")
    one.save_snapshot_state(flat_path)
    with np.load(flat_path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    checkpoint.save_state(axis_path, [a[None] for a in leaves], one.pcfg)
    for p in (flat_path, axis_path):
        other = SketchEngine(eng.cfg, device="cpu")
        assert other.load_snapshot_state(p)
        for a, b in zip(leaves, checkpoint.state_to_numpy(other.state)):
            np.testing.assert_array_equal(a, b)


def test_mesh_devices_reaches_the_agents_engine(monkeypatch):
    """On a host of four cards (here four CPU shards), ``--set
    mesh_devices=3`` gives the agent's engine three shards; the daemon still
    refuses distributed_coordinator, naming the queued part of item 5."""
    from retina_tpu_torch.cli import _parse_overrides
    from retina_tpu_torch.config import load_config
    from retina_tpu_torch.daemon import Daemon
    from test_torch_daemon import SMALL as DAEMON_SMALL

    _four_local_cards(monkeypatch)
    over = dict(DAEMON_SMALL, api_server_addr="127.0.0.1:0")
    over.update(_parse_overrides(["mesh_devices=3"]))
    d = Daemon(load_config(None, overrides=over, env={}), apiserver_host="127.0.0.1")
    assert d.cm.engine.n_devices == 3 and len(d.cm.engine.states) == 3
    with pytest.raises(ValueError, match="collectives in the same order.*item 5"):
        Daemon(load_config(None, overrides=dict(over, distributed_coordinator="10.0.0.1:1"),
                           env={}))


@pytest.mark.parametrize("workers", [1, 2], ids=["inline", "two_workers"])
def test_lanes_over_four_shards_equal_their_own_synchronous_replay(workers):
    """The runtime lanes (``start(stop)``: the feed loop, the feed workers,
    the dispatch thread, the close and harvest lanes) at four shards:
    every shard's state, the published windows and the merged snapshot
    equal the dispatch log replayed synchronously at four shards."""
    from test_torch_runtime import LANES, _configs, _replay, _run_lanes, _same_state
    from test_torch_runtime import _same_windows

    _, cfg = _configs(feed_workers=workers, **LANES)
    eng, log, published, accepted, observed = _run_lanes(cfg, devices=["cpu"] * D)
    assert eng.n_devices == D and eng.errors == {} and eng.lost_events == {}
    assert observed == accepted == eng.counts.events
    assert eng.windows["idle"] >= 1 and eng.windows["end_window"] >= 2
    ref, ref_published = _replay(cfg, log, devices=["cpu"] * D)
    for a, b in zip(eng.states, ref.states):
        _same_state(a, b)
    _same_windows(published, ref_published)
    a, b = eng.snapshot(max_age_s=0, now_s=5000), ref.snapshot(max_age_s=0, now_s=5000)
    assert int(to_numpy(a["totals"])[0]) == accepted  # one packet a row
    for name in ("totals", "node_counters", "pod_forward", "active_conns", "ct_totals"):
        assert torch.equal(a[name], b[name]), name
