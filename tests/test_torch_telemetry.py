"""The port's single-card Telemetry against the reference ShardedTelemetry on
a one-device mesh, and state carried from the reference into the port (CPU).

Snapshot rules: same keys, shapes and dtypes (the port's u32 leaves are
int32 bit patterns, so uint32 on the reference side is int32 on the port's);
integer values exactly; HLL estimates within rtol 1e-5 (float32 sums and
logarithms evaluated by two libraries). The step summaries and the
invertible decode follow the same rules.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retina_tpu.events.synthetic import TrafficGen as JTrafficGen
from retina_tpu.models.identity import IdentityMap as JIdentityMap
from retina_tpu.models.pipeline import PipelineConfig as JConfig
from retina_tpu.models.pipeline import TelemetryPipeline as JPipeline
from retina_tpu.parallel.mesh import make_mesh
from retina_tpu.parallel.telemetry import ShardedTelemetry
from retina_tpu.parallel.telemetry import topk_from_snapshot as jtopk_from_snapshot
from retina_tpu_torch.convert import state_from_numpy, state_to_numpy
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig, TelemetryPipeline
from retina_tpu_torch.parallel.telemetry import Telemetry, topk_from_snapshot
from retina_tpu_torch.u32 import from_numpy, to_numpy
from test_torch_pipeline import API, B, PODS, SMALL, SMALL_CUTS, clock, compare_states, traffic


def _compare_snapshots(jsnap, tsnap):
    assert set(jsnap) == set(tsnap)
    for key, ref in jsnap.items():
        port = tsnap[key]
        pairs = ([(ref[k], port[k], f"{key}.{k}") for k in ref] if isinstance(ref, dict)
                 else [(ref, port, key)])
        for r, p, name in pairs:
            r = np.asarray(r)
            assert r.shape == tuple(p.shape), name
            if r.dtype == np.float32:
                assert p.dtype.is_floating_point and p.element_size() == 4, name
                np.testing.assert_allclose(p.numpy(), r, rtol=1e-5, err_msg=name)
            else:
                assert str(p.dtype) == "torch.int32", name
                np.testing.assert_array_equal(to_numpy(p).astype(r.dtype), r, err_msg=name)


def test_snapshot_matches_sharded_telemetry_on_one_device():
    cfg = JConfig(**SMALL)
    ref = ShardedTelemetry(cfg, make_mesh(jax.devices()[:1]))
    port = Telemetry(PipelineConfig(**SMALL), device="cpu")
    js, ts = ref.init_state(), port.init_state()
    ji = JIdentityMap.build_host(PODS, n_slots=1 << 8)
    ti = IdentityMap.build_host(PODS, n_slots=1 << 8, device="cpu")
    cap = JTrafficGen(mode="pcap_replay", seed=0)
    windows = [[cap.batch(B)] + traffic(11, 2), traffic(12, 2)]
    for w, batches in enumerate(windows):
        for i, rec in enumerate(batches):
            nv = B - 100 * i
            js, jout = ref.step(js, rec[None], np.array([nv], np.uint32), 3 + w, ji,
                                apiserver_ip=API, lost=7 * i)
            ts, tout = port.step(ts, from_numpy(rec, "cpu"), nv, 3 + w, ti,
                                 apiserver_ip=API, lost=7 * i)
            assert int(tout["events"]) & 0xFFFFFFFF == int(jout["events"])
        js, jwin = ref.end_window(js)
        ts, twin = port.end_window(ts)
        np.testing.assert_allclose(twin["entropy_bits"].numpy(), np.asarray(jwin["entropy_bits"]),
                                   rtol=1e-5)
        jsnap, tsnap = ref.snapshot(js, 3 + w), port.snapshot(ts, 3 + w)
        _compare_snapshots(jsnap, tsnap)
        for name in ("flow_hh", "svc_hh", "dns_hh"):
            jk, jc = jtopk_from_snapshot(jsnap, name, 20)
            tk, tc = topk_from_snapshot(tsnap, name, 20)
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(tk, jk)
    assert int(to_numpy(ts.totals)[7]) == 7 * 3 + 7 * 1


def _compare_dicts(jd, td):
    """Same keys; arrays of the same shape, dtype kind and values."""
    assert set(jd) == set(td)
    for key, ref in jd.items():
        ref, port = np.asarray(ref), td[key]
        assert ref.shape == tuple(port.shape), key
        if ref.dtype == bool:
            assert port.dtype == torch.bool, key
            np.testing.assert_array_equal(port.numpy(), ref, err_msg=key)
        else:
            assert port.dtype == torch.int32, key
            np.testing.assert_array_equal(to_numpy(port).astype(ref.dtype), ref, err_msg=key)


@pytest.mark.parametrize("cut", ["no_conntrack", "deployed", "invertible"])
def test_summaries_snapshots_and_decode_match_sharded_telemetry(cut):
    kw = SMALL if cut == "no_conntrack" else SMALL_CUTS[cut]
    ref = ShardedTelemetry(JConfig(**kw), make_mesh(jax.devices()[:1]))
    port = Telemetry(PipelineConfig(**kw), device="cpu")
    js, ts = ref.init_state(), port.init_state()
    ji = JIdentityMap.build_host(PODS, n_slots=1 << 8)
    ti = IdentityMap.build_host(PODS, n_slots=1 << 8, device="cpu")
    for w in range(2):
        for i, rec in enumerate(traffic(31 + w, 3)):
            nv = B - 50 * i
            js, jout = ref.step(js, rec[None], np.array([nv], np.uint32), clock(w, i), ji,
                                apiserver_ip=API)
            ts, tout = port.step(ts, from_numpy(rec, "cpu"), nv, clock(w, i), ti,
                                 apiserver_ip=API)
            _compare_dicts(jout, tout)
        if kw.get("enable_invertible"):
            for min_weight in (0, 3):
                _compare_dicts(ref.inv_decode(js, min_weight), port.inv_decode(ts, min_weight))
        js, _ = ref.end_window(js)
        ts, _ = port.end_window(ts)
        _compare_snapshots(ref.snapshot(js, clock(w, 3)), port.snapshot(ts, clock(w, 3)))


def test_snapshot_is_a_copy():
    port = Telemetry(PipelineConfig(**SMALL), device="cpu")
    ts = port.init_state()
    ti = IdentityMap.build_host(PODS, n_slots=1 << 8, device="cpu")
    snap = port.snapshot(ts, 0)
    port.step(ts, from_numpy(traffic(13, 1)[0], "cpu"), B, 0, ti)
    assert int(snap["totals"][0]) == 0 and int(to_numpy(ts.totals)[0]) == B


def test_state_carried_from_reference_continues_identically():
    jp = JPipeline(JConfig(**SMALL))
    tp = TelemetryPipeline(PipelineConfig(**SMALL), device="cpu")
    step = jp.jitted_step()
    ji = JIdentityMap.build_host(PODS, n_slots=1 << 8)
    batches = traffic(14, 4)
    js = jp.init_state()
    for rec in batches[:2]:
        js, _ = step(js, jnp.asarray(rec), jnp.uint32(B), jnp.uint32(1), ji, jnp.uint32(0))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    ts = state_from_numpy(leaves, tp.init_state())
    ti = state_from_numpy([np.asarray(ji.table)], IdentityMap.zeros(1 << 8, device="cpu"))
    assert ti.seed == ji.seed
    compare_states(js, ts)
    for rec in batches[2:]:
        js, _ = step(js, jnp.asarray(rec), jnp.uint32(B), jnp.uint32(1), ji, jnp.uint32(0))
        ts, _ = tp.step(ts, from_numpy(rec, "cpu"), B, 1, ti, 0)
        compare_states(js, ts)
    back = state_to_numpy(ts)
    assert [a.dtype for a in back] == [np.asarray(x).dtype for x in jax.tree_util.tree_leaves(js)]


@pytest.mark.parametrize("cut", ["deployed", "invertible"])
def test_live_conntrack_and_invertible_state_carried_mid_stream(cut):
    jp = JPipeline(JConfig(**SMALL_CUTS[cut]))
    tp = TelemetryPipeline(PipelineConfig(**SMALL_CUTS[cut]), device="cpu")
    step = jp.jitted_step()
    ji = JIdentityMap.build_host(PODS, n_slots=1 << 8)
    batches = traffic(15, 4)
    js = jp.init_state()
    for i, rec in enumerate(batches[:2]):
        js, _ = step(js, jnp.asarray(rec), jnp.uint32(B), jnp.uint32(clock(0, i)), ji,
                     jnp.uint32(0))
    assert int(np.asarray(js.totals)[6]) > 0 and np.asarray(js.conntrack.keys).any()
    ts = state_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(js)],
                          tp.init_state())
    ti = state_from_numpy([np.asarray(ji.table)], IdentityMap.zeros(1 << 8, device="cpu"))
    for i, rec in enumerate(batches[2:], start=2):
        js, _ = step(js, jnp.asarray(rec), jnp.uint32(B), jnp.uint32(clock(0, i)), ji,
                     jnp.uint32(0))
        ts, _ = tp.step(ts, from_numpy(rec, "cpu"), B, clock(0, i), ti, 0)
        compare_states(js, ts)


def _random_state(ref, port, seed):
    """A random reference state (ShardedTelemetry, one device) and the same
    state carried into the port: counters and candidate tables of random
    words, HLL registers 0-20 (some groups all 0), conntrack slots a quarter
    empty with idle times across the lifetimes and the 16-bit wrap."""
    rng = np.random.default_rng(seed)
    js = ref.init_state()
    leaves, treedef = jax.tree_util.tree_flatten(js)
    tmpl = port.init_state()
    names = [n for n, _ in _named(tmpl)]
    out = []
    for name, leaf in zip(names, leaves):
        shape, dtype = leaf.shape, np.dtype(leaf.dtype)
        if name.startswith("hll"):
            x = rng.integers(0, 21, shape)
            x[..., ::7, :] = 0
        elif name == "conntrack.keys":
            x = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
            x[rng.random(shape[:-1]) < 0.25] = 0
        elif name == "conntrack.vals":
            x = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
            x[..., 0] = (rng.integers(0, 1 << 16, shape[:-1])
                         | (rng.integers(0, 2, shape[:-1]) << 31))
        elif dtype == np.float32:
            x = rng.random(shape) * 100
        else:
            x = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
        out.append(np.asarray(x).astype(dtype))
    js = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in out])
    return js, state_from_numpy([x[0] for x in out], tmpl)


def _named(state, prefix=""):
    """(dotted name, tensor) of a port state's leaves, in leaf order."""
    import dataclasses

    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out.append((f"{prefix}{f.name}", v))
        elif dataclasses.is_dataclass(v):
            out += _named(v, f"{prefix}{f.name}.")
    return out


@pytest.mark.parametrize("now", [5, 0xFFFF + 9])
def test_flat_snapshot_layout_and_offsets_match_reference_snapshot_flat(now):
    """At DEPLOYED_CONFIG's widths with a 2^10-slot conntrack table, on a
    random state carried from the reference: the readout's jobs lie in
    ``_sorted_leaves``' order of the snapshot, the layout's shapes and
    dtypes equal the reference ``snapshot_flat``'s leaves (u32 as int32),
    the plan's offsets are the running sums of the reference's leaf sizes,
    and the flat buffer and ``Telemetry.snapshot`` equal the reference's
    (integer words exactly, estimates within rtol 1e-5)."""
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG
    from retina_tpu_torch.parallel.telemetry import _sorted_leaves

    kw = {f.name: getattr(DEPLOYED_CONFIG, f.name)
          for f in __import__("dataclasses").fields(DEPLOYED_CONFIG)}
    kw["conntrack_slots"] = 1 << 10
    ref = ShardedTelemetry(JConfig(**kw), make_mesh(jax.devices()[:1]))
    port = Telemetry(PipelineConfig(**kw), device="cpu")
    js, ts = _random_state(ref, port, 61 + now % 7)
    jflat = np.asarray(ref.snapshot_flat_dispatch(js, now))
    _, jleaves, _ = ref._snapshot_flat
    flat, layout = port.snapshot_flat_dispatch(ts, now)
    leaves = port.readout_jobs(ts)
    snap = port.snapshot(ts, now)
    assert [p for p, *_ in leaves] == [p for p, _ in _sorted_leaves(snap)]
    assert [tuple(x.shape) for x in jleaves] == [shape for _, shape, _ in layout]
    assert [torch.float32 if np.dtype(x.dtype) == np.float32 else torch.int32
            for x in jleaves] == [dtype for *_, dtype in layout]
    sizes = [int(np.prod(x.shape)) for x in jleaves]
    plan = kops.readout_plan([job for _, job, _, _ in leaves])
    assert list(plan.offsets) == [sum(sizes[:i]) for i in range(len(sizes))]
    assert plan.total == sum(sizes) == flat.numel() == jflat.size
    words = flat.numpy().view(np.uint32)
    for (path, shape, dtype), off, n in zip(layout, plan.offsets, sizes):
        a, b = words[off:off + n], jflat[off:off + n]
        if dtype == torch.float32:
            np.testing.assert_allclose(a.view(np.float32), b.view(np.float32), rtol=1e-5,
                                       err_msg=str(path))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    _compare_snapshots(ref.snapshot(js, now), snap)
    assert 0 < int(snap["active_conns"]) < 1 << 10
    est = snap["hll_src_per_pod"]
    assert (est[::7] == 0).all() and (est[1::7] > 0).all()  # the groups all 0 count 0


@pytest.mark.parametrize("cut", ["deployed", "invertible"])
def test_fleet_export_seeds_and_snapshot_host_match_sharded_telemetry(cut):
    """State stepped by the reference is carried into the port (convert.py);
    the export, the seeds and the one-copy snapshot then equal the
    reference's exactly (HLL estimates within rtol 1e-5)."""
    kw = SMALL_CUTS[cut]
    ref = ShardedTelemetry(JConfig(**kw), make_mesh(jax.devices()[:1]))
    port = Telemetry(PipelineConfig(**kw), device="cpu")
    js = ref.init_state()
    ji = JIdentityMap.build_host(PODS, n_slots=1 << 8)
    for i, rec in enumerate(traffic(41, 3)):
        js, _ = ref.step(js, rec[None], np.array([B], np.uint32), clock(0, i), ji,
                         apiserver_ip=API)
    ts = state_from_numpy([np.asarray(x)[0] for x in jax.tree_util.tree_leaves(js)],
                          port.init_state())
    want, got = ref.fleet_export(js), port.fleet_export(ts)
    assert set(got) == set(want)  # the catalog names
    for name, r in want.items():
        r = np.asarray(r)
        a = to_numpy(got[name])
        assert a.dtype == r.dtype and a.shape == r.shape, name
        np.testing.assert_array_equal(a, r, err_msg=name)
    assert ("inv_flow_planes" in got) == (cut == "invertible")
    assert port.fleet_seeds(ts) == ref.fleet_seeds(js)
    now = clock(0, 3)
    _compare_snapshots(ref.snapshot_host(js, now), port.snapshot_host(ts, now))
    flat, layout = port.snapshot_flat_dispatch(ts, now)
    assert flat.dtype == torch.int32 and flat.dim() == 1
    _compare_snapshots(ref.snapshot_host(js, now),
                       port.snapshot_flat_finish(flat.numpy().view(np.uint32), layout))
    # The export is a copy: the window close that follows does not reach it.
    entropy = got["entropy"].clone()
    port.end_window(ts)
    assert torch.equal(got["entropy"], entropy) and float(ts.entropy.counts.sum()) == 0.0
