"""The port's single-card Telemetry against the reference ShardedTelemetry on
a one-device mesh, and state carried from the reference into the port (CPU).

Snapshot rules: same keys, shapes and dtypes (the port's u32 leaves are
int32 bit patterns, so uint32 on the reference side is int32 on the port's);
integer values exactly; HLL estimates within rtol 1e-5 (float32 sums and
logarithms evaluated by two libraries).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

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
from test_torch_pipeline import API, B, PODS, SMALL, compare_states, traffic


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
