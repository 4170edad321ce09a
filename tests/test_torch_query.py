"""The Count-Min query of several jobs (K10's ``cms_query_many``) and the
window close's verified decode against the reference (CPU, plain versions).

``cms_query_many`` answers a verify of several regions in one call: per job
the point estimates of the decoded keys, then ``decode_verified``'s filter
(ok & est >= min_weight, unsigned; est where ok, else 0). Its plain version
must give, job by job, the reference's ``decode_verified``
(``retina_tpu/ops/invertible.py:229``) exactly, and ``Telemetry.inv_decode``
the reference's ``ShardedTelemetry.inv_decode``
(``retina_tpu/parallel/telemetry.py:646``), on ``TrafficGen`` batches, at
``min_weight`` 0 (the config's default ``invertible_min_weight``) and at one
that rejects some decoded keys. Neither launches a kernel on the CPU.
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
from retina_tpu.ops.countmin import CountMinSketch as JCMS
from retina_tpu.ops.invertible import InvertibleSketch as JInv
from retina_tpu.ops.invertible import decode_verified as jdecode_verified
from retina_tpu.parallel.mesh import make_mesh
from retina_tpu.parallel.telemetry import ShardedTelemetry
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig
from retina_tpu_torch.ops.countmin import CountMinSketch, query_many_plain
from retina_tpu_torch.ops.invertible import InvertibleSketch, decode_verified
from retina_tpu_torch.parallel.telemetry import Telemetry
from retina_tpu_torch.u32 import from_numpy, to_numpy
from test_torch_pipeline import API, B, PODS, SMALL_CUTS, clock, traffic

# The two regions of a verify: (width, seed), as the step's inv_flow and
# inv_hi (a wide main region, a narrow priority one).
REGIONS = ((1 << 8, 11), (1 << 5, 12))


def _flow_keys(rec: np.ndarray) -> np.ndarray:
    """(N, 4) u32 flow keys of records, in the engine's key layout (src,
    dst, ports, proto)."""
    from retina_tpu.events.schema import F

    return np.stack([rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS],
                     rec[:, F.META] >> np.uint32(24)], axis=1).astype(np.uint32)


def _sketches(seed: int):
    """The reference's and the port's two invertible regions and flow CMS
    over three TrafficGen batches, rows split between the regions by a
    priority class (dst in the first 8 pods)."""
    from retina_tpu.events.schema import F

    refs = [JInv.zeros(2, w, n_key_cols=4, seed=s) for w, s in REGIONS]
    ports = [InvertibleSketch.zeros(2, w, n_key_cols=4, seed=s, device="cpu")
             for w, s in REGIONS]
    jcms = JCMS.zeros(depth=4, width=1 << 10, seed=3)
    cms = CountMinSketch.zeros(depth=4, width=1 << 10, seed=3, device="cpu")
    gen = JTrafficGen(n_flows=300, n_pods=48, seed=seed)
    for _ in range(3):
        rec = gen.batch(B)
        keys = _flow_keys(rec)
        w = rec[:, F.PACKETS].astype(np.uint32)
        prio = (rec[:, F.DST_IP] & np.uint32(0xFFFFFFF8)) == np.uint32(0x0A000000)
        jcols = [jnp.asarray(keys[:, i]) for i in range(4)]
        tcols = [from_numpy(keys[:, i], "cpu") for i in range(4)]
        jcms = jcms.update(jcols, jnp.asarray(w))
        cms.update(tcols, from_numpy(w, "cpu"))
        for region, (ref, port) in enumerate(zip(refs, ports)):
            wr = np.where(prio == bool(region), w, 0).astype(np.uint32)
            refs[region] = ref.update(jcols, jnp.asarray(wr))
            port.update(tcols, from_numpy(wr, "cpu"))
    return refs, ports, jcms, cms


def _rejecting_weight(est: np.ndarray, ok: np.ndarray) -> int:
    """A min_weight that rejects some of the decoded keys and keeps some:
    above the lightest verified estimate, at most the heaviest."""
    verified = np.unique(est[ok])
    assert len(verified) >= 2, "the traffic must verify keys of two weights at least"
    return int(verified[len(verified) // 2])


@pytest.mark.parametrize("kind", ["zero", "rejecting", "top bit"])
def test_cms_query_many_plain_matches_reference_decode_verified(kind):
    refs, ports, jcms, cms = _sketches(seed=21)
    decoded = [kops.inv_decode(p.planes, p.weights, p.seed, p.n_key_cols) for p in ports]
    want0 = [jdecode_verified(r, jcms, min_weight=0) for r in refs]
    est0 = np.concatenate([np.asarray(e) for _, e, _ in want0])
    ok0 = np.concatenate([np.asarray(o) for _, _, o in want0])
    min_weight = {"zero": 0, "rejecting": _rejecting_weight(est0, ok0),
                  "top bit": 1 << 31}[kind]
    want = [jdecode_verified(r, jcms, min_weight=min_weight) for r in refs]
    kops.reset_launch_counts()
    est, ok = kops.cms_query_many([(cms.table, cms.seed, list(c), k, min_weight)
                                   for c, k in decoded])
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}
    assert est.dtype == torch.int32 and ok.dtype == torch.bool
    np.testing.assert_array_equal(to_numpy(est), np.concatenate([np.asarray(e)
                                                                  for _, e, _ in want]))
    np.testing.assert_array_equal(ok.numpy(), np.concatenate([np.asarray(o)
                                                              for _, _, o in want]))
    if kind == "rejecting":
        assert 0 < int(ok.sum()) < int(ok0.sum())
    if kind == "top bit":
        assert not ok.any() and not est.any()
    # Each region alone through decode_verified: the same job, one at a time.
    for ref, port, (jcols, jest, jok) in zip(refs, ports, want):
        cols, e, o = decode_verified(port, cms, min_weight=min_weight)
        for a, b in zip(cols, jcols):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
        np.testing.assert_array_equal(to_numpy(e), np.asarray(jest))
        np.testing.assert_array_equal(o.numpy(), np.asarray(jok))


def test_cms_query_many_plain_is_the_query_without_a_mask():
    """A job without a mask is the point query where min_weight is 0, and at
    a min_weight the estimates under it read 0 and not ok; jobs of 0 and 1
    rows and key columns of 1 to 4 words, contiguous and strided."""
    from retina_tpu.ops.countmin import CountMinSketch as J

    rng = np.random.default_rng(5)
    rows = rng.integers(0, 1 << 32, (300, 4), dtype=np.uint64).astype(np.uint32)
    w = rng.integers(1, 50, 300).astype(np.uint32)
    tcols = from_numpy(rows, "cpu")
    cms = CountMinSketch.zeros(depth=4, width=1 << 8, seed=7, device="cpu").update(
        [tcols[:, i] for i in range(4)], from_numpy(w, "cpu"))
    jcms = J.zeros(depth=4, width=1 << 8, seed=7).update(
        [jnp.asarray(rows[:, i]) for i in range(4)], jnp.asarray(w))
    jobs = [(cms.table, cms.seed, [tcols[:, i] for i in range(c)], None, mw)
            for c, mw in ((4, 0), (1, 0), (2, 40), (3, 0))]
    jobs.insert(1, (cms.table, cms.seed, [tcols[:0, 0]], None, 0))
    jobs.append((cms.table, cms.seed, [tcols[:1, 0].clone()], None, 0))
    est, ok = query_many_plain(jobs)
    assert est.shape == ok.shape == (300 * 4 + 1,)
    off = 0
    for _, _, cols, _, mw in jobs:
        n = cols[0].shape[0]
        q = np.asarray(jcms.query([jnp.asarray(to_numpy(c)) for c in cols])).astype(np.uint32)
        keep = q >= mw
        np.testing.assert_array_equal(to_numpy(est[off:off + n]), np.where(keep, q, 0))
        np.testing.assert_array_equal(ok[off:off + n].numpy(), keep)
        off += n
    assert torch.equal(kops.cms_query_many(jobs)[0], est)
    assert torch.equal(kops.cms_query(cms.table, cms.seed, jobs[0][2]), est[:300])


@pytest.mark.parametrize("kind", ["zero", "rejecting"])
def test_inv_decode_matches_sharded_telemetry_on_traffic(kind):
    kw = SMALL_CUTS["invertible"]
    ref = ShardedTelemetry(JConfig(**kw), make_mesh(jax.devices()[:1]))
    port = Telemetry(PipelineConfig(**kw), device="cpu")
    js, ts = ref.init_state(), port.init_state()
    ji = JIdentityMap.build_host(PODS, n_slots=1 << 8)
    ti = IdentityMap.build_host(PODS, n_slots=1 << 8, device="cpu")
    for i, rec in enumerate(traffic(61, 3)):
        js, _ = ref.step(js, rec[None], np.array([B], np.uint32), clock(0, i), ji,
                         apiserver_ip=API)
        ts, _ = port.step(ts, from_numpy(rec, "cpu"), B, clock(0, i), ti, apiserver_ip=API)
    base = ref.inv_decode(js, 0)
    min_weight = 0 if kind == "zero" else _rejecting_weight(np.asarray(base["est"]),
                                                           np.asarray(base["ok"]))
    want = ref.inv_decode(js, min_weight)
    kops.reset_launch_counts()
    got = port.inv_decode(ts, min_weight)
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}
    assert set(got) == set(want)
    for key, r in want.items():
        r = np.asarray(r)
        assert r.shape == tuple(got[key].shape), key
        if r.dtype == bool:
            np.testing.assert_array_equal(got[key].numpy(), r, err_msg=key)
        else:
            assert got[key].dtype == torch.int32, key
            np.testing.assert_array_equal(to_numpy(got[key]).astype(r.dtype), r, err_msg=key)
    n_ok = int(np.asarray(want["ok"]).sum())
    assert n_ok > 0
    if kind == "rejecting":
        assert n_ok < int(np.asarray(base["ok"]).sum())


@pytest.mark.parametrize("kind", ["zero", "rejecting"])
def test_inv_decode_many_plain_matches_sharded_telemetry_regions(kind):
    """K15's many-region entry over the step's two regions (inv_flow tier 0,
    inv_hi tier 1) on TrafficGen traffic gives the reference's
    ``ShardedTelemetry.inv_decode`` keys and tiers, and, through one job of
    K10's plain version over all its rows, the reference's est and ok."""
    kw = SMALL_CUTS["invertible"]
    ref = ShardedTelemetry(JConfig(**kw), make_mesh(jax.devices()[:1]))
    port = Telemetry(PipelineConfig(**kw), device="cpu")
    js, ts = ref.init_state(), port.init_state()
    ji = JIdentityMap.build_host(PODS, n_slots=1 << 8)
    ti = IdentityMap.build_host(PODS, n_slots=1 << 8, device="cpu")
    for i, rec in enumerate(traffic(62, 3)):
        js, _ = ref.step(js, rec[None], np.array([B], np.uint32), clock(0, i), ji,
                         apiserver_ip=API)
        ts, _ = port.step(ts, from_numpy(rec, "cpu"), B, clock(0, i), ti, apiserver_ip=API)
    base = ref.inv_decode(js, 0)
    min_weight = 0 if kind == "zero" else _rejecting_weight(np.asarray(base["est"]),
                                                           np.asarray(base["ok"]))
    want = ref.inv_decode(js, min_weight)
    keys, ok, tier = kops.inv_decode_many([(inv.planes, inv.weights, inv.seed, i)
                                           for i, inv in enumerate((ts.inv_flow, ts.inv_hi))])
    np.testing.assert_array_equal(to_numpy(keys), np.asarray(want["keys"]))
    np.testing.assert_array_equal(to_numpy(tier), np.asarray(want["tier"]))
    cms = ts.flow_hh.cms
    est, vok = query_many_plain([(cms.table, cms.seed, list(keys.t()), ok, min_weight)])
    np.testing.assert_array_equal(to_numpy(est), np.asarray(want["est"]))
    np.testing.assert_array_equal(vok.numpy(), np.asarray(want["ok"]))
    assert int(vok.sum()) > 0
