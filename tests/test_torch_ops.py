"""Parity of the port's operators (retina_tpu_torch.ops) with the JAX reference.

Inputs are made with numpy from a seed and handed to both sides; the port
runs on the CPU, where every kernel wrapper takes its plain version.
Integer results are compared exactly. Float rules, with their reasons:
entropy counts of integer weights are exact (each bucket stays far below
2^24); entropy bits, HLL estimates and the EWMA state come from float32
reductions and transcendental functions that the two libraries evaluate
in different orders and polynomials, so they are held within rtol 1e-5.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retina_tpu.events.synthetic import TrafficGen as JTrafficGen
from retina_tpu.models import identity as jidentity
from retina_tpu.models import pipeline as jpipeline
from retina_tpu.ops import hashing as jhash
from retina_tpu.ops import hashing_np as jhash_np
from retina_tpu.ops.conntrack import ConntrackTable as JConntrack
from retina_tpu.ops.countmin import CountMinSketch as JCMS
from retina_tpu.ops.entropy import AnomalyEWMA as JEWMA
from retina_tpu.ops.entropy import EntropyWindow as JEntropy
from retina_tpu.ops.hyperloglog import HyperLogLog as JHLL
from retina_tpu.ops.topk import HeavyHitterSketch as JHH
from retina_tpu.ops.topk import TopKTable as JTopK
from retina_tpu_torch.events.synthetic import TrafficGen
from retina_tpu_torch.models import identity as tidentity
from retina_tpu_torch.models import pipeline as tpipeline
from retina_tpu_torch.ops import hashing as thash
from retina_tpu_torch.ops.conntrack import ConntrackTable
from retina_tpu_torch.ops.countmin import CountMinSketch
from retina_tpu_torch.ops.entropy import AnomalyEWMA, EntropyWindow
from retina_tpu_torch.ops.hyperloglog import HyperLogLog
from retina_tpu_torch.ops.topk import HeavyHitterSketch, TopKTable, slots
from retina_tpu_torch.u32 import from_numpy, to_numpy

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _u32(rng, n, hi=1 << 32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return from_numpy(np.asarray(a), "cpu")


def _keys(rng, n, n_distinct, n_cols):
    """(n_cols, n) u32 key columns drawn from n_distinct keys (duplicates)."""
    table = np.stack([_u32(rng, n_distinct) for _ in range(n_cols)])
    table[:, 0] = EDGE[-1]  # one key of all-ones words
    table[:, 1] = 0  # one key of zero words
    return table[:, rng.integers(0, n_distinct, n)]


# -- hashing --------------------------------------------------------------


@pytest.mark.parametrize("n_cols", [1, 2, 4])
def test_hash_cols_matches_reference(n_cols):
    rng = np.random.default_rng(n_cols)
    cols = [np.concatenate([EDGE, _u32(rng, 250)]) for _ in range(n_cols)]
    for seed in (0, 1, 0x70CC + 3, 0xFFFFFFFF):
        ref = np.asarray(jhash.hash_cols([jnp.asarray(c) for c in cols], np.uint32(seed)))
        port = thash.hash_cols([_t(c) for c in cols], seed).numpy().astype(np.uint32)
        np.testing.assert_array_equal(port, ref)
        np.testing.assert_array_equal(thash.hash_cols_np(cols, np.uint32(seed)), ref)
        np.testing.assert_array_equal(jhash_np.hash_cols_np(cols, np.uint32(seed)), ref)


def test_fmix32_family_and_reduce_range_match_reference():
    rng = np.random.default_rng(7)
    x = np.concatenate([EDGE, _u32(rng, 500)])
    np.testing.assert_array_equal(
        thash.fmix32(_t(x)).numpy().astype(np.uint32), np.asarray(jhash.fmix32(jnp.asarray(x))))
    np.testing.assert_array_equal(thash.fmix32_np(x), jhash_np.fmix32_np(x))
    # (R, 1) seed broadcast: R independent hashes of a (B,) batch.
    ref = np.asarray(jhash.hash_family(jnp.asarray(x), 4, seed=5))
    port = thash.hash_family(_t(x), 4, seed=5).numpy().astype(np.uint32)
    np.testing.assert_array_equal(port, ref)
    seeds = np.arange(1, 4, dtype=np.uint32).reshape(3, 1) + np.uint32(0xFFFFFFF0)
    ref = np.asarray(jhash.hash_cols([jnp.asarray(x)[None, :]], seeds))
    port = thash.hash_cols([_t(x)[None, :]], torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(port.numpy().astype(np.uint32), ref)
    for width in (1, 64, 1 << 15):
        np.testing.assert_array_equal(
            thash.reduce_range(torch.from_numpy(x.astype(np.int64)), width).numpy(),
            np.asarray(jhash.reduce_range(jnp.asarray(x), width)))
        np.testing.assert_array_equal(thash.reduce_range_np(x, width),
                                      jhash_np.reduce_range_np(x, width))
    with pytest.raises(ValueError):
        thash.reduce_range(torch.zeros(1, dtype=torch.int64), 48)


# -- Count-Min and top-k ----------------------------------------------------


def test_cms_update_and_query_match_reference():
    rng = np.random.default_rng(11)
    n = 2000
    keys = _keys(rng, n, 300, 2)
    w = rng.integers(0, 5, n).astype(np.uint32)
    w[rng.random(n) < 0.2] = 0  # masked rows carry weight 0
    w[:3] = 0xFFFFFFF0  # huge weights: the u32 counters wrap
    ref = JCMS.zeros(4, 1 << 9, seed=3)
    port = CountMinSketch.zeros(4, 1 << 9, seed=3)
    for _ in range(2):
        ref = ref.update([jnp.asarray(k) for k in keys], jnp.asarray(w))
        port.update([_t(k) for k in keys], _t(w))
    np.testing.assert_array_equal(to_numpy(port.table), np.asarray(ref.table))
    q_ref = np.asarray(ref.query([jnp.asarray(k) for k in keys]))
    np.testing.assert_array_equal(port.query([_t(k) for k in keys]).numpy(), q_ref)
    assert int(port.total()) == int(ref.total())


def _check_topk(port_keys, port_counts, ref_keys, ref_counts, key_est, seed):
    """Counts equal exactly. Key rows equal, except where tied estimates
    race: there the port's row must hash to its slot and carry an estimate
    equal to the slot's count (key_est maps a key row to its estimate)."""
    np.testing.assert_array_equal(port_counts, ref_counts)
    diff = np.nonzero((port_keys != ref_keys).any(axis=1))[0]
    if not len(diff):
        return
    s = len(port_counts)
    rows = port_keys[diff]
    slot = slots(s, seed, [torch.from_numpy(rows[:, c].astype(np.int64))
                           for c in range(rows.shape[1])]).numpy()
    np.testing.assert_array_equal(slot, diff)
    np.testing.assert_array_equal(key_est(rows), port_counts[diff])


def test_topk_table_update_matches_reference():
    rng = np.random.default_rng(12)
    n, s = 1500, 64
    keys = _keys(rng, n, 400, 3)
    est = rng.integers(0, 6, n).astype(np.uint32)  # many ties per slot
    est[rng.random(n) < 0.3] = 0
    ref = JTopK.zeros(3, s, seed=2)
    port = TopKTable.zeros(3, s, seed=2)
    for _ in range(2):
        ref = ref.update([jnp.asarray(k) for k in keys], jnp.asarray(est))
        port.update([_t(k) for k in keys], _t(est))
        kk = keys.T

        def key_est(rows):
            # the largest offered estimate of the row's key
            return np.array([est[(kk == r).all(axis=1)].max() for r in rows], np.uint32)

        _check_topk(to_numpy(port.key_rows), to_numpy(port.counts),
                    np.asarray(ref.key_rows), np.asarray(ref.counts), key_est, 2)
    ref_keys, ref_counts = ref.top_k_host(10)
    port_keys, port_counts = port.top_k_host(10)
    np.testing.assert_array_equal(port_counts, ref_counts)


@pytest.mark.parametrize("n_cols", [1, 2, 4])
def test_heavy_hitter_update_matches_reference(n_cols):
    rng = np.random.default_rng(20 + n_cols)
    n = 3000
    ref = JHH.zeros(n_cols, depth=4, width=1 << 8, n_slots=1 << 5, seed=n_cols)
    port = HeavyHitterSketch.zeros(n_cols, depth=4, width=1 << 8, n_slots=1 << 5,
                                   seed=n_cols)
    for _ in range(3):
        keys = _keys(rng, n, 200, n_cols)
        w = rng.integers(1, 4, n).astype(np.uint32)
        w[rng.random(n) < 0.25] = 0
        ref = ref.update([jnp.asarray(k) for k in keys], jnp.asarray(w))
        port.update([_t(k) for k in keys], _t(w))
        np.testing.assert_array_equal(to_numpy(port.cms.table), np.asarray(ref.cms.table))

        def key_est(rows):
            return port.cms.query([torch.from_numpy(rows[:, c].astype(np.int64))
                                   for c in range(n_cols)]).numpy().astype(np.uint32)

        _check_topk(to_numpy(port.table.key_rows), to_numpy(port.table.counts),
                    np.asarray(ref.table.key_rows), np.asarray(ref.table.counts),
                    key_est, n_cols)


# -- HyperLogLog ------------------------------------------------------------


def test_hll_update_and_estimate_match_reference():
    rng = np.random.default_rng(31)
    n, g = 5000, 8
    keys = _keys(rng, n, 3000, 2)
    group = rng.integers(0, g + 2, n).astype(np.uint32)  # g, g+1 out of range: dropped
    mask = rng.random(n) < 0.8
    ref = JHLL.zeros(g, precision=6, seed=5)
    port = HyperLogLog.zeros(g, precision=6, seed=5)
    ref = ref.update([jnp.asarray(k) for k in keys], jnp.asarray(group), jnp.asarray(mask))
    port.update([_t(k) for k in keys], _t(group), torch.from_numpy(mask.astype(np.int32)))
    np.testing.assert_array_equal(to_numpy(port.registers), np.asarray(ref.registers))
    np.testing.assert_allclose(port.estimate().numpy(), np.asarray(ref.estimate()), rtol=1e-5)
    # group None is group 0 of a single bank; rho covers the all-zero rest
    ref1 = JHLL.zeros(1, precision=12, seed=4)
    port1 = HyperLogLog.zeros(1, precision=12, seed=4)
    ref1 = ref1.update([jnp.asarray(k) for k in keys], jnp.zeros(n, jnp.uint32),
                       jnp.asarray(mask))
    port1.update([_t(k) for k in keys], None, torch.from_numpy(mask.astype(np.int32)))
    np.testing.assert_array_equal(to_numpy(port1.registers), np.asarray(ref1.registers))
    np.testing.assert_allclose(port1.estimate().numpy(), np.asarray(ref1.estimate()),
                               rtol=1e-5)


# -- entropy ------------------------------------------------------------------


def test_entropy_update_and_bits_match_reference():
    rng = np.random.default_rng(41)
    n = 4000
    cols = [_u32(rng, n, 500), _u32(rng, n, 50), _u32(rng, n, 1 << 16)]
    w = rng.integers(0, 3, n).astype(np.uint32)
    ref = JEntropy.zeros(3, 1 << 8, seed=7)
    port = EntropyWindow.zeros(3, 1 << 8, seed=7)
    for g, c in enumerate(cols):
        ref = ref.update([jnp.asarray(c)], jnp.full((n,), g, jnp.uint32), jnp.asarray(w))
    port.update([_t(c) for c in cols], _t(w))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_allclose(port.entropy_bits().numpy(), np.asarray(ref.entropy_bits()),
                               rtol=1e-5)
    port.reset()
    assert float(port.counts.abs().sum()) == 0.0


def test_anomaly_ewma_observe_matches_reference():
    rng = np.random.default_rng(42)
    ref, port = JEWMA.zeros(3), AnomalyEWMA.zeros(3)
    flagged = []
    for t in range(16):
        h = (5.0 + 0.01 * rng.standard_normal(3)).astype(np.float32)
        if t == 13:
            h[0] = 1.0  # an attack window: flagged, kept out of the baseline
        active = np.array([t != 4, True, t % 3 != 0])  # idle windows skipped
        ref, f_ref, z_ref = ref.observe(jnp.asarray(h), active=jnp.asarray(active))
        port, f_port, z_port = port.observe(torch.from_numpy(h),
                                            active=torch.from_numpy(active))
        np.testing.assert_array_equal(f_port.numpy(), np.asarray(f_ref))
        flagged.append(bool(f_port[0]))
        np.testing.assert_allclose(z_port.numpy(), np.asarray(z_ref), rtol=1e-4, atol=1e-4)
        for a in ("mean", "var", "n_obs"):
            np.testing.assert_allclose(getattr(port, a).numpy(), np.asarray(getattr(ref, a)),
                                       rtol=1e-5, atol=1e-9)
    assert flagged[13] and sum(flagged) == 1


# -- pipeline helpers, identity, conntrack gauge, traffic -----------------------


def test_step_helpers_match_reference():
    rng = np.random.default_rng(51)
    n = 1000
    x = np.concatenate([EDGE, _u32(rng, n)])
    lo, hi = jpipeline._sum64(jnp.asarray(x))
    t_lo, t_hi = tpipeline._sum64(_t(x))
    assert (int(t_lo), int(t_hi)) == (int(lo), int(hi))
    src, dst = _u32(rng, n), _u32(rng, n)
    src[:50] = 0x0A0B0000 + np.arange(50, dtype=np.uint32)
    pr = np.asarray(jpipeline.priority_class(jnp.asarray(src), jnp.asarray(dst),
                                             0xFFFF0000, 0x0A0B0000))
    tsrc, tdst = torch.from_numpy(src.astype(np.int64)), torch.from_numpy(dst.astype(np.int64))
    tp = tpipeline.priority_class(tsrc, tdst, 0xFFFF0000, 0x0A0B0000)
    np.testing.assert_array_equal(tp.numpy(), pr)
    pk = rng.integers(0, 200, n).astype(np.uint32)
    pk[:5] = 0xFFFFFFFF // 3 + np.arange(5, dtype=np.uint32)  # saturating multiply
    by = _u32(rng, n)
    tsval = np.where(rng.random(n) < 0.1, _u32(rng, n), 0).astype(np.uint32)
    ex = np.asarray(jpipeline.sample_exempt(jnp.asarray(pk), jnp.asarray(tsval),
                                            jnp.zeros(n, jnp.uint32), jnp.asarray(pr), 64))
    tex = tpipeline.sample_exempt(torch.from_numpy(pk.astype(np.int64)),
                                  torch.from_numpy(tsval.astype(np.int64)),
                                  torch.zeros(n, dtype=torch.int64), tp, 64)
    np.testing.assert_array_equal(tex.numpy(), ex)
    for k in (1, 3, 4):
        p_ref, b_ref = jpipeline.ht_rescale(jnp.asarray(pk), jnp.asarray(by),
                                            jnp.asarray(ex), np.uint32(k))
        p_t, b_t = tpipeline.ht_rescale(torch.from_numpy(pk.astype(np.int64)),
                                        torch.from_numpy(by.astype(np.int64)), tex, k)
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_ref))
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_ref))


def test_identity_table_and_lookup_match_reference():
    rng = np.random.default_rng(61)
    ips = np.unique(_u32(rng, 900, 1 << 31)) | np.uint32(1)
    mapping = {int(ip): i + 1 for i, ip in enumerate(ips[:500])}
    ref = jidentity.HostIdentityTable(n_slots=1 << 10, seed=3)
    port = tidentity.HostIdentityTable(n_slots=1 << 10, seed=3)
    for ip, idx in mapping.items():
        ref.insert(ip, idx)
        port.insert(ip, idx)
    for ip in list(mapping)[:40]:
        ref.remove(ip)
        port.remove(ip)
    ref.insert(int(ips[100]), 7)  # overwrite in place
    port.insert(int(ips[100]), 7)
    np.testing.assert_array_equal(port.table, ref.table)
    assert (port.seed, port.n_keys) == (ref.seed, ref.n_keys)
    jmap, tmap = ref.to_device(), port.to_device("cpu")
    probe = np.concatenate([ips, _u32(rng, 300), EDGE])
    np.testing.assert_array_equal(tmap.lookup(_t(probe)).numpy(),
                                  np.asarray(jmap.lookup(jnp.asarray(probe))))
    full = tidentity.IdentityMap.build_host(mapping, n_slots=1 << 10, device="cpu")
    jfull = jidentity.IdentityMap.build_host(mapping, n_slots=1 << 10)
    np.testing.assert_array_equal(to_numpy(full.table), np.asarray(jfull.table))
    with pytest.raises(ValueError, match="overfull"):
        tidentity.IdentityMap.build_host(mapping, n_slots=1 << 9, device="cpu")


def test_active_connections_matches_reference():
    rng = np.random.default_rng(71)
    s = 1 << 10
    keys = np.where(rng.random((s, 2)) < 0.5, _u32(rng, 2 * s).reshape(s, 2), 0).astype(np.uint32)
    meta = (_u32(rng, s, 1 << 16) | (rng.integers(0, 2, s).astype(np.uint32) << 31))
    vals = np.stack([meta, _u32(rng, s), _u32(rng, s), np.zeros(s, np.uint32)], 1)
    ref = JConntrack(jnp.asarray(keys), jnp.asarray(vals.astype(np.uint32)))
    port = ConntrackTable(_t(keys), _t(vals.astype(np.uint32)))
    for now in (0, 100, 30000, 65535, 70000):
        assert int(port.active_connections(now)) == int(ref.active_connections(now))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.process()


def test_traffic_gen_is_bit_identical_to_reference():
    ref = JTrafficGen(n_flows=3000, n_pods=64, seed=9)
    port = TrafficGen(n_flows=3000, n_pods=64, seed=9)
    for n in (1000, 777):
        np.testing.assert_array_equal(port.batch(n), ref.batch(n))
    np.testing.assert_array_equal(port.true_counts(), ref.true_counts())
    np.testing.assert_array_equal(port.true_top_k(20), ref.true_top_k(20))
    fields = {f.name for f in dataclasses.fields(TrafficGen)}
    assert fields <= {f.name for f in dataclasses.fields(JTrafficGen)}

