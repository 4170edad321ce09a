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
from retina_tpu_torch.ops import hyperloglog
from retina_tpu_torch.ops.hyperloglog import HyperLogLog
from retina_tpu_torch.ops.invertible import InvertibleSketch
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


# -- constructors -----------------------------------------------------------

SKETCH_ZEROS = {
    "countmin": lambda **kw: CountMinSketch.zeros(4, 1 << 6, **kw),
    "topk_table": lambda **kw: TopKTable.zeros(2, 8, **kw),
    "heavy_hitter": lambda **kw: HeavyHitterSketch.zeros(2, 4, 1 << 6, 8, **kw),
    "entropy": lambda **kw: EntropyWindow.zeros(3, 1 << 6, **kw),
    "anomaly_ewma": lambda **kw: AnomalyEWMA.zeros(3, **kw),
    "hyperloglog": lambda **kw: HyperLogLog.zeros(1, 6, **kw),
    "invertible": lambda **kw: InvertibleSketch.zeros(2, 1 << 4, 2, **kw),
    "conntrack": lambda **kw: ConntrackTable.zeros(1 << 4, **kw),
}


@pytest.mark.parametrize("name", sorted(SKETCH_ZEROS))
def test_sketch_constructors_default_to_the_card(name, monkeypatch):
    """Without ``device=`` a sketch is made on the card, as the reference's
    zeros land on JAX's default device: with no card it raises, and
    ``device="cpu"`` still builds it on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SKETCH_ZEROS[name]()
    sketch = SKETCH_ZEROS[name](device="cpu")
    tensors = [f for f in vars(sketch).values() if isinstance(f, torch.Tensor)]
    tensors += [t for f in vars(sketch).values() if dataclasses.is_dataclass(f)
                for t in vars(f).values() if isinstance(t, torch.Tensor)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)


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
    port = CountMinSketch.zeros(4, 1 << 9, seed=3, device="cpu")
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
    port = TopKTable.zeros(3, s, seed=2, device="cpu")
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
                                   seed=n_cols, device="cpu")
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


def _edge_batch(case: str, n: int = 1 << 12):
    """(key columns (4, n) u32, weights (n,) u32) of a TrafficGen batch
    (Zipf, 1M flows): the 5-tuple's four words and the packet lane, bent
    to one of the inputs K2 and K4 take in a way of their own: "zipf" as
    it comes; "one_key" every row the first row's key; "zero" every weight
    0; "wrap" weights near 2^32, so every sum wraps."""
    b = TrafficGen(n_flows=1_000_000, n_pods=2048, seed=17).batch(n)
    keys = np.stack([b[:, 2], b[:, 3], b[:, 4], (b[:, 5] >> 24) & 0xFF]).astype(np.uint32)
    w = b[:, 7].astype(np.uint32)
    if case == "one_key":
        keys[:] = keys[:, :1]
    elif case == "zero":
        w[:] = 0
    elif case == "wrap":
        w = (0xFFFFFF00 + np.arange(n) % 256).astype(np.uint32)
    return keys, w


def _tied_keys(n_cols, n_slots, width, seed):
    """Two distinct keys in one candidate slot, each at CMS columns no other
    key of the pair shares."""
    rng = np.random.default_rng(5)
    cand = _u32(rng, (n_cols, 4096)).reshape(n_cols, 4096)
    slot = slots(n_slots, seed, [torch.from_numpy(c.astype(np.int64)) for c in cand]).numpy()
    cms = CountMinSketch.zeros(4, width, seed=seed, device="cpu")
    from retina_tpu_torch.ops.countmin import indices

    cols = indices(cms.table, seed, [torch.from_numpy(c.astype(np.int64)) for c in cand])
    cols = cols.numpy()
    for i in range(1, 4096):
        if slot[i] == slot[0] and (cols[:, i] != cols[:, 0]).all():
            return cand[:, [0, i]]
    raise AssertionError("no tied pair")


@pytest.mark.parametrize("case", ["zipf", "one_key", "tie", "zero", "wrap"])
def test_heavy_hitter_update_edge_inputs_match_reference(case):
    """K2's plain version against the reference's HeavyHitterSketch.update
    on the inputs the kernel's per-key sums and per-key offers treat in a
    way of their own: CMS exactly, key rows through _check_topk; on the tie
    the port's rule (the last row in batch order) picks the second key."""
    n_slots, width, seed = 1 << 6, 1 << 12, 4
    if case == "tie":
        pair = _tied_keys(4, n_slots, width, seed)
        keys = pair[:, [0, 1, 0, 1, 1, 0, 0, 1]]  # each key weighs 10; the last row is key 1
        w = np.array([1, 2, 3, 4, 3, 2, 4, 1], np.uint32)
    else:
        keys, w = _edge_batch(case)
    ref = JHH.zeros(4, depth=4, width=width, n_slots=n_slots, seed=seed)
    port = HeavyHitterSketch.zeros(4, depth=4, width=width, n_slots=n_slots, seed=seed,
                                   device="cpu")
    for _ in range(2):
        ref = ref.update([jnp.asarray(k) for k in keys], jnp.asarray(w))
        port.update([_t(k) for k in keys], _t(w))
        np.testing.assert_array_equal(to_numpy(port.cms.table), np.asarray(ref.cms.table))

        def key_est(rows):
            return port.cms.query([torch.from_numpy(rows[:, c].astype(np.int64))
                                   for c in range(4)]).numpy().astype(np.uint32)

        _check_topk(to_numpy(port.table.key_rows), to_numpy(port.table.counts),
                    np.asarray(ref.table.key_rows), np.asarray(ref.table.counts), key_est, seed)
    counts = to_numpy(port.table.counts)
    if case == "zero":
        assert not counts.any() and not to_numpy(port.cms.table).any()
    if case == "tie":
        s = int(slots(n_slots, seed, [torch.from_numpy(pair[c, :1].astype(np.int64))
                                      for c in range(4)])[0])
        assert counts[s] == 20
        np.testing.assert_array_equal(to_numpy(port.table.key_rows)[s], pair[:, 1])


@pytest.mark.parametrize("case", ["zipf", "one_key", "zero", "wrap"])
def test_entropy_update_edge_inputs_match_reference(case):
    """K4's plain version against the reference's EntropyWindow.update (one
    call a group) on the same inputs: buckets below 2^24 exactly, above it
    within a relative 2^-22 (the order of float adds)."""
    keys, w = _edge_batch(case)
    cols = [keys[0], keys[1], keys[2] & 0xFFFF]
    ref = JEntropy.zeros(3, 1 << 12, seed=7)
    port = EntropyWindow.zeros(3, 1 << 12, seed=7, device="cpu")
    for g, c in enumerate(cols):
        ref = ref.update([jnp.asarray(c)], jnp.full((len(w),), g, jnp.uint32), jnp.asarray(w))
    port.update([_t(c) for c in cols], _t(w))
    a, b = port.counts.numpy(), np.asarray(ref.counts)
    err = np.abs(a - b)
    exact = np.maximum(a, b) < 2 ** 24
    assert (err[exact] == 0).all()
    assert (err <= 2.0 ** -22 * np.abs(b)).all()
    assert (a.sum() == 0) == (case == "zero")


# -- HyperLogLog ------------------------------------------------------------


def test_hll_update_and_estimate_match_reference():
    rng = np.random.default_rng(31)
    n, g = 5000, 8
    keys = _keys(rng, n, 3000, 2)
    group = rng.integers(0, g + 2, n).astype(np.uint32)  # g, g+1 out of range: dropped
    mask = rng.random(n) < 0.8
    ref = JHLL.zeros(g, precision=6, seed=5)
    port = HyperLogLog.zeros(g, precision=6, seed=5, device="cpu")
    ref = ref.update([jnp.asarray(k) for k in keys], jnp.asarray(group), jnp.asarray(mask))
    port.update([_t(k) for k in keys], _t(group), torch.from_numpy(mask.astype(np.int32)))
    np.testing.assert_array_equal(to_numpy(port.registers), np.asarray(ref.registers))
    np.testing.assert_allclose(port.estimate().numpy(), np.asarray(ref.estimate()), rtol=1e-5)
    # group None is group 0 of a single bank; rho covers the all-zero rest
    ref1 = JHLL.zeros(1, precision=12, seed=4)
    port1 = HyperLogLog.zeros(1, precision=12, seed=4, device="cpu")
    ref1 = ref1.update([jnp.asarray(k) for k in keys], jnp.zeros(n, jnp.uint32),
                       jnp.asarray(mask))
    port1.update([_t(k) for k in keys], None, torch.from_numpy(mask.astype(np.int32)))
    np.testing.assert_array_equal(to_numpy(port1.registers), np.asarray(ref1.registers))
    np.testing.assert_allclose(port1.estimate().numpy(), np.asarray(ref1.estimate()),
                               rtol=1e-5)


def _rest_zero_keys(rng, n_cols, seed, p, count):
    """``count`` keys of ``n_cols`` columns whose HLL hash leaves rest 0
    (rho = 32 - p + 1), found by search."""
    found = []
    while sum(len(f) for f in found) < count:
        cand = np.stack([_u32(rng, 1 << 20) for _ in range(n_cols)])
        h = jhash_np.hash_cols_np(list(cand), np.uint32(0xC0FFEE + seed))
        found.append(cand[:, (h >> np.uint32(p)) == 0].T)
    return np.concatenate(found)[:count].T


@pytest.mark.parametrize("agg", ["high", "low"])
def test_hll_update_many_matches_three_reference_updates(agg):
    """The step's three banks through one ``update_many`` call against the
    reference step's three updates (retina_tpu/models/pipeline.py:542-550):
    reasons and pods past the banks' groups (dropped), groups whose g * m
    passes 2^32 (u32 arithmetic wraps them into the bank, as the
    reference's), masked rows, and keys whose hash rest is 0. At low
    aggregation the flow bank's mask is the report lane and the pod bank's
    is pod_mask ANDed with it by K3."""
    rng = np.random.default_rng(33 if agg == "high" else 34)
    n, n_reasons, n_pods = 6000, 16, 64
    five = _keys(rng, n, 2500, 4)
    five[:, :8] = _rest_zero_keys(rng, 4, 4, 16, 8)
    five[0, 8:16] = _rest_zero_keys(rng, 1, 5, 12, 8)[0]
    src = five[0]
    mask, is_drop, pod_mask, report = (rng.random((4, n)) < [[0.8], [0.3], [0.5], [0.1]])
    reason = rng.integers(0, n_reasons + 4, n).astype(np.uint32)
    reason[::97] = (1 << 20) + 3  # 2^20 * 2^12 wraps to 0: group 3
    pod_grp = rng.integers(0, n_pods + 8, n).astype(np.uint32)
    pod_grp[::89] = (1 << 26) + 5  # 2^26 * 2^6 wraps to 0: group 5
    mask[:8] = report[:8] = is_drop[8:16] = True  # the rest-0 keys count
    reason[8:16] = 2
    sk_mask = report if agg == "low" else mask
    ref_pod_mask = pod_mask & report if agg == "low" else pod_mask
    banks = [(4, 1, 16), (5, n_reasons, 12), (6, n_pods, 6)]
    refs = [JHLL.zeros(g, precision=p, seed=seed) for seed, g, p in banks]
    refs[0] = refs[0].update([jnp.asarray(k) for k in five], jnp.zeros(n, jnp.uint32),
                             jnp.asarray(sk_mask))
    refs[1] = refs[1].update([jnp.asarray(src)], jnp.asarray(reason), jnp.asarray(is_drop))
    refs[2] = refs[2].update([jnp.asarray(src)], jnp.asarray(pod_grp),
                             jnp.asarray(ref_pod_mask))
    ports = [HyperLogLog.zeros(g, precision=p, seed=seed, device="cpu") for seed, g, p in banks]
    lane = [_t(x.astype(np.uint32)) for x in (mask, is_drop, pod_mask, report)]
    hyperloglog.update_many([
        (ports[0], [_t(k) for k in five], None, lane[3] if agg == "low" else lane[0], None),
        (ports[1], [_t(src)], _t(reason), lane[1], None),
        (ports[2], [_t(src)], _t(pod_grp), lane[2], lane[3] if agg == "low" else None)])
    for r, p in zip(refs, ports):
        np.testing.assert_array_equal(to_numpy(p.registers), np.asarray(r.registers))
    assert int(to_numpy(ports[0].registers).max()) == 32 - 16 + 1
    assert int(to_numpy(ports[1].registers).max()) == 32 - 12 + 1


# -- entropy ------------------------------------------------------------------


def test_entropy_update_and_bits_match_reference():
    rng = np.random.default_rng(41)
    n = 4000
    cols = [_u32(rng, n, 500), _u32(rng, n, 50), _u32(rng, n, 1 << 16)]
    w = rng.integers(0, 3, n).astype(np.uint32)
    ref = JEntropy.zeros(3, 1 << 8, seed=7)
    port = EntropyWindow.zeros(3, 1 << 8, seed=7, device="cpu")
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
    ref, port = JEWMA.zeros(3), AnomalyEWMA.zeros(3, device="cpu")
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
    # ... and after a batch through process, which is ported now.
    cols = [_u32(rng, 200, 1 << 8) for _ in range(3)] + [np.full(200, 6, np.uint32)] * 2
    ref, *_ = ref.process(*map(jnp.asarray, cols), jnp.uint32(120), jnp.asarray(cols[0]),
                          jnp.ones(200, bool))
    port, *_ = port.process(*map(_t, cols), 120, _t(cols[0]), torch.ones(200, dtype=torch.bool))
    for now in (120, 200, 500):
        assert int(port.active_connections(now)) == int(ref.active_connections(now))


def test_traffic_gen_is_bit_identical_to_reference():
    ref = JTrafficGen(n_flows=3000, n_pods=64, seed=9)
    port = TrafficGen(n_flows=3000, n_pods=64, seed=9)
    for n in (1000, 777):
        np.testing.assert_array_equal(port.batch(n), ref.batch(n))
    np.testing.assert_array_equal(port.true_counts(), ref.true_counts())
    np.testing.assert_array_equal(port.true_top_k(20), ref.true_top_k(20))
    fields = {f.name for f in dataclasses.fields(TrafficGen)}
    assert fields <= {f.name for f in dataclasses.fields(JTrafficGen)}

