"""The port's sketch merges against the reference's, and the plain versions
of the N-way folds (K8 ``fold``, K9 ``topk_join``) against chained pairwise
merges (CPU).

Rules: u32 arrays exactly (sums wrap mod 2^32, maxes are unsigned);
entropy histograms of integer weights exactly while every sum stays below
2^24. The candidate-table join is checked on ties, keys that differ only
in a column's top bit, and empty slots, and by hypothesis for the
semilattice laws the fleet tier relies on (associative, commutative,
idempotent).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from retina_tpu.ops.countmin import CountMinSketch as JCMS
from retina_tpu.ops.entropy import EntropyWindow as JEntropy
from retina_tpu.ops.hyperloglog import HyperLogLog as JHLL
from retina_tpu.ops.invertible import InvertibleSketch as JInv
from retina_tpu.ops.topk import HeavyHitterSketch as JHH
from retina_tpu.ops.topk import TopKTable as JTopK
from retina_tpu.timetravel.fold import RangeFold as JRangeFold
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.ops.countmin import CountMinSketch
from retina_tpu_torch.ops.entropy import EntropyWindow
from retina_tpu_torch.ops.hyperloglog import HyperLogLog
from retina_tpu_torch.ops.invertible import InvertibleSketch
from retina_tpu_torch.ops.topk import HeavyHitterSketch, TopKTable
from retina_tpu_torch.timetravel.fold import RangeFold, fold_plain
from retina_tpu_torch.u32 import from_numpy, to_numpy

# Values that make ties and sign trouble likely.
EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint32)


def u32(rng, shape, high=1 << 32):
    return rng.integers(0, high, shape, dtype=np.uint64).astype(np.uint32)


def t(a):
    return from_numpy(a, "cpu")


def topk_arrays(rng, s=64, c=4, edge=True):
    """Candidate keys and counts with many ties: counts and keys drawn from
    EDGES (or small ranges), empty slots zero."""
    if edge:
        keys = EDGES[rng.integers(0, len(EDGES), (s, c))]
        counts = EDGES[rng.integers(0, len(EDGES), s)]
    else:
        keys, counts = u32(rng, (s, c)), u32(rng, s, high=5)
    empty = rng.random(s) < 0.2
    keys[empty], counts[empty] = 0, 0
    return keys, counts


def assert_u32(port: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(to_numpy(port), np.asarray(ref).astype(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_countmin_merge_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = u32(rng, (4, 256)), u32(rng, (4, 256))  # sums wrap mod 2^32
    got = CountMinSketch(t(a), seed=5).merge(CountMinSketch(t(b), seed=5))
    ref = JCMS(table=jnp.asarray(a), seed=5).merge(JCMS(table=jnp.asarray(b), seed=5))
    assert_u32(got.table, ref.table)
    assert got.seed == 5


def test_hll_merge_matches_reference_unsigned():
    rng = np.random.default_rng(3)
    a, b = u32(rng, (8, 64), high=34), u32(rng, (8, 64), high=34)
    a[0, :8] = EDGES  # a register past 2^31 is the larger one, unsigned
    got = HyperLogLog(t(a), seed=4).merge(HyperLogLog(t(b), seed=4))
    ref = JHLL(registers=jnp.asarray(a), seed=4).merge(JHLL(registers=jnp.asarray(b), seed=4))
    assert_u32(got.registers, ref.registers)


def test_entropy_merge_matches_reference_exactly_below_2_24():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 23, (3, 512)).astype(np.float32)
    b = rng.integers(0, 1 << 23, (3, 512)).astype(np.float32)
    got = EntropyWindow(torch.from_numpy(a), seed=7).merge(EntropyWindow(torch.from_numpy(b), 7))
    ref = JEntropy(counts=jnp.asarray(a), seed=7).merge(JEntropy(counts=jnp.asarray(b), seed=7))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))


def test_invertible_merge_matches_reference_and_refuses_other_seeds():
    rng = np.random.default_rng(5)
    pa, pb = u32(rng, (2, 64, 160)), u32(rng, (2, 64, 160))
    wa, wb = u32(rng, (2, 64)), u32(rng, (2, 64))
    got = InvertibleSketch(t(pa), t(wa), seed=9).merge(InvertibleSketch(t(pb), t(wb), seed=9))
    ref = JInv(planes=jnp.asarray(pa), weights=jnp.asarray(wa), seed=9).merge(
        JInv(planes=jnp.asarray(pb), weights=jnp.asarray(wb), seed=9))
    assert_u32(got.planes, ref.planes)
    assert_u32(got.weights, ref.weights)
    with pytest.raises(ValueError, match="seed mismatch"):
        InvertibleSketch(t(pa), t(wa), seed=9).merge(InvertibleSketch(t(pb), t(wb), seed=10))
    with pytest.raises(ValueError, match="seed mismatch"):
        JInv(planes=jnp.asarray(pa), weights=jnp.asarray(wa), seed=9).merge(
            JInv(planes=jnp.asarray(pb), weights=jnp.asarray(wb), seed=10))


@pytest.mark.parametrize("case", ["random", "ties", "edges", "one_column"])
def test_topk_merge_matches_reference(case):
    rng = np.random.default_rng({"random": 6, "ties": 7, "edges": 8, "one_column": 9}[case])
    c = 1 if case == "one_column" else 4
    ka, ca = topk_arrays(rng, c=c, edge=case != "random")
    kb, cb = topk_arrays(rng, c=c, edge=case != "random")
    if case == "ties":
        cb = ca.copy()  # every slot ties on the count
        kb[::2] = ka[::2]  # and half on the whole key row too
        kb[1::4, -1] ^= np.uint32(1 << 31)  # rows that differ only in a top bit
    got = TopKTable(t(ka), t(ca), seed=1).merge(TopKTable(t(kb), t(cb), seed=1))
    ref = JTopK(key_rows=jnp.asarray(ka), counts=jnp.asarray(ca), seed=1).merge(
        JTopK(key_rows=jnp.asarray(kb), counts=jnp.asarray(cb), seed=1))
    assert_u32(got.key_rows, ref.key_rows)
    assert_u32(got.counts, ref.counts)


def test_topk_merge_refuses_other_seeds():
    z = TopKTable.zeros(2, 8, seed=1, device="cpu")
    with pytest.raises(ValueError, match="seed mismatch"):
        z.merge(TopKTable.zeros(2, 8, seed=2, device="cpu"))


def test_heavy_hitter_merge_matches_reference():
    rng = np.random.default_rng(10)
    parts = []
    for _ in range(2):
        cms = u32(rng, (4, 128))
        keys, counts = topk_arrays(rng, s=32, c=2)
        parts.append((cms, keys, counts))
    port = [HeavyHitterSketch(CountMinSketch(t(m), 2), TopKTable(t(k), t(c), 2))
            for m, k, c in parts]
    ref = [JHH(cms=JCMS(table=jnp.asarray(m), seed=2),
               table=JTopK(key_rows=jnp.asarray(k), counts=jnp.asarray(c), seed=2))
           for m, k, c in parts]
    got, want = port[0].merge(port[1]), ref[0].merge(ref[1])
    assert_u32(got.cms.table, want.cms.table)
    assert_u32(got.table.key_rows, want.table.key_rows)
    assert_u32(got.table.counts, want.table.counts)


# -- the semilattice laws (hypothesis) -------------------------------------------

_value = st.sampled_from([int(x) for x in EDGES])


@st.composite
def tables(draw, s=6, c=2):
    keys = np.array(draw(st.lists(_value, min_size=s * c, max_size=s * c)),
                    np.uint32).reshape(s, c)
    counts = np.array(draw(st.lists(_value, min_size=s, max_size=s)), np.uint32)
    return TopKTable(t(keys), t(counts), seed=3)


def same(a: TopKTable, b: TopKTable) -> bool:
    return torch.equal(a.key_rows, b.key_rows) and torch.equal(a.counts, b.counts)


@settings(max_examples=60, deadline=None)
@given(tables(), tables(), tables())
def test_topk_join_is_associative_commutative_idempotent(a, b, c):
    assert same(a.merge(b), b.merge(a))
    assert same(a.merge(b).merge(c), a.merge(b.merge(c)))
    assert same(a.merge(a), a)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(0, (1 << 32) - 1), min_size=3 * 16, max_size=3 * 16))
def test_sum_and_max_merges_are_associative_and_commutative(vals):
    x = np.array(vals, np.uint32).reshape(3, 2, 8)
    cms = [CountMinSketch(t(v), seed=1) for v in x]
    hll = [HyperLogLog(t(v), seed=1) for v in x]
    ent = [EntropyWindow(torch.from_numpy((v >> 9).astype(np.float32)), seed=1) for v in x]
    for sk, leaf in ((cms, "table"), (hll, "registers"), (ent, "counts")):
        a, b, c = sk
        assert torch.equal(getattr(a.merge(b), leaf), getattr(b.merge(a), leaf))
        assert torch.equal(getattr(a.merge(b).merge(c), leaf),
                           getattr(a.merge(b.merge(c)), leaf))


# -- the plain versions of K8 and K9 against chained merges ---------------------


@pytest.mark.parametrize("n", [1, 2, 5, 32])
def test_fold_plain_equals_chained_pairwise_merges(n):
    rng = np.random.default_rng(20 + n)
    cms = u32(rng, (n, 4, 128))
    hll = u32(rng, (n, 16, 64), high=34)
    hll[:, 0, 0] = EDGES[rng.integers(0, len(EDGES), n)]
    ent = rng.integers(0, 1 << 18, (n, 3, 256)).astype(np.float32)
    planes, weights = u32(rng, (n, 2, 32, 160)), u32(rng, (n, 2, 32))
    kops.reset_launch_counts()

    def chain(objs):
        out = objs[0]
        for o in objs[1:]:
            out = out.merge(o)
        return out

    want = chain([CountMinSketch(t(x), 1) for x in cms]).table
    assert torch.equal(kops.fold(t(cms), "sum_u32"), want)
    want = chain([HyperLogLog(t(x), 4) for x in hll]).registers
    assert torch.equal(kops.fold(t(hll), "max_u32"), want)
    want = chain([EntropyWindow(torch.from_numpy(x), 7) for x in ent]).counts
    assert torch.equal(kops.fold(torch.from_numpy(ent), "sum_f32"), want)
    inv = chain([InvertibleSketch(t(p), t(w), 9) for p, w in zip(planes, weights)])
    assert torch.equal(kops.fold(t(planes), "sum_u32"), inv.planes)
    assert torch.equal(kops.fold(t(weights), "sum_u32"), inv.weights)
    # ... and the reference's N-way sums and maxes of the same stacks.
    assert_u32(kops.fold(t(cms), "sum_u32"), jnp.sum(jnp.asarray(cms), axis=0))
    assert_u32(kops.fold(t(hll), "max_u32"), jnp.max(jnp.asarray(hll), axis=0))
    np.testing.assert_array_equal(kops.fold(torch.from_numpy(ent), "sum_f32").numpy(),
                                  np.asarray(jnp.sum(jnp.asarray(ent), axis=0)))
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}  # CPU: plain


@pytest.mark.parametrize("n", [1, 2, 33])
def test_fold_many_equals_per_array_fold_plain_and_the_reference_range_fold(n):
    """One ``fold_many`` call over a catalog of mixed ops, an odd-length
    array among them, equals ``fold_plain`` array by array and the
    reference's ``range_fold`` over the same slots (entropy counts stay
    below 2^24, where the reference's sum is exact)."""
    rng = np.random.default_rng(40 + n)
    slots = []
    for _ in range(n):
        slots.append({
            "flow_cms": u32(rng, (4, 128)),
            "hll_flows": u32(rng, (1, 64), high=34),
            "entropy": rng.integers(0, 1 << 12, (3, 256)).astype(np.float32),
            "totals": u32(rng, (6,)),  # odd length: no 16-byte loads after slot 0
            "inv_flow_weights": u32(rng, (2, 33)),
            "flow_keys": topk_arrays(rng, s=16)[0],
            "flow_counts": topk_arrays(rng, s=16)[1],
        })
    slots[0]["hll_flows"][0, :8] = EDGES
    names = sorted(slots[0])
    ops = {name: "max_u32" if name.startswith("hll_") else
           "sum_f32" if slots[0][name].dtype == np.float32 else "sum_u32"
           for name in names if not name.endswith(("_keys", "_counts"))}

    def stacked(name):
        a = np.stack([s[name] for s in slots])
        return torch.from_numpy(a) if a.dtype == np.float32 else t(a)

    kops.reset_launch_counts()
    got = kops.fold_many([(stacked(name), op) for name, op in ops.items()])
    assert [g.shape for g in got] == [stacked(name).shape[1:] for name in ops]
    for g, (name, op) in zip(got, ops.items()):
        assert torch.equal(g, fold_plain(stacked(name), op)), name
        assert torch.equal(kops.fold(stacked(name), op), g), name
    ref = JRangeFold().fold(slots, {"flow": 3})
    port = RangeFold(device="cpu").fold(slots, {"flow": 3})
    assert sorted(port) == sorted(ref) == names
    for name in names:
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
    for g, name in zip(got, ops):
        np.testing.assert_array_equal(g.numpy().view(ref[name].dtype), ref[name], err_msg=name)
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}  # CPU: plain
    assert kops.fold_many([]) == []
    with pytest.raises(ValueError, match="differ in slots"):
        kops.fold_many([(stacked("totals"), "sum_u32"),
                        (torch.cat([stacked("totals")] * 2), "sum_u32")])
    with pytest.raises(ValueError, match="fold op"):
        kops.fold_many([(stacked("totals"), "min_u32")])
    with pytest.raises(TypeError, match="float32"):
        kops.fold_many([(stacked("totals"), "sum_f32")])


@pytest.mark.parametrize("n", [1, 2, 3, 17])
def test_topk_join_plain_is_the_per_slot_maximum_and_the_reference_fold(n):
    rng = np.random.default_rng(30 + n)
    keys = np.stack([topk_arrays(rng, s=128)[0] for _ in range(n)])
    counts = EDGES[rng.integers(0, 3, (n, 128))]  # counts 0, 1, 2: many ties
    keys[:, :16] = keys[0, :16]  # whole-row ties
    keys[1:, 16:32, 3] ^= np.uint32(1 << 31)  # differ only in the last column's top bit
    counts[:, 32:40] = 0
    keys[:, 32:40] = 0  # empty everywhere
    got_keys, got_counts = kops.topk_join(t(keys), t(counts))
    # The per-slot maximum of (count, key row) as Python ints.
    for s in range(128):
        best = max((int(counts[k, s]), *map(int, keys[k, s])) for k in range(n))
        assert (int(to_numpy(got_counts)[s]), *map(int, to_numpy(got_keys)[s])) == best
    # The reference's chained fold (timetravel/fold.py, fleet/aggregator.py).
    ref = JTopK(key_rows=jnp.asarray(keys[0]), counts=jnp.asarray(counts[0]), seed=1)
    for k in range(1, n):
        ref = ref.merge(JTopK(key_rows=jnp.asarray(keys[k]), counts=jnp.asarray(counts[k]),
                              seed=1))
    assert_u32(got_keys, ref.key_rows)
    assert_u32(got_counts, ref.counts)


def _families(rng, n, shapes=((128, 4), (64, 2), (100, 1))):
    """The three candidate families of a fold (flow C = 4, svc C = 2, dns C =
    1) stacked n deep, at slot counts that are and are not a multiple of
    K9's 32-slot tile: counts 0 to 2 (many ties), whole-row ties, keys that
    differ only in the last column's top bit, and slots empty in every
    table."""
    fams = []
    for s, c in shapes:
        keys = np.stack([topk_arrays(rng, s=s, c=c)[0] for _ in range(n)])
        counts = EDGES[rng.integers(0, 3, (n, s))]
        keys[:, :16] = keys[0, :16]  # the tie reaches the last column
        keys[1:, 16:32, c - 1] ^= np.uint32(1 << 31)
        keys[:, 32:40], counts[:, 32:40] = 0, 0
        fams.append((keys, counts))
    return fams


@pytest.mark.parametrize("n", [1, 2, 3, 32, 64])
def test_topk_join_many_plain_matches_the_reference_chained_merges(n):
    """K9's many-family entry on the CPU (its plain version): each family's
    result equals the reference's TopKTable.merge chained over the n tables
    (fold.py, aggregator.py) and the one-family ``topk_join``; no launch."""
    rng = np.random.default_rng(70 + n)
    fams = _families(rng, n)
    kops.reset_launch_counts()
    got = kops.topk_join_many([(t(k), t(c)) for k, c in fams])
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}
    assert len(got) == len(fams)
    for (keys, counts), (got_keys, got_counts) in zip(fams, got):
        assert got_keys.shape == keys.shape[1:] and got_counts.shape == counts.shape[1:]
        assert got_keys.dtype == got_counts.dtype == torch.int32
        ref = JTopK(key_rows=jnp.asarray(keys[0]), counts=jnp.asarray(counts[0]), seed=1)
        for k in range(1, n):
            ref = ref.merge(JTopK(key_rows=jnp.asarray(keys[k]),
                                  counts=jnp.asarray(counts[k]), seed=1))
        assert_u32(got_keys, ref.key_rows)
        assert_u32(got_counts, ref.counts)
        one_keys, one_counts = kops.topk_join(t(keys), t(counts))
        assert torch.equal(one_keys, got_keys) and torch.equal(one_counts, got_counts)


@pytest.mark.parametrize("n", [1, 3, 32])
def test_range_fold_of_three_families_matches_the_reference(n):
    """The port's RangeFold (``fold_stacked``: K8 for the sums, one K9 call
    for the three families) equals the reference's range fold over the same
    slots, every array exactly."""
    rng = np.random.default_rng(80 + n)
    fams = _families(rng, n)
    slots = [{"flow_cms": u32(rng, (4, 64)), "totals": u32(rng, (6,))} for _ in range(n)]
    for name, (keys, counts) in zip(("flow", "svc", "dns"), fams):
        for i, slot in enumerate(slots):
            slot[f"{name}_keys"], slot[f"{name}_counts"] = keys[i], counts[i]
    ref = JRangeFold().fold(slots, {"flow": 3})
    port = RangeFold(device="cpu").fold(slots, {"flow": 3})
    assert sorted(port) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
