"""The port's invertible sketch against the reference's (CPU, plain version).

``update`` must give the same planes and bucket weights exactly (u32 sums
wrap); ``decode`` the same decoded columns, weights and ``ok`` flags, and
``decode_verified`` the same estimates and ``ok`` flags, all exactly.
``decode_plain`` (K15's plain version) is held to the reference's decode
where a signed or careless majority would differ: bucket weights of 2^31
and more, ties (p == w - p is no majority), key words with the top bit set,
one and four key columns, and an empty sketch. ``update_pair`` (K6's entry
for the step's two regions) must give each region the reference step's
update under ``where(is_priority, ...)`` exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retina_tpu.ops.countmin import CountMinSketch as JCMS
from retina_tpu.ops.invertible import InvertibleSketch as JInv
from retina_tpu.ops.invertible import decode_verified as jdecode_verified
from retina_tpu_torch.ops.countmin import CountMinSketch
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.ops.invertible import (
    InvertibleSketch,
    decode_plain,
    decode_verified,
    update_pair,
)
from retina_tpu_torch.u32 import from_numpy, to_numpy


def _keys(rng, n, n_cols):
    return rng.integers(0, 1 << 32, (n, n_cols), dtype=np.uint64).astype(np.uint32)


def _pair(depth, width, n_cols, seed, keys, w):
    ref = JInv.zeros(depth, width, n_key_cols=n_cols, seed=seed)
    port = InvertibleSketch.zeros(depth, width, n_key_cols=n_cols, seed=seed, device="cpu")
    for k, wt in zip(keys, w):
        ref = ref.update([jnp.asarray(k[:, i]) for i in range(n_cols)], jnp.asarray(wt))
        port.update([from_numpy(k[:, i], "cpu") for i in range(n_cols)], from_numpy(wt, "cpu"))
    np.testing.assert_array_equal(to_numpy(port.planes), np.asarray(ref.planes))
    np.testing.assert_array_equal(to_numpy(port.weights), np.asarray(ref.weights))
    return ref, port


@pytest.mark.parametrize("n_cols", [1, 2, 4])
def test_update_matches_reference(n_cols):
    rng = np.random.default_rng(n_cols)
    keys = [_keys(rng, 700, n_cols) for _ in range(3)]
    keys[1][::3] = keys[0][:len(keys[1][::3])]  # repeated keys add up
    w = [rng.integers(0, 4, 700).astype(np.uint32) for _ in range(3)]
    w[2][::5] = rng.integers(1 << 30, 1 << 32, len(w[2][::5]), dtype=np.uint64)  # wraps
    _pair(2, 1 << 7, n_cols, 9, keys, w)


def _split(n_cols, keys, w, sel, widths=(1 << 7, 1 << 4), depth=2):
    """The reference step's two updates (retina_tpu/models/pipeline.py:527-534:
    inv_flow takes where(is_priority, 0, w), inv_hi where(is_priority, w, 0))
    against one ``update_pair`` call: both regions' planes and weights equal."""
    jcols = [jnp.asarray(keys[:, i]) for i in range(n_cols)]
    jw, prio = jnp.asarray(w), jnp.asarray(sel != 0)
    ref = [JInv.zeros(depth, widths[0], n_key_cols=n_cols, seed=9).update(
               jcols, jnp.where(prio, 0, jw)),
           JInv.zeros(depth, widths[1], n_key_cols=n_cols, seed=10).update(
               jcols, jnp.where(prio, jw, 0))]
    port = [InvertibleSketch.zeros(depth, wd, n_key_cols=n_cols, seed=9 + i, device="cpu")
            for i, wd in enumerate(widths)]
    update_pair(*port, [from_numpy(keys[:, i], "cpu") for i in range(n_cols)],
                from_numpy(w, "cpu"), from_numpy(sel, "cpu"))
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(to_numpy(p.planes), np.asarray(r.planes))
        np.testing.assert_array_equal(to_numpy(p.weights), np.asarray(r.weights))
    return port


@pytest.mark.parametrize("n_cols", [1, 2, 3, 4])
def test_update_pair_matches_the_reference_split_by_priority(n_cols):
    """A selector that splits the rows (any non-zero value selects), a
    repeated key, zero weights and weights past 2^31, so sums wrap."""
    rng = np.random.default_rng(40 + n_cols)
    n = 900
    keys = _keys(rng, n, n_cols)
    keys[::4] = keys[1]
    w = rng.integers(0, 5, n).astype(np.uint32)
    w[::7] = rng.integers(1 << 31, 1 << 32, len(w[::7]), dtype=np.uint64)
    sel = (rng.random(n) < 0.35) * rng.integers(1, 1 << 32, n, dtype=np.uint64)
    lo, hi = _split(n_cols, keys, w, sel.astype(np.uint32))
    assert lo.weights.any() and hi.weights.any()


@pytest.mark.parametrize("case", ["one_key", "width_one"])
def test_update_pair_matches_the_reference_in_one_bucket(case):
    """Every weighted row in one bucket of each depth: one key for all rows
    ("one_key", its weights summing past 2^32), or distinct keys in sketches
    one bucket wide ("width_one")."""
    rng = np.random.default_rng(len(case))
    n = 700
    keys = _keys(rng, n, 4)
    if case == "one_key":
        keys[:] = keys[0]
    w = rng.integers(1 << 30, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w[::5] = 0
    sel = (np.arange(n) % 3 == 0).astype(np.uint32)
    widths = (1, 1) if case == "width_one" else (1 << 7, 1 << 4)
    lo, hi = _split(4, keys, w, sel, widths=widths)
    assert int((to_numpy(lo.weights) != 0).sum()) <= 2


def test_decode_and_verify_match_reference():
    rng = np.random.default_rng(7)
    heavy, noise = _keys(rng, 32, 4), _keys(rng, 200, 4)
    keys = np.concatenate([heavy, noise])
    w = np.concatenate([np.full(32, 100, np.uint32), np.ones(200, np.uint32)])
    ref, port = _pair(2, 1 << 9, 4, 3, [keys], [w])
    jcms = JCMS.zeros(depth=4, width=1 << 12, seed=1).update(
        [jnp.asarray(keys[:, i]) for i in range(4)], jnp.asarray(w))
    cms = CountMinSketch.zeros(depth=4, width=1 << 12, seed=1, device="cpu").update(
        [from_numpy(keys[:, i], "cpu") for i in range(4)], from_numpy(w, "cpu"))
    jcols, jweight, jok = ref.decode()
    cols, weight, ok = port.decode()
    for j, t in zip(jcols, cols):
        np.testing.assert_array_equal(to_numpy(t), np.asarray(j))
    np.testing.assert_array_equal(to_numpy(weight), np.asarray(jweight))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    for min_weight in (150, 0, 50):
        jcols, jest, jok = jdecode_verified(ref, jcms, min_weight=min_weight)
        cols, est, ok = decode_verified(port, cms, min_weight=min_weight)
        np.testing.assert_array_equal(to_numpy(est), np.asarray(jest))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    found = {tuple(row) for row in np.stack([to_numpy(c) for c in cols], 1)[ok.numpy()]}
    assert found == {tuple(k) for k in heavy}


def test_empty_sketch_decodes_nothing_and_reset_clears():
    rng = np.random.default_rng(4)
    keys, w = _keys(rng, 50, 4), np.full(50, 9, np.uint32)
    _, port = _pair(2, 1 << 6, 4, 0, [keys], [w])
    assert port.decode()[2].any()
    port.reset()
    assert not port.decode()[2].any() and not port.planes.any()


def _edge_arrays(case, n_cols, rng):
    """(planes, weights, keys, key weights) of one edge case; keys and key
    weights are None where the arrays are built directly."""
    depth, width = 2, 1 << 6
    if case == "empty":
        return (np.zeros((depth, width, 32 * (n_cols + 1)), np.uint32),
                np.zeros((depth, width), np.uint32), None, None)
    if case == "tie":
        # Every bucket weight even; a third of the planes exactly half of it,
        # the rest on either side.
        w = rng.integers(1, 1 << 31, (depth, width), dtype=np.uint64) * 2
        frac = rng.choice([0.5, 0.25, 0.75], (depth, width, 32 * (n_cols + 1)))
        planes = (w[:, :, None] * frac).astype(np.uint64)
        return planes.astype(np.uint32), w.astype(np.uint32), None, None
    keys = _keys(rng, 120, n_cols)
    if case == "top_bit":
        keys |= np.uint32(0x80000000)
        wts = np.concatenate([np.full(20, 50, np.uint32), np.ones(100, np.uint32)])
    else:  # "heavy_2_31": heavy keys whose buckets carry 2^31 and more
        wts = np.concatenate([np.full(20, 0xC0000000, np.uint32),
                              rng.integers(1, 1 << 20, 100).astype(np.uint32)])
    return None, None, keys, wts


@pytest.mark.parametrize("n_cols", [1, 4])
@pytest.mark.parametrize("case", ["heavy_2_31", "tie", "top_bit", "empty"])
def test_decode_plain_matches_reference_at_the_edges(case, n_cols):
    rng = np.random.default_rng(11 + n_cols)
    planes, weights, keys, wts = _edge_arrays(case, n_cols, rng)
    if keys is None:
        ref = JInv(planes=jnp.asarray(planes), weights=jnp.asarray(weights), seed=5)
        port = InvertibleSketch(planes=from_numpy(planes, "cpu"),
                                weights=from_numpy(weights, "cpu"), seed=5)
        keys = _keys(rng, 50, n_cols)
        wts = rng.integers(1, 100, 50).astype(np.uint32)
    else:
        ref, port = _pair(2, 1 << 6, n_cols, 5, [keys], [wts])
    if case == "heavy_2_31":
        assert (to_numpy(port.weights) >= 1 << 31).any()
    jcols, jweight, jok = ref.decode()
    kops.reset_launch_counts()
    cols, ok = decode_plain(port.planes, port.weights, port.seed, n_cols)
    assert cols.shape == (n_cols, port.weights.numel()) and cols.dtype == torch.int32
    for j, t in zip(jcols, cols):
        np.testing.assert_array_equal(to_numpy(t), np.asarray(j))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    # The wrapper on CPU tensors is the plain version, and decode returns it.
    dcols, dweight, dok = port.decode()
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}
    for a, b in zip(dcols, cols):
        assert torch.equal(a, b)
    assert torch.equal(dok, ok)
    np.testing.assert_array_equal(to_numpy(dweight), np.asarray(jweight))
    assert dweight.data_ptr() != port.weights.data_ptr()
    if case == "empty":
        assert not ok.any() and not cols.any()
    elif case != "tie":
        assert ok.any()
    jcms = JCMS.zeros(depth=4, width=1 << 10, seed=2).update(
        [jnp.asarray(keys[:, i]) for i in range(n_cols)], jnp.asarray(wts))
    cms = CountMinSketch.zeros(depth=4, width=1 << 10, seed=2, device="cpu").update(
        [from_numpy(keys[:, i], "cpu") for i in range(n_cols)], from_numpy(wts, "cpu"))
    for min_weight in (0, 1 << 31):
        _, jest, jok = jdecode_verified(ref, jcms, min_weight=min_weight)
        _, est, ok = decode_verified(port, cms, min_weight=min_weight)
        np.testing.assert_array_equal(to_numpy(est), np.asarray(jest))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_decode_wrapper_rejects_what_the_kernel_does_not_take():
    inv = InvertibleSketch.zeros(2, 1 << 4, n_key_cols=2, device="cpu")
    with pytest.raises(ValueError, match="planes do not fit"):
        kops.inv_decode(inv.planes, inv.weights, 0, 3)
    with pytest.raises(ValueError, match="1 to 4"):
        kops.inv_decode(torch.zeros((2, 16, 32 * 6), dtype=torch.int32), inv.weights, 0, 5)
    with pytest.raises(ValueError, match="power of two"):
        kops.inv_decode(torch.zeros((2, 12, 96), dtype=torch.int32),
                        torch.zeros((2, 12), dtype=torch.int32), 0, 2)
    with pytest.raises(ValueError, match="shape"):
        kops.inv_decode(inv.planes, inv.weights[:1].clone(), 0, 2)
    with pytest.raises(TypeError, match="int32"):
        kops.inv_decode(inv.planes.long(), inv.weights, 0, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kops.inv_decode(inv.planes.transpose(0, 1), inv.weights, 0, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        kops.inv_decode(inv.planes.to("meta"), inv.weights.to("meta"), 0, 2)
    # The many-region entry: one or two regions of one C on one device.
    region = (inv.planes, inv.weights, 0, 0)
    with pytest.raises(ValueError, match="1 to 2 decode regions"):
        kops.inv_decode_many([])
    with pytest.raises(ValueError, match="1 to 2 decode regions"):
        kops.inv_decode_many([region] * 3)
    other = InvertibleSketch.zeros(2, 1 << 4, n_key_cols=3, device="cpu")
    with pytest.raises(ValueError, match="differ in key columns"):
        kops.inv_decode_many([region, (other.planes, other.weights, 0, 1)])
    with pytest.raises(ValueError, match="is on meta"):
        kops.inv_decode_many([region, (inv.planes.to("meta"), inv.weights.to("meta"), 0, 1)])
    with pytest.raises(ValueError, match="expected \\(2, 16\\)"):
        kops.inv_decode_many([region, (inv.planes, inv.weights[:, :8].contiguous(), 0, 1)])
    with pytest.raises(ValueError, match="do not fit"):
        kops.inv_decode_many([(torch.zeros((2, 16, 100), dtype=torch.int32), inv.weights, 0, 0)])
    with pytest.raises(ValueError, match="do not fit"):
        kops.inv_decode_many([(torch.zeros((2, 16, 32 * 6), dtype=torch.int32), inv.weights,
                               0, 0)])
    with pytest.raises(TypeError, match="int32"):
        kops.inv_decode_many([region, (inv.planes, inv.weights.float(), 0, 1)])
    kops.reset_launch_counts()
    keys, ok, tier = kops.inv_decode_many([(inv.planes[:0], inv.weights[:0], 0, 0)])
    assert keys.shape == (0, 2) and ok.shape == tier.shape == (0,)
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}


def _edge_sketches(case, n_cols, rng, seed):
    """(reference, port) sketches of one edge case of ``_edge_arrays``."""
    planes, weights, keys, wts = _edge_arrays(case, n_cols, rng)
    if keys is None:
        return (JInv(planes=jnp.asarray(planes), weights=jnp.asarray(weights), seed=seed),
                InvertibleSketch(planes=from_numpy(planes, "cpu"),
                                 weights=from_numpy(weights, "cpu"), seed=seed))
    return _pair(2, 1 << 6, n_cols, seed, [keys], [wts])


@pytest.mark.parametrize("n_cols", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["heavy_2_31", "tie", "top_bit", "empty"])
def test_decode_many_plain_matches_reference_at_the_edges(case, n_cols):
    """K15's many-region entry on the CPU (its plain version): an edge-case
    region (tier 0) and a region of heavy keys over noise (tier 1, another
    width and seed) decode end to end to the reference's decode of each,
    keys row-major, and verify through K10's plain version to the
    reference's decode_verified, at min_weight 0 and 2^31; the one-region
    form and ``decode`` give the same rows. No launch."""
    rng = np.random.default_rng(30 + n_cols)
    ref_a, port_a = _edge_sketches(case, n_cols, rng, seed=5)
    heavy = _keys(rng, 40, n_cols)
    ref_b, port_b = _pair(2, 1 << 4, n_cols, 6, [heavy],
                          [rng.integers(1, 60, 40).astype(np.uint32)])
    kops.reset_launch_counts()
    keys, ok, tier = kops.inv_decode_many([(p.planes, p.weights, p.seed, i)
                                           for i, p in enumerate((port_a, port_b))])
    assert keys.dtype == tier.dtype == torch.int32 and ok.dtype == torch.bool
    want_keys, want_ok = [], []
    for ref in (ref_a, ref_b):
        jcols, _, jok = ref.decode()
        want_keys.append(np.stack([np.asarray(c) for c in jcols], axis=1))
        want_ok.append(np.asarray(jok))
    np.testing.assert_array_equal(to_numpy(keys), np.concatenate(want_keys))
    np.testing.assert_array_equal(ok.numpy(), np.concatenate(want_ok))
    np.testing.assert_array_equal(tier.numpy(), np.repeat([0, 1], [port_a.weights.numel(),
                                                                  port_b.weights.numel()]))
    if case == "heavy_2_31":
        assert (to_numpy(port_a.weights) >= 1 << 31).any() and ok.any()
    if case == "empty":
        assert not ok[: port_a.weights.numel()].any()
    flat = np.concatenate([heavy, _keys(rng, 60, n_cols)])
    jcms = JCMS.zeros(depth=4, width=1 << 8, seed=2).update(
        [jnp.asarray(flat[:, i]) for i in range(n_cols)], jnp.asarray(np.full(100, 7, np.uint32)))
    cms = CountMinSketch.zeros(depth=4, width=1 << 8, seed=2, device="cpu").update(
        [from_numpy(flat[:, i], "cpu") for i in range(n_cols)],
        from_numpy(np.full(100, 7, np.uint32), "cpu"))
    for min_weight in (0, 1 << 31):
        est, vok = kops.cms_query_many([(cms.table, cms.seed, list(keys.t()), ok, min_weight)])
        want = [jdecode_verified(r, jcms, min_weight=min_weight) for r in (ref_a, ref_b)]
        np.testing.assert_array_equal(to_numpy(est), np.concatenate([np.asarray(e)
                                                                      for _, e, _ in want]))
        np.testing.assert_array_equal(vok.numpy(), np.concatenate([np.asarray(o)
                                                                   for _, _, o in want]))
    one_keys, one_ok, one_tier = kops.inv_decode_many([(port_b.planes, port_b.weights, 6, 1)])
    n_a = port_a.weights.numel()
    assert torch.equal(one_keys, keys[n_a:]) and torch.equal(one_ok, ok[n_a:])
    assert torch.equal(one_tier, tier[n_a:])
    cols, _, dok = port_a.decode()
    assert torch.equal(torch.stack(cols, dim=1), keys[:n_a]) and torch.equal(dok, ok[:n_a])
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}
