"""The port's invertible sketch against the reference's (CPU, plain version).

``update`` must give the same planes and bucket weights exactly (u32 sums
wrap); ``decode`` the same decoded columns, weights and ``ok`` flags, and
``decode_verified`` the same estimates and ``ok`` flags, all exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from retina_tpu.ops.countmin import CountMinSketch as JCMS
from retina_tpu.ops.invertible import InvertibleSketch as JInv
from retina_tpu.ops.invertible import decode_verified as jdecode_verified
from retina_tpu_torch.ops.countmin import CountMinSketch
from retina_tpu_torch.ops.invertible import InvertibleSketch, decode_verified
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
