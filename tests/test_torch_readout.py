"""Parity of the readout programs that K16 and K17 carry with the JAX
reference on the CPU: the window close (``end_window``: entropy bits, the
anomaly EWMA, the histogram reset), the HLL estimate of the snapshot's three
banks, the live-connection count, and ``range_extract``'s cardinality and
entropy bits.

On the CPU the wrappers run the plain versions (``end_window_plain``,
``entropy_bits_plain``, ``estimate_plain``, ``active_connections_plain``)
and launch nothing; the kernels against the plain versions are the ``gpu``
tests of ``tests/test_torch_kernels.py``.

Tolerances: entropy bits, the EWMA mean and the HLL estimates within rtol
1e-5 (float32 sums and log2/log evaluated by two libraries); z-scores
within rtol 1e-5 and atol 1e-4 (a bits difference at float32 rounding
divided by a standard deviation of ~0.05); the EWMA var within rtol 1e-5
and atol 1e-6 (it squares a difference of bits of ~0.1, so the bits'
rounding reaches ~1e-5 of it); anomaly flags, n_obs and the
live-connection count exactly.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retina_tpu.models.pipeline import PipelineConfig as JConfig
from retina_tpu.models.pipeline import TelemetryPipeline as JPipeline
from retina_tpu.ops.conntrack import ConntrackTable as JConntrack
from retina_tpu.ops.hyperloglog import HyperLogLog as JHLL
from retina_tpu.timetravel.fold import range_extract as jrange_extract
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models.pipeline import PipelineConfig, TelemetryPipeline
from retina_tpu_torch.ops.conntrack import (
    CLOCK_SKEW_SLACK,
    CT_NON_TCP_LIFETIME,
    CT_TCP_LIFETIME,
    ConntrackTable,
)
from retina_tpu_torch.ops.hyperloglog import HyperLogLog
from retina_tpu_torch.timetravel.fold import range_extract
from retina_tpu_torch.u32 import from_numpy

SMALL = dict(
    n_pods=64, cms_depth=4, cms_width=1 << 10, topk_slots=1 << 6,
    hll_precision=8, hll_pod_precision=6, entropy_buckets=1 << 8,
    conntrack_slots=1 << 8, latency_slots=1 << 6, enable_conntrack=False,
)
N_WINDOWS = 45
IDLE = {3, 7, 20}  # every group idle
GROUP2_IDLE = {25}  # one group idle, the others active
COLLAPSE = {33, 34}  # group 0's sources collapse into one bucket


def _window_counts(rng: np.random.Generator, w: int, k: int) -> np.ndarray:
    """(3, k) integer-valued float32 histograms of one window."""
    counts = np.zeros((3, k), np.float32)
    if w in IDLE:
        return counts
    for g in range(3):
        if g == 2 and w in GROUP2_IDLE:
            continue
        if g == 0 and w in COLLAPSE:
            counts[g, 7] = 5000.0
            continue
        n = int(rng.integers(500, 3000))
        spread = int(rng.integers(150, k))
        counts[g] = np.bincount(rng.integers(0, spread, n), minlength=k).astype(np.float32)
    return counts


def test_end_window_matches_reference_over_45_windows():
    jp = JPipeline(JConfig(**SMALL))
    jstate = jp.init_state()
    end = jp.jitted_end_window()
    tp = TelemetryPipeline(PipelineConfig(**SMALL), device="cpu")
    tstate = tp.init_state()
    k = SMALL["entropy_buckets"]
    rng = np.random.default_rng(41)
    flagged = []
    kops.reset_launch_counts()
    for w in range(N_WINDOWS):
        counts = _window_counts(rng, w, k)
        jstate = dataclasses.replace(jstate, entropy=dataclasses.replace(
            jstate.entropy, counts=jnp.asarray(counts)))
        tstate.entropy.counts.copy_(torch.from_numpy(counts))
        jstate, jout = end(jstate)
        tstate, tout = tp.end_window(tstate)
        np.testing.assert_allclose(tout["entropy_bits"].numpy(),
                                   np.asarray(jout["entropy_bits"]), rtol=1e-5)
        np.testing.assert_allclose(tout["zscore"].numpy(), np.asarray(jout["zscore"]),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(tout["anomaly"].numpy(), np.asarray(jout["anomaly"]))
        a, ja = tstate.anomaly, jstate.anomaly
        np.testing.assert_array_equal(a.n_obs.numpy(), np.asarray(ja.n_obs))
        np.testing.assert_allclose(a.mean.numpy(), np.asarray(ja.mean), rtol=1e-5)
        np.testing.assert_allclose(a.var.numpy(), np.asarray(ja.var), rtol=1e-5, atol=1e-6)
        assert not tstate.entropy.counts.any()
        flagged.append(bool(tout["anomaly"][0]))
        if w < 10:  # min_windows = 10: no flag before the warm-up
            assert not tout["anomaly"].any()
    assert flagged[33] and not any(flagged[:33])
    # Idle windows took no warm-up credit: group 0 missed three, group 2 four.
    assert tstate.anomaly.n_obs.tolist() == [N_WINDOWS - 3, N_WINDOWS - 3, N_WINDOWS - 4]
    assert kops.launch_counts() == {name: 0 for name in kops.launch_counts()}


def _edge_rows(rng: np.random.Generator, case: str, k: int) -> np.ndarray:
    """(3, k) integer-valued float32 histograms of one window for K16's
    edges: "collapse" each group's mass in one bucket (a different one a
    group), "dense" every bucket nonzero (counts below a bound drawn for
    each window, so that the entropy varies from window to window as
    traffic's does), "bench" random draws over part of the row (the K max
    and uneven-slice rows)."""
    if case == "collapse":
        counts = np.zeros((3, k), np.float32)
        counts[np.arange(3), (977 * np.arange(3) + 5) % k] = float(rng.integers(1, 1 << 20))
        return counts
    if case == "dense":
        return rng.integers(1, 2 ** rng.integers(1, 11, (3, 1)), (3, k)).astype(np.float32)
    return np.stack([np.bincount(rng.integers(0, int(rng.integers(k // 4, k + 1)),
                                              int(rng.integers(500, 4000))),
                                 minlength=k).astype(np.float32) for _ in range(3)])


@pytest.mark.parametrize("case,k", [("collapse", 4096), ("dense", 4096), ("bench", 1 << 14),
                                    ("dense", 1 << 14), ("bench", 4095), ("dense", 1000)])
def test_end_window_plain_matches_reference_at_the_kernel_edges(case, k):
    """K16's plain version against the reference's end_window over 14
    windows (past the EWMA's warm-up) on the rows the kernel's grid treats
    apart: each group's mass in one bucket, every bucket nonzero, K = 16384
    (the wrapper's limit) and rows that 16 blocks a group split into slices
    of uneven length (4095 and 1000 buckets); the bits, z-scores, flags and
    EWMA state at the module's tolerances, the histogram zero after each
    close, and no launch."""
    kw = dict(SMALL, entropy_buckets=k)
    jp = JPipeline(JConfig(**kw))
    jstate = jp.init_state()
    end = jp.jitted_end_window()
    tp = TelemetryPipeline(PipelineConfig(**kw), device="cpu")
    tstate = tp.init_state()
    rng = np.random.default_rng(k + len(case))
    kops.reset_launch_counts()
    for _ in range(14):
        counts = _edge_rows(rng, case, k)
        jstate = dataclasses.replace(jstate, entropy=dataclasses.replace(
            jstate.entropy, counts=jnp.asarray(counts)))
        tstate.entropy.counts.copy_(torch.from_numpy(counts))
        jstate, jout = end(jstate)
        tstate, tout = tp.end_window(tstate)
        np.testing.assert_allclose(tout["entropy_bits"].numpy(),
                                   np.asarray(jout["entropy_bits"]), rtol=1e-5)
        np.testing.assert_allclose(tout["zscore"].numpy(), np.asarray(jout["zscore"]),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(tout["anomaly"].numpy(), np.asarray(jout["anomaly"]))
        a, ja = tstate.anomaly, jstate.anomaly
        np.testing.assert_array_equal(a.n_obs.numpy(), np.asarray(ja.n_obs))
        np.testing.assert_allclose(a.mean.numpy(), np.asarray(ja.mean), rtol=1e-5)
        np.testing.assert_allclose(a.var.numpy(), np.asarray(ja.var), rtol=1e-5, atol=1e-6)
        assert not tstate.entropy.counts.any()
    assert tstate.anomaly.n_obs.tolist() == [14.0, 14.0, 14.0]
    assert kops.launch_counts() == {name: 0 for name in kops.launch_counts()}


def _banks(rng: np.random.Generator) -> dict[str, list[np.ndarray]]:
    """The snapshot's three banks at the deployed widths: mostly-empty
    registers (linear counting), full ones (the raw estimate), all zero."""
    out = {}
    for name, (g, m) in {"hll_flows": (1, 4096), "hll_src_per_reason": (16, 4096),
                         "hll_src_per_pod": (4096, 64)}.items():
        sparse = np.where(rng.random((g, m)) < 0.05,
                          rng.integers(1, 6, (g, m)), 0).astype(np.uint32)
        full = rng.integers(1, 24, (g, m)).astype(np.uint32)
        out[name] = [sparse, full, np.zeros((g, m), np.uint32)]
    return out


def test_hll_estimate_matches_reference_on_the_three_banks():
    rng = np.random.default_rng(42)
    kops.reset_launch_counts()
    for name, cases in _banks(rng).items():
        for regs in cases:
            got = HyperLogLog(registers=from_numpy(regs, "cpu")).estimate().numpy()
            want = np.asarray(JHLL(registers=jnp.asarray(regs)).estimate())
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    assert kops.launch_counts()["hll_estimate"] == 0


def _table(rng: np.random.Generator, n: int, now: int) -> tuple[np.ndarray, np.ndarray]:
    """A conntrack table with empty slots, TCP and non-TCP rows, and idle
    times around every lifetime and inside the skew slack."""
    keys = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    keys[rng.random(n) < 0.25] = 0
    idle = rng.choice(np.array([0, 1, CT_NON_TCP_LIFETIME, CT_NON_TCP_LIFETIME + 1,
                                CT_TCP_LIFETIME, CT_TCP_LIFETIME + 1, 5000,
                                0xFFFF - CLOCK_SKEW_SLACK, 0xFFFF - CLOCK_SKEW_SLACK + 1,
                                0xFFFF]), n)
    seen16 = (now - idle) & 0xFFFF
    tcp = rng.random(n) < 0.5
    meta = (seen16 | (rng.integers(0, 1 << 14, n) << 16) | (tcp.astype(np.int64) << 31))
    vals = rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32)
    vals[:, 0] = meta.astype(np.uint32)
    return keys, vals


@pytest.mark.parametrize("now", [1_700_000_000, 0xFFFF, 0x10000 + 3, 0xFFFFFFFF, 5])
def test_active_connections_matches_reference(now):
    rng = np.random.default_rng(43 + now % 97)
    keys, vals = _table(rng, 1 << 12, now)
    got = ConntrackTable(keys=from_numpy(keys, "cpu"),
                         vals=from_numpy(vals, "cpu")).active_connections(now)
    want = JConntrack(keys=jnp.asarray(keys), vals=jnp.asarray(vals)).active_connections(now)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(want)
    assert 0 < int(got) < int((keys != 0).any(axis=1).sum())


def test_range_extract_cardinality_and_entropy_match_reference():
    rng = np.random.default_rng(44)
    seeds = {"hll_flows": 4, "entropy": 10}
    for regs in _banks(rng)["hll_flows"]:
        merged = {
            "hll_flows": regs,
            "entropy": np.stack([_window_counts(rng, 0, 4096)[g] * (g + 1)
                                 for g in range(3)]).astype(np.float32),
        }
        got = range_extract(merged, seeds, "cpu")
        want = jrange_extract(merged, seeds)
        np.testing.assert_allclose(got["cardinality"], want["cardinality"], rtol=1e-5)
        assert got["entropy_bits"].keys() == want["entropy_bits"].keys()
        for dim, bits in want["entropy_bits"].items():
            np.testing.assert_allclose(got["entropy_bits"][dim], bits, rtol=1e-5)


def test_readout_wrappers_reject_what_the_kernels_do_not_take():
    counts = torch.zeros((3, 256))
    ewma = [torch.zeros(3) for _ in range(3)]
    with pytest.raises(TypeError):
        kops.window_close(counts.double(), *ewma, 0.1, 4.0, 10)
    with pytest.raises(ValueError):
        kops.window_close(counts, torch.zeros(2), *ewma[1:], 0.1, 4.0, 10)
    with pytest.raises(ValueError):
        kops.window_close(counts, torch.zeros(3, device="meta"), *ewma[1:], 0.1, 4.0, 10)
    with pytest.raises(ValueError):
        kops.entropy_bits(torch.zeros(256))
    with pytest.raises(TypeError):
        kops.hll_estimate(torch.zeros((1, 64)))
    with pytest.raises(ValueError):
        kops.hll_estimate(torch.zeros((1, 48), dtype=torch.int32))
    with pytest.raises(ValueError):
        kops.hll_estimate(torch.zeros((1, 64), dtype=torch.int32, device="meta"))
    keys = torch.zeros((16, 2), dtype=torch.int32)
    vals = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        kops.ct_active(keys, vals[:8], 0)
    with pytest.raises(TypeError):
        kops.ct_active(keys.long(), vals, 0)
    with pytest.raises(ValueError):
        kops.ct_active(keys, vals.to("meta"), 0)
    kops.reset_launch_counts()
    bits, flags, z = kops.window_close(counts, *ewma, 0.1, 4.0, 10)
    assert bits.shape == flags.shape == z.shape == (3,) and flags.dtype == torch.bool
    assert kops.entropy_bits(counts).shape == (3,)
    assert kops.hll_estimate(torch.zeros((2, 64), dtype=torch.int32)).shape == (2,)
    assert int(kops.ct_active(keys, vals, 0)) == 0
    assert kops.launch_counts() == {name: 0 for name in kops.launch_counts()}
