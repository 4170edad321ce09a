"""The port's own checks: JAX-free imports, the no-fallback device rule, the
kernel wrappers' dispatch and launch counts, and (marked ``gpu``) every CUDA
kernel against its plain version on the card.

This file imports neither JAX nor retina_tpu, so the ``gpu`` tests run on a
machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Whether a card is present is decided inside the ``card`` fixture; without
one the ``gpu`` tests skip with a reason.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from retina_tpu_torch.events.schema import F
from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip
from retina_tpu_torch.kernels import build
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig, TelemetryPipeline
from retina_tpu_torch.parallel.telemetry import Telemetry
from retina_tpu_torch.u32 import from_numpy

REPO = Path(__file__).resolve().parent.parent
CFG = PipelineConfig(
    n_pods=256, cms_depth=4, cms_width=1 << 12, topk_slots=1 << 8,
    hll_precision=10, entropy_buckets=1 << 9, conntrack_slots=1 << 8,
    latency_slots=1 << 8, enable_conntrack=False, bypass_filter=False,
)
MODULES = [
    "retina_tpu_torch", "retina_tpu_torch.convert", "retina_tpu_torch.kernels.build",
    "retina_tpu_torch.kernels.ops", "retina_tpu_torch.events.synthetic",
    "retina_tpu_torch.models.pipeline", "retina_tpu_torch.parallel.telemetry",
    "retina_tpu_torch.ops.conntrack", "retina_tpu_torch.ops.invertible",
    "retina_tpu_torch.step_profile",
]


def _python(code: str, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=env)


def test_port_imports_without_jax_or_reference():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'retina_tpu' or m.startswith('retina_tpu.')]\n"
        "assert not bad, bad\n"
        "import chip_smoke\n"
        "print('clean')\n"
    )
    proc = _python(code)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TelemetryPipeline(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Telemetry(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IdentityMap.build_host({pod_ip(1): 1}, n_slots=1 << 4)
    assert TelemetryPipeline(CFG, device="cpu").device.type == "cpu"


def _run_steps(pipe, device, n_steps=2, b=2048):
    gen = TrafficGen(n_flows=300, n_pods=200, seed=3)
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, 200)}, n_slots=1 << 9,
                                   device=device)
    state = pipe.init_state()
    for _ in range(n_steps):
        state, _ = pipe.step(state, from_numpy(gen.batch(b), device), b, 1, ident)
    return state


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    kops.reset_launch_counts()
    state = _run_steps(TelemetryPipeline(CFG, device="cpu"), "cpu")
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}
    assert int(state.totals[0]) == 2 * 2048


def test_build_imports_without_nvcc(monkeypatch):
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").exists()
        assert build.library_path(name).parent == REPO / ".torch_kernels"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_wrappers_reject_what_the_kernels_do_not_take():
    rec = torch.zeros((64, 16), dtype=torch.int32)
    w = torch.zeros(64, dtype=torch.int32)
    table = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        kops.hh_update(table, 0, torch.zeros((8, 1), dtype=torch.int32),
                       torch.zeros(8, dtype=torch.int32), 0, [rec[:, 2]], w.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        kops.hll_update(torch.zeros((64, 4), dtype=torch.int32).t(), 0, [rec[:, 2]], None, w)
    with pytest.raises(ValueError, match="power of two"):
        kops.entropy_update(torch.zeros((1, 48)), 0, [rec[:, 2]], w)
    with pytest.raises(ValueError, match="shape"):
        kops.hll_update(torch.zeros((1, 64), dtype=torch.int32), 0, [rec[:10, 2]], None, w)
    with pytest.raises(ValueError, match="unsupported device"):
        kops.entropy_update(torch.zeros((1, 64), device="meta"), 0,
                            [rec[:, 2].to("meta")], w.to("meta"))


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_kernels.py on the GPU machine")
    return torch.device("cuda")


def _pair(fn, *tensors):
    """Run fn on clones through the kernel and through the plain version."""
    a = [t.clone() for t in tensors]
    b = [t.clone() for t in tensors]
    before = kops.launch_counts()
    out_a = fn(*a)
    assert kops.launch_counts() != before, "the kernel was not launched"
    with kops.plain_versions():
        out_b = fn(*b)
    torch.cuda.synchronize()
    return a, b, out_a, out_b


@pytest.mark.gpu
def test_step_rows_kernel_matches_plain(card):
    gen = TrafficGen(n_flows=5000, n_pods=200, seed=4)
    rec = from_numpy(gen.batch(1 << 16), card)
    rec[::7, F.PACKETS] = 100  # exempt rows
    rec[::5, F.TSVAL] = 3
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, 150)}, n_slots=1 << 9,
                                   device=card)
    filt = IdentityMap.build_host({pod_ip(170): 1}, n_slots=1 << 4, device=card)
    state = TelemetryPipeline(CFG, device=card).init_state()
    rects = [state.pod_forward, state.pod_drop, state.pod_tcpflags, state.pod_dns,
             state.pod_retrans, state.node_counters, state.totals]
    for sample_k, n_valid in ((1, 1 << 16), (4, 40000)):
        a, b, out_a, out_b = _pair(
            lambda *r: kops.step_rows(rec, n_valid, sample_k, ident.table, ident.seed,
                                      filt.table, filt.seed, *r, CFG), *rects)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert torch.equal(out_a[0], out_b[0]) and torch.equal(out_a[1], out_b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [1, 2, 4])
def test_hh_update_kernel_matches_plain(card, n_cols):
    rng = np.random.default_rng(n_cols)
    n = 1 << 16
    keys = [from_numpy(rng.integers(0, 500, n).astype(np.uint32), card) for _ in range(n_cols)]
    w = from_numpy(rng.integers(0, 3, n).astype(np.uint32), card)
    tensors = [torch.zeros((4, 1 << 10), dtype=torch.int32, device=card),
               torch.zeros((1 << 6, n_cols), dtype=torch.int32, device=card),
               torch.zeros(1 << 6, dtype=torch.int32, device=card)]
    for _ in range(2):
        a, b, _, _ = _pair(lambda c, k, s: kops.hh_update(c, 1, k, s, 1, keys, w), *tensors)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        tensors = a


@pytest.mark.gpu
def test_hll_update_kernel_matches_plain(card):
    rng = np.random.default_rng(9)
    n = 1 << 16
    keys = [from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32), card)]
    group = from_numpy(rng.integers(0, 70, n).astype(np.uint32), card)  # 64.. dropped
    mask = from_numpy((rng.random(n) < 0.7).astype(np.uint32), card)
    for g, grp in ((64, group), (1, None)):
        regs = torch.zeros((g, 1 << 6), dtype=torch.int32, device=card)
        a, b, _, _ = _pair(lambda r: kops.hll_update(r, 6, keys, grp, mask), regs)
        assert torch.equal(a[0], b[0])


@pytest.mark.gpu
def test_entropy_update_kernel_matches_plain(card):
    rng = np.random.default_rng(10)
    n = 1 << 16
    keys = [from_numpy(rng.integers(0, 1000, n).astype(np.uint32), card) for _ in range(3)]
    w = from_numpy(rng.integers(0, 4, n).astype(np.uint32), card)
    counts = torch.zeros((3, 1 << 9), dtype=torch.float32, device=card)
    a, b, _, _ = _pair(lambda c: kops.entropy_update(c, 7, keys, w), counts)
    assert torch.equal(a[0], b[0])  # integer weights, every bucket < 2^24


@pytest.mark.gpu
def test_pipeline_on_card_matches_cpu(card):
    kops.reset_launch_counts()
    on_card = _run_steps(TelemetryPipeline(CFG, device=card), card)
    counts = kops.launch_counts()
    assert counts == {"step_rows": 2, "hh_update": 18, "hll_update": 6, "entropy_update": 2}
    on_cpu = _run_steps(TelemetryPipeline(CFG, device="cpu"), "cpu")
    from retina_tpu_torch.convert import tensor_leaves

    for x, y in zip(tensor_leaves(on_card), tensor_leaves(on_cpu)):
        assert torch.equal(x.cpu(), y)
