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

import contextlib
import dataclasses
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
from retina_tpu_torch.ops.conntrack import ConntrackTable
from retina_tpu_torch.ops.invertible import InvertibleSketch
from retina_tpu_torch.parallel.telemetry import Telemetry
from retina_tpu_torch.u32 import from_numpy

REPO = Path(__file__).resolve().parent.parent
CFG = PipelineConfig(
    n_pods=256, cms_depth=4, cms_width=1 << 12, topk_slots=1 << 8,
    hll_precision=10, entropy_buckets=1 << 9, conntrack_slots=1 << 8,
    latency_slots=1 << 8, enable_conntrack=False, bypass_filter=False,
)
# Small cuts of DEPLOYED_CONFIG and INVERTIBLE_CONFIG (conntrack on, low
# aggregation); pods 1-15 are the priority class.
DEPLOYED_CUT = dataclasses.replace(CFG, enable_conntrack=True, data_aggregation_level="low")
INVERTIBLE_CUT = dataclasses.replace(
    DEPLOYED_CUT, enable_invertible=True, inv_width=1 << 9, inv_hi_width=1 << 6,
    priority_ip_mask=0xFFFFFFF0, priority_ip_match=pod_ip(0))
MODULES = [
    "retina_tpu_torch", "retina_tpu_torch.convert", "retina_tpu_torch.kernels.build",
    "retina_tpu_torch.kernels.ops", "retina_tpu_torch.events.synthetic",
    "retina_tpu_torch.models.pipeline", "retina_tpu_torch.parallel.telemetry",
    "retina_tpu_torch.ops.conntrack", "retina_tpu_torch.ops.invertible",
    "retina_tpu_torch.step_profile", "retina_tpu_torch.lanes_probe", "retina_tpu_torch.config", "retina_tpu_torch.engine",
    "retina_tpu_torch.native", "retina_tpu_torch.parallel.combine",
    "retina_tpu_torch.parallel.flowdict", "retina_tpu_torch.parallel.partition",
    "retina_tpu_torch.parallel.wire", "retina_tpu_torch.parallel.mesh",
    "retina_tpu_torch.parallel.collectives", "retina_tpu_torch.fleet.codec",
    "retina_tpu_torch.utils._msgpack", "retina_tpu_torch.fleet.aggregator",
    "retina_tpu_torch.fleet.shipper", "retina_tpu_torch.timetravel.ring",
    "retina_tpu_torch.timetravel.fold", "retina_tpu_torch.timetravel.query",
    "retina_tpu_torch.timetravel.autocapture", "retina_tpu_torch.detect",
    "retina_tpu_torch.detect.programs", "retina_tpu_torch.detect.features",
    "retina_tpu_torch.detect.base", "retina_tpu_torch.detect.detectors",
    "retina_tpu_torch.capture.translator", "retina_tpu_torch.capture.outputs",
    "retina_tpu_torch.capture.providers", "retina_tpu_torch.capture.manager",
    "retina_tpu_torch.sources.pcapdecode", "retina_tpu_torch.sources.pcapreplay",
    "retina_tpu_torch.runtime", "retina_tpu_torch.runtime.overload",
    "retina_tpu_torch.plugins",
    "retina_tpu_torch.plugins.api", "retina_tpu_torch.parallel.feed",
    "retina_tpu_torch.utils", "retina_tpu_torch.utils.device_proxy",
    "retina_tpu_torch.ops.countmin", "retina_tpu_torch.log", "retina_tpu_torch.exporter",
    "retina_tpu_torch.metrics", "retina_tpu_torch.utils.metric_names",
    "retina_tpu_torch.utils.buildinfo", "retina_tpu_torch.common", "retina_tpu_torch.pubsub",
    "retina_tpu_torch.crd.types", "retina_tpu_torch.controllers.cache",
    "retina_tpu_torch.managers.filtermanager", "retina_tpu_torch.module.metric_objects",
    "retina_tpu_torch.module.metrics_module", "retina_tpu_torch.plugins.registry",
    "retina_tpu_torch.plugins.conntrack_gc", "retina_tpu_torch.plugins.dropreason",
    "retina_tpu_torch.server", "retina_tpu_torch.runtime.faults",
    "retina_tpu_torch.runtime.supervisor", "retina_tpu_torch.checkpoint",
    "retina_tpu_torch.obs", "retina_tpu_torch.obs.recorder",
    "retina_tpu_torch.events.schema", "retina_tpu_torch.utils.ktime",
    "retina_tpu_torch.sources.procfs", "retina_tpu_torch.plugins.mockplugin",
    "retina_tpu_torch.plugins.packetparser", "retina_tpu_torch.plugins.packetforward",
    "retina_tpu_torch.plugins.dns", "retina_tpu_torch.managers.pluginmanager",
    "retina_tpu_torch.watchers", "retina_tpu_torch.watchers.endpoint",
    "retina_tpu_torch.watchers.apiserver", "retina_tpu_torch.managers.watchermanager",
    "retina_tpu_torch.telemetry", "retina_tpu_torch.module.traces",
    "retina_tpu_torch.managers.controllermanager", "retina_tpu_torch.daemon",
    "retina_tpu_torch.cli", "retina_tpu_torch.hubble", "retina_tpu_torch.hubble.server",
    "retina_tpu_torch.fleet.dryrun", "retina_tpu_torch.timetravel.dryrun",
    "retina_tpu_torch.fleetquery", "retina_tpu_torch.fleetquery.service",
    "retina_tpu_torch.fleetquery.dryrun", "retina_tpu_torch.sources",
    "retina_tpu_torch.sources.gobcodec", "retina_tpu_torch.sources.cilium_monitor",
    "retina_tpu_torch.plugins.framing", "retina_tpu_torch.plugins.externalevents",
    "retina_tpu_torch.plugins.linuxutil", "retina_tpu_torch.plugins.tcpretrans",
    "retina_tpu_torch.plugins.infiniband", "retina_tpu_torch.plugins.ciliumeventobserver",
    "retina_tpu_torch.hubble.flow", "retina_tpu_torch.hubble.monitoragent",
    "retina_tpu_torch.hubble.observer", "retina_tpu_torch.hubble.proto",
    "retina_tpu_torch.hubble.relay", "retina_tpu_torch.fleet.hostsketch",
    "retina_tpu_torch.fleet.node_agent", "retina_tpu_torch.fleet.churn",
    "retina_tpu_torch.ops.hashing_np", "retina_tpu_torch.utils.hostcopy",
    "retina_tpu_torch.operator", "retina_tpu_torch.operator.kubeclient",
    "retina_tpu_torch.operator.kubewatch", "retina_tpu_torch.operator.store",
    "retina_tpu_torch.operator.bridge", "retina_tpu_torch.operator.cilium",
    "retina_tpu_torch.operator.crdinstall", "retina_tpu_torch.operator.leaderelection",
    "retina_tpu_torch.operator.operator", "retina_tpu_torch.capture",
    "retina_tpu_torch.capture.remote", "retina_tpu_torch.capture.managed",
    "retina_tpu_torch.capture.k8s_jobs", "retina_tpu_torch.obs.debug",
    "retina_tpu_torch.soak", "retina_tpu_torch.soak.schedule",
    "retina_tpu_torch.soak.sentinels", "retina_tpu_torch.soak.runner",
    "retina_tpu_torch.e2e", "retina_tpu_torch.e2e.framework",
    "retina_tpu_torch.e2e.prometheus", "retina_tpu_torch.e2e.steps",
    "retina_tpu_torch.e2e.perf", "retina_tpu_torch.e2e.kind",
]


def _python(code: str, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=env)


def test_port_imports_without_jax_or_reference():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['prometheus_client'] = None\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['psutil'] = None\n"
        "sys.modules['grpc'] = None\n"
        "sys.modules['google.protobuf'] = None\n"
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


def _run_steps(pipe, device, n_steps=2, b=2048, summaries=None):
    gen = TrafficGen(n_flows=300, n_pods=200, seed=3)
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, 200)}, n_slots=1 << 9,
                                   device=device)
    state = pipe.init_state()
    for i in range(n_steps):
        state, summ = pipe.step(state, from_numpy(gen.batch(b), device), b - 100 * i,
                                1 + 20 * i, ident)
        if summaries is not None:
            summaries.append(summ)
    return state


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    kops.reset_launch_counts()
    state = _run_steps(TelemetryPipeline(CFG, device="cpu"), "cpu")
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}
    assert int(state.totals[0]) == 2 * 2048 - 100


def test_conntrack_and_invertible_cpu_step_launches_nothing():
    kops.reset_launch_counts()
    summaries = []
    state = _run_steps(TelemetryPipeline(INVERTIBLE_CUT, device="cpu"), "cpu",
                       summaries=summaries)
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}
    assert int(state.totals[6]) == sum(int(s["report_mask"].sum()) for s in summaries) > 0
    assert state.inv_flow.weights.any() and state.inv_hi.weights.any()


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
    inv = InvertibleSketch.zeros(2, 1 << 4, n_key_cols=4, device="cpu")
    with pytest.raises(ValueError, match="planes"):
        kops.inv_update(inv.planes, inv.weights, 0, [rec[:, 2]], w)
    with pytest.raises(ValueError, match="power of two"):
        kops.inv_update(torch.zeros((2, 12, 64), dtype=torch.int32),
                        torch.zeros((2, 12), dtype=torch.int32), 0, [rec[:, 2]], w)
    ct = ConntrackTable.zeros(1 << 4, device="cpu")
    cols = [rec[:, 2], rec[:, 3], rec[:, 4], w, w]
    with pytest.raises(ValueError, match="shape"):
        kops.conntrack_process(ct.keys, ct.vals, 0, *cols, 5, w, w[:10], None, ct.scratch)
    with pytest.raises(TypeError, match="int32"):
        kops.conntrack_process(ct.keys, ct.vals, 0, *cols, 5, w.float(), w, None, ct.scratch)
    with pytest.raises(ValueError, match="shape"):
        kops.conntrack_process(ct.keys[:, :1].contiguous(), ct.vals, 0, *cols, 5, w, w, None,
                               ct.scratch)


def test_hh_update_many_lays_out_one_record_a_sketch(monkeypatch):
    """The three-sketch entry of K2 without a card: the launch is caught
    where it would enter C, and its int64 records (csrc/hh_update.cu's 22
    fields a sketch) are read back: shapes, seeds, strided key lanes, and
    the scratch regions laid end to end (packed words, then each sketch's
    chunk lists and their lengths)."""
    import ctypes

    seen = []

    def launch(name, dev, ptr, n_inst, n, n_launches=1):
        seen.append((name, list((ctypes.c_longlong * (22 * n_inst)).from_address(ptr)),
                     n_inst, n, n_launches))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    n = 5000
    rec = torch.zeros((n, 16), dtype=torch.int32)
    w = torch.ones(n, dtype=torch.int32)
    ups = [(torch.zeros((d, 1 << 10), dtype=torch.int32), 7 + c,
            torch.zeros((64, c), dtype=torch.int32), torch.zeros(64, dtype=torch.int32),
            -1, [rec[:, 2 + i] for i in range(c)], w) for d, c in ((4, 4), (2, 2), (4, 1))]
    kops.hh_update_many(ups)
    (name, f, n_inst, rows, n_launches), = seen
    assert (name, n_inst, rows, n_launches) == ("hh_update", 3, n, 3)
    n_chunks = -(-n // kops.HH_CHUNK)
    rec_ = [f[22 * k:22 * (k + 1)] for k in range(3)]
    for r, (cms, cseed, keys, counts, _, cols, wt) in zip(rec_, ups):
        assert r[:8] == [cms.data_ptr(), *cms.shape, cseed, keys.data_ptr(), counts.data_ptr(),
                         64, 0xFFFFFFFF]
        assert r[11:14] == [wt.data_ptr(), 1, len(cols)]
        assert r[14:22] == ([c.data_ptr() for c in cols] + [0] * (4 - len(cols))
                            + [16] * len(cols) + [0] * (4 - len(cols)))
    assert [r[8] - rec_[0][8] for r in rec_] == [0, 8 * 64, 16 * 64]
    assert rec_[0][9] == rec_[2][8] + 8 * 64
    for k, r in enumerate(rec_):
        assert r[10] == r[9] + 4 * n_chunks * (ups[k][0].shape[0] + 2) * kops.HH_CHUNK
        if k < 2:
            assert rec_[k + 1][9] == r[10] + 4 * n_chunks
    with pytest.raises(ValueError, match="share a state tensor"):
        kops.hh_update_many([ups[0], ups[0]])


def test_hll_update_many_lays_out_one_record_a_bank(monkeypatch):
    """K3's many-bank entry without a card: the launch is caught where it
    would enter C, and its int64 records (csrc/hll_update.cu's 19 fields a
    bank) are read back: bank, groups, precision, seed, strided key lanes,
    group, mask, and the second mask or 0; one launch for the three."""
    import ctypes

    seen = []

    def launch(name, dev, ptr, n_banks, n, n_launches=1):
        seen.append((name, list((ctypes.c_longlong * (19 * n_banks)).from_address(ptr)),
                     n_banks, n, n_launches))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    n = 3000
    rec = torch.zeros((n, 16), dtype=torch.int32)
    lanes = torch.zeros((4, n), dtype=torch.int32)
    five = [rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS], lanes[0]]
    banks = [(torch.zeros((1, 1 << 12), dtype=torch.int32), 4, five, None, lanes[1], None),
             (torch.zeros((16, 1 << 12), dtype=torch.int32), 5, five[:1], lanes[2], lanes[3],
              None),
             (torch.zeros((64, 1 << 6), dtype=torch.int32), -2, five[:1], lanes[0], lanes[1],
              lanes[2])]
    kops.hll_update_many(banks)
    (name, f, n_banks, rows, n_launches), = seen
    assert (name, n_banks, rows, n_launches) == ("hll_update", 3, n, 1)
    for k, (regs, seed, cols, grp, mask, mask2) in enumerate(banks):
        pad = [0] * (4 - len(cols))
        assert f[19 * k:19 * (k + 1)] == [
            regs.data_ptr(), regs.shape[0], regs.shape[1].bit_length() - 1, seed & 0xFFFFFFFF,
            len(cols), *[c.data_ptr() for c in cols], *pad, *[c.stride(0) for c in cols], *pad,
            0 if grp is None else grp.data_ptr(), 0 if grp is None else 1, mask.data_ptr(), 1,
            0 if mask2 is None else mask2.data_ptr(), 0 if mask2 is None else 1]
    assert f[9:13] == [16, 16, 16, 1]  # record lanes at the records' stride
    with pytest.raises(ValueError, match="share a bank"):
        kops.hll_update_many([banks[0], banks[0]])
    with pytest.raises(ValueError, match="1 to 3"):
        kops.hll_update_many(banks + banks[:1])


def test_inv_update_pair_lays_out_its_regions_and_scratch(monkeypatch):
    """K6's two-region entry without a card: the launch is caught where it
    would enter C; its region records (5 int64 fields each), lanes and the
    scratch regions laid end to end (entries, pairs, the tile table) are
    read back; one region takes no selector, two need one."""
    import ctypes

    seen = []

    def launch(name, dev, ptr, n_regions, *args, n_launches=1):
        seen.append((name, list((ctypes.c_longlong * (5 * n_regions)).from_address(ptr)),
                     n_regions, args, n_launches))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    n = 5000
    rec = torch.zeros((n, 16), dtype=torch.int32)
    w, sel = torch.ones((2, n), dtype=torch.int32)
    cols = [rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS], w]
    lo = InvertibleSketch.zeros(2, 1 << 9, n_key_cols=4, seed=9, device="cpu")
    hi = InvertibleSketch.zeros(2, 1 << 6, n_key_cols=4, seed=10, device="cpu")
    regions = [(lo.planes, lo.weights, 9), (hi.planes, hi.weights, 10)]
    kops.inv_update_pair(regions, cols, w, sel)
    kops.inv_update_pair(regions[1:], cols, w)
    (name, f, n_regions, args, n_launches), (_, f1, n1, args1, _) = seen
    assert (name, n_regions, n_launches, n1) == ("inv_update", 2, 2, 1)
    assert f == [lo.planes.data_ptr(), lo.weights.data_ptr(), 2, 1 << 9, 9,
                 hi.planes.data_ptr(), hi.weights.data_ptr(), 2, 1 << 6, 10] and f1 == f[5:]
    assert list(args[:9]) == [*[x for c in cols for x in (c.data_ptr(), c.stride(0))], 4]
    assert list(args[9:14]) == [w.data_ptr(), 1, sel.data_ptr(), 1, n]
    assert list(args1[11:13]) == [None, 0]
    n_ent = -(-n // kops.INV_CHUNK) * kops.INV_CHUNK
    entries, pairs, seg = args[14:17]
    assert (pairs - entries, seg - pairs) == (4 * 8 * n_ent, 4 * 2 * n_ent)
    with pytest.raises(ValueError, match="selector"):
        kops.inv_update_pair(regions[:1], cols, w, sel)
    with pytest.raises(ValueError, match="selector"):
        kops.inv_update_pair(regions, cols, w)
    with pytest.raises(ValueError, match="share"):
        kops.inv_update_pair([regions[0], regions[0]], cols, w, sel)
    deep = InvertibleSketch.zeros(kops.INV_MAX_DEPTH + 1, 1 << 4, n_key_cols=4, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        kops.inv_update_pair([(deep.planes, deep.weights, 0)], cols, w)


def test_fold_many_lays_out_one_record_an_array(monkeypatch):
    """K8's many-array entry without a card: the launch is caught where it
    would enter C, and its int64 records (csrc/fold.cu's 4 fields an array:
    source, elements a slot, op, output) are read back. Arrays with no
    element take no record; the rest go 32 a launch."""
    import ctypes

    seen = []

    def launch(name, dev, ptr, n_arrays, n_slots, n_launches=1):
        seen.append((name, list((ctypes.c_longlong * (4 * n_arrays)).from_address(ptr)),
                     n_slots, n_launches))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    ops = ["sum_u32", "sum_f32", "max_u32"]
    items = [(torch.zeros((3, k + 1), dtype=torch.float32 if k % 3 == 1 else torch.int32),
              ops[k % 3]) for k in range(35)]
    items.insert(5, (torch.zeros((3, 2, 0), dtype=torch.int32), "sum_u32"))
    outs = kops.fold_many(items)
    assert [o.shape for o in outs] == [x.shape[1:] for x, _ in items]
    assert [o.dtype for o in outs] == [x.dtype for x, _ in items]
    assert [(name, len(f) // 4, n, nl) for name, f, n, nl in seen] == [
        ("fold", 32, 3, 1), ("fold", 3, 3, 1)]
    fields = seen[0][1] + seen[1][1]
    live = [(x, op, o) for (x, op), o in zip(items, outs) if o.numel()]
    assert fields == [v for x, op, o in live
                      for v in (x.data_ptr(), o.numel(), kops.FOLD_OPS[op], o.data_ptr())]


def test_snapshot_flat_lays_out_one_job_a_leaf(monkeypatch):
    """K17's one-launch readout without a card: the launch is caught where
    it would enter C, and its table (csrc/snapshot_readout.cu's Table, read
    back through ``kops._ReadoutTable``) is read: a job a snapshot leaf in
    ``_sorted_leaves`` order, each at the offset of its leaf in the flat
    layout, blocks in proportion to its bytes, the live count's clock and
    lifetimes; the table's size matches the kernel's static_assert. A
    second readout of the same state reuses the plan."""
    import ctypes

    from retina_tpu_torch.ops.conntrack import (
        CLOCK_SKEW_SLACK,
        CT_NON_TCP_LIFETIME,
        CT_TCP_LIFETIME,
    )
    from retina_tpu_torch.ops.hyperloglog import _alpha
    from retina_tpu_torch.parallel.telemetry import _sorted_leaves

    src = (REPO / "retina_tpu_torch/kernels/csrc/snapshot_readout.cu").read_text()
    assert f"kMaxJobs = {kops.READOUT_MAX_JOBS};" in src
    assert ctypes.sizeof(kops._ReadoutJob) == 48 and "sizeof(Job) == 48" in src
    assert ctypes.sizeof(kops._ReadoutTable) == 40 + 48 * kops.READOUT_MAX_JOBS
    assert "sizeof(Table) == 40 + 48 * kMaxJobs" in src
    seen = []

    def launch(name, dev, ptr, n_launches=1):
        t = kops._ReadoutTable.from_address(ptr)
        seen.append((name, t.out, t.now, t.tcp_life, t.other_life, t.wrap_floor, t.n_blocks,
                     [(j.kind, j.block0, j.dst, j.n, j.src, j.src2, j.m, j.alpha_mm)
                      for j in t.jobs[:t.n_jobs]]))

    tel = Telemetry(DEPLOYED_CUT, device="cpu")
    state = _run_steps(tel.pipeline, "cpu")
    paths = [p for p, _ in _sorted_leaves(tel.snapshot(state, 77))]
    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    monkeypatch.setattr(kops, "_stream_key", lambda dev: (0, 0))
    monkeypatch.setattr(kops, "_ct_scratch", {})
    flat, layout = tel.snapshot_flat_dispatch(state, 77)
    tel.snapshot_flat_dispatch(state, 78)
    (name, out, now, tcp, other, floor, n_blocks, jobs), again = seen
    assert (name, out, now, tcp, other, floor) == (
        "snapshot_flat", flat.data_ptr(), 77, CT_TCP_LIFETIME, CT_NON_TCP_LIFETIME,
        0xFFFF - CLOCK_SKEW_SLACK)
    assert again[2] == 78 and again[7] == jobs
    leaves = tel.readout_jobs(state)
    assert [p for p, *_ in leaves] == paths
    assert [(p, shape, dtype) for p, _, shape, dtype in leaves] == layout
    off = block0 = 0
    for (kind, b0, dst, n, ptr, ptr2, m, alpha_mm), (_, job, shape, _) in zip(jobs, leaves):
        t = job[1]
        assert (b0, dst, ptr) == (block0, off, t.data_ptr())
        if job[0] == "copy":
            assert (kind, n) == (0, t.numel())
            words = t.numel()
        elif job[0] == "hll":
            g, mm = t.shape
            assert (kind, n, m) == (2 if 4 <= mm <= 128 else 1, g, mm)
            assert alpha_mm == pytest.approx(_alpha(mm) * mm * mm, rel=1e-6)
            words = g
        else:
            assert (kind, n, ptr2) == (3, t.shape[0], job[2].data_ptr())
            words = 1
        # Blocks in proportion to the bytes read and written, within the
        # job's parallelism: a block a 1024 words copied, a group (a block
        # a group) or 1024 / m groups (m / 4 lanes a group),
        # READOUT_LIVE_BLOCKS.
        nbytes = {"copy": 8 * words, "hll": 4 * t.numel() + 4 * words,
                  "live": 24 * t.shape[0] + 4}[job[0]]
        cap = {0: -(-words // 1024), 1: words, 2: -(-words * m // 1024),
               3: kops.READOUT_LIVE_BLOCKS}[kind]
        blocks = kops.readout_plan([job]).blocks[0]
        assert blocks == max(1, min(cap, -(-nbytes // kops.READOUT_BLOCK_BYTES)))
        block0 += blocks
        off += words
    assert n_blocks == block0 and flat.shape == (off,)
    assert int(np.prod(layout[0][1])) == 1 and layout[0][0] == ("active_conns",)


def test_conntrack_wrapper_keeps_its_batch_scratch(monkeypatch):
    """K5's scratch without a card: 2B key slots (the next power of two, at
    least two chunks' worth) of 32 bytes, each free (zero accumulators, the
    key ~0), a 32-byte record for each connection a batch can hold (a region
    of 2048 a chunk) and a record count a chunk, and the winner words; a
    second batch reuses it."""
    seen = []

    def launch(name, dev, *args, n_launches=1):
        seen.append((name, args, n_launches))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    ct = ConntrackTable.zeros(1 << 6, device="cpu")
    b = 3000
    w = torch.ones(b, dtype=torch.int32)
    rec = torch.zeros((b, 16), dtype=torch.int32)
    cols = [rec[:, 2], rec[:, 3], rec[:, 4], w, w]
    out = ct.process_lanes(*cols, 5, w, w, None)
    assert out.shape == (4, b)
    sc = dict(ct.scratch)
    assert sc["key_slots"] == 8192
    free = torch.tensor([0, 0, 0, 0, -1, -1, 0, 0], dtype=torch.int32)
    assert torch.equal(sc["slots"], free.repeat(8192, 1))
    assert sc["rec"].shape == (4096, kops.CT_RECORD_WORDS) and sc["count"].shape == (2,)
    assert sc["winner"].shape == (64,) and sc["winner"].dtype == torch.int64
    assert kops.conntrack_scratch_bytes(ct.scratch) == 8192 * 32 + 4096 * 32 + 2 * 4 + 64 * 8
    (name, args, n_launches), = seen
    assert (name, n_launches) == ("conntrack", 2)
    assert args[20:] == (b, 5, sc["slots"].data_ptr(), 8192, sc["rec"].data_ptr(),
                         sc["count"].data_ptr(), sc["winner"].data_ptr(), out.data_ptr())
    ct.process_lanes(*[c[:100] for c in cols], 6, w[:100], w[:100], None)
    assert all(ct.scratch[k] is sc[k] for k in ("slots", "rec", "count", "winner"))
    assert len(seen) == 2 and seen[1][1][22:26] == args[22:26]
    small = ConntrackTable.zeros(1 << 6, device="cpu")
    small.process_lanes(*[c[:10] for c in cols], 5, w[:10], w[:10], None)
    assert small.scratch["key_slots"] == 4096 and small.scratch["count"].shape == (1,)


def test_step_rows_lists_the_probes_that_latency_update_finishes(monkeypatch):
    """K1's probe list for K14 without a card: the launches are caught where
    they would enter C. step_rows with an apiserver passes it and the list's
    count and entries and marks the list filled for its records;
    latency_update on those records and that apiserver finishes it in one
    launch; with no list filled for its records it raises; a list filled
    and never finished is cleared by the next step_rows; an empty batch
    launches nothing."""
    seen = []

    def launch(name, dev, *args, n_launches=1):
        seen.append((name, args, n_launches))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    monkeypatch.setattr(kops, "_stream_key", lambda dev: (0, 0))
    monkeypatch.setattr(kops, "_latency_scratch", {})
    st = TelemetryPipeline(CFG, device="cpu").init_state()
    ident = IdentityMap.build_host({pod_ip(1): 1}, n_slots=1 << 4, device="cpu")
    rec = torch.zeros((3000, 16), dtype=torch.int32)
    mask = torch.ones(3000, dtype=torch.int32)
    lat = [st.lat_key, st.lat_ts, st.lat_hist]

    def k1(r, api):
        return kops.step_rows(r, r.shape[0], 1, ident.table, ident.seed, None, 0,
                              st.pod_forward, st.pod_drop, st.pod_tcpflags, st.pod_dns,
                              st.pod_retrans, st.node_counters, st.totals, CFG,
                              apiserver_ip=api)

    k1(rec, None)
    assert seen[-1][0] == "step_rows" and seen[-1][1][-3:] == (0, None, None)
    with pytest.raises(ValueError, match="no probe list"):
        kops.latency_update(*lat, rec, mask, API)
    k1(rec, API)
    lst = kops._latency_scratch[(0, 0)]
    assert seen[-1][1][-3:] == (API, lst["count"].data_ptr(), lst["entries"].data_ptr())
    assert lst["entries"].shape == (1 << 16, 4)
    for other in ((rec, 0), (rec.clone(), API)):  # another apiserver, other records
        with pytest.raises(ValueError, match="no probe list"):
            kops.latency_update(*lat, other[0], mask, other[1])
    kops.latency_update(*lat, rec, mask, API)
    assert seen[-1] == ("latency_update", (
        lst["count"].data_ptr(), lst["entries"].data_ptr(), st.lat_key.data_ptr(),
        st.lat_ts.data_ptr(), CFG.latency_slots, st.lat_hist.data_ptr(), CFG.latency_buckets),
        1)
    with pytest.raises(ValueError, match="no probe list"):  # finished
        kops.latency_update(*lat, rec, mask, API)
    k1(rec, API)
    lst["count"].fill_(7)  # what the kernel listed; no latency_update follows
    k1(rec, API)
    assert int(lst["count"]) == 0 and lst["pending"] == (rec.data_ptr(), 3000, API)
    n = len(seen)
    scratch, sums = k1(rec[:0], API)
    assert len(seen) == n and scratch.shape == (len(kops.SCRATCH), 0) and not sums.any()


def test_ingest_wrappers_reject_what_the_kernels_do_not_take():
    wire = torch.zeros((64, 12), dtype=torch.int32)
    table = torch.zeros((16, 12), dtype=torch.int32)
    winner = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="bucket, 16"):
        kops.ingest_packed(wire, False, 0, 0, 64)
    with pytest.raises(ValueError, match="cannot hold"):
        kops.ingest_packed(wire, True, 0, 0, 32)
    with pytest.raises(ValueError, match="bucket, 13"):
        kops.ingest_new(wire, table, winner, 0, 0, 64)
    with pytest.raises(ValueError, match="shape"):
        kops.ingest_new(torch.zeros((64, 13), dtype=torch.int32), table, winner[:8], 0, 0, 64)
    with pytest.raises(ValueError, match="slots, 12"):
        kops.ingest_known(torch.zeros(200, dtype=torch.int32), 64, True, 4, table[:, :8].clone(), 1, 0,
                          0, 64)
    with pytest.raises(ValueError, match="words"):
        kops.ingest_known(torch.zeros(10, dtype=torch.int32), 64, True, 4, table, 1, 0, 0, 64)
    with pytest.raises(ValueError, match="id_bits"):
        kops.ingest_known(torch.zeros((64, 2), dtype=torch.int32), 64, False, 33, table, 1, 0,
                          0, 64)
    with pytest.raises(ValueError, match="expected 64"):
        kops.ingest_known(torch.zeros((60, 2), dtype=torch.int32), 64, False, 4, table, 1, 0,
                          0, 64)


def test_fold_join_and_query_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="fold op"):
        kops.fold(x, "mean")
    with pytest.raises(TypeError, match="float32"):
        kops.fold(x, "sum_f32")
    with pytest.raises(TypeError, match="int32"):
        kops.fold(x.float(), "max_u32")
    with pytest.raises(ValueError, match="at least one slot"):
        kops.fold(x[:0], "sum_u32")
    with pytest.raises(ValueError, match="contiguous"):
        kops.fold(x.t(), "sum_u32")
    keys = torch.zeros((3, 16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        kops.topk_join(keys, torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="N >= 1"):
        kops.topk_join(keys[0], torch.zeros((16,), dtype=torch.int32))
    table = torch.zeros((4, 64), dtype=torch.int32)
    col = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        kops.cms_query(torch.zeros((4, 48), dtype=torch.int32), 0, [col])
    with pytest.raises(ValueError, match="key column"):
        kops.cms_query(table, 0, [])
    with pytest.raises(ValueError, match="shape"):
        kops.cms_query(table, 0, [col, col[:5]])
    with pytest.raises(TypeError, match="int32"):
        kops.cms_query(table, 0, [col.long()])
    fam = (keys, torch.zeros((3, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="1 to 3 candidate families"):
        kops.topk_join_many([])
    with pytest.raises(ValueError, match="1 to 3 candidate families"):
        kops.topk_join_many([fam] * 4)
    with pytest.raises(ValueError, match="1 to 4 columns"):
        kops.topk_join_many([fam, (torch.zeros((3, 16, 5), dtype=torch.int32), fam[1])])
    with pytest.raises(ValueError, match="expected \\(3, 16\\)"):
        kops.topk_join_many([fam, (keys[:, :, :2].contiguous(), fam[1][:, :8].contiguous())])
    with pytest.raises(ValueError, match="is on meta"):
        kops.topk_join_many([fam, (keys.to("meta"), fam[1].to("meta"))])
    with pytest.raises(ValueError, match="contiguous"):
        kops.topk_join_many([(keys.transpose(1, 2).contiguous().transpose(1, 2), fam[1])])
    kops.reset_launch_counts()
    assert kops.cms_query(table, 0, [col[:0]]).shape == (0,)
    assert kops.fold(torch.zeros((3, 0), dtype=torch.int32), "sum_u32").shape == (0,)
    (ek, ec), = kops.topk_join_many([(keys[:, :0].contiguous(), fam[1][:, :0].contiguous())])
    assert ek.shape == (0, 4) and ec.shape == (0,)
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}


def test_detector_wrappers_reject_what_the_kernels_do_not_take():
    keys = torch.zeros((64, 4), dtype=torch.int32)
    w = torch.ones(64)
    with pytest.raises(ValueError, match="P, 4"):
        kops.portscan_score(keys[:, :3].contiguous(), w, 32, 8, 0)
    with pytest.raises(TypeError, match="float32"):
        kops.portscan_score(keys, w.to(torch.int32), 32, 8, 0)
    with pytest.raises(ValueError, match="shape"):
        kops.portscan_score(keys, w[:10], 32, 8, 0)
    with pytest.raises(ValueError, match="shared memory"):
        kops.portscan_score(keys, w, 32, 14, 0)  # 2 MB of registers: more than a block holds
    with pytest.raises(ValueError, match="shared memory"):
        kops.portscan_score(keys, w, 65, 8, 0)  # 65 KB: one group more than a block holds
    with pytest.raises(ValueError, match="precision"):
        kops.portscan_score(keys, w, 32, 2, 0)
    with pytest.raises(ValueError, match="1, nbins"):
        kops.dnstunnel_score(torch.zeros(64))
    with pytest.raises(TypeError, match="float32"):
        kops.dnstunnel_score(torch.zeros((1, 64), dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        kops.synflood_score(torch.zeros(8))
    kops.reset_launch_counts()
    assert kops.portscan_score(keys, w, 32, 8, 0).shape == (32,)
    assert kops.dnstunnel_score(torch.zeros((1, 64))).shape == (2,)
    assert kops.synflood_score(torch.zeros(9)).shape == (3,)
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}


def test_cms_query_many_lays_out_one_job_a_query(monkeypatch):
    """K10's many-job entry without a card: the launch is caught where it
    would enter C, and its table (csrc/cms_query.cu's Table, read back
    through ``kops._QueryTable``) is read: a job a query in order, each
    writing its rows end to end into the one est and ok buffer, a block a
    256 rows, each key column's address and stride (row-major (R, 4) and (R,
    2) tensors alike), the mask where given, the min_weight as u32; a job of 0 rows takes no block; the sizes match the
    kernel's static_asserts. ``cms_query`` is one job without a mask."""
    import ctypes

    src = (REPO / "retina_tpu_torch/kernels/csrc/cms_query.cu").read_text()
    assert f"kMaxJobs = {kops.CMS_QUERY_MAX_JOBS};" in src
    assert f"kThreads = {kops.CMS_QUERY_THREADS};" in src
    assert ctypes.sizeof(kops._QueryJob) == 112 and "sizeof(Job) == 112" in src
    assert ctypes.sizeof(kops._QueryTable) == 8 + 112 * kops.CMS_QUERY_MAX_JOBS
    seen = []

    def launch(name, dev, ptr, n_launches=1):
        t = kops._QueryTable.from_address(ptr)
        seen.append((name, t.n_blocks, [
            (j.table, list(j.col)[:j.n_cols], list(j.stride)[:j.n_cols], j.n, j.est,
             j.ok_in, j.ok_out, j.wmask, j.seed, j.min_weight, j.depth, j.n_cols, j.block0)
            for j in t.jobs[:t.n_jobs]]))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    table = torch.zeros((4, 1 << 10), dtype=torch.int32)
    deep = torch.zeros((3, 1 << 6), dtype=torch.int32)
    rows4 = torch.zeros((70_000, 4), dtype=torch.int32)
    rows2 = torch.zeros((300, 2), dtype=torch.int32)
    wide = torch.zeros((1000, 5), dtype=torch.int32)  # strided columns
    mask = torch.ones(1000, dtype=torch.bool)
    jobs = [(table, 3, [rows4[:, j] for j in range(4)], None, 0),
            (table, 3, [rows2[:, j] for j in range(2)], None, 0),
            (deep, -1, [wide[:, j] for j in range(3)], mask, 1 << 31),
            (table, 5, [rows4[:0, 0]], None, 0),
            (table, 6, [rows4[:1, 0].clone()], mask[:1], 7)]
    est, ok = kops.cms_query_many(jobs)
    assert est.shape == ok.shape == (71_301,) and est.dtype == torch.int32
    (name, n_blocks, got), = seen
    assert name == "cms_query" and len(got) == len(jobs)
    off = block0 = 0
    for (t, seed, cols, m, mw), g in zip(jobs, got):
        r = cols[0].shape[0]
        want = (t.data_ptr(), [c.data_ptr() for c in cols] if r else [None] * len(cols),
                [c.stride(0) for c in cols] if r else [0] * len(cols), r,
                est.data_ptr() + 4 * off if r else None,
                m.data_ptr() if m is not None and r else None,
                ok.data_ptr() + off if r else None, t.shape[1] - 1, seed & 0xFFFFFFFF,
                mw & 0xFFFFFFFF, t.shape[0], len(cols), block0)
        assert tuple(x or None if i in (4, 5, 6) else x for i, x in enumerate(g)) == want
        block0 += -(-r // kops.CMS_QUERY_THREADS)
        off += r
    assert n_blocks == block0 == 274 + 2 + 4 + 1
    seen.clear()
    out = kops.cms_query(table, 3, [wide[:, j] for j in range(4)])
    (name, n_blocks, ((*_, n, e, ok_in, ok_out, _, _, mw, _, _, _),)), = seen
    assert (n, e, ok_in, mw, n_blocks) == (1000, out.data_ptr(), None, 0, 4) and ok_out


def test_cms_query_many_rejects_what_the_kernel_does_not_take():
    table = torch.zeros((4, 64), dtype=torch.int32)
    col = torch.zeros(10, dtype=torch.int32)
    job = (table, 0, [col], None, 0)
    with pytest.raises(ValueError, match="1 to 8 query jobs"):
        kops.cms_query_many([])
    with pytest.raises(ValueError, match="1 to 8 query jobs"):
        kops.cms_query_many([job] * 9)

    with pytest.raises(TypeError, match="bool"):
        kops.cms_query_many([(table, 0, [col], col, 0)])
    with pytest.raises(ValueError, match="shape"):
        kops.cms_query_many([(table, 0, [col], torch.ones(9, dtype=torch.bool), 0)])
    with pytest.raises(ValueError, match="depth >= 1"):
        kops.cms_query_many([(table[:0], 0, [col], None, 0)])
    with pytest.raises(ValueError, match="power of two"):
        kops.cms_query_many([job, (torch.zeros((4, 48), dtype=torch.int32), 0, [col], None, 0)])
    kops.reset_launch_counts()
    est, ok = kops.cms_query_many([(table, 0, [col[:0]], None, 0)])
    assert est.shape == ok.shape == (0,)
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}


def test_topk_join_many_lays_out_one_job_a_family(monkeypatch):
    """K9's many-family entry without a card: the launch is caught where it
    would enter C, and its table (csrc/topk_join.cu's Table, read back
    through ``kops._JoinTable``) is read: a job a family in order, each with
    its inputs, its own outputs, N, S and C, and a block a 32 slots from its
    first block; a family of 0 slots takes no block; the sizes match the
    kernel's static_asserts. ``topk_join`` is one job."""
    import ctypes

    src = (REPO / "retina_tpu_torch/kernels/csrc/topk_join.cu").read_text()
    assert f"kMaxJobs = {kops.TOPK_JOIN_MAX_JOBS};" in src
    assert f"kSlots = {kops.TOPK_JOIN_SLOTS};" in src
    assert ctypes.sizeof(kops._JoinJob) == 56 and "sizeof(Job) == 56" in src
    assert ctypes.sizeof(kops._JoinTable) == 8 + 56 * kops.TOPK_JOIN_MAX_JOBS
    seen = []

    def launch(name, dev, ptr, n_launches=1):
        t = kops._JoinTable.from_address(ptr)
        seen.append((name, t.n_blocks, [
            (j.keys, j.counts, j.out_keys, j.out_counts, j.n_tables, j.n_slots, j.n_cols,
             j.block0) for j in t.jobs[:t.n_jobs]]))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    fams = [(torch.zeros((64, 2048, 4), dtype=torch.int32),
             torch.zeros((64, 2048), dtype=torch.int32)),
            (torch.zeros((5, 0, 2), dtype=torch.int32), torch.zeros((5, 0), dtype=torch.int32)),
            (torch.zeros((1, 100, 1), dtype=torch.int32), torch.zeros((1, 100), dtype=torch.int32))]
    outs = kops.topk_join_many(fams)
    assert [(k.shape, c.shape) for k, c in outs] == [((2048, 4), (2048,)), ((0, 2), (0,)),
                                                     ((100, 1), (100,))]
    (name, n_blocks, got), = seen
    assert name == "topk_join" and n_blocks == 64 + 0 + 4
    want = []
    block0 = 0
    for (k, c), (ok_, oc) in zip(fams, outs):
        n, s, cols = k.shape
        want.append((k.data_ptr() or None, c.data_ptr() or None, ok_.data_ptr() or None,
                     oc.data_ptr() or None, n, s, cols, block0))
        block0 += -(-s // kops.TOPK_JOIN_SLOTS)
    assert [tuple(x or None if i < 4 else x for i, x in enumerate(g)) for g in got] == want
    seen.clear()
    k1, c1 = kops.topk_join(*fams[2])
    assert seen[0][1] == 4 and seen[0][2][0][2] == k1.data_ptr()


def test_inv_decode_many_lays_out_one_job_a_region(monkeypatch):
    """K15's many-region entry without a card: the launch is caught where it
    would enter C, and its table (csrc/inv_decode.cu's Table, read back
    through ``kops._DecodeTable``) is read: the one keys, ok and tier output
    of all regions, a job a region in order with its planes, weights, bucket
    count, first output row, seed as u32, log2 of its width, tier and first
    block (a block a 8 buckets); the sizes match the kernel's
    static_asserts. ``inv_decode`` is one job of tier 0, its key columns a
    transposed view of the keys."""
    import ctypes

    src = (REPO / "retina_tpu_torch/kernels/csrc/inv_decode.cu").read_text()
    assert f"kMaxJobs = {kops.INV_DECODE_MAX_JOBS};" in src
    assert f"kWarps = {kops.INV_DECODE_WARPS};" in src
    assert ctypes.sizeof(kops._DecodeJob) == 48 and "sizeof(Job) == 48" in src
    assert ctypes.sizeof(kops._DecodeTable) == 40 + 48 * kops.INV_DECODE_MAX_JOBS
    seen = []

    def launch(name, dev, ptr, n_launches=1):
        t = kops._DecodeTable.from_address(ptr)
        seen.append((name, t.keys, t.ok, t.tier, t.n_cols, t.n_blocks, [
            (j.planes, j.weights, j.n, j.row0, j.seed, j.width_log2, j.tier, j.block0)
            for j in t.jobs[:t.n_jobs]]))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    flow = InvertibleSketch.zeros(2, 1 << 12, n_key_cols=4, seed=3, device="cpu")
    hi = InvertibleSketch.zeros(2, 1 << 9, n_key_cols=4, seed=-1, device="cpu")
    keys, ok, tier = kops.inv_decode_many([(flow.planes, flow.weights, 3, 0),
                                           (hi.planes, hi.weights, -1, 1)])
    assert keys.shape == (9216, 4) and ok.shape == tier.shape == (9216,)
    assert keys.is_contiguous() and ok.dtype == torch.bool and tier.dtype == torch.int32
    (name, k, o, t, n_cols, n_blocks, jobs), = seen
    assert (name, k, o, t, n_cols, n_blocks) == (
        "inv_decode", keys.data_ptr(), ok.data_ptr(), tier.data_ptr(), 4, 1024 + 128)
    assert jobs == [(flow.planes.data_ptr(), flow.weights.data_ptr(), 8192, 0, 3, 12, 0, 0),
                    (hi.planes.data_ptr(), hi.weights.data_ptr(), 1024, 8192, 0xFFFFFFFF, 9, 1,
                     1024)]
    seen.clear()
    small = InvertibleSketch.zeros(1, 1 << 2, n_key_cols=1, seed=7, device="cpu")
    cols, ok1 = kops.inv_decode(small.planes, small.weights, 7, 1)
    (_, k, _, _, n_cols, n_blocks, jobs), = seen
    assert cols.shape == (1, 4) and cols.stride() == (1, 1) and k == cols.data_ptr()
    assert (n_cols, n_blocks, jobs[0][2:]) == (1, 1, (4, 0, 7, 2, 0, 0))


def test_fold_and_close_decode_launch_k9_and_k15_once(monkeypatch):
    """Without a card, the launches caught where they would enter C: one
    ``fold_stacked`` call over a catalog with the three candidate families
    launches K8 once and K9 once (all three families in one table), and a
    window close's ``Telemetry.inv_decode`` launches K15 once (both regions)
    and K10 once (one job over all rows, at the key columns' stride)."""
    from retina_tpu_torch.timetravel.fold import fold_stacked

    seen = []

    def launch(name, dev, *args, n_launches=1):
        if name == "topk_join":
            t = kops._JoinTable.from_address(args[0])
            seen.append((name, t.n_jobs, [j.n_cols for j in t.jobs[:t.n_jobs]]))
        elif name == "inv_decode":
            seen.append((name, kops._DecodeTable.from_address(args[0]).n_jobs))
        elif name == "cms_query":
            t = kops._QueryTable.from_address(args[0])
            seen.append((name, t.n_jobs, list(t.jobs[0].stride)[:t.jobs[0].n_cols],
                         t.jobs[0].n))
        else:
            seen.append((name,))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    stacked = {"flow_cms": torch.zeros((32, 4, 64), dtype=torch.int32),
               "hll_flows": torch.zeros((32, 1, 64), dtype=torch.int32),
               "entropy": torch.zeros((32, 3, 64))}
    for fam, c in (("flow", 4), ("svc", 2), ("dns", 1)):
        stacked[f"{fam}_keys"] = torch.zeros((32, 256, c), dtype=torch.int32)
        stacked[f"{fam}_counts"] = torch.zeros((32, 256), dtype=torch.int32)
    out = fold_stacked(stacked)
    assert sorted(out) == sorted(stacked)
    assert seen == [("fold",), ("topk_join", 3, [4, 2, 1])]
    seen.clear()
    tel = Telemetry(INVERTIBLE_CUT, device="cpu")
    dec = tel.inv_decode(tel.init_state())
    m = 2 * (INVERTIBLE_CUT.inv_width + INVERTIBLE_CUT.inv_hi_width)
    assert seen == [("inv_decode", 2), ("cms_query", 1, [4] * 4, m)]
    assert dec["keys"].shape == (m, 4) and dec["tier"].shape == (m,)


def test_sharded_merges_launch_k8_once_a_program_and_nothing_at_one_shard(monkeypatch):
    """Without a card, the launches caught where they would enter C, at 4
    shards of one device: the snapshot counts each shard's live connections
    (K17, one job each), folds its 12 sums and maxes in one K8 launch and
    reads out 19 jobs in one K17 launch; the export folds 11 arrays (the
    invertible planes and weights among them) in one K8 launch and joins the 3 families in one K9 launch; the decode folds 5 in
    one K8 launch, then K15 and K10 once; the close folds the entropy in one
    K8 launch, then K16 once. At one shard with no group, each is
    ``Telemetry``'s: no fold."""
    from retina_tpu_torch.parallel.mesh import make_mesh
    from retina_tpu_torch.parallel.telemetry import ShardedTelemetry

    seen = []

    def launch(name, dev, *args, n_launches=1):
        seen.append((name, args[1], args[2]) if name == "fold" else (name,))

    def readout(name, dev, jobs, out, now):
        seen.append((name, len(jobs)))

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    monkeypatch.setattr(kops, "_readout_launch", readout)
    monkeypatch.setattr(kops, "_close_args", lambda dev, g, k: (1, 0, 0))
    for n in (4, 1):
        tel = ShardedTelemetry(INVERTIBLE_CUT, make_mesh(["cpu"] * n))
        states = tel.init_state()
        seen.clear()
        tel.snapshot_flat_dispatch(states, 5)
        tel.fleet_export(states)
        tel.inv_decode(states)
        tel.end_window(states)
        if n == 4:
            assert seen == [("ct_active", 1)] * 4 + [
                ("fold", 12, 4), ("snapshot_flat", 19), ("fold", 11, 4), ("topk_join",),
                ("fold", 5, 4), ("inv_decode",), ("cms_query",), ("fold", 1, 4),
                ("window_close",)]
        else:
            assert seen == [("snapshot_flat", 19), ("inv_decode",), ("cms_query",),
                            ("window_close",)]


@pytest.mark.parametrize("groups, precision, n_rows, want", [
    (32, 8, 1 << 16, 16), (32, 8, 8 << 12, 8), (32, 8, 1 << 12, 1), (32, 8, 64, 1),
    (32, 8, 4097, 2), (32, 8, 0, 1), (3, 8, 1 << 20, 16), (64, 8, 4 << 12, 4),
    (1, 13, 1 << 16, 16), (65, 8, 1 << 16, None), (3, 13, 64, None)])
def test_portscan_cluster_size(groups, precision, n_rows, want):
    """K11's blocks: one a PORTSCAN_BLOCK_ROWS rows, at least one, at most
    PORTSCAN_CLUSTER (the kernel's kMaxCluster); every block holds all the
    registers, so more than SHARED_BYTES of them (kMaxBankBytes) is an error
    whatever the rows."""
    src = (REPO / "retina_tpu_torch/kernels/csrc/detect.cu").read_text()
    assert f"kMaxCluster = {kops.PORTSCAN_CLUSTER};" in src
    assert f"kMaxBankBytes = {kops.SHARED_BYTES // 1024} * 1024;" in src
    if want is None:
        with pytest.raises(ValueError, match="shared memory"):
            kops.portscan_cluster(groups, precision, n_rows)
        return
    assert kops.portscan_cluster(groups, precision, n_rows) == want
    assert groups * (4 << precision) <= kops.SHARED_BYTES


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


def _step_rows_batch(card, case: str, n: int = 1 << 16):
    """(records, identity map) of a K1 batch at CFG's widths: "zipf" the
    bench's skewed stream; "one" every row on pod 1, its forward bytes
    summing past 2^32; "spread" row i on pod 1 + i mod (P - 1), so no pod
    is hot; "clamped" pods, drop reasons and DNS qtypes past P - 1, R - 1
    and Q - 1. Every seventh row is exempt from sampling, every fifth a
    probe-like TSval."""
    rng = np.random.default_rng(sum(map(ord, case)))
    host = TrafficGen(n_flows=5000, n_pods=200, seed=4).batch(n)
    pods = {pod_ip(i): i for i in range(1, 150)}
    if case == "one":
        host[:, F.SRC_IP] = host[:, F.DST_IP] = pod_ip(1)
        host[:, F.BYTES] = rng.integers(1 << 20, 1 << 24, n)
    elif case == "spread":
        host[:, F.SRC_IP] = host[:, F.DST_IP] = pod_ip(1) + np.arange(n) % (CFG.n_pods - 1)
        pods = {pod_ip(i): i for i in range(1, CFG.n_pods)}
    elif case == "clamped":
        pods |= {pod_ip(150 + i): CFG.n_pods - 2 + i * 37 for i in range(40)}
        host[::3, F.DST_IP] = pod_ip(150) + rng.integers(0, 40, len(host[::3]))
        host[::2, F.VERDICT] = 2  # dropped
        host[:, F.DROP_REASON] = rng.integers(0, 3 * CFG.n_drop_reasons, n)
        host[1::2, F.EVENT_TYPE] = rng.integers(2, 4, len(host[1::2]))  # DNS requests, replies
        host[:, F.DNS] = rng.integers(0, 4 * CFG.n_dns_qtypes, n).astype(np.uint32) << 16
    rec = from_numpy(host, card)
    rec[::7, F.PACKETS] = 100  # exempt rows
    rec[::5, F.TSVAL] = 3
    ident = IdentityMap.build_host(pods, n_slots=1 << 10, device=card)
    return rec, ident


def _k1_pair(card, cfg, rec, ident, filt, cases, api=None):
    """K1 on its kernel and on its plain version, from zeroed state, for
    each (sample_k, n_valid): the rectangles, node counters, totals,
    scratch and sums must be bit-equal. Returns the last (kernel, plain)
    scratch."""
    state = TelemetryPipeline(cfg, device=card).init_state()
    rects = [state.pod_forward, state.pod_drop, state.pod_tcpflags, state.pod_dns,
             state.pod_retrans, state.node_counters, state.totals]
    for sample_k, n_valid in cases:
        a, b, out_a, out_b = _pair(
            lambda *r: kops.step_rows(rec, n_valid, sample_k, ident.table, ident.seed,
                                      None if filt is None else filt.table,
                                      0 if filt is None else filt.seed, *r, cfg,
                                      apiserver_ip=api), *rects)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert torch.equal(out_a[0], out_b[0]) and torch.equal(out_a[1], out_b[1])
        rects = a
    return out_a[0], out_b[0]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zipf", "one", "spread", "clamped"])
def test_step_rows_kernel_matches_plain(card, case):
    rec, ident = _step_rows_batch(card, case)
    filt = IdentityMap.build_host({pod_ip(170): 1}, n_slots=1 << 4, device=card)
    _k1_pair(card, CFG, rec, ident, filt, ((1, 1 << 16), (4, 40000)))
    if case == "one":  # a pod's forward bytes wrapped past 2^32
        assert int(rec[:, F.BYTES].double().sum()) > 1 << 32


@pytest.mark.gpu
def test_step_rows_kernel_overflows_its_shared_table(card):
    """Every row on a pod of its own, dropped and a DNS request: three keys
    a row, more than STEP_SLOTS in a STEP_CHUNK-row chunk, so rows whose key
    finds no free slot add to the rectangles directly; bit-equal all the
    same."""
    cfg = dataclasses.replace(CFG, n_pods=4096)
    n = 1 << 16
    host = TrafficGen(n_flows=5000, n_pods=200, seed=8).batch(n)
    host[:, F.SRC_IP] = host[:, F.DST_IP] = pod_ip(1) + np.arange(n) % (cfg.n_pods - 1)
    host[:, F.META] = (6 << 24) | (0x12 << 16) | (host[:, F.META] & 0xFFFF)  # TCP, SYN | ACK
    host[:, F.VERDICT] = 2
    host[:, F.EVENT_TYPE] = 2
    assert 3 * kops.STEP_CHUNK > kops.STEP_SLOTS
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, cfg.n_pods)},
                                   n_slots=1 << 13, device=card)
    _k1_pair(card, cfg, from_numpy(host, card), ident, None, ((1, n), (1, n - 999)))


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


FULL_BATCH = (1 << 21) - 77  # not a multiple of a block (512) or of K2's chunk (2048)


def _full_batch(card, case: str):
    """(records, weights) of a 2^21-row bench batch less 77 rows: "zipf"
    is the 1M-flow stream as it comes; "one_key" gives every row the first
    row's addresses, ports and DNS hash; "distinct" draws them uniformly, so
    a chunk holds ~2048 keys (more than a warp's 32); "wrap" weighs rows
    near 2^32, so the sums wrap. Every third row weighs 0."""
    rng = np.random.default_rng(sum(map(ord, case)))
    host = TrafficGen(n_flows=1_000_000, n_pods=2048, seed=5).batch(FULL_BATCH)
    lanes = [F.SRC_IP, F.DST_IP, F.PORTS, F.DNS_QHASH]
    if case == "one_key":
        host[:, lanes] = host[0, lanes]
    elif case == "distinct":
        host[:, lanes] = rng.integers(0, 1 << 32, (FULL_BATCH, 4), dtype=np.uint64)
    w = host[:, F.PACKETS].copy()
    if case == "wrap":
        w = (0xFFFFFFF0 + rng.integers(0, 16, FULL_BATCH)).astype(np.uint32)
    w[::3] = 0
    return from_numpy(host, card), from_numpy(w, card)


def _hh_instances(rec, w, card, rng):
    """The step's three sketches over one batch (flow 4 columns, service 2,
    DNS 1), at the deployed widths, with counts and CMS already in use:
    the flow and DNS keys are strided lanes of the records."""
    proto = (rec[:, F.META] >> 24) & 0xFF
    svc = [rec[:, F.SRC_IP] & 0x7FF, rec[:, F.DST_IP] & 0x7FF]
    dns_w = torch.where(rec[:, F.DNS_QHASH] % 5 == 0, w, 0)
    out = []
    for seed, (cols, wt) in enumerate(((
            [rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS], proto], w),
            (svc, w), ([rec[:, F.DNS_QHASH]], dns_w))):
        out.append([from_numpy(rng.integers(0, 1 << 8, (4, 1 << 15)).astype(np.uint32), card),
                    seed + 3,
                    from_numpy(rng.integers(0, 1 << 32, (2048, len(cols)),
                                            dtype=np.uint64).astype(np.uint32), card),
                    from_numpy(rng.integers(0, 1 << 10, 2048).astype(np.uint32), card),
                    seed + 3, cols, wt])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zipf", "one_key", "distinct", "wrap"])
def test_hh_update_many_matches_three_plain_updates(card, case):
    """K2's three-sketch entry against three plain updates at 2^21 rows, in
    3 launches a call, twice (the second offer meets the counts the first
    set): CMS, counts and key rows bit for bit."""
    rec, w = _full_batch(card, case)
    rng = np.random.default_rng(3)
    kern = _hh_instances(rec, w, card, rng)
    plain = [[x.clone() if isinstance(x, torch.Tensor) and i in (0, 2, 3) else x
              for i, x in enumerate(u)] for u in kern]
    for _ in range(2):
        before = kops.launch_counts()["hh_update"]
        kops.hh_update_many(kern)
        assert kops.launch_counts()["hh_update"] == before + 3
        with kops.plain_versions():
            for u in plain:
                kops.hh_update(*u)
        torch.cuda.synchronize()
        for a, b in zip(kern, plain):
            for i in (0, 2, 3):
                assert torch.equal(a[i], b[i]), (case, i)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zipf", "one_key", "distinct"])
def test_entropy_update_matches_plain_at_full_batch(card, case):
    """K4 at 2^21 rows and the deployed (3, 4096) bank, key columns as
    strided record lanes: buckets below 2^24 exactly, above it within a
    relative 2^-22 (the order of float adds)."""
    rec, w = _full_batch(card, case)
    cols = [rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS] & 0xFFFF]
    counts = torch.zeros((3, 4096), dtype=torch.float32, device=card)
    a, b, _, _ = _pair(lambda c: kops.entropy_update(c, 7, cols, w), counts)
    err = (a[0] - b[0]).abs()
    exact = torch.maximum(a[0], b[0]) < 2 ** 24
    assert bool((err[exact] == 0).all())
    assert bool((err <= 2.0 ** -22 * b[0].abs()).all())
    assert float(a[0].sum()) > 0


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
def test_conntrack_kernel_matches_plain(card):
    """K5 against its plain version through every branch of the decision:
    new, interval, expiry, the 16-bit wrap and a clock 10 s back, with
    connections sharing slots, masked and garbage rows, and one packet per
    row where no packet lane is given."""
    rng = np.random.default_rng(11)
    gen = TrafficGen(n_flows=20000, n_pods=200, seed=5)
    n = 1 << 16
    tables = [ConntrackTable.zeros(1 << 10, seed=8, device=card) for _ in range(2)]
    for t, now in enumerate((100, 101, 131, 200, 600, 65_700, 65_690)):
        rec = from_numpy(gen.batch(n), card)
        if t % 3 == 2:  # reply rows
            rev = rec[::3]
            rev[:, [F.SRC_IP, F.DST_IP]] = rev[:, [F.DST_IP, F.SRC_IP]]
            p = rev[:, F.PORTS]
            rev[:, F.PORTS] = ((p & 0xFFFF) << 16) | ((p >> 16) & 0xFFFF)
        flags = (rec[:, F.META] >> 16) & 0xFF
        flags[::37] = 1  # FIN
        mask = torch.ones(n, dtype=torch.int32, device=card)
        mask[::9] = 0
        n_valid = n - 5000 * (t % 2)
        mask[n_valid:] = 0
        rec[n_valid:] = from_numpy(rng.integers(0, 1 << 32, (n - n_valid, 16),
                                                dtype=np.uint64).astype(np.uint32), card)
        cols = [rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS],
                (rec[:, F.META] >> 24) & 0xFF, flags]
        packets = None if t == 3 else rec[:, F.PACKETS]
        before = kops.launch_counts()["conntrack"]
        out = [tables[0].process_lanes(*cols, now, rec[:, F.BYTES], mask, packets)]
        assert kops.launch_counts()["conntrack"] == before + 2
        with kops.plain_versions():
            out.append(tables[1].process_lanes(*cols, now, rec[:, F.BYTES], mask, packets))
        torch.cuda.synchronize()
        assert torch.equal(out[0], out[1]), f"lanes differ at now={now}"
        assert torch.equal(tables[0].keys, tables[1].keys), f"keys differ at now={now}"
        assert torch.equal(tables[0].vals, tables[1].vals), f"vals differ at now={now}"
        assert int(out[0][0].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hot", "wrap"])
def test_conntrack_kernel_matches_plain_at_a_full_batch(card, case):
    """K5 against its plain version at a full batch (2^21 rows less 77) and
    the deployed 2^18 slots, through every branch of the clock. "hot" makes
    every other row one connection (its first row in the first chunk, its
    last in the last; a quarter of them in the reply direction); "wrap"
    gives every row ~2^31 packets and ~2^32 bytes, so the connections' sums
    wrap mod 2^32."""
    rec, _ = _full_batch(card, "zipf")
    n = rec.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=card)
    if case == "hot":
        rec[0::2] = rec[0]
        rev = rec[2::8]
        rev[:, [F.SRC_IP, F.DST_IP]] = rec[0, [F.DST_IP, F.SRC_IP]]
        p = rec[0, F.PORTS]
        rev[:, F.PORTS] = ((p & 0xFFFF) << 16) | ((p >> 16) & 0xFFFF)
    flags = (rec[:, F.META] >> 16) & 0xFF
    mask = torch.ones(n, dtype=torch.int32, device=card)
    mask[::9] = 0
    cols = [rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS],
            (rec[:, F.META] >> 24) & 0xFF, flags]
    bytes_, packets = rec[:, F.BYTES], rec[:, F.PACKETS]
    if case == "wrap":
        bytes_, packets = (-256) | (rows & 0xFF), 0x7FFFFFF1 + (rows & 7)
    tables = [ConntrackTable.zeros(1 << 18, seed=8, device=card) for _ in range(2)]
    for now in (100, 101, 131, 200, 600, 65_700, 65_690):
        out = tables[0].process_lanes(*cols, now, bytes_, mask, packets)
        with kops.plain_versions():
            ref = tables[1].process_lanes(*cols, now, bytes_, mask, packets)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), f"lanes differ at now={now}"
        assert torch.equal(tables[0].keys, tables[1].keys), f"keys differ at now={now}"
        assert torch.equal(tables[0].vals, tables[1].vals), f"vals differ at now={now}"
        if case == "hot" and now == 100:  # new: one report, at the last masked row
            hot = torch.nonzero(mask[0::2]).flatten() * 2
            assert torch.equal(torch.nonzero(out[0][hot]).flatten(),
                               torch.tensor([len(hot) - 1], device=card))


@pytest.mark.gpu
@pytest.mark.parametrize("n_slots", [1, 2, 33, 64])
def test_fold_many_kernel_matches_plain(card, n_slots):
    """One launch folds arrays of mixed ops and lengths, each equal to its
    plain fold bit for bit: 16-byte loads where base and length allow, and
    the scalar path on an odd length (its slots off 16-byte boundaries) and
    on an array whose base is 4 bytes off one."""
    rng = np.random.default_rng(60 + n_slots)
    u = from_numpy(_stack(rng, (n_slots, 3, 1000)), card)
    hll = from_numpy(_stack(rng, (n_slots, 64, 65), high=34), card)
    hll[:, 0, :5] = -1
    ent = torch.from_numpy(rng.integers(0, 1 << 26, (n_slots, 3, 4096)).astype(np.float32))
    odd = from_numpy(_stack(rng, (n_slots, 4099)), card)
    shifted = from_numpy(_stack(rng, (n_slots * 1000 + 1,)), card)[1:].view(n_slots, 1000)
    items = [(u, "sum_u32"), (hll, "max_u32"), (ent.to(card), "sum_f32"), (odd, "sum_u32"),
             (from_numpy(_stack(rng, (n_slots, 6)), card), "sum_u32"), (shifted, "max_u32")]
    before = kops.launch_counts()["fold"]
    outs = kops.fold_many(items)
    assert kops.launch_counts()["fold"] == before + 1
    with kops.plain_versions():
        refs = [kops.fold(x, op) for x, op in items]
    torch.cuda.synchronize()
    for (x, op), out, ref in zip(items, outs, refs):
        assert out.dtype == x.dtype and out.shape == x.shape[1:]
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), (op, x.shape)


@pytest.mark.gpu
def test_sharded_merges_on_the_card_match_plain(card):
    """Four shards on the card, stepped with the kernels: the merged
    snapshot, export, decode and close (K8, K9, K15, K10, K16, K17 on the
    lead shard's device) equal the plain versions' on copies of the same
    states bit for bit, and so do the states the close leaves."""
    from retina_tpu_torch.convert import state_from_numpy, state_to_numpy
    from retina_tpu_torch.parallel.mesh import make_mesh
    from retina_tpu_torch.parallel.partition import partition_events
    from retina_tpu_torch.parallel.telemetry import ShardedTelemetry

    n = 4
    tel = ShardedTelemetry(INVERTIBLE_CUT, make_mesh([card] * n))
    states = tel.init_state()
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, 200)}, n_slots=1 << 9,
                                   device=card)
    gen = TrafficGen(n_flows=3000, n_pods=200, seed=91)
    for i in range(3):
        sb = partition_events(gen.batch(1 << 15), n, 1 << 14)
        recs = [from_numpy(r, card) for r in sb.records]
        states, summ = tel.step(states, recs, sb.n_valid, 100 + i, ident, lost=sb.lost)
    copies = [state_from_numpy(state_to_numpy(s), s) for s in states]

    def merges(sts):
        snap = tel.snapshot(sts, 103)
        out = {f"snap.{k}": v for k, v in snap.items() if not isinstance(v, dict)}
        out.update({f"snap.{k}.{kk}": vv for k, v in snap.items() if isinstance(v, dict)
                    for kk, vv in v.items()})
        out.update({f"export.{k}": v for k, v in tel.fleet_export(sts).items()})
        out.update({f"decode.{k}": v for k, v in tel.inv_decode(sts, 3).items()})
        sts, win = tel.end_window(sts)
        out.update({f"close.{k}": v for k, v in win.items()})
        return out, sts

    kops.reset_launch_counts()
    got, states = merges(states)
    launches = kops.launch_counts()
    with kops.plain_versions():
        want, copies = merges(copies)
    torch.cuda.synchronize()
    assert launches["fold"] == 4 and launches["topk_join"] == 1
    assert launches["snapshot_flat"] == 1 and launches["ct_active"] == n
    assert set(got) == set(want)
    for k, ref in want.items():
        assert got[k].shape == ref.shape and got[k].dtype == ref.dtype, k
        a, b = got[k].reshape(-1), ref.reshape(-1)
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), k
    for a, b in zip(states, copies):
        for x, y in zip(state_to_numpy(a), state_to_numpy(b)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [1, 2, 3, 4])
def test_inv_update_kernel_matches_plain(card, n_cols):
    rng = np.random.default_rng(20 + n_cols)
    n = 1 << 16
    keys = [from_numpy(rng.integers(0, 300, n).astype(np.uint32), card) for _ in range(n_cols)]
    w = from_numpy(rng.integers(0, 3, n).astype(np.uint32) * (rng.random(n) < 0.3), card)
    inv = InvertibleSketch.zeros(2, 1 << 9, n_key_cols=n_cols, seed=9, device=card)
    for _ in range(2):
        a, b, _, _ = _pair(lambda p, wt: kops.inv_update(p, wt, 9, keys, w),
                           inv.planes, inv.weights)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        inv.planes, inv.weights = a


def _inv_regions(card, widths=(1 << 12, 1 << 9)):
    """inv_flow and inv_hi at INVERTIBLE_CONFIG's widths (or ``widths``),
    their planes and weights already in use."""
    rng = np.random.default_rng(70)
    out = []
    for i, wd in enumerate(widths):
        inv = InvertibleSketch.zeros(2, wd, n_key_cols=4, seed=9 + i, device=card)
        inv.planes.copy_(from_numpy(_stack(rng, tuple(inv.planes.shape)), card))
        inv.weights.copy_(from_numpy(_stack(rng, tuple(inv.weights.shape)), card))
        out.append((inv.planes, inv.weights, 9 + i))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["split", "per_row", "one_key", "one_bucket"])
def test_inv_update_pair_matches_plain(card, case):
    """Both regions of a step through one call (2 launches), bit-equal to the
    plain version over a full batch (2^21 rows less 77): "split" the bench
    stream with a priority class on a third of the rows and weights past
    2^31; "per_row" every row weighted; "one_key" every row one key (one
    bucket a depth, summed a chunk in shared memory); "one_bucket" distinct
    keys in regions one bucket wide, every pair of a region in one tile."""
    rec, w = _full_batch(card, "distinct" if case == "one_bucket" else
                         "one_key" if case == "one_key" else "zipf")
    n = rec.shape[0]
    rng = np.random.default_rng(len(case))
    if case == "split":
        w[::5] = from_numpy(rng.integers(1 << 31, 1 << 32, len(w[::5]), dtype=np.uint64)
                            .astype(np.uint32), card)
    if case == "per_row":
        w = rec[:, F.PACKETS].clone()
    sel = from_numpy((rng.random(n) < 0.33).astype(np.uint32), card)
    cols = [rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS], (rec[:, F.META] >> 24) & 0xFF]
    regions = _inv_regions(card, (1, 1) if case == "one_bucket" else (1 << 12, 1 << 9))
    pair = [[(p.clone(), q.clone(), s) for p, q, s in regions] for _ in range(2)]
    for _ in range(2):
        before = kops.launch_counts()["inv_update"]
        kops.inv_update_pair(pair[0], cols, w, sel)
        assert kops.launch_counts()["inv_update"] == before + 2
        with kops.plain_versions():
            kops.inv_update_pair(pair[1], cols, w, sel)
    torch.cuda.synchronize()
    for a, b in zip(pair[0], pair[1]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(pair[0][1][0], regions[1][0])  # inv_hi took rows


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["per_row", "report"])
def test_hll_update_many_matches_three_plain_updates(card, case):
    """The step's three banks at the deployed widths (1 x 2^12, 16 x 2^12,
    4096 x 2^6) through one launch over a full batch, bit-equal to three plain
    updates: reasons and pods past the groups, groups whose g * m wraps past
    2^32, registers already in use; "report" masks the flow bank by a
    sparse report lane and ANDs the pod bank's mask with it."""
    rec, _ = _full_batch(card, "zipf")
    n = rec.shape[0]
    rng = np.random.default_rng(80 + len(case))

    def lane(hi, p=None):
        x = rng.integers(0, hi, n) if p is None else rng.random(n) < p
        return from_numpy(x.astype(np.uint32), card)

    mask, is_drop, pod_mask, report = lane(2, 0.9), lane(2, 0.2), lane(2, 0.5), lane(2, 0.03)
    reason, pod_grp = lane(20), lane(4200)
    reason[::97] = (1 << 20) + 3
    pod_grp[::89] = (1 << 26) + 5
    five = [rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS], lane(256)]
    low = case == "report"
    banks = [((1, 1 << 12), 4, five, None, report if low else mask, None),
             ((16, 1 << 12), 5, five[:1], reason, is_drop, None),
             ((4096, 1 << 6), 6, five[:1], pod_grp, pod_mask, report if low else None)]
    regs = [from_numpy(_stack(rng, shape, high=8), card) for shape, *_ in banks]
    pair = [[(r.clone(), *b[1:]) for r, b in zip(regs, banks)] for _ in range(2)]
    for _ in range(2):
        before = kops.launch_counts()["hll_update"]
        kops.hll_update_many(pair[0])
        assert kops.launch_counts()["hll_update"] == before + 1
        with kops.plain_versions():
            kops.hll_update_many(pair[1])
    torch.cuda.synchronize()
    for a, b, r in zip(pair[0], pair[1], regs):
        assert torch.equal(a[0], b[0]) and not torch.equal(a[0], r)


@pytest.mark.gpu
def test_pipeline_on_card_matches_cpu(card):
    kops.reset_launch_counts()
    on_card = _run_steps(TelemetryPipeline(CFG, device=card), card)
    counts = kops.launch_counts()
    assert counts == {"step_rows": 2, "hh_update": 6, "cms_update": 0, "hll_update": 2,
                      "entropy_update": 2,
                      "conntrack": 0, "inv_update": 0, "ingest_packed": 0, "ingest_new": 0,
                      "ingest_known": 0, "fold": 0, "topk_join": 0, "cms_query": 0,
                      "portscan_score": 0, "bank_close": 0, "dnstunnel_score": 0,
                      "synflood_score": 0,
                      "latency_update": 2, "inv_decode": 0, "window_close": 0,
                      "entropy_bits": 0, "snapshot_flat": 0, "hll_estimate": 0, "ct_active": 0}
    on_cpu = _run_steps(TelemetryPipeline(CFG, device="cpu"), "cpu")
    from retina_tpu_torch.convert import tensor_leaves

    for x, y in zip(tensor_leaves(on_card), tensor_leaves(on_cpu)):
        assert torch.equal(x.cpu(), y)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [DEPLOYED_CUT, INVERTIBLE_CUT], ids=["deployed", "invertible"])
def test_conntrack_pipeline_on_card_matches_cpu(card, cfg):
    from retina_tpu_torch.convert import tensor_leaves

    kops.reset_launch_counts()
    card_sums, cpu_sums = [], []
    on_card = _run_steps(Telemetry(cfg, device=card), card, n_steps=3, summaries=card_sums)
    counts = kops.launch_counts()
    assert counts["conntrack"] == 6 and counts["hll_update"] == 3
    assert counts["inv_update"] == (6 if cfg.enable_invertible else 0)
    on_cpu = _run_steps(Telemetry(cfg, device="cpu"), "cpu", n_steps=3, summaries=cpu_sums)
    for x, y in zip(tensor_leaves(on_card), tensor_leaves(on_cpu)):
        assert torch.equal(x.cpu(), y)
    for a, b in zip(card_sums, cpu_sums):
        assert set(a) == set(b)
        for key in a:
            assert torch.equal(a[key].cpu(), b[key]), key
    if cfg.enable_invertible:
        before = kops.launch_counts()["inv_decode"]
        dec = [Telemetry(cfg, device=d).inv_decode(s) for d, s in ((card, on_card),
                                                                    ("cpu", on_cpu))]
        assert kops.launch_counts()["inv_decode"] == before + 1  # both regions, one launch
        for key in dec[0]:
            assert torch.equal(dec[0][key].cpu(), dec[1][key]), key


def _k7_wire(rng, shape, n_valid):
    """Random u32 wire lanes; rows past n_valid zero."""
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    w[n_valid:] = 0
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [True, False])
def test_ingest_packed_kernel_matches_plain(card, packed):
    rng = np.random.default_rng(30 + packed)
    w = _k7_wire(rng, (3000, 12 if packed else 16), 2900)
    w[::5, 0] = 0  # TS_REL 0: unstamped
    w[1::5, 0] = 0xFFFFFFFF  # the low word carries into the high word
    wire = from_numpy(w, card)
    for lo, hi in ((0xFFFFFF00, 7), (0, 0)):
        before = kops.launch_counts()["ingest_packed"]
        out = kops.ingest_packed(wire, packed, lo, hi, 4096)
        assert kops.launch_counts()["ingest_packed"] == before + 1
        with kops.plain_versions():
            ref = kops.ingest_packed(wire, packed, lo, hi, 4096)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        assert not out[3000:].any()


@pytest.mark.gpu
def test_ingest_new_kernel_matches_plain(card):
    """Repeated ids (escalated rows, the sentinel slot 0, padding rows):
    the last row in batch order writes the slot, in kernel and plain alike,
    and the claim scratch is zero again after each call."""
    rng = np.random.default_rng(32)
    slots = 1 << 10
    table = from_numpy(rng.integers(0, 1 << 32, (slots, 12), dtype=np.uint64)
                       .astype(np.uint32), card)
    tables = [table.clone(), table.clone()]
    winner = torch.zeros(slots, dtype=torch.int32, device=card)
    for n_valid in (5000, 4096):
        w = _k7_wire(rng, (4096 + 1024, 13), n_valid)
        w[:n_valid, 0] = rng.integers(0, 300, n_valid)
        w[::7, 0] = 0
        w[3::97, 0] = slots + 5  # past the table: dropped
        wire = from_numpy(w, card)
        out = kops.ingest_new(wire, tables[0], winner, 0xFFFFF000, 3, 3 * 2048)
        with kops.plain_versions():
            ref = kops.ingest_new(wire, tables[1], winner, 0xFFFFF000, 3, 3 * 2048)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        assert torch.equal(tables[0], tables[1])
        assert not winner.any()


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("id_bits", [1, 12, 18, 21, 32, 13])
def test_ingest_known_kernel_matches_plain(card, dense, id_bits):
    from retina_tpu_torch.parallel.wire import dense_known_rows, dense_words, known_rows

    rng = np.random.default_rng(40 + id_bits + dense)
    slots = min(1 << id_bits, 1 << 12)
    bucket, n_valid = 6000, 5800
    rows = np.zeros((n_valid, 16), np.uint32)
    pk_bits = 10 if dense else 32 - id_bits
    rows[:, F.PACKETS] = rng.integers(0, 1 << pk_bits, n_valid) if pk_bits else 0
    rows[:, F.BYTES] = rng.integers(0, 1 << (22 if dense else 32), n_valid, dtype=np.uint64)
    ids = rng.integers(0, 1 << id_bits, n_valid, dtype=np.uint64).astype(np.uint32)
    ids[::2] %= slots  # half inside the table, the rest read its last slot
    if dense:
        w = np.zeros(dense_words(bucket, id_bits), np.uint32)
        dense_known_rows(rows, ids, id_bits, w)
    else:
        w = np.zeros((bucket, 2), np.uint32)
        known_rows(rows, ids, np.uint32(id_bits), w[:n_valid])
    wire = from_numpy(w, card)
    table = from_numpy(rng.integers(0, 1 << 32, (slots, 12), dtype=np.uint64)
                       .astype(np.uint32), card)
    for flag, lo, hi in ((1, 0xFFFFFFF0, 5), (0, 0, 0)):
        out = kops.ingest_known(wire, bucket, dense, id_bits, table, flag, lo, hi, 8192)
        with kops.plain_versions():
            ref = kops.ingest_known(wire, bucket, dense, id_bits, table, flag, lo, hi, 8192)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


# Shapes at the edges of K7's 256-row tiles: one row, a bucket that ends
# inside a tile, windows whose zero tail spans several tiles.
K7_EDGES = [(1, 1), (1, 256), (256, 256), (257, 1024), (1000, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("bucket, n_out", K7_EDGES)
def test_ingest_packed_kernel_at_tile_edges(card, packed, bucket, n_out):
    rng = np.random.default_rng(bucket + n_out + packed)
    w = _k7_wire(rng, (bucket, 12 if packed else 16), bucket)
    w[::5, 0] = 0
    w[1::5, 0] = 0xFFFFFFFF
    wire = from_numpy(w, card)
    out = kops.ingest_packed(wire, packed, 0xFFFFFF00, 7, n_out)
    with kops.plain_versions():
        ref = kops.ingest_packed(wire, packed, 0xFFFFFF00, 7, n_out)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert not out[bucket:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["one id", "across tiles", "a third padding", "distinct"])
@pytest.mark.parametrize("bucket, n_out", [(1, 256), (257, 1024), (1000, 1024), (4096, 8192)])
def test_ingest_new_kernel_at_tile_edges(card, pattern, bucket, n_out):
    """Every row one id (one claim a tile, the last row writes); ids that
    repeat across tile boundaries (row % 300); a wire a third of which is
    padding (id 0, zero lanes: the last padding row writes slot 0); distinct
    ids. Called twice: the claim scratch is zero after each call."""
    slots = 1 << 12
    rng = np.random.default_rng(bucket + len(pattern))
    n_valid = bucket - bucket // 3 if pattern == "a third padding" else bucket
    w = _k7_wire(rng, (bucket, 13), n_valid)
    ids = {"one id": np.full(bucket, 5), "across tiles": np.arange(bucket) % 300,
           "a third padding": rng.integers(0, 300, bucket),
           "distinct": rng.permutation(slots)[:bucket]}[pattern]
    w[:n_valid, 0] = ids[:n_valid]
    wire = from_numpy(w, card)
    table = from_numpy(rng.integers(0, 1 << 32, (slots, 12), dtype=np.uint64)
                       .astype(np.uint32), card)
    tables = [table.clone(), table.clone()]
    winner = torch.zeros(slots, dtype=torch.int32, device=card)
    for _ in range(2):
        before = kops.launch_counts()["ingest_new"]
        out = kops.ingest_new(wire, tables[0], winner, 0xFFFFF000, 3, n_out)
        assert kops.launch_counts()["ingest_new"] == before + 2
        torch.cuda.synchronize()
        assert not winner.any()
        with kops.plain_versions():
            ref = kops.ingest_new(wire, tables[1], winner, 0xFFFFF000, 3, n_out)
        assert torch.equal(out, ref)
        assert torch.equal(tables[0], tables[1])


def _k7_known(rng, bucket, n_valid, id_bits, dense, slots):
    """A known wire of ``bucket`` rows (v4 stream or v3 rows), half of its
    ids inside a table of ``slots``, the rest anywhere in id_bits."""
    from retina_tpu_torch.parallel.wire import dense_known_rows, dense_words, known_rows

    rows = np.zeros((n_valid, 16), np.uint32)
    pk_bits = 10 if dense else 32 - id_bits
    rows[:, F.PACKETS] = rng.integers(0, 1 << pk_bits, n_valid) if pk_bits else 0
    rows[:, F.BYTES] = rng.integers(0, 1 << (22 if dense else 32), n_valid, dtype=np.uint64)
    ids = rng.integers(0, 1 << id_bits, n_valid, dtype=np.uint64).astype(np.uint32)
    ids[::2] %= slots
    if dense:
        w = np.zeros(dense_words(bucket, id_bits), np.uint32)
        dense_known_rows(rows, ids, id_bits, w)
    else:
        w = np.zeros((bucket, 2), np.uint32)
        known_rows(rows, ids, np.uint32(id_bits), w[:n_valid])
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("id_bits", [1, 13, 21, 32])
@pytest.mark.parametrize("bucket, n_out", K7_EDGES)
def test_ingest_known_kernel_at_tile_edges(card, dense, id_bits, bucket, n_out):
    rng = np.random.default_rng(bucket + n_out + id_bits + dense)
    slots = min(1 << id_bits, 1 << 12)
    wire = from_numpy(_k7_known(rng, bucket, bucket, id_bits, dense, slots), card)
    table = from_numpy(rng.integers(0, 1 << 32, (slots, 12), dtype=np.uint64)
                       .astype(np.uint32), card)
    out = kops.ingest_known(wire, bucket, dense, id_bits, table, 1, 0xFFFFFFF0, 5, n_out)
    with kops.plain_versions():
        ref = kops.ingest_known(wire, bucket, dense, id_bits, table, 1, 0xFFFFFFF0, 5, n_out)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert not out[bucket:].any()


@pytest.mark.gpu
def test_ingest_known_kernel_on_a_bench_sized_table(card):
    """Bench sizing: a 2^18-row v4 stream (id_bits 21) gathering from a
    2^21-slot table (100.7 MB, larger than the L2) into a 2^19-row window."""
    rng = np.random.default_rng(21)
    slots, bucket, n_out = 1 << 21, 1 << 18, 1 << 19
    wire = from_numpy(_k7_known(rng, bucket, bucket - 1000, 21, True, slots), card)
    table = torch.randint(-(1 << 31), 1 << 31, (slots, 12), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(21)).to(card)
    out = kops.ingest_known(wire, bucket, True, 21, table, 1, 0xFFFFFF00, 7, n_out)
    with kops.plain_versions():
        ref = kops.ingest_known(wire, bucket, True, 21, table, 1, 0xFFFFFF00, 7, n_out)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["flowdict", "invertible"])
def test_engine_on_card_matches_cpu(card, source):
    from retina_tpu_torch.config import Config
    from retina_tpu_torch.convert import tensor_leaves
    from retina_tpu_torch.engine import SketchEngine

    # 3000 slots: the dictionary clears twice and the replay meets known rows.
    cfg = Config(batch_capacity=1 << 11, feed_coalesce_windows=2, flow_dict_slots=3000,
                 transfer_min_bucket=256, n_pods=256, cms_width=1 << 12, topk_slots=1 << 8,
                 hll_precision=10, entropy_buckets=1 << 9, conntrack_slots=1 << 10,
                 identity_slots=1 << 9, heavy_keys_source=source,
                 invertible_width=1 << 9, invertible_hi_width=1 << 6)
    gen = TrafficGen(n_flows=3000, n_pods=200, seed=6)
    quanta = [[gen.batch(4096) for _ in range(2)] for _ in range(3)]
    quanta[0][0][::40, F.PACKETS] = 3000  # escalates
    engines = [SketchEngine(cfg, device=d) for d in (card, "cpu")]
    kops.reset_launch_counts()
    for eng in engines:
        eng.update_identities({pod_ip(i): i for i in range(1, 200)})
        for i, blocks in enumerate(quanta + quanta):
            eng.flush(blocks, 10 + i)
        if eng.device.type == "cuda":
            counts = kops.launch_counts()
    if source == "flowdict":
        assert counts["ingest_new"] > 0 and counts["ingest_known"] > 0
        assert engines[0]._flow_dict.generation > 0
    else:
        assert counts["ingest_packed"] > 0 and counts["ingest_new"] == 0
    assert kops.launch_counts() == counts  # the CPU engine launched nothing
    for x, y in zip(tensor_leaves(engines[0].state), tensor_leaves(engines[1].state)):
        assert torch.equal(x.cpu(), y)


def _stack(rng, shape, high=1 << 32):
    return rng.integers(0, high, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("n_slots", [1, 2, 7, 64])
def test_fold_kernel_matches_plain(card, n_slots):
    rng = np.random.default_rng(50 + n_slots)
    u = from_numpy(_stack(rng, (n_slots, 3, 1000)), card)  # sums wrap mod 2^32
    hll = from_numpy(_stack(rng, (n_slots, 64, 65), high=34), card)
    hll[:, 0, :5] = -1  # 0xFFFFFFFF: the max is unsigned
    # float32 entropy counts with integer values both below and above 2^24,
    # so the order of the adds shows above it.
    ent = torch.from_numpy(rng.integers(0, 1 << 26, (n_slots, 3, 4096)).astype(np.float32))
    ent = ent.to(card)
    for x, op in ((u, "sum_u32"), (hll, "max_u32"), (ent, "sum_f32")):
        before = kops.launch_counts()["fold"]
        out = kops.fold(x, op)
        assert kops.launch_counts()["fold"] == before + 1
        with kops.plain_versions():
            ref = kops.fold(x, op)
        torch.cuda.synchronize()
        assert out.dtype == x.dtype and out.shape == x.shape[1:]
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), op


@pytest.mark.gpu
@pytest.mark.parametrize("n_tables", [1, 3, 64])
def test_topk_join_kernel_matches_chained_merges(card, n_tables):
    rng = np.random.default_rng(60 + n_tables)
    s, c = 512, 4
    keys = _stack(rng, (n_tables, s, c))
    counts = _stack(rng, (n_tables, s), high=6)  # many equal counts
    counts[:, :32] = 0  # empty slots: zero counts and zero keys
    keys[:, :32] = 0
    keys[:, 32:128] = keys[0, 32:128]  # equal keys: the tie reaches the last column
    keys[1:, 64:96, 3] ^= np.uint32(1 << 31)  # keys that differ only in a top bit
    keys[:, 96:128, 0] = np.uint32(0x80000000)
    k, n = from_numpy(keys, card), from_numpy(counts, card)
    before = kops.launch_counts()["topk_join"]
    out = kops.topk_join(k, n)
    assert kops.launch_counts()["topk_join"] == before + 1
    with kops.plain_versions():
        ref = kops.topk_join(k, n)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def _join_family(rng, n, s, c):
    """A family of n stacked (s, c) candidate tables on the CPU: counts 0 to
    5 (many ties), empty slots, whole-row ties that reach the last column,
    keys that differ only in a top bit and keys with the top bit set."""
    keys = _stack(rng, (n, s, c))
    counts = _stack(rng, (n, s), high=6)
    counts[:, :8], keys[:, :8] = 0, 0
    keys[:, 8:40] = keys[0, 8:40]
    keys[1:, 24:40, c - 1] ^= np.uint32(1 << 31)
    keys[:, 40:56, 0] |= np.uint32(0x80000000)
    return from_numpy(keys, "cpu"), from_numpy(counts, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("n_fams", [1, 2, 3])
@pytest.mark.parametrize("n_tables", [1, 2, 3, 32, 64])
def test_topk_join_many_kernel_matches_plain(card, n_tables, n_fams):
    """K9's many-family entry: one launch for 1 to 3 families (flow C = 4 at
    2048 slots, svc C = 2 at 100, dns C = 1 at 2047: slot counts that are
    and are not a multiple of the block's 32), bit-equal to the plain
    chained merges."""
    rng = np.random.default_rng(90 + 4 * n_tables + n_fams)
    fams = [_join_family(rng, n_tables, s, c) for s, c in ((2048, 4), (100, 2), (2047, 1))]
    fams = [(k.to(card), c.to(card)) for k, c in fams[:n_fams]]
    before = kops.launch_counts()["topk_join"]
    out = kops.topk_join_many(fams)
    assert kops.launch_counts()["topk_join"] == before + 1
    with kops.plain_versions():
        ref = kops.topk_join_many(fams)
    torch.cuda.synchronize()
    for (k, c), (rk, rc) in zip(out, ref):
        assert torch.equal(k, rk) and torch.equal(c, rc)


@pytest.mark.gpu
def test_fold_stacked_on_card_launches_k8_and_k9_once(card):
    """A range query's or fleet merge's fold on the card: one launch of K8
    and one of K9 for the three families, equal to the plain versions."""
    from retina_tpu_torch.timetravel.fold import fold_stacked

    rng = np.random.default_rng(95)
    stacked = {"flow_cms": from_numpy(_stack(rng, (32, 4, 1 << 10)), card),
               "hll_flows": from_numpy(_stack(rng, (32, 1, 1 << 10), high=34), card)}
    for fam, c in (("flow", 4), ("svc", 2), ("dns", 1)):
        k, n = _join_family(rng, 32, 2048, c)
        stacked[f"{fam}_keys"], stacked[f"{fam}_counts"] = k.to(card), n.to(card)
    kops.reset_launch_counts()
    out = fold_stacked(stacked)
    assert {k: v for k, v in kops.launch_counts().items() if v} == {"fold": 1, "topk_join": 1}
    with kops.plain_versions():
        ref = fold_stacked(stacked)
    torch.cuda.synchronize()
    assert sorted(out) == sorted(ref)
    for name in ref:
        assert torch.equal(out[name], ref[name]), name


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [1, 2, 4])
def test_cms_query_kernel_matches_plain(card, n_cols):
    from retina_tpu_torch.ops.countmin import CountMinSketch

    rng = np.random.default_rng(70 + n_cols)
    cms = CountMinSketch(from_numpy(_stack(rng, (4, 1 << 12)), card), seed=3)
    rows = from_numpy(_stack(rng, (5000, 4)), card)  # strided columns
    cols = [rows[:, j] for j in range(n_cols)]
    before = kops.launch_counts()["cms_query"]
    out = kops.cms_query(cms.table, cms.seed, cols)
    assert kops.launch_counts()["cms_query"] == before + 1
    with kops.plain_versions():
        ref = kops.cms_query(cms.table, cms.seed, cols)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(cms.query(cols), ref.to(torch.int64) & 0xFFFFFFFF)


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [1, 4])
def test_cms_update_kernel_matches_plain(card, n_cols):
    """Row 12 at the deployed CMS shape (depth 4, width 2^15), with masked
    rows (weight 0), repeated keys and weights that wrap the u32 counters."""
    from retina_tpu_torch.ops.countmin import CountMinSketch, cms_update_jit

    rng = np.random.default_rng(75 + n_cols)
    n = 1 << 16
    rows = _stack(rng, (n, 4))
    rows[n // 2:] = rows[: n // 2]
    w = rng.integers(0, 9, n).astype(np.uint32)
    w[rng.random(n) < 0.25] = 0
    w[:8] = 0xFFFFFFF0
    cols = [from_numpy(rows, card)[:, j] for j in range(n_cols)]  # strided columns
    wt = from_numpy(w, card)
    start = _stack(rng, (4, 1 << 15))
    sk = CountMinSketch(from_numpy(start, card), seed=5)
    ref = CountMinSketch(from_numpy(start, card), seed=5)
    before = kops.launch_counts()["cms_update"]
    assert cms_update_jit(sk, cols, wt) is sk
    assert kops.launch_counts()["cms_update"] == before + 1
    with kops.plain_versions():
        cms_update_jit(ref, cols, wt)
    torch.cuda.synchronize()
    assert torch.equal(sk.table, ref.table)


def _portscan_keys(p: int, seed: int):
    """The tap's keys of a portscan-regime window of bench traffic, padded
    to P rows, with sources that have the top bit set."""
    from retina_tpu_torch.detect.features import padded_flow_keys

    gen = TrafficGen(n_flows=100_000, n_pods=2048, mode="portscan", seed=seed)
    return padded_flow_keys(gen.batch(p - p // 8))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1 << 6, 1 << 12, 1 << 16])
def test_detect_portscan_kernel_matches_plain(card, p):
    from retina_tpu_torch.detect import programs

    keys, w = _portscan_keys(p, 80 + p.bit_length())
    k, wt = from_numpy(keys, card), from_numpy(w, card)
    before = kops.launch_counts()["portscan_score"]
    out = programs.portscan_program(k, wt)
    assert kops.launch_counts()["portscan_score"] == before + 1
    with kops.plain_versions():
        ref = programs.portscan_program(k, wt)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (programs.PORTSCAN_GROUPS,)
    assert torch.allclose(out, ref, rtol=1e-5, atol=0)
    assert float(out.max()) >= 12.0  # the sweep is seen


def _portscan_case(case: str):
    """(keys, weights) of a K11 edge: "one group" (every row's source in one
    hash-group, so every remote atomic lands in one block), "top bit" (every
    source with its top bit set: the group product wraps), "zero weights"
    (every row padding), "ragged" (P = 16 * 1024 * 4 + 777 rows, not a
    multiple of a cluster's rows a pass)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    keys, w = _portscan_keys(1 << 16, 90)
    if case == "one group":
        keys[:, 0] = 0x0A000001
        keys[:, 3] = rng.integers(0, 1 << 16, len(keys))
        w[:] = 1.0
    elif case == "top bit":
        keys[:, 0] |= np.uint32(0x80000000)
    elif case == "zero weights":
        w[:] = 0.0
    elif case == "ragged":
        keys, w = _portscan_keys(1 << 17, 91)
        keys, w = keys[: 16 * 1024 * 4 + 777], w[: 16 * 1024 * 4 + 777]
    return np.ascontiguousarray(keys), np.ascontiguousarray(w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one group", "top bit", "zero weights", "ragged"])
def test_detect_portscan_kernel_at_its_edges(card, case):
    from retina_tpu_torch.detect import programs

    keys, w = _portscan_case(case)
    k, wt = from_numpy(keys, card), from_numpy(w, card)
    before = kops.launch_counts()["portscan_score"]
    out = programs.portscan_program(k, wt)
    assert kops.launch_counts()["portscan_score"] == before + 1
    with kops.plain_versions():
        ref = programs.portscan_program(k, wt)
    torch.cuda.synchronize()
    assert torch.allclose(out, ref, rtol=1e-5, atol=0)
    if case == "one group":
        assert int((out > 0).sum()) == 1 and float(out.max()) > 10_000
    if case == "zero weights":
        assert not out.any()


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", range(1, 17))
def test_detect_portscan_kernel_at_every_cluster_size(card, blocks):
    """Every cluster size the wrapper may choose (1 to 16 blocks, a block a
    PORTSCAN_BLOCK_ROWS rows) at 32, 3 and 64 groups. The rows of a one-block
    window, repeated ``blocks`` times and shuffled, raise the same registers
    (each a maximum), so every estimate is bit-equal to the one-block
    window's (the groups' f32 sums add in one order whatever the cluster)
    and within a relative 1e-5 of the plain version."""
    keys, w = _portscan_keys(kops.PORTSCAN_BLOCK_ROWS, 92)
    order = np.random.default_rng(blocks).permutation(blocks * len(keys))
    many_keys = np.ascontiguousarray(np.tile(keys, (blocks, 1))[order])
    many_w = np.ascontiguousarray(np.tile(w, blocks)[order])
    k1, w1 = from_numpy(keys, card), from_numpy(w, card)
    k, wt = from_numpy(many_keys, card), from_numpy(many_w, card)
    for groups, precision in ((32, 8), (3, 8), (64, 8)):
        assert kops.portscan_cluster(groups, precision, len(keys)) == 1
        assert kops.portscan_cluster(groups, precision, len(many_keys)) == blocks
        one = kops.portscan_score(k1, w1, groups, precision, 5)
        out = kops.portscan_score(k, wt, groups, precision, 5)
        with kops.plain_versions():
            ref = kops.portscan_score(k, wt, groups, precision, 5)
        torch.cuda.synchronize()
        assert torch.equal(out, one), (groups, blocks)
        assert torch.allclose(out, ref, rtol=1e-5, atol=0), (groups, blocks)
        assert float(out.max()) > 0


def _query_jobs(card, n_jobs: int, rng):
    """``n_jobs`` K10 jobs over one deployed-width table (depth 4, 2^15) of
    different R (0, 1 and more), key columns of 1 to 4 words: the columns of
    row-major (R, 4) and (R, 2) tensors, strided columns of an (R, 5) tensor
    and contiguous columns; masks where the job has one;
    min_weight 0, a middling one and 2^31 and past (an unsigned compare)."""
    table = from_numpy(_stack(rng, (4, 1 << 15), high=1 << 12), card)
    table[:, ::2] = -0x40000000  # 0xC0000000: a key on even columns counts past 2^31
    kinds = ["row4", "col1", "row2", "strided3", "contig4"]
    sizes = [5000, 0, 1, 70_000, 777]
    weights = [0, 0, 1 << 31, 2000, 0xC0000000]
    jobs = []
    for j in range(n_jobs):
        kind, r = kinds[j % 5], sizes[(j + n_jobs) % 5] if n_jobs > 1 else 131_072
        data = from_numpy(_stack(rng, (r, 5)), card)
        if r:
            data[::7] = data[0].clone()  # repeated keys
        if kind == "row4":
            base = data[:, :4].contiguous()
            cols = [base[:, c] for c in range(4)]
        elif kind == "row2":
            base = data[:, :2].contiguous()
            cols = [base[:, c] for c in range(2)]
        elif kind == "strided3":
            cols = [data[:, c] for c in range(3)]
        elif kind == "contig4":
            cols = [data[:, c].contiguous() for c in range(4)]
        else:
            cols = [data[:, 0].contiguous()]
        mask = (None if j % 2 == 0 else
                torch.from_numpy(rng.random(r) < 0.7).to(card))
        jobs.append((table, 40 + j, cols, mask, weights[j % 5]))
    return jobs


@pytest.mark.gpu
@pytest.mark.parametrize("n_jobs", [1, 2, 5])
def test_cms_query_many_kernel_matches_plain(card, n_jobs):
    rng = np.random.default_rng(100 + n_jobs)
    jobs = _query_jobs(card, n_jobs, rng)
    before = kops.launch_counts()["cms_query"]
    est, ok = kops.cms_query_many(jobs)
    assert kops.launch_counts()["cms_query"] == before + 1
    with kops.plain_versions():
        ref_est, ref_ok = kops.cms_query_many(jobs)
    torch.cuda.synchronize()
    assert torch.equal(est, ref_est) and torch.equal(ok, ref_ok)
    assert ok.any() and (n_jobs == 1 or not ok.all())


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8192, 65_536, 131_072, 262_144])
def test_cms_query_kernel_at_the_fixed_shape(card, rows):
    """Depth 4 and 4 key columns, the shape every config's query has: below
    3 blocks a SM the depth rows' gathers issue together, from there the
    depth rows run in order. Two jobs of ``rows`` rows each (strided and
    contiguous columns, one masked at a middling min_weight), est and ok
    bit-equal to the plain versions."""
    rng = np.random.default_rng(rows)
    table = from_numpy(_stack(rng, (4, 1 << 15), high=1 << 12), card)
    data = from_numpy(_stack(rng, (rows, 4)), card)
    flat = from_numpy(_stack(rng, (4, rows)), card)
    mask = torch.from_numpy(rng.random(rows) < 0.7).to(card)
    for jobs in ([(table, 3, [data[:, c] for c in range(4)], None, 0)],
                 [(table, 3, [data[:, c] for c in range(4)], None, 0),
                  (table, 9, [flat[c] for c in range(4)], mask, 2000)]):
        est, ok = kops.cms_query_many(jobs)
        with kops.plain_versions():
            ref_est, ref_ok = kops.cms_query_many(jobs)
        torch.cuda.synchronize()
        assert torch.equal(est, ref_est) and torch.equal(ok, ref_ok)
        assert ok[:rows].all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["all false", "min weight 2^31", "depth 3"])
def test_cms_query_many_kernel_at_its_edges(card, case):
    """An all-false mask (every row rejected, est 0), min_weight 2^31 (the
    compare is unsigned: the estimates past it pass) and a depth-3 table
    (the instance that reads its depth), est and ok bit-equal to the plain
    versions."""
    rng = np.random.default_rng(sum(map(ord, case)))
    jobs = _query_jobs(card, 5, rng)
    if case == "all false":
        jobs = [(t, s, c, None if c[0].shape[0] == 0 else
                 torch.zeros(c[0].shape[0], dtype=torch.bool, device=card), mw)
                for t, s, c, _, mw in jobs]
    elif case == "min weight 2^31":
        jobs = [(t, s, c, m, 1 << 31) for t, s, c, m, _ in jobs]
    elif case == "depth 3":
        jobs = [(t[:3].contiguous(), s, c, m, mw) for t, s, c, m, mw in jobs]
    est, ok = kops.cms_query_many(jobs)
    with kops.plain_versions():
        ref_est, ref_ok = kops.cms_query_many(jobs)
    torch.cuda.synchronize()
    assert torch.equal(est, ref_est) and torch.equal(ok, ref_ok)
    if case == "all false":
        assert not ok.any() and not est.any()
    if case == "min weight 2^31":
        assert ok.any() and bool((est.view(torch.int32) < 0)[ok].all())


@pytest.mark.gpu
def test_inv_decode_verifies_both_regions_in_one_launch(card):
    """A window close's decode on the card: one K15 launch for both regions
    and one K10 launch for their query and filter, and no other kernel of
    the port, equal to the CPU run of the same steps at min_weight 0 and at
    one that rejects keys."""
    cfg = INVERTIBLE_CUT
    on_card = _run_steps(Telemetry(cfg, device=card).pipeline, card, n_steps=3)
    on_cpu = _run_steps(Telemetry(cfg, device="cpu").pipeline, "cpu", n_steps=3)
    for min_weight in (0, 5):
        kops.reset_launch_counts()
        got = Telemetry(cfg, device=card).inv_decode(on_card, min_weight)
        counts = kops.launch_counts()
        assert {k: v for k, v in counts.items() if v} == {"inv_decode": 1, "cms_query": 1}
        want = Telemetry(cfg, device="cpu").inv_decode(on_cpu, min_weight)
        torch.cuda.synchronize()
        for key in want:
            assert torch.equal(got[key].cpu(), want[key]), key
        assert bool(got["ok"].any())


@pytest.mark.gpu
def test_detect_dnstunnel_kernel_matches_plain(card):
    from retina_tpu_torch.detect import features, programs

    gen = TrafficGen(n_flows=100_000, n_pods=2048, mode="dns_flood", dns_fraction=0.8,
                     zipf_a=1.5, seed=81)
    for hist in (features.qname_length_hist(gen.batch(1 << 16)), np.zeros((1, 64), np.float32)):
        h = from_numpy(hist, card)
        before = kops.launch_counts()["dnstunnel_score"]
        out = programs.dnstunnel_program(h)
        assert kops.launch_counts()["dnstunnel_score"] == before + 1
        with kops.plain_versions():
            ref = programs.dnstunnel_program(h)
        torch.cuda.synchronize()
        assert torch.allclose(out, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_detect_synflood_kernel_is_exact(card):
    from retina_tpu_torch.detect import features, programs

    gen = TrafficGen(n_flows=100_000, n_pods=2048, mode="syn_storm", zipf_a=1.05,
                     drop_fraction=0.15, seed=82)
    for lanes in (features.tcpflag_lanes(gen.batch(1 << 16)), np.zeros(9, np.float32),
                  np.array([0, 7, 0, 0, 3, 0, 0, 0, 11], np.float32)):
        x = from_numpy(lanes, card)
        before = kops.launch_counts()["synflood_score"]
        out = programs.synflood_program(x)
        assert kops.launch_counts()["synflood_score"] == before + 1
        with kops.plain_versions():
            ref = programs.synflood_program(x)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


# The bank's close: three slots in the bank's order (dnstunnel, portscan,
# synflood), each with its own (z_thresh, min_windows, alpha).
BANK_KINDS = (kops.BANK_DNSTUNNEL, kops.BANK_PORTSCAN, kops.BANK_SYNFLOOD)
BANK_KNOBS = ((8.0, 3, 0.1), (4.0, 2, 0.1), (3.0, 5, 0.25))
BANK_CASES = ("first", "warmup", "flagged", "inactive", "ack_zero", "total_zero",
              "zero_hist", "one_bin", "mixed")


def bank_windows(case: str) -> list[list]:
    """The features of a sequence of window closes of the bank's three
    slots, made from a seed with numpy: each window [hist (1, 64), estimates
    (32,), lanes (9,)] float32, or None for an inactive slot. "first": one
    window; "warmup": noisy benign windows up to and past every slot's
    min_windows; "flagged": benign windows, one outlier in every slot (it
    must not enter the baseline), benign again; "inactive": each slot
    inactive in every third window; "ack_zero", "total_zero": lanes with no
    ACK, all-zero lanes; "zero_hist", "one_bin": an all-zero and a one-bin
    histogram, among benign windows; "mixed": all of them."""
    rng = np.random.default_rng(BANK_CASES.index(case) + 70)

    def benign():
        hist = np.zeros((1, 64), np.float32)
        hist[0, 8:17] = rng.integers(20, 300, 9)
        est = rng.uniform(1.0, 5.0, 32).astype(np.float32)
        lanes = np.zeros(9, np.float32)
        lanes[8] = rng.integers(5000, 9000)
        lanes[4] = lanes[8] - rng.integers(0, 200)
        lanes[1] = rng.integers(100, 600)
        return [hist, est, lanes]

    def outlier():
        hist = rng.integers(0, 500, (1, 64)).astype(np.float32)
        est = rng.uniform(1.0, 5.0, 32).astype(np.float32)
        est[7] = 40.0
        lanes = np.array([0, 9000, 0, 0, 300, 0, 0, 0, 9400], np.float32)
        return [hist, est, lanes]

    n = {"first": 1, "warmup": 8, "flagged": 14, "inactive": 12, "mixed": 16}.get(case, 8)
    windows = [benign() for _ in range(n)]
    if case in ("flagged", "mixed"):
        windows[9] = outlier()
    if case in ("inactive", "mixed"):
        for t, w in enumerate(windows):
            for j in range(3):
                if (t + j) % 3 == 0:
                    w[j] = None
    if case in ("ack_zero", "mixed"):
        windows[5][2] = np.array([0, 700, 0, 0, 0, 0, 0, 0, 700], np.float32)
    if case in ("total_zero", "mixed"):
        windows[6][2] = np.zeros(9, np.float32)
    if case in ("zero_hist", "mixed"):
        windows[4][0] = np.zeros((1, 64), np.float32)
    if case in ("one_bin", "mixed"):
        windows[7][0] = np.zeros((1, 64), np.float32)
        windows[7][0][0, 11] = 321.0
    return windows


def bank_slots(window, device) -> list:
    """``kops.bank_close``'s slots of one window of ``bank_windows``: the
    estimates as a tensor on ``device``."""
    return [(kind, None if x is None else (torch.from_numpy(x).to(device)
                                           if kind == kops.BANK_PORTSCAN else x), *knobs)
            for kind, x, knobs in zip(BANK_KINDS, window, BANK_KNOBS)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BANK_CASES)
def test_bank_close_kernel_matches_plain(card, case):
    """The bank's close on the card against its plain version, window by
    window from the same state: one launch a close (none when every slot
    is inactive), scores (synflood and portscan exact, dnstunnel rtol
    1e-5), flags equal, z atol 1e-4, mean rtol 1e-5, var atol 1e-6, n_obs
    equal."""
    io = kops.BankCloseIO(card, 3)
    state = [torch.zeros(3, device=card) for _ in range(3)]
    ref = [torch.zeros(3, device=card) for _ in range(3)]
    for window in bank_windows(case):
        slots = bank_slots(window, card)
        before = kops.launch_counts()["bank_close"]
        score, z, flag = kops.bank_close(slots, *state, io=io)
        active = any(x is not None for x in window)
        assert kops.launch_counts()["bank_close"] == before + active
        with kops.plain_versions():
            r_score, r_z, r_flag = kops.bank_close(slots, *ref)
        torch.cuda.synchronize()
        assert torch.equal(flag, r_flag)
        torch.testing.assert_close(score[0], r_score[0], rtol=1e-5, atol=0)
        assert torch.equal(score[1:], r_score[1:])
        torch.testing.assert_close(z, r_z, rtol=0, atol=1e-4)
        torch.testing.assert_close(state[0], ref[0], rtol=1e-5, atol=0)
        torch.testing.assert_close(state[1], ref[1], rtol=0, atol=1e-6)
        assert torch.equal(state[2], ref[2])


@pytest.mark.gpu
def test_bank_close_kernel_over_several_tables(card):
    """More slots than one launch's table holds: twelve slots of the
    "mixed" windows, the histograms widened to 256 bins, so a table a
    launch (3 dnstunnel slots fill 512 floats past a table's slot count of
    8) and one wait; each slot against the plain version at the same
    tolerances."""
    io = kops.BankCloseIO(card, 12)
    state = [torch.zeros(12, device=card) for _ in range(3)]
    ref = [torch.zeros(12, device=card) for _ in range(3)]
    rng = np.random.default_rng(29)
    for window in bank_windows("mixed"):
        slots = []
        for rep in range(4):
            for (kind, x, *knobs) in bank_slots(window, card):
                if kind == kops.BANK_DNSTUNNEL and x is not None:
                    x = np.concatenate([x, rng.integers(0, 50, (1, 192)).astype(np.float32)],
                                       axis=1)
                slots.append((kind, x, *knobs))
        sizes = kops._bank_slots_check(slots, state[0].device)
        want = len(kops._bank_tables(slots, sizes, *state, io))
        before = kops.launch_counts()["bank_close"]
        score, z, flag = kops.bank_close(slots, *state, io=io)
        assert kops.launch_counts()["bank_close"] == before + want
        with kops.plain_versions():
            r_score, r_z, r_flag = kops.bank_close(slots, *ref)
        torch.cuda.synchronize()
        dns = torch.tensor([k == kops.BANK_DNSTUNNEL for k, *_ in slots])
        assert torch.equal(flag, r_flag)
        torch.testing.assert_close(score[dns], r_score[dns], rtol=1e-5, atol=0)
        assert torch.equal(score[~dns], r_score[~dns])
        torch.testing.assert_close(z, r_z, rtol=0, atol=1e-4)
        torch.testing.assert_close(state[0], ref[0], rtol=1e-5, atol=0)
        torch.testing.assert_close(state[1], ref[1], rtol=0, atol=1e-6)
        assert torch.equal(state[2], ref[2])


@pytest.mark.gpu
def test_bank_close_on_card_matches_cpu_bank(card):
    """A default bank on the card against one on the CPU over benign and
    attack windows: the same firings, scores and z; each close on the card
    one K11 and one bank_close launch, no K12 or K13 alone and no
    AnomalyEWMA.observe call; ``Detector.judge`` alone steps the bank's
    state (its ``_ewma`` views it)."""
    from retina_tpu_torch.config import Config
    from retina_tpu_torch.detect import build_default_bank
    from retina_tpu_torch.ops import entropy

    gens = {m: TrafficGen(n_flows=100_000, n_pods=2048, mode=m, seed=83)
            for m in ("mix", "syn_storm", "dns_flood", "portscan")}
    banks = [build_default_bank(Config(detector_min_windows=2), device=d) for d in (card, "cpu")]
    calls = []
    observe = entropy.AnomalyEWMA.observe
    entropy.AnomalyEWMA.observe = lambda *a, **kw: (calls.append(1), observe(*a, **kw))[1]
    try:
        for e, mode in enumerate(["mix"] * 4 + ["syn_storm", "mix", "dns_flood", "portscan"]):
            rec = gens[mode].batch(1 << 14)
            for b in banks:
                b.observe(e, rec, now_s=float(e))
            calls.clear()
            kops.reset_launch_counts()
            got = banks[0].flush(now_s=float(e))
            assert not calls
            counts = {k: v for k, v in kops.launch_counts().items() if v}
            assert counts == {"portscan_score": 1, "bank_close": 1}, counts
            want = banks[1].flush(now_s=float(e))
            assert [(d.detector, d.epoch) for d in got] == [(d.detector, d.epoch) for d in want]
            for name, score in banks[1].detector_score.items():
                np.testing.assert_allclose(banks[0].detector_score[name], score, rtol=1e-5)
                np.testing.assert_allclose(banks[0].detector_zscore[name],
                                           banks[1].detector_zscore[name], atol=1e-4)
    finally:
        entropy.AnomalyEWMA.observe = observe
    assert banks[0].fired, "no attack window fired"
    syn = next(d for d in banks[0].detectors if d.name == "synflood")
    syn.add_records(gens["syn_storm"].batch(1 << 14))
    n_obs = float(banks[0]._state[2][2])
    syn.judge(100)
    assert float(banks[0]._state[2][2]) == n_obs + 1
    assert syn._ewma.n_obs.data_ptr() == banks[0]._state[2][2:].data_ptr()


API = 0x7F000001


def _latency_records(rng, n, api, prev=None, every=8):
    """(n, 16) rows of TrafficGen traffic with one row in ``every`` turned
    into an apiserver send (the first half of them) or reply (the second):
    RTTs in every bucket, the 2^13 and 2^15 edges and 0xFFFFFFFF, repeated
    TSvals (the last send wins), replies twice, and, given the ``prev``
    batch's (TSvals, send times), replies to its sends. Returns the rows
    and this batch's (TSvals, send times)."""
    rec = TrafficGen(n_flows=5000, n_pods=200, seed=int(rng.integers(1 << 16))).batch(n)
    idx = np.arange(0, n, every)
    half = len(idx) // 2
    send, reply = idx[:half], idx[half: 2 * half]
    rtts = np.array([0, 1, 2, 7, 100, 8191, 8192, 32767, 40000, 1 << 20, 0xFFFFFFFF], np.int64)
    tsv = rng.integers(1, 1 << 31, half).astype(np.uint32)
    tsv[1::5] = tsv[0::5][: len(tsv[1::5])]
    t_send = rng.integers(1 << 21, 1 << 30, half).astype(np.int64)
    reply_tsv, reply_t = tsv.copy(), t_send.copy()
    if prev is not None:
        reply_tsv[1::3], reply_t[1::3] = prev[0][1::3], prev[1][1::3]
    reply_tsv[2::7] = reply_tsv[0::7][: len(reply_tsv[2::7])]  # the same reply twice
    reply_t[2::7] = reply_t[0::7][: len(reply_t[2::7])]
    reply_ms = (reply_t + rtts[np.arange(half) % len(rtts)]) & 0xFFFFFFFF
    for rows, ms in ((send, t_send), (reply, reply_ms)):
        ns = ms << 20
        rec[rows, F.TS_LO] = (ns & 0xFFFFFFFF).astype(np.uint32)
        rec[rows, F.TS_HI] = (ns >> 32).astype(np.uint32)
    rec[send, F.DST_IP] = api
    rec[send, F.TSVAL] = tsv
    rec[reply, F.SRC_IP] = api
    rec[reply, F.TSECR] = reply_tsv
    return rec, (tsv, t_send)


@pytest.mark.gpu
@pytest.mark.parametrize("n_slots", [1 << 6, 1 << 12])
@pytest.mark.parametrize("api", [API, 0])
def test_latency_kernel_matches_plain(card, n_slots, api):
    """K14 through the fused path (K1 lists the probes, the finish applies
    them) over three consecutive batches (the table carries over), with
    rows the filter drops and a partial batch, at a heavily colliding and
    at the deployed slot count; the plain path is K1's and K14's plain
    versions on K1's mask lane."""
    rng = np.random.default_rng(90 + n_slots.bit_length() + api % 7)
    n = 1 << 16
    cfg = dataclasses.replace(CFG, latency_slots=n_slots)
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, 150)} | {API: 3},
                                   n_slots=1 << 10, device=card)
    pipe = TelemetryPipeline(cfg, device=card)
    states = [pipe.init_state(), pipe.init_state()]
    prev = None
    for t in range(3):
        rows, prev = _latency_records(rng, n, api, prev)
        rows[5::13, F.SRC_IP] = rows[5::13, F.DST_IP] = 0xC0000001  # no pod: filtered
        rec = from_numpy(rows, card)
        for plain, st in ((False, states[0]), (True, states[1])):
            with kops.plain_versions() if plain else contextlib.nullcontext():
                before = kops.launch_counts()
                scratch, _ = kops.step_rows(
                    rec, n - 3000 * t, 1, ident.table, ident.seed, None, 0, st.pod_forward,
                    st.pod_drop, st.pod_tcpflags, st.pod_dns, st.pod_retrans,
                    st.node_counters, st.totals, cfg, apiserver_ip=api)
                kops.latency_update(st.lat_key, st.lat_ts, st.lat_hist, rec,
                                    scratch[kops.SCRATCH.index("mask")], api)
                launched = {k: v - before[k] for k, v in kops.launch_counts().items() if v != before[k]}
                assert launched == ({} if plain else {"step_rows": 1, "latency_update": 1})
        torch.cuda.synchronize()
        for name in ("lat_key", "lat_ts", "lat_hist"):
            assert torch.equal(getattr(states[0], name), getattr(states[1], name)), name
    hist = states[0].lat_hist
    assert int(hist.sum()) > 0 and int(hist[15]) > 0


@pytest.mark.gpu
def test_latency_kernel_at_the_step_launches_once_and_no_plain_op(card):
    """Through the fused path a step's latency match is one launch of the
    finish after K1's; with no K1 list for the records the wrapper raises."""
    from retina_tpu_torch.models import pipeline as tpipeline

    rng = np.random.default_rng(95)
    rec = from_numpy(_latency_records(rng, 1 << 12, API)[0], card)
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, 200)}, n_slots=1 << 9,
                                   device=card)
    st = TelemetryPipeline(CFG, device=card).init_state()
    lat = [st.lat_key, st.lat_ts, st.lat_hist]
    plain, called = tpipeline.latency_update_plain, []
    tpipeline.latency_update_plain = lambda *a: called.append(a)
    try:
        before = kops.launch_counts()
        scratch, _ = kops.step_rows(rec, 1 << 12, 1, ident.table, ident.seed, None, 0,
                                    st.pod_forward, st.pod_drop, st.pod_tcpflags, st.pod_dns,
                                    st.pod_retrans, st.node_counters, st.totals, CFG,
                                    apiserver_ip=API)
        mask = scratch[kops.SCRATCH.index("mask")]
        kops.latency_update(*lat, rec, mask, API)
        after = kops.launch_counts()
        assert after["latency_update"] == before["latency_update"] + 1 and not called
        assert after["step_rows"] == before["step_rows"] + 1
        with pytest.raises(ValueError, match="no probe list"):
            kops.latency_update(*lat, rec, mask, API)
    finally:
        tpipeline.latency_update_plain = plain
    torch.cuda.synchronize()
    assert int(st.lat_hist.sum()) > 0


def _decode_inputs(rng, n_cols, width, heavy_weight):
    """A sketch of heavy keys (some with the top bit set) over light noise,
    as planes and weights on the CPU."""
    inv = InvertibleSketch.zeros(2, width, n_key_cols=n_cols, seed=9, device="cpu")
    keys = rng.integers(0, 1 << 32, (4000, n_cols), dtype=np.uint64).astype(np.uint32)
    keys[:40, 0] |= np.uint32(0x80000000)
    w = rng.integers(1, 4, 4000).astype(np.uint32)
    w[:200] = heavy_weight
    inv.update([from_numpy(keys[:, j], "cpu") for j in range(n_cols)], from_numpy(w, "cpu"))
    return inv.planes, inv.weights


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [1, 4])
@pytest.mark.parametrize("heavy_weight", [60, 0xC0000000])
def test_inv_decode_kernel_matches_plain(card, n_cols, heavy_weight):
    """K15 at INVERTIBLE_CONFIG's inv_flow width, with bucket weights past
    2^31 (a signed majority would flip), an exact tie and an empty sketch."""
    rng = np.random.default_rng(100 + n_cols)
    planes, weights = _decode_inputs(rng, n_cols, 1 << 12, heavy_weight)
    tie_w = torch.full_like(weights[:, :8], 1 << 20)
    cases = [(planes, weights),
             (torch.where(torch.from_numpy(rng.random(planes.shape) < 0.3), 1 << 19, planes),
              weights.clone()),
             (torch.zeros_like(planes), torch.zeros_like(weights))]
    cases[1][1][:, :8] = tie_w  # p == w - p in the ties' planes
    for p, w in cases:
        pc, wc = p.contiguous().to(card), w.contiguous().to(card)
        before = kops.launch_counts()["inv_decode"]
        cols, ok = kops.inv_decode(pc, wc, 9, n_cols)
        assert kops.launch_counts()["inv_decode"] == before + 1
        with kops.plain_versions():
            ref_cols, ref_ok = kops.inv_decode(pc, wc, 9, n_cols)
        torch.cuda.synchronize()
        assert cols.shape == ref_cols.shape == (n_cols, wc.numel())
        assert torch.equal(cols, ref_cols) and torch.equal(ok, ref_ok)
    assert bool(kops.inv_decode(planes.to(card), weights.to(card), 9, n_cols)[1].any())


def _decode_region(rng, case, n_cols, width):
    """(planes, weights) of one decode case on the CPU: "heavy" keys over
    noise, "2^31" heavy keys whose buckets weigh 2^31 and more, "tie" (p ==
    w - p in a third of the planes) and "empty"."""
    if case == "empty":
        return (torch.zeros((2, width, 32 * (n_cols + 1)), dtype=torch.int32),
                torch.zeros((2, width), dtype=torch.int32))
    planes, weights = _decode_inputs(rng, n_cols, width, 0xC0000000 if case == "2^31" else 60)
    if case == "tie":
        w = torch.full_like(weights, 1 << 20)
        pick = torch.from_numpy(rng.random(planes.shape) < 0.3)
        planes = torch.where(pick, 1 << 19, planes % (1 << 20))
        return planes.contiguous(), w
    return planes, weights


@pytest.mark.gpu
@pytest.mark.parametrize("n_regions", [1, 2])
@pytest.mark.parametrize("n_cols", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["heavy", "2^31", "tie", "empty"])
def test_inv_decode_many_kernel_matches_plain(card, case, n_cols, n_regions):
    """K15's many-region entry: one launch for one region (INVERTIBLE_CONFIG's
    inv_flow width) or two (and inv_hi's, another seed and tier 1), keys,
    ok and tier bit-equal to the plain version."""
    rng = np.random.default_rng(120 + 8 * n_cols + n_regions)
    regions = [(p.to(card), w.to(card), seed, tier) for (p, w), seed, tier in zip(
        (_decode_region(rng, case, n_cols, 1 << 12), _decode_region(rng, case, n_cols, 1 << 9)),
        (9, -3), (0, 1))][:n_regions]
    before = kops.launch_counts()["inv_decode"]
    keys, ok, tier = kops.inv_decode_many(regions)
    assert kops.launch_counts()["inv_decode"] == before + 1
    with kops.plain_versions():
        ref = kops.inv_decode_many(regions)
    torch.cuda.synchronize()
    assert keys.shape == ref[0].shape == (sum(w.numel() for _, w, _, _ in regions), n_cols)
    assert torch.equal(keys, ref[0]) and torch.equal(ok, ref[1]) and torch.equal(tier, ref[2])
    if case in ("heavy", "2^31"):
        assert bool(ok.any())


# -- K16 and K17: the window close and the snapshot readout ---------------------


def _close_windows(rng, g, k, n=40):
    """n windows of (g, k) integer-valued histograms: idle windows (2, 9),
    the last group idle alone (15), group 0 collapsed into one bucket after
    the warm-up (30, 31)."""
    for w in range(n):
        counts = np.zeros((g, k), np.float32)
        if w not in (2, 9):
            for j in range(g):
                if j == 0 and w in (30, 31):
                    counts[j, 5] = 4000.0
                    continue
                if j == g - 1 and g > 1 and w == 15:
                    continue
                counts[j] = np.bincount(rng.integers(0, int(rng.integers(200, k)),
                                                     int(rng.integers(500, 4000))),
                                        minlength=k).astype(np.float32)
        yield counts


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 3])
def test_window_close_kernel_matches_plain_over_40_windows(card, g):
    """K16 with its EWMA carried over 40 windows, beside the plain version's
    own carried state: bits and z within rtol 1e-5 (z with atol 1e-4), the
    EWMA within rtol 1e-5 (var with atol 1e-6), flags and n_obs exactly,
    the histogram zero after each close; the read-only entry leaves its
    input as it was."""
    rng = np.random.default_rng(110 + g)
    k = 4096
    ewma = [torch.zeros(g, device=card) for _ in range(3)]
    ref_ewma = [torch.zeros(g, device=card) for _ in range(3)]
    flagged = []
    for counts in _close_windows(rng, g, k):
        c = torch.from_numpy(counts).to(card)
        c_ref = c.clone()
        before = kops.launch_counts()
        bits_only = kops.entropy_bits(c)
        bits, flags, z = kops.window_close(c, *ewma, 0.1, 4.0, 10)
        after = kops.launch_counts()
        assert after["entropy_bits"] == before["entropy_bits"] + 1
        assert after["window_close"] == before["window_close"] + 1
        with kops.plain_versions():
            ref_bits_only = kops.entropy_bits(c_ref)
            ref_bits, ref_flags, ref_z = kops.window_close(c_ref, *ref_ewma, 0.1, 4.0, 10)
        torch.cuda.synchronize()
        torch.testing.assert_close(bits_only, ref_bits_only, rtol=1e-5, atol=0)
        torch.testing.assert_close(bits, ref_bits, rtol=1e-5, atol=0)
        torch.testing.assert_close(z, ref_z, rtol=1e-5, atol=1e-4)
        assert torch.equal(flags, ref_flags) and torch.equal(ewma[2], ref_ewma[2])
        torch.testing.assert_close(ewma[0], ref_ewma[0], rtol=1e-5, atol=0)
        torch.testing.assert_close(ewma[1], ref_ewma[1], rtol=1e-5, atol=1e-6)
        assert not c.any() and not c_ref.any()
        flagged.append(bool(flags[0]))
    assert flagged[30] and not any(flagged[:30])
    assert ewma[2].tolist()[0] == 38


@pytest.mark.gpu
def test_window_close_bits_and_z_equal_plain_bit_for_bit(card):
    """K16 and its plain version sum the bits in float64 and round once, so
    over 40 windows of three groups the bits, z-scores and EWMA state are
    equal, not only close: a z-score magnifies an ulp of the bits when its
    baseline barely varies."""
    rng = np.random.default_rng(131)
    ewma = [torch.zeros(3, device=card) for _ in range(3)]
    ref_ewma = [torch.zeros(3, device=card) for _ in range(3)]
    for counts in _close_windows(rng, 3, 4096):
        c = torch.from_numpy(counts).to(card)
        c_ref = c.clone()
        out = kops.window_close(c, *ewma, 0.1, 4.0, 10)
        with kops.plain_versions():
            ref = kops.window_close(c_ref, *ref_ewma, 0.1, 4.0, 10)
        torch.cuda.synchronize()
        for x, y in zip([*out, *ewma], [*ref, *ref_ewma]):
            assert torch.equal(x, y)


def _slice_windows(rng, g, k, case, n=12):
    """n windows of (g, k) integer-valued histograms for K16's slice edges:
    "bench" random draws over part of the row, "dense" every bucket
    nonzero, "one bucket" each group's mass in one bucket (a different one
    a group), "collapse" the bench draws until group 0 collapses into one
    bucket in the last two windows."""
    for w in range(n):
        if case == "dense":
            counts = rng.integers(1, 1 << 12, (g, k)).astype(np.float32)
        elif case == "one bucket":
            counts = np.zeros((g, k), np.float32)
            counts[np.arange(g), (977 * np.arange(g) + w) % k] = float(rng.integers(1, 1 << 20))
        else:
            counts = np.stack([np.bincount(rng.integers(0, max(1, int(rng.integers(k // 4, k + 1))),
                                                        int(rng.integers(500, 4000))),
                                           minlength=k).astype(np.float32) for _ in range(g)])
            if case == "collapse" and w >= n - 2:
                counts[0] = 0.0
                counts[0, 5] = 4000.0
        yield counts


@pytest.mark.gpu
@pytest.mark.parametrize("g,k,case,slices", [
    (3, 4096, "bench", 32), (3, 4095, "bench", 32), (2, 1000, "bench", 7), (5, 1, "bench", 32),
    (1, 33, "dense", 32), (3, 16384, "dense", 32), (3, 16384, "bench", 48),
    (3, 4096, "one bucket", 32), (3, 4096, "collapse", 1), (4, 4096, "dense", 16)])
def test_window_close_matches_plain_at_slice_edges(card, monkeypatch, g, k, case, slices):
    """K16 at the edges of its G x S grid (a bucket count not a multiple of
    the slice, slices past the row's end, K = 1, K = 16384, one nonzero
    bucket a group, one block a group), its EWMA carried over 12 windows
    beside the plain version's: bits, flags, z, mean, var and n_obs equal
    bit for bit, the histogram zero after each close, the read-only entry's
    bits equal, and every group's ticket back at 0 after every call."""
    monkeypatch.setattr(kops, "ENTROPY_SLICES", slices)
    rng = np.random.default_rng(k + g + slices)
    ewma = [torch.zeros(g, device=card) for _ in range(3)]
    ref_ewma = [torch.zeros(g, device=card) for _ in range(3)]
    for counts in _slice_windows(rng, g, k, case):
        c = torch.from_numpy(counts).to(card)
        c_ref = c.clone()
        bits_only = kops.entropy_bits(c)
        out = kops.window_close(c, *ewma, 0.1, 4.0, 10)
        with kops.plain_versions():
            ref = kops.window_close(c_ref, *ref_ewma, 0.1, 4.0, 10)
        torch.cuda.synchronize()
        assert torch.equal(bits_only, ref[0])
        for x, y in zip([*out, *ewma], [*ref, *ref_ewma]):
            assert torch.equal(x, y)
        assert not c.any()
        assert not kops._close_scratch[kops._stream_key(card)][1].any()
    assert int(ewma[2][0]) == 12


def _readout_banks(rng):
    for g, m in ((1, 4096), (16, 4096), (4096, 64)):
        yield np.where(rng.random((g, m)) < 0.05, rng.integers(1, 6, (g, m)), 0).astype(np.uint32)
        yield rng.integers(1, 24, (g, m)).astype(np.uint32)
        yield np.zeros((g, m), np.uint32)


@pytest.mark.gpu
def test_hll_estimate_kernel_matches_plain_on_the_three_banks(card):
    """K17's estimate on the snapshot's three banks (the block and the warp
    shapes) in the linear-counting and raw regimes and all zero, within rtol
    1e-5."""
    rng = np.random.default_rng(120)
    for regs in _readout_banks(rng):
        r = from_numpy(regs, card)
        before = kops.launch_counts()["hll_estimate"]
        got = kops.hll_estimate(r)
        assert kops.launch_counts()["hll_estimate"] == before + 1
        with kops.plain_versions():
            want = kops.hll_estimate(r)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("g,m", [(3, 2), (33, 4), (100, 16), (9, 128), (7, 256), (5, 1024)])
def test_hll_estimate_kernel_matches_plain_at_other_widths(card, g, m):
    """K17's estimate at bank widths beside the deployed ones, on both sides
    of the lane-group job's range (4 <= m <= 128) and with a group count
    that leaves a pass part empty: sparse, full and all-zero registers,
    within rtol 1e-5."""
    rng = np.random.default_rng(g * m)
    for regs in (np.where(rng.random((g, m)) < 0.05, rng.integers(1, 6, (g, m)), 0),
                 rng.integers(1, 24, (g, m)), np.zeros((g, m))):
        r = from_numpy(regs.astype(np.uint32), card)
        got = kops.hll_estimate(r)
        with kops.plain_versions():
            want = kops.hll_estimate(r)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def _ct_table(rng, n, now):
    """keys and vals of an n-slot table: empty slots, TCP and non-TCP rows,
    idle times at every lifetime's edge and inside the skew slack."""
    from retina_tpu_torch.ops.conntrack import (
        CLOCK_SKEW_SLACK,
        CT_NON_TCP_LIFETIME,
        CT_TCP_LIFETIME,
    )

    keys = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    keys[rng.random(n) < 0.25] = 0
    idle = rng.choice(np.array([0, CT_NON_TCP_LIFETIME, CT_NON_TCP_LIFETIME + 1,
                                CT_TCP_LIFETIME, CT_TCP_LIFETIME + 1, 5000,
                                0xFFFF - CLOCK_SKEW_SLACK, 0xFFFF - CLOCK_SKEW_SLACK + 1]), n)
    meta = ((now - idle) & 0xFFFF) | (rng.integers(0, 1 << 14, n) << 16) \
        | ((rng.random(n) < 0.5).astype(np.int64) << 31)
    vals = rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32)
    vals[:, 0] = meta.astype(np.uint32)
    return keys, vals


@pytest.mark.gpu
def test_ct_active_kernel_is_exact_and_resets_its_ticket(card):
    """K17's live count over the deployed 2^18-slot table, exactly, at
    clocks across the 16-bit wrap; repeated calls on one stream reuse the
    ticket, which each call leaves at 0."""
    rng = np.random.default_rng(130)
    for now in (1_700_000_000, 0xFFFF, 0x10000 + 3, 0xFFFFFFFF):
        keys, vals = _ct_table(rng, 1 << 18, now)
        k, v = from_numpy(keys, card), from_numpy(vals, card)
        with kops.plain_versions():
            want = int(kops.ct_active(k, v, now))
        for _ in range(2):
            before = kops.launch_counts()["ct_active"]
            got = kops.ct_active(k, v, now)
            assert kops.launch_counts()["ct_active"] == before + 1
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and int(got) == want
    assert 0 < want < 1 << 18


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["deployed", "invertible", "zero"])
def test_readout_matches_snapshot_flat_dispatch_plain(card, which):
    """K17's one-launch readout against ``snapshot_flat_dispatch`` under
    ``plain_versions()`` on DEPLOYED_CONFIG's and INVERTIBLE_CONFIG's state
    after four batches of a 100k-flow stream and on a zero state (every
    HLL group counting linearly): one launch, the same layout, every int
    leaf bit for bit, the estimates within rtol 1e-5, at clocks across the
    16-bit wrap; the live count's ticket back at 0."""
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG, INVERTIBLE_CONFIG

    tel = Telemetry(INVERTIBLE_CONFIG if which == "invertible" else DEPLOYED_CONFIG,
                    device=card)
    state = tel.init_state()
    if which != "zero":
        gen = TrafficGen(n_flows=100_000, n_pods=2048, seed=5)
        ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, 2048)}, n_slots=1 << 16,
                                       device=card)
        for i in range(4):
            state, _ = tel.step(state, from_numpy(gen.batch(1 << 18), card), 1 << 18, 2 + i,
                                ident)
    for now in (5, 40, 0xFFFF + 3, 0xFFFFFFFF):
        before = kops.launch_counts()
        flat, layout = tel.snapshot_flat_dispatch(state, now)
        after = kops.launch_counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
            "snapshot_flat": 1}
        with kops.plain_versions():
            ref, ref_layout = tel.snapshot_flat_dispatch(state, now)
        torch.cuda.synchronize()
        assert layout == ref_layout and flat.shape == ref.shape
        got, want = (Telemetry.snapshot_flat_finish(x, layout) for x in (flat, ref))
        for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
            if a.dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=str(path))
            else:
                assert torch.equal(a, b), path
        assert not kops._ct_scratch[kops._stream_key(card)].any()
    if which != "zero":
        assert int(got["active_conns"]) > 0


def _leaves(d, prefix=()):
    out = []
    for k in sorted(d):
        out += _leaves(d[k], prefix + (k,)) if isinstance(d[k], dict) else [(prefix + (k,), d[k])]
    return out


@pytest.mark.gpu
def test_close_and_snapshot_on_card_launch_k16_and_k17(card):
    """end_window is one launch of K16 and no plain op; Telemetry.snapshot
    is one launch of K17's readout (the copies, the three banks' estimates
    and the live count) and no plain op; both equal the CPU run of the same
    steps."""
    from retina_tpu_torch.models import pipeline as tpipeline
    from retina_tpu_torch.parallel import telemetry as ttelemetry

    on_card, on_cpu = Telemetry(DEPLOYED_CUT, device=card), Telemetry(DEPLOYED_CUT, device="cpu")
    st_card = _run_steps(on_card.pipeline, card)
    st_cpu = _run_steps(on_cpu.pipeline, "cpu")
    plain, called = tpipeline.end_window_plain, []
    tpipeline.end_window_plain = lambda *a: called.append(a)
    readout_plain, ttelemetry.readout_plain = (ttelemetry.readout_plain,
                                               lambda *a: called.append(a))
    try:
        kops.reset_launch_counts()
        st_card, win = on_card.end_window(st_card)
        snap = on_card.snapshot(st_card, 41)
        counts = kops.launch_counts()
    finally:
        tpipeline.end_window_plain, ttelemetry.readout_plain = plain, readout_plain
    assert not called
    assert counts["window_close"] == 1 and counts["snapshot_flat"] == 1
    assert sum(counts.values()) == 2
    st_cpu, ref = on_cpu.end_window(st_cpu)
    ref_snap = on_cpu.snapshot(st_cpu, 41)
    torch.cuda.synchronize()
    torch.testing.assert_close(win["entropy_bits"].cpu(), ref["entropy_bits"], rtol=1e-5, atol=0)
    for name in ("hll_flows", "hll_src_per_reason", "hll_src_per_pod"):
        torch.testing.assert_close(snap[name].cpu(), ref_snap[name], rtol=1e-5, atol=0)
    assert int(snap["active_conns"]) == int(ref_snap["active_conns"]) > 0


@pytest.mark.gpu
def test_debug_profile_on_the_card_traces_k1(card, tmp_path):
    """``POST /debug/profile`` on an agent whose engine runs on the card: the
    session is a torch.profiler session with the CUDA activity, and its
    exported trace holds K1's kernel (``step_rows_kernel``), launched by the
    agent's own threads while records go through the sink."""
    import json
    import threading
    import time
    import urllib.request

    from retina_tpu_torch.e2e.steps import small_agent_config
    from retina_tpu_torch.daemon import Daemon
    from retina_tpu_torch.obs.debug import TRACE_FILE

    cfg = small_agent_config(profile_artifact_dir=str(tmp_path / "prof"))
    d = Daemon(cfg)
    assert d.cm.engine.device.type == "cuda"
    stop = threading.Event()
    t = threading.Thread(target=d.start, args=(stop,), daemon=True)
    t.start()
    gen = TrafficGen(n_flows=2000, n_pods=64, seed=5)
    try:
        deadline = time.monotonic() + 300
        port = None
        while port is None and time.monotonic() < deadline:
            if d.cm.server is not None and d.cm.engine.started.is_set():
                with contextlib.suppress(AssertionError):
                    port = d.cm.server.port
            time.sleep(0.05)
        assert port is not None, "the agent did not come up"
        feeding = threading.Event()

        def feed():
            while not feeding.is_set():
                d.cm.engine.sink.write_records(gen.batch(1 << 10), "test")
                time.sleep(0.02)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/debug/profile?seconds=1",
                                     method="POST", data=b"")
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200
            doc = json.loads(r.read())
        feeding.set()
        feeder.join(10)
    finally:
        stop.set()
        t.join(60)
    assert doc["torch_trace"] is True
    with open(os.path.join(doc["artifact_dir"], TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("step_rows_kernel" in k for k in kernels), sorted(set(kernels))[:30]
