#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's six CUDA kernels from ``retina_tpu_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card at the
shapes of the main path, then drives the port's paths through the entry
points a node agent calls (Telemetry step -> end_window -> snapshot ->
host top-k), each over two 2^21-event batches of a 1M-flow Zipf stream:

- the main path: the deployed agent (DEPLOYED_CONFIG: conntrack on, low
  aggregation), 3 windows x 8 steps;
- the invertible path: INVERTIBLE_CONFIG, 1 window x 8 steps, with
  inv_decode at the window close;
- the earlier paths: PipelineConfig() (bench.py's production shapes:
  conntrack on, high aggregation) and NO_CONNTRACK_CONFIG, 1 window x 8
  steps each.

Each path's launch counts are set to 0 just before it and read just after,
and every kernel of the path must have launched. The state, step summaries,
window outputs, snapshots and decodes after each path must equal the same
run through the plain versions on the card.

Comparison rules: integer state and outputs are compared exactly (the
top-k winner and the latency slot winner are "last row in batch order",
the conntrack report row is the connection's last row and a shared slot
goes to the largest fingerprint, in the kernels and the plain versions
alike); float32 entropy counts of integer weights are exact below 2^24
per bucket and compared exactly there, within a relative 2^-22 above;
derived floats (entropy bits, HLL estimates, EWMA state, z-scores) within
a relative 1e-5, since reductions may group differently.

Prints the card's name and power limit, a JSON line of per-kernel results
and, as the last line, {"ok": true, "device": {...}}. Exits non-zero, with
no result line, if there is no card or any check fails.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

BATCH = 1 << 21
N_FLOWS, N_PODS_GEN, SEED = 1_000_000, 2048, 42
WINDOWS, STEPS = 3, 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
OPS_PER_S = 67e12  # 32-bit non-tensor rate of the H100 SXM
HASH_OPS = 14  # integer ops to fold one u32 column into a hash
# now_s of the K5 check: new, within the interval, interval up, UDP
# expiry, TCP expiry, the 16-bit wrap, and a clock 10 s back.
CT_CLOCK = (100, 101, 131, 200, 600, 65_700, 65_690)


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def named_leaves(obj, prefix: str = ""):
    """(name, tensor) of every state tensor, in the reference's leaf order."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)]
    out = []
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out += named_leaves(getattr(obj, f.name), f"{prefix}.{f.name}".lstrip("."))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip
    from retina_tpu_torch.kernels import build
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.identity import IdentityMap
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG as CFG
    from retina_tpu_torch.models.pipeline import (
        INVERTIBLE_CONFIG,
        NO_CONNTRACK_CONFIG,
        PipelineConfig,
    )
    from retina_tpu_torch.ops.conntrack import ConntrackTable
    from retina_tpu_torch.ops.hashing import hash_cols, reduce_range
    from retina_tpu_torch.ops.invertible import InvertibleSketch, bits, indices
    from retina_tpu_torch.parallel.telemetry import Telemetry, topk_from_snapshot
    from retina_tpu_torch.u32 import from_numpy, narrow, to_numpy, widen

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"kernel build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- traffic and identity, as bench.py's full-scale device phase --
    gen = TrafficGen(n_flows=N_FLOWS, n_pods=N_PODS_GEN, seed=SEED)
    host = [gen.batch(BATCH) for _ in range(2)]
    recs = [from_numpy(b, dev) for b in host]
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, N_PODS_GEN)},
                                   n_slots=1 << 16, device=dev)
    tel = Telemetry(CFG, device=dev)
    print(f"traffic: {len(host)} x {BATCH} events, {N_FLOWS} flows", flush=True)

    def time_ms(fn, reps: int = 10) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    def equal_int(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
        check(a.shape == b.shape and bool(torch.equal(a, b)),
              f"{what}: {int((a != b).sum()) if a.shape == b.shape else 'shape'} differ")

    def close_counts(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
        err = (a - b).abs()
        exact = torch.maximum(a.abs(), b.abs()) < 2 ** 24
        check(bool((err[exact] == 0).all()), f"{what}: counts below 2^24 differ")
        check(bool((err <= 2.0 ** -22 * b.abs()).all()), f"{what}: counts above 2^24 differ")
        return float(err.max()) if err.numel() else 0.0

    def close_float(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6)), f"{what}: floats differ")

    def equal_any(a, b, what: str) -> None:
        """Integer and bool tensors exactly, float32 within the float rule."""
        if isinstance(a, dict):
            check(set(a) == set(b), f"{what}: keys differ")
            for k in a:
                equal_any(a[k], b[k], f"{what}.{k}")
        elif a.dtype == torch.float32:
            check(bool(torch.isfinite(a).all()), f"{what} finite")
            close_float(a, b, what)
        else:
            equal_int(a, b, what)

    results = []

    def report(name, source, replaces, ms, plain_ms, nbytes, ops, library_ms, err):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / OPS_PER_S * 1e3
        results.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        })
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.4f} ms, library {library_ms}, max_abs_err {err}",
              flush=True)

    # -- K1: step_rows at the deployed shapes ---------------------------
    pair = [tel.init_state(), tel.init_state()]
    filt = IdentityMap.zeros(1 << 4, seed=99, device=dev)  # Telemetry's empty filter map

    def k1(state, r, n_valid=BATCH):
        return kops.step_rows(r, n_valid, 1, ident.table, ident.seed, filt.table, filt.seed,
                              state.pod_forward, state.pod_drop, state.pod_tcpflags,
                              state.pod_dns, state.pod_retrans, state.node_counters,
                              state.totals, CFG)

    outs = []
    for i, st in enumerate(pair):
        if i == 0:
            outs.append([k1(st, r) for r in recs])
        else:
            with kops.plain_versions():
                outs.append([k1(st, r) for r in recs])
    for j in range(2):
        equal_int(outs[0][j][0], outs[1][j][0], f"K1 scratch batch {j}")
        equal_int(outs[0][j][1], outs[1][j][1], f"K1 sums batch {j}")
    for a, b, n in zip(named_leaves(pair[0]), named_leaves(pair[1]), range(10)):
        if a[1].dtype == torch.int32:
            equal_int(a[1], b[1], f"K1 state {a[0]}")
    scratch = dict(zip(kops.SCRATCH, outs[0][0][0]))
    st = tel.init_state()
    ms = time_ms(lambda: k1(st, recs[0]))
    with kops.plain_versions():
        plain_ms = time_ms(lambda: k1(st, recs[0]))
    P, R, Q = CFG.n_pods, CFG.n_drop_reasons, CFG.n_dns_qtypes
    rect_bytes = 4 * (P * 4 + P * R * 2 + P * 8 + P * Q * 2 + P)
    report("step_rows", "retina_tpu_torch/kernels/csrc/step_rows.cu",
           "retina_tpu/models/pipeline.py:326", ms, plain_ms,
           BATCH * 64 + (1 << 16) * 8 + 2 * rect_bytes + len(kops.SCRATCH) * BATCH * 4,
           BATCH * (4 * HASH_OPS + 60), None, 0.0)

    # -- K2: the three heavy-hitter instances ------------------------------
    src, dst = recs[0][:, F.SRC_IP], recs[0][:, F.DST_IP]
    instances = [
        ("flow_hh", [src, dst, recs[0][:, F.PORTS], scratch["proto"]], scratch["flow_w"]),
        ("svc_hh", [scratch["src_pod"], scratch["dst_pod"]], scratch["svc_w"]),
        ("dns_hh", [recs[0][:, F.DNS_QHASH]], scratch["dns_w"]),
    ]
    pair = [tel.init_state(), tel.init_state()]
    for i, st in enumerate(pair):
        for name, cols, w in instances:
            for _ in range(2):  # the second offer meets counts already set
                hh = getattr(st, name)
                if i == 0:
                    hh.update(cols, w)
                else:
                    with kops.plain_versions():
                        hh.update(cols, w)
    for name, _, _ in instances:
        a, b = getattr(pair[0], name), getattr(pair[1], name)
        equal_int(a.cms.table, b.cms.table, f"K2 {name} cms")
        equal_int(a.table.counts, b.table.counts, f"K2 {name} counts")
        equal_int(a.table.key_rows, b.table.key_rows, f"K2 {name} key rows")
    st = tel.init_state()

    def k2_all():
        for name, cols, w in instances:
            getattr(st, name).update(cols, w)

    ms = time_ms(k2_all)
    with kops.plain_versions():
        plain_ms = time_ms(k2_all)
    nbytes = ops = 0
    d, wd, s = CFG.cms_depth, CFG.cms_width, CFG.topk_slots
    for _, cols, w in instances:
        c = len(cols)
        active = int((w != 0).sum())
        nbytes += BATCH * (4 * c + 4) + 2 * 4 * (d * wd + s * (c + 1))
        ops += active * (2 * d * c * HASH_OPS + c * HASH_OPS + 4 * d)
    report("hh_update", "retina_tpu_torch/kernels/csrc/hh_update.cu",
           "retina_tpu/ops/topk.py:177", ms, plain_ms, nbytes, ops, None, 0.0)

    # -- K3: the three HLL banks -----------------------------------------
    five = instances[0][1]
    banks = [
        ("hll_flows", five, None, scratch["mask"]),
        ("hll_src_per_reason", [src], scratch["reason"], scratch["is_drop"]),
        ("hll_src_per_pod", [src], scratch["pod_grp"], scratch["pod_mask"]),
    ]
    pair = [tel.init_state(), tel.init_state()]
    for i, st in enumerate(pair):
        for name, cols, grp, msk in banks:
            if i == 0:
                getattr(st, name).update(cols, grp, msk)
            else:
                with kops.plain_versions():
                    getattr(st, name).update(cols, grp, msk)
    for name, _, _, _ in banks:
        equal_int(getattr(pair[0], name).registers, getattr(pair[1], name).registers,
                  f"K3 {name}")
    st = tel.init_state()

    def k3_all():
        for name, cols, grp, msk in banks:
            getattr(st, name).update(cols, grp, msk)

    ms = time_ms(k3_all)
    with kops.plain_versions():
        plain_ms = time_ms(k3_all)
    # Library yardstick: one scatter_reduce_(amax) over the three banks laid
    # end to end, with the indices and ranks precomputed (no hashing).
    flat, vals, off, nbytes, ops = [], [], 0, 0, 0
    for name, cols, grp, msk in banks:
        hll = getattr(st, name)
        g, m = hll.registers.shape
        p = m.bit_length() - 1
        h = hash_cols(cols, 0xC0FFEE + hll.seed)
        rest = h >> p
        rho = (32 - p) - (torch.frexp(rest.double()).exponent.long() - 1)
        gi = widen(grp) if grp is not None else 0
        on = msk != 0
        flat.append(torch.where(on, off + gi * m + reduce_range(h, m), off))
        vals.append(torch.where(on, rho, 0).int())
        off += g * m
        nbytes += BATCH * (4 * len(cols) + (8 if grp is not None else 4)) + 2 * 4 * g * m
        ops += int(on.sum()) * (len(cols) * HASH_OPS + 10)
    flat_i, vals_i = torch.cat(flat), torch.cat(vals)
    regs = torch.zeros(off, dtype=torch.int32, device=dev)
    lib_ms = time_ms(lambda: regs.scatter_reduce_(0, flat_i, vals_i, "amax"))
    del flat, vals, flat_i, vals_i, regs
    report("hll_update", "retina_tpu_torch/kernels/csrc/hll_update.cu",
           "retina_tpu/ops/hyperloglog.py:72", ms, plain_ms, nbytes, ops, lib_ms, 0.0)

    # -- K4: entropy histograms -------------------------------------------
    ent_cols = [src, dst, scratch["dport"]]
    pair = [tel.init_state(), tel.init_state()]
    pair[0].entropy.update(ent_cols, scratch["ent_w"])
    with kops.plain_versions():
        pair[1].entropy.update(ent_cols, scratch["ent_w"])
    err = close_counts(pair[0].entropy.counts, pair[1].entropy.counts, "K4 counts")
    st = tel.init_state()
    ms = time_ms(lambda: st.entropy.update(ent_cols, scratch["ent_w"]))
    with kops.plain_versions():
        plain_ms = time_ms(lambda: st.entropy.update(ent_cols, scratch["ent_w"]))
    k = CFG.entropy_buckets
    idx = torch.cat([g * k + reduce_range(hash_cols([c], 0xE17209 + st.entropy.seed), k)
                     for g, c in enumerate(ent_cols)])
    wf = widen(scratch["ent_w"]).float().repeat(3)
    hist = torch.zeros(3 * k, dtype=torch.float32, device=dev)
    lib_ms = time_ms(lambda: hist.index_add_(0, idx, wf))
    del idx, wf
    active = int((scratch["ent_w"] != 0).sum())
    report("entropy_update", "retina_tpu_torch/kernels/csrc/entropy_update.cu",
           "retina_tpu/ops/entropy.py:54", ms, plain_ms,
           BATCH * 4 * 4 + 2 * 4 * 3 * k, active * (3 * HASH_OPS + 3), lib_ms, err)

    # -- K5: conntrack at 2^21 rows and 2^18 slots ------------------------
    rng = np.random.default_rng(SEED)
    partial = recs[1].clone()
    n_partial = BATCH - BATCH // 8
    partial[n_partial:] = from_numpy(
        rng.integers(0, 1 << 32, (BATCH - n_partial, 16), dtype=np.uint64).astype(np.uint32),
        dev)

    def ct_inputs(r, n_valid=BATCH):
        """process_lanes' arguments for one batch, from K1's lanes as the
        step passes them (now_s goes in the middle)."""
        sc = dict(zip(kops.SCRATCH, k1(tel.init_state(), r, n_valid)[0]))
        head = [r[:, F.SRC_IP], r[:, F.DST_IP], r[:, F.PORTS], sc["proto"],
                (r[:, F.META] >> 16) & 0xFF]
        return head, [sc["bytes"], sc["mask"], sc["ent_w"]]

    # Reply rows: a third of one batch flipped to the opposite direction.
    flipped = recs[0].clone()
    rev = flipped[::3]
    rev[:, F.SRC_IP], rev[:, F.DST_IP] = recs[0][::3, F.DST_IP], recs[0][::3, F.SRC_IP]
    p = recs[0][::3, F.PORTS]
    rev[:, F.PORTS] = ((p & 0xFFFF) << 16) | ((p >> 16) & 0xFFFF)
    batches = {1: (partial, n_partial), 3: (flipped,), 5: (flipped,)}
    ct_calls = [(now, *ct_inputs(*batches.get(i, (recs[i % 2],))))
                for i, now in enumerate(CT_CLOCK)]
    tables = [ConntrackTable.zeros(CFG.conntrack_slots, seed=8, device=dev) for _ in range(2)]
    rep_low = None
    for now, head, tail in ct_calls:
        out = tables[0].process_lanes(*head, now, *tail)
        with kops.plain_versions():
            ref = tables[1].process_lanes(*head, now, *tail)
        equal_int(out, ref, f"K5 lanes at now={now}")
        equal_int(tables[0].keys, tables[1].keys, f"K5 keys at now={now}")
        equal_int(tables[0].vals, tables[1].vals, f"K5 vals at now={now}")
        check(int(out[0].sum()) > 0, f"K5 no reports at now={now}")
        print(f"K5 now={now}: {int(out[0].sum())} reports, {int(out[1].sum())} replies",
              flush=True)
        if now == 131:
            rep_low = out[2].clone()  # flow_w of a real step at low aggregation
    now, head, tail = ct_calls[2]
    ms = time_ms(lambda: tables[0].process_lanes(*head, now, *tail))
    with kops.plain_versions():
        plain_ms = time_ms(lambda: tables[1].process_lanes(*head, now, *tail))
    fp = widen(torch.randint(-(1 << 31), 1 << 31, (BATCH,), dtype=torch.int32, device=dev))
    sort_ms = time_ms(lambda: torch.sort(fp, stable=True))
    del fp
    n_masked = int((tail[1] != 0).sum())
    slot_bytes = 24 * CFG.conntrack_slots
    report("conntrack", "retina_tpu_torch/kernels/csrc/conntrack.cu",
           "retina_tpu/ops/conntrack.py:123", ms, plain_ms,
           BATCH * (8 * 4 + 4 * 4) + 2 * slot_bytes, n_masked * (8 * HASH_OPS + 40), None, 0.0)
    print(f"K5 note: torch.sort (stable) of {BATCH} int64 keys {sort_ms:.4f} ms, the "
          f"reference design's sort alone", flush=True)

    # -- K6: the invertible sketch at INVERTIBLE_CONFIG's shapes ----------
    icfg = INVERTIBLE_CONFIG
    key5 = [recs[0][:, F.SRC_IP], recs[0][:, F.DST_IP], recs[0][:, F.PORTS], scratch["proto"]]
    for label, w in (("low", rep_low), ("high", scratch["flow_w"])):
        invs = [InvertibleSketch.zeros(icfg.inv_depth, icfg.inv_width, 4, seed=9, device=dev)
                for _ in range(2)]
        for _ in range(2):
            invs[0].update(key5, w)
            with kops.plain_versions():
                invs[1].update(key5, w)
        equal_int(invs[0].planes, invs[1].planes, f"K6 planes ({label})")
        equal_int(invs[0].weights, invs[1].weights, f"K6 weights ({label})")
        dec = [inv.decode() for inv in invs]
        for j in range(4):
            equal_int(dec[0][0][j], dec[1][0][j], f"K6 decode col {j} ({label})")
        equal_int(dec[0][1], dec[1][1], f"K6 decode weight ({label})")
        equal_int(dec[0][2], dec[1][2], f"K6 decode ok ({label})")
        print(f"K6 {label}: {int((w != 0).sum())} weighted rows, "
              f"{int(dec[0][2].sum())} buckets decode", flush=True)
    inv = InvertibleSketch.zeros(icfg.inv_depth, icfg.inv_width, 4, seed=9, device=dev)
    ms = time_ms(lambda: inv.update(key5, rep_low))
    with kops.plain_versions():
        plain_ms = time_ms(lambda: inv.update(key5, rep_low))
    d, w, nb = inv.planes.shape
    flat_idx = (indices(d, w, 9, key5) + (torch.arange(d, device=dev) * w)[:, None]).reshape(-1)
    rows = narrow(bits(key5, 9) * widen(rep_low)[:, None]).repeat(d, 1)
    lib_planes = torch.zeros((d * w, nb), dtype=torch.int32, device=dev)
    lib_ms = time_ms(lambda: lib_planes.index_add_(0, flat_idx, rows))
    del flat_idx, rows, lib_planes
    active = int((rep_low != 0).sum())
    report("inv_update", "retina_tpu_torch/kernels/csrc/inv_update.cu",
           "retina_tpu/ops/invertible.py:136", ms, plain_ms,
           BATCH * 4 + active * 16 + 2 * 4 * d * w * (nb + 1),
           active * ((d + 1) * 4 * HASH_OPS + d * nb), lib_ms, 0.0)

    # -- the paths: step -> end_window -> snapshot (-> inv_decode) ---------
    def run_path(t, windows, steps, plain):
        state = t.init_state()
        snaps, wins, decs, step_s, n_reports = [], [], [], 0.0, 0
        for w in range(windows):
            for s in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if plain:
                    with kops.plain_versions():
                        state, summ = t.step(state, recs[(w * steps + s) % 2], BATCH, 2 + w,
                                             ident)
                else:
                    state, summ = t.step(state, recs[(w * steps + s) % 2], BATCH, 2 + w,
                                         ident)
                torch.cuda.synchronize()
                step_s += time.perf_counter() - t0
                check(int(summ["events"]) == BATCH, "step summary events")
                check(int(summ["ct_reports"]) == int(summ["report_mask"].sum()),
                      "step summary ct_reports")
                n_reports += int(summ["ct_reports"])
                if w == 0 and s == 0:
                    first = summ
            if t.pipeline.config.enable_invertible:
                decs.append(t.inv_decode(state))
            state, out = t.end_window(state)
            wins.append(out)
            snaps.append(t.snapshot(state, 2 + w))
        return dict(state=state, snaps=snaps, wins=wins, decs=decs, step_s=step_s,
                    n_reports=n_reports, first=first)

    def compare_runs(a, b, label):
        for (name, x), (_, y) in zip(named_leaves(a["state"]), named_leaves(b["state"])):
            if x.dtype == torch.int32:
                equal_int(x, y, f"{label} state {name}")
            elif name == "entropy.counts":
                close_counts(x, y, f"{label} entropy counts")
            else:
                close_float(x, y, f"{label} state {name}")
        equal_any(a["first"], b["first"], f"{label} first step summary")
        for w in range(len(a["wins"])):
            equal_any(a["wins"][w], b["wins"][w], f"{label} window {w}")
            equal_any(a["snaps"][w], b["snaps"][w], f"{label} snapshot {w}")
        for w in range(len(a["decs"])):
            equal_any(a["decs"][w], b["decs"][w], f"{label} inv_decode {w}")

    true_keys = [
        (int(gen.src_ip[f]), int(gen.dst_ip[f]),
         int((gen.sport[f] << np.uint32(16)) | gen.dport[f]), int(gen.proto[f]))
        for f in gen.true_top_k(50)
    ]

    def recall(found) -> float:
        return sum(k in found for k in true_keys) / 50

    def path(name, cfg, windows, steps, kernels):
        t = Telemetry(cfg, device=dev)
        kops.reset_launch_counts()
        run = run_path(t, windows, steps, plain=False)
        launches = kops.launch_counts()
        print(f"{name} launches: {launches}", flush=True)
        for k in kernels:
            check(launches[k] > 0, f"{k} was not launched on the {name}")
        ref = run_path(t, windows, steps, plain=True)
        check(kops.launch_counts() == launches, f"the plain {name} run launched kernels")
        compare_runs(run, ref, name)
        state = run["state"]
        fed = sum(int(host[i % 2][:, F.PACKETS].astype(np.uint64).sum())
                  for i in range(windows * steps)) & 0xFFFFFFFF
        check(int(to_numpy(state.totals)[0]) == fed, f"{name}: totals[0] != packets fed")
        check(int(to_numpy(state.totals)[6]) == run["n_reports"] & 0xFFFFFFFF,
              f"{name}: totals[6] != report rows of the summaries")
        keys, _ = topk_from_snapshot(run["snaps"][-1], "flow_hh", 256)
        rec = recall({tuple(int(x) for x in kk) for kk in keys})
        n = windows * steps
        print(f"{name}: {n} steps, {n * BATCH / run['step_s']:.0f} events/s "
              f"({run['step_s'] / n * 1e3:.3f} ms/step; plain {ref['step_s'] / n * 1e3:.3f} "
              f"ms/step), flow recall@50 {rec:.2f}, totals[0] {fed}, "
              f"reports {run['n_reports']}", flush=True)
        check(rec >= 0.8, f"{name}: flow recall@50 {rec} below 0.8")
        return run, launches

    k1_k5 = ["step_rows", "hh_update", "hll_update", "entropy_update", "conntrack"]
    run, launches = path("main path", CFG, WINDOWS, STEPS, k1_k5)
    cms_rows = widen(run["state"].flow_hh.cms.table).sum(dim=1) & 0xFFFFFFFF
    ct_lo = int(to_numpy(run["state"].ct_totals)[0])
    check(bool((cms_rows == ct_lo).all()), "main path: a flow_hh CMS row != ct_totals[0]")
    for r in results:
        r["launches"] = launches[r["name"]]

    run, launches = path("invertible path", INVERTIBLE_CONFIG, 1, STEPS,
                         k1_k5 + ["inv_update"])
    dec = run["decs"][-1]
    ok = dec["ok"]
    found = {tuple(int(x) for x in row) for row in to_numpy(dec["keys"][ok])}
    print(f"invertible path: {int(ok.sum())} verified buckets, {len(found)} keys, recall of "
          f"the true top-50 {recall(found):.2f}", flush=True)
    for r in results:
        if r["name"] == "inv_update":
            r["launches"] = launches["inv_update"]

    path("production path", PipelineConfig(), 1, STEPS, k1_k5)
    path("no-conntrack path", NO_CONNTRACK_CONFIG, 1, STEPS, k1_k5[:4])

    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
