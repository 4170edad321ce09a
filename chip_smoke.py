#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``retina_tpu_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card at the
shapes of the main path, then drives the main path of one node agent
(Telemetry step -> end_window -> snapshot -> host top-k) at the deployed
agent's shapes: 3 windows x 8 steps over two 2^21-event batches of a
1M-flow Zipf stream. The state after the run must equal the same run
through the plain versions on the card.

Comparison rules: integer state is compared exactly (the top-k winner and
the latency slot winner are both fixed to "last row in batch order" in the
kernels and the plain versions alike); float32 entropy counts of integer
weights are exact below 2^24 per bucket and compared exactly there, within
a relative 2^-22 above; derived floats (entropy bits, HLL estimates,
EWMA state, z-scores) within a relative 1e-5, since reductions may group
differently.

Prints the card's name and power limit, a JSON line of per-kernel results
and, as the last line, {"ok": true, "device": {...}}. Exits non-zero, with
no result line, if there is no card or any check fails.
"""

from __future__ import annotations

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


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


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
    from retina_tpu_torch.ops.hashing import hash_cols, reduce_range
    from retina_tpu_torch.parallel.telemetry import Telemetry, topk_from_snapshot
    from retina_tpu_torch.convert import tensor_leaves
    from retina_tpu_torch.u32 import from_numpy, to_numpy, widen

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
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

    def k1(state, r):
        return kops.step_rows(r, BATCH, 1, ident.table, ident.seed, filt.table, filt.seed,
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
    for a, b, n in zip(tensor_leaves(pair[0]), tensor_leaves(pair[1]), range(10)):
        if a.dtype == torch.int32:
            equal_int(a, b, f"K1 state leaf {n}")
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
    active = int((scratch["ent_w"] != 0).sum())
    report("entropy_update", "retina_tpu_torch/kernels/csrc/entropy_update.cu",
           "retina_tpu/ops/entropy.py:54", ms, plain_ms,
           BATCH * 4 * 4 + 2 * 4 * 3 * k, active * (3 * HASH_OPS + 3), lib_ms, err)

    # -- main path: step -> end_window -> snapshot -> top-k, twice -----------
    def run_main(plain: bool):
        state = tel.init_state()
        snaps, windows, step_s = [], [], 0.0
        for w in range(WINDOWS):
            for s in range(STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if plain:
                    with kops.plain_versions():
                        state, summ = tel.step(state, recs[(w * STEPS + s) % 2], BATCH,
                                               2 + w, ident)
                else:
                    state, summ = tel.step(state, recs[(w * STEPS + s) % 2], BATCH,
                                           2 + w, ident)
                torch.cuda.synchronize()
                step_s += time.perf_counter() - t
                check(int(summ["events"]) == BATCH, "step summary events")
            state, out = tel.end_window(state)
            windows.append(out)
            snaps.append(tel.snapshot(state, 2 + w))
        return state, snaps, windows, step_s

    kops.reset_launch_counts()
    state, snaps, windows, step_s = run_main(plain=False)
    launches = kops.launch_counts()
    print(f"main path launches: {launches}", flush=True)
    for r in results:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"{r['name']} was not launched on the main path")
    ref_state, ref_snaps, ref_windows, plain_s = run_main(plain=True)
    check(kops.launch_counts() == launches, "the plain run launched kernels")

    for n, (a, b) in enumerate(zip(tensor_leaves(state), tensor_leaves(ref_state))):
        if a.dtype == torch.int32:
            equal_int(a, b, f"main path state leaf {n}")
        elif n == 20:  # entropy counts (reset at the last window close)
            close_counts(a, b, "main path entropy counts")
        else:
            close_float(a, b, f"main path float leaf {n}")
    for w in range(WINDOWS):
        for key in ("entropy_bits", "zscore"):
            close_float(windows[w][key], ref_windows[w][key], f"window {w} {key}")
            check(bool(torch.isfinite(windows[w][key]).all()), f"window {w} {key} finite")
        equal_int(windows[w]["anomaly"], ref_windows[w]["anomaly"], f"window {w} anomaly")
        for key, v in snaps[w].items():
            rv = ref_snaps[w][key]
            if isinstance(v, dict):
                for kk in v:
                    equal_int(v[kk], rv[kk], f"snapshot {w} {key}.{kk}")
            elif v.dtype == torch.float32:
                check(bool(torch.isfinite(v).all()), f"snapshot {w} {key} finite")
                close_float(v, rv, f"snapshot {w} {key}")
            else:
                equal_int(v, rv, f"snapshot {w} {key}")

    fed = sum(int(host[(i % 2)][:, F.PACKETS].astype(np.uint64).sum())
              for i in range(WINDOWS * STEPS)) & 0xFFFFFFFF
    check(int(to_numpy(state.totals)[0]) == fed, "totals[0] != packets fed")
    keys, _ = topk_from_snapshot(snaps[-1], "flow_hh", 256)
    reported = {tuple(int(x) for x in kk) for kk in keys}
    true_ids = gen.true_top_k(50)
    hits = sum(
        (int(gen.src_ip[f]), int(gen.dst_ip[f]),
         int((gen.sport[f] << np.uint32(16)) | gen.dport[f]), int(gen.proto[f])) in reported
        for f in true_ids
    )
    recall = hits / 50
    n_steps = WINDOWS * STEPS
    print(f"main path: {n_steps} steps, {n_steps * BATCH / step_s:.0f} events/s "
          f"({step_s / n_steps * 1e3:.3f} ms/step; plain {plain_s / n_steps * 1e3:.3f} "
          f"ms/step), flow recall@50 {recall:.2f}, totals[0] {fed}", flush=True)
    check(recall >= 0.8, f"flow recall@50 {recall} below 0.8")

    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
