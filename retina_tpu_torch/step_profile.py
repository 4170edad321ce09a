"""Where one step of the PyTorch/CUDA port spends its time on the card.

    python3 -m retina_tpu_torch.step_profile [--steps N]
    python3 -m retina_tpu_torch.step_profile --feed

Runs the port's main path (Telemetry.step at DEPLOYED_CONFIG, the deployed
agent: conntrack on, low aggregation; two 2^21-event batches of a 1M-flow
Zipf stream, as chip_smoke.py) and reports, after a warm-up:

- steady-state step throughput with no synchronisation between steps
  (the host enqueues, the card runs), from the host clock;
- the device time of each kernel and torch op over the profiled steps,
  from torch.profiler, with the device's busy and idle share of the
  wall time, and the launches a step (the kernels, copies and fills the
  profiler saw on the card, divided by the steps);
- the time of the apiserver latency match alone, its kernel K14 and its
  plain version (torch ops), from CUDA events.

With ``--feed`` it profiles the feed path instead: ``SketchEngine.flush``
at ``Config()`` (the deployed agent) over quanta of 256 blocks of 2^13
events of the same stream, as chip_smoke.py's ingest path 1, and reports
the wall time with and without the profiler and the device's busy share
of each (the device time of every kernel, memcpy and memset, from
torch.profiler), with the device time by kernel.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

BATCH = 1 << 21
QUANTUM, BLOCK = 1 << 21, 1 << 13


def device_rows(prof) -> tuple[list, list]:
    """(kernel rows, torch-op rows) of a profile as (device us, calls, name),
    largest first. A device row is one kernel, memcpy or memset; an aten row
    repeats the device time of the kernels it launched, so only device rows
    add up to the busy time."""
    from torch.autograd import DeviceType

    kernels, ops = [], []
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if dev_us <= 0:
            continue
        (kernels if e.device_type == DeviceType.CUDA else ops).append(
            (dev_us, e.count, e.key))
    return sorted(kernels, reverse=True), sorted(ops, reverse=True)


def feed_profile(dev, n_quanta: int) -> dict:
    """Profile ``SketchEngine.flush`` at ``Config()``: a warm-up quantum,
    then ``n_quanta`` unprofiled and the same ``n_quanta`` profiled."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip

    gen = TrafficGen(n_flows=1_000_000, n_pods=2048, seed=42)
    quanta = [np.split(gen.batch(QUANTUM), QUANTUM // BLOCK) for _ in range(3)]
    eng = SketchEngine(Config(), device=dev)
    eng.update_identities({pod_ip(i): i for i in range(1, 2048)})
    eng.flush(quanta[0], 100)  # builds the kernels and the native library
    torch.cuda.synchronize()

    def run(now0: int) -> float:
        t = time.perf_counter()
        for i in range(n_quanta):
            eng.flush(quanta[(i + 1) % 3], now0 + i)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    eng.stages.reset()
    wall = run(200)
    st = eng.stages.seconds()
    span = sum(st[k] for k in eng.stages.CARD)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_p = run(300)
    kernels, _ = device_rows(prof)
    busy_us = sum(r[0] for r in kernels)
    print(f"feed path, Config(): {n_quanta} quanta of {QUANTUM} events, {eng.counts.steps} "
          f"steps so far; wall {wall / n_quanta * 1e3:.3f} ms/quantum unprofiled, "
          f"{wall_p / n_quanta * 1e3:.3f} profiled; device busy "
          f"{busy_us / 1e3 / n_quanta:.3f} ms/quantum: {busy_us / 1e4 / wall:.1f}% of the "
          f"unprofiled wall ({busy_us / 1e4 / wall_p:.1f}% of the profiled); the card "
          f"stages' CUDA-event span {span / n_quanta * 1e3:.3f} ms/quantum unprofiled "
          f"({span / wall:.1%})")
    print("device time per quantum by kernel (ms, calls per quantum, name):")
    for dev_us, count, key in kernels[:24]:
        print(f"  {dev_us / 1e3 / n_quanta:9.4f}  {count / n_quanta:7.1f}  {key[:90]}")
    return {
        "ms_per_quantum": wall / n_quanta * 1e3,
        "device_busy_ms_per_quantum": busy_us / 1e3 / n_quanta,
        "device_busy_share": busy_us / 1e6 / wall,
        "card_span_share": span / wall,
        "device": torch.cuda.get_device_name(0),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--feed", action="store_true",
                    help="profile the feed path (SketchEngine.flush) instead of the step")
    ap.add_argument("--quanta", type=int, default=4, help="quanta to profile with --feed")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip
    from retina_tpu_torch.models.identity import IdentityMap
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG
    from retina_tpu_torch.parallel.telemetry import Telemetry
    from retina_tpu_torch.u32 import from_numpy

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    if args.feed:
        print(json.dumps(feed_profile(dev, args.quanta)))
        return 0
    gen = TrafficGen(n_flows=1_000_000, n_pods=2048, seed=42)
    recs = [from_numpy(gen.batch(BATCH), dev) for _ in range(2)]
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, 2048)}, n_slots=1 << 16,
                                   device=dev)
    tel = Telemetry(DEPLOYED_CONFIG, device=dev)
    state = tel.init_state()

    def steps(n):
        nonlocal state
        for i in range(n):
            state, _ = tel.step(state, recs[i % 2], BATCH, 2, ident)

    steps(4)  # builds the kernels, warms the allocator
    torch.cuda.synchronize()
    t = time.perf_counter()
    steps(args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"steady state: {args.steps} steps, {wall / args.steps * 1e3:.3f} ms/step, "
          f"{args.steps * BATCH / wall:.0f} events/s (no sync between steps)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        steps(args.steps)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t
    kernels, ops = device_rows(prof)
    busy_us = sum(r[0] for r in kernels)
    launches = sum(r[1] for r in kernels) / args.steps
    print(f"profiled: {args.steps} steps in {wall_p * 1e3:.3f} ms wall; device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e4 / wall_p:.1f}%), idle "
          f"{100 - busy_us / 1e4 / wall_p:.1f}%; {launches:.1f} launches a step on the card "
          f"(kernels, copies and fills)")
    for title, rows in (("kernels", kernels), ("torch ops", ops)):
        print(f"device time per step by {title} (ms, calls per step, name):")
        for dev_us, count, key in rows[:24]:
            print(f"  {dev_us / 1e3 / args.steps:9.4f}  {count / args.steps:6.1f}  {key[:90]}")

    lat = [state.lat_key, state.lat_ts, state.lat_hist]
    mask = torch.ones(BATCH, dtype=torch.int32, device=dev)

    def latency_ms() -> float:
        for _ in range(2):
            kops.latency_update(*lat, recs[0], mask, 0)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            kops.latency_update(*lat, recs[0], mask, 0)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / 10

    k14_ms = latency_ms()
    with kops.plain_versions():
        plain_ms = latency_ms()
    print(f"latency match alone: K14 {k14_ms:.4f} ms, plain version (torch ops) "
          f"{plain_ms:.4f} ms")

    print(json.dumps({
        "ms_per_step": wall / args.steps * 1e3,
        "events_per_s": args.steps * BATCH / wall,
        "device_busy_share": busy_us / 1e6 / wall_p,
        "launches_per_step": launches,
        "latency_ms": k14_ms,
        "latency_plain_ms": plain_ms,
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
