"""Where one step of the PyTorch/CUDA port spends its time on the card.

    python3 -m retina_tpu_torch.step_profile [--steps N]

Runs the port's main path (Telemetry.step at the deployed agent's shapes,
two 2^21-event batches of a 1M-flow Zipf stream, as chip_smoke.py) and
reports, after a warm-up:

- steady-state step throughput with no synchronisation between steps
  (the host enqueues, the card runs), from the host clock;
- the device time of each kernel and torch op over the profiled steps,
  from torch.profiler, with the device's busy and idle share of the
  wall time;
- the time of the apiserver latency match alone (torch ops), from CUDA
  events.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

BATCH = 1 << 21


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip
    from retina_tpu_torch.models.identity import IdentityMap
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG, latency_update
    from retina_tpu_torch.parallel.telemetry import Telemetry
    from retina_tpu_torch.u32 import from_numpy

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
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
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if dev_us <= 0:
            continue
        # A device row is one kernel, memcpy or memset; an aten row repeats
        # the device time of the kernels it launched, so only device rows
        # add up to the busy time.
        on_device = e.device_type == DeviceType.CUDA
        (kernels if on_device else ops).append((dev_us, e.count, e.key))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    busy_us = sum(r[0] for r in kernels)
    print(f"profiled: {args.steps} steps in {wall_p * 1e3:.3f} ms wall; device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e4 / wall_p:.1f}%), idle "
          f"{100 - busy_us / 1e4 / wall_p:.1f}%")
    for title, rows in (("kernels", kernels), ("torch ops", ops)):
        print(f"device time per step by {title} (ms, calls per step, name):")
        for dev_us, count, key in rows[:16]:
            print(f"  {dev_us / 1e3 / args.steps:9.4f}  {count / args.steps:6.1f}  {key[:90]}")

    lat = [state.lat_key, state.lat_ts, state.lat_hist]
    mask = torch.ones(BATCH, dtype=torch.int32, device=dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        latency_update(*lat, recs[0], mask, 0)
    e0.record()
    for _ in range(10):
        latency_update(*lat, recs[0], mask, 0)
    e1.record()
    e1.synchronize()
    print(f"latency match alone (torch ops): {e0.elapsed_time(e1) / 10:.4f} ms")

    print(json.dumps({
        "ms_per_step": wall / args.steps * 1e3,
        "events_per_s": args.steps * BATCH / wall,
        "device_busy_share": busy_us / 1e6 / wall_p,
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
