"""Standalone node-agent child process (``python -m
retina_tpu_torch.fleet.node_agent``; port of retina_tpu/fleet/node_agent.py).

One real OS process per simulated node: builds numpy-only sketch
windows (fleet/hostsketch.py — no torch import anywhere on this module's
import path, so 64+ children start in seconds), and ships real RFLT frames through a real
:class:`SnapshotShipper` over the relay's ``retina.Fleet/Ship`` gRPC
socket. This is the worker half of the churn harness
(fleet/churn.py); nothing here is test-only — the shipper, codec, and
transport are the production paths.

Protocol (line-oriented, parent <-> child):

- stdout ``READY node=<name> pid=<pid>`` once the shipper is running —
  the parent's deadline-based readiness signal (no fixed sleeps).
- stdin ``ROTATE <gen>``: live seed rotation — the NEXT epoch is built
  and tagged under generation <gen> (hostsketch.rotated_seeds).
- stdin ``STOP`` (or EOF — an orphaned child must not outlive its
  parent): drain the ship spool within the deadline, emit one stdout
  ``STATS <json>`` line (shipper stats + offered epochs + SHIP_SEND
  trace IDs for the cross-process lineage check + the process's
  ``VmHWM`` and ``VmRSS`` from ``/proc/self/status`` in ``memory_kb``,
  those of the two that it gives), and exit 0.

Traffic is derived deterministically from (run seed, node index,
epoch), so the parent scores exact recall without any data channel and
a restarted replacement process regenerates the identical stream.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from retina_tpu_torch.config import Config
from retina_tpu_torch.fleet.hostsketch import (
    epoch_traffic, rotated_seeds, sketch_arrays_np,
)
from retina_tpu_torch.fleet.shipper import SnapshotShipper, window_epoch
from retina_tpu_torch.obs.recorder import get_recorder
from retina_tpu_torch.utils import metric_names as mn


def _parse_args(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="retina-node-agent")
    ap.add_argument("--node-index", type=int, required=True)
    ap.add_argument("--relay", required=True, help="zone relay addr host:port")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--heavy", type=int, default=40)
    ap.add_argument("--light", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gen", type=int, default=0)
    ap.add_argument("--tenant-mod", type=int, default=4)
    ap.add_argument("--spool", type=int, default=256)
    ap.add_argument("--backoff-base", type=float, default=0.05)
    ap.add_argument("--backoff-max", type=float, default=1.0)
    ap.add_argument(
        "--max-epochs", type=int, default=600,
        help="hard exit after this many shipped epochs (orphan guard)",
    )
    ap.add_argument(
        "--drain-timeout", type=float, default=10.0,
        help="max seconds to wait for queue+spool drain on STOP",
    )
    return ap.parse_args(argv)


def _memory_kb() -> dict[str, int]:
    """This process's peak (``VmHWM``) and current (``VmRSS``) resident set
    in kB, those that ``/proc/self/status`` gives. Not ``getrusage``'s
    ``ru_maxrss``: a child keeps its forking parent's maximum across exec."""
    out: dict[str, int] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key, _, rest = line.partition(":")
                if key in ("VmHWM", "VmRSS"):
                    out[key] = int(rest.split()[0])
    except OSError:  # noqa: RT101 — no /proc here: the keys stay out of STATS
        pass
    return out


def main(argv: list[str] | None = None) -> int:
    args = _parse_args(argv)
    idx = int(args.node_index)
    node = f"node{idx:03d}"
    cfg = Config(
        fleet_enabled=True,
        fleet_node_name=node,
        fleet_tenant=f"tenant{idx % max(1, args.tenant_mod)}",
        fleet_priority=idx % 4,
        fleet_relay_addr=args.relay,
        fleet_seed_generation=int(args.gen),
        fleet_ship_spool=int(args.spool),
        fleet_ship_backoff_base_s=float(args.backoff_base),
        fleet_ship_backoff_max_s=float(args.backoff_max),
    )
    ship = SnapshotShipper(cfg)
    ship.start()

    stop = threading.Event()
    # Written by the control thread, read at each epoch build; a plain
    # int attribute via a 1-slot list keeps this lock-free (GIL-atomic).
    gen_box = [int(args.gen)]

    def control() -> None:  # runs-on: na-control
        for line in sys.stdin:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "ROTATE" and len(parts) > 1:
                gen_box[0] = int(parts[1])
            elif parts[0] == "STOP":
                stop.set()
                return
        stop.set()  # EOF: parent is gone

    threading.Thread(target=control, name="na-control", daemon=True).start()

    print(f"READY node={node} pid={os.getpid()}", flush=True)

    offered: list[dict] = []
    last_epoch = -1
    interval = max(0.05, float(args.interval))
    while not stop.is_set() and len(offered) < args.max_epochs:
        epoch = window_epoch(interval)
        if epoch != last_epoch:
            last_epoch = epoch
            gen = gen_box[0]
            if gen != ship.seed_gen:
                ship.set_seed_generation(gen)
            keys, w = epoch_traffic(
                args.seed, idx, epoch, args.heavy, args.light
            )
            seeds = rotated_seeds(gen)
            arrays = sketch_arrays_np(keys, w, seeds)
            ok = ship.offer(epoch, arrays, interval, seeds, seed_gen=gen)
            offered.append(
                {"epoch": int(epoch), "gen": int(gen), "queued": bool(ok)}
            )
        # Wake early enough to catch the next boundary and to let the
        # spool retry timer run between epochs.
        stop.wait(interval / 20.0)

    # Drain: give the worker time to replay any spooled frames before
    # reporting — a healed partition must end with an empty spool. The
    # third condition closes the race where the worker popped the last
    # frame (queue shows empty) but hasn't finished sending it: every
    # queued frame must be accounted shipped-or-evicted before STATS.
    n_queued = sum(1 for o in offered if o["queued"])
    deadline = time.monotonic() + float(args.drain_timeout)
    while time.monotonic() < deadline:
        st = ship.stats()
        if (st["queue_depth"] == 0 and st["spool_depth"] == 0
                and st["shipped"] + st["spool_evicted"] >= n_queued):
            break
        time.sleep(0.05)

    st = ship.stats()
    ship_tids = sorted({
        int(s["trace_id"]) for s in get_recorder().spans()
        if s["stage"] == mn.STAGE_SHIP_SEND
    })
    st.update({
        "offered": offered,
        "n_offered": len(offered),
        "ship_tids": ship_tids,
        "memory_kb": _memory_kb(),
    })
    print("STATS " + json.dumps(st), flush=True)
    ship.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
