"""Two host-side probes of the agent's runtime lanes, for comparing trees.

    python3 -m retina_tpu_torch.lanes_probe proxy --workers N [--label L]
        The lanes (``SketchEngine.start``) at ``Config(feed_workers=N,
        overload_enabled=False)`` (0: the auto pool, 1: the inline feed), fed
        by two producer threads for 4 s (longer if no step landed by then):
        the proxy's host milliseconds a step, the steps, the events stepped a
        second and the losses.
    python3 -m retina_tpu_torch.lanes_probe fleet-child [--root DIR] [--label L]
        ``python3 -m retina_tpu_torch agent``, started from ``DIR`` (default:
        this checkout) in the three fleet roles at the defaults, polled for
        its first merged epoch and then for ``/fleet/query?last=4`` until it
        answers 200, at most 150 s in all: the seconds to each, the busy
        answers by overload state, the controller's signals read at each busy
        answer (how often each was the highest, their means and maxima), and
        the overload and feed stats at the end.

Each prints one line, ``PROXY ...`` or ``PROBE {json}``. Both run on the
card; the functions also take a device and small shapes (``proxy``) or
extra ``--set``s (``fleet_child``), which is how the tests run them on the
CPU. To hold two trees against each other, copy this file into the other
tree's package and run it from each tree's root in turns on one machine.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

FLEET_SETS = ("fleet_enabled=true", "fleet_aggregator=true", "fleetquery_enabled=true",
              "timetravel_enabled=true", "fleet_expected_nodes=1")
OVERLOAD_KEYS = ("state", "pressure", "signals", "since_change_s", "transitions")


def overload_block(debug_vars: dict) -> dict:
    """The overload controller's block of an agent's ``/debug/vars``: its
    state, pressure, signals, seconds since its last change and transitions."""
    ov = debug_vars.get("overload", {})
    return {k: ov.get(k) for k in OVERLOAD_KEYS}


def top_signal(signals: dict | None) -> str | None:
    """The signal that sets the pressure (the largest; None when there is none)."""
    return max(signals, key=signals.get) if signals else None


class SignalTally:
    """The overload blocks read at each busy answer: how often each signal was
    the highest, each signal's mean and max, and the last block."""

    def __init__(self) -> None:
        self.n = 0
        self.top: dict[str, int] = {}
        self.sums: dict[str, float] = {}
        self.maxes: dict[str, float] = {}
        self.last: dict | None = None

    def add(self, block: dict) -> None:
        sig = block.get("signals") or {}
        self.n += 1
        self.last = block
        t = top_signal(sig)
        if t is not None:
            self.top[t] = self.top.get(t, 0) + 1
        for k, v in sig.items():
            self.sums[k] = self.sums.get(k, 0.0) + v
            self.maxes[k] = max(self.maxes.get(k, 0.0), v)

    def summary(self) -> dict:
        return {"answers": self.n, "top": self.top,
                "mean": {k: round(v / self.n, 4) for k, v in self.sums.items()},
                "max": self.maxes, "last": self.last,
                "last_top": top_signal((self.last or {}).get("signals"))}


def proxy(workers: int, seconds: float = 4.0, device: str | None = None, n_blocks: int = 256,
          block: int = 1 << 13, n_flows: int = 1_000_000, **overrides) -> dict:
    """The lanes fed by two producers for ``seconds`` (longer until a step
    lands): the proxy's host ms a step, the steps and the events stepped a
    second."""
    from retina_tpu_torch.config import Config
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip

    cfg = Config(feed_workers=workers, overload_enabled=False, **overrides)
    eng = SketchEngine(cfg, device=device)
    eng.compile()
    eng.update_identities({pod_ip(i): i for i in range(1, min(2048, cfg.n_pods))})
    gen = TrafficGen(n_flows=n_flows, n_pods=min(2048, cfg.n_pods), seed=42)
    blocks = [gen.batch(block) for _ in range(n_blocks)]
    stop, done = threading.Event(), threading.Event()
    lanes = threading.Thread(target=eng.start, args=(stop,), daemon=True)
    lanes.start()

    def produce(k: int) -> None:
        i = k
        while not done.is_set():
            eng.sink.write_records(blocks[i % len(blocks)], "gen")
            i += 2

    prods = [threading.Thread(target=produce, args=(k,), daemon=True) for k in range(2)]
    busy0, steps0, ev0 = eng._proxy.busy_s, eng.counts.steps, eng.counts.events
    t0 = time.perf_counter()
    for p in prods:
        p.start()
    time.sleep(seconds)
    # A window without a step measures nothing: on a loaded host it stays
    # open until the first step lands (at most a minute more).
    deadline = time.monotonic() + 60
    while eng.counts.steps == steps0 and time.monotonic() < deadline:
        time.sleep(0.05)
    done.set()
    busy = eng._proxy.busy_s - busy0
    steps, events = eng.counts.steps - steps0, eng.counts.events - ev0
    wall = time.perf_counter() - t0
    for p in prods:
        p.join(10)
    stop.set()
    lanes.join(60)
    eng.stop()
    return {"ms_a_step": busy / max(steps, 1) * 1e3, "steps": steps,
            "events_per_s": events / wall, "lost": dict(eng.lost_events)}


def fleet_child(root: str | Path | None = None, limit_s: float = 150.0,
                extra_sets: tuple[str, ...] = ()) -> dict:
    """The fleet-role agent child from ``root``: seconds to its first merged
    epoch and to its first 200 from ``/fleet/query?last=4``, the busy answers
    by overload state, and its overload and feed stats at the end."""
    root = Path(root) if root is not None else Path(__file__).resolve().parent.parent
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]

    def get(path: str) -> tuple[int, str]:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read().decode()

    sets = FLEET_SETS + (f"api_server_addr=127.0.0.1:{port}",) + tuple(extra_sets)
    log = Path(tempfile.mkdtemp(prefix="lanes_probe_")) / "agent.log"
    env = {k: v for k, v in os.environ.items() if not k.startswith("RETINA_")}
    t0 = time.monotonic()
    with open(log, "w") as out:
        child = subprocess.Popen([sys.executable, "-m", "retina_tpu_torch", "agent"]
                                 + [a for s in sets for a in ("--set", s)],
                                 cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    res: dict = {}
    trail: list = []

    def sample(block: dict | None = None) -> None:
        # One [s since start, state, pressure, signals] a second, from boot on.
        now = round(time.monotonic() - t0, 1)
        if trail and now - trail[-1][0] < 1.0:
            return
        try:
            block = block or overload_block(json.loads(get("/debug/vars")[1]))
        except OSError:
            return
        trail.append([now, block["state"], block["pressure"],
                      {k: round(v, 2) for k, v in (block["signals"] or {}).items()}])

    try:
        while time.monotonic() - t0 < limit_s and child.poll() is None:
            sample()
            try:
                text = get("/metrics")[1]
                if any(ln.startswith("networkobservability_fleet_windows_merged_counter_total ")
                       and float(ln.rsplit(" ", 1)[1]) >= 1 for ln in text.splitlines()):
                    break
            except OSError:
                pass
            time.sleep(0.2)
        res["merged_s"] = round(time.monotonic() - t0, 2)
        code, busy, states, t1 = 0, 0, {}, time.monotonic()
        tally = SignalTally()
        while time.monotonic() - t0 < limit_s and child.poll() is None:
            try:
                code = get("/fleet/query?last=4")[0]
            except urllib.error.HTTPError as err:
                code = err.code
            except OSError:
                code = 0
            if code == 200:
                break
            busy += 1
            try:
                block = overload_block(json.loads(get("/debug/vars")[1]))
                states[block["state"]] = states.get(block["state"], 0) + 1
                tally.add(block)
                sample(block)
            except OSError:
                pass
            time.sleep(0.1)
        res.update(code=code, busy=busy, states=states,
                   answer_s=round(time.monotonic() - t1, 2), signals=tally.summary())
        if child.poll() is None:
            v = json.loads(get("/debug/vars")[1])
            res["overload"] = overload_block(v)
            res["feed"] = {k: v.get("feed", {}).get(k) for k in (
                "mode", "workers", "dropped_events", "lane_s", "lost_events")}
        res["wall_s"] = round(time.monotonic() - t0, 2)
        res["trail"] = trail
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGTERM)
            try:
                child.wait(timeout=60)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait(timeout=30)
    res["exit"] = child.returncode
    if res["exit"] not in (0, -signal.SIGTERM) or res.get("code") != 200:
        res["log_tail"] = log.read_text()[-1500:]
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m retina_tpu_torch.lanes_probe")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("proxy")
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--label", default="")
    c = sub.add_parser("fleet-child")
    c.add_argument("--root", default=None)
    c.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if args.cmd == "proxy":
        r = proxy(args.workers)
        print(f"PROXY {args.label} workers={args.workers}: {r['ms_a_step']:.2f} ms proxy host "
              f"a step, {r['steps']} steps, {r['events_per_s']:.0f} events/s stepped, "
              f"lost {r['lost']}", flush=True)
    else:
        r = fleet_child(args.root)
        print("PROBE", json.dumps({"label": args.label, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
