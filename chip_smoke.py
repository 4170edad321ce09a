#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's fifteen CUDA kernel sources from
``retina_tpu_torch/kernels/csrc`` (one nvcc each, all at once) and its
native host helpers (``retina_tpu_torch/native``, g++), holds each kernel
against its plain PyTorch version on the card at the shapes of the main
path, then drives the port's paths through the entry points a node agent
calls. The step paths (Telemetry step -> end_window -> snapshot -> host
top-k) each run over two 2^21-event batches of a 1M-flow Zipf stream:

- the main path: the deployed agent (DEPLOYED_CONFIG: conntrack on, low
  aggregation), 3 windows x 8 steps;
- the invertible path: INVERTIBLE_CONFIG, 1 window x 8 steps, with
  inv_decode at the window close;
- the earlier paths: PipelineConfig() (bench.py's production shapes:
  conntrack on, high aggregation) and NO_CONNTRACK_CONFIG, 1 window x 8
  steps each.

K2 (the heavy-hitter update: one call, three launches, for a step's
three sketches) and K4 (the entropy histograms) are held against their
plain versions and timed as a step calls them, at three weight sets: the
per-row lanes (high aggregation), the main path's conntrack reports, and a
batch with one key in every row (see ``sketch_phase``). Every path's
launch counts must show at most three launches of K2 and one of K4 a step,
and one of K14's finish a launch of K1.

K3 (the HLL registers: one launch for a step's three banks) is held bit for
bit against three plain updates at the per-row masks and at the main path's
report masks, whose pod bank the kernel ANDs with the reports (see
``hll_phase``); K6 (the invertible sketch: one call, two launches, for a
step's inv_flow and inv_hi) against its plain version, planes, weights and
decodes, with a priority class that feeds inv_hi, at the report and the
per-row weights (see ``inv_phase``). Every path's launch counts must show at
most one launch of K3 and two of K6 a step.

K5 (conntrack) is held against its plain version through a now_s sequence
that reaches every branch of the decision, on three batch sequences: the
bench stream with partial, garbage and reply rows; a hot connection on
every other row (its first row in the first 2048-row chunk, its last in the
last); and sums past 2^32. K8 (the N-way fold) folds each path's arrays in
one launch, an odd-length array among them, each bit for bit against its
plain version, and is timed beside the same arrays folded one a launch.

K1 (the step's per-event body) is held bit for bit against its plain
version on the two bench batches, on a batch with every row on one pod
whose forward bytes sum past 2^32, and on a batch with pods, drop reasons
and DNS qtypes past the rectangles' last rows (see ``k1_batches``).

Before the paths, K14 (the apiserver latency match: K1 lists the probes of
its final mask, one launch finishes the list) runs against the plain
versions over 4 consecutive 2^21-event batches of that stream with one row
in 64 turned into apiserver probes (the latency table carried over), then
over three batches of the in-repo captures (``TrafficGen(mode=
"pcap_replay")``, the apiserver at their loopback address); after the
invertible path, K15 (the invertible decode) against its plain version on
that path's state and on a sketch whose buckets weigh 2^31 and more, and
on the time-travel path on the 32-window fold's span-summed planes.

The ingest paths feed raw blocks through SketchEngine as the feed loop
flushes them (_build_quantum: native combine and partition; then
_dispatch_sharded per chunk: flow dictionary, new and known wires, one
copy a side, K7 ingest, one step a window), over three distinct quanta of
256 x 2^13 events of the same stream, with a window closed every two:

- ingest path 1: the deployed agent, Config(), the three quanta fed twice;
  each quantum overflows the 2^18-slot dictionary, which clears, so every
  row ships on the new side;
- ingest path 2: bench.py's sizing (batch_capacity 2^19, 8 windows a
  transfer, 2^21 dictionary slots), the three quanta fed twice: the later
  quanta ship their seen descriptors on the known side, the replay all but
  the escalated rows (over 2^10 packets or 2^22 bytes);
- ingest path 3: heavy_keys_source="invertible" (no dictionary, the
  packed full-row wire), two quanta, the invertible decode at each close.

- the time-travel path: Config(heavy_keys_source="invertible",
  timetravel_enabled=True) over the three quanta in turn, a window closed
  (and its export offered to the engine's 32-slot ring) after each, 34
  windows; then QueryService._query over the newest 1, 8 and 32 slots
  (K8, K9 and K10);
- the fleet path: 64 nodes (one engine, a fresh state a node) each fed one
  TrafficGen(seed=i) batch of 2^18 events, two tenants of 32, one window
  closed at one epoch and encoded to an RFLT frame; a FleetAggregator
  expecting 64 nodes ingests the 64 frames plus a duplicate and a late
  frame (both must drop), merges the epoch (K8, K9) and rolls it up (K10).
- the detection path: the closed loop of the reference daemon on
  Config(heavy_keys_source="invertible", timetravel_enabled=True), wired
  as the reference daemon wires it with its detectors and autocapture on:
  the engine's record tap feeds the detector bank (K11 and one bank_close
  launch at each window close, no AnomalyEWMA.observe call), whose winner and the engine's entropy anomaly flags notify
  AutoCapture, which range-queries
  the ring around the window (K8-K10), attributes sources by the invertible
  decode and writes a replay capture of only the attributed hosts. 24
  windows of 2^16 bench events, one quantum each, with a port sweep, a DNS
  tunnel and the DDoS burst at windows 12, 16 and 20: no benign window may
  fire, each attack window must fire its detector (the DDoS: synflood or
  the entropy flags), each must be captured, every artifact must hold only
  rows to or from attributed hosts, and the plain run must fire, hook and
  attribute alike. The DDoS's decode recall and the tap's share of a
  bench-scale quantum are printed as findings.
- row 12, ``cms.update_jit``, which lies on no path: its kernel
  (``cms_update``, K2's add phase alone) against its plain version at the
  deployed CMS shape (depth 4, width 2^15) over a 2^21-row batch.
- the runtime path: ``SketchEngine.start(stop)`` on its own thread, the
  deployed ``Config()`` fed by producer threads through ``engine.sink``
  for 8 windows with a pause in the middle, so a close is idle; the feed
  loop, the feed workers (1, 2, then the auto count), the dispatch thread,
  the device proxy on its own CUDA stream, the close lane and the harvest
  lane; then a short run with ``heavy_keys_source="both"`` (K6, K10, the
  ground truth) and a short one with the overload controller held in
  SAMPLING. Each run's dispatch thread's log is replayed synchronously
  under the plain versions, and the run must equal its replay (see
  ``runtime_lanes``).
- the scrape path: the node agent's scrape surface wired as the reference
  daemon wires it (``Config()`` with its time-travel ring, the identity
  cache with 2047 pods, ``MetricsModule`` with the default metric set, the
  conntrack plugin's gauges, the HTTP ``Server`` on 127.0.0.1 and
  ``QueryService`` behind ``/timetravel/query``): 8 windows of one bench
  quantum each, closed through the close and harvest lanes (K16), then
  scraped twice over HTTP (the snapshot's estimates and live count: K17);
  each exposition must equal the plain versions' of the same state, and
  each close ``end_window_plain`` on the state saved before it; then
  ``GET /timetravel/query?last=1``, ``8`` and ``32`` (the range extract:
  K16's read-only entry and K17), each equal to the plain route's
  document. It prints the GET time and its split into snapshot, publish
  and render, the exposition's size and the queries' latency (see
  ``scrape_surface``).
- the supervision path: the deployed ``Config()`` under a ``Supervisor``
  (watchdog deadline 5 s): a quantum flushed and checkpointed, an injected
  transfer fault on an asynchronous dispatch, degraded drop-and-count, the
  crash-only recovery from the checkpoint and its zero-row probe (K7 and
  the step's kernels), two quanta, a close and a snapshot after it, held
  against a second engine that loaded the checkpoint and took the same
  quanta under the plain versions; a torn checkpoint quarantined; the
  checkpoint's save and load times at DEPLOYED_CONFIG and
  INVERTIBLE_CONFIG. Then the script starts itself as a child
  (``--sticky-child``) that runs the lanes on the card, poisons the CUDA
  context with a device-side assert and must end, within its bound, with
  ``recovery_failed`` set and the state still on the card (see
  ``supervision_phase`` and ``sticky_child``). Each runtime run also prints
  the flight recorder's stage report and its seconds by thread and stage.

Each path's launch counts are set to 0 just before it and read just after,
and every kernel of the path must have launched. The state, step summaries,
window outputs, snapshots and decodes after each path must equal the same
run through the plain versions on the card (an ingest path's plain run has
an engine of its own and launches nothing; the time-travel queries and the
fleet aggregation are repeated under the plain versions and their result
documents must be equal), and totals[0] must equal the events fed.

Comparison rules: integer state and outputs are compared exactly (the
top-k winner and the latency slot winner are "last row in batch order",
the conntrack report row is the connection's last row and a shared slot
goes to the largest fingerprint, in the kernels and the plain versions
alike); float32 entropy counts of integer weights are exact below 2^24
per bucket and compared exactly there, within a relative 2^-22 above;
derived floats (entropy bits, HLL estimates, EWMA state, z-scores) within
a relative 1e-5, since reductions may group differently.

K7 (the ingest kernels) is held bit for bit against its plain versions at
the default-flush and bench shapes (2^21 slots: the known side's gather
does not fit in the L2), and its new side on a wire a third of which is
padding, on one id in every row and on distinct ids: the windows, the
descriptor table and zero claims after every call. K1-K6 are timed by
CUDA events around 10 calls after 2 warm-ups; K7-K17,
whose kernels take microseconds, by their device time in
torch.profiler (the summed durations of what the calls ran on the card),
with the CUDA-event span of the same calls beside it. K11 is held against
its plain version at the tap's largest shapes (2^16 flow keys, a padded
2^6, and 2^16 keys whose sources share one hash-group, so every register
update of K11's cluster lands in one block), estimates within a relative
1e-5; the bank's close (K12, K13 and the three detectors' EWMA in one
launch) over 8 closes of the dns_flood histogram, the syn_storm lanes and
K11's estimates of a 2^16-row sweep window, perturbed from a seed, the
last an outlier: flags equal, z within 1e-4, the scores and the EWMA mean
within a relative 1e-5, its variance within 1e-6; K12 and K13 alone (its
one-slot forms) within a relative 1e-5 and bit for bit. The pairwise merges are
timed by device time beside their bounds.

K10 (the Count-Min query; several jobs and ``decode_verified``'s filter in
one launch) is held bit for bit against its plain versions at a window
close's shape (the invertible path's two regions in one launch, at
min_weight 0, at one that rejects decoded keys, at 2^31 and with an
all-false mask; see ``verify_phase``) and at the fleet path's (the union of
the nodes' candidate tables with the merged epoch's two decoded regions in
one launch). Every node close of the fleet and time-travel paths, and the
invertible path's close, must launch K10 once and K15 once (both regions
in one launch), and one call of the close's ``Telemetry.inv_decode`` must
run exactly those two kernels on the card; K10's launches are printed by
path (node close, rollup, range query).

K15 (the invertible decode, both regions of a close or a range query in one
launch) is held bit for bit against its plain version on the invertible
path's state, on a sketch whose buckets weigh 2^31 and more and on the
32-window fold's span-summed planes, and timed by device time on the
invertible path's two regions, back to back and with the L2 flushed (see
``inv_decode_phase``). K9 (the candidate-table join, the three families of
a fold in one launch) is held bit for bit against its plain version on the
32-window fold's stacked tables and on the 64-node epoch's, and timed by
device time on the epoch's three families, back to back and with the L2
flushed; one ``fold_stacked`` call, a range query's or a fleet merge's,
must launch K9 once.

K16 (the window close: 16 blocks a group, one launch a close) and K17's
readout (one launch writes the scrape's whole flat snapshot: the copied
leaves, the HLL estimates and the live count) are held bit for bit
against their plain versions at the batches of ``step_profile --readout``
(a close of the main path's state, one bucket a group, every bucket
nonzero, 16384 buckets, a 32-window histogram; the readout of that state,
of a zero state and of the invertible path's), estimates within a
relative 1e-5, and timed by device time back to back and with the L2
flushed, beside the span of a call and the sector bound (see
``readout_phase``). Every path that closes a window and takes a snapshot
must launch K16 and the readout.

Then the engine over 4 shards on the one card (``sharded_phase``):
``SketchEngine(cfg, devices=[card] * 4)`` at ``Config()`` and at the
invertible configuration over ingest path 1's quanta, its closes, export,
snapshot and decode merged by K8 and K9 on the card, equal to the same run
under the plain versions, equal to one shard on the leaves that are exact
by construction, the union's candidates holding the heaviest flows; the
same merges in a world-size-1 NCCL group equal to the group-less ones;
and the flush rate, the close's and the snapshot's device time and the
snapshot's latency at 4 shards and at one.

Last, the node agent as users start it (``daemon_phase``): a ``Daemon``
at ``Config()`` with the time-travel ring and the detector bank on the
card, one in-repo capture through packetparser (the scraped pod series
equal to the decoded capture's sums exactly), the default synthetic
source for 10 s (its run equal to its synchronous replay under the plain
versions), /metrics, /debug/vars and a range query, the kernels of the
path launched, the shutdown checkpoint reloaded; then a child
``python3 -m retina_tpu_torch agent`` scraped and stopped by SIGTERM.
Then the agent with its identity from a cluster (``kube_phase``): a fake
kube-apiserver on 127.0.0.1 (``FakeKube``) lists 2,048 pods, their
services and 8 nodes to an agent started with a kubeconfig; its cache, the
engine's identity map and the filter set equal a plain replay of the LIST,
pushed to the card once, then of each WATCH event (a pod added, deleted
and moved, a service deleted, a bookmark, a 410 and a dropped
connection's re-LIST); the capture's scraped pod series under the listed
names, a ``MetricsConfiguration`` CR reconciled and deleted, the operator
beside the agent (a Capture's local capture of the replay on the card
exact against the filter, in a host path, a blob container and a bucket,
a batch/v1 Job a remote node, a Capture with a failed Job, a
RetinaEndpoint CR, the ``capture`` verb), a second agent over
CiliumEndpoints, a ``--kubeconfig`` child, and an ``operator`` child
whose unknown-node Capture fails after the next two phases.
Then the agent's event sources (``sources_phase``): the three in-repo
captures and a 2^20-packet capture synthesized from the bench flows'
keys, in the nanosecond and microsecond formats, through the native and
the numpy decoders (all 16 lanes and the DNS names equal); their records
through the main and the invertible engines with kernels and under the
plain versions (state, windows and snapshots equal, ``totals[0]`` the
packets decoded); and a ``Daemon`` with packetparser (the TPACKET_V3 ring
on lo where this process may open one, else a replay of the synthesized
capture), linuxutil, tcpretrans, infiniband, externalevents (a capture's
records as frames on its socket) and ciliumeventobserver (a gob stream of
drop and trace notifications on its socket): the host-stat series on
/metrics and the rows stepped equal to the rows delivered.
Then the Hubble control plane (``hubble_phase``): a ``Daemon`` at
``Config()`` with ``enable_hubble`` and the synthetic source at 1e6
events/s; ``GetFlows(last=1000)`` over msgpack, over the Cilium protobuf
surface and over the unix socket, each equal to ``record_to_flow`` of the
last 1000 rows the monitor agent delivered; ServerStatus, peer Notify, the
hubble metrics mux; ``observe`` and ``status`` children; a ``relay`` child
whose flows carry the agent's node name.
Then the fleet tier as the agent runs it (``fleet_transport_phase``): 8
engines at ``Config()`` close 4 shared epochs and ship them through their
``SnapshotShipper``s over the in-process bus to one subscribed
``FleetAggregator`` (the rollups equal to the same frames merged under the
plain versions), one more epoch over the relay client to the port's
``HubbleServer`` (``fleet_ingest=agg.ingest``) on 127.0.0.1,
``/fleet/query`` over the aggregator's ring and over 8 node clients
(equal to the plain versions), the three fleet dryruns at their defaults,
and a child agent in the three fleet roles scraped for its ``fleet_*``
series and ``/fleet/query`` and stopped by SIGTERM. Last, the churn
harness (``churn_phase``): ``run_churn_dryrun`` with 64 torch-free node
processes shipping over gRPC to 4 zone relays (``HubbleServer``) whose
aggregators merge on the card and re-ship to a root aggregator on the
card, through restarts, two partitions and a seed rotation; its scorecard
must be ok.

Prints the card's name and power limit, a JSON line of per-kernel results
and, as the last line, {"ok": true, "device": {...}}. Exits non-zero, with
no result line, if there is no card or any check fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tarfile
import time

import numpy as np

BATCH = 1 << 21
QUANTUM, BLOCK = 1 << 21, 1 << 13  # a flush quantum of 256 blocks, as bench.py feeds
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


def device_ms(fn, reps: int = 10, kernel: str | None = None,
              require: bool = True) -> float | None:
    """Device time of one call of ``fn`` from torch.profiler, over ``reps``
    calls after 2 warm-ups: the summed durations of the kernels, copies and
    fills the calls ran on the card (only the kernels whose name holds
    ``kernel``, if given), after an empty session that takes the records an
    earlier session delivered late. Unlike a CUDA-event span, it holds no
    wait for the host's launches. A trace that holds no device activity (the
    profiler has returned such traces, up to three in a row, on the chip
    machine) is taken again with twice the calls, at most eight times in
    all; then it fails, or with ``require`` false returns None (not
    measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for attempt in range(8):
        # An empty session first: the card's activity records that an
        # earlier session delivered late land there and are dropped.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.002)  # the tracer is on before the first call
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.key))
        if us > 0:
            break
        print(f"device_ms: trace {attempt + 1} of {reps} calls held no device time; "
              "tracing again", flush=True)
        reps *= 2
        time.sleep(0.1)
    if not require and us == 0:
        return None
    check(us > 0, f"the profiler saw no device time{f' in {kernel}' if kernel else ''}")
    return us / 1e3 / reps


def device_launches(fn, reps: int = 10) -> dict[str, int]:
    """{name: launches a call} of the kernels, copies and fills that a call
    of ``fn`` runs on the card, from torch.profiler over ``reps`` calls after
    a warm-up and an empty session. A trace that is empty, or whose counts
    are not whole launches a call (the profiler has lost single records on
    the chip machine), is taken again, at most eight times. A spin kernel
    runs before the calls and one after, and both are left out of the
    counts: on some machines the trace loses the session's first or last
    record every time, which is then a spin kernel's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.002)  # the tracer is on before the first call
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ran = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and "spin_kernel" not in e.key}
        if ran and all(n % reps == 0 for n in ran.values()):
            return {k: n // reps for k, n in ran.items()}
        time.sleep(0.1)
    raise CheckFailed(f"the profiler saw no whole launches a call: {ran}")


def busy_threads(seconds: float = 1.0, top: int = 6) -> list[tuple[str, float]]:
    """This process's busiest threads over ``seconds``: (name, CPU seconds)
    from the user and system times in /proc/self/task/*/stat."""
    import os
    import threading

    def cpu() -> dict[int, float]:
        out = {}
        for tid in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            out[int(tid)] = (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
        return out

    before = cpu()
    time.sleep(seconds)
    after = cpu()
    names = {t.native_id: t.name for t in threading.enumerate()}
    used = sorted(((names.get(tid, str(tid)), after[tid] - before.get(tid, 0.0))
                   for tid in after), key=lambda x: -x[1])
    return [(n, round(c, 3)) for n, c in used[:top]]


def overload_line(block: dict) -> str:
    """An overload controller's block (``overload_stats()`` or an agent's
    ``/debug/vars``) on one line: state, pressure, signals, seconds since its
    last change and transitions."""
    sig = {k: round(v, 3) for k, v in (block.get("signals") or {}).items()}
    return (f"{block.get('state')} pressure {block.get('pressure')} signals {sig} since "
            f"{block.get('since_change_s')} s, {block.get('transitions')} transitions")


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


def named_leaves_dict(d, prefix: str = ""):
    """(name, tensor) of every tensor in a nested dict."""
    out = []
    for k, v in d.items():
        out += (named_leaves_dict(v, f"{prefix}{k}.") if isinstance(v, dict)
                else [(f"{prefix}{k}", v)])
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
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
    from retina_tpu_torch.parallel.telemetry import Telemetry, topk_from_snapshot
    from retina_tpu_torch.u32 import from_numpy, to_numpy, widen

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
        elif isinstance(a, int):
            check(a == b, f"{what}: {a} != {b}")
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

    def k1(state, r, n_valid=BATCH, table=ident, api=None):
        return kops.step_rows(r, n_valid, 1, table.table, table.seed, filt.table, filt.seed,
                              state.pod_forward, state.pod_drop, state.pod_tcpflags,
                              state.pod_dns, state.pod_retrans, state.node_counters,
                              state.totals, CFG, apiserver_ip=api)

    scratch = None  # the kernel's lanes of the first bench batch
    for label, r, table in k1_batches(dev, host, recs, ident):
        out = []
        for i, st in enumerate(pair):
            with kops.plain_versions() if i else contextlib.nullcontext():
                out.append(k1(st, r, table=table))
        equal_int(out[0][0], out[1][0], f"K1 scratch ({label})")
        equal_int(out[0][1], out[1][1], f"K1 sums ({label})")
        for (name, a), (_, b) in zip(named_leaves(pair[0])[:7], named_leaves(pair[1])[:7]):
            equal_int(a, b, f"K1 state {name} after the {label} batch")
        print(f"K1 {label} batch: bit-equal to the plain version", flush=True)
        if scratch is None:
            scratch = dict(zip(kops.SCRATCH, out[0][0]))
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

    # -- K2 and K4 as a step calls them, at three weight sets ---------------
    row12_set = sketch_phase(dev, recs, ident, time_ms, report, equal_int, close_counts)
    src, dst = recs[0][:, F.SRC_IP], recs[0][:, F.DST_IP]
    five = [src, dst, recs[0][:, F.PORTS], scratch["proto"]]

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
    # The hot connection: every other row of a batch is one connection (its
    # first row in the first chunk, its last in the last), one in four of them
    # in the reply direction.
    h = int(torch.nonzero(ct_calls[0][2][1])[0])  # a masked row of recs[0]
    hot = recs[0].clone()
    hot[0::2] = recs[0][h]
    rh = hot[2::8]
    rh[:, F.SRC_IP], rh[:, F.DST_IP] = recs[0][h, F.DST_IP], recs[0][h, F.SRC_IP]
    p0 = recs[0][h, F.PORTS]
    rh[:, F.PORTS] = ((p0 & 0xFFFF) << 16) | ((p0 >> 16) & 0xFFFF)
    hot_head, hot_tail = ct_inputs(hot)
    # Sums past 2^32: every row carries ~2^31 packets and ~2^32 bytes, so a
    # connection's sums wrap from its third row on.
    wrap_head, wrap_tail = ct_inputs(recs[1])
    rows = torch.arange(BATCH, dtype=torch.int32, device=dev)
    wrap_tail = [(-256) | (rows & 0xFF), wrap_tail[1], 0x7FFFFFF1 + (rows & 7)]
    sequences = {"mixed": ct_calls,
                 "hot connection": [(now, hot_head, hot_tail) for now in CT_CLOCK],
                 "sums past 2^32": [(now, wrap_head, wrap_tail) for now in CT_CLOCK]}
    from retina_tpu_torch.ops.conntrack import fingerprint

    def ct_stats(head, tail):
        """Distinct connections of a batch and distinct keys a 2048-row chunk."""
        lo, hi, _ = fingerprint(*head[:4], 8)
        m = tail[1] != 0
        key = ((lo << 32) | hi)[m]
        chunk = torch.arange(BATCH, device=dev)[m] // 2048
        return (int(torch.unique(key).numel()),
                torch.unique(torch.stack([chunk, key]), dim=1).shape[1] / (BATCH // 2048))

    rep_low = rep_mask = None
    for seq, calls in sequences.items():
        tables = [ConntrackTable.zeros(CFG.conntrack_slots, seed=8, device=dev) for _ in range(2)]
        n_conn, per_chunk = ct_stats(*calls[0][1:])
        for now, head, tail in calls:
            out = tables[0].process_lanes(*head, now, *tail)
            with kops.plain_versions():
                ref = tables[1].process_lanes(*head, now, *tail)
            what = f"K5 ({seq}) at now={now}"
            equal_int(out, ref, f"{what}: lanes")
            equal_int(tables[0].keys, tables[1].keys, f"{what}: keys")
            equal_int(tables[0].vals, tables[1].vals, f"{what}: vals")
            check(int(out[0].sum()) > 0, f"{what}: no reports")
            print(f"{what}: {int(out[0].sum())} reports, {int(out[1].sum())} replies", flush=True)
            if seq == "mixed" and now == 131:
                # flow_w and the report mask of a real step at low aggregation
                rep_low, rep_mask = out[2].clone(), out[0].clone()
            if seq == "hot connection" and now == CT_CLOCK[0]:
                # New: one report, at the connection's last row.
                check(int(out[0][0:BATCH - 2:2].sum()) == 0 and int(out[0][BATCH - 2]) == 1,
                      f"{what}: the report is not on the connection's last row")
        print(f"K5 {seq}: {n_conn} distinct connections a batch, {per_chunk:.1f} distinct keys "
              f"a 2048-row chunk; scratch {kops.conntrack_scratch_bytes(tables[0].scratch)} "
              f"bytes", flush=True)
        if seq == "mixed":
            kept = tables
    tables = kept
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

    # -- K3: the step's three HLL banks in one launch, per-row and report --
    hll_phase(dev, recs, scratch, rep_mask, tel, time_ms, report, equal_int)

    # -- K6: both invertible regions in one call at INVERTIBLE_CONFIG's shapes
    inv_phase(dev, recs, scratch, rep_low, time_ms, report, equal_int)

    # -- K14: the latency match over probe batches and the captures ------
    latency_phase(dev, host, recs, tel, k1, time_ms, report, equal_int)

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
            # The decode (K15, K10), the close (K16) and the snapshot (K17):
            # the plain run takes their plain versions.
            with kops.plain_versions() if plain else contextlib.nullcontext():
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
        check_sketch_launches(launches, name)
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

    k1_k5 = ["step_rows", "hh_update", "hll_update", "entropy_update", "conntrack",
             "latency_update"]
    # Every path that closes a window and takes a snapshot: K16 and K17's
    # one-launch readout.
    close_snap = ["window_close", "snapshot_flat"]
    run, launches = path("main path", CFG, WINDOWS, STEPS, k1_k5 + close_snap)
    main_launches = launches
    cms_rows = widen(run["state"].flow_hh.cms.table).sum(dim=1) & 0xFFFFFFFF
    ct_lo = int(to_numpy(run["state"].ct_totals)[0])
    check(bool((cms_rows == ct_lo).all()), "main path: a flow_hh CMS row != ct_totals[0]")
    for r in results:
        r["launches"] = launches[r["name"]]

    # The invertible decode verifies its keys through the CMS query, K10.
    run, launches = path("invertible path", INVERTIBLE_CONFIG, 1, STEPS,
                         k1_k5 + close_snap + ["inv_update", "cms_query", "inv_decode"])
    # One window closed, one decode: K15 once and K10 once for both regions.
    check(launches["cms_query"] == 1 and launches["inv_decode"] == 1,
          f"invertible path: a close launched K10 {launches['cms_query']} and K15 "
          f"{launches['inv_decode']} times (want 1 and 1)")
    dec = run["decs"][-1]
    ok = dec["ok"]
    found = {tuple(int(x) for x in row) for row in to_numpy(dec["keys"][ok])}
    print(f"invertible path: {int(ok.sum())} verified buckets, {len(found)} keys, recall of "
          f"the true top-50 {recall(found):.2f}", flush=True)
    for r in results:
        if r["name"] == "inv_update":
            r["launches"] = launches["inv_update"]
    inv_decode_phase(dev, run["state"], time_ms, report, equal_int)
    results[-1]["launches"] = launches["inv_decode"]
    verify_phase(dev, run["state"], equal_int)

    path("production path", PipelineConfig(), 1, STEPS, k1_k5 + close_snap)
    path("no-conntrack path", NO_CONNTRACK_CONFIG, 1, STEPS,
         [k for k in k1_k5 if k != "conntrack"] + close_snap)

    # -- the window close and the scrape, timed -------------------------------
    # end_window is K16 and the snapshot K17's one-launch readout, each
    # beside its plain version; the rest (inv_decode's glue, the export) is
    # torch ops, whose "plain version" is themselves. Bounds count the state
    # they read and the copies they write.
    from retina_tpu_torch.step_profile import readout_sector_bytes

    t = Telemetry(INVERTIBLE_CONFIG, device=dev)
    st = t.init_state()
    for r in recs:
        st, _ = t.step(st, r, BATCH, 2, ident)
    snap = t.snapshot(st, 2)
    snap_bytes = sum(x.numel() * x.element_size() for _, x in named_leaves_dict(snap))
    ro_bytes = readout_sector_bytes(st)["total"]
    snap_ms = time_ms(lambda: t.snapshot(st, 2))

    def plain_snapshot():
        with kops.plain_versions():
            t.snapshot(st, 2)

    snap_plain_ms = time_ms(plain_snapshot)
    dec_ms = time_ms(lambda: t.inv_decode(st))
    dec_bytes = sum(x.numel() * x.element_size() for x in (
        st.inv_flow.planes, st.inv_flow.weights, st.inv_hi.planes, st.inv_hi.weights,
        st.flow_hh.cms.table))
    ent_bytes = 2 * st.entropy.counts.numel() * 4
    def one_close(plain: bool) -> float:
        """ms of one close (CUDA events) after a window of traffic."""
        nonlocal st
        st, _ = t.step(st, recs[0], BATCH, 3, ident)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with kops.plain_versions() if plain else contextlib.nullcontext():
            e0.record()
            t.end_window(st)
            e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    t.end_window(st)  # warm-up of both routes
    with kops.plain_versions():
        t.end_window(st)
    close_ms = [one_close(False), one_close(True), one_close(True), one_close(False)]
    print(f"end_window (K16, one launch) {close_ms[0]:.4f}, {close_ms[3]:.4f} ms; plain (torch "
          f"ops) {close_ms[1]:.4f}, {close_ms[2]:.4f} ms; snapshot (K17, one launch) "
          f"{snap_ms:.4f} ms, plain {snap_plain_ms:.4f} ms", flush=True)
    export_bytes = sum(x.numel() * x.element_size() for x in t.fleet_export(st).values())
    export_ms = time_ms(lambda: t.fleet_export(st))
    flat_ms = time_ms(lambda: t.snapshot_flat_dispatch(st, 2))
    host_ms = time_ms(lambda: t.snapshot_host(st, 2))
    for name, ms, nbytes in (("snapshot (K17, one launch; its leaves views of the buffer)",
                              snap_ms, ro_bytes),
                             ("inv_decode (K15 once, K10 once)", dec_ms,
                              dec_bytes),
                             ("fleet_export", export_ms, 2 * export_bytes),
                             ("snapshot_flat (K17, one launch)", flat_ms, ro_bytes),
                             ("snapshot_host (flat + readback)", host_ms,
                              ro_bytes + snap_bytes),
                             ("end_window (K16)", close_ms[0], ent_bytes)):
        print(f"{name}: {ms:.4f} ms, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"({nbytes} bytes)", flush=True)
    # The two allocations (rows 7 and 8): a state of the invertible engine,
    # and the deployed descriptor table with K7's claim scratch; each writes
    # its zeros once.
    from retina_tpu_torch.config import Config as _Config
    from retina_tpu_torch.parallel.wire import PACKED_FIELDS

    slots = _Config().flow_dict_slots
    state_bytes = sum(x.numel() * x.element_size() for _, x in named_leaves(st))
    for name, fn, nbytes in (
            ("init_state (INVERTIBLE_CONFIG)", t.init_state, state_bytes),
            ("desc_table (2^18 slots)", lambda: (
                torch.zeros((slots, PACKED_FIELDS), dtype=torch.int32, device=dev),
                torch.zeros((slots,), dtype=torch.int32, device=dev)),
             slots * (PACKED_FIELDS + 1) * 4)):
        print(f"allocation {name}: {time_ms(fn):.4f} ms, bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes)", flush=True)
    # The pairwise merges (torch ops), each of this state with itself: device
    # time; the bound reads both inputs and writes the result once from HBM,
    # but the timed calls find the inputs (at most 5.3 MB) in the 50 MB L2.
    def nbytes_of(*ts):
        return sum(x.numel() * x.element_size() for x in ts)

    for name, sk, leaves in (
            ("cms.merge (flow_hh)", st.flow_hh.cms, [st.flow_hh.cms.table]),
            ("topk.merge (flow_hh)", st.flow_hh.table,
             [st.flow_hh.table.counts, st.flow_hh.table.key_rows]),
            ("hh.merge (flow_hh)", st.flow_hh,
             [st.flow_hh.cms.table, st.flow_hh.table.counts, st.flow_hh.table.key_rows]),
            ("hll.merge (hll_flows)", st.hll_flows, [st.hll_flows.registers]),
            ("entropy.merge", st.entropy, [st.entropy.counts]),
            ("inv.merge (inv_flow)", st.inv_flow, [st.inv_flow.planes, st.inv_flow.weights])):
        ms = device_ms(lambda sk=sk: sk.merge(sk))
        nbytes = 3 * nbytes_of(*leaves)
        print(f"torch ops {name}: device time {ms:.4f} ms, bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms ({nbytes} bytes; warm in L2)",
              flush=True)
    del st, t, snap

    # -- K16 and the readout at the batches of step_profile --readout -------
    readout_phase(dev, recs, ident, time_ms, report, results, main_launches, equal_int)

    # -- K7: the ingest kernels against their plain versions ---------------
    from retina_tpu_torch import native
    from retina_tpu_torch.config import Config
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.parallel.flowdict import flow_dict_stats
    from retina_tpu_torch.step_profile import ingest_wires, k7_sector_bytes, new_claim_wires

    t0 = time.perf_counter()
    native.get_lib()
    print(f"native host helpers: built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    k7 = {}
    for label, cap, bucket, slots in (("default flush", 1 << 15, 1 << 17, 1 << 18),
                                      ("bench sizing", 1 << 19, 1 << 18, 1 << 21)):
        x = ingest_wires(dev, bucket, slots, seed=SEED + 7)
        id_bits = x["id_bits"]
        n_out = -(-bucket // cap) * cap
        for lo, hi in ((0xFFFFFF00, 7), (0, 0)):
            out = kops.ingest_packed(x["packed"], True, lo, hi, n_out)
            with kops.plain_versions():
                ref = kops.ingest_packed(x["packed"], True, lo, hi, n_out)
            equal_int(out, ref, f"K7 ingest_packed ({label}, base {lo:#x})")
            tables = [x["table"].clone(), x["table"].clone()]
            winner = torch.zeros(slots, dtype=torch.int32, device=dev)
            out = kops.ingest_new(x["new"], tables[0], winner, lo, hi, n_out)
            with kops.plain_versions():
                ref = kops.ingest_new(x["new"], tables[1], winner, lo, hi, n_out)
            equal_int(out, ref, f"K7 ingest_new windows ({label})")
            equal_int(tables[0], tables[1], f"K7 ingest_new table ({label})")
            check(not bool(winner.any()), f"K7 ingest_new left claims ({label})")
            for wire_name, dense in (("dense", True), ("two", False)):
                for flag in (1, 0):
                    out = kops.ingest_known(x[wire_name], bucket, dense, id_bits, x["table"],
                                            flag, lo, hi, n_out)
                    with kops.plain_versions():
                        ref = kops.ingest_known(x[wire_name], bucket, dense, id_bits,
                                                x["table"], flag, lo, hi, n_out)
                    equal_int(out, ref, f"K7 ingest_known v{4 if dense else 3} ({label})")
        print(f"K7 {label}: bucket {bucket}, {n_out // cap} windows of {cap}, {slots} slots "
              f"(id_bits {id_bits}): kernels equal their plain versions", flush=True)
        k7[label] = (x, n_out, slots, id_bits, bucket)

    # The new side's claims at the batches that pull them apart, each
    # against its plain version: a wire a third of which is padding (id 0,
    # as the engine pads a bucket: every padding row claims slot 0), every
    # row one id, every row an id of its own. The windows, the table and
    # zero claims after the call, then the device time and the span.
    slots = 1 << 18
    for label, (n_valid, w) in new_claim_wires(SEED + 13, slots).items():
        bucket = w.shape[0]
        wire = from_numpy(w, dev)
        n_out = -(-bucket // (1 << 15)) * (1 << 15)
        table = from_numpy(rng.integers(0, 1 << 32, (slots, 12), dtype=np.uint64)
                           .astype(np.uint32), dev)
        tables = [table, table.clone()]
        winner = torch.zeros(slots, dtype=torch.int32, device=dev)
        out = kops.ingest_new(wire, tables[0], winner, 0xFFFFFF00, 7, n_out)
        torch.cuda.synchronize()
        check(not bool(winner.any()), f"K7 ingest_new left claims ({label})")
        with kops.plain_versions():
            ref = kops.ingest_new(wire, tables[1], winner, 0xFFFFFF00, 7, n_out)
        equal_int(out, ref, f"K7 ingest_new windows ({label})")
        equal_int(tables[0], tables[1], f"K7 ingest_new table ({label})")
        nbytes = k7_sector_bytes("ingest_new", wire, w[:, 0], n_out)

        def new_fn(wire=wire, table=tables[0], winner=winner, n_out=n_out):
            return kops.ingest_new(wire, table, winner, 0xFFFFFF00, 7, n_out)

        dev_ms, span = device_ms(new_fn), time_ms(new_fn)
        check(not bool(winner.any()), f"K7 ingest_new left claims after its timing ({label})")
        print(f"K7 ingest_new on the {label} batch (bucket {bucket}, {n_valid} valid rows): "
              f"device time {dev_ms:.4f} ms, CUDA-event span {span:.4f} ms; sector bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes); equal to the plain "
              f"version", flush=True)
        del wire, tables, table, winner, out, ref

    # Times at the default flush (one coalesced chunk of 2^17 rows) and the
    # known side's gather at bench sizing (2^21 slots: the table, 100.7 MB,
    # does not fit in the L2): device time first, the CUDA-event span of a
    # call beside it. Back to back, the default flush's wire, table and
    # records (27 MB) stay in the 50 MB L2, so its times may pass the HBM
    # bound; step_profile --ingest times them with the L2 flushed too.
    row_ops = 40  # integer operations a row: decode, unpack, addressing
    for label in ("default flush", "bench sizing"):
        x, n_out, slots, id_bits, bucket = k7[label]
        table = x["table"].clone()
        winner = torch.zeros(slots, dtype=torch.int32, device=dev)
        new_ids = to_numpy(x["new"][:, 0])
        k7_runs = (
            ("ingest_packed", "retina_tpu/engine.py:1052",
             lambda: kops.ingest_packed(x["packed"], True, 0xFFFFFF00, 7, n_out),
             k7_sector_bytes("ingest_packed", x["packed"], [], n_out), None),
            ("ingest_new", "retina_tpu/engine.py:1205",
             lambda: kops.ingest_new(x["new"], table, winner, 0xFFFFFF00, 7, n_out),
             k7_sector_bytes("ingest_new", x["new"], new_ids[new_ids < slots], n_out), None),
            ("ingest_known", "retina_tpu/engine.py:1275",
             lambda: kops.ingest_known(x["dense"], bucket, True, id_bits, x["table"], 1,
                                       0xFFFFFF00, 7, n_out),
             k7_sector_bytes("ingest_known", x["dense"], x["known_ids"], n_out),
             "index_select"),
        )
        for name, replaces, fn, nbytes, lib in k7_runs:
            if label == "bench sizing" and name != "ingest_known":
                continue
            ms, span = device_ms(fn), time_ms(fn)
            lib_ms = None
            if lib:
                ids_dev = from_numpy(x["known_ids"], dev).long()
                lib_out = torch.zeros((n_out, 16), dtype=torch.int32, device=dev)

                def lib_fn():
                    lib_out[: len(x["known_ids"]), :12].copy_(x["table"].index_select(0, ids_dev))

                lib_ms = device_ms(lib_fn)
            print(f"K7 {name} at the {label}: device time {ms:.4f} ms, CUDA-event span "
                  f"{span:.4f} ms (the wrapper's host cost {span - ms:.4f} ms a call); sector "
                  f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes)"
                  + (f"; index_select + copy {lib_ms:.4f} ms (device time)" if lib else ""),
                  flush=True)
            if label == "bench sizing":
                continue
            with kops.plain_versions():
                plain_ms = time_ms(fn)
            report(name, "retina_tpu_torch/kernels/csrc/ingest.cu", replaces, ms, plain_ms,
                   nbytes, bucket * row_ops, lib_ms, 0.0)
        check(not bool(winner.any()), f"K7 ingest_new left claims after its timing ({label})")

    # -- the ingest paths: raw blocks -> combine -> flow dictionary ->
    # wire -> K7 -> step, through SketchEngine, as the feed loop flushes --
    qgen = TrafficGen(n_flows=N_FLOWS, n_pods=N_PODS_GEN, seed=SEED)
    quanta = [np.split(qgen.batch(QUANTUM), QUANTUM // BLOCK) for _ in range(3)]
    pods = {pod_ip(i): i for i in range(1, N_PODS_GEN)}
    print(f"ingest traffic: 3 quanta of {QUANTUM // BLOCK} x {BLOCK} events", flush=True)

    def feed_run(cfg, schedule, plain):
        eng = SketchEngine(cfg, device=dev)
        eng.update_identities(pods)
        wins, snaps, per_q = [], [], []
        ctx = kops.plain_versions if plain else contextlib.nullcontext
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, blocks in enumerate(schedule):
            before = (eng.counts.new_rows, eng.counts.known_rows, eng.counts.packed_rows)
            with ctx():
                eng.flush(blocks, 100 + i)
                if i % 2 == 1 or i == len(schedule) - 1:
                    wins.append(eng.close_window())
                    snaps.append(eng.snapshot(max_age_s=0, now_s=100 + i))
            after = (eng.counts.new_rows, eng.counts.known_rows, eng.counts.packed_rows)
            per_q.append(tuple(a - b for a, b in zip(after, before)))
        torch.cuda.synchronize()
        return dict(eng=eng, wins=wins, snaps=snaps, per_q=per_q,
                    wall=time.perf_counter() - t0, stages=eng.stages.seconds())

    def ingest_path(name, cfg, schedule, kernels):
        kops.reset_launch_counts()
        run = feed_run(cfg, schedule, plain=False)
        launches = kops.launch_counts()
        print(f"{name} launches: {launches}", flush=True)
        check_sketch_launches(launches, name)
        for k in kernels:
            check(launches[k] > 0, f"{k} was not launched on the {name}")
        ref = feed_run(cfg, schedule, plain=True)
        check(kops.launch_counts() == launches, f"the plain {name} run launched kernels")
        eng = run["eng"]
        for (leaf, a), (_, b) in zip(named_leaves(eng.state), named_leaves(ref["eng"].state)):
            if a.dtype == torch.int32:
                equal_int(a, b, f"{name} state {leaf}")
            elif leaf == "entropy.counts":
                close_counts(a, b, f"{name} entropy counts")
            else:
                close_float(a, b, f"{name} state {leaf}")
        for w in range(len(run["wins"])):
            equal_any(run["wins"][w], ref["wins"][w], f"{name} window {w}")
            equal_any(run["snaps"][w], ref["snaps"][w], f"{name} snapshot {w}")
        fed = sum(len(b) for blocks in schedule for b in blocks)
        check(fed == sum(int(b[:, F.PACKETS].astype(np.uint64).sum())
                         for blocks in schedule for b in blocks), "one packet a raw event")
        check(int(to_numpy(eng.state.totals)[0]) == fed & 0xFFFFFFFF,
              f"{name}: totals[0] != raw events fed")
        check(eng.counts.events == fed, f"{name}: events counted != fed")
        st = run["stages"]
        n_q = len(schedule)
        card = st["copy"] + st["ingest"] + st["steps"]
        print(f"{name}: {n_q} quanta, {fed} events in {run['wall']:.3f} s: "
              f"{fed / run['wall']:.0f} events/s through the feed path; "
              f"{eng.counts.steps} steps; wire {eng.counts.wire_bytes / fed:.4f} bytes/event; "
              f"flow dict {flow_dict_stats(eng._flow_dict)}", flush=True)
        print(f"{name}: rows per quantum (new, known, packed) {run['per_q']}", flush=True)
        print(f"{name}: ms per quantum " + ", ".join(
            f"{k} {st[k] / n_q * 1e3:.3f}" for k in st)
            + f"; wall {run['wall'] / n_q * 1e3:.3f}; card span {card / run['wall']:.1%} of "
            f"the wall (copy, ingest and steps by CUDA events)", flush=True)
        return run, launches

    # bench.py's traffic holds ~197k distinct descriptors a quantum, about
    # half of them unseen in the previous one: the default 2^18-slot
    # dictionary overflows and clears in every quantum, so every row ships
    # on the new side; the known side runs at bench sizing.
    run, launches = ingest_path("ingest path 1 (deployed agent)", Config(), quanta + quanta,
                                ["ingest_new"] + close_snap)
    check(run["eng"]._flow_dict.generation > 0, "ingest path 1: the dictionary never cleared")
    for r in results:
        if r["name"] == "ingest_new":
            r["launches"] = launches["ingest_new"]
    run, launches = ingest_path(
        "ingest path 2 (bench sizing)",
        Config(batch_capacity=1 << 19, feed_coalesce_windows=8, flow_dict_slots=1 << 21),
        quanta + quanta, ["ingest_new", "ingest_known"] + close_snap)
    new, known, _ = run["per_q"][-1]
    check(new * 100 < known, "ingest path 2: the replay ships more than escalated rows new")
    for r in results:
        if r["name"] == "ingest_known":
            r["launches"] = launches["ingest_known"]
    run, launches = ingest_path("ingest path 3 (invertible)",
                                Config(heavy_keys_source="invertible"), quanta[:2],
                                ["ingest_packed", "inv_update", "cms_query", "inv_decode"]
                                + close_snap)
    for r in results:
        if r["name"] == "ingest_packed":
            r["launches"] = launches["ingest_packed"]
    dec = run["wins"][-1]["inv"]
    print(f"ingest path 3: {int(dec['ok'].sum())} verified buckets at the close", flush=True)

    timetravel_and_fleet(dev, quanta, pods, time_ms, report, results)
    detection_loop(dev, quanta, pods, time_ms, report, results)
    cms_update_phase(dev, host[0], time_ms, report, results, equal_int, row12_set)
    runtime_lanes(dev, quanta, pods, equal_int, close_counts, close_float, equal_any)
    scrape_surface(dev, quanta, time_ms, report, results)
    supervision_phase(dev, quanta, pods, equal_int, close_counts, close_float, equal_any)
    sharded_phase(dev, quanta, pods, smi, equal_any)
    daemon_phase(dev, equal_int, close_counts, close_float, equal_any)
    finish_kube = kube_phase(smi)
    try:
        sources_phase(dev, smi, equal_int, close_counts, close_float, equal_any)
        hubble_phase(dev, smi)
    except BaseException:
        finish_kube(checked=False)
        raise
    finish_kube()  # the kube phase's operator child, its deferrals spent meanwhile
    fleet_transport_phase(dev, pods, smi)
    churn_phase(dev, smi)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from its start to the "
          f"kernels line", flush=True)
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def readout_phase(dev, recs, ident, time_ms, report, results, main_launches,
                  equal_int) -> None:
    """K16 and K17's one-launch readout at the batches of ``step_profile
    --readout`` (``step_profile.readout_inputs``), each held bit for bit
    against its plain version and timed by device time (back to back and
    with the L2 flushed by a 128 MiB write before each call) beside its
    CUDA-event span and its sector bound.

    K16: the close of DEPLOYED_CONFIG's state after one window at (3, 4096),
    each group's mass in one bucket ("collapse"), every bucket nonzero
    ("dense") and K = 16384 ("K max"), each from a warm EWMA state (n_obs
    12, random mean and var): bits, flags, z, mean, var and n_obs equal, the
    histogram zeroed, and the read-only entry's bits equal; the 32-window
    merged histogram of a range query ("bits"). The readout: the snapshot
    of that state ("scrape"), of a zero state ("empty") and of
    INVERTIBLE_CONFIG's after one window ("invertible scrape"), at clocks
    across the 16-bit wrap: one launch a call, the flat layout equal, every
    int leaf equal, the estimates within a relative 1e-5. It reports the
    readout (``snapshot_flat``) with the main path's launches, the scrape's
    flushed device time, its sector bound and ``torch.cat`` of the copied
    leaves as its library call."""
    import torch

    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import EWMA_MIN_WINDOWS
    from retina_tpu_torch.parallel.telemetry import Telemetry
    from retina_tpu_torch.step_profile import (
        copied_leaves,
        k16_bytes,
        readout_inputs,
        readout_sector_bytes,
        span_ms,
    )

    inp = readout_inputs(dev, recs, ident)
    l2 = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    floor = device_ms(lambda: l2[:1].zero_(), reps=50, kernel="Fill")
    print(f"launch floor (a one-word fill, device time): {floor:.4f} ms", flush=True)
    rng = np.random.default_rng(SEED + 14)
    alpha = inp["state"].anomaly.alpha

    def warm_ewma(g):
        return [torch.from_numpy(rng.uniform(0, 12, g).astype(np.float32)).to(dev),
                torch.from_numpy(rng.uniform(0, 0.5, g).astype(np.float32)).to(dev),
                torch.full((g,), 12.0, device=dev)]

    def timed(label, fn, prep, kernel, nbytes, plain):
        """Device time back to back and L2 flushed, the span and the plain
        version's time of one call after ``prep()``."""
        warm = device_ms(lambda: (prep(), fn()), kernel=kernel)
        cold = device_ms(lambda: (prep(), l2.zero_(), fn()), kernel=kernel)
        span = span_ms(fn, prep)

        def plain_call():
            prep()
            with kops.plain_versions():
                plain()

        plain_ms = time_ms(plain_call)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{label}: device time {warm:.4f} ms back to back, {cold:.4f} ms L2 flushed; "
              f"CUDA-event span {span:.4f} ms (host cost {span - warm:.4f} ms a call); plain "
              f"{plain_ms:.4f} ms; sector bound {bound:.4f} ms ({nbytes} bytes), launch floor "
              f"{floor:.4f} ms", flush=True)
        return cold, plain_ms

    for label, counts in inp["counts"].items():
        g, k = counts.shape
        ewma0 = warm_ewma(g)
        c, c_ref = counts.clone(), counts.clone()
        e, e_ref = [x.clone() for x in ewma0], [x.clone() for x in ewma0]
        before = kops.launch_counts()["window_close"]
        out = kops.window_close(c, *e, alpha, 4.0, EWMA_MIN_WINDOWS)
        check(kops.launch_counts()["window_close"] == before + 1, f"K16 {label}: launches")
        with kops.plain_versions():
            ref = kops.window_close(c_ref, *e_ref, alpha, 4.0, EWMA_MIN_WINDOWS)
        bits = kops.entropy_bits(counts)
        torch.cuda.synchronize()
        for x, y, what in zip([*out, *e], [*ref, *e_ref],
                              ("bits", "flags", "z", "mean", "var", "n_obs")):
            check(x.shape == y.shape and bool(torch.equal(x, y)), f"K16 {label}: {what} differ")
        check(not bool(c.any()), f"K16 {label}: the histogram was not zeroed")
        check(bool(torch.equal(bits, ref[0])), f"K16 {label}: entropy_bits differs")
        print(f"K16 {label} ({g}, {k}): bits, flags, z, mean, var, n_obs and the reset equal "
              f"the plain version's; {int(out[1].sum())} flags", flush=True)
        timed(f"K16 {label}", lambda: kops.window_close(c, *e, alpha, 4.0, EWMA_MIN_WINDOWS),
              lambda: c.copy_(counts), "window_close_kernel", k16_bytes(g, k),
              lambda: kops.window_close(c, *e, alpha, 4.0, EWMA_MIN_WINDOWS))
    merged = inp["merged"]
    bits = kops.entropy_bits(merged)
    with kops.plain_versions():
        ref = kops.entropy_bits(merged)
    torch.cuda.synchronize()
    check(bool(torch.equal(bits, ref)), "K16 bits on the 32-window histogram differ")
    timed("K16 bits (32 windows)", lambda: kops.entropy_bits(merged), lambda: None,
          "window_close_kernel", k16_bytes(*merged.shape, close=False),
          lambda: kops.entropy_bits(merged))

    tel, st = inp["tel"], inp["state"]
    inv_tel, inv_st = inp["invertible"]
    for label, t, s in (("scrape", tel, st), ("empty", tel, inp["empty"]),
                        ("invertible scrape", inv_tel, inv_st)):
        err = 0.0
        for now in (3, 40, 0xFFFF + 3, 0xFFFFFFFF):
            before = kops.launch_counts()
            flat, layout = t.snapshot_flat_dispatch(s, now)
            after = kops.launch_counts()
            check({n: after[n] - before[n] for n in after if after[n] != before[n]}
                  == {"snapshot_flat": 1}, f"readout {label}: not one launch")
            with kops.plain_versions():
                ref, ref_layout = t.snapshot_flat_dispatch(s, now)
            torch.cuda.synchronize()
            check(layout == ref_layout, f"readout {label}: layouts differ")
            got, want = (Telemetry.snapshot_flat_finish(x, layout) for x in (flat, ref))
            for (name, a), (_, b) in zip(named_leaves_dict(got), named_leaves_dict(want)):
                if a.dtype == torch.float32:
                    check(bool(torch.allclose(a, b, rtol=1e-5, atol=0)),
                          f"readout {label}: {name} estimates differ")
                    err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
                else:
                    equal_int(a, b, f"readout {label} at now {now}: {name}")
        nb = readout_sector_bytes(s)
        print(f"readout {label}: one launch, {flat.numel()} words equal to the plain "
              f"version's (estimates within {err}); bytes " +
              ", ".join(f"{a} {b}" for a, b in nb.items()), flush=True)
        ms, plain_ms = timed(f"readout {label} (snapshot_flat_dispatch)",
                             lambda t=t, s=s: t.snapshot_flat_dispatch(s, 3), lambda: None,
                             "readout_kernel", nb["total"],
                             lambda t=t, s=s: t.snapshot_flat_dispatch(s, 3))
        snap_span = span_ms(lambda t=t, s=s: t.snapshot(s, 3))
        print(f"readout {label}: Telemetry.snapshot CUDA-event span {snap_span:.4f} ms",
              flush=True)
        if label == "scrape":
            scrape = (ms, plain_ms, nb, err)
    s = st
    words = [x.reshape(-1) for x in copied_leaves(s)]
    cat_ms = device_ms(lambda: (l2.zero_(), torch.cat(words)), kernel="CatArray")
    print(f"library: torch.cat of the {len(words)} copied leaves, L2 flushed, {cat_ms:.4f} ms "
          "(device time)", flush=True)
    ms, plain_ms, nb, err = scrape
    n_regs = sum(b.registers.numel() for b in (s.hll_flows, s.hll_src_per_reason,
                                               s.hll_src_per_pod))
    report("snapshot_flat", "retina_tpu_torch/kernels/csrc/snapshot_readout.cu",
           "retina_tpu/parallel/telemetry.py:712", ms, plain_ms, nb["total"],
           3 * n_regs + 8 * s.conntrack.n_slots, cat_ms, err)
    results[-1]["launches"] = main_launches["snapshot_flat"]


def k1_batches(dev, host, recs, ident):
    """K1's check batches at the deployed widths, as (label, records,
    identity map): the two bench batches; "one", the first with every row's
    addresses on pod 1 and its bytes times 4096, so that the pod's forward
    bytes sum past 2^32 (and wrap); "clamped", the second with every third
    row's destination a pod past P - 1, every other row dropped with a
    reason up to 3 R, and every odd row a DNS request or reply with a qtype
    up to 4 Q."""
    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.events.synthetic import pod_ip
    from retina_tpu_torch.models.identity import IdentityMap
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG as CFG
    from retina_tpu_torch.u32 import from_numpy

    yield "bench 0", recs[0], ident
    yield "bench 1", recs[1], ident
    one = host[0].copy()
    one[:, F.SRC_IP] = one[:, F.DST_IP] = pod_ip(1)
    one[:, F.BYTES] *= 4096
    check(int(one[one[:, F.VERDICT] == 1, F.BYTES].astype(np.uint64).sum()) > 1 << 33,
          "K1: the one-pod batch's forward bytes stay under 2^32")
    yield "one", from_numpy(one, dev), ident
    del one
    rng = np.random.default_rng(SEED + 1)
    cl = host[1].copy()
    n, P, R, Q = len(cl), CFG.n_pods, CFG.n_drop_reasons, CFG.n_dns_qtypes
    far = {pod_ip(N_PODS_GEN + j): P - 1 + 977 * j for j in range(16)}
    cl[::3, F.DST_IP] = pod_ip(N_PODS_GEN) + rng.integers(0, 16, len(cl[::3]))
    cl[::2, F.VERDICT] = 2  # dropped
    cl[:, F.DROP_REASON] = rng.integers(0, 3 * R, n)
    cl[1::2, F.EVENT_TYPE] = rng.integers(2, 4, len(cl[1::2]))  # DNS request, reply
    cl[:, F.DNS] = rng.integers(0, 4 * Q, n).astype(np.uint32) << np.uint32(16)
    table = IdentityMap.build_host({pod_ip(i): i for i in range(1, N_PODS_GEN)} | far,
                                   n_slots=1 << 16, device=dev)
    yield "clamped", from_numpy(cl, dev), table


def check_sketch_launches(launches: dict, label: str) -> None:
    """A step makes one K1 launch, which also lists the latency probes, one
    launch of the latency match's finish (K14), one call of K2 (three
    launches for its three sketches), one launch of K3 for its three HLL
    banks, at most two of K6 for both invertible regions and one of K4."""
    steps = launches["step_rows"]
    check(launches["hll_update"] <= steps,
          f"{label}: hll_update launched {launches['hll_update']} times in {steps} steps")
    check(launches["inv_update"] <= 2 * steps,
          f"{label}: inv_update launched {launches['inv_update']} times in {steps} steps")
    check(launches["latency_update"] == steps,
          f"{label}: latency_update launched {launches['latency_update']} times in {steps} steps")
    check(launches["hh_update"] <= 3 * steps,
          f"{label}: hh_update launched {launches['hh_update']} times in {steps} steps")
    check(launches["entropy_update"] <= steps,
          f"{label}: entropy_update launched {launches['entropy_update']} times in {steps} steps")


def sketch_phase(dev, recs, ident, time_ms, report, equal_int, close_counts):
    """K2 and K4 as a step calls them, each held against its plain version
    and timed at three weight sets of the deployed widths, the calls
    captured at the wrappers (``step_profile.sketch_calls``): "per-row" (the
    8th step of NO_CONNTRACK_CONFIG, high aggregation: every masked row
    weighted), "report" (the 8th step of DEPLOYED_CONFIG, the main path:
    the conntrack reports weight the sketches) and "one-key" (a
    NO_CONNTRACK_CONFIG step on a batch whose rows all carry the first
    row's addresses, ports, protocol and DNS hash). K2 is the step's one
    ``hh_update_many`` call, made twice from clones of the state the step
    left (the second offer meets the counts the first set), kernel against
    plain: CMS, counts and key rows bit for bit, 3 launches a call; K4 within
    ``close_counts``. Each set's times (CUDA events, and device time in
    torch.profiler, which leaves out the host's launch gaps) go on a line
    of their own; the kernels line carries the per-row CUDA-event times.
    Returns the report set's flow keys and weights for row 12."""
    import torch

    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG as CFG
    from retina_tpu_torch.models.pipeline import NO_CONNTRACK_CONFIG
    from retina_tpu_torch.ops.hashing import hash_cols, reduce_range
    from retina_tpu_torch.parallel.telemetry import Telemetry
    from retina_tpu_torch.step_profile import capture_sketch_calls, sketch_calls
    from retina_tpu_torch.u32 import widen

    sets = sketch_calls(dev, recs, ident)
    hot = recs[0].clone()
    lanes = [F.SRC_IP, F.DST_IP, F.PORTS, F.META, F.DNS_QHASH]
    hot[:, lanes] = hot[0, lanes]
    tel = Telemetry(NO_CONNTRACK_CONFIG, device=dev)
    state = tel.init_state()
    sets["one-key"] = capture_sketch_calls(lambda: tel.step(state, hot, len(hot), 2, ident))
    n = len(recs[0])
    row12 = None
    for label in ("per-row", "report", "one-key"):
        k2, k4 = sets[label]["k2"], sets[label]["k4"]
        check(len(k2) == 1 and k2[0][0].__name__ == "hh_update_many" and len(k4) == 1,
              f"K2/K4 {label}: the step made {len(k2)} and {len(k4)} calls")
        updates = k2[0][1][0]
        pair = [[(u[0].clone(), u[1], u[2].clone(), u[3].clone(), u[4], u[5], u[6])
                 for u in updates] for _ in range(2)]
        for _ in range(2):
            before = kops.launch_counts()["hh_update"]
            kops.hh_update_many(pair[0])
            check(kops.launch_counts()["hh_update"] == before + 3,
                  f"K2 {label}: one call did not launch 3 kernels")
            with kops.plain_versions():
                kops.hh_update_many(pair[1])
        for name, a, b in zip(("flow_hh", "svc_hh", "dns_hh"), pair[0], pair[1]):
            equal_int(a[0], b[0], f"K2 {label} {name} cms")
            equal_int(a[3], b[3], f"K2 {label} {name} counts")
            equal_int(a[2], b[2], f"K2 {label} {name} key rows")
        weighted = [int((u[6] != 0).sum()) for u in updates]
        ms = time_ms(lambda: kops.hh_update_many(pair[0]))
        dev_ms = device_ms(lambda: kops.hh_update_many(pair[0]))
        print(f"K2 at the {label} weights: kernel {ms:.4f} ms (CUDA events), device time "
              f"{dev_ms:.4f} ms (3 launches for the 3 sketches); weighted rows {weighted} of {n}",
              flush=True)
        if label == "per-row":
            with kops.plain_versions():
                plain_ms = time_ms(lambda: kops.hh_update_many(pair[1]))
            nbytes = ops = 0
            for (cms, _, key_rows, _, _, cols, w), active in zip(updates, weighted):
                c, (d, wd), s = len(cols), cms.shape, key_rows.shape[0]
                nbytes += n * (4 * c + 4) + 2 * 4 * (d * wd + s * (c + 1))
                ops += active * (2 * d * c * HASH_OPS + c * HASH_OPS + 4 * d)
            report("hh_update", "retina_tpu_torch/kernels/csrc/hh_update.cu",
                   "retina_tpu/ops/topk.py:177", ms, plain_ms, nbytes, ops, None, 0.0)
        if label == "report":
            row12 = (updates[0][5], updates[0][6])
        del pair

        counts, seed, cols, w = k4[0][1]
        pair = [counts.clone(), counts.clone()]
        kops.entropy_update(pair[0], seed, cols, w)
        with kops.plain_versions():
            kops.entropy_update(pair[1], seed, cols, w)
        err = close_counts(pair[0], pair[1], f"K4 {label} counts")
        ms = time_ms(lambda: kops.entropy_update(pair[0], seed, cols, w))
        dev_ms = device_ms(lambda: kops.entropy_update(pair[0], seed, cols, w))
        active = int((w != 0).sum())
        print(f"K4 at the {label} weights: kernel {ms:.4f} ms (CUDA events), device time "
              f"{dev_ms:.4f} ms; weighted rows {active} of {n}; max_abs_err {err}", flush=True)
        if label == "per-row":
            with kops.plain_versions():
                plain_ms = time_ms(lambda: kops.entropy_update(pair[1], seed, cols, w))
            g, k = counts.shape
            idx = torch.cat([i * k + reduce_range(hash_cols([c], 0xE17209 + seed), k)
                             for i, c in enumerate(cols)])
            wf = widen(w).float().repeat(g)
            hist = torch.zeros(g * k, dtype=torch.float32, device=dev)
            lib_ms = time_ms(lambda: hist.index_add_(0, idx, wf))
            del idx, wf, hist
            report("entropy_update", "retina_tpu_torch/kernels/csrc/entropy_update.cu",
                   "retina_tpu/ops/entropy.py:54", ms, plain_ms,
                   n * 4 * (g + 1) + 2 * 4 * g * k, active * (g * HASH_OPS + g), lib_ms, err)
        del pair
    check(CFG.cms_depth == updates[0][0].shape[0], "the sets are not at the deployed widths")
    del sets, state, tel, hot
    return row12


def hll_phase(dev, recs, scratch, report_lane, tel, time_ms, report, equal_int) -> None:
    """K3 as the step calls it: one launch for the deployed state's three
    HLL banks (1 x 2^12, 16 x 2^12, 4096 x 2^6) over the first bench batch,
    at the per-row masks (high aggregation: K1's mask, is_drop and pod_mask
    lanes) and at the main path's report masks (low aggregation: the flow
    bank masked by the conntrack reports, the pod bank's pod_mask ANDed with
    them in the kernel); each bank bit-equal to three plain updates, twice
    over (the second call meets the registers the first raised). The kernels
    line carries the per-row times. Bound: the records' first 32-byte sector
    (src, dst, ports) and each of the six scratch lanes (4 bytes) once a
    row, the banks read and written once; the earlier formula (4 bytes a key
    lane, a bank) is printed beside it."""
    import torch

    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.ops.hashing import hash_cols, reduce_range
    from retina_tpu_torch.u32 import widen

    src = recs[0][:, F.SRC_IP]
    five = [src, recs[0][:, F.DST_IP], recs[0][:, F.PORTS], scratch["proto"]]
    masks = {"per-row": (scratch["mask"], None), "report": (report_lane, report_lane)}
    names = ("hll_flows", "hll_src_per_reason", "hll_src_per_pod")

    def banks_of(st, label):
        sk, pod2 = masks[label]
        lanes = [(five, None, sk, None), ([src], scratch["reason"], scratch["is_drop"], None),
                 ([src], scratch["pod_grp"], scratch["pod_mask"], pod2)]
        return [(getattr(st, n).registers, getattr(st, n).seed, *x) for n, x in zip(names, lanes)]

    for label in masks:
        pair = [tel.init_state(), tel.init_state()]
        for _ in range(2):
            before = kops.launch_counts()["hll_update"]
            kops.hll_update_many(banks_of(pair[0], label))
            check(kops.launch_counts()["hll_update"] == before + 1,
                  f"K3 {label}: one call did not make one launch")
            with kops.plain_versions():
                kops.hll_update_many(banks_of(pair[1], label))
        for n in names:
            equal_int(getattr(pair[0], n).registers, getattr(pair[1], n).registers,
                      f"K3 {label} {n}")
        banks = banks_of(tel.init_state(), label)
        on = [(m != 0) if m2 is None else ((m & m2) != 0) for *_, m, m2 in banks]
        ms = time_ms(lambda: kops.hll_update_many(banks))
        dev_ms = device_ms(lambda: kops.hll_update_many(banks))
        print(f"K3 at the {label} masks: kernel {ms:.4f} ms (CUDA events), device time "
              f"{dev_ms:.4f} ms (one launch for the three banks); masked rows "
              f"{[int(x.sum()) for x in on]} of {BATCH}; bit-equal to the plain version",
              flush=True)
        if label != "per-row":
            continue
        with kops.plain_versions():
            plain_ms = time_ms(lambda: kops.hll_update_many(banks))
        # Library yardstick: one scatter_reduce_(amax) over the three banks
        # laid end to end, with the indices and ranks precomputed (no hashing).
        flat, vals, off, ops = [], [], 0, 0
        for (regs, seed, cols, grp, _, _), hit in zip(banks, on):
            g, m = regs.shape
            p = m.bit_length() - 1
            h = hash_cols(cols, 0xC0FFEE + seed)
            rho = (32 - p) - (torch.frexp((h >> p).double()).exponent.long() - 1)
            gi = widen(grp) if grp is not None else 0
            flat.append(torch.where(hit, off + gi * m + reduce_range(h, m), off))
            vals.append(torch.where(hit, rho, 0).int())
            off += g * m
            ops += int(hit.sum()) * (len(cols) * HASH_OPS + 10)
        flat_i, vals_i = torch.cat(flat), torch.cat(vals)
        lib = torch.zeros(off, dtype=torch.int32, device=dev)
        lib_ms = time_ms(lambda: lib.scatter_reduce_(0, flat_i, vals_i, "amax"))
        del flat, vals, flat_i, vals_i, lib
        regs_bytes = 2 * 4 * off
        nbytes = BATCH * (32 + 4 * 6) + regs_bytes
        old = BATCH * sum(4 * len(b[2]) + (8 if b[3] is not None else 4) for b in banks) \
            + regs_bytes
        print(f"K3 bound: {nbytes} bytes, {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (a 32-byte "
              f"record sector and six 4-byte lanes a row); by the earlier formula (4 bytes a "
              f"key lane, a bank) {old} bytes, {old / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
        report("hll_update", "retina_tpu_torch/kernels/csrc/hll_update.cu",
               "retina_tpu/ops/hyperloglog.py:72", ms, plain_ms, nbytes, ops, lib_ms, 0.0)


INV_PRIORITY_MASK = 0xFFFFFF00  # K6's priority class: the /24 of pod_ip(0), pods 1-255


def inv_phase(dev, recs, scratch, rep_low, time_ms, report, equal_int) -> None:
    """K6 as the invertible step calls it: one call (two launches) for
    inv_flow (2 x 4096) and inv_hi (2 x 512) at INVERTIBLE_CONFIG's widths
    over the first bench batch, its rows split by a priority class (src or
    dst in pods 1-255: priority_ip_mask INV_PRIORITY_MASK over pod_ip(0)'s
    /24, whose share of the rows is printed) so that inv_hi's planes carry
    weight, at the main path's report weights ("low") and the per-row
    weights ("high"); both regions' planes, weights and decodes bit-equal to
    the plain version, twice over. The kernels line carries the "low" times.
    Bound: the weight and selector lanes (4 bytes a row), a weighted row's
    32-byte record sector and proto lane, both regions' planes and weights
    read and written once; the earlier formula (inv_flow alone, 16 bytes a
    weighted row's key) is printed beside it."""
    import torch

    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.events.synthetic import pod_ip
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import INVERTIBLE_CONFIG as ICFG
    from retina_tpu_torch.models.pipeline import priority_class
    from retina_tpu_torch.ops.invertible import InvertibleSketch, bits, indices
    from retina_tpu_torch.u32 import narrow, widen

    key5 = [recs[0][:, F.SRC_IP], recs[0][:, F.DST_IP], recs[0][:, F.PORTS], scratch["proto"]]
    prio = priority_class(widen(key5[0]), widen(key5[1]), INV_PRIORITY_MASK,
                          pod_ip(0) & INV_PRIORITY_MASK).to(torch.int32)
    widths = (ICFG.inv_width, ICFG.inv_hi_width)

    def sketches():
        return [InvertibleSketch.zeros(ICFG.inv_depth, wd, 4, seed=9 + i, device=dev)
                for i, wd in enumerate(widths)]

    def regions(invs):
        return [(inv.planes, inv.weights, inv.seed) for inv in invs]

    print(f"K6 priority class: {int(prio.sum())} of {BATCH} rows "
          f"({int(prio.sum()) / BATCH:.4f}) have src or dst in pods 1-255", flush=True)
    for label, w in (("low", rep_low), ("high", scratch["flow_w"])):
        pair = [sketches(), sketches()]
        for _ in range(2):
            before = kops.launch_counts()["inv_update"]
            kops.inv_update_pair(regions(pair[0]), key5, w, prio)
            check(kops.launch_counts()["inv_update"] == before + 2,
                  f"K6 {label}: one call did not make two launches")
            with kops.plain_versions():
                kops.inv_update_pair(regions(pair[1]), key5, w, prio)
        decoded = []
        for name, a, b in zip(("inv_flow", "inv_hi"), *pair):
            equal_int(a.planes, b.planes, f"K6 {name} planes ({label})")
            equal_int(a.weights, b.weights, f"K6 {name} weights ({label})")
            dec = [a.decode(), b.decode()]
            for j in range(4):
                equal_int(dec[0][0][j], dec[1][0][j], f"K6 {name} decode col {j} ({label})")
            equal_int(dec[0][1], dec[1][1], f"K6 {name} decode weight ({label})")
            equal_int(dec[0][2], dec[1][2], f"K6 {name} decode ok ({label})")
            decoded.append(int(dec[0][2].sum()))
        weighted = w != 0
        n_hi = int((weighted & (prio != 0)).sum())
        check(n_hi > 0 and bool(pair[0][1].weights.any()), f"K6 {label}: inv_hi took no row")
        print(f"K6 {label}: {int(weighted.sum())} weighted rows, {n_hi} of them to inv_hi; "
              f"buckets decode: inv_flow {decoded[0]}, inv_hi {decoded[1]}; bit-equal to the "
              f"plain version", flush=True)
    invs = regions(sketches())
    ms = time_ms(lambda: kops.inv_update_pair(invs, key5, rep_low, prio))
    dev_ms = device_ms(lambda: kops.inv_update_pair(invs, key5, rep_low, prio))
    with kops.plain_versions():
        plain_ms = time_ms(lambda: kops.inv_update_pair(invs, key5, rep_low, prio))
    # Library yardstick: one index_add_ over both regions laid end to end,
    # each row's bucket indices and weighted bits precomputed (no hashing).
    d, nb = ICFG.inv_depth, invs[0][0].shape[2]
    pick = prio != 0
    flat = torch.where(pick[None, :],
                       indices(d, widths[1], 10, key5) + d * widths[0]
                       + (torch.arange(d, device=dev) * widths[1])[:, None],
                       indices(d, widths[0], 9, key5)
                       + (torch.arange(d, device=dev) * widths[0])[:, None]).reshape(-1)
    rows = narrow(torch.where(pick[:, None], bits(key5, 10), bits(key5, 9))
                  * widen(rep_low)[:, None]).repeat(d, 1)
    lib = torch.zeros((d * sum(widths), nb), dtype=torch.int32, device=dev)
    lib_ms = time_ms(lambda: lib.index_add_(0, flat, rows))
    del flat, rows, lib
    active = int((rep_low != 0).sum())
    nbytes = BATCH * 8 + active * 36 + 2 * 4 * d * sum(widths) * (nb + 1)
    old = BATCH * 4 + active * 16 + 2 * 4 * d * widths[0] * (nb + 1)
    print(f"K6 at the low weights, both regions: kernel {ms:.4f} ms (CUDA events), device time "
          f"{dev_ms:.4f} ms (two launches); bound {nbytes} bytes, "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; by the earlier formula (inv_flow alone, "
          f"16 bytes a weighted row's key) {old} bytes, {old / HBM_BYTES_PER_S * 1e3:.4f} ms",
          flush=True)
    report("inv_update", "retina_tpu_torch/kernels/csrc/inv_update.cu",
           "retina_tpu/ops/invertible.py:136", ms, plain_ms, nbytes,
           active * ((d + 1) * 4 * HASH_OPS + d * nb), lib_ms, 0.0)


LAT_API = 0x7F000001  # the latency phase's apiserver: the captures' loopback address
LAT_BATCHES = 4  # consecutive 2^21-row probe batches; the latency table carries over
LAT_EVERY = 64  # one row in LAT_EVERY a probe
LAT_CAPTURE_ROWS = 1 << 16  # rows of each batch of the in-repo captures
# RTTs of the probes (ms): every bucket, the 2^13 and 2^15 edges, 0xFFFFFFFF.
LAT_RTTS = (0, 1, 2, 5, 9, 20, 40, 100, 200, 500, 1000, 3000, 5000, 8191, 8192, 16383, 32767,
            40000, 1 << 20, 0xFFFFFFFF)


def latency_probes(batch, rng, prev):
    """A copy of ``batch`` whose rows 0, LAT_EVERY, 2 LAT_EVERY, ... are
    apiserver probes: the first half sends to LAT_API, the second half
    replies from it. Sends repeat TSvals (the last one of a slot wins) and
    collide in the 4096 slots; a reply answers a send of its own batch or,
    for a third of them, of the ``prev`` batch's (TSvals, send times), at
    an RTT of LAT_RTTS; one in seven replies twice. Returns the rows and
    this batch's (TSvals, send times)."""
    from retina_tpu_torch.events.schema import F

    rec = batch.copy()
    idx = np.arange(0, len(rec), LAT_EVERY)
    half = len(idx) // 2
    send, reply = idx[:half], idx[half: 2 * half]
    tsv = rng.integers(1, 1 << 31, half).astype(np.uint32)
    tsv[1::5] = tsv[0::5][: len(tsv[1::5])]
    t_send = rng.integers(1 << 21, 1 << 30, half).astype(np.int64)
    reply_tsv, reply_t = tsv.copy(), t_send.copy()
    if prev is not None:
        reply_tsv[1::3], reply_t[1::3] = prev[0][1::3], prev[1][1::3]
    reply_tsv[2::7], reply_t[2::7] = reply_tsv[0::7][: len(reply_tsv[2::7])], \
        reply_t[0::7][: len(reply_t[2::7])]
    rtts = np.array(LAT_RTTS, np.int64)
    reply_ms = (reply_t + rtts[np.arange(half) % len(rtts)]) & 0xFFFFFFFF
    for rows, ms in ((send, t_send), (reply, reply_ms)):
        ns = ms << 20
        rec[rows, F.TS_LO] = (ns & 0xFFFFFFFF).astype(np.uint32)
        rec[rows, F.TS_HI] = (ns >> 32).astype(np.uint32)
    rec[send, F.DST_IP], rec[send, F.TSVAL] = LAT_API, tsv
    rec[reply, F.SRC_IP], rec[reply, F.TSECR] = LAT_API, reply_tsv
    return rec, (tsv, t_send)


def latency_phase(dev, host, recs, tel, k1, time_ms, report, equal_int) -> None:
    """K14 through the fused path against the plain versions: K1 with the
    apiserver lists the probes of its final mask, then the finish applies
    them; the plain path is K1's plain version and ``latency_update_plain``
    on its mask lane. Over LAT_BATCHES consecutive 2^21-row batches of the
    bench traffic with probes (one batch partial), then three batches of the
    in-repo captures through ``TrafficGen(mode="pcap_replay")`` (loopback
    TCP: every row carries TSval and TSecr and is a send and a reply; the
    apiserver's address is a pod of the identity map, so K1 keeps every
    row), the latency state carried through all of them. The masks and the
    state must be equal after every batch and the histogram count matches.
    Timed on the main path's batch (no probe, the apiserver at 0) and on a
    probe batch: the finish and K1 with and without the list by device
    time, the plain version by CUDA events."""
    import torch

    from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.identity import IdentityMap
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG as CFG
    from retina_tpu_torch.models.pipeline import latency_update_plain
    from retina_tpu_torch.u32 import from_numpy

    rng = np.random.default_rng(SEED + 14)
    n_slots, n_buckets = CFG.latency_slots, CFG.latency_buckets
    states = [[torch.zeros(n, dtype=torch.int32, device=dev)
               for n in (n_slots, n_slots, n_buckets)] for _ in range(2)]
    names = ("lat_key", "lat_ts", "lat_hist")
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, N_PODS_GEN)} | {LAT_API: 1},
                                   n_slots=1 << 16, device=dev)
    kst = tel.init_state()
    lane = kops.SCRATCH.index("mask")

    def fused(rec, n_valid, api, lat):
        mask = k1(kst, rec, n_valid, ident, api)[0][lane]
        kops.latency_update(*lat, rec, mask, api)
        return mask

    def both(rec, n_valid, label):
        before = int(states[0][2].sum())
        mask = fused(rec, n_valid, LAT_API, states[0])
        with kops.plain_versions():
            ref_mask = k1(kst, rec, n_valid, ident)[0][lane]
        latency_update_plain(*states[1], rec, ref_mask, LAT_API)
        torch.cuda.synchronize()
        equal_int(mask, ref_mask, f"K1's mask lane ({label})")
        for name, a, b in zip(names, *states):
            equal_int(a, b, f"K14 {name} after {label}")
        print(f"K14 {label}: {int(mask.sum())} rows in the mask, "
              f"{int(states[0][2].sum()) - before} matches", flush=True)

    prev, probe = None, None
    for i in range(LAT_BATCHES):
        rows, prev = latency_probes(host[i % 2], rng, prev)
        rec = from_numpy(rows, dev)
        both(rec, BATCH - BATCH // 8 if i == 2 else BATCH, f"probe batch {i}")
        probe = rec
    check(int(states[0][2].sum()) > 0, "K14: no probe matched")
    cap = TrafficGen(mode="pcap_replay", seed=0)
    before = int(states[0][2].sum())
    for i in range(3):
        both(from_numpy(cap.batch(LAT_CAPTURE_ROWS), dev), LAT_CAPTURE_ROWS,
             f"capture batch {i}")
    check(int(states[0][2].sum()) > before, "K14: no capture row matched")
    print(f"K14 histogram {states[0][2].tolist()}", flush=True)

    st = [t.clone() for t in states[0]]
    main_mask = k1(kst, recs[0], BATCH, ident)[0][lane]
    ms = device_ms(lambda: fused(recs[0], BATCH, 0, st), kernel="finish_kernel")
    k1_list_ms = device_ms(lambda: fused(recs[0], BATCH, 0, st), kernel="step_rows_kernel")
    k1_ms = device_ms(lambda: k1(kst, recs[0], BATCH, ident), kernel="step_rows_kernel")
    plain_ms = time_ms(lambda: latency_update_plain(*st, recs[0], main_mask, 0))
    probe_ms = device_ms(lambda: fused(probe, BATCH, LAT_API, st), kernel="finish_kernel")
    probe_k1_ms = device_ms(lambda: fused(probe, BATCH, LAT_API, st), kernel="step_rows_kernel")
    probe_mask = k1(kst, probe, BATCH, ident)[0][lane]
    probe_plain_ms = time_ms(lambda: latency_update_plain(*st, probe, probe_mask, LAT_API))
    n_probes = BATCH // LAT_EVERY
    print(f"K14 finish (device time): main batch {ms:.4f} ms, probe batch ({n_probes} probes) "
          f"{probe_ms:.4f} ms; K1 listing the probes {k1_list_ms:.4f} ms (probe batch "
          f"{probe_k1_ms:.4f}), without the list {k1_ms:.4f} ms; plain version {plain_ms:.4f} "
          f"ms (probe batch {probe_plain_ms:.4f})", flush=True)
    # The finish reads the list's count and entries (none on the main batch:
    # no row is a probe) and reads and writes the slots and the histogram.
    report("latency_update", "retina_tpu_torch/kernels/csrc/latency.cu",
           "retina_tpu/models/pipeline.py:565", ms, plain_ms,
           4 + 2 * 4 * (2 * n_slots + n_buckets), n_buckets, None, 0.0)


def inv_decode_phase(dev, state, time_ms, report, equal_int) -> None:
    """K15 against its plain version on the invertible path's state after its
    window (both regions in one launch, and each region alone) and on a
    constructed sketch whose buckets weigh 2^31 and more; a close's
    ``Telemetry.inv_decode`` runs K15 and K10 once each and no other kernel;
    both regions timed by device time, back to back and with the L2
    flushed. (The span-summed fold is checked on the time-travel path.)"""
    import torch

    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import INVERTIBLE_CONFIG
    from retina_tpu_torch.ops.invertible import InvertibleSketch
    from retina_tpu_torch.parallel.telemetry import Telemetry
    from retina_tpu_torch.u32 import from_numpy

    def same(invs, label):
        regions = [(inv.planes, inv.weights, inv.seed, t) for t, inv in enumerate(invs)]
        before = kops.launch_counts()["inv_decode"]
        out = kops.inv_decode_many(regions)
        check(kops.launch_counts()["inv_decode"] == before + 1, f"K15 ({label}): not one launch")
        with kops.plain_versions():
            ref = kops.inv_decode_many(regions)
        torch.cuda.synchronize()
        for name, a, b in zip(("keys", "ok", "tier"), out, ref):
            equal_int(a, b, f"K15 {name} ({label})")
        print(f"K15 {label}: {int(out[1].sum())} of {out[1].numel()} buckets decode", flush=True)
        return int(out[1].sum())

    regions = (state.inv_flow, state.inv_hi)
    same(regions, "invertible path, both regions")
    same(regions[:1], "invertible path, inv_flow")
    same(regions[1:], "invertible path, inv_hi")
    rng = np.random.default_rng(SEED + 15)
    big = InvertibleSketch.zeros(2, 1 << 12, n_key_cols=4, seed=9, device=dev)
    keys = from_numpy(rng.integers(0, 1 << 32, (1 << 16, 4), dtype=np.uint64)
                      .astype(np.uint32), dev)
    w = from_numpy(rng.integers(1, 1 << 12, 1 << 16).astype(np.uint32), dev)
    w[:512] = -0x40000000  # 0xC0000000: heavy keys past 2^31
    big.update([keys[:, j] for j in range(4)], w)
    check(bool((big.weights.view(torch.int32) < 0).any()), "K15: no bucket weighs 2^31")
    check(same((big, state.inv_hi), "buckets of 2^31 and more, and inv_hi") > 0,
          "K15: the heavy keys did not decode")

    # A close's decode runs K15 and K10 once each, and nothing else on the card.
    tel = Telemetry(INVERTIBLE_CONFIG, device=dev)
    ran = device_launches(lambda: tel.inv_decode(state))
    print(f"Telemetry.inv_decode on the card: {ran}", flush=True)
    check(sorted(ran.values()) == [1, 1] and any("decode_kernel" in k for k in ran)
          and any("query_kernel" in k for k in ran),
          f"a close's inv_decode ran {ran} on the card (want K15 and K10 once each)")

    # A call's device time is microseconds, below the wrapper's host time:
    # timed, as K8-K13, by device time in torch.profiler, back to back and
    # with the L2 flushed by a 128 MiB write before each call.
    jobs = [(inv.planes, inv.weights, inv.seed, t) for t, inv in enumerate(regions)]
    l2 = torch.empty(32 << 20, dtype=torch.int32, device=dev)

    def k15():
        return kops.inv_decode_many(jobs)

    def plain():
        from retina_tpu_torch.ops.invertible import decode_many_plain

        return decode_many_plain(jobs)

    warm = device_ms(k15, kernel="decode_kernel")
    ms = device_ms(lambda: (l2.zero_(), k15()), kernel="decode_kernel")
    plain_ms = device_ms(plain)
    print(f"inv_decode_many (both regions, one launch): device time {warm:.4f} ms back to "
          f"back, {ms:.4f} ms L2 flushed; CUDA-event span of a call {time_ms(k15):.4f} ms, "
          f"plain {time_ms(plain):.4f} ms", flush=True)
    n_rows = sum(inv.weights.numel() for inv in regions)
    c = regions[0].n_key_cols
    report("inv_decode", "retina_tpu_torch/kernels/csrc/inv_decode.cu",
           "retina_tpu/ops/invertible.py:167", ms, plain_ms,
           sum(4 * (inv.planes.numel() + inv.weights.numel()) for inv in regions)
           + n_rows * (4 * c + 1 + 4),
           sum(inv.planes.numel() * 2 for inv in regions) + n_rows * 2 * (c + 1) * HASH_OPS,
           None, 0.0)


def verify_phase(dev, state, equal_int) -> None:
    """K10's many-job entry at a window close's shape: the query and
    ``decode_verified``'s filter of both regions of the invertible path's
    state in one launch, bit for bit against the plain versions at min_weight
    0, at one that rejects some decoded keys and at 2^31 (the compare is
    unsigned), and with an all-false mask; then its device time beside the
    plain version's and the library call's (``torch.gather`` + ``amin`` on
    indices computed beforehand)."""
    import torch

    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.ops.countmin import indices

    cms = state.flow_hh.cms
    decoded = [(list(c), ok) for c, ok in (
        kops.inv_decode(inv.planes, inv.weights, inv.seed, inv.n_key_cols)
        for inv in (state.inv_flow, state.inv_hi))]

    def verify(min_weight, masks=None):
        return kops.cms_query_many([(cms.table, cms.seed, c, ok if masks is None else masks[i],
                                     min_weight) for i, (c, ok) in enumerate(decoded)])

    est0, ok0 = verify(0)
    verified = torch.unique(est0[ok0])
    check(verified.numel() >= 2, "K10 verify: fewer than two verified estimates")
    rejecting = int(verified[verified.numel() // 2])
    none = [torch.zeros_like(ok) for _, ok in decoded]
    for label, mw, masks in (("min_weight 0", 0, None), (f"min_weight {rejecting}", rejecting,
                                                         None),
                             ("min_weight 2^31", 1 << 31, None), ("all-false mask", 0, none)):
        kops.reset_launch_counts()
        est, ok = verify(mw, masks)
        check(kops.launch_counts()["cms_query"] == 1, f"K10 verify ({label}): not one launch")
        with kops.plain_versions():
            ref_est, ref_ok = verify(mw, masks)
        torch.cuda.synchronize()
        equal_int(est, ref_est, f"K10 verify est ({label})")
        check(torch.equal(ok, ref_ok), f"K10 verify ok ({label}): kernel != plain")
        print(f"K10 verify of both regions ({label}): {int(ok.sum())} of {ok.numel()} rows "
              "verified; est and ok equal to the plain versions", flush=True)
    ms = device_ms(lambda: verify(0), kernel="query_kernel")

    def plain():
        with kops.plain_versions():
            verify(0)

    plain_ms = device_ms(plain)
    cols = [torch.cat([c[j] for c, _ in decoded]) for j in range(len(decoded[0][0]))]
    idx = indices(cms.table, cms.seed, cols)
    lib_ms = device_ms(lambda: torch.gather(cms.table, 1, idx).amin(dim=0))
    print(f"K10 at a close's shape ({ok0.numel()} rows, both regions, one launch): device time "
          f"{ms:.4f} ms (back to back), plain {plain_ms:.4f} ms, torch.gather + amin on "
          f"indices computed beforehand {lib_ms:.4f} ms", flush=True)


TT_WINDOWS = 34  # windows closed on the time-travel path: the 32-slot ring evicts two
FLEET_NODES, NODE_EVENTS, FLEET_EPOCH = 64, 1 << 18, 7
QUERY_TOPK = 32  # k of a range query: the reference agent's default
# Every kernel an invertible engine launches when it is fed, closes windows
# and answers range queries: the step (K1-K6, K14), the packed wire's ingest
# (K7; there is no flow dictionary, so no ingest_new/ingest_known), the
# decode (K15), the fold, join and Count-Min query (K8-K10) and the window
# close (K16).
INVERTIBLE_ENGINE_KERNELS = ("step_rows", "hh_update", "hll_update", "entropy_update",
                             "conntrack", "inv_update", "latency_update", "ingest_packed",
                             "fold", "topk_join", "cms_query", "inv_decode", "window_close")
# What a range query's extract and a fleet rollup add: the span's entropy
# bits (K16's read-only entry) and HLL estimates (K17).
EXTRACT_KERNELS = ("entropy_bits", "hll_estimate")


def same_doc(a, b, what: str) -> None:
    """Nested dicts, lists, tuples, numpy arrays and scalars equal: integers,
    strings and integer arrays exactly; floats (the HLL estimates and entropy
    bits, which K16 and K17 sum in another order than torch) within a
    relative 1e-5."""
    if isinstance(a, dict):
        check(isinstance(b, dict) and set(a) == set(b), f"{what}: keys differ")
        for k in a:
            same_doc(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        check(isinstance(b, (list, tuple)) and len(a) == len(b), f"{what}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same_doc(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        check(isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape,
              f"{what}: arrays differ in type or shape")
        if a.dtype.kind == "f":
            check(bool(np.allclose(a, b, rtol=1e-5, atol=0)), f"{what}: floats differ")
        else:
            check(bool((a == b).all()), f"{what}: arrays differ")
    elif isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        check(abs(a - b) <= 1e-5 * abs(b), f"{what}: {a!r} != {b!r}")
    else:
        check(a == b, f"{what}: {a!r} != {b!r}")


def timetravel_and_fleet(dev, quanta, pods, time_ms, report, results) -> None:
    """The time-travel path (window exports -> the engine's ring -> range
    fold and query) and the fleet path (64 nodes' RFLT frames -> the
    aggregator's merge -> rollup), each with kernels and under the plain
    versions, and K8, K9 and K10 against their plain versions at the
    paths' shapes."""
    import torch

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.synthetic import TrafficGen
    from retina_tpu_torch.fleet.aggregator import FleetAggregator
    from retina_tpu_torch.fleet.codec import FleetSnapshot, decode_snapshot, encode_snapshot
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.timetravel.fold import (
        fold_stacked,
        host_arrays,
        range_decode,
        range_extract,
        range_topk,
        stack_slots,
    )
    from retina_tpu_torch.timetravel.query import QueryService
    from retina_tpu_torch.u32 import from_numpy

    def sync_ms(fn):
        """(result, host ms) of one call, the card synchronised around it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # -- the time-travel path --------------------------------------------------
    tcfg = Config(heavy_keys_source="invertible", timetravel_enabled=True)
    kops.reset_launch_counts()
    eng = SketchEngine(tcfg, device=dev)
    eng.update_identities(pods)
    ring = eng.timetravel_ring
    close_k10 = [0]

    def feed_and_close():
        for i in range(TT_WINDOWS):
            eng.flush(quanta[i % 3], 300 + i)
            before = kops.launch_counts()["cms_query"]
            eng.close_window(epoch=i)
            close_k10[0] += kops.launch_counts()["cms_query"] - before
            check(ring.drain(60.0), f"ring readback of window {i}")

    _, feed_ms = sync_ms(feed_and_close)
    st = ring.stats()
    check((st["depth"], st["appended"], st["evicted"], ring.dropped) == (32, TT_WINDOWS, 2, 0),
          f"time-travel ring: {st}, dropped {ring.dropped}")
    svc = QueryService(tcfg, device=dev)
    svc.add_ring(ring)
    k = QUERY_TOPK
    docs = {}
    for n in (1, 8, 32):
        docs[n], ms = sync_ms(lambda: svc._query(ring, TT_WINDOWS - n, TT_WINDOWS, k, "flow"))
        print(f"time-travel query over {n} windows: {ms:.3f} ms (first call)", flush=True)
    tt_launches = kops.launch_counts()
    print(f"time-travel path launches: {tt_launches}", flush=True)
    check(close_k10[0] == TT_WINDOWS, f"time-travel path: {close_k10[0]} K10 launches in "
          f"{TT_WINDOWS} closes (one a close)")
    query_k10 = tt_launches["cms_query"] - close_k10[0]
    check_sketch_launches(tt_launches, "time-travel path")
    for name in INVERTIBLE_ENGINE_KERNELS + EXTRACT_KERNELS:
        check(tt_launches[name] > 0, f"{name} was not launched on the time-travel path")
    for n, doc in docs.items():
        with kops.plain_versions():
            ref = svc._query(ring, TT_WINDOWS - n, TT_WINDOWS, k, "flow")
        same_doc(doc, ref, f"time-travel query over {n} windows")
        check(doc["windows"] == n and doc["epochs"] == list(range(TT_WINDOWS - n, TT_WINDOWS)),
              f"time-travel query over {n} windows: epochs")
        check(len(doc["topk"]["keys"]) == k and doc["decode"]["n_keys"] > 0,
              f"time-travel query over {n} windows: empty answer")
        check(np.isfinite(doc["cardinality"]) and doc["cardinality"] > 0,
              f"time-travel query over {n} windows: cardinality")
    check(kops.launch_counts() == tt_launches, "the plain time-travel queries launched kernels")
    print(f"time-travel path: {TT_WINDOWS} windows fed and closed in {feed_ms:.1f} ms; "
          f"32-window cardinality {docs[32]['cardinality']:.0f}, entropy bits "
          f"{docs[32]['entropy_bits']}, {docs[32]['decode']['n_keys']} decoded keys", flush=True)

    # The 32-window query by stage (warm: a second call).
    slots = ring.select(TT_WINDOWS - 32, TT_WINDOWS)
    arrays32, seeds = [s[1] for s in slots], slots[0][3]
    names = sorted(arrays32[0])
    for attempt in ("cold", "warm"):
        stacked32, stack_ms = sync_ms(lambda: stack_slots(arrays32, names, dev))
        merged_dev, fold_ms = sync_ms(lambda: fold_stacked(stacked32))
        merged, back_ms = sync_ms(lambda: host_arrays(merged_dev))
        extras, extract_ms = sync_ms(lambda: range_extract(merged, seeds, dev))
        dec, decode_ms = sync_ms(lambda: range_decode(merged, seeds, dev))
        _, topk_ms = sync_ms(lambda: range_topk(merged, seeds, k=k, est=extras["flow_est"],
                                                device=dev))
        _, query_ms = sync_ms(lambda: svc._query(ring, TT_WINDOWS - 32, TT_WINDOWS, k, "flow"))
    # K15 on the span-summed planes of the 32-window fold: both regions in one
    # launch, as range_decode runs it.
    span_regions = [(from_numpy(merged[f"{region}_planes"], dev),
                     from_numpy(merged[f"{region}_weights"], dev), seeds[region], tier)
                    for tier, region in enumerate(("inv_flow", "inv_hi"))]
    out = kops.inv_decode_many(span_regions)
    with kops.plain_versions():
        ref = kops.inv_decode_many(span_regions)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, ref)),
          "K15 != plain on the 32-window fold's two regions")
    print(f"K15 on the 32-window fold's two regions: {int(out[1].sum())} of {out[1].numel()} "
          f"buckets decode, heaviest bucket "
          f"{max(int(merged[f'{r}_weights'].max()) for r in ('inv_flow', 'inv_hi'))}", flush=True)
    # K9 on the 32-window fold's stacked candidate tables, the three families
    # in one launch.
    fams32 = [(stacked32[f"{fam}_keys"], stacked32[f"{fam}_counts"])
              for fam in ("flow", "svc", "dns")]
    out = kops.topk_join_many(fams32)
    with kops.plain_versions():
        ref = kops.topk_join_many(fams32)
    torch.cuda.synchronize()
    check(all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(out, ref)),
          "K9 != plain on the 32-window fold's three families")
    print("K9 on the 32-window fold's three families (slots, key columns): "
          f"{[tuple(k.shape[1:]) for k, _ in fams32]}: equal to the plain version", flush=True)
    stacked_bytes = sum(x.numel() * x.element_size() for x in stacked32.values())
    # totals are cumulative over the engine's life: the newest slot holds every
    # event fed, and the fold their sum over the 32 slots.
    check(int(arrays32[-1]["totals"][0]) == TT_WINDOWS * QUANTUM,
          "newest ring slot: totals[0] != events fed")
    check(int(merged["totals"][0]) == QUANTUM * sum(range(TT_WINDOWS - 31, TT_WINDOWS + 1))
          % (1 << 32), "32-window fold: totals[0] != the slots' sum")
    # Row 11g, the span's estimates besides the CMS query: the folded HLL
    # registers and entropy counts read once; the few floats out are noise.
    est_bytes = merged["hll_flows"].nbytes + merged["entropy"].nbytes
    print(f"row 11g (cardinality and entropy bits of the span): bound "
          f"{est_bytes / HBM_BYTES_PER_S * 1e3:.7f} ms ({est_bytes} bytes: hll_flows "
          f"{merged['hll_flows'].shape} u32 and entropy {merged['entropy'].shape} f32 read "
          f"once)", flush=True)
    print(f"time-travel 32-window query (warm): {stacked_bytes} bytes stacked; stack + copy "
          f"{stack_ms:.3f} ms, K8/K9 {fold_ms:.3f} ms, readback {back_ms:.3f} ms, extract "
          f"{extract_ms:.3f} ms, decode {decode_ms:.3f} ms, top-k {topk_ms:.3f} ms; the whole "
          f"query {query_ms:.3f} ms", flush=True)
    eng.stop()
    del eng, ring, svc

    # -- the fleet path ----------------------------------------------------------------
    fcfg = Config(heavy_keys_source="invertible", fleet_enabled=True)
    acfg = Config(fleet_expected_nodes=FLEET_NODES)
    kops.reset_launch_counts()
    eng = SketchEngine(fcfg, device=dev)
    eng.update_identities(pods)
    frames = []
    t0 = time.perf_counter()
    for i in range(FLEET_NODES):
        gen = TrafficGen(n_flows=N_FLOWS, n_pods=N_PODS_GEN, seed=i)
        # A fresh node, one engine reused; made on the engine's stream.
        eng.states = eng._proxy.run(eng.telemetry.init_state)
        eng.flush(np.split(gen.batch(NODE_EVENTS), NODE_EVENTS // BLOCK), 500)
        before = kops.launch_counts()
        epoch, arrays, window_s, seeds = eng.close_window(epoch=FLEET_EPOCH)["export"]
        after = kops.launch_counts()
        check(after["cms_query"] - before["cms_query"] == 1
              and after["inv_decode"] - before["inv_decode"] == 1,
              f"fleet node {i}: a close launched K10 {after['cms_query'] - before['cms_query']}"
              f" and K15 {after['inv_decode'] - before['inv_decode']} times (want 1 and 1)")
        first_half = i < FLEET_NODES // 2
        frames.append(encode_snapshot(FleetSnapshot(
            node=f"node-{i:02d}", tenant="tenant-a" if first_half else "tenant-b",
            priority=int(first_half), epoch=epoch, seq=1, window_s=window_s, seeds=seeds,
            arrays=host_arrays(arrays))))
    nodes_s = time.perf_counter() - t0
    node_k10 = kops.launch_counts()["cms_query"]
    late = encode_snapshot(dataclasses.replace(decode_snapshot(frames[1]),
                                               epoch=FLEET_EPOCH - 1))
    print(f"fleet path: {FLEET_NODES} nodes of {NODE_EVENTS} events fed, closed and encoded in "
          f"{nodes_s:.1f} s; frame {len(frames[0])} bytes a node", flush=True)

    def aggregate():
        agg = FleetAggregator(acfg, device=dev)
        for f in frames[:-1]:
            check(agg.ingest(f), "a fleet frame was refused")
        check(not agg.ingest(frames[0]), "a duplicate frame was accepted")
        check(agg.ingest(frames[-1]), "the quorum frame was refused")
        check(not agg.ingest(late), "a late frame was accepted")
        want = dict.fromkeys(agg.dropped, 0) | {"duplicate": 1, "late": 1}
        check(agg.dropped == want, f"fleet drops {agg.dropped}")
        check((agg.epochs_merged, agg.merge_errors, agg.invertible_decode_failed) == (1, 0, 0),
              "fleet merge failed")
        rollup = dict(agg.rollups[-1])
        rollup.pop("merge_seconds")
        return rollup

    rollup, agg_cold_ms = sync_ms(aggregate)
    fleet_launches = kops.launch_counts()
    print(f"fleet path launches: {fleet_launches}", flush=True)
    check_sketch_launches(fleet_launches, "fleet path")
    for name in INVERTIBLE_ENGINE_KERNELS + EXTRACT_KERNELS:
        check(fleet_launches[name] > 0, f"{name} was not launched on the fleet path")
    with kops.plain_versions():
        ref = aggregate()
    check(kops.launch_counts() == fleet_launches, "the plain fleet merge launched kernels")
    same_doc(rollup, ref, "fleet rollup")
    check(int(rollup["totals"][0]) == FLEET_NODES * NODE_EVENTS, "fleet totals[0] != events fed")
    check(len(rollup["nodes"]) == FLEET_NODES and set(rollup["tenants"]) == {"tenant-a",
                                                                              "tenant-b"},
          "fleet rollup nodes or tenants")
    check(len(rollup["top_flow"][0]) == acfg.fleet_topk_k and len(rollup["invertible"]["keys"]),
          "fleet rollup: no heavy flows")
    check(np.isfinite(rollup["distinct_flows"]) and rollup["distinct_flows"] > 0,
          "fleet distinct flows")
    _, agg_ms = sync_ms(aggregate)  # warm: the fleet-merge latency
    print(f"fleet rollup: {len(rollup['invertible']['keys'])} decoded keys, distinct flows "
          f"{rollup['distinct_flows']:.0f}, entropy bits {rollup['entropy_bits']}; the "
          f"aggregation of {FLEET_NODES + 2} frames, frames in to rollup out: "
          f"{agg_ms:.3f} ms warm ({agg_cold_ms:.3f} ms cold)", flush=True)

    # The merge by stage (warm: a second pass).
    agg = FleetAggregator(acfg, device=dev)
    for attempt in ("cold", "warm"):
        snaps, decode_ms = sync_ms(lambda: sorted((decode_snapshot(f) for f in frames),
                                                  key=lambda s: s.node))
        names = sorted(snaps[0].arrays)
        stacked64, stack_ms = sync_ms(lambda: stack_slots([s.arrays for s in snaps], names, dev))
        merged64, merge_ms = sync_ms(lambda: fold_stacked(stacked64))
        _, rollup_ms = sync_ms(lambda: agg._rollup(FLEET_EPOCH, snaps, merged64, snaps[0].seeds))
    stacked_bytes = sum(x.numel() * x.element_size() for x in stacked64.values())
    print(f"fleet merge of {FLEET_NODES} frames (warm): decode {decode_ms:.3f} ms, stack + copy "
          f"{stack_ms:.3f} ms ({stacked_bytes} bytes), merge kernels {merge_ms:.3f} ms, rollup "
          f"{rollup_ms:.3f} ms", flush=True)

    # -- K8, K9, K10 against their plain versions, timed --------------------------------
    def fold_ops(stacked):
        return [(x, "max_u32" if n.startswith("hll_") else
                 "sum_f32" if x.dtype == torch.float32 else "sum_u32")
                for n, x in stacked.items() if not n.endswith(("_keys", "_counts"))]

    check(tt_launches["fold"] == len(docs),
          f"K8: {tt_launches['fold']} launches for {len(docs)} range queries (one a fold)")
    check(tt_launches["topk_join"] == len(docs),
          f"K9: {tt_launches['topk_join']} launches for {len(docs)} range queries (one a fold)")
    check(fleet_launches["topk_join"] == 1,
          f"K9: {fleet_launches['topk_join']} launches for the fleet path's one merge")
    rng = np.random.default_rng(SEED)
    for label, stacked, n_slots, launches in (
            (f"fold ({len(arrays32)} ring slots)", stacked32, len(arrays32), tt_launches["fold"]),
            (f"fold ({FLEET_NODES} nodes)", stacked64, FLEET_NODES, fleet_launches["fold"])):
        ops = fold_ops(stacked)
        # An array of odd length besides the catalog: its slots but every 4th
        # lie off a 16-byte boundary, so the kernel folds it by scalar loads,
        # with a tail.
        odd = from_numpy(rng.integers(0, 1 << 32, (n_slots, 4099), dtype=np.uint64)
                         .astype(np.uint32), dev)
        checked = ops + [(odd, "sum_u32")]
        kops.reset_launch_counts()
        outs = kops.fold_many(checked)
        check(kops.launch_counts()["fold"] == 1, f"K8 {label}: fold_many took more than a launch")
        with kops.plain_versions():
            wants = [kops.fold(x, op) for x, op in checked]
        torch.cuda.synchronize()
        for (x, op), out, want in zip(checked, outs, wants):
            check(torch.equal(out.view(torch.int32), want.view(torch.int32)),
                  f"K8 {label} {op} of shape {tuple(x.shape)}: kernel != plain")
        del odd, checked, outs, wants

        def kernel():
            return kops.fold_many(ops)

        def per_array():
            return [kops.fold(x, op) for x, op in ops]

        def library():
            return [torch.amax(x, 0) if op == "max_u32" else torch.sum(x, 0, dtype=x.dtype)
                    for x, op in ops]

        ms = device_ms(kernel, kernel="fold_kernel")
        per_array_ms = device_ms(per_array, kernel="fold_kernel")
        with kops.plain_versions():
            plain_ms = device_ms(kernel)
            plain_span = time_ms(kernel)
        lib_ms = device_ms(library)
        n_elems = sum(x[0].numel() for x, _ in ops)
        report(label, "retina_tpu_torch/kernels/csrc/fold.cu",
               "retina_tpu/timetravel/fold.py:102" if stacked is stacked32
               else "retina_tpu/fleet/aggregator.py:328",
               ms, plain_ms, 4 * n_elems * (n_slots + 1), n_elems * n_slots, lib_ms, 0.0)
        results[-1]["launches"] = launches
        print(f"{label}: {len(ops)} arrays, {n_elems} elements a slot; device time of one "
              f"fold_many launch {ms:.4f} ms, of {len(ops)} one-array launches {per_array_ms:.4f} "
              f"ms; CUDA-event span of a fold_many call {time_ms(kernel):.4f} ms, of the "
              f"{len(ops)} one-array calls {time_ms(per_array):.4f}, plain {plain_span:.4f}, "
              f"library {time_ms(library):.4f}", flush=True)

    # K9 on the 64-node epoch's three families, in one launch; timed by device
    # time back to back and with the L2 flushed by a 128 MiB write.
    fams64 = [(stacked64[f"{fam}_keys"], stacked64[f"{fam}_counts"])
              for fam in ("flow", "svc", "dns")]
    out = kops.topk_join_many(fams64)
    with kops.plain_versions():
        want = kops.topk_join_many(fams64)
    torch.cuda.synchronize()
    check(all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(out, want)),
          "K9: kernel != plain on the 64-node epoch's three families")
    l2 = torch.empty(32 << 20, dtype=torch.int32, device=dev)

    def join():
        return kops.topk_join_many(fams64)

    warm = device_ms(join, kernel="join_kernel")
    ms = device_ms(lambda: (l2.zero_(), join()), kernel="join_kernel")
    with kops.plain_versions():
        plain_ms = device_ms(join)
        plain_span = time_ms(join)
    report("topk_join", "retina_tpu_torch/kernels/csrc/topk_join.cu",
           "retina_tpu/ops/topk.py:107", ms, plain_ms,
           sum(4 * s * (c + 1) * (n + 1) for n, s, c in (k.shape for k, _ in fams64)),
           sum(n * s * (c + 1) for n, s, c in (k.shape for k, _ in fams64)), None, 0.0)
    results[-1]["launches"] = fleet_launches["topk_join"]
    print(f"topk_join_many (the three families of {FLEET_NODES} nodes, one launch): device "
          f"time {warm:.4f} ms back to back, {ms:.4f} ms L2 flushed; CUDA-event span of a call "
          f"{time_ms(join):.4f} ms, plain {plain_span:.4f}", flush=True)
    del l2

    cand = [sn.arrays["flow_keys"][sn.arrays["flow_counts"] > 0] for sn in snaps]
    union = from_numpy(np.unique(np.concatenate(cand), axis=0), dev)
    cols = [union[:, j] for j in range(union.shape[1])]
    table, seed = merged64["flow_cms"], snaps[0].seeds["flow"]
    out = kops.cms_query(table, seed, cols)
    with kops.plain_versions():
        want = kops.cms_query(table, seed, cols)
    torch.cuda.synchronize()
    check(torch.equal(out, want), "K10: kernel != plain")
    # The rollup's jobs in one launch: the union (a row-major (R, 4) tensor),
    # and the merged epoch's two decoded regions with their masks, at
    # min_weight 0 and 2^31.
    regions = []
    for name in ("inv_flow", "inv_hi"):
        planes, weights = merged64[f"{name}_planes"], merged64[f"{name}_weights"]
        c, ok = kops.inv_decode(planes, weights, snaps[0].seeds[name],
                                planes.shape[2] // 32 - 1)
        regions.append((list(c), ok))
    for mw in (0, 1 << 31):
        jobs = [(table, seed, cols, None, 0)] + [(table, seed, c, ok, mw) for c, ok in regions]
        kops.reset_launch_counts()
        est, ok = kops.cms_query_many(jobs)
        check(kops.launch_counts()["cms_query"] == 1, "K10: cms_query_many took more than a launch")
        with kops.plain_versions():
            ref_est, ref_ok = kops.cms_query_many(jobs)
        torch.cuda.synchronize()
        check(torch.equal(est, ref_est) and torch.equal(ok, ref_ok),
              f"K10 cms_query_many (the union and the epoch's regions, min_weight {mw}): "
              "kernel != plain")
        check(torch.equal(est[: union.shape[0]], out), "K10: the union's job != cms_query")
        print(f"K10 cms_query_many, the union and the merged epoch's two regions in one launch "
              f"(min_weight {mw}): {int(ok[union.shape[0]:].sum())} decoded keys verified; "
              "equal to the plain versions", flush=True)

    def query():
        return kops.cms_query(table, seed, cols)

    ms = device_ms(query, kernel="query_kernel")
    with kops.plain_versions():
        plain_ms = device_ms(query)
        plain_span = time_ms(query)
    from retina_tpu_torch.ops.countmin import indices

    idx = indices(table, seed, cols)
    gather_ms = device_ms(lambda: torch.gather(table, 1, idx).amin(dim=0))
    (r, c), (d, w) = union.shape, table.shape
    # The key columns and the answers cross HBM once; the table at most once
    # (a 512 KiB table stays in L2 while its rows are gathered).
    report("cms_query", "retina_tpu_torch/kernels/csrc/cms_query.cu",
           "retina_tpu/timetravel/fold.py:163", ms, plain_ms,
           r * c * 4 + min(d * w, r * d) * 4 + r * 4, r * d * c * HASH_OPS, gather_ms, 0.0)
    results[-1]["launches"] = fleet_launches["cms_query"]
    print(f"cms_query: CUDA-event span of a call {time_ms(query):.4f} ms, plain "
          f"{plain_span:.4f}", flush=True)
    print(f"K10 note: {r} candidate rows of {FLEET_NODES} nodes; torch.gather + amin on "
          f"indices computed beforehand, device time {gather_ms:.4f} ms (two calls)",
          flush=True)
    rollup_k10 = fleet_launches["cms_query"] - node_k10
    print(f"cms_query launches by path: node close {node_k10} over {FLEET_NODES} closes "
          f"(fleet path), rollup {rollup_k10} (the fleet path's merge of one epoch), range "
          f"query {query_k10} over {len(docs)} queries (time-travel path, besides its "
          f"{close_k10[0]} closes); the kernels line counts the fleet path's "
          f"{fleet_launches['cms_query']}", flush=True)


DET_WINDOW = 1 << 16  # benign events a window on the detection path: the tap's cap
DET_BENIGN0, DET_AFTER = 12, 3  # benign windows before the attacks and after each
DET_ATTACKS = (  # (detector expected to win, TrafficGen attack method, events, its options)
    ("portscan", "portscan_batch", 1 << 15, {"n_scanners": 4, "n_ports": 24}),
    ("dnstunnel", "tunnel_batch", 1 << 15, {"n_clients": 48}),
    ("synflood", "ddos_batch", 98_304, {"n_sources": 48}),  # the dryrun's burst
)
# Every kernel the detection path launches: those of the time-travel and
# fleet paths and the bank's (K11 and the bank's close).
DETECTION_KERNELS = INVERTIBLE_ENGINE_KERNELS + ("portscan_score", "bank_close")
BANK_KNOBS = (8.0, 3, 0.1)  # the bank's z_thresh, min_windows and EWMA alpha (Config())
CAPTURE_ATTACK_ROWS = 768  # attack rows in each block of the live stream a capture reads
ATTACK_NET = {"portscan": 0xC9, "dnstunnel": 0xCA, "synflood": 0xC0}  # the attack sources' /8


def detection_schedule(gen):
    """The detection path's traffic, drawn from ``gen`` in order: DET_BENIGN0
    benign windows, then each attack of DET_ATTACKS appended to a benign
    window's events and followed by DET_AFTER benign windows. Returns
    (windows, attack_at, attack_rows): each window as record blocks of at
    most about BLOCK rows, each attack window's (detector, method, options)
    and its attack rows."""
    windows, attack_at, attack_rows = [], {}, {}
    for _ in range(DET_BENIGN0):
        windows.append([gen.batch(DET_WINDOW)])
    for name, method, n, kw in DET_ATTACKS:
        e = len(windows)
        attack_at[e] = (name, method, kw)
        benign = gen.batch(DET_WINDOW)
        attack_rows[e] = getattr(gen, method)(n, **kw)
        windows.append([benign, attack_rows[e]])
        for _ in range(DET_AFTER):
            windows.append([gen.batch(DET_WINDOW)])
    windows = [[b for blk in w for b in np.array_split(blk, max(1, len(blk) // BLOCK))]
               for w in windows]
    return windows, attack_at, attack_rows


def detection_loop(dev, quanta, pods, time_ms, report, results) -> None:
    """The detection path: K11, the bank's close and K12, K13 alone against
    their plain versions at the tap's largest shapes, then the closed loop at the deployed width (the
    engine's record tap -> the detector bank -> arbitration -> AutoCapture
    -> range decode -> a replay capture of the attributed hosts) with
    kernels and under the plain versions, and the tap's share of a
    bench-scale quantum."""
    import tempfile

    import torch

    from retina_tpu_torch.capture.manager import CaptureManager
    from retina_tpu_torch.capture.providers import ReplayProvider
    from retina_tpu_torch.config import Config
    from retina_tpu_torch.detect import build_default_bank, features, programs
    from retina_tpu_torch.detect.base import MAX_WINDOW_RECORDS
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.schema import F, u32_to_ip
    from retina_tpu_torch.events.synthetic import TrafficGen, preset_params
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.ops import entropy
    from retina_tpu_torch.parallel.combine import combine_blocks
    from retina_tpu_torch.sources.pcapdecode import _decode_pcap_numpy
    from retina_tpu_torch.timetravel.autocapture import AutoCapture
    from retina_tpu_torch.timetravel.query import QueryService
    from retina_tpu_torch.u32 import from_numpy

    t_phase = time.perf_counter()

    def bench_gen(seed=SEED, **kw):
        return TrafficGen(n_flows=N_FLOWS, n_pods=N_PODS_GEN, seed=seed, **kw)

    # -- K11, the bank's close, K12 and K13 at the tap's largest shapes --------
    scan = bench_gen(**preset_params("portscan"))
    k11_in = {}
    one = scan.batch(DET_WINDOW)
    one[:, F.SRC_IP] = 0x0A000001  # every source in one hash-group: one block's registers
    for label, rows in (("P = 2^16", scan.batch(DET_WINDOW)), ("P = 2^6, padded", scan.batch(40)),
                        ("P = 2^16, one group", one)):
        keys, w = features.padded_flow_keys(rows)
        k11_in[label] = (from_numpy(keys, dev), from_numpy(w, dev))
    for label, (keys, _) in k11_in.items():
        blocks = kops.portscan_cluster(programs.PORTSCAN_GROUPS, programs.PORTSCAN_PRECISION,
                                       keys.shape[0])
        print(f"K11 {label}: a cluster of {blocks} blocks", flush=True)
    hist_np = features.qname_length_hist(
        bench_gen(**preset_params("dns_flood")).batch(DET_WINDOW))
    lanes_np = features.tcpflag_lanes(bench_gen(**preset_params("syn_storm")).batch(DET_WINDOW))
    hist, lanes = from_numpy(hist_np, dev), from_numpy(lanes_np, dev)
    errs = {}
    for label, (keys, w) in k11_in.items():
        out = programs.portscan_program(keys, w)
        with kops.plain_versions():
            ref = programs.portscan_program(keys, w)
        check(bool(torch.allclose(out, ref, rtol=1e-5, atol=0)), f"K11 ({label}): kernel != plain")
        errs["portscan_score"] = max(errs.get("portscan_score", 0.0),
                                     float((out - ref).abs().max()))
        print(f"K11 {label}: estimates max {float(out.max()):.3f} (kernel), "
              f"{float(ref.max()):.3f} (plain)", flush=True)
    out = programs.dnstunnel_program(hist)
    with kops.plain_versions():
        ref = programs.dnstunnel_program(hist)
    check(bool(torch.allclose(out, ref, rtol=1e-5, atol=0)), "K12 alone: kernel != plain")
    print(f"K12 alone, dns_flood histogram: {out.tolist()} (kernel), {ref.tolist()} (plain)",
          flush=True)
    out = programs.synflood_program(lanes)
    with kops.plain_versions():
        ref = programs.synflood_program(lanes)
    check(bool(torch.equal(out, ref)), "K13 alone: kernel != plain (must be bit-equal)")
    print(f"K13 alone, syn_storm lanes: {out.tolist()}", flush=True)

    # The bank's close: 8 closes of the three built-ins from a zero state,
    # the features perturbed from a seed, the last an outlier in every slot.
    sweep = np.concatenate([bench_gen(seed=SEED + 3).batch(DET_WINDOW // 2),
                            bench_gen(seed=SEED + 4).portscan_batch(
                                DET_WINDOW // 2, n_scanners=4, n_ports=24)])
    skeys, sw = features.padded_flow_keys(sweep)
    est = programs.portscan_program(from_numpy(skeys, dev), from_numpy(sw, dev))
    rng = np.random.default_rng(SEED)

    def bank_slots(h, e, lanes_):
        return [(kops.BANK_DNSTUNNEL, h, *BANK_KNOBS), (kops.BANK_PORTSCAN, e, *BANK_KNOBS),
                (kops.BANK_SYNFLOOD, lanes_, *BANK_KNOBS)]

    io = kops.BankCloseIO(dev)
    state = [torch.zeros(3, device=dev) for _ in range(3)]
    ref_state = [torch.zeros(3, device=dev) for _ in range(3)]
    flagged = []
    errs["bank_close"] = 0.0
    for t in range(8):
        h = np.round(hist_np * rng.uniform(0.8, 1.2, hist_np.shape)).astype(np.float32)
        l_t = lanes_np.copy()
        l_t[1] = np.round(l_t[1] * rng.uniform(0.9, 1.1))
        e_t = est * float(rng.uniform(0.9, 1.1))
        if t == 7:
            h = np.full_like(hist_np, np.round(hist_np.sum() / hist_np.size))
            l_t[1] *= 20
            e_t = e_t * 10
        slots = bank_slots(h, e_t, l_t)
        got = kops.bank_close(slots, *state, io=io)
        with kops.plain_versions():
            want = kops.bank_close(slots, *ref_state)
        torch.cuda.synchronize()
        check(torch.equal(got[2], want[2]), f"bank close {t}: flags {got[2]} != {want[2]}")
        check(bool(torch.allclose(got[0], want[0], rtol=1e-5, atol=0)),
              f"bank close {t}: scores {got[0]} != {want[0]}")
        check(float((got[1] - want[1]).abs().max()) <= 1e-4,
              f"bank close {t}: z {got[1]} != {want[1]}")
        check(bool(torch.allclose(state[0], ref_state[0], rtol=1e-5, atol=0))
              and float((state[1] - ref_state[1]).abs().max()) <= 1e-6
              and torch.equal(state[2], ref_state[2]),
              f"bank close {t}: EWMA state {state} != {ref_state}")
        errs["bank_close"] = max(errs["bank_close"], float((got[0] - want[0]).abs().max()),
                                 float((got[1] - want[1]).abs().max()))
        flagged.append(got[2].tolist())
    check(flagged[-1] == [True] * 3 and not any(any(f) for f in flagged[:-1]),
          f"bank close: flags by close {flagged} (only the outlier must flag)")
    print(f"bank close: 8 closes equal to the plain version's (max abs err "
          f"{errs['bank_close']}), scores {got[0].tolist()}, z {got[1].tolist()} at the "
          f"outlier", flush=True)

    keys, w = k11_in["P = 2^16"]
    p_rows = keys.shape[0]
    p = hist / hist.sum()
    bank_in = bank_slots(hist_np, est, lanes_np)
    # K11's library call: scatter_reduce_ amax of each row's rank into a zero
    # register bank at its (group, register), both computed beforehand.
    from retina_tpu_torch.ops.hashing import _mul32, hash_cols
    from retina_tpu_torch.u32 import widen

    m = 1 << programs.PORTSCAN_PRECISION
    hk = widen(hash_cols([keys[:, 3]], (0xC0FFEE + programs.PORTSCAN_SEED) & 0xFFFFFFFF))
    grp = _mul32(widen(keys[:, 0]), programs.GROUP_MUL) % programs.PORTSCAN_GROUPS
    rest = hk >> programs.PORTSCAN_PRECISION
    hsb = torch.where(rest > 0, torch.floor(torch.log2(rest.double().clamp(min=1))).long(), -1)
    flat = (grp * m + (hk & (m - 1)))[w > 0]
    rank = (32 - programs.PORTSCAN_PRECISION - hsb).to(torch.int32)[w > 0]
    bank = torch.zeros(programs.PORTSCAN_GROUPS * m, dtype=torch.int32, device=dev)
    for name, fn, kernel, nbytes, ops, lib in (
            ("portscan_score", lambda: programs.portscan_program(keys, w), "portscan_kernel",
             p_rows * 20 + programs.PORTSCAN_GROUPS * 4, p_rows * (HASH_OPS + 12),
             lambda: bank.zero_().scatter_reduce_(0, flat, rank, "amax")),
            ("bank_close", lambda: kops.bank_close(bank_in, *state, io=io), "bank_close_kernel",
             # the features and the EWMA state read once, the state and rows written once
             4 * (hist.numel() + 9 + est.numel()) + 2 * 3 * 3 * 4 + 3 * kops.BANK_ROW * 4,
             hist.numel() * 6 + 9 + est.numel() + 3 * 16,
             lambda: torch.special.entr(p).sum())):
        ms = device_ms(fn, kernel=kernel)
        with kops.plain_versions():
            plain_ms = device_ms(fn)
        lib_ms = device_ms(lib) if lib else None
        report(name, "retina_tpu_torch/kernels/csrc/detect.cu",
               {"portscan_score": "retina_tpu/detect/programs.py:51",
                "bank_close": "retina_tpu/detect/programs.py:78 and :100"}[name],
               ms, plain_ms, nbytes, ops, lib_ms, errs[name])
        print(f"{name}: CUDA-event span of a call {time_ms(fn):.4f} ms", flush=True)
    print("K11 library: scatter_reduce_ amax of the ranks into a zeroed register bank at "
          "(group, register) computed beforehand, two calls (no PyTorch call computes the "
          "estimate); bank close library: torch.special.entr + sum on p computed beforehand, "
          "two calls (the dnstunnel score alone; no PyTorch call computes the close)",
          flush=True)

    # -- the closed loop at the deployed width -------------------------------------------
    windows, attack_at, attack_rows = detection_schedule(bench_gen())
    n_events = sum(len(b) for w in windows for b in w)
    print(f"detection path traffic: {len(windows)} windows, {n_events} events, attacks at "
          f"{ {e: a[0] for e, a in attack_at.items()} }", flush=True)

    def loop_run(plain: bool) -> dict:
        out_dir = tempfile.mkdtemp(prefix="retina-autocapture-")
        cfg = Config(heavy_keys_source="invertible", timetravel_enabled=True,
                     autocapture_cooldown_s=0, autocapture_duration_s=1,
                     autocapture_output_dir=out_dir)
        eng = SketchEngine(cfg, device=dev)
        eng.update_identities(pods)
        qs = QueryService(cfg, device=dev)
        qs.add_ring(eng.timetravel_ring)
        cgen = bench_gen(seed=SEED + 1)
        live = {"attack": None}

        def capture_source():
            """The live record stream during a capture: background and the
            attack still in flight."""
            return np.concatenate([cgen.batch(256), live["attack"](cgen)])

        ac = AutoCapture(cfg, qs, manager=CaptureManager(ReplayProvider(source=capture_source)))
        notified = {}
        notify = ac.notify

        def timed_notify(epoch, dims):
            ok = notify(epoch, dims)
            if ok:
                notified.setdefault(epoch, time.perf_counter())
            return ok

        ac.notify = timed_notify
        ac.start()
        bank = build_default_bank(cfg, sink=ac.notify, device=dev)
        close = bank._close
        t = {"tap": 0.0, "close": [], "scores": [], "ewma_calls": 0}
        observe = entropy.AnomalyEWMA.observe

        def timed_close(epoch, now_s):
            """The close, timed, with its AnomalyEWMA.observe calls counted."""
            calls = []
            entropy.AnomalyEWMA.observe = lambda *a, **kw: (calls.append(1),
                                                            observe(*a, **kw))[1]
            t0 = time.perf_counter()
            try:
                got = close(epoch, now_s)
            finally:
                entropy.AnomalyEWMA.observe = observe
            t["close"].append(time.perf_counter() - t0)
            t["ewma_calls"] += len(calls)
            t["scores"].append(dict(bank.detector_score))
            return got

        bank._close = timed_close
        cur = [0]
        hooks, fired = [], []

        def tap(records, now_s):
            t0 = time.perf_counter()
            fired.extend(bank.observe(cur[0], records, now_s=float(now_s)))
            t["tap"] += time.perf_counter() - t0

        def anomaly(epoch, dims):
            hooks.append((epoch, tuple(dims)))
            ac.notify(epoch, dims)

        eng.record_hook, eng.anomaly_hook = tap, anomaly
        done_at = {}

        def settle(epoch):
            """Wait until every queued capture has finished."""
            deadline = time.perf_counter() + 120.0
            while time.perf_counter() < deadline:
                with ac._lock:
                    idle = ac._q.empty() and ac.autocapture_triggered == (
                        ac.autocapture_completed + ac.autocapture_failed
                        + ac.autocapture_suppressed["no_keys"])
                if idle:
                    break
                time.sleep(0.005)
            check(idle, f"detection path: captures of epoch {epoch} did not finish")
            done_at[epoch] = time.perf_counter()

        ctx = kops.plain_versions() if plain else contextlib.nullcontext()
        kops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            for i, blocks in enumerate(windows):
                cur[0] = i
                if i in attack_at:
                    _, method, kw = attack_at[i]
                    live["attack"] = lambda g, m=method, kw=kw: getattr(g, m)(
                        CAPTURE_ATTACK_ROWS, **kw)
                eng.flush(blocks, 1000 + i)
                eng.close_window(epoch=i)
                check(eng.timetravel_ring.drain(60.0), f"ring readback of window {i}")
                if i - 1 in attack_at:  # the lookahead window landed: let the captures run
                    settle(i - 1)
            fired.extend(bank.flush(now_s=time.time()))
            settle(len(windows))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kops.launch_counts()
        ac.stop()
        eng.stop()
        return dict(eng=eng, qs=qs, ac=ac, bank=bank, fired=fired, hooks=hooks, t=t,
                    wall=wall, launches=launches, notified=notified, done_at=done_at,
                    stages=eng.stages.seconds())

    run = loop_run(plain=False)
    det_launches = run["launches"]
    print(f"detection path launches: {det_launches}", flush=True)
    check_sketch_launches(det_launches, "detection path")
    for name in DETECTION_KERNELS:
        check(det_launches[name] > 0, f"{name} was not launched on the detection path")
    judged = len(run["t"]["close"])
    check(det_launches["bank_close"] <= judged and det_launches["dnstunnel_score"] == 0
          and det_launches["synflood_score"] == 0 and run["t"]["ewma_calls"] == 0,
          f"detection path: {det_launches['bank_close']} bank_close launches over {judged} "
          f"closes, K12 alone {det_launches['dnstunnel_score']}, K13 alone "
          f"{det_launches['synflood_score']}, AnomalyEWMA.observe "
          f"{run['t']['ewma_calls']} (must be at most 1 a close, 0, 0, 0)")
    ref = loop_run(plain=True)
    check(all(v == 0 for v in ref["launches"].values()),
          f"the plain detection run launched kernels: {ref['launches']}")

    for r in (run, ref):
        fired = [(d.detector, d.epoch) for d in r["fired"]]
        hook_epochs = sorted({e for e, _ in r["hooks"]})
        check(set(e for _, e in fired) | set(hook_epochs) <= set(attack_at),
              f"detection path: a benign window fired: {fired}, hooks {r['hooks']}")
        for e, (name, _, _) in attack_at.items():
            got = [d for d, fe in fired if fe == e]
            ok = got == [name] or (name == "synflood" and not got and e in hook_epochs)
            check(ok, f"detection path: window {e} ({name} attack) fired {got}")
        caps = r["ac"].captures
        check(r["ac"].autocapture_failed == 0 and {c["epoch"] for c in caps} == set(attack_at),
              f"detection path: captures {[c['epoch'] for c in caps]}, "
              f"failed {r['ac'].autocapture_failed}")
    print("detection path firings (detector, epoch, score, z): "
          + ", ".join(f"({d.detector}, {d.epoch}, {d.score:.4f}, {d.zscore:.1f})"
                      for d in run["fired"])
          + f"; entropy anomaly hooks {run['hooks']}", flush=True)
    same_doc([(d.detector, d.epoch, d.dims) for d in run["fired"]],
             [(d.detector, d.epoch, d.dims) for d in ref["fired"]], "detection path firings")
    same_doc(run["hooks"], ref["hooks"], "detection path anomaly hooks")
    for a, b in zip(run["fired"], ref["fired"]):
        check(abs(a.score - b.score) <= 1e-5 * abs(b.score), "detection path firing scores")
    check(len(run["t"]["scores"]) == len(ref["t"]["scores"]), "detection path closes")
    for a, b in zip(run["t"]["scores"], ref["t"]["scores"]):
        check(set(a) == set(b) and all(abs(a[k] - b[k]) <= 1e-5 * abs(b[k]) for k in a),
              f"detection path window scores: {a} != {b}")

    def sources(r):
        return {c["epoch"]: c["sources"] for c in r["ac"].captures}

    same_doc(sources(run), sources(ref), "detection path capture sources")

    # Each capture's artifact, read back: rows to or from attributed hosts only.
    ddos_e = next(e for e, a in attack_at.items() if a[0] == "synflood")
    for c in run["ac"].captures:
        with tarfile.open(c["artifacts"][0]) as tf:
            member = next(m for m in tf.getmembers() if m.name.endswith(".pcap"))
            rows = _decode_pcap_numpy(tf.extractfile(member).read()).records
        hosts = {ip for ip, _ in c["sources"]}
        only = bool(len(rows)) and all(u32_to_ip(int(s)) in hosts or u32_to_ip(int(d)) in hosts
                                       for s, d in zip(rows[:, F.SRC_IP], rows[:, F.DST_IP]))
        check(only, f"capture of epoch {c['epoch']}: rows outside the attributed hosts")
        net = ATTACK_NET[attack_at[c["epoch"]][0]]
        n_atk = int(((rows[:, F.SRC_IP] >> np.uint32(24)) == net).sum())
        print(f"capture of epoch {c['epoch']} ({c['dims']}): {c['attributed_keys']} decoded keys, "
              f"{len(hosts)} attributed hosts, {len(rows)} rows, {n_atk} attack rows, "
              f"{c['artifact_bytes']} bytes; query and decode {c['query_seconds'] * 1e3:.1f} ms, "
              f"capture {c['capture_seconds'] * 1e3:.1f} ms", flush=True)

    # Attribution of the DDoS: its keys in the engine's key layout (src, dst,
    # ports, proto) and its 48 sources, against the range decode over the
    # capture's span [W - 2, W + 2).
    atk = attack_rows[ddos_e]
    atk_keys = {(int(r[F.SRC_IP]), int(r[F.DST_IP]), int(r[F.PORTS]), 6) for r in atk}
    atk_srcs = set(int(s) for s in atk[:, F.SRC_IP])
    dec = run["qs"].query_range("engine", ddos_e - 2, ddos_e + 2)["decode"]
    dec_keys = {tuple(int(x) for x in k) for k in dec["keys"]}
    dec_srcs = set(int(s) for s in dec["sources"][0])
    print(f"DDoS attribution (finding, no gate): {len(atk_keys)} attack keys, "
          f"{len(dec_keys)} decoded keys, key recall {len(atk_keys & dec_keys) / len(atk_keys):.4f}; "
          f"{len(atk_srcs)} attack sources, source recall "
          f"{len(atk_srcs & dec_srcs) / len(atk_srcs):.4f}", flush=True)
    for net_name, net in ATTACK_NET.items():
        srcs = [i for i, s in enumerate(dec["sources"][0]) if int(s) >> 24 == net]
        print(f"  {net_name} sources among the DDoS span's {len(dec['sources'][0])} decoded "
              f"sources: {len(srcs)}, first at rank {srcs[0] if srcs else None}", flush=True)

    for label, r in (("kernels", run), ("plain versions", ref)):
        st, n_q = r["stages"], len(windows)
        lat = {e: (r["done_at"][e] - r["notified"][e]) * 1e3 for e in attack_at
               if e in r["notified"] and e in r["done_at"]}
        print(f"detection path ({label}): {n_q} quanta, {n_events} events in {r['wall']:.3f} s; "
              f"per quantum: tap {(r['t']['tap'] - sum(r['t']['close'])) / n_q * 1e3:.3f} ms, "
              f"combine {st['combine'] / n_q * 1e3:.3f} ms; bank close "
              f"{np.mean(r['t']['close']) * 1e3:.3f} ms mean over {len(r['t']['close'])} closes; "
              f"notify to last capture done per attack (ms) {lat}; busy drops "
              f"{r['ac'].autocapture_suppressed['busy']}", flush=True)
    print(f"bank close: {det_launches['bank_close']} bank_close launches and "
          f"{run['t']['ewma_calls']} AnomalyEWMA.observe calls over {judged} closes with "
          f"kernels; the plain run's closes called observe {ref['t']['ewma_calls']} times",
          flush=True)
    for r in results:
        if r["name"] in ("portscan_score", "bank_close"):
            r["launches"] = det_launches[r["name"]]
            print(f"{r['name']}: {det_launches[r['name']]} launches over {judged} window "
                  f"closes", flush=True)

    # -- finding: how much of a bench quantum the tap sees ------------------------------
    sweep = TrafficGen(n_flows=N_FLOWS, n_pods=N_PODS_GEN, seed=SEED + 2).portscan_batch(
        1 << 15, n_scanners=4, n_ports=24)
    rows = combine_blocks(list(quanta[0]) + [sweep])
    kept = min(len(rows), MAX_WINDOW_RECORDS)
    bank = build_default_bank(Config(), device=dev)
    bank.observe(0, rows, now_s=0.0)
    fires = [d.detector for d in bank.flush(now_s=1.0)]
    in_cap = int((rows[:kept, F.SRC_IP] >> 24 == 0xC9).sum())
    print(f"tap finding (no gate): a {QUANTUM}-event quantum of path 1's traffic with a "
          f"{len(sweep)}-probe sweep appended combines to {len(rows)} rows; the tap keeps "
          f"{kept} ({kept / len(rows):.1%}), {in_cap} of them sweep rows; the bank fires "
          f"{fires or 'nothing'} (portscan score {bank.detector_score.get('portscan')})",
          flush=True)
    print(f"detection phase: {time.perf_counter() - t_phase:.1f} s", flush=True)

def cms_update_phase(dev, batch, time_ms, report, results, equal_int, report_set) -> None:
    """Row 12, ``cms.update_jit``, which lies on no path: its kernel
    (``cms_update``, K2's add phase alone) against its plain version at the
    deployed CMS shape (depth 4, width 2^15) over one 2^21-row batch, keyed
    by the 5-tuple and weighted by the packet lane with every eighth row
    masked (weight 0); then at the main path's report weights
    (``report_set``: the flow sketch's keys and weights of ``sketch_phase``'s
    report set). Its launches are this phase's own."""
    import torch

    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG as CFG
    from retina_tpu_torch.ops.countmin import CountMinSketch, cms_update_jit, indices
    from retina_tpu_torch.u32 import from_numpy, widen

    rec = from_numpy(batch, dev)
    cols = [rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS],
            ((rec[:, F.META] >> 24) & 0xFF).contiguous()]
    w = rec[:, F.PACKETS].clone()
    w[::8] = 0
    d, wd = CFG.cms_depth, CFG.cms_width
    kops.reset_launch_counts()
    sk = cms_update_jit(CountMinSketch.zeros(d, wd, seed=3, device=dev), cols, w)
    launches = kops.launch_counts()["cms_update"]
    check(launches == 1, f"cms_update launched {launches} times for one update")
    with kops.plain_versions():
        ref = cms_update_jit(CountMinSketch.zeros(d, wd, seed=3, device=dev), cols, w)
    check(kops.launch_counts()["cms_update"] == launches, "the plain cms_update launched")
    equal_int(sk.table, ref.table, "row 12 cms_update table")
    total = int(widen(w).sum()) & 0xFFFFFFFF
    check(bool(((widen(sk.table).sum(dim=1) & 0xFFFFFFFF) == total).all()),
          "row 12: a CMS row does not sum to the weight added")
    ms = time_ms(lambda: cms_update_jit(sk, cols, w))
    with kops.plain_versions():
        plain_ms = time_ms(lambda: cms_update_jit(ref, cols, w))
    flat = (indices(sk.table, sk.seed, cols) + (torch.arange(d, device=dev) * wd)[:, None]
            ).reshape(-1)
    wts = w.expand(d, -1).reshape(-1)
    lib_table = torch.zeros(d * wd, dtype=torch.int32, device=dev)
    lib_ms = time_ms(lambda: lib_table.index_add_(0, flat, wts))
    del flat, wts, lib_table
    rcols, rw = report_set
    tables = [CountMinSketch.zeros(d, wd, seed=3, device=dev) for _ in range(2)]
    cms_update_jit(tables[0], rcols, rw)
    with kops.plain_versions():
        cms_update_jit(tables[1], rcols, rw)
    equal_int(tables[0].table, tables[1].table, "row 12 cms_update table (report weights)")
    for label, args in (("report", (tables[0], rcols, rw)), ("packet", (sk, cols, w))):
        print(f"cms_update at the {label} weights: kernel "
              f"{ms if label == 'packet' else time_ms(lambda: cms_update_jit(*args)):.4f} ms "
              f"(CUDA events), device time {device_ms(lambda: cms_update_jit(*args)):.4f} ms; "
              f"weighted rows {int((args[2] != 0).sum())} of {len(args[2])}", flush=True)
    n, active = len(batch), int((w != 0).sum())
    report("cms_update", "retina_tpu_torch/kernels/csrc/hh_update.cu",
           "retina_tpu/ops/countmin.py:122", ms, plain_ms,
           # Every weight is read; a row of weight 0 returns before its keys.
           n * 4 + active * 4 * len(cols) + 2 * 4 * d * wd,
           active * (d * len(cols) * HASH_OPS + d),
           lib_ms, 0.0)
    results[-1]["launches"] = launches


RT_WINDOWS = 6  # windows of producer traffic in each full runtime run
RT_SHORT = 3  # windows of the "both" and overload runs
RT_PRODUCERS = 2
RT_IDLE_WINDOWS = 2.2  # the pause after the backlog drained: a whole tick interval idle
RT_NOW = 4_000_000_000 // 2  # now_s of the final snapshots compared


def instrument(eng, log, published, summaries):
    """Log the dispatch thread's batches and closes as issued, the step
    summaries, and each published window with its close's number."""
    dispatch, close = eng._dispatch_sharded, eng._submit_close_window

    def logged_dispatch(sb, now_s, n_raw, sync=True):
        log.append(("step", sb, now_s, n_raw))
        dispatch(sb, now_s, n_raw, sync)

    def logged_close():
        deferred = eng.windows["deferred"]
        close()
        if eng.windows["deferred"] == deferred:
            log.append(("window",))

    eng._dispatch_sharded, eng._submit_close_window = logged_dispatch, logged_close
    annotate, publish, step = (eng.overload.window_annotation, eng._publish_window,
                               eng.telemetry.step)
    n_closes = [0]

    def numbered_annotation():
        meta = annotate()
        meta["close_seq"] = n_closes[0]
        n_closes[0] += 1
        return meta

    def logged_publish(win, meta=None):
        published.append((win, meta))
        publish(win, meta)

    def logged_step(*args, **kwargs):
        state, summ = step(*args, **kwargs)
        summaries.append(summ)
        return state, summ

    eng.overload.window_annotation = numbered_annotation
    eng._publish_window = logged_publish
    eng.telemetry.step = logged_step


def runtime_lanes(dev, quanta, pods, equal_int, close_counts, close_float, equal_any) -> None:
    """The runtime path: ``SketchEngine.start(stop)`` on its own thread
    with the deployed ``Config()`` (window_seconds 1.0), fed by producer
    threads that write the ingest quanta's 2^13-event blocks of the 1M-flow
    Zipf stream into ``engine.sink`` as fast as it takes them, for 8
    windows, pausing in the middle until the backlog has drained and then
    2.2 windows more, so a close is idle. The feed
    loop, the feed workers (1: inline through the TransferMux; then 2;
    then the auto count), the dispatch thread, the device proxy on its CUDA
    stream, the close lane and the harvest lane all run; each run prints
    the proxy's busy time and the kernel launches a step. The overload
    controller is off in these runs, so every accepted event is stepped; a
    fourth run turns it on.

    In every run the dispatch thread's batches (with now_s and n_raw) and
    its closes are logged as issued, and replayed synchronously through a second engine
    under the plain versions: state, every step summary, every published
    window and the final snapshot must be equal (the comparison rules of
    the module docstring). totals[0] must equal the events the sink
    accepted less the pool's drops, and the dispatch thread drop nothing;
    the idle close must publish a zero window and run no export, ring
    offer or end_window; the harvest must publish in close order;
    ``top_flows`` must equal ``topk_from_snapshot`` of the same snapshot;
    K1-K5 and K7's new side must launch. A third, short run with
    ``heavy_keys_source="both"`` and the ring must launch K6 and K10 and
    score the decode against ``_hk_account``'s ground truth. A fourth holds
    the controller in SAMPLING by an injected signal: k reaches every
    batch, the step rescales the kept non-exempt weight by k exactly,
    exempt rows are kept whole, and the estimate is within the
    Horvitz-Thompson rule of ``runtime/overload.py``."""
    import os
    import threading

    import torch

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.parallel.telemetry import topk_from_snapshot
    from retina_tpu_torch.runtime import overload as ov
    from retina_tpu_torch.u32 import to_numpy

    t_phase = time.perf_counter()
    blocks = [b for q in quanta for b in q]
    print(f"runtime path: os.cpu_count() {os.cpu_count()}; {len(blocks)} blocks of {BLOCK} "
          f"events cycled by {RT_PRODUCERS} producers", flush=True)

    def lanes_run(label, cfg, windows, idle_at=None, inject=None, sample_log=None):
        eng = SketchEngine(cfg, device=dev)
        eng.update_identities(pods)
        log, published, summaries = [], [], []
        instrument(eng, log, published, summaries)
        if inject is not None:
            eng.overload._signals = lambda: {"injected": inject}
            check(eng.overload.tick(now=time.monotonic()) == ov.SAMPLING,
                  f"{label}: the injected signal did not reach SAMPLING")
        if sample_log is not None:
            sample = eng.overload.sample_rows

            def logged_sample(rec):
                kept, k = sample(rec)
                ex_in = rec[ov.row_tiers(rec, cfg) > ov.TIER_BACKGROUND]
                ex_out = kept[ov.row_tiers(kept, cfg) > ov.TIER_BACKGROUND]
                sample_log.append((int(rec[:, F.PACKETS].sum()),
                                   ex_in.shape == ex_out.shape and bool((ex_in == ex_out).all())))
                return kept, k

            eng.overload.sample_rows = logged_sample
        w = cfg.window_seconds
        accepted, offered = [0] * RT_PRODUCERS, [0] * RT_PRODUCERS
        go, done = threading.Event(), threading.Event()
        go.set()

        def produce(p):
            i = p
            while not done.is_set():
                if not go.is_set():
                    go.wait(0.01)
                    continue
                b = blocks[i % len(blocks)]
                i += RT_PRODUCERS
                got = eng.sink.write_records(b, "gen")
                accepted[p] += got
                offered[p] += len(b)
                if not got:
                    time.sleep(0.001)  # a full sink: yield, do not spin

        kops.reset_launch_counts()
        stop = threading.Event()
        lanes = threading.Thread(target=eng.start, args=(stop,), name="lanes", daemon=True)
        producers = [threading.Thread(target=produce, args=(p,), daemon=True)
                     for p in range(RT_PRODUCERS)]
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        lanes.start()
        for t in producers:
            t.start()
        idle_s = 0.0  # the part of the pause after the backlog drained
        if idle_at:
            time.sleep(idle_at * w)
            go.clear()
            t_pause = time.perf_counter()
            # Once every accepted event is stepped (or dropped by the pool),
            # two ticks with nothing new: the close between them is idle.
            deadline = time.monotonic() + 60
            while (not eng.sink.q.empty() or eng.counts.events + eng.lost_events["handoff"]
                   < sum(accepted)) and time.monotonic() < deadline:
                time.sleep(0.005)
            drain_s = time.perf_counter() - t_pause
            time.sleep(RT_IDLE_WINDOWS * w)
            idle_s = time.perf_counter() - t_pause - drain_s
            go.set()
            time.sleep((windows - idle_at) * w)
            print(f"{label}: the backlog drained {drain_s:.3f} s into the pause", flush=True)
        else:
            time.sleep(windows * w)
        done.set()
        for t in producers:
            t.join(30)
        drain_end = time.monotonic() + 30
        while not eng.sink.q.empty() and time.monotonic() < drain_end:
            time.sleep(0.005)
        time.sleep(1.5 * w)  # the last fed window closes
        stop.set()
        lanes.join(120)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        check(not lanes.is_alive() and not any(t.is_alive() for t in producers),
              f"{label}: a thread did not stop")
        launches = kops.launch_counts()
        check_sketch_launches(launches, label)
        eng.stop()
        fs = eng.feed_stats()
        acc, off = sum(accepted), sum(offered)
        pool_drops = fs.get("dropped_events", 0)
        st = eng.stages.seconds()
        card = st["copy"] + st["ingest"] + st["steps"]
        active = wall - idle_s
        print(f"{label}: {fs['mode']} feed, {fs['workers']} workers; {eng.counts.events} events "
              f"stepped in {wall:.3f} s ({active:.3f} s without the idle pause): "
              f"{eng.counts.events / active:.0f} events/s; card span (copy, ingest, steps by "
              f"CUDA events) {card:.3f} s = {card / active:.1%} of the active wall; sink took "
              f"{acc} of {off} offered (dropped {off - acc}); pool dropped {pool_drops}; "
              f"lost {fs['lost_events']}; windows {fs['windows']}; steps {eng.counts.steps}",
              flush=True)
        steps = max(eng.counts.steps, 1)
        print(f"{label}: the proxy busy {fs['lane_s'].get('proxy', 0.0) / steps * 1e3:.3f} ms a "
              f"step; {sum(launches.values()) / steps:.2f} kernel launches a step by the "
              f"wrappers' counts ({eng.counts.steps} steps)", flush=True)
        print(f"{label}: lane seconds {({k: round(v, 3) for k, v in fs['lane_s'].items()})}; "
              f"stages {({k: round(v, 3) for k, v in st.items()})}; per worker busy "
              f"{[round(x['busy_s'], 3) for x in fs['per_worker']]}; overload "
              f"{fs['overload']['state']}; launches {launches}", flush=True)
        # The flight recorder's spans of the run (host clock): by stage, and
        # the seconds each thread spent in each stage (the proxy's are the
        # transfer and device_step spans: its host time issuing them).
        rep = eng._recorder.stage_report()
        print(f"{label}: recorder stage_report (count, total s, p50 ms, p99 ms): " + "; ".join(
            f"{k} {v['count']} {v['total_s']:.3f} {v['p50_s'] * 1e3:.3f} "
            f"{v['p99_s'] * 1e3:.3f}" for k, v in rep.items()), flush=True)
        by_thread: dict = {}
        for span in eng._recorder.spans():
            th = by_thread.setdefault(span["thread"], {})
            th[span["stage"]] = th.get(span["stage"], 0.0) + span["t1"] - span["t0"]
        print(f"{label}: recorder seconds by thread and stage " + str(
            {t: {k: round(v, 3) for k, v in st.items()} for t, st in sorted(by_thread.items())}),
            flush=True)
        check(eng.errors == {}, f"{label}: errors {dict(eng.errors)}")
        check(not eng.lost_events.get("dispatch") and not eng.lost_events.get("device"),
              f"{label}: the dispatch thread lost events {dict(eng.lost_events)}")
        check(eng.counts.events == acc - pool_drops,
              f"{label}: {eng.counts.events} events stepped, {acc} accepted, {pool_drops} "
              f"dropped by the pool")
        check(eng.windows["closed"] == eng.windows["end_window"] + eng.windows["idle"],
              f"{label}: closes {dict(eng.windows)}")
        check([m["close_seq"] for _, m in published] == list(range(eng.windows["closed"])),
              f"{label}: the harvest did not publish in close order")
        for win, meta in published:
            if meta["events"] == 0:
                check(all(not np.asarray(win[k]).any() for k in ("entropy_bits", "anomaly",
                                                                  "zscore")),
                      f"{label}: an idle close published a non-zero window")
        return dict(eng=eng, log=log, published=published, summaries=summaries,
                    launches=launches, accepted=acc, pool_drops=pool_drops)

    def replay(label, cfg, run, inject=None, feed_side=()):
        """The run's log, synchronously, under the plain versions. With
        ``inject`` the replay's controller holds the run's state; the
        annotation keys in ``feed_side`` are the sampler's accounting,
        which runs before the log and so is not replayed."""
        eng = SketchEngine(cfg, device=dev)
        eng.update_identities(pods)
        if inject is not None:
            eng.overload._signals = lambda: {"injected": inject}
            check(eng.overload.tick(now=time.monotonic()) == ov.SAMPLING,
                  f"{label}: the replay's controller did not reach SAMPLING")
        log, published, summaries = [], [], []
        instrument(eng, log, published, summaries)
        launches = kops.launch_counts()
        t0 = time.perf_counter()
        with kops.plain_versions():
            for entry in run["log"]:
                if entry[0] == "step":
                    eng._dispatch_sharded(*entry[1:])
                else:
                    eng._close_window()
            eng._harvest_window(timeout=60)
            snap = eng.snapshot(max_age_s=0, now_s=RT_NOW)
        check(kops.launch_counts() == launches, f"the plain replay of {label} launched kernels")
        a, b = run["eng"], eng
        for (leaf, x), (_, y) in zip(named_leaves(a.state), named_leaves(b.state)):
            if x.dtype == torch.int32:
                equal_int(x, y, f"{label} state {leaf}")
            elif leaf == "entropy.counts":
                close_counts(x, y, f"{label} entropy counts")
            else:
                close_float(x, y, f"{label} state {leaf}")
        check(len(run["summaries"]) == len(summaries),
              f"{label}: {len(run['summaries'])} steps, the replay {len(summaries)}")
        for i, (x, y) in enumerate(zip(run["summaries"], summaries)):
            equal_any(x, y, f"{label} step summary {i}")
        check(len(run["published"]) == len(published), f"{label}: windows published differ")
        for i, ((wx, mx), (wy, my)) in enumerate(zip(run["published"], published)):
            equal_any({k: torch.from_numpy(np.asarray(wx[k])) for k in ("entropy_bits", "anomaly",
                                                                         "zscore")},
                      {k: torch.from_numpy(np.asarray(wy[k])) for k in ("entropy_bits", "anomaly",
                                                                         "zscore")},
                      f"{label} window {i}")
            skip = ("inv_decode",) + tuple(feed_side)
            check({k: v for k, v in mx.items() if k not in skip}
                  == {k: v for k, v in my.items() if k not in skip},
                  f"{label} window {i} annotation")
        equal_any(run["eng"].snapshot(max_age_s=0, now_s=RT_NOW), snap, f"{label} snapshot")
        if a._hk_counts is not None:
            # The ground truth and the last window's decode (K6 and K10 on
            # the lanes); the scores depend on when the harvest ran.
            check(a._hk_counts == b._hk_counts, f"{label}: _hk_account's ground truth differs")
            ra, rb = a.invertible_report(), b.invertible_report()
            check(ra.keys() == rb.keys() and all(np.array_equal(ra[k], rb[k]) for k in ra),
                  f"{label}: the invertible report differs")
        eng.stop()
        print(f"{label}: the plain replay of {len(run['log'])} dispatches and closes "
              f"({time.perf_counter() - t0:.1f} s) equals the run: state, "
              f"{len(summaries)} step summaries, {len(published)} windows, the snapshot",
              flush=True)

    k1_k5 = ("step_rows", "hh_update", "hll_update", "entropy_update", "conntrack",
             "latency_update")
    for label, workers in (("runtime run 1 (inline)", 1), ("runtime run 1b (2 workers)", 2),
                           ("runtime run 2 (auto workers)", 0)):
        cfg = Config(window_seconds=1.0, feed_workers=workers, overload_enabled=False)
        run = lanes_run(label, cfg, RT_WINDOWS, idle_at=RT_WINDOWS // 2)
        eng = run["eng"]
        if workers == 0:
            check(eng.feed_stats()["workers"] == eng._resolve_feed_workers() > 1,
                  f"{label}: the auto count did not start a pool")
        for k in k1_k5 + ("ingest_new", "window_close"):
            check(run["launches"][k] > 0, f"{k} was not launched on {label}")
        check(eng.windows["idle"] >= 1 and eng.windows["exports"] == 0,
              f"{label}: closes {dict(eng.windows)}")
        fed = (run["accepted"] - run["pool_drops"]) & 0xFFFFFFFF
        check(int(to_numpy(eng.state.totals)[0]) == fed,
              f"{label}: totals[0] != the events accepted")
        snap = eng.snapshot(max_age_s=0)
        keys, counts = eng.top_flows(20)
        check(eng.snapshot() is snap, f"{label}: the scrape missed its cache")
        want_keys, want_counts = topk_from_snapshot(snap, "flow_hh", 20)
        check(np.array_equal(keys, want_keys) and np.array_equal(counts, want_counts),
              f"{label}: top_flows != topk_from_snapshot")
        print(f"{label}: conntrack_gc {eng.conntrack_gc()}; top flow count {int(counts[0])}",
              flush=True)
        replay(label, cfg, run)
        del run, eng, snap

    cfg = Config(window_seconds=1.0, heavy_keys_source="both", timetravel_enabled=True,
                 overload_enabled=False)
    run = lanes_run("runtime run 3 (heavy keys both)", cfg, RT_SHORT)
    eng = run["eng"]
    for k in k1_k5 + ("inv_update", "cms_query", "inv_decode", "window_close"):
        check(run["launches"][k] > 0, f"{k} was not launched on runtime run 3")
    check(eng.timetravel_ring.stats()["appended"] == eng.windows["end_window"]
          == eng.windows["exports"] > 0, f"runtime run 3: ring {eng.timetravel_ring.stats()} "
          f"closes {dict(eng.windows)}")
    check("recall" in eng.invertible_scores, "runtime run 3: the decode was not scored")
    print(f"runtime run 3: the decode against _hk_account's {len(eng._hk_counts)} keys "
          f"{eng.invertible_scores}; ring {eng.timetravel_ring.stats()}", flush=True)
    replay("runtime run 3", cfg, run)
    del run, eng

    sample_log: list = []
    cfg = Config(window_seconds=1.0)
    run = lanes_run("runtime run 4 (overload: SAMPLING injected)", cfg, RT_SHORT,
                    inject=0.8, sample_log=sample_log)
    eng, k = run["eng"], cfg.overload_sample_k
    steps = [e[1] for e in run["log"] if e[0] == "step"]
    check(bool(steps) and all(sb.sample_k == k for sb in steps),
          "runtime run 4: sample_k did not reach every batch")
    kept = np.concatenate([sb.records[0, : int(sb.n_valid[0])] for sb in steps])
    exempt = ov.row_tiers(kept, cfg) > ov.TIER_BACKGROUND
    pk = kept[:, F.PACKETS].astype(np.int64)
    est = int(pk[exempt].sum()) + k * int(pk[~exempt].sum())
    check(int(to_numpy(eng.state.totals)[0]) == est & 0xFFFFFFFF,
          "runtime run 4: the step did not rescale the kept rows by k")
    check(all(ok for _, ok in sample_log), "runtime run 4: an exempt row was sampled")
    offered = sum(n for n, _ in sample_log)
    check(offered == run["accepted"] - run["pool_drops"],
          "runtime run 4: the sampler saw other events than were accepted")
    sd = float(np.sqrt((k - 1) * k * float((pk[~exempt] ** 2).sum())))
    check(abs(est - offered) <= 4 * sd, f"runtime run 4: estimate {est} vs {offered} offered")
    print(f"runtime run 4: k {k}; {offered} events offered to the sampler, {int(pk.sum())} kept "
          f"({int(pk[exempt].sum())} exempt); estimate {est} ({(est - offered) / offered:+.5%}, "
          f"{abs(est - offered) / max(sd, 1):.2f} sd); controller "
          f"{eng.overload_stats()['counters']}", flush=True)
    replay("runtime run 4", cfg, run, inject=0.8,
           feed_side=("sampled_fraction", "events_sampled", "priority_exempt_events"))
    del run, eng
    print(f"runtime phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


SCRAPE_WINDOWS = 8  # windows fed and closed on the scrape path, two GETs after each
SCRAPE_PODS = 2047  # pods in the identity cache: every pod index of the bench traffic
# now_s of the scrape path's first window: 4 s before a 16-bit boundary of the
# clock, so the conntrack table's seen16 stamps and the snapshots' idle
# times cross the wrap between its fourth and fifth windows.
SCRAPE_T0 = (1 << 16) * 26_000 - 4
SCRAPE_QUERIES = (1, 8, 32)  # GET /timetravel/query?last=N


def exposition_samples(text: str) -> dict[str, float]:
    """{series (the sample line without its value): value} of an exposition;
    a series written twice keeps its last value."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


def scrape_surface(dev, quanta, time_ms, report, results) -> None:
    """The scrape surface of the node agent, wired as the reference daemon
    wires it: the engine (``Config()`` with its time-travel ring) closing
    windows through its close and harvest lanes (K16, whose entropy and
    anomaly series the harvest publishes), the identity cache with 2047
    pods, ``MetricsModule`` with ``MetricsConfiguration.default()``
    reading the snapshot (K17) into the advanced registry, the conntrack
    plugin's live-connection gauge, the HTTP ``Server`` on 127.0.0.1 with
    its render cache, and ``QueryService`` on the engine's ring behind
    ``/timetravel/query`` (the range extract: K16's read-only entry and
    K17).

    Each of 8 windows is fed one bench quantum and closed, then scraped
    twice over HTTP; the scraped exposition must equal the one the same
    engine state gives through the plain versions (the snapshot taken
    under ``plain_versions()`` and published by a second module into an
    exporter of its own): the advanced series and the live-connection
    gauge value for value, estimates within a relative 1e-5, the rest
    exactly, with no series on one side only and no metric object whose
    publish failed on either; the window's close must equal ``end_window_plain`` on the
    state saved before it (bits and z within a relative 1e-5, the flags
    exactly away from the threshold), as must the entropy, anomaly and
    z-score series. Then three range queries over HTTP, each equal to the
    plain route's document. K16 and K17 are then held against their plain
    versions on the path's state (the live count at clocks across the
    16-bit wrap) and timed with the L2 cache flushed before each call, as a
    scrape or a close finds the state after a step."""
    import threading
    import urllib.request

    import torch

    from retina_tpu_torch.common import RetinaEndpoint
    from retina_tpu_torch.config import Config
    from retina_tpu_torch.controllers.cache import Cache
    from retina_tpu_torch.crd.types import MetricsConfiguration
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.schema import u32_to_ip
    from retina_tpu_torch.events.synthetic import pod_ip
    from retina_tpu_torch.exporter import Exporter, get_exporter
    from retina_tpu_torch.fleet.shipper import window_epoch
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.metrics import initialize_metrics
    from retina_tpu_torch.models.pipeline import EWMA_MIN_WINDOWS, end_window_plain
    from retina_tpu_torch.module.metrics_module import MetricsModule
    from retina_tpu_torch.plugins.conntrack_gc import ConntrackPlugin
    from retina_tpu_torch.server import Server
    from retina_tpu_torch.timetravel.query import QueryService
    from retina_tpu_torch.utils import metric_names as mn

    # Families the plain comparison holds within a relative 1e-5 (HLL
    # estimates, entropy bits and z-scores); every other sample exactly.
    float_families = (mn.DISTINCT_SRC_PER_POD, mn.DISTINCT_FLOWS, mn.ENTROPY_BITS,
                      mn.ANOMALY_ZSCORE)
    t_phase = time.perf_counter()
    cfg = Config(timetravel_enabled=True)
    eng = SketchEngine(cfg, device=dev)
    cache = Cache()
    for i in range(1, SCRAPE_PODS + 1):
        idx = cache.update_endpoint(RetinaEndpoint(
            name=f"pod-{i}", namespace=f"ns-{i % 16}", ips=(u32_to_ip(pod_ip(i)),),
            owner_refs=(("ReplicaSet", f"rs-{i % 97}"),) if i % 3 else ()))
        check(idx == i, f"scrape path: pod {i} got cache index {idx}")
    eng.update_identities({ip: i for i, ip in ((i, pod_ip(i)) for i in range(1, SCRAPE_PODS + 1))})
    ex = get_exporter()
    initialize_metrics(ex)
    mod = MetricsModule(cfg, eng, cache, exporter=ex)
    mod.reconcile(MetricsConfiguration.default())
    ct_plugin = ConntrackPlugin(cfg)
    ct_plugin.attach_engine(eng)
    srv = Server("127.0.0.1:0", exporter=ex, metrics_cache_ttl_s=cfg.metrics_cache_ttl_s)
    qs = QueryService(cfg, overload=eng.overload, device=dev)
    qs.add_ring(eng.timetravel_ring)
    qs.attach(srv)
    srv.start()

    class Frozen:
        """The engine as the plain module sees it: one snapshot."""

        def __init__(self, snap):
            self.snap, self.overload = snap, eng.overload

        def snapshot(self, max_age_s: float = 0.5):
            return self.snap

        def shed_active(self, stage: str) -> bool:
            return False

    pex = Exporter()
    pmod = MetricsModule(cfg, Frozen(None), cache, exporter=pex)
    pmod.reconcile(MetricsConfiguration.default())

    def get(path: str) -> tuple[bytes, float]:
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=60) as r:
            check(r.status == 200, f"GET {path}: {r.status}")
            body = r.read()
        return body, (time.perf_counter() - t0) * 1e3

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    timings = {"GET (first)": [], "GET (fresh)": [], "snapshot": [], "publish": [],
               "render": []}
    n_bytes = n_samples = 0
    saved = None
    kops.reset_launch_counts()
    epoch = window_epoch(cfg.window_seconds)
    try:
        for w in range(SCRAPE_WINDOWS):
            now = SCRAPE_T0 + w
            eng.flush(quanta[w % 3], now)
            # One close an epoch of the wall clock: the ring keys its slots
            # by the epoch at the close.
            while window_epoch(cfg.window_seconds) == epoch:
                time.sleep(0.01)
            epoch = window_epoch(cfg.window_seconds)
            a = eng.state.anomaly
            saved = [x.clone() for x in (eng.state.entropy.counts, a.mean, a.var, a.n_obs)]
            eng._close_window()
            eng._harvest_window(timeout=60)
            check(eng.windows["end_window"] == w + 1, f"scrape path: closes {dict(eng.windows)}")
            win = eng.last_window
            bits, flags, z = end_window_plain(*(x.clone() for x in saved), a.alpha, 4.0,
                                              EWMA_MIN_WINDOWS)
            bits, flags, z = (x.cpu().numpy() for x in (bits, flags, z))
            check(bool(np.allclose(win["entropy_bits"], bits, rtol=1e-5, atol=0)),
                  f"scrape window {w}: K16 bits {win['entropy_bits']} != plain {bits}")
            check(bool(np.allclose(win["zscore"], z, rtol=1e-5, atol=1e-4)),
                  f"scrape window {w}: K16 z {win['zscore']} != plain {z}")
            away = np.abs(np.abs(z) - 4.0) > 1e-3
            check(bool((win["anomaly"].astype(bool) == flags)[away].all()),
                  f"scrape window {w}: K16 flags {win['anomaly']} != plain {flags}")
            # The scrape: the snapshot (K17), the publication, the conntrack
            # gauge, the render; then two GETs, the second until it carries
            # this window's exposition (the first may be the render cache's).
            snap, ms = synced(lambda: eng.snapshot(max_age_s=0, now_s=now))
            timings["snapshot"].append(ms)
            t0 = time.perf_counter()
            mod.publish_once()
            timings["publish"].append((time.perf_counter() - t0) * 1e3)
            stats = ct_plugin.gc_once()
            t0 = time.perf_counter()
            want = ex.gather_text()
            timings["render"].append((time.perf_counter() - t0) * 1e3)
            _, ms = get("/metrics")
            timings["GET (first)"].append(ms)
            deadline = time.monotonic() + 30
            while True:
                body, ms = get("/metrics")
                if body == want or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            check(body == want, f"scrape window {w}: /metrics never served the exposition")
            timings["GET (fresh)"].append(ms)
            n_bytes, got = len(body), exposition_samples(body.decode())
            n_samples = len(got)
            # The same state through the plain versions.
            with kops.plain_versions():
                psnap = eng.snapshot(max_age_s=0, now_s=now)
            pmod.engine.snap = psnap
            pmod.publish_once()
            check(mod.publish_failures == pmod.publish_failures == 0,
                  f"scrape window {w}: {mod.publish_failures} metric objects failed to "
                  f"publish, {pmod.publish_failures} on the plain side")
            plain_text = pex.gather_text().decode()
            plain = exposition_samples(plain_text)
            check(len(plain) > 4 * SCRAPE_PODS, f"scrape window {w}: {len(plain)} plain samples")
            # The plain exporter holds the metric objects' families only: the
            # scrape holds exactly its series of those families.
            families = {line.split()[2] for line in plain_text.splitlines()
                        if line.startswith("# TYPE ")}
            extra = {x for x in got if x.split("{")[0] in families} - plain.keys()
            check(not extra, f"scrape window {w}: {len(extra)} series not in the plain "
                  f"exposition, e.g. {sorted(extra)[:3]}")
            for series, value in plain.items():
                check(series in got, f"scrape window {w}: {series} not scraped")
                if series.startswith(float_families):
                    check(abs(got[series] - value) <= 1e-5 * abs(value),
                          f"scrape window {w}: {series} {got[series]} != plain {value}")
                else:
                    check(got[series] == value,
                          f"scrape window {w}: {series} {got[series]} != plain {value}")
            active = int(psnap["active_conns"])
            check(stats["active"] == active and got[mn.ACTIVE_CONNECTIONS] == active > 0,
                f"scrape window {w}: active connections {stats['active']} != plain {active}")
            for i, dim in enumerate(("src_ip", "dst_ip", "dst_port")):
                lbl = f'{{dimension="{dim}"}}'
                check(abs(got[mn.ENTROPY_BITS + lbl] - bits[i]) <= 1e-5 * abs(bits[i]),
                      f"scrape window {w}: entropy series {dim}")
                check(got[mn.ANOMALY_FLAG + lbl] == float(win["anomaly"][i]),
                      f"scrape window {w}: anomaly series {dim}")
        check(eng.timetravel_ring.drain(60.0), "scrape path: the ring's readback")
        docs, query_ms = {}, {}
        for n in SCRAPE_QUERIES:
            body, query_ms[n] = get(f"/timetravel/query?last={n}")
            docs[n] = json.loads(body)
        _, cached_ms = get(f"/timetravel/query?last={SCRAPE_QUERIES[-1]}")
        launches = kops.launch_counts()
    finally:
        srv.stop()
    print(f"scrape path launches: {launches}", flush=True)
    check_sketch_launches(launches, "scrape path")
    for name in ("window_close", "snapshot_flat", "hll_estimate", "entropy_bits", "step_rows",
                 "ingest_new", "fold", "cms_query"):
        check(launches[name] > 0, f"{name} was not launched on the scrape path")
    ring = eng.timetravel_ring
    _, newest = ring.span()
    for n, doc in docs.items():
        e0, e1 = newest - n + 1, newest + 1
        with kops.plain_versions():
            ref = qs._query(ring, e0, e1, cfg.timetravel_query_topk, "flow")
        same_doc(doc, json.loads(json.dumps(ref, default=str)), f"/timetravel/query?last={n}")
        # A window that took longer than the clock's window leaves an epoch
        # without a slot, so last=N selects the slots in its N epochs.
        check(doc["windows"] == len(ring.select(e0, e1)) > 0 and doc["cardinality"] > 0
              and len(doc["topk"]["keys"]) == cfg.timetravel_query_topk,
              f"/timetravel/query?last={n}: {doc['windows']} windows")
    check(docs[SCRAPE_QUERIES[-1]]["windows"] == SCRAPE_WINDOWS,
          f"/timetravel/query?last=32 holds {docs[SCRAPE_QUERIES[-1]]['windows']} windows")
    med = {k: float(np.median(v)) for k, v in timings.items()}
    print(f"scrape path: {SCRAPE_WINDOWS} windows, {SCRAPE_PODS} pods; GET /metrics median of "
          f"{SCRAPE_WINDOWS}: {med['GET (first)']:.3f} ms (the first GET after the close, "
          f"from the render cache), {med['GET (fresh)']:.3f} ms (the GET that served the "
          f"window's exposition); a fresh scrape split: snapshot (K17, one launch, one copy) "
          f"{med['snapshot']:.3f} ms, publish {med['publish']:.3f} ms, render "
          f"{med['render']:.3f} ms; exposition {n_bytes} bytes, {n_samples} samples",
          flush=True)
    print("scrape path: /timetravel/query latency (first call, the fold) "
          + ", ".join(f"last={n} ({docs[n]['windows']} windows) {query_ms[n]:.3f} ms"
                      for n in SCRAPE_QUERIES)
          + f"; a cached repeat {cached_ms:.3f} ms; cardinality over 32 "
          f"{docs[32]['cardinality']:.0f}", flush=True)

    # -- K16 and K17 against their plain versions on the path's state, timed --
    counts, mean, var, n_obs = saved
    g, k = counts.shape

    def max_err(x, y):
        return float((x.float() - y.float()).abs().max()) if x.numel() else 0.0

    # The state is cold when a close or a scrape reads it after a step: each
    # timed call first writes a buffer larger than the 50 MB L2. The filter
    # on the kernel's name leaves that fill out of the time.
    l2 = torch.empty(32 << 20, dtype=torch.int32, device=dev)

    def cold_ms(name, fn, kernel):
        """Median of 3 profiler windows of 50 calls, each call after the flush."""
        runs = [device_ms(fn, reps=50, kernel=kernel) for _ in range(3)]
        print(f"{name}: {', '.join(f'{r:.6f}' for r in runs)} ms a call, L2 flushed "
              "(3 windows of 50)", flush=True)
        return float(np.median(runs))

    c = counts.clone()
    ewma = [t.clone() for t in (mean, var, n_obs)]
    out = kops.window_close(c, *ewma, eng.state.anomaly.alpha, 4.0, EWMA_MIN_WINDOWS)
    c_ref, ewma_ref = counts.clone(), [t.clone() for t in (mean, var, n_obs)]
    with kops.plain_versions():
        ref = kops.window_close(c_ref, *ewma_ref, eng.state.anomaly.alpha, 4.0, EWMA_MIN_WINDOWS)
    torch.cuda.synchronize()
    close_err = max_err(out[0], ref[0])
    check(close_err <= 1e-5 * float(ref[0].abs().max()), "K16 window_close: bits differ")
    check(bool(torch.allclose(out[2], ref[2], rtol=1e-5, atol=1e-4)), "K16 window_close: z")
    check(torch.equal(ewma[2], ewma_ref[2]) and not c.any(), "K16 window_close: n_obs, reset")
    bits_out = kops.entropy_bits(counts)
    with kops.plain_versions():
        bits_ref = kops.entropy_bits(counts)
    bits_err = max_err(bits_out, bits_ref)
    check(bool(torch.allclose(bits_out, bits_ref, rtol=1e-5, atol=0)), "K16 entropy_bits")

    def close_once(plain: bool):
        c.copy_(counts)
        if not plain:
            l2.zero_()
        with kops.plain_versions() if plain else contextlib.nullcontext():
            kops.window_close(c, *ewma, eng.state.anomaly.alpha, 4.0, EWMA_MIN_WINDOWS)

    close_ms = cold_ms("window_close", lambda: close_once(False), "window_close_kernel")
    close_plain_ms = time_ms(lambda: close_once(True))
    bits_ms = cold_ms("entropy_bits", lambda: (l2.zero_(), kops.entropy_bits(counts)),
                      "window_close_kernel")

    def plain_bits():
        with kops.plain_versions():
            kops.entropy_bits(counts)

    bits_plain_ms = time_ms(plain_bits)
    ent = g * k * 4
    report("window_close", "retina_tpu_torch/kernels/csrc/window_close.cu",
           "retina_tpu/models/pipeline.py:664", close_ms, close_plain_ms,
           2 * ent + 2 * 3 * g * 4 + g * 9, 4 * g * k, None, close_err)
    results[-1]["launches"] = launches["window_close"]
    report("entropy_bits", "retina_tpu_torch/kernels/csrc/window_close.cu",
           "retina_tpu/ops/entropy.py:71", bits_ms, bits_plain_ms, ent + g * 4, 4 * g * k,
           None, bits_err)
    results[-1]["launches"] = launches["entropy_bits"]

    st = eng.state
    banks = [st.hll_flows.registers, st.hll_src_per_reason.registers,
             st.hll_src_per_pod.registers]
    est_err = 0.0
    for regs in banks:
        got = kops.hll_estimate(regs)
        with kops.plain_versions():
            want = kops.hll_estimate(regs)
        torch.cuda.synchronize()
        check(bool(torch.allclose(got, want, rtol=1e-5, atol=0)),
              f"K17 hll_estimate on a {tuple(regs.shape)} bank")
        est_err = max(est_err, max_err(got, want))
    est_ms = cold_ms("hll_estimate", lambda: [(l2.zero_(), kops.hll_estimate(r)) for r in banks],
                     "readout_kernel")

    def plain_est():
        with kops.plain_versions():
            for r in banks:
                kops.hll_estimate(r)

    est_plain_ms = time_ms(plain_est)
    reg_bytes = sum(r.numel() * 4 for r in banks)
    report("hll_estimate", "retina_tpu_torch/kernels/csrc/snapshot_readout.cu",
           "retina_tpu/ops/hyperloglog.py:108 (under parallel/telemetry.py:493)", est_ms,
           est_plain_ms, reg_bytes + sum(r.shape[0] * 4 for r in banks), 3 * reg_bytes // 4,
           None, est_err)
    results[-1]["launches"] = launches["hll_estimate"]
    ct = st.conntrack
    last = SCRAPE_T0 + SCRAPE_WINDOWS - 1
    for now in (last, last + 30, last + 400, SCRAPE_T0 - 200, (1 << 32) - 1):
        got = kops.ct_active(ct.keys, ct.vals, now)
        with kops.plain_versions():
            want = kops.ct_active(ct.keys, ct.vals, now)
        torch.cuda.synchronize()
        check(int(got) == int(want), f"K17 ct_active at now {now}: {int(got)} != {int(want)}")
    check(int(kops.ct_active(ct.keys, ct.vals, last)) > 0, "K17 ct_active: no live connection")
    ct_ms = cold_ms("ct_active", lambda: (l2.zero_(), kops.ct_active(ct.keys, ct.vals, last)),
                    "readout_kernel")

    def plain_ct():
        with kops.plain_versions():
            kops.ct_active(ct.keys, ct.vals, last)

    ct_plain_ms = time_ms(plain_ct)
    report("ct_active", "retina_tpu_torch/kernels/csrc/snapshot_readout.cu",
           "retina_tpu/ops/conntrack.py:286 (under parallel/telemetry.py:493)", ct_ms,
           ct_plain_ms, ct.n_slots * 12 + 4, 8 * ct.n_slots, None, 0.0)
    # The live count runs as a job of every readout launch of the snapshot
    # (kops.ct_active is its one-job launch): its launches are the path's
    # own calls and its readouts.
    results[-1]["launches"] = launches["ct_active"] + launches["snapshot_flat"]
    eng.stop()
    print(f"scrape phase: {time.perf_counter() - t_phase:.1f} s", flush=True)



SUP_DEADLINE_S = 5.0  # the phase's watchdog deadline (and the recovery's fence bound)
SUP_WAIT_S = 120.0  # the bound on each wait of the supervision phase
STICKY_TIMEOUT_S = 240  # the bound on the sticky-error child, its start included


def supervision_phase(dev, quanta, pods, equal_int, close_counts, close_float, equal_any
                      ) -> None:
    """The supervised runtime at the deployed width (``Config()``:
    DEPLOYED_CONFIG) on the card, under a ``Supervisor`` whose watchdog
    deadline is 5 s:

    1. checkpoint and fault: one quantum of bench.py's traffic flushed
       synchronously, the state saved (``save_snapshot_state``), then
       ``transfer:raise@1,recover:hang30`` armed and one asynchronous
       dispatch submitted;
    2. degraded mode: ``degraded`` and ``degraded_mode`` 1, and a second
       asynchronous dispatch dropped and counted under
       ``lost_events["degraded"]``;
    3. recovery: the hang released; ``restarts``, ``engine_restarts`` 1,
       ``recovery_failed`` unset, ``degraded_mode`` 0;
    4. the probe (K7's packed side and the step's kernels, by the wrappers'
       counts) and two quanta flushed after it, with a close and a snapshot
       (K7's new side, K1-K5, K14, K16, K17); a second engine that loaded the
       same checkpoint takes the same quanta, and the two states, windows
       and snapshots must be equal (integers exactly, floats by the
       module's rules); totals[0] is the checkpointed packets plus those fed
       after the recovery;
    5. a torn checkpoint (``checkpoint:corrupt@1``): a fresh engine's load
       returns False, the file is quarantined to ``.bad`` and the state is
       zero, on the card.

    Prints the checkpoint's save and load times at DEPLOYED_CONFIG and at
    INVERTIBLE_CONFIG, ``recovery_seconds`` and the probe's launches. Then
    the sticky-error child (``sticky_child``) in a subprocess: its JSON line
    and exit code must show ``recovery_failed`` set within its bound, the
    state still on the card."""
    import os
    import shutil
    import tempfile

    import torch

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.convert import tensor_leaves
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.metrics import get_metrics
    from retina_tpu_torch.runtime import faults
    from retina_tpu_torch.runtime.supervisor import Supervisor
    from retina_tpu_torch.u32 import to_numpy

    t_phase = time.perf_counter()
    m = get_metrics()

    def wait(pred, what: str) -> None:
        deadline = time.monotonic() + SUP_WAIT_S
        while not pred():
            check(time.monotonic() < deadline, f"supervision: timed out waiting for {what}")
            time.sleep(0.01)

    def packets(blocks) -> int:
        return sum(int(b[:, F.PACKETS].astype(np.uint64).sum()) for b in blocks)

    def async_dispatch(eng, blocks, now_s) -> int:
        """One quantum's first batch, submitted as the dispatch thread does;
        its events."""
        _, sb, now, n = eng._build_quantum(blocks, sum(len(b) for b in blocks), now_s)[0]
        eng._dispatch_sharded(sb, now, n, sync=False)
        return int(sb.events) + int(sb.lost)

    tmp = tempfile.mkdtemp(prefix="retina-supervision-")
    # -- the checkpoint's cost at the two configurations ------------------
    for label, cfg in (("DEPLOYED_CONFIG", Config()),
                       ("INVERTIBLE_CONFIG", Config(heavy_keys_source="invertible"))):
        eng = SketchEngine(cfg, device=dev)
        eng.update_identities(pods)
        eng.flush(quanta[0], 100)
        torch.cuda.synchronize()
        path = os.path.join(tmp, f"{label}.npz")
        save_ms, load_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.save_snapshot_state(path)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            other = SketchEngine(cfg, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(other.load_snapshot_state(path), f"supervision: {label} did not resume")
            torch.cuda.synchronize()
            load_ms.append((time.perf_counter() - t0) * 1e3)
            for (leaf, a), (_, b) in zip(named_leaves(eng.state), named_leaves(other.state)):
                check(b.device == a.device, f"supervision: {label} loaded {leaf} off the card")
                check(bool(torch.equal(a, b)), f"supervision: {label} leaf {leaf} did not "
                      "round-trip")
            other.stop()
        leaves = sum(t.numel() * t.element_size() for t in tensor_leaves(eng.state))
        print(f"checkpoint at {label}: {leaves / 2 ** 20:.2f} MiB of leaves, file "
              f"{os.path.getsize(path) / 2 ** 20:.2f} MiB (npz, compressed); save ms "
              f"{[round(x, 1) for x in save_ms]}, load ms {[round(x, 1) for x in load_ms]} "
              "(host clock, the file warm in the page cache)", flush=True)
        eng.stop()

    # -- 1. checkpoint and fault --------------------------------------------
    cfg = Config(snapshot_dir=tmp, watchdog_deadline_s=SUP_DEADLINE_S, watchdog_interval_s=0.1)
    sup = Supervisor(deadline_s=cfg.watchdog_deadline_s, interval_s=cfg.watchdog_interval_s)
    sup.start()
    eng = SketchEngine(cfg, device=dev, supervisor=sup)
    eng.update_identities(pods)
    eng.flush(quanta[0], 100)
    checkpointed = packets(quanta[0])
    eng.save_snapshot_state(eng._snapshot_path)
    check(int(to_numpy(eng.state.totals)[0]) == checkpointed & 0xFFFFFFFF,
          "supervision: totals[0] != the checkpointed packets")
    restarts0 = m.engine_restarts._value
    try:
        faults.configure("transfer:raise@1,recover:hang30")
        async_dispatch(eng, quanta[1], 101)
        # -- 2. degraded mode ---------------------------------------------
        wait(lambda: eng.degraded, "degraded mode")
        check(m.degraded_mode._value == 1, "supervision: degraded_mode is not 1")
        n_dropped = async_dispatch(eng, quanta[2], 102)
        check(eng.lost_events["degraded"] == n_dropped > 0,
              f"supervision: {eng.lost_events['degraded']} degraded drops, not {n_dropped}")
        print(f"supervision: degraded after the injected transfer fault; {n_dropped} events "
              "of the second dispatch dropped and counted", flush=True)
        # -- 3. recovery ---------------------------------------------------
        kops.reset_launch_counts()
        t_rel = time.perf_counter()
        faults.release_hangs()
        wait(lambda: not eng.degraded, "the recovery")
        released_s = time.perf_counter() - t_rel
    finally:
        faults.clear()
    probe = kops.launch_counts()
    check(eng.restarts == 1 and m.engine_restarts._value - restarts0 == 1,
          f"supervision: restarts {eng.restarts}")
    check(not eng.recovery_failed.is_set(), "supervision: recovery_failed is set")
    check(m.degraded_mode._value == 0, "supervision: degraded_mode is not 0")
    check(eng._last_resume_src.startswith("resumed"), f"supervision: {eng._last_resume_src}")
    rec_s = {s: v for s, _, v in m.recovery_seconds.samples()}
    print(f"supervision: recovered ({eng._last_resume_src}); recovery_seconds sum "
          f"{rec_s['_sum']:.3f} s over {int(rec_s['_count'])} recoveries, the injected hang "
          f"included; {released_s:.3f} s from the hang's release to the end of degraded mode "
          f"(fence, rebuild from the checkpoint, probe); the probe's launches "
          f"{ {k: v for k, v in probe.items() if v} }", flush=True)
    for k in ("ingest_packed", "step_rows"):
        check(probe[k] >= 1, f"supervision: the probe did not launch {k}")
    # -- 4. the steps after the probe, against the checkpoint's replay ------
    other = SketchEngine(Config(), device=dev)
    other.update_identities(pods)
    check(other.load_snapshot_state(eng._snapshot_path), "supervision: the replay did not resume")
    kops.reset_launch_counts()
    outs = []
    for e in (eng, other):
        ctx = contextlib.nullcontext() if e is eng else kops.plain_versions()
        with ctx:
            for i, q in enumerate(quanta[1:]):
                e.flush(q, 110 + i)
            win = e.close_window(epoch=7)
            snap = e.snapshot(max_age_s=0, now_s=120)
        # The engines' own counts (steps, events since the engine began)
        # differ by construction; the state's are compared.
        snap = {k: v for k, v in snap.items() if k not in ("steps", "events_in")}
        outs.append((win, snap))
        if e is eng:
            after = kops.launch_counts()
    for k in ("ingest_new", "step_rows", "hh_update", "hll_update", "entropy_update",
              "conntrack", "latency_update", "window_close", "snapshot_flat"):
        check(after[k] > 0, f"supervision: {k} was not launched after the recovery")
    check(kops.launch_counts() == after, "supervision: the plain replay launched kernels")
    for (leaf, a), (_, b) in zip(named_leaves(eng.state), named_leaves(other.state)):
        if a.dtype == torch.int32:
            equal_int(a, b, f"supervision state {leaf}")
        elif leaf == "entropy.counts":
            close_counts(a, b, "supervision entropy counts")
        else:
            close_float(a, b, f"supervision state {leaf}")
    equal_any(outs[0][0], outs[1][0], "supervision window")
    equal_any(outs[0][1], outs[1][1], "supervision snapshot")
    fed = checkpointed + packets(quanta[1]) + packets(quanta[2])
    check(int(to_numpy(eng.state.totals)[0]) == fed & 0xFFFFFFFF,
          "supervision: totals[0] != the checkpointed packets plus those fed after recovery")
    print(f"supervision: after the probe, 2 quanta and a close: state, window and snapshot "
          f"equal to the checkpoint's plain replay; totals[0] {fed}; launches {after}",
          flush=True)
    eng.stop()
    other.stop()
    sup.stop()
    # -- 5. a torn checkpoint -----------------------------------------------
    torn = os.path.join(tmp, "torn.npz")
    try:
        faults.configure("checkpoint:corrupt@1")
        eng.save_snapshot_state(torn)
    finally:
        faults.clear()
    fresh = SketchEngine(Config(), device=dev)
    check(fresh.load_snapshot_state(torn) is False, "supervision: the torn checkpoint resumed")
    check(not os.path.exists(torn) and os.path.exists(torn + ".bad"),
          "supervision: the torn checkpoint was not quarantined")
    for leaf, t in named_leaves(fresh.state):
        check(t.device.type == dev.type and not bool(t.any()),
              f"supervision: the cold start's {leaf} is not zero on the card")
    fresh.stop()
    print("supervision: the torn checkpoint was quarantined to .bad; cold start on the card",
          flush=True)
    # -- the sticky-error child ---------------------------------------------
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--sticky-child"], capture_output=True,
                          text=True, timeout=STICKY_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"sticky"')]
    check(proc.returncode == 0 and len(lines) == 1,
          f"supervision: the sticky child exited {proc.returncode}: {proc.stdout[-2000:]} "
          f"{proc.stderr[-3000:]}")
    res = json.loads(lines[0])["sticky"]
    check(res["poisoned"] and res["stepped_before"] and res["recovery_failed"]
          and res["state_device"].startswith("cuda") and res["restarts"] == 0
          and res["attempts"] == 2 and res["degraded"] and res["lanes_stopped"],
          f"supervision: the sticky child {res}")
    print(f"supervision: the sticky-error child: {res}; exit {proc.returncode} after "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"supervision phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


DAEMON_PCAP = "loopback_mixed_real.pcap"  # the daemon phase's capture (tests/fixtures/real)
DAEMON_SYNTH_S = 10.0  # seconds of the default synthetic source at its default rate
DAEMON_PODS = 2047  # pods in the identity cache besides the capture's: the bench traffic's
DAEMON_WAIT_S = 120.0  # the bound on each wait of the daemon phase
DAEMON_CHILD_S = 300.0  # the bound on the agent child's boot
PUBLISH_S = 1.0  # the metrics module's publication interval
DAEMON_KERNELS = ("step_rows", "hh_update", "hll_update", "entropy_update", "conntrack",
                  "latency_update", "ingest_packed", "ingest_new", "window_close",
                  "snapshot_flat", "fold", "topk_join", "cms_query", "portscan_score",
                  "bank_close")


def scraped_pod_sums(text: str):
    """{(pod, direction): (packets, bytes)} of an exposition's pod forward
    series and {(pod, reason): ...} of its drop series, nonzero ones."""
    vals: dict = {}
    for line in text.splitlines():
        if not line.startswith("networkobservability_adv_") or "{" not in line:
            continue
        name, rest = line.split("{", 1)
        labels, value = rest.rsplit("} ", 1)
        lv = dict(kv.split("=", 1) for kv in labels.split(","))
        lv = {k: v.strip('"') for k, v in lv.items()}
        vals[(name, lv.get("podname"), lv.get("direction") or lv.get("reason"))] = int(
            float(value))
    out = []
    for kind in ("forward", "drop"):
        d = {}
        for (name, pod, key), v in vals.items():
            if name == f"networkobservability_adv_{kind}_count":
                b = vals.get((f"networkobservability_adv_{kind}_bytes", pod, key), 0)
                if v or b:
                    d[(pod, key)] = (v, b)
        out.append(d)
    return tuple(out)


def capture_pod_sums(rec, names: dict[str, str]):
    """The pipeline's pod attribution of the records ``rec`` under
    ``names`` (address -> pod): the destination's pod for ingress rows, the
    source's otherwise; ({(pod, direction): (packets, bytes)} of the
    forwarded rows, {(pod, reason): ...} of the dropped ones)."""
    from retina_tpu_torch.events.schema import (
        DIR_INGRESS,
        VERDICT_DROPPED,
        VERDICT_FORWARDED,
        F,
        u32_to_ip,
    )
    from retina_tpu_torch.plugins.dropreason import DROP_REASONS

    ingress = ((rec[:, F.META] >> 4) & 0xF) == DIR_INGRESS
    local = np.where(ingress, rec[:, F.DST_IP], rec[:, F.SRC_IP])
    fwd: dict = {}
    drop: dict = {}
    for r, ing, ip in zip(rec, ingress, local):
        pod, pk, by = names[u32_to_ip(int(ip))], int(r[F.PACKETS]), int(r[F.BYTES])
        if r[F.VERDICT] == VERDICT_FORWARDED:
            key, tab = (pod, "ingress" if ing else "egress"), fwd
        elif r[F.VERDICT] == VERDICT_DROPPED:
            key, tab = (pod, DROP_REASONS.get(int(r[F.DROP_REASON]), str(int(r[F.DROP_REASON])))
                        ), drop
        else:
            continue
        tab[key] = tuple(a + b for a, b in zip(tab.get(key, (0, 0)), (pk, by)))
    return fwd, drop


def daemon_phase(dev, equal_int, close_counts, close_float, equal_any) -> None:
    """The node agent as users start it, on the card: ``Daemon(load_config(None,
    overrides=...))`` at ``Config()`` with the time-travel ring, the detector
    bank, a checkpoint directory in a temp dir (``snapshot_interval_s`` 1)
    and an apiserver watcher on 127.0.0.1 (K14's input), its identity cache
    holding DAEMON_PODS pods and one pod an address of the capture, started
    on a thread and waited for until ready. The plugins are the default set
    (packetparser, dropreason, packetforward, dns, with conntrack's GC).

    (a) packetparser replays one in-repo capture once: the scraped pod-level
    forward and drop packet and byte series must equal the decoded
    capture's sums exactly. (b) the default synthetic source (a second
    packetparser on the engine's sink) runs at its default 1e6 events/s for
    DAEMON_SYNTH_S. Then /metrics twice, /debug/vars (top_flows) and
    ``/timetravel/query?last=8``; the launch counts, set to 0 when the agent
    was ready, must show K7, K1-K5, K14, K16, K17, K8-K10, K11 and the
    bank's close. The engine is instrumented as the runtime phase's
    (``instrument``), and after the stop its log is replayed synchronously
    under the plain versions in a second engine: state, step summaries,
    published windows and the snapshot must be equal. The shutdown
    checkpoint must load into a fresh engine with an equal state. Last, a
    child ``python3 -m retina_tpu_torch agent`` with the defaults is
    scraped once and sent SIGTERM: it must exit 0. Prints boot-to-ready,
    events/s and the scrape's ms."""
    import os
    import signal
    import socket
    import tempfile
    import threading
    import urllib.request
    from pathlib import Path

    import torch

    from retina_tpu_torch.common import RetinaEndpoint
    from retina_tpu_torch.config import load_config
    from retina_tpu_torch.daemon import Daemon
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.schema import F, u32_to_ip
    from retina_tpu_torch.events.synthetic import pod_ip
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.plugins.packetparser import PacketParserPlugin
    from retina_tpu_torch.sources.pcapdecode import decode_pcap_bytes

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    rec = decode_pcap_bytes((root / "tests" / "fixtures" / "real" / DAEMON_PCAP).read_bytes()
                            ).records
    tmp = tempfile.mkdtemp(prefix="chip_smoke_daemon_")

    def wait(pred, what: str, bound: float = DAEMON_WAIT_S) -> None:
        deadline = time.monotonic() + bound
        while not pred():
            check(time.monotonic() < deadline, f"daemon phase: timed out waiting for {what}")
            time.sleep(0.02)

    def get(port: int, path: str) -> tuple[str, float]:
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            body = r.read().decode()
            check(r.status == 200, f"daemon phase: GET {path} answered {r.status}")
        return body, (time.perf_counter() - t0) * 1e3

    cfg = load_config(None, overrides=dict(
        api_server_addr="127.0.0.1:0", timetravel_enabled=True, detectors_enabled=True,
        snapshot_dir=tmp, snapshot_interval_s=1, event_source="pcap",
        pcap_path=str(root / "tests" / "fixtures" / "real" / DAEMON_PCAP), pcap_loop=False),
        env={})
    t_boot = time.perf_counter()
    d = Daemon(cfg, apiserver_host="127.0.0.1")
    ctor_s = time.perf_counter() - t_boot
    eng = d.cm.engine
    check(eng.device.type == "cuda", f"daemon phase: the agent runs on {eng.device}")
    # The capture's addresses, one pod each, then the bench traffic's pods,
    # as an identity watcher would list them at boot. The metrics module
    # pushes the filter table at each pod's event (the reference's dirty-pod
    # sync); one deferred push stands for the list's.
    ips = sorted({u32_to_ip(int(x)) for x in np.concatenate([rec[:, F.SRC_IP], rec[:, F.DST_IP]])})
    names = {ip: f"capture-{i}" for i, ip in enumerate(ips)}
    t_reg = time.perf_counter()
    with d.cm.filtermanager.deferred_push():
        for ip, name in names.items():
            d.cm.cache.update_endpoint(RetinaEndpoint(name=name, namespace="default", ips=(ip,)))
        for i in range(1, DAEMON_PODS + 1):
            d.cm.cache.update_endpoint(RetinaEndpoint(name=f"pod-{i}", namespace="default",
                                                      ips=(u32_to_ip(pod_ip(i)),)))
        want_ident = d.cm.cache.ip_index_map()
        wait(lambda: d.cm.filtermanager.ip_count() >= len(want_ident), "the pod events")
    wait(lambda: eng._ident_dict == want_ident, "the identity rebuild")
    reg_s = time.perf_counter() - t_reg
    log, published, summaries = [], [], []
    instrument(eng, log, published, summaries)
    stop = threading.Event()
    agent = threading.Thread(target=d.start, args=(stop,), name="daemon", daemon=True)
    t_start = time.perf_counter()
    agent.start()
    wait(lambda: d.cm._ready.is_set() or not agent.is_alive(), "the agent's ready")
    check(agent.is_alive(), "daemon phase: the agent died while booting")
    boot_s = ctor_s + time.perf_counter() - t_start
    kops.reset_launch_counts()
    port = d.cm.server.port
    print(f"daemon phase: boot to ready {boot_s:.3f} s (Daemon() {ctor_s:.3f} s, then start() "
          f"to ready; kernels already built in this process); {len(want_ident)} addresses "
          f"registered in {reg_s:.3f} s", flush=True)

    # (a) the capture, once, through packetparser's pcap source.
    want_fwd, want_drop = capture_pod_sums(rec, names)
    wait(lambda: eng.counts.events == len(rec), "the capture to be stepped")
    got = [None]

    def scraped() -> bool:
        got[0] = scraped_pod_sums(get(port, "/metrics")[0])
        return got[0] == (want_fwd, want_drop)

    wait(scraped, f"the scrape to hold the capture's sums {(want_fwd, want_drop)}", 30)
    print(f"daemon phase (a): {DAEMON_PCAP}: {len(rec)} events; the scraped pod series equal "
          f"the decoded capture's sums: forward {want_fwd}, drop {want_drop}; overload "
          f"{eng.overload_stats()['state']}", flush=True)

    # (b) the default synthetic source at its default rate.
    class CountingSink:
        def __init__(self, inner):
            self.inner, self.offered, self.accepted = inner, 0, 0

        def write_records(self, records, plugin):
            n = self.inner.write_records(records, plugin)
            self.offered += len(records)
            self.accepted += n
            return n

    synth = PacketParserPlugin(dataclasses.replace(cfg, event_source="synthetic"))
    sink = CountingSink(eng.sink)
    synth.set_sink(sink)
    synth.generate()
    synth.compile()
    synth.init()
    ev0 = eng.counts.events
    stop_b = threading.Event()
    src = threading.Thread(target=synth.start, args=(stop_b,), name="synthetic", daemon=True)
    t_b = time.perf_counter()
    src.start()
    while time.perf_counter() - t_b < DAEMON_SYNTH_S:
        time.sleep(min(1.0, max(0.0, DAEMON_SYNTH_S - (time.perf_counter() - t_b))))
        print(f"daemon phase (b) at {time.perf_counter() - t_b:.1f} s: overload "
              f"{overload_line(eng.overload_stats())}", flush=True)
    stop_b.set()
    src.join(30)
    check(not src.is_alive(), "daemon phase: the synthetic source did not stop")
    fed = sink.accepted
    wait(lambda: eng.counts.events - ev0 + eng.lost_events["handoff"] >= fed,
         "the synthetic events to be stepped")
    wall_b = time.perf_counter() - t_b
    stepped = eng.counts.events - ev0
    print(f"daemon phase (b): synthetic source {sink.offered} events offered in "
          f"{DAEMON_SYNTH_S:.1f} s ({sink.offered / DAEMON_SYNTH_S:.0f}/s), sink took "
          f"{sink.accepted}; {stepped} stepped in {wall_b:.3f} s: {stepped / wall_b:.0f} "
          f"events/s; lost {dict(eng.lost_events)}; overload {eng.overload_stats()['state']}; "
          f"windows {dict(eng.windows)}", flush=True)
    time.sleep(1.5 * cfg.window_seconds)  # the last fed window closes
    ov_run = eng.overload_stats()
    # Under SHEDDING and above the pod series publish without their labels
    # (the "labels" stage); the controller steps down a level a dwell.
    t_calm = time.perf_counter()
    wait(lambda: eng.overload_stats()["state"] == "NOMINAL", "the overload controller's NOMINAL")
    time.sleep(2 * PUBLISH_S)  # a publication with the labels
    print(f"daemon phase: overload at the run's end {ov_run['state']} "
          f"{dict(ov_run['counters'])}; NOMINAL {time.perf_counter() - t_calm:.1f} s later",
          flush=True)
    _, scrape1 = get(port, "/metrics")
    time.sleep(cfg.metrics_cache_ttl_s)
    text, scrape2 = get(port, "/metrics")
    check("podname=\"pod-1\"" in text and "retina_build_info" in text,
          "daemon phase: the scrape lacks the pod series or the build info")
    body, vars_ms = get(port, "/debug/vars")
    dv = json.loads(body)
    check(bool(dv["top_flows"]) and dv["engine"]["events_in"] == eng.counts.events,
          "daemon phase: /debug/vars lacks top_flows or the engine's events")
    wait(lambda: eng.timetravel_ring.drain(1.0), "the ring's readback")
    body, query_ms = get(port, "/timetravel/query?last=8")
    doc = json.loads(body)
    check(doc["windows"] >= 1 and bool(doc["topk"]["keys"]),
          f"daemon phase: the range query answered {body[:200]}")
    launches = kops.launch_counts()
    print(f"daemon phase: GET /metrics {scrape1:.1f} ms then {scrape2:.1f} ms "
          f"({len(text)} bytes); /debug/vars {vars_ms:.1f} ms; /timetravel/query?last=8 "
          f"{query_ms:.1f} ms ({doc['windows']} windows); launches {launches}", flush=True)
    check_sketch_launches(launches, "daemon phase")
    for name in DAEMON_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the daemon phase")

    stop.set()
    agent.join(120)
    check(not agent.is_alive(), "daemon phase: the agent did not stop")
    path = Path(tmp) / "sketch_state.npz"
    check(path.exists(), "daemon phase: no shutdown checkpoint")
    check(not eng.errors and not eng.lost_events.get("dispatch")
          and not eng.lost_events.get("device"), f"daemon phase: errors {dict(eng.errors)}, "
          f"lost {dict(eng.lost_events)}")

    # The run's log, synchronously, under the plain versions.
    t0 = time.perf_counter()
    ref = SketchEngine(cfg, device=dev)
    ref.update_identities(d.cm.cache.ip_index_map())
    ref.update_filter_ips(set(d.cm.filtermanager._refs))
    ref.set_apiserver_ips([eng.apiserver_ip])
    rlog, rpub, rsum = [], [], []
    instrument(ref, rlog, rpub, rsum)
    before = kops.launch_counts()
    with kops.plain_versions():
        for entry in log:
            if entry[0] == "step":
                ref._dispatch_sharded(*entry[1:])
            else:
                ref._close_window()
        ref._harvest_window(timeout=60)
        snap = ref.snapshot(max_age_s=0, now_s=RT_NOW)
    check(kops.launch_counts() == before, "the plain replay of the daemon phase launched kernels")
    for (leaf, x), (_, y) in zip(named_leaves(eng.state), named_leaves(ref.state)):
        if x.dtype == torch.int32:
            equal_int(x, y, f"daemon phase state {leaf}")
        elif leaf == "entropy.counts":
            close_counts(x, y, "daemon phase entropy counts")
        else:
            close_float(x, y, f"daemon phase state {leaf}")
    check(len(summaries) == len(rsum), f"daemon phase: {len(summaries)} steps, the replay "
          f"{len(rsum)}")
    for i, (x, y) in enumerate(zip(summaries, rsum)):
        equal_any(x, y, f"daemon phase step summary {i}")
    check(len(published) == len(rpub), "daemon phase: windows published differ")
    for i, ((wx, _), (wy, _)) in enumerate(zip(published, rpub)):
        equal_any({k: torch.from_numpy(np.asarray(wx[k])) for k in ("entropy_bits", "anomaly",
                                                                     "zscore")},
                  {k: torch.from_numpy(np.asarray(wy[k])) for k in ("entropy_bits", "anomaly",
                                                                     "zscore")},
                  f"daemon phase window {i}")
    mine = eng.snapshot(max_age_s=0, now_s=RT_NOW)
    counters = ("steps", "events_in")  # the engines' own counts, not state
    equal_any({k: v for k, v in mine.items() if k not in counters},
              {k: v for k, v in snap.items() if k not in counters}, "daemon phase snapshot")
    ref.stop()
    replay_s = time.perf_counter() - t0
    fresh = SketchEngine(cfg, device=dev)
    check(fresh.load_snapshot_state(str(path)), "daemon phase: the checkpoint did not load")
    for (leaf, x), (_, y) in zip(named_leaves(eng.state), named_leaves(fresh.state)):
        check(torch.equal(x, y), f"daemon phase: the checkpoint's {leaf} differs")
    fresh.stop()
    print(f"daemon phase: the plain replay of {len(log)} dispatches and closes ({replay_s:.1f} s) "
          f"equals the run: state, {len(rsum)} step summaries, {len(rpub)} windows, the "
          f"snapshot; the shutdown checkpoint ({path.stat().st_size} bytes) reloads equal",
          flush=True)
    del log, summaries, published, rlog, rsum, rpub

    # The agent as a user starts it, in a process of its own.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        child_port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("RETINA_")}
    out_path = Path(tmp) / "agent.log"
    t_child = time.perf_counter()
    with open(out_path, "w") as out:
        child = subprocess.Popen(
            [sys.executable, "-m", "retina_tpu_torch", "agent", "--set",
             f"api_server_addr=127.0.0.1:{child_port}"],
            cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        def child_ready() -> bool:
            check(child.poll() is None, "daemon phase: the agent child exited while booting: "
                  + out_path.read_text()[-2000:])
            try:
                return get(child_port, "/readyz")[0] == "ok"
            except OSError:
                return False

        wait(child_ready, "the agent child's /readyz", DAEMON_CHILD_S)
        child_boot = time.perf_counter() - t_child
        text, child_ms = get(child_port, "/metrics")
        check("networkobservability_tpu_uptime_seconds" in text,
              "daemon phase: the agent child's scrape lacks the uptime")
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    tail = out_path.read_text()[-2000:]
    check(rc == 0, f"daemon phase: the agent child exited {rc}: {tail}")
    check("agent shut down" in tail, f"daemon phase: the agent child did not shut down: {tail}")
    print(f"daemon phase: python3 -m retina_tpu_torch agent: boot to ready {child_boot:.3f} s "
          f"(the process's start, torch's import and the kernels' cached build included); "
          f"GET /metrics {child_ms:.1f} ms ({len(text)} bytes); exit {rc} on SIGTERM",
          flush=True)
    print(f"daemon phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


class FakeKube:
    """A kube-apiserver on 127.0.0.1 for the kube phase and the CPU tests,
    on the standard library: LIST and chunked WATCH (with resourceVersion
    resumption and bookmarks) of any resource under ``/api/v1`` or
    ``/apis/<group>/<version>``, GET of one object, POST, PUT (a stale
    ``metadata.resourceVersion`` answers 409, an absent object 404),
    DELETE, and the ``/status`` merge-PATCH. Objects and their events are
    made by the caller (``add``, ``modify``, ``delete``); ``bookmark``,
    ``expire`` (a 410 ``ERROR`` event on every open stream), ``drop`` (open
    streams cut without their last chunk) and ``forget`` (an object removed
    with no event: a delete the watch missed) script the rest. Every
    request is logged in ``requests`` as (method, path, Authorization),
    every write in ``writes`` as (method, path, body). ``tls`` is an
    ``ssl.SSLContext`` to serve HTTPS."""

    def __init__(self, tls=None) -> None:
        import threading
        from http.server import ThreadingHTTPServer

        self.cond = threading.Condition()
        self.rv = 1
        self.objects: dict[str, dict[str, dict]] = {}  # resource -> key -> object
        self.events: dict[str, list[tuple[int, dict]]] = {}  # resource -> (rv, event)
        self.cuts: dict[str, list[str]] = {}  # resource -> "expire"/"drop", in order
        self.refuse: dict[str, int] = {}  # resource -> WATCH requests to refuse
        self.open: dict[str, int] = {}  # resource -> streams open
        self.hangups = 0
        self.lists: dict[str, int] = {}
        self.list_at: dict[str, list[float]] = {}  # resource -> time.monotonic() of each LIST
        self.watches: dict[str, int] = {}
        self.requests: list[tuple[str, str, str]] = []
        self.writes: list[tuple[str, str, dict]] = []
        self.closed = False
        fake = self

        handler = type("KubeHandler", (_kube_handler(),), {"kube": fake})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.httpd.daemon_threads = True
        if tls is not None:
            self.httpd.socket = tls.wrap_socket(self.httpd.socket, server_side=True)
        self.port = self.httpd.server_address[1]
        self.url = f"{'https' if tls is not None else 'http'}://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="fakekube",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        with self.cond:
            self.closed = True
            self.cond.notify_all()
        self.httpd.shutdown()
        self.httpd.server_close()

    def kubeconfig(self, path, token: str = "tok", cluster: dict | None = None,
                   user: dict | None = None) -> str:
        """Write a kubeconfig for this server at ``path``; returns it."""
        import yaml

        with open(path, "w") as fh:
            yaml.safe_dump({
                "apiVersion": "v1", "kind": "Config", "current-context": "smoke",
                "contexts": [{"name": "smoke", "context": {"cluster": "c", "user": "u"}}],
                "clusters": [{"name": "c", "cluster": dict(cluster or {}, server=self.url)}],
                "users": [{"name": "u", "user": user if user is not None else {"token": token}}],
            }, fh)
        return str(path)

    # -- the script -----------------------------------------------------
    @staticmethod
    def key(obj: dict) -> str:
        meta = obj.get("metadata", {}) or {}
        return f"{meta.get('namespace', '')}/{meta.get('name', '')}"

    def _event(self, resource: str, etype: str, obj: dict) -> dict:
        import copy

        with self.cond:
            self.rv += 1
            obj = copy.deepcopy(obj)
            obj.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
            store = self.objects.setdefault(resource, {})
            if etype == "DELETED":
                store.pop(self.key(obj), None)
            elif etype != "BOOKMARK":
                store[self.key(obj)] = obj
            ev = {"type": etype, "object": obj}
            self.events.setdefault(resource, []).append((self.rv, ev))
            self.cond.notify_all()
        return obj

    def add(self, resource: str, obj: dict, event: bool = True) -> dict:
        """Store ``obj`` under ``resource`` (e.g. "/api/v1/pods"); with
        ``event`` an ADDED event goes to the watchers too."""
        if event:
            return self._event(resource, "ADDED", obj)
        with self.cond:
            self.rv += 1
            obj = dict(obj, metadata=dict(obj.get("metadata", {}),
                                          resourceVersion=str(self.rv)))
            self.objects.setdefault(resource, {})[self.key(obj)] = obj
        return obj

    def modify(self, resource: str, obj: dict) -> dict:
        return self._event(resource, "MODIFIED", obj)

    def delete(self, resource: str, obj: dict) -> dict:
        return self._event(resource, "DELETED", obj)

    def bookmark(self, resource: str) -> None:
        self._event(resource, "BOOKMARK", {"kind": "Bookmark", "metadata": {}})

    def forget(self, resource: str, key: str) -> None:
        with self.cond:
            self.objects.get(resource, {}).pop(key, None)

    def expire(self, resource: str) -> None:
        with self.cond:
            self.cuts.setdefault(resource, []).append("expire")
            self.cond.notify_all()

    def end(self, resource: str) -> None:
        with self.cond:
            self.cuts.setdefault(resource, []).append("end")
            self.cond.notify_all()

    def hangup(self) -> None:
        """End every open stream cleanly: watchers whose stop is set leave
        at once instead of waiting out ``timeoutSeconds``."""
        with self.cond:
            self.hangups += 1
            self.cond.notify_all()

    def drop(self, resource: str) -> None:
        with self.cond:
            self.cuts.setdefault(resource, []).append("drop")
            self.refuse[resource] = self.refuse.get(resource, 0) + self.open.get(resource, 0)
            self.cond.notify_all()

    def wait(self, pred, bound: float, what: str) -> None:
        """Wait until ``pred()`` holds (under the server's lock)."""
        import time as _time

        deadline = _time.monotonic() + bound
        with self.cond:
            while not pred():
                left = deadline - _time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"fake apiserver: timed out waiting for {what}")
                self.cond.wait(min(left, 0.1))

    def items(self, resource: str, namespace: str = "") -> list[dict]:
        with self.cond:
            return [o for k, o in self.objects.get(resource, {}).items()
                    if not namespace or k.startswith(namespace + "/")]


def _kube_path(path: str):
    """(resource, namespace, name, subresource, query) of an apiserver
    path: resource is the collection's path without its namespace, e.g.
    "/api/v1/pods" or "/apis/cilium.io/v2/ciliumendpoints"."""
    from urllib.parse import parse_qs, urlsplit

    u = urlsplit(path)
    parts = [p for p in u.path.split("/") if p]
    if parts[:1] == ["api"]:
        base, rest = f"/api/{parts[1]}", parts[2:]
    else:
        base, rest = f"/apis/{parts[1]}/{parts[2]}", parts[3:]
    ns = ""
    if len(rest) >= 3 and rest[0] == "namespaces":
        ns, rest = rest[1], rest[2:]
    return (f"{base}/{rest[0]}", ns, rest[1] if len(rest) > 1 else "",
            rest[2] if len(rest) > 2 else "", parse_qs(u.query))


def _kube_handler():
    """The request handler class of ``FakeKube`` (built on first use, so
    that importing this script loads no HTTP server)."""
    import copy
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked WATCH streams
        kube: FakeKube

        def log_message(self, *args) -> None:
            pass

        def _send(self, code: int, doc: dict) -> None:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _status(self, code: int, reason: str) -> None:
            self._send(code, {"kind": "Status", "apiVersion": "v1", "status": "Failure",
                              "reason": reason, "code": code})

        def _start(self, write: bool):
            k = self.kube
            n = int(self.headers.get("Content-Length", 0) or 0)
            body = json.loads(self.rfile.read(n)) if n else {}
            with k.cond:
                k.requests.append((self.command, self.path,
                                   self.headers.get("Authorization", "")))
                if write:
                    k.writes.append((self.command, self.path, copy.deepcopy(body)))
            return (*_kube_path(self.path), body)

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.flush()

        def do_GET(self) -> None:
            k = self.kube
            res, ns, name, _, q, _ = self._start(False)
            if q.get("watch") == ["true"]:
                self._watch(res, ns, q)
                return
            with k.cond:
                if name:
                    obj = k.objects.get(res, {}).get(f"{ns}/{name}")
                else:
                    k.lists[res] = k.lists.get(res, 0) + 1
                    k.list_at.setdefault(res, []).append(time.monotonic())
                    items = [o for key, o in k.objects.get(res, {}).items()
                             if not ns or key.startswith(ns + "/")]
                    doc = {"kind": "List", "apiVersion": "v1",
                           "metadata": {"resourceVersion": str(k.rv)}, "items": items}
                    k.cond.notify_all()
            if not name:
                self._send(200, doc)
            elif obj is None:
                self._status(404, "NotFound")
            else:
                self._send(200, obj)

        def _watch(self, res: str, ns: str, q: dict) -> None:
            k = self.kube
            deadline = time.monotonic() + float(q.get("timeoutSeconds", ["240"])[0])
            with k.cond:
                k.watches[res] = k.watches.get(res, 0) + 1
                sent = int(q.get("resourceVersion", ["0"])[0] or 0) or k.rv
                cut0 = len(k.cuts.get(res, []))
                hangups = k.hangups
                refused = k.refuse.get(res, 0) > 0
                if refused:
                    k.refuse[res] -= 1
                else:
                    k.open[res] = k.open.get(res, 0) + 1
                k.cond.notify_all()
            if refused:
                self.close_connection = True
                return
            try:
                self._stream(res, ns, sent, cut0, hangups, deadline)
            finally:
                with k.cond:
                    k.open[res] -= 1

        def _stream(self, res: str, ns: str, sent: int, cut0: int, hangups: int,
                    deadline: float) -> None:
            k = self.kube
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self.wfile.flush()
            try:
                while True:
                    with k.cond:
                        while True:
                            if k.closed:
                                out = "drop"
                                break
                            # Events before a cut: the stream keeps their order.
                            out = [(rv, ev) for rv, ev in k.events.get(res, ())
                                   if rv > sent and (not ns or ev["object"].get(
                                       "metadata", {}).get("namespace", ns) == ns)]
                            if out:
                                break
                            cuts = k.cuts.get(res, [])
                            if len(cuts) > cut0:
                                out = cuts[cut0]
                                break
                            if k.hangups > hangups:
                                out = "end"
                                break
                            if time.monotonic() > deadline:
                                out = "timeout"
                                break
                            k.cond.wait(0.1)
                    if out == "drop":
                        # Cut without the last chunk (a client reads it as the
                        # stream's end); its next WATCH is refused.
                        self.close_connection = True
                        return
                    if out == "expire":
                        self._chunk(json.dumps({"type": "ERROR", "object": {
                            "kind": "Status", "apiVersion": "v1", "status": "Failure",
                            "message": "too old resource version", "reason": "Expired",
                            "code": 410}}).encode() + b"\n")
                    if out in ("expire", "end", "timeout"):
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                        return
                    for rv, ev in out:
                        self._chunk(json.dumps(ev).encode() + b"\n")
                        sent = rv
            except OSError:
                self.close_connection = True

        def do_POST(self) -> None:
            k = self.kube
            res, ns, _, _, _, body = self._start(True)
            meta = body.setdefault("metadata", {})
            if ns and not meta.get("namespace"):
                meta["namespace"] = ns
            with k.cond:
                if k.key(body) in k.objects.get(res, {}):
                    obj = None
                else:
                    obj = k._event(res, "ADDED", body)
            if obj is None:
                self._status(409, "AlreadyExists")
            else:
                self._send(201, obj)

        def do_PUT(self) -> None:
            k = self.kube
            res, ns, name, _, _, body = self._start(True)
            meta = body.setdefault("metadata", {})
            meta["name"] = name
            if ns:
                meta["namespace"] = ns
            with k.cond:
                cur = k.objects.get(res, {}).get(f"{ns}/{name}")
                if cur is None:
                    code = 404
                elif meta.get("resourceVersion", cur["metadata"]["resourceVersion"]) \
                        != cur["metadata"]["resourceVersion"]:
                    code = 409
                else:
                    code, obj = 200, k._event(res, "MODIFIED", body)
            if code == 200:
                self._send(200, obj)
            else:
                self._status(code, "NotFound" if code == 404 else "Conflict")

        def do_PATCH(self) -> None:
            k = self.kube
            res, ns, name, _, _, body = self._start(True)
            with k.cond:
                cur = k.objects.get(res, {}).get(f"{ns}/{name}")
                if cur is not None:
                    merged = copy.deepcopy(cur)
                    for field, value in body.items():
                        if isinstance(value, dict) and isinstance(merged.get(field), dict):
                            merged[field].update(value)
                        else:
                            merged[field] = value
                    obj = k._event(res, "MODIFIED", merged)
            if cur is None:
                self._status(404, "NotFound")
            else:
                self._send(200, obj)

        def do_DELETE(self) -> None:
            k = self.kube
            res, ns, name, _, _, _ = self._start(True)
            with k.cond:
                cur = k.objects.get(res, {}).get(f"{ns}/{name}")
                if cur is not None:
                    k._event(res, "DELETED", cur)
            if cur is None:
                self._status(404, "NotFound")
            else:
                self._send(200, cur)

    return Handler


class FakeStorage:
    """An object store on 127.0.0.1 for the kube phase and the CPU tests,
    on the standard library, speaking just enough of one dialect: "blob"
    (Azure Blob under a container path, ``restype=container&comp=list``
    with ``NextMarker``) or "s3" (keys as paths, ``list-type=2`` with
    ``NextContinuationToken``). PUT, GET, DELETE of an object; lists page
    at two names, so a client must follow the markers. Objects are in
    ``store`` (name -> bytes), every request in ``requests`` as (method,
    path, headers)."""

    def __init__(self, dialect: str) -> None:
        import threading
        from http.server import ThreadingHTTPServer

        self.dialect = dialect
        self.store: dict[str, bytes] = {}
        self.requests: list[tuple[str, str, dict]] = []
        handler = type("StorageHandler", (_storage_handler(),), {"storage": self})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="fakestorage",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _storage_handler():
    """The request handler class of ``FakeStorage`` (built on first use)."""
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qsl, unquote, urlsplit

    class Handler(BaseHTTPRequestHandler):
        storage: FakeStorage

        def log_message(self, *args) -> None:
            pass

        def _name(self) -> str:
            path = urlsplit(self.path).path.lstrip("/")
            # /container/name for blob, /name for s3 (the bucket is the host)
            return unquote(path.split("/", 1)[1] if self.storage.dialect == "blob" else path)

        def _reply(self, code: int, data: bytes = b"") -> None:
            self.send_response(code)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_PUT(self) -> None:
            st = self.storage
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            st.requests.append(("PUT", self.path, dict(self.headers)))
            st.store[self._name()] = body
            self._reply(201 if st.dialect == "blob" else 200)

        def do_GET(self) -> None:
            st = self.storage
            q = dict(parse_qsl(urlsplit(self.path).query))
            st.requests.append(("GET", self.path, dict(self.headers)))
            if q.get("comp") != "list" and not q.get("list-type"):
                name = self._name()
                if name in st.store:
                    self._reply(200, st.store[name])
                else:
                    self._reply(404)
                return
            names = sorted(n for n in st.store if n.startswith(q.get("prefix", "")))
            after = q.get("marker", q.get("continuation-token", ""))
            if after:
                names = [n for n in names if n > after]
            page, rest = names[:2], names[2:]
            if st.dialect == "blob":
                items = "".join(
                    f"<Blob><Name>{n}</Name><Properties><Content-Length>{len(st.store[n])}"
                    f"</Content-Length><Last-Modified>now</Last-Modified></Properties></Blob>"
                    for n in page)
                nxt = f"<NextMarker>{page[-1]}</NextMarker>" if rest else "<NextMarker/>"
                body = f"<EnumerationResults><Blobs>{items}</Blobs>{nxt}</EnumerationResults>"
            else:
                items = "".join(f"<Contents><Key>{n}</Key><Size>{len(st.store[n])}</Size>"
                                f"<LastModified>now</LastModified></Contents>" for n in page)
                nxt = (f"<NextContinuationToken>{page[-1]}</NextContinuationToken>"
                       if rest else "")
                body = (f"<ListBucketResult><IsTruncated>{'true' if rest else 'false'}"
                        f"</IsTruncated>{items}{nxt}</ListBucketResult>")
            self._reply(200, body.encode())

        def do_DELETE(self) -> None:
            st = self.storage
            st.requests.append(("DELETE", self.path, dict(self.headers)))
            if st.store.pop(self._name(), None) is None:
                self._reply(404)
            else:
                self._reply(202 if st.dialect == "blob" else 204)

    return Handler


KUBE_PODS = 2048  # pods the apiserver lists: the capture's addresses, then pod_ip(1..)
KUBE_SERVICES = 64  # services over them, one an app label
KUBE_NODES = 8
KUBE_WAIT_S = 120.0  # the bound on each wait of the kube phase
KUBE_KERNELS = ("step_rows", "hh_update", "hll_update", "entropy_update", "conntrack",
                "latency_update", "window_close", "snapshot_flat")
KUBE_INGEST = ("ingest_packed", "ingest_new", "ingest_known")  # K7: any of its entries
OP_FRONT_NODES = ("node-3", "node-5", "node-7")  # the nodes of the pods labelled tier=front
OP_NODE = "node-7"  # the in-process operator's node: pod-7 there takes the capture's address
OP_WINDOW_S = 5  # the Capture's duration: the local capture's window
OP_FILTER = "port 41443"  # the Capture's raw filter: a third of the capture's packets pass
OP_EXT_IP = "192.0.2.9"  # the address a RetinaEndpoint CR gives a pod: no listed pod has it
OP_CHILD_NS = "retina-op"  # the operator child's namespace: its Captures and its Lease
OP_CHILD_WAIT_S = 240.0  # the bound on the child's unknown-node Capture: 24 deferrals of 5 s
OP_KERNELS = KUBE_KERNELS[:6]  # K1-K5 and K14 over the capture's window


def kube_pod_doc(name: str, ip: str, node: str, app: str) -> dict:
    labels = {"app": app, "tier": "front" if node in OP_FRONT_NODES else "back"}
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default", "labels": labels},
            "spec": {"nodeName": node, "containers": [{"name": "main"}]},
            "status": {"phase": "Running", "podIP": ip, "podIPs": [{"ip": ip}]}}


def kube_cep_doc(pod: dict) -> dict:
    """The CiliumEndpoint a Cilium agent publishes for ``pod``."""
    meta = pod["metadata"]
    labels = [f"k8s:{k}={v}" for k, v in meta["labels"].items()]
    labels.append(f"k8s:io.kubernetes.pod.namespace={meta['namespace']}")
    return {"apiVersion": "cilium.io/v2", "kind": "CiliumEndpoint",
            "metadata": {"name": meta["name"], "namespace": meta["namespace"]},
            "status": {"identity": {"id": 256, "labels": labels},
                       "networking": {"addressing": [{"ipv4": pod["status"]["podIP"]}],
                                      "node": pod["spec"]["nodeName"]},
                       "state": "ready"}}


CAPTURES_RES = "/apis/retina.sh/v1alpha1/captures"
JOBS_RES = "/apis/batch/v1/jobs"
LEASES_RES = "/apis/coordination.k8s.io/v1/leases"


def capture_cr(name: str, ns: str, target: dict, output: dict, **spec) -> dict:
    return {"apiVersion": "retina.sh/v1alpha1", "kind": "Capture",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"captureTarget": target, "outputConfiguration": output,
                     "duration": OP_WINDOW_S, **spec}}


def capture_status(kube: FakeKube, ns: str, name: str) -> dict:
    """The Capture's status on the apiserver ({} before the first PATCH)."""
    with kube.cond:
        doc = kube.objects.get(CAPTURES_RES, {}).get(f"{ns}/{name}", {})
        return dict(doc.get("status") or {})


def start_operator_child(kube: FakeKube, kc: str, root, tmp):
    """``python3 -m retina_tpu_torch operator --kubeconfig ... --leader-elect``
    in OP_CHILD_NS, and a Capture there for a node the cluster lacks.
    Returns the child, the Capture's apply time and the child's log."""
    import os

    env = {k: v for k, v in os.environ.items() if not k.startswith("RETINA_")}
    log = tmp / "operator.log"
    with open(log, "w") as out:
        child = subprocess.Popen(
            [sys.executable, "-m", "retina_tpu_torch", "operator", "--kubeconfig", kc,
             "--leader-elect", "--namespace", OP_CHILD_NS, "--node-name", "node-0"],
            cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    t_apply = time.monotonic()
    kube.add(CAPTURES_RES, capture_cr("ghost", OP_CHILD_NS, {"nodeNames": ["ghost-node"]},
                                      {"hostPath": str(tmp / "ghost")}))
    return child, t_apply, log


def stop_operator_child(kube: FakeKube, child, t_apply: float, log) -> float:
    """The child took its Lease, failed the unknown-node Capture on the
    apiserver and exits 0 on SIGTERM, releasing the Lease. Returns the
    Capture's apply-to-Failed seconds."""
    key = f"{OP_CHILD_NS}/retina-tpu-operator"

    def holder() -> str:
        return ((kube.objects.get(LEASES_RES, {}).get(key) or {}).get("spec") or {}).get(
            "holderIdentity", "")

    seen: dict = {}

    def failed() -> bool:
        check(child.poll() is None, "kube phase: the operator child exited: "
              + log.read_text()[-2000:])
        st = capture_status(kube, OP_CHILD_NS, "ghost")
        if st.get("phase") == "Failed":
            seen.setdefault("t", time.monotonic())
        return bool(seen)

    kube.wait(lambda: bool(holder()), KUBE_WAIT_S, "the operator child's Lease")
    deadline = t_apply + OP_CHILD_WAIT_S
    while not failed():
        check(time.monotonic() < deadline, "kube phase: the operator child did not fail the "
              f"unknown-node Capture: {capture_status(kube, OP_CHILD_NS, 'ghost')}")
        time.sleep(0.2)
    failed_s = seen["t"] - t_apply
    st = capture_status(kube, OP_CHILD_NS, "ghost")
    check("unknown nodes" in st.get("message", "") and "ghost-node" in st["message"],
          f"kube phase: the operator child failed the Capture with {st}")
    lessee = holder()
    child.send_signal(__import__("signal").SIGTERM)
    deadline = time.monotonic() + 60
    while child.poll() is None and time.monotonic() < deadline:
        kube.hangup()
        time.sleep(0.2)
    rc = child.wait(timeout=10)
    text = log.read_text()
    check(rc == 0 and "operator running" in text, f"kube phase: the operator child exited "
          f"{rc}: {text[-2000:]}")
    check(holder() == "", f"kube phase: the operator child left its Lease held by {holder()}")
    print(f"kube phase: python3 -m retina_tpu_torch operator --kubeconfig --leader-elect: "
          f"{lessee} took the Lease, failed the Capture for ghost-node {failed_s:.3f} s after "
          f"its apply ({st['message']!r}), exit {rc} on SIGTERM, the Lease released",
          flush=True)
    return failed_s


def operator_part(k) -> dict:
    """The operator and the capture paths beside the kube phase's first agent
    (``k``: its daemon, config, apiserver, plain replay and helpers), on the
    card. Returns the expected pod series after it."""
    import os
    import re

    from retina_tpu_torch.capture.k8s_jobs import KubeJobRunner
    from retina_tpu_torch.capture.manager import CaptureManager
    from retina_tpu_torch.capture.providers import (
        ReplayProvider,
        SocketProvider,
        TcpdumpProvider,
        best_provider,
    )
    from retina_tpu_torch.capture.translator import synthesize_filter
    from retina_tpu_torch.common import RetinaEndpoint
    from retina_tpu_torch.controllers.cache import Cache
    from retina_tpu_torch.events.schema import F, ip_to_u32, u32_to_ip
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.operator import CRDStore, Operator
    from retina_tpu_torch.operator.bridge import KubeBridge
    from retina_tpu_torch.operator.kubeclient import KubeClient
    from retina_tpu_torch.operator.kubewatch import CoreWatcher
    from retina_tpu_torch.operator.leaderelection import LeaderElector
    from retina_tpu_torch.sources.pcapdecode import decode_pcap_bytes, synthesize_pcap

    t_part = time.perf_counter()
    d, kube, eng, rec, wait = k.d, k.kube, k.d.cm.engine, k.rec, k.wait
    tmp = k.tmp
    blob, s3 = FakeStorage("blob"), FakeStorage("s3")
    aws = {"AWS_ACCESS_KEY_ID": "chip-smoke", "AWS_SECRET_ACCESS_KEY": "chip-smoke-key"}
    saved = {v: os.environ.get(v) for v in aws}
    os.environ.update(aws)  # the S3 output's credentials, from the standard variables
    store = CRDStore()
    bridge = KubeBridge(store, k.kc, namespace="default", kinds=["Capture"], retry_s=0.5)
    node_cache = Cache()
    nodewatch = CoreWatcher(node_cache, k.kc, include_pods=False, include_services=False,
                            include_nodes=True, retry_s=0.5)
    elector = LeaderElector(KubeClient(k.kc), identity="chip-smoke-operator",
                            lease_duration_s=15.0, renew_period_s=1.0)
    manager = CaptureManager(provider=ReplayProvider(engine=eng))
    local_s: list[float] = []
    run_local = manager.run_job

    def timed_local(job):
        t0 = time.perf_counter()
        try:
            return run_local(job)
        finally:
            local_s.append(time.perf_counter() - t0)

    manager.run_job = timed_local
    op = Operator(store, cache=d.cm.cache, node_name=OP_NODE, capture_manager=manager,
                  status_sink=bridge.patch_status, leading=elector.is_leader,
                  job_runner=KubeJobRunner(KubeClient(k.kc), image="retina-tpu-torch:smoke",
                                           poll_s=0.1),
                  cluster_nodes=node_cache.list_nodes)
    elector.on_started_leading = op.resync
    try:
        nodewatch.start()
        wait(lambda: len(node_cache.list_nodes()) == KUBE_NODES, "the operator's 8 nodes")
        elector.start()
        wait(elector.is_leader, "the operator's Lease")
        op.start()
        bridge.start()

        # The Capture: the tier=front pods of the LIST, on three nodes, the
        # operator's among them, into a host path, a blob container and a bucket.
        front = [ep for ep in k.plain.index_label_map().values()
                 if ep.namespace == "default" and ep.labels_dict().get("tier") == "front"]
        targets = sorted({ep.node for ep in front})
        check(targets == sorted(OP_FRONT_NODES) and OP_NODE in targets and any(
            "127.0.0.1" in ep.ips for ep in front), f"kube phase: the front pods' nodes {targets}")
        want_filter = synthesize_filter([ip for ep in front for ip in ep.ips], OP_FILTER)
        host_dir = tmp / "captures"
        output = {"hostPath": str(host_dir), "blobUpload": f"{blob.url}/captures?sig=smoke",
                  "s3Upload": {"bucket": "smoke", "region": "us-east-1", "endpoint": s3.url}}
        n_obs = len(eng._observers)
        t_apply = time.monotonic()
        kube.add(CAPTURES_RES, capture_cr("grab", "default", {"podSelector": {"tier": "front"}},
                                          output, tcpdumpFilter=OP_FILTER))
        wait(lambda: capture_status(kube, "default", "grab").get("phase") == "Running",
             "the Capture's Running", step=0.005)
        running_s = time.monotonic() - t_apply
        wait(lambda: len(eng._observers) > n_obs, "the local capture's window")
        kops.reset_launch_counts()
        k.replay(d, k.cfg)
        want = k.add_sums(k.want, capture_pod_sums(rec, k.names))
        # The kubelet: one Job a remote node, each pinned there, run once.
        remote = [n for n in targets if n != OP_NODE]
        kube.wait(lambda: len(kube.items(JOBS_RES, "default")) == len(remote), KUBE_WAIT_S,
                  "the remote Jobs")
        jobs = kube.items(JOBS_RES, "default")
        for job in jobs:
            pod = job["spec"]["template"]["spec"]
            args = pod["containers"][0]["args"]
            check(job["spec"]["backoffLimit"] == 0 and pod["hostNetwork"]
                  and args[:2] == ["capture", "create"]
                  and args[args.index("--filter") + 1] == want_filter
                  and job["metadata"]["labels"]["retina.sh/capture"] == "grab",
                  f"kube phase: remote Job {job['metadata']['name']}: {args[:12]}")
        check(sorted(j["spec"]["template"]["spec"]["nodeName"] for j in jobs) == remote,
              "kube phase: the Jobs' nodes")
        for job in jobs:
            kube.modify(JOBS_RES, dict(job, status={"succeeded": 1}))
        wait(lambda: capture_status(kube, "default", "grab").get("phase") in (
            "Completed", "Failed"), "the Capture's end")
        completed_s = time.monotonic() - t_apply
        launches = kops.launch_counts()
        st = capture_status(kube, "default", "grab")
        check(st["phase"] == "Completed" and st["jobs_completed"] == len(targets)
              and st["jobs_failed"] == 0, f"kube phase: the Capture's status {st}")
        for name in OP_KERNELS:
            check(launches[name] > 0, f"{name} was not launched over the capture's window")
        check(any(launches[name] for name in KUBE_INGEST),
              "K7 was not launched over the capture's window")

        # The artifact: exactly the replayed packets that pass the filter, in
        # each of the three outputs.
        (art,) = os.listdir(host_dir)
        data = (host_dir / art).read_bytes()
        check(blob.store.get(art) == data and s3.store.get(f"retina/captures/{art}") == data,
              f"kube phase: the artifact {art} is not in the blob container and the bucket")
        with tarfile.open(host_dir / art) as tf:
            (member,) = [n for n in tf.getnames() if n.endswith(".pcap")]
            pcap_bytes = tf.extractfile(member).read()
        # The filter evaluated here on its own: a host of the selected pods
        # and the port, on either side.
        hosts = set(re.findall(r"host ([0-9a-f.:]+)", want_filter))
        port_no = int(OP_FILTER.split()[1])
        keep = [r for r in rec
                if {u32_to_ip(int(r[F.SRC_IP])), u32_to_ip(int(r[F.DST_IP]))} & hosts
                and port_no in (int(r[F.PORTS]) >> 16, int(r[F.PORTS]) & 0xFFFF)]
        expect = synthesize_pcap([dict(
            src_ip=int(r[F.SRC_IP]), dst_ip=int(r[F.DST_IP]), sport=int(r[F.PORTS]) >> 16,
            dport=int(r[F.PORTS]) & 0xFFFF, proto=int(r[F.META]) >> 24,
            tcp_flags=(int(r[F.META]) >> 16) & 0xFF,
            ts_ns=(int(r[F.TS_HI]) << 32) | int(r[F.TS_LO]), tsval=int(r[F.TSVAL]),
            tsecr=int(r[F.TSECR])) for r in keep])
        got = decode_pcap_bytes(pcap_bytes).records
        check(pcap_bytes == expect and 0 < len(got) < len(rec),
              f"kube phase: the artifact holds {len(got)} packets, the replay's {len(keep)} "
              f"of {len(rec)} pass the filter")
        wait(lambda: scraped_pod_sums(k.get("/metrics")) == want,
             f"the scrape to hold the capture's sums {want}", 30)
        print(f"kube phase: Capture grab (tier=front: {len(front)} pods on {targets}; filter of "
              f"{len(hosts)} hosts and {OP_FILTER!r}) Running {running_s:.3f} s and Completed "
              f"{completed_s:.3f} s after its apply; local capture on {OP_NODE} "
              f"{local_s[0]:.3f} s on the host, its artifact {art} ({len(data)} bytes) holds the "
              f"{len(got)} of {len(rec)} replayed packets that pass the filter, in the host path, "
              f"the blob container and the bucket; {len(jobs)} batch/v1 Jobs on {remote}; the "
              f"pod series hold the replay's sums; launches over the window {launches}",
              flush=True)

        # A second Capture on the remote nodes, one Job failing.
        n_jobs = len(kube.items(JOBS_RES, "default"))
        kube.add(CAPTURES_RES, capture_cr("grab-fail", "default", {"nodeNames": remote},
                                          {"hostPath": str(tmp / "fail")}))
        kube.wait(lambda: len(kube.items(JOBS_RES, "default")) == n_jobs + len(remote),
                  KUBE_WAIT_S, "the second Capture's Jobs")
        fresh = [j for j in kube.items(JOBS_RES, "default") if not j.get("status")]
        for job, outcome in zip(fresh, ("failed", "succeeded")):
            kube.modify(JOBS_RES, dict(job, status={outcome: 1}))
        wait(lambda: capture_status(kube, "default", "grab-fail").get("phase") in (
            "Completed", "Failed"), "the second Capture's end")
        st2 = capture_status(kube, "default", "grab-fail")
        check(st2["phase"] == "Failed" and st2["jobs_failed"] == 1
              and st2["jobs_completed"] == len(remote) - 1,
              f"kube phase: the second Capture's status {st2}")

        # A RetinaEndpoint CR gives an unlisted address a pod; deleting it
        # takes the next replay's rows away from that pod.
        ext = tmp / "ext.pcap"
        ext.write_bytes(synthesize_pcap([dict(
            src_ip=ip_to_u32(OP_EXT_IP), dst_ip=ip_to_u32(OP_EXT_IP),
            sport=int(r[F.PORTS]) >> 16, dport=int(r[F.PORTS]) & 0xFFFF,
            proto=int(r[F.META]) >> 24, tcp_flags=(int(r[F.META]) >> 16) & 0xFF,
            ts_ns=(int(r[F.TS_HI]) << 32) | int(r[F.TS_LO])) for r in rec]))
        rec_ext = decode_pcap_bytes(ext.read_bytes()).records
        check(ip_to_u32(OP_EXT_IP) not in eng._ident_dict, f"kube phase: {OP_EXT_IP} is listed")
        store.apply("RetinaEndpoint", RetinaEndpoint(
            name="ext-0", namespace="default", ips=(OP_EXT_IP,), labels=(("app", "ext"),),
            node=OP_NODE))
        wait(lambda: ip_to_u32(OP_EXT_IP) in eng._ident_dict, "the endpoint on the card")
        k.replay(d, k.cfg, ext, len(rec_ext))
        want = k.add_sums(want, capture_pod_sums(rec_ext, {OP_EXT_IP: "ext-0"}))
        wait(lambda: scraped_pod_sums(k.get("/metrics")) == want,
             f"the scrape to hold ext-0's sums {want}", 30)
        store.delete("RetinaEndpoint", "ext-0", "default")
        wait(lambda: ip_to_u32(OP_EXT_IP) not in eng._ident_dict, "the endpoint's removal")
        k.replay(d, k.cfg, ext, len(rec_ext))
        k.replay(d, k.cfg)  # then the capture, whose rows go to pod-7: the scrape's clock
        want = k.add_sums(want, capture_pod_sums(rec, k.names))
        wait(lambda: scraped_pod_sums(k.get("/metrics")) == want,
             f"the scrape after the endpoint's deletion {want}", 30)
        print(f"kube phase: RetinaEndpoint ext-0 ({OP_EXT_IP}) through the operator: a replay "
              f"of {len(rec_ext)} packets went to its series; after its deletion the next "
              f"replay's did not; the second Capture Failed with {st2['jobs_failed']} of "
              f"{len(remote)} Jobs failed", flush=True)

        # The capture verb over the blob container.
        env = {v: x for v, x in os.environ.items() if not v.startswith(("RETINA_", "BLOB_"))}
        sas = f"{blob.url}/captures?sig=smoke"
        dl = tmp / "download"

        def verb(*argv: str) -> str:
            r = subprocess.run([sys.executable, "-m", "retina_tpu_torch", "capture", *argv,
                                "--blob-url", sas], cwd=k.root, env=env, capture_output=True,
                               text=True, timeout=120)
            check(r.returncode == 0, f"kube phase: capture {argv[0]} exited {r.returncode}: "
                  f"{r.stderr[-2000:]}")
            return r.stdout

        listed = verb("list")
        check(listed.split("\t")[:2] == [art, str(len(data))], f"kube phase: capture list "
              f"printed {listed!r}")
        verb("download", "--file", "capture-grab", "--output", str(dl))
        check((dl / art).read_bytes() == data, "kube phase: capture download's bytes")
        verb("delete", "--file", "capture-grab")
        check(blob.store == {}, f"kube phase: capture delete left {sorted(blob.store)}")
        choice = type(best_provider(engine=eng)).__name__
        print(f"kube phase: capture list, download and delete over the blob container "
              f"({art}); best_provider here: {choice} (tcpdump "
              f"{'found' if TcpdumpProvider.available() else 'absent'}, an AF_PACKET socket "
              f"{'opened' if SocketProvider.available() else 'refused'}); the operator part "
              f"{time.perf_counter() - t_part:.1f} s ({k.smi})", flush=True)
        return want
    finally:
        elector.stop()  # releases the Lease
        for part in (bridge, nodewatch):
            part._stop.set()
        kube.hangup()
        for part in (bridge, nodewatch):
            part.stop()
        blob.close()
        s3.close()
        for v, x in saved.items():
            if x is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = x


def kube_phase(smi: str):
    """The agent with its identity from a cluster, on the card: a fake
    kube-apiserver on 127.0.0.1 (``FakeKube``) lists KUBE_PODS pods (the
    capture's address, one pod, then ``pod_ip(1..)``), KUBE_SERVICES
    services and KUBE_NODES nodes, and the agent boots as users start it,
    ``Daemon(load_config(None, overrides={"kubeconfig": ...}))`` at
    ``Config()`` with an apiserver watcher on 127.0.0.1 (K14's input) and a
    capture with no packets as its own source. Its cache, the engine's
    identity map and the filter set must equal a plain replay of the LIST
    (the port's ``Cache`` fed the same documents in order), with one filter
    push for the LIST; the LIST-to-identity-ready seconds are printed.

    The in-repo capture replayed through a second packetparser: each
    scraped pod series equals the decoded capture's sums exactly, under the
    listed pod's name. WATCH events (a pod added, the capture's pod
    deleted, a pod whose IP becomes the capture's address, a service
    deleted, a bookmark and the stream's end, a 410 ``ERROR``, a dropped
    connection whose re-LIST omits a pod), each held against the plain
    replay. The capture again: its traffic goes to the pod that took the
    address; the deleted pod's series do not grow. A ``MetricsConfiguration``
    CR through the agent's ``KubeBridge`` (forward and drop only): the
    next scrapes lack the other families; deleting it returns the
    defaults. The launch counts since ready must show K7, K1-K5, K14, K16
    and K17. Then a second agent with ``identity_source="cilium"`` over
    CiliumEndpoints of the same pods: its series from one replay equal the
    first agent's. Last, a child ``python3 -m retina_tpu_torch agent
    --kubeconfig`` answers /metrics with a listed pod's series and exits 0
    on SIGTERM.

    Before the first agent stops, the operator and the capture paths run
    beside it (``operator_part``). A child ``python3 -m retina_tpu_torch
    operator --kubeconfig --leader-elect`` starts with the phase and is given
    a Capture for a node the cluster lacks, which the reference's operator
    defers 24 times 5 s before it fails it: the phase returns ``finish``,
    which checks the child after the next phases."""
    import os
    import shutil
    import signal
    import socket
    import struct
    import tempfile
    import threading
    import urllib.request
    from pathlib import Path

    from retina_tpu_torch.config import load_config
    from retina_tpu_torch.controllers.cache import Cache
    from retina_tpu_torch.daemon import Daemon
    from retina_tpu_torch.events.schema import F, ip_to_u32, u32_to_ip
    from retina_tpu_torch.events.synthetic import pod_ip
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.operator.kubewatch import pod_to_endpoint
    from retina_tpu_torch.plugins.packetparser import PacketParserPlugin
    from retina_tpu_torch.sources.pcapdecode import decode_pcap_bytes

    t_phase = time.perf_counter()
    pods_res, svcs_res, nodes_res = "/api/v1/pods", "/api/v1/services", "/api/v1/nodes"
    ceps_res = "/apis/cilium.io/v2/ciliumendpoints"
    metrics_res = "/apis/retina.sh/v1alpha1/metricsconfigurations"
    root = Path(__file__).resolve().parent
    pcap = root / "tests" / "fixtures" / "real" / DAEMON_PCAP
    rec = decode_pcap_bytes(pcap.read_bytes()).records
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_kube_"))
    empty = tmp / "empty.pcap"  # a capture with no packets: the agents' own source is quiet
    empty.write_bytes(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))

    def wait(pred, what: str, bound: float = KUBE_WAIT_S, step: float = 0.02) -> None:
        deadline = time.monotonic() + bound
        while not pred():
            check(time.monotonic() < deadline, f"kube phase: timed out waiting for {what}")
            time.sleep(step)

    def get(port: int, path: str) -> str:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            check(r.status == 200, f"kube phase: GET {path} answered {r.status}")
            return r.read().decode()

    def add_sums(a, b):
        return tuple({k: tuple(x + y for x, y in zip(da.get(k, (0, 0)), db.get(k, (0, 0))))
                      for k in {*da, *db}} for da, db in zip(a, b))

    kube = FakeKube()
    agents: list = []  # (daemon, its stop event, its thread) of the running agents
    op_child = None  # the operator child
    handed_over = False  # the child, the apiserver and the files go to ``finish``

    def close() -> None:
        if op_child is not None and op_child.poll() is None:
            op_child.kill()
            op_child.wait(timeout=30)
        kube.close()
        shutil.rmtree(tmp, ignore_errors=True)

    def start_agent(overrides: dict):
        cfg = load_config(None, overrides=dict(
            api_server_addr="127.0.0.1:0", kubeconfig=kc, event_source="pcap",
            pcap_path=str(empty), pcap_loop=False, **overrides), env={})
        d = Daemon(cfg, apiserver_host="127.0.0.1")
        check(d.cm.engine.device.type == "cuda", f"kube phase: the agent runs on "
              f"{d.cm.engine.device}")
        pushes: list = []  # (time.monotonic(), the IPs) of each filter push, once on the card
        fm = d.cm.filtermanager
        inner = fm._apply

        def apply(ips, inner=inner):
            inner(ips)
            pushes.append((time.monotonic(), frozenset(ips)))

        fm._apply = apply
        stop = threading.Event()
        t = threading.Thread(target=d.start, args=(stop,), name="daemon", daemon=True)
        t.start()
        agents.append((d, stop, t))
        wait(lambda: d.cm._ready.is_set() or not t.is_alive(), "the agent's ready")
        check(t.is_alive(), "kube phase: the agent died while booting")
        return d, cfg, pushes

    def stop_agent(d, stop, t) -> None:
        for part in (d.kubewatch, d.ciliumwatch, d.crd_bridge):
            if part is not None:
                part._stop.set()
        kube.hangup()  # the watch streams end now, not at their timeout
        stop.set()
        t.join(120)
        check(not t.is_alive(), "kube phase: the agent did not stop")
        agents.remove((d, stop, t))

    def replay_capture(d, cfg, path=pcap, n: int = len(rec)) -> None:
        """A capture (``n`` packets) once through a second packetparser on the
        engine's sink."""
        eng = d.cm.engine
        src = PacketParserPlugin(dataclasses.replace(cfg, event_source="pcap",
                                                     pcap_path=str(path), pcap_loop=False))
        src.set_sink(eng.sink)
        src.generate()
        src.compile()
        src.init()
        ev0 = eng.counts.events
        src.start(threading.Event())  # one pass, then it returns
        wait(lambda: eng.counts.events - ev0 == n, "the capture to be stepped")

    try:
        # The cluster: the capture's addresses, one pod each, then the bench
        # traffic's pods, their services and the nodes.
        addrs = sorted({u32_to_ip(int(x))
                        for x in np.concatenate([rec[:, F.SRC_IP], rec[:, F.DST_IP]])})
        names = {ip: f"capture-{i}" for i, ip in enumerate(addrs)}
        pods = [kube_pod_doc(n, ip, "node-0", "capture") for ip, n in names.items()]
        pods += [kube_pod_doc(f"pod-{i}", u32_to_ip(pod_ip(i)), f"node-{i % KUBE_NODES}",
                              f"app-{i % KUBE_SERVICES}")
                 for i in range(1, KUBE_PODS - len(pods) + 1)]
        for doc in pods:
            kube.add(pods_res, doc, event=False)
        for j in range(KUBE_SERVICES):
            kube.add(svcs_res, {"apiVersion": "v1", "kind": "Service", "metadata": {
                "name": f"svc-{j}", "namespace": "default"}, "spec": {
                "clusterIP": f"10.96.{j >> 8}.{(j & 0xFF) + 1}", "selector": {"app": f"app-{j}"}}},
                event=False)
        for n in range(KUBE_NODES):
            kube.add(nodes_res, {"apiVersion": "v1", "kind": "Node", "metadata": {
                "name": f"node-{n}", "labels": {"topology.kubernetes.io/zone": f"z{n % 2}"}},
                "status": {"addresses": [{"type": "InternalIP",
                                          "address": f"192.168.0.{n + 1}"}]}}, event=False)
        kc = kube.kubeconfig(tmp / "kubeconfig", token="chip-smoke")

        # The operator as users start it, in its own namespace, from the
        # start of the phase: the Capture it is given names a node the
        # cluster lacks, which it defers for two minutes before it fails it.
        op_child, op_child_t, op_child_log = start_operator_child(kube, kc, root, tmp)

        # The plain replay: the port's Cache fed the same documents in order,
        # and the filter's pod references as the metrics module keeps them
        # (an IP a pod drops on an update keeps its reference, as in the
        # reference).
        plain = Cache()
        plain_refs: dict[int, set[str]] = {}

        def plain_upsert(doc: dict) -> None:
            ep = pod_to_endpoint(doc)
            plain.update_endpoint(ep)
            for ip in ep.ips:
                plain_refs.setdefault(ip_to_u32(ip), set()).add(ep.key())

        def plain_delete(key: str) -> None:
            ep = plain.get_endpoint(key)
            plain.delete_endpoint(key)
            for ip in ep.ips:
                refs = plain_refs[ip_to_u32(ip)]
                refs.discard(key)
                if not refs:
                    del plain_refs[ip_to_u32(ip)]

        def plain_list(items: list[dict]) -> None:
            for doc in items:
                plain_upsert(doc)
            listed = {FakeKube.key(doc) for doc in items}
            for key in plain.list_endpoint_keys():
                if key not in listed:
                    plain_delete(key)

        api = {ip_to_u32("127.0.0.1")}  # the apiserver watcher's own filter reference

        def held(d) -> bool:
            """The agent's cache, identity map and filter set equal the plain
            replay's."""
            c = d.cm.cache
            keys = c.list_endpoint_keys()
            return (keys == plain.list_endpoint_keys()
                    and all(c.get_endpoint(k) == plain.get_endpoint(k)
                            and c.get_index(k) == plain.get_index(k) for k in keys)
                    and d.cm.engine._ident_dict == plain.ip_index_map()
                    and set(d.cm.filtermanager._refs) | api == set(plain_refs) | api)

        plain_list(pods)
        # Boot: the LIST, its one push, the identity on the card.
        d, cfg, pushes = start_agent({})
        eng = d.cm.engine
        wait(lambda: pods_res in kube.list_at, "the agent's pod LIST")
        t_list = kube.list_at[pods_res][0]

        seen: dict[str, float] = {}  # first time the LIST's cache, identity map, filter held

        def ready() -> bool:
            now = time.monotonic()
            c = d.cm.cache
            if "cache" not in seen and c.list_endpoint_keys() == plain.list_endpoint_keys():
                seen["cache"] = now
            if "identity" not in seen and eng._ident_dict == plain.ip_index_map():
                seen["identity"] = now
            if "filter" not in seen and pushes and pushes[-1][1] - api == frozenset(
                    plain_refs) - api:
                seen["filter"] = pushes[-1][0]
            return held(d) and len(seen) == 3 and pushes[-1][1] == frozenset(
                d.cm.filtermanager._refs)

        wait(ready, "the LIST's identity and filter on the card", step=0.005)
        ready_s = time.monotonic() - t_list
        check(sorted(d.cm.cache.list_service_keys()) == sorted(
            f"default/svc-{j}" for j in range(KUBE_SERVICES))
            and len(d.cm.cache.list_nodes()) == KUBE_NODES,
            "kube phase: the services or the nodes did not land")
        parts = [p - api for _, p in pushes]
        list_pushes = sum(1 for a, b in zip([frozenset()] + parts, parts) if a != b)
        check(list_pushes == 1, f"kube phase: the LIST changed the filter's pods in "
              f"{list_pushes} pushes, not one")
        kops.reset_launch_counts()
        port = d.cm.server.port
        print(f"kube phase: LIST of {KUBE_PODS} pods to identity ready {ready_s:.3f} s "
              f"(the engine's identity map and the filter table on the card equal the plain "
              f"replay's; from the LIST: the cache {seen['cache'] - t_list:.3f} s, the "
              f"identity map {seen['identity'] - t_list:.3f} s, the filter push done "
              f"{seen['filter'] - t_list:.3f} s; {len(pushes)} filter pushes, one with the "
              f"LIST's pods); {KUBE_SERVICES} services, {KUBE_NODES} nodes", flush=True)

        # The capture under the listed names.
        replay_capture(d, cfg)
        want1 = capture_pod_sums(rec, names)
        wait(lambda: scraped_pod_sums(get(port, "/metrics")) == want1,
             f"the scrape to hold the capture's sums {want1}", 30)
        print(f"kube phase: {DAEMON_PCAP}: {len(rec)} events; the scraped pod series equal "
              f"the decoded capture's sums under the listed names: {want1}", flush=True)

        # WATCH events, each held against the plain replay.
        moved_ip, moved_from = addrs[0], names[addrs[0]]
        new_pod = kube_pod_doc(f"pod-{KUBE_PODS}", u32_to_ip(pod_ip(KUBE_PODS)), "node-1",
                               "app-0")
        mover = kube_pod_doc("pod-7", moved_ip, f"node-{7 % KUBE_NODES}",
                             f"app-{7 % KUBE_SERVICES}")
        n_push = len(pushes)
        steps = [
            ("a pod added", lambda: kube.add(pods_res, new_pod), lambda: plain_upsert(new_pod)),
            (f"{moved_from} deleted", lambda: kube.delete(pods_res, pods[0]),
             lambda: plain_delete(f"default/{moved_from}")),
            (f"pod-7's IP becomes {moved_ip}", lambda: kube.modify(pods_res, mover),
             lambda: plain_upsert(mover)),
        ]
        for what, act, replay in steps:
            t0 = time.monotonic()
            act()
            replay()
            wait(lambda: held(d), f"the agent after {what}", step=0.005)
            print(f"kube phase: {what}: held in {time.monotonic() - t0:.3f} s", flush=True)
        kube.delete(svcs_res, {"metadata": {"name": "svc-0", "namespace": "default"}})
        wait(lambda: "default/svc-0" not in d.cm.cache.list_service_keys(),
             "the service's deletion")
        # A bookmark, then the stream's end: the agent resumes from the
        # bookmark's resourceVersion with no LIST.
        n_lists = kube.lists[pods_res]
        kube.wait(lambda: kube.open.get(pods_res, 0) >= 1, KUBE_WAIT_S, "the pod watch")
        kube.bookmark(pods_res)
        rv = kube.rv
        n_watch = kube.watches[pods_res]
        kube.end(pods_res)
        kube.wait(lambda: kube.watches[pods_res] > n_watch, KUBE_WAIT_S, "the re-WATCH")
        last = [p for m, p, _ in kube.requests if "/pods?watch=true" in p][-1]
        check(f"resourceVersion={rv}" in last and kube.lists[pods_res] == n_lists,
              f"kube phase: after the bookmark the agent asked {last}")
        # A 410: a re-LIST.
        kube.wait(lambda: kube.open.get(pods_res, 0) >= 1, KUBE_WAIT_S, "the pod watch")
        kube.expire(pods_res)
        kube.wait(lambda: kube.lists[pods_res] > n_lists, KUBE_WAIT_S, "the 410's re-LIST")
        plain_list(kube.items(pods_res))
        wait(lambda: held(d), "the agent after the 410's re-LIST")
        # A dropped connection whose re-LIST omits a pod.
        kube.wait(lambda: kube.open.get(pods_res, 0) >= 1, KUBE_WAIT_S, "the pod watch")
        kube.forget(pods_res, "default/pod-9")
        kube.drop(pods_res)
        kube.wait(lambda: kube.lists[pods_res] > n_lists + 1, KUBE_WAIT_S,
                  "the dropped connection's re-LIST")
        plain_list(kube.items(pods_res))
        wait(lambda: held(d) and d.cm.cache.get_endpoint("default/pod-9") is None,
             "the agent after the dropped connection's resync")
        print(f"kube phase: WATCH script held against the plain replay (a pod added, "
              f"{moved_from} deleted, pod-7 moved to {moved_ip}, svc-0 deleted, a bookmark "
              f"resumed at rv {rv} with no LIST, a 410 and a dropped connection re-LISTed, "
              f"pod-9 resynced away); {len(pushes) - n_push} filter pushes, "
              f"{kube.lists[pods_res]} pod LISTs", flush=True)

        # The capture again: its address now belongs to pod-7.
        replay_capture(d, cfg)
        moved_names = dict(names, **{moved_ip: "pod-7"})
        want2 = add_sums(want1, capture_pod_sums(rec, moved_names))
        wait(lambda: scraped_pod_sums(get(port, "/metrics")) == want2,
             f"the scrape to hold the second replay's sums {want2}", 30)
        print(f"kube phase: the capture again: {moved_from}'s series did not grow, pod-7's "
              f"hold the capture's sums: {want2}", flush=True)

        # A MetricsConfiguration CR through the agent's KubeBridge.
        cr = {"apiVersion": "retina.sh/v1alpha1", "kind": "MetricsConfiguration",
              "metadata": {"name": "forward-drop", "namespace": "default"},
              "spec": {"contextOptions": [
                  {"metricName": "forward", "sourceLabels": ["podname", "namespace"]},
                  {"metricName": "drop", "sourceLabels": ["podname", "namespace"]}]}}
        families = ("# TYPE networkobservability_adv_tcpflags_count gauge",
                    "# TYPE networkobservability_adv_dns_request_count gauge")
        # The registry's reset drops the deleted pod's stale series.
        want3 = tuple({k: v for k, v in w.items() if k[0] != moved_from} for w in want2)
        text = [""]

        def scraped(pred) -> bool:
            text[0] = get(port, "/metrics")
            return pred(text[0]) and scraped_pod_sums(text[0]) == want3

        kube.add(metrics_res, cr)
        wait(lambda: d.metrics_module.enabled_metrics() == ["drop", "forward"],
             "the CR's reconcile")
        wait(lambda: scraped(lambda t: not any(f in t for f in families)),
             "a scrape without the families the CR left out", 30)
        kube.delete(metrics_res, cr)
        wait(lambda: len(d.metrics_module.enabled_metrics()) == 9, "the defaults' reconcile")
        wait(lambda: scraped(lambda t: all(f in t for f in families)),
             "a scrape with the defaults' families", 30)
        print(f"kube phase: MetricsConfiguration {cr['metadata']['name']} reconciled (forward "
              f"and drop only, the other families gone, the deleted pod's stale series "
              f"dropped) and its deletion returned the defaults; pod series {want3}",
              flush=True)
        launches = kops.launch_counts()
        check_sketch_launches(launches, "kube phase")
        for name in KUBE_KERNELS:
            check(launches[name] > 0, f"{name} was not launched on the kube phase")
        check(any(launches[name] for name in KUBE_INGEST), "K7 was not launched on the kube phase")
        check(not eng.errors and not eng.lost_events.get("dispatch")
              and not eng.lost_events.get("device"), f"kube phase: errors {dict(eng.errors)}, "
              f"lost {dict(eng.lost_events)}")
        print(f"kube phase: launches since ready {launches}", flush=True)

        # The operator and the capture paths beside this agent.
        import types

        operator_part(types.SimpleNamespace(
            d=d, cfg=cfg, kube=kube, kc=kc, tmp=tmp, root=root, rec=rec, wait=wait,
            replay=replay_capture, add_sums=add_sums, want=want3, names=moved_names,
            plain=plain, get=lambda path: get(port, path), smi=smi))
        stop_agent(*agents[0])

        # CiliumEndpoints of the same pods as the identity source.
        for doc in pods:
            kube.add(ceps_res, kube_cep_doc(doc), event=False)
        first = Cache()
        for doc in pods:
            first.update_endpoint(pod_to_endpoint(doc))
        t0 = time.perf_counter()
        d2, cfg2, pushes2 = start_agent({"identity_source": "cilium"})
        check(d2.ciliumwatch is not None and not d2.kubewatch.include_pods,
              "kube phase: the cilium agent watches core/v1 pods")
        wait(lambda: d2.cm.engine._ident_dict == first.ip_index_map()
             and bool(pushes2) and pushes2[-1][1] == frozenset(d2.cm.filtermanager._refs),
             "the cilium agent's identity")
        cilium_s = time.perf_counter() - t0
        replay_capture(d2, cfg2)
        wait(lambda: scraped_pod_sums(get(d2.cm.server.port, "/metrics")) == want1,
             f"the cilium agent's scrape to equal the first agent's {want1}", 30)
        stop_agent(*agents[0])
        print(f"kube phase: identity_source=cilium: {KUBE_PODS} CiliumEndpoints, boot to "
              f"identity {cilium_s:.3f} s, {len(pushes2)} filter pushes; one replay's pod "
              f"series equal the first agent's", flush=True)

        # The agent as users start it.
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            child_port = sk.getsockname()[1]
        env = {k: v for k, v in os.environ.items() if not k.startswith("RETINA_")}
        out_path = tmp / "agent.log"
        t_child = time.perf_counter()
        with open(out_path, "w") as out:
            child = subprocess.Popen(
                [sys.executable, "-m", "retina_tpu_torch", "agent", "--kubeconfig", kc,
                 "--set", f"api_server_addr=127.0.0.1:{child_port}"],
                cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            def child_pod_series() -> bool:
                check(child.poll() is None, "kube phase: the agent child exited: "
                      + out_path.read_text()[-2000:])
                try:
                    return 'podname="pod-' in get(child_port, "/metrics")
                except OSError:
                    return False

            wait(child_pod_series, "a listed pod's series on the child's /metrics",
                 DAEMON_CHILD_S, step=0.5)
            child_s = time.perf_counter() - t_child
            child.send_signal(signal.SIGTERM)
            deadline = time.monotonic() + 120
            while child.poll() is None and time.monotonic() < deadline:
                kube.hangup()
                time.sleep(0.2)
            rc = child.wait(timeout=10)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=30)
        tail = out_path.read_text()[-2000:]
        check(rc == 0 and "agent shut down" in tail, f"kube phase: the agent child exited "
              f"{rc}: {tail}")
        print(f"kube phase: python3 -m retina_tpu_torch agent --kubeconfig: a listed pod's "
              f"series on /metrics {child_s:.3f} s after its start; exit {rc} on SIGTERM",
              flush=True)
        handed_over = True
    finally:
        for a in list(agents):
            stop_agent(*a)
        if not handed_over:
            close()
    print(f"kube phase: {time.perf_counter() - t_phase:.1f} s (the operator child's Capture "
          f"runs on through the next phases)", flush=True)

    def finish(checked: bool = True) -> None:
        """The operator child's end, once its Capture's deferrals ran out
        (``checked=False``: only stop it and clean up)."""
        try:
            if checked:
                stop_operator_child(kube, op_child, op_child_t, op_child_log)
        finally:
            close()

    return finish


SRC_PACKETS = 1 << 20  # packets of the synthesized capture
SRC_QNAMES = ("kube-dns.kube-system.svc.cluster.local", "api.internal", "db-0.prod.svc",
              "metrics.monitoring.svc.cluster.local", "x.y")
SRC_T0_NS = 1_700_000_000_000_000_000  # the synthesized capture's first timestamp
SRC_BURST = 20_000  # UDP datagrams of the live burst over lo
SRC_DNS = 200  # DNS queries of the live burst
SRC_REPLAY_RATE = 250_000.0  # events/s of the agent's replay where no ring opens
SRC_WAIT_S = 60.0  # the bound on each wait of the sources phase
SRC_MONITOR = (600, 400)  # drop and trace notifications served on the monitor socket
# The main path's kernels (K7's ingest, the step, the close, the scrape) and
# what the invertible configuration adds (K6, K15, K10).
SRC_KERNELS = ("step_rows", "hh_update", "hll_update", "entropy_update", "conntrack",
               "latency_update", "window_close", "snapshot_flat")
SRC_INV_KERNELS = ("ingest_packed", "inv_update", "inv_decode", "cms_query")


def capture_specs(n: int, seed: int = SEED) -> list[dict]:
    """``synthesize_pcap``'s packet specs for ``n`` packets on ``TrafficGen``'s
    flow keys (its addresses and ports): TCP (two in five with the timestamp
    option, the flags varied), UDP, and DNS queries and responses of
    SRC_QNAMES (port 53) with several qtypes and rcodes, a microsecond apart
    and more."""
    from retina_tpu_torch.events.schema import F, PROTO_TCP, PROTO_UDP
    from retina_tpu_torch.events.synthetic import TrafficGen

    rec = TrafficGen(n_flows=N_FLOWS, n_pods=N_PODS_GEN, seed=seed).batch(n)
    rng = np.random.default_rng(seed)
    kind = rng.choice(4, n, p=[0.5, 0.3, 0.1, 0.1])  # tcp, udp, dns query, dns response
    ts = SRC_T0_NS + np.cumsum(rng.integers(1_000, 50_000, n, dtype=np.int64))
    flags = rng.choice(np.array([0x10, 0x02, 0x12, 0x18, 0x11, 0x04]), n)
    with_ts = rng.random(n) < 0.4
    tsval, tsecr = (rng.integers(1, 1 << 32, n, dtype=np.int64) for _ in range(2))
    qname = rng.integers(0, len(SRC_QNAMES), n)
    qtype = rng.choice(np.array([1, 28, 5, 33, 12]), n)
    rcode = rng.choice(np.array([0, 0, 0, 3, 2]), n)
    cols = [c.tolist() for c in (rec[:, F.SRC_IP], rec[:, F.DST_IP], rec[:, F.PORTS] >> 16,
                                 rec[:, F.PORTS] & 0xFFFF, kind, ts, flags, with_ts, tsval,
                                 tsecr, qname, qtype, rcode)]
    out = []
    for src, dst, sport, dport, k, t, fl, wts, tv, te, q, qt, rc in zip(*cols):
        p = {"src_ip": src, "dst_ip": dst, "sport": sport, "dport": dport, "ts_ns": t}
        if k == 0:
            p.update(proto=PROTO_TCP, tcp_flags=fl)
            if wts:
                p.update(tsval=tv, tsecr=te)
        elif k == 1:
            p["proto"] = PROTO_UDP
        else:
            p.update(proto=PROTO_UDP, dns_qname=SRC_QNAMES[q], dns_qtype=qt,
                     dns_response=k == 3, dns_rcode=rc if k == 3 else 0)
            if k == 3:
                p.update(sport=53, dport=sport)
            else:
                p["dport"] = 53
        out.append(p)
    return out


def pcap_to_microseconds(data: bytes) -> bytes:
    """A nanosecond pcap as ``synthesize_pcap(..., ns=False)`` writes the same
    packets: the microsecond magic, and each record's fraction divided by
    1000."""
    from retina_tpu_torch.sources.pcapdecode import PCAP_MAGIC_NS, PCAP_MAGIC_US, _find_offsets

    buf = np.frombuffer(data, np.uint8).copy()
    if int.from_bytes(data[:4], "little") != PCAP_MAGIC_NS:
        raise ValueError("not a little-endian nanosecond pcap")
    buf[:4] = np.frombuffer(PCAP_MAGIC_US.to_bytes(4, "little"), np.uint8)
    _, pkt_off, _ = _find_offsets(data, True, False)
    frac = pkt_off.astype(np.int64) - 12  # each record header's fraction field
    words = buf[frac[:, None] + np.arange(4)].view("<u4").reshape(-1)
    buf[frac[:, None] + np.arange(4)] = (words // 1000).astype("<u4").view(np.uint8).reshape(-1, 4)
    return buf.tobytes()


def sources_phase(dev, smi, equal_int, close_counts, close_float, equal_any) -> None:
    """The agent's event sources on the card.

    (a) Decode: the three in-repo captures, and a capture of SRC_PACKETS
    packets synthesized from ``TrafficGen``'s flow keys (``capture_specs``:
    TCP with and without the timestamp option, UDP, DNS queries and
    responses) in the nanosecond and the microsecond format, through the
    native decoder (``native/decoder.cpp``) and the numpy decoder: all 16
    lanes and the DNS names equal; both decoders' host ms printed.

    (b) Step: each capture's records through ``SketchEngine.flush`` (K7's
    ingest, the step's K1-K5 and K14, K6 on the invertible configuration),
    a window close (K16; K15 and K10 on the invertible one) and a snapshot
    (K17), at ``Config()`` and ``Config(heavy_keys_source="invertible")``,
    with kernels and under the plain versions: integer state and snapshots
    equal, floats within the float rule, ``totals[0]`` the packets decoded.

    (c) The agent: a ``Daemon`` at ``Config()`` with packetparser, linuxutil,
    tcpretrans, infiniband, externalevents and ciliumeventobserver (the
    overload controller off, so every row delivered is stepped).
    packetparser captures ``lo`` live through the TPACKET_V3 ring where the
    machine lets this process open one, while the phase sends a counted
    burst of UDP datagrams and DNS queries over it (the ring's rows must
    hold them); elsewhere it replays the synthesized capture at
    SRC_REPLAY_RATE. A producer writes the first capture's records to
    ``external_socket`` as frames, and a fake Cilium agent serves a gob
    stream of drop and trace notifications at ``monitor_sock_path``. Checks:
    the host-stat series on ``/metrics``; after the stop, the rows stepped
    equal the rows the three sources delivered, the replay's and the
    frames' exactly. Each run's kernels must have launched in that run: the
    counts are set to 0 before each configuration of (b) and before the
    agent starts, and (c) requires the kernels a ``Config()`` agent runs."""
    import os
    import shutil
    import socket
    import struct
    import tempfile
    import threading
    import urllib.request
    from pathlib import Path

    import torch

    from retina_tpu_torch import native
    from retina_tpu_torch.common import RetinaEndpoint
    from retina_tpu_torch.config import Config, load_config
    from retina_tpu_torch.daemon import Daemon
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.schema import EV_DNS_REQ, F, u32_to_ip
    from retina_tpu_torch.events.synthetic import pod_ip
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.plugins import framing
    from retina_tpu_torch.sources import gobcodec
    from retina_tpu_torch.sources.cilium_monitor import (
        MSG_DROP,
        MSG_TRACE,
        PAYLOAD_EVENT_SAMPLE,
    )
    from retina_tpu_torch.sources.pcapdecode import (
        _decode_pcap_numpy,
        decode_pcap_bytes,
        dns_qname_hash,
        synthesize_pcap,
    )
    from retina_tpu_torch.u32 import to_numpy

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sources_"))
    # The Unix sockets' directory: a path of at most 108 bytes binds.
    sock_dir = Path(tempfile.mkdtemp(prefix="cs_"))
    if len(str(sock_dir)) > 90:
        sock_dir = Path(tempfile.mkdtemp(prefix=".cs_", dir="."))

    def wait(pred, what: str, bound: float = SRC_WAIT_S) -> None:
        deadline = time.monotonic() + bound
        while not pred():
            check(time.monotonic() < deadline, f"sources phase: timed out waiting for {what}")
            time.sleep(0.02)

    # (a) Decode.
    captures = {p.name: p.read_bytes()
                for p in sorted((root / "tests" / "fixtures" / "real").glob("*.pcap"))}
    t0 = time.perf_counter()
    big = synthesize_pcap(capture_specs(SRC_PACKETS))
    captures["synthesized_ns"] = big
    captures["synthesized_us"] = pcap_to_microseconds(big)
    print(f"sources phase (a): {SRC_PACKETS} packets synthesized ({len(big)} bytes) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    decoded = {}
    for name, data in captures.items():
        t0 = time.perf_counter()
        nat = decode_pcap_bytes(data)
        nat_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = decode_pcap_bytes(data, prefer_native=False)
        np_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        records, total = native.decode_pcap_native(data)
        lib_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _decode_pcap_numpy(data, parse_dns=False)
        lanes_ms = (time.perf_counter() - t0) * 1e3
        check(nat.records.shape == ref.records.shape and np.array_equal(nat.records, ref.records)
              and np.array_equal(records, ref.records),
              f"sources phase: {name}: the native and numpy decodes differ")
        check(nat.dns_names == ref.dns_names and nat.n_packets_total == ref.n_packets_total
              == total, f"sources phase: {name}: DNS names or packet counts differ")
        check(len(nat.records) == total, f"sources phase: {name}: {total - len(nat.records)} "
              "packets did not decode")
        decoded[name] = nat
        print(f"sources phase (a): {name}: {total} packets, {len(nat.dns_names)} DNS names; "
              f"native and numpy equal in all 16 lanes; host ms: native {lib_ms:.1f} "
              f"(with the name pass {nat_ms:.1f}), numpy {lanes_ms:.1f} (with the name pass "
              f"{np_ms:.1f}); card {smi}", flush=True)
    us = decoded["synthesized_us"].records
    ns = decoded["synthesized_ns"].records
    check(np.array_equal(np.delete(us, [F.TS_LO, F.TS_HI], 1),
                         np.delete(ns, [F.TS_LO, F.TS_HI], 1)),
          "sources phase: the microsecond capture decodes to other lanes than the nanosecond one")

    # (b) Step, with kernels and under the plain versions.
    pods = {pod_ip(i): i for i in range(1, N_PODS_GEN)}
    t_b = time.perf_counter()
    for label, cfg, extra in (("Config()", Config(), ("ingest_new",)),
                              ("invertible", Config(heavy_keys_source="invertible"),
                               SRC_INV_KERNELS)):
        # Each configuration's kernels are counted from its own run.
        kops.reset_launch_counts()
        runs = []
        for plain in (False, True):
            eng = SketchEngine(cfg, device=dev)
            # TrafficGen's pods, and the captures' loopback address as a
            # second address of pod 1: every row has a pod at one end.
            eng.update_identities({**pods, 0x7F000001: 1})
            eng.set_apiserver_ips([0x7F000001])  # the captures' loopback: K14's probes
            snaps, wins, fed = [], [], 0
            before = kops.launch_counts()
            with kops.plain_versions() if plain else contextlib.nullcontext():
                for name, res in decoded.items():
                    rec = res.records
                    now_s = int(((rec[:, F.TS_HI].astype(np.uint64) << np.uint64(32))
                                 | rec[:, F.TS_LO]).max() // 10**9) + 1
                    eng.flush([rec], now_s)
                    wins.append(eng.close_window())
                    snaps.append(eng.snapshot(max_age_s=0, now_s=now_s))
                    fed += int(rec[:, F.PACKETS].astype(np.uint64).sum())
                    check(int(to_numpy(eng.state.totals)[0]) == fed & 0xFFFFFFFF,
                          f"sources phase (b) {label}: totals[0] after {name} is not the "
                          f"{fed} packets decoded")
            torch.cuda.synchronize()
            if plain:
                check(kops.launch_counts() == before,
                      f"sources phase (b) {label}: the plain run launched kernels")
            runs.append((eng, wins, snaps))
        (eng, wins, snaps), (ref, rwins, rsnaps) = runs
        for (leaf, a), (_, b) in zip(named_leaves(eng.state), named_leaves(ref.state)):
            if a.dtype == torch.int32:
                equal_int(a, b, f"sources phase (b) {label} state {leaf}")
            elif leaf == "entropy.counts":
                close_counts(a, b, f"sources phase (b) {label} entropy counts")
            else:
                close_float(a, b, f"sources phase (b) {label} state {leaf}")
        for i, name in enumerate(decoded):
            equal_any(wins[i], rwins[i], f"sources phase (b) {label} window after {name}")
            equal_any(snaps[i], rsnaps[i], f"sources phase (b) {label} snapshot after {name}")
        launches = kops.launch_counts()
        for k in SRC_KERNELS + extra:
            check(launches[k] > 0, f"{k} was not launched on the sources phase ({label})")
        eng.stop()
        ref.stop()
        print(f"sources phase (b) {label}: {len(decoded)} captures, {fed} packets stepped "
              f"with kernels equal the plain versions (state, windows, snapshots; totals[0]); "
              f"launches {launches}", flush=True)
    print(f"sources phase (b): {time.perf_counter() - t_b:.1f} s", flush=True)

    # (c) The agent with the new sources.
    try:
        native.AfPacketRing(iface="lo").close()
        live, why = True, "this process may open an AF_PACKET socket on lo"
    except RuntimeError as e:
        live, why = False, f"no TPACKET_V3 ring here ({e})"
    if live:
        source = dict(event_source="live", capture_iface="lo")
    else:
        replay_path = tmp / "synthesized.pcap"
        replay_path.write_bytes(big)
        source = dict(event_source="pcap", pcap_path=str(replay_path), pcap_loop=False,
                      synthetic_rate=SRC_REPLAY_RATE)
    cfg = load_config(None, overrides=dict(
        api_server_addr="127.0.0.1:0", overload_enabled=False,
        enabled_plugins=["packetparser", "linuxutil", "tcpretrans", "infiniband",
                         "externalevents", "ciliumeventobserver"],
        external_socket=str(sock_dir / "e.sock"), monitor_sock_path=str(sock_dir / "m.sock"),
        **source), env={})
    ext_rec = decoded[next(iter(decoded))].records
    # The fake Cilium agent: drop notifications of 10.77.0.0/16 sources and
    # trace notifications of 10.78.0.0/16 ones, one gob stream, one connection.
    enc = gobcodec.GobStructEncoder("Payload", [("Data", gobcodec.T_BYTES),
                                                ("CPU", gobcodec.T_INT),
                                                ("Lost", gobcodec.T_UINT),
                                                ("Type", gobcodec.T_INT)])

    def udp_frame(src: int) -> bytes:
        ip = struct.pack(">BBHHHBBHII", 0x45, 0, 36, 0, 0, 64, 17, 0, src, 0x0A010009)
        return b"\x00" * 12 + b"\x08\x00" + ip + struct.pack(">HHHH", 3333, 8080, 16, 0) \
            + b"x" * 8

    notes = []
    for i in range(SRC_MONITOR[0]):
        hdr = bytearray(36)
        hdr[0], hdr[1] = MSG_DROP, 133
        notes.append(bytes(hdr) + udp_frame(0x0A4D0000 + i))
    for i in range(SRC_MONITOR[1]):
        hdr = bytearray(32)
        hdr[0], hdr[1] = MSG_TRACE, 10
        notes.append(bytes(hdr) + udp_frame(0x0A4E0000 + i))
    wire = b"".join(enc.encode({"Data": d, "Type": PAYLOAD_EVENT_SAMPLE}) for d in notes)
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(cfg.monitor_sock_path)
    server.listen(1)

    def serve() -> None:
        conn, _ = server.accept()
        with conn:
            conn.sendall(wire)
            time.sleep(1.0)

    served = threading.Thread(target=serve, name="monitor", daemon=True)
    served.start()
    d = Daemon(cfg, apiserver_host="127.0.0.1")
    eng = d.cm.engine
    check(eng.device.type == "cuda", f"sources phase: the agent runs on {eng.device}")
    delivered: dict = {}
    tap: list = []
    write = eng.sink.write_records

    def counted(records, plugin):
        n = write(records, plugin)
        delivered[plugin] = delivered.get(plugin, 0) + n
        if plugin == "packetparser" and live:
            tap.append(records[:n].copy())
        return n

    eng.sink.write_records = counted
    # The pods: the loopback address (the live burst, the frames), the
    # monitor stream's destination, and, for the replay, TrafficGen's pods.
    local = ["127.0.0.1", "10.1.0.9"] + ([] if live else [u32_to_ip(ip) for ip in pods])
    with d.cm.filtermanager.deferred_push():
        for i, ip in enumerate(local):
            d.cm.cache.update_endpoint(RetinaEndpoint(name=f"pod-{i}", namespace="default",
                                                      ips=(ip,)))
        want_ident = d.cm.cache.ip_index_map()
        wait(lambda: d.cm.filtermanager.ip_count() >= len(want_ident), "the pod events")
    wait(lambda: eng._ident_dict == want_ident, "the identity rebuild")
    stop = threading.Event()
    agent = threading.Thread(target=d.start, args=(stop,), name="daemon", daemon=True)
    kops.reset_launch_counts()  # the agent's kernels, counted from its own run
    t_c = time.perf_counter()
    agent.start()
    try:
        wait(lambda: d.cm._ready.is_set() or not agent.is_alive(), "the agent's ready")
        check(agent.is_alive(), "sources phase: the agent died while booting")
        port = d.cm.server.port
        wait(lambda: os.path.exists(cfg.external_socket), "the external socket")
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(cfg.external_socket)
            for i in range(0, len(ext_rec), 8):
                framing.send_frame(c, ext_rec[i: i + 8])
        sent = dns_sent = 0
        if live:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx, \
                    socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                rx.bind(("127.0.0.1", 0))
                udp_port = rx.getsockname()[1]
                rx.setblocking(False)
                tx.connect(("127.0.0.1", udp_port))
                for _ in range(SRC_BURST):
                    tx.send(b"sources-phase-burst")
                    sent += 1
                    try:
                        rx.recv(64)
                    except BlockingIOError:
                        pass
            q = (b"\x12\x34\x01\x00\x00\x01\x00\x00\x00\x00\x00\x00"
                 b"\x07sources\x05phase\x00\x00\x01\x00\x01")
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                for _ in range(SRC_DNS):
                    try:
                        tx.sendto(q, ("127.0.0.1", 53))
                        dns_sent += 1
                    except OSError:
                        pass  # the ICMP port-unreachable of an earlier query
        else:
            wait(lambda: delivered.get("packetparser", 0) >= len(ns), "the replay")
        wait(lambda: delivered.get("externalevents", 0) >= len(ext_rec), "the external frames")
        wait(lambda: delivered.get("ciliumeventobserver", 0) >= sum(SRC_MONITOR),
             "the monitor stream")
        text = ""

        def host_stats() -> bool:
            nonlocal text
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
                text = r.read().decode()
            return all(f"networkobservability_{k}{{" in text for k in (
                "tcp_connection_stats", "udp_connection_stats", "ip_connection_stats"))

        wait(host_stats, "the host-stat series on /metrics")
        if live:
            seen = [0, 0]

            def burst_seen() -> bool:
                # Over lo the ring sees each datagram twice, sent and received.
                rows = np.concatenate(tap) if tap else np.zeros((0, 16), np.uint32)
                dns = rows[rows[:, F.EVENT_TYPE] == EV_DNS_REQ]
                seen[:] = [int(((rows[:, F.PORTS] & 0xFFFF) == udp_port).sum()), int(
                    (dns[:, F.DNS_QHASH] == np.uint32(dns_qname_hash(b"sources.phase"))).sum())]
                return seen[0] >= 2 * sent and seen[1] >= 2 * dns_sent

            deadline = time.monotonic() + SRC_WAIT_S
            while not burst_seen():
                check(time.monotonic() < deadline, f"sources phase: the ring's rows hold "
                      f"{seen[0]} of the {2 * sent} frames of the burst and {seen[1]} of the "
                      f"{2 * dns_sent} of the DNS queries; delivered {delivered}")
                time.sleep(0.05)
        # Quiescence: every row the sources delivered has been stepped.
        caught_up = [0, 0]

        def stepped_all() -> bool:
            caught_up[:] = [sum(delivered.values()), eng.counts.events]
            return caught_up[0] == caught_up[1]

        wait(stepped_all, "the rows delivered to be stepped")
    finally:
        stop.set()
        agent.join(120)
        server.close()
        served.join(10)
        shutil.rmtree(sock_dir, ignore_errors=True)
    check(not agent.is_alive(), "sources phase: the agent did not stop")
    wall_c = time.perf_counter() - t_c
    lost = dict(eng.lost_events)
    check(not eng.errors and not lost, f"sources phase (c): errors {dict(eng.errors)}, "
          f"lost {lost}")
    total = caught_up[0]
    check(delivered["externalevents"] == len(ext_rec)
          and delivered["ciliumeventobserver"] == sum(SRC_MONITOR),
          f"sources phase (c): delivered {delivered}")
    if not live:
        check(delivered["packetparser"] == len(ns), f"sources phase (c): the replay delivered "
              f"{delivered['packetparser']} of {len(ns)}")
    # Every row has a pod at one end, so totals[0] counts each stepped row
    # (the live ring's rows after the quiescent point too).
    check(int(to_numpy(eng.state.totals)[0]) == eng.counts.events & 0xFFFFFFFF,
          f"sources phase (c): totals[0] is not the {eng.counts.events} rows stepped")
    # The Config() agent's path: K7's ingest and the main path's kernels.
    launches = kops.launch_counts()
    for k in SRC_KERNELS + ("ingest_new",):
        check(launches[k] > 0, f"{k} was not launched by the agent on the sources phase (c)")
    host_lines = sum(1 for ln in text.splitlines() if ln.startswith((
        "networkobservability_tcp_connection_stats{", "networkobservability_udp_connection_stats{",
        "networkobservability_ip_connection_stats{", "networkobservability_interface_stats{",
        "networkobservability_infiniband_")))
    print(f"sources phase (c): packetparser {'live on lo through the TPACKET_V3 ring' if live else 'replayed the synthesized capture through the native decoder'} "
          f"({why}); {total} rows delivered ({delivered} at the stop) and as many stepped, "
          f"none lost, in {wall_c:.1f} s; {host_lines} host-stat series on /metrics"
          + (f"; the ring held the {sent}-datagram burst and {dns_sent} DNS queries" if live
             else ""), flush=True)
    print(f"sources phase (c): launches {launches}", flush=True)
    print(f"sources phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


HUB_WAIT_S = 60.0  # the bound on each wait of the hubble phase
HUB_SYNTH_S = 5.0  # seconds of the default synthetic source before the reads
HUB_LAST = 1000  # GetFlows(last=N) on each surface
HUB_FOLLOW_S = 2.0  # seconds of the protobuf follow stream read
HUB_PODS = 255  # pods in the identity cache: pod_ip(1..255) of the synthetic traffic
HUB_NODE = "chip-node"  # the agent's node_name: the relay's flows must carry it


def hubble_phase(dev, smi: str) -> None:
    """The Hubble control plane as the agent serves it, on the card: a
    ``Daemon`` at ``Config()`` with ``enable_hubble`` (its default plugins,
    the synthetic source at 1e6 events/s), ``hubble_addr`` and
    ``hubble_metrics_addr`` on 127.0.0.1:0 and ``hubble_sock_path`` in a temp
    dir, HUB_PODS pods in the identity cache, a static peer and a node in the
    node store. The plugins mirror every block to the external channel ->
    MonitorAgent -> FlowObserver (lazy decode) -> HubbleServer.

    A second consumer on the monitor agent copies each block it receives
    and, once the phase holds it, keeps the drain thread (so the observer)
    still. After HUB_SYNTH_S: GetFlows(last=HUB_LAST) over msgpack (TCP),
    over protobuf and over msgpack on the unix socket must each equal the
    port's ``record_to_flow`` of the last HUB_LAST copied rows (the protobuf
    one as ``flow_dict_to_proto`` of those, byte for byte); ``python3 -m
    retina_tpu_torch observe --last 100 --json`` (a child) prints the last
    100 of them; ``status`` (a child) exits 0; ServerStatus on both
    surfaces, peer Notify (the static peer and the node) and the hubble
    mux's ``hubble_*`` series are checked. Released, a ``relay`` child
    follows the agent: flows read through it carry HUB_NODE. A protobuf
    follow stream is read for HUB_FOLLOW_S. The launch counts, set to 0 just
    before the agent starts, must show SRC_KERNELS and K7's ingest. Then
    ``python3 -m retina_tpu_torch agent --set enable_hubble=true`` as a
    child at the defaults must serve GetFlows over msgpack and protobuf and
    exit 0 on SIGTERM. Prints
    flows observed a second, the external channel's losses, GetFlows ms on
    each surface and the follow stream's flows a second."""
    import os
    import signal
    import socket
    import tempfile
    import threading
    import urllib.request
    from pathlib import Path

    import grpc

    from retina_tpu_torch.common import RetinaEndpoint, RetinaNode
    from retina_tpu_torch.config import load_config
    from retina_tpu_torch.daemon import Daemon
    from retina_tpu_torch.events.schema import u32_to_ip
    from retina_tpu_torch.events.synthetic import pod_ip
    from retina_tpu_torch.hubble import proto as pb
    from retina_tpu_torch.hubble.flow import record_to_flow
    from retina_tpu_torch.hubble.server import HubbleClient
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.metrics import get_metrics

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    sock_dir = Path(tempfile.mkdtemp(prefix="cs_"))
    if len(str(sock_dir)) > 90:
        sock_dir = Path(tempfile.mkdtemp(prefix=".cs_", dir="."))
    env = {k: v for k, v in os.environ.items() if not k.startswith("RETINA_")}

    def wait(pred, what: str, bound: float = HUB_WAIT_S) -> None:
        deadline = time.monotonic() + bound
        while not pred():
            check(time.monotonic() < deadline, f"hubble phase: timed out waiting for {what}")
            time.sleep(0.02)

    def free_port() -> int:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    static_peer = {"name": "peer-static", "address": "10.9.9.9:4244"}
    cfg = load_config(None, overrides=dict(
        api_server_addr="127.0.0.1:0", enable_hubble=True, hubble_addr="127.0.0.1:0",
        hubble_metrics_addr="127.0.0.1:0", hubble_sock_path=str(sock_dir / "h.sock"),
        hubble_peers=[static_peer], node_name=HUB_NODE), env={})
    d = Daemon(cfg, apiserver_host="127.0.0.1")
    eng = d.cm.engine
    check(eng.device.type == "cuda", f"hubble phase: the agent runs on {eng.device}")
    with d.cm.filtermanager.deferred_push():
        for i in range(1, HUB_PODS + 1):
            d.cm.cache.update_endpoint(RetinaEndpoint(
                name=f"pod-{i}", namespace=f"ns-{i % 4}", ips=(u32_to_ip(pod_ip(i)),),
                labels=(("app", f"app-{i % 8}"),), owner_refs=(("Deployment", f"app-{i % 8}"),)))
        want_ident = d.cm.cache.ip_index_map()
        wait(lambda: d.cm.filtermanager.ip_count() >= len(want_ident), "the pod events")
    wait(lambda: eng._ident_dict == want_ident, "the identity rebuild")
    d.cm.cache.update_node(RetinaNode(name="node-x", ip="10.99.0.7"))

    # The second consumer: copies each block; while ``hold`` is set it keeps
    # the monitor agent's drain thread (the observer's only writer) still.
    copied: list = []
    hold, held, release = threading.Event(), threading.Event(), threading.Event()

    def copy_blocks(records) -> None:
        copied.append(np.array(records, copy=True))
        del copied[:-64]
        if hold.is_set():
            held.set()
            release.wait(HUB_WAIT_S)

    d.monitoragent.register_consumer(copy_blocks)
    stop = threading.Event()
    agent = threading.Thread(target=d.start, args=(stop,), name="daemon", daemon=True)
    lost_ext = get_metrics().lost_events

    def external_lost() -> int:
        return int(sum(v for suffix, labels, v in lost_ext.samples()
                       if suffix == "_total" and labels.get("stage") == "external"))

    lost0 = external_lost()
    relay = None
    cli = [sys.executable, "-m", "retina_tpu_torch"]
    kops.reset_launch_counts()  # the agent's kernels, counted from its own run
    agent.start()
    try:
        wait(lambda: d.cm._ready.is_set() or not agent.is_alive(), "the agent's ready")
        check(agent.is_alive(), "hubble phase: the agent died while booting")
        port = d.hubble.port
        addr = f"127.0.0.1:{port}"
        wait(lambda: d.observer.flows_seen > 0, "the first flow at the observer")
        seen0, t0 = d.observer.flows_seen, time.perf_counter()
        time.sleep(HUB_SYNTH_S)
        flows_s = (d.observer.flows_seen - seen0) / (time.perf_counter() - t0)
        lost_run = external_lost() - lost0
        hold.set()
        check(held.wait(HUB_WAIT_S), "hubble phase: the monitor agent delivered no block")
        rows = np.concatenate(copied)[-HUB_LAST:]
        check(len(rows) == HUB_LAST, f"hubble phase: {len(rows)} rows copied")
        dns = d.cm.pluginmanager.plugins.get("dns")
        want = [record_to_flow(r, d.cm.cache, dns.resolve if dns else None) for r in rows]
        check(sum(1 for f in want if f["source"] or f["destination"]) > 0,
              "hubble phase: no flow was enriched from the identity cache")
        surface_ms = {}

        def timed(label, fn):
            t1 = time.perf_counter()
            out = fn()
            surface_ms[label] = (time.perf_counter() - t1) * 1e3
            return out

        client = HubbleClient(addr)
        got = timed("msgpack", lambda: list(client.get_flows(last=HUB_LAST, timeout=60)))
        check(got == want, f"hubble phase: GetFlows over msgpack differs from record_to_flow "
              f"({len(got)} flows)")
        ux = HubbleClient(f"unix:{cfg.hubble_sock_path}")
        got = timed("unix", lambda: list(ux.get_flows(last=HUB_LAST, timeout=60)))
        check(got == want, "hubble phase: GetFlows over the unix socket differs")
        ux.close()
        chan = grpc.insecure_channel(addr)
        get_flows = chan.unary_stream(
            "/observer.Observer/GetFlows",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.GetFlowsResponse.FromString)
        resps = timed("protobuf", lambda: list(get_flows(pb.GetFlowsRequest(number=HUB_LAST),
                                                         timeout=60)))
        check([r.flow.SerializeToString() for r in resps]
              == [pb.flow_dict_to_proto(f, HUB_NODE).SerializeToString() for f in want]
              and all(r.node_name == HUB_NODE for r in resps),
              f"hubble phase: GetFlows over protobuf differs ({len(resps)} responses)")
        st = client.server_status()
        status_pb = chan.unary_unary(
            "/observer.Observer/ServerStatus",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.ServerStatusResponse.FromString)(
                pb.ServerStatusRequest(), timeout=10)
        seen = d.observer.flows_seen
        cap = cfg.hubble_ring_capacity
        check(st["seen_flows"] == seen and st["num_flows"] == min(seen, cap)
              and st["max_flows"] == cap and status_pb.seen_flows == seen
              and status_pb.max_flows == cap, f"hubble phase: ServerStatus {st}, {status_pb}")
        notify = chan.unary_stream(
            "/peer.Peer/Notify", request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.ChangeNotification.FromString)(pb.NotifyRequest(),
                                                                    timeout=30)
        it = iter(notify)
        notes = {(n.name, n.address, n.type) for n in (next(it), next(it))}
        notify.cancel()
        check(notes == {("peer-static", "10.9.9.9:4244", 1), ("node-x", f"10.99.0.7:{port}", 1)},
              f"hubble phase: peer Notify sent {notes}")
        check(client.list_peers() == [static_peer, {"name": "node-x",
                                                    "address": f"10.99.0.7:{port}"}],
              f"hubble phase: ListPeers {client.list_peers()}")
        client.close()
        t1 = time.perf_counter()
        obs = subprocess.run(cli + ["observe", "--server", addr, "--last", "100", "--json"],
                             cwd=root, env=env, capture_output=True, text=True, timeout=120)
        observe_s = time.perf_counter() - t1
        check(obs.returncode == 0, f"hubble phase: observe exited {obs.returncode}: "
              f"{obs.stderr[-2000:]}")
        check([json.loads(ln) for ln in obs.stdout.splitlines()] == want[-100:],
              "hubble phase: observe --last 100 did not print the last 100 flows")
        sts = subprocess.run(cli + ["status", "--server", addr], cwd=root, env=env,
                             capture_output=True, text=True, timeout=120)
        check(sts.returncode == 0 and f"Flows seen total: {seen}" in sts.stdout
              and "peer: node-x" in sts.stdout,
              f"hubble phase: status exited {sts.returncode}: {sts.stdout} {sts.stderr[-2000:]}")
        hold.clear()
        release.set()
        mux = ""
        want_series = ("hubble_seen_flows ", 'hubble_get_flows_requests_total{surface="msgpack"}',
                       'hubble_get_flows_requests_total{surface="protobuf"}',
                       'hubble_lost_events_total{source="HUBBLE_RING_BUFFER"}',
                       "hubble_flows_processed_total{")

        def mux_series() -> bool:
            # The mux's render cache serves its previous body until a
            # re-render after its TTL lands: scrape until the series show.
            nonlocal mux
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{d.hubble_metrics_server.port}/metrics", timeout=60) as r:
                mux = r.read().decode()
            return all(series in mux for series in want_series)

        wait(mux_series, "the hubble_* series on the hubble mux")
        check("networkobservability_" not in mux, "hubble phase: the hubble mux serves the "
              "agent's families")

        # The follow stream from the live edge (number=1: the newest
        # buffered flow, then what arrives), read for HUB_FOLLOW_S after its
        # first response. The server converts every buffered flow before
        # the first one goes out (the reference's filter-then-last-N).
        stream = get_flows(pb.GetFlowsRequest(follow=True, number=1),
                           timeout=HUB_FOLLOW_S + HUB_WAIT_S)
        it = iter(stream)
        t1 = time.perf_counter()
        next(it)
        first_ms = (time.perf_counter() - t1) * 1e3
        n_follow = n_lost_markers = lost_in_stream = 0
        t1 = time.perf_counter()
        for resp in it:
            if resp.WhichOneof("response_types") == "lost_events":
                n_lost_markers += 1
                lost_in_stream += resp.lost_events.num_events_lost
            else:
                n_follow += 1
            if time.perf_counter() - t1 >= HUB_FOLLOW_S:
                break
        follow_s = time.perf_counter() - t1
        stream.cancel()
        chan.close()

        # The relay child, following the agent.
        relay_port = free_port()
        with open(sock_dir / "relay.log", "w") as out:
            relay = subprocess.Popen(cli + ["relay", "--peer", addr, "--addr",
                                            f"127.0.0.1:{relay_port}", "--name", "chip-relay"],
                                     cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
        rchan = grpc.insecure_channel(f"127.0.0.1:{relay_port}")
        rget = rchan.unary_stream(
            "/observer.Observer/GetFlows", request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.GetFlowsResponse.FromString)
        relayed: list = []

        def through_relay() -> bool:
            check(relay.poll() is None, "hubble phase: the relay child exited")
            try:
                relayed[:] = list(rget(pb.GetFlowsRequest(number=100), timeout=10))
            except grpc.RpcError:
                return False
            return len(relayed) == 100

        t1 = time.perf_counter()
        wait(through_relay, "100 flows through the relay child", DAEMON_CHILD_S)
        relay_s = time.perf_counter() - t1
        rchan.close()
        check(all(r.flow.node_name == HUB_NODE and r.node_name == "chip-relay"
                  for r in relayed), "hubble phase: the relay's flows do not carry the "
              f"agent's node_name: {sorted({r.flow.node_name for r in relayed})}")
        relay.send_signal(signal.SIGTERM)
        rc = relay.wait(timeout=60)
        check(rc == 0, f"hubble phase: the relay child exited {rc}: "
              + (sock_dir / "relay.log").read_text()[-2000:])
    finally:
        release.set()
        stop.set()
        agent.join(120)
        if relay is not None and relay.poll() is None:
            relay.kill()
            relay.wait(timeout=30)
    check(not agent.is_alive(), "hubble phase: the agent did not stop")
    lost_total = external_lost() - lost0
    launches = kops.launch_counts()
    for k in SRC_KERNELS + ("ingest_new",):
        check(launches[k] > 0, f"{k} was not launched by the agent on the hubble phase")

    # The agent as users start it: python3 -m retina_tpu_torch agent with
    # enable_hubble at the defaults, read over msgpack and protobuf, SIGTERM.
    child_node = f"{HUB_NODE}-child"
    hub_port, api_port = free_port(), free_port()
    agent_log = sock_dir / "agent.log"
    with open(agent_log, "w") as out:
        child = subprocess.Popen(
            cli + ["agent", "--set", "enable_hubble=true", "--set",
                   f"hubble_addr=127.0.0.1:{hub_port}", "--set",
                   f"api_server_addr=127.0.0.1:{api_port}", "--set", f"node_name={child_node}"],
            cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        child_flows: list = []

        def child_serves() -> bool:
            check(child.poll() is None, "hubble phase: the agent child exited: "
                  + agent_log.read_text()[-2000:])
            c = HubbleClient(f"127.0.0.1:{hub_port}")
            try:
                child_flows[:] = list(c.get_flows(last=100, timeout=30))
            except grpc.RpcError:
                return False
            finally:
                c.close()
            return len(child_flows) == 100

        t1 = time.perf_counter()
        wait(child_serves, "GetFlows from the agent child", DAEMON_CHILD_S)
        child_s = time.perf_counter() - t1
        with grpc.insecure_channel(f"127.0.0.1:{hub_port}") as cchan:
            cresps = list(cchan.unary_stream(
                "/observer.Observer/GetFlows",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb.GetFlowsResponse.FromString)(
                    pb.GetFlowsRequest(number=100), timeout=60))
        check(len(cresps) == 100 and all(r.flow.node_name == child_node for r in cresps)
              and all("ip" in f and "l4" in f for f in child_flows),
              f"hubble phase: the agent child's GetFlows: {len(cresps)} protobuf responses")
        child.send_signal(signal.SIGTERM)
        child_rc = child.wait(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    check(child_rc == 0, f"hubble phase: the agent child exited {child_rc}: "
          + agent_log.read_text()[-2000:])
    print(f"hubble phase: {flows_s:.0f} flows observed a second over {HUB_SYNTH_S:.0f} s of "
          f"the synthetic source; the external channel lost {lost_run} rows in that run "
          f"({lost_total} in all, the hold included); GetFlows(last={HUB_LAST}) "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in surface_ms.items())
          + f" (msgpack first: it pays the lazy decode), each equal to record_to_flow of the "
          f"last {HUB_LAST} rows copied; the follow stream's first response after "
          f"{first_ms:.1f} ms, then {n_follow / follow_s:.0f} flows a second "
          f"({n_lost_markers} LostEvent markers, {lost_in_stream} flows lost to it); observe "
          f"child {observe_s:.1f} s; "
          f"100 flows through the relay child {relay_s:.1f} s after its start, "
          f"node_name {HUB_NODE}; python3 -m retina_tpu_torch agent --set enable_hubble=true "
          f"served GetFlows on both surfaces {child_s:.1f} s after its start and exited 0 on "
          f"SIGTERM; card {smi}", flush=True)
    print(f"hubble phase launches: {launches}", flush=True)
    print(f"hubble phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


CHURN_NODES, CHURN_ZONES = 64, 4  # the reference's defaults (bench.py --churn-dryrun)
# The kernels the churn's aggregators must launch: K8's fold and K9's join
# for each merge, and the rollup's K10 query, K16's entropy bits and K17's
# HLL estimate (the FT_KERNELS of a non-invertible rollup).
CHURN_KERNELS = ("fold", "topk_join", "cms_query", "entropy_bits", "hll_estimate")


def churn_phase(dev, smi: str) -> None:
    """The multi-process fleet churn harness (``fleet/churn.py``
    ``run_churn_dryrun``) at CHURN_NODES node processes (torch-free, real
    RFLT frames over gRPC) and CHURN_ZONES zones: each zone relay a
    ``HubbleServer`` in front of a zone ``FleetAggregator`` on the card that
    re-ships each merged epoch to the root relay and root aggregator (on the
    card), through a rolling restart, a node->relay and a relay->root
    partition and a live seed rotation. The interval is bench.py's rule,
    max(1, 0.08 * nodes / cpus) s. The scorecard's ``ok`` is required; its
    recall, replay, rotation and lineage fields are printed. The launch
    counts, set to 0 just before the run, must show CHURN_KERNELS."""
    import os

    from retina_tpu_torch.fleet.churn import run_churn_dryrun
    from retina_tpu_torch.kernels import ops as kops

    interval = max(1.0, 0.08 * CHURN_NODES / (os.cpu_count() or 1))
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_churn_dryrun(nodes=CHURN_NODES, zones=CHURN_ZONES, interval_s=interval,
                           device=dev, log=lambda s: print(s, flush=True))
    wall = time.perf_counter() - t0
    launches = kops.launch_counts()
    keys = ("recall_min", "epochs_scored", "child_spool_replayed", "reship_spool_replayed",
            "no_silent_frame_loss", "rotation_readmitted_all", "rotation_readmit_epochs",
            "trace_lineage_ok", "root_epochs_merged", "zone_epochs_merged",
            "frames_dropped_by_reason", "uplink_frames_sent", "root_frames_accepted",
            "root_frames_rejected_counted", "scrape_p99_s", "scrape_samples", "zone_merge_s",
            "root_merge_s", "child_peak_rss_kb", "child_rss_at_stop_kb", "events")
    print("churn phase: " + json.dumps({k: res[k] for k in keys}), flush=True)
    check(res["ok"], f"churn phase: the scorecard is not ok: {json.dumps(res)[:6000]}")
    for k in CHURN_KERNELS:
        check(launches[k] > 0, f"{k} was not launched on the churn phase")
    print(f"churn phase: {CHURN_NODES} node processes, {CHURN_ZONES} zones, interval "
          f"{interval:.2f} s: ok in {wall:.1f} s; merges on the card: zones "
          f"{res['zone_merge_s']['n']} in {res['zone_merge_s']['sum']:.3f} s (max "
          f"{res['zone_merge_s']['max'] * 1e3:.1f} ms), root {res['root_merge_s']['n']} in "
          f"{res['root_merge_s']['sum']:.3f} s (max {res['root_merge_s']['max'] * 1e3:.1f} ms); "
          f"scrape p99 {res['scrape_p99_s']} s; the children's largest peak RSS (VmHWM) "
          f"{res['child_peak_rss_kb']} kB and RSS at STOP {res['child_rss_at_stop_kb']} kB "
          f"(None where /proc does not give it); card {smi}", flush=True)
    print(f"churn phase launches: {launches}", flush=True)


FT_NODES, FT_EPOCHS, FT_EPOCH0 = 8, 4, 9000  # the fleet transport phase's nodes and epochs
FT_WAIT_S = 120.0  # the bound on each wait of the fleet transport phase
# The kernels the fleet transport phase must launch: the merges and queries
# (K8-K10, K15, K16's bits, K17's estimate) and the dryruns' sketch builds
# (K2-K4, K6).
FT_KERNELS = ("fold", "topk_join", "cms_query", "inv_decode", "entropy_bits", "hll_estimate",
              "hh_update", "hll_update", "entropy_update", "inv_update")


def fleet_transport_phase(dev, pods, smi: str) -> None:
    """The fleet tier as the agent runs it, on the card. FT_NODES
    ``SketchEngine``s at ``Config()`` (with the time-travel ring) share the
    card, each with ``fleet_enabled``, its own ``fleet_node_name`` and one of
    two tenants of different priority; each takes a ``TrafficGen`` batch of
    NODE_EVENTS an epoch and closes at FT_EPOCHS shared epochs, and its
    ``SnapshotShipper`` ships over the in-process bus to one subscribed
    ``FleetAggregator`` (FT_NODES expected, with its epoch ring), which
    merges each epoch on the card (on its quorum: the straggler timeout is
    FT_WAIT_S, since one process feeds the nodes in turn). The frames the
    shippers sent are
    captured off the bus and merged again under ``kops.plain_versions()``:
    the rollups must be equal, and ``fleet_windows_merged`` must count every
    epoch. One more epoch ships over ``FleetShipClient`` to the port's
    ``HubbleServer(fleet_ingest=agg.ingest)`` on 127.0.0.1 (its
    ``retina.Fleet/Ship``; each engine gets a shipper with the server's
    address). ``FleetQueryService`` answers ``last=4`` over the
    aggregator's ring and the same span over FT_NODES ``LocalNodeClient``s on
    the engines' rings (every node given FT_WAIT_S to answer in full), each
    equal to its plain-version run. Then
    ``run_dryrun``, ``run_invertible_dryrun`` and ``run_fleetquery_dryrun``
    at their reference defaults (``ok`` required), and a child ``python3 -m
    retina_tpu_torch agent`` in the three fleet roles, scraped for its
    fleet_* series and ``/fleet/query`` once and stopped by SIGTERM (exit 0
    required). The launch counts, set to 0 at the phase's start, must show
    FT_KERNELS."""
    import os
    import signal
    import socket
    import tempfile
    import urllib.error
    import urllib.request
    from pathlib import Path

    import torch

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.synthetic import TrafficGen
    from retina_tpu_torch.fleet.aggregator import FleetAggregator
    from retina_tpu_torch.fleet.codec import FLEET_TOPIC, decode_snapshot
    from retina_tpu_torch.fleet.dryrun import run_dryrun, run_invertible_dryrun
    from retina_tpu_torch.fleet.shipper import SnapshotShipper
    from retina_tpu_torch.fleetquery import FleetQueryService, LocalNodeClient
    from retina_tpu_torch.fleetquery.dryrun import run_fleetquery_dryrun
    from retina_tpu_torch.hubble import FlowObserver, HubbleServer
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.lanes_probe import overload_block, top_signal
    from retina_tpu_torch.metrics import get_metrics
    from retina_tpu_torch.pubsub import get_pubsub
    from retina_tpu_torch.timetravel.fold import RangeFold

    t_phase = time.perf_counter()
    name_power = smi

    def wait(pred, what: str, bound: float = FT_WAIT_S) -> None:
        deadline = time.monotonic() + bound
        while not pred():
            check(time.monotonic() < deadline, f"fleet transport: timed out waiting for {what}")
            time.sleep(0.01)

    def rollup_doc(r: dict) -> dict:
        return {k: v for k, v in r.items() if k != "merge_seconds"}

    m = get_metrics()
    merged0, dropped0 = m.fleet_windows_merged._value, m.fleet_ship_dropped._value
    kops.reset_launch_counts()
    # The nodes are fed one after another by one process: an epoch closes on
    # its quorum, never on the straggler timeout.
    acfg = Config(fleet_expected_nodes=FT_NODES, timetravel_enabled=True,
                  fleet_straggler_timeout_s=FT_WAIT_S)
    agg = FleetAggregator(acfg, device=dev)
    bus = get_pubsub()
    frames: list[bytes] = []
    tap = bus.subscribe(FLEET_TOPIC, frames.append)  # what the shippers sent
    agg.start(subscribe=True)
    engines = []
    for i in range(FT_NODES):
        first_half = i < FT_NODES // 2
        cfg = Config(fleet_enabled=True, timetravel_enabled=True, fleet_node_name=f"node-{i}",
                     fleet_tenant="tenant-a" if first_half else "tenant-b",
                     fleet_priority=int(first_half))
        eng = SketchEngine(cfg, device=dev)
        eng.update_identities(pods)
        engines.append(eng)
    gens = [TrafficGen(n_flows=N_FLOWS, n_pods=N_PODS_GEN, seed=200 + i) for i in range(FT_NODES)]
    relay = None
    try:
        t0 = time.perf_counter()
        for e in range(FT_EPOCHS):
            for eng, gen in zip(engines, gens):
                eng.flush(np.split(gen.batch(NODE_EVENTS), NODE_EVENTS // BLOCK), 600 + e)
                eng.close_window(epoch=FT_EPOCH0 + e)
            wait(lambda: agg.epochs_merged == e + 1, f"the merge of epoch {e}")
        feed_s = time.perf_counter() - t0
        epochs = FT_EPOCHS
        # One more epoch over the relay: the port's HubbleServer fronts the
        # aggregator, and each node's close offers to a shipper dialing it.
        relay = HubbleServer(FlowObserver(), "127.0.0.1:0", fleet_ingest=agg.ingest)
        relay.start()
        for eng in engines:
            eng._fleet_shipper.stop()
            eng._fleet_shipper = SnapshotShipper(
                dataclasses.replace(eng.cfg, fleet_relay_addr=f"127.0.0.1:{relay.port}"),
                overload=eng._overload)
        for eng, gen in zip(engines, gens):
            eng.flush(np.split(gen.batch(NODE_EVENTS), NODE_EVENTS // BLOCK), 600 + epochs)
            eng.close_window(epoch=FT_EPOCH0 + epochs)
        epochs += 1
        wait(lambda: agg.epochs_merged == epochs, "the merge of the relay's epoch")
        wait(lambda: all(eng._fleet_shipper.stats()["shipped"] == 1 for eng in engines),
             "the relay's answers to the shippers")
        print("fleet transport: epoch over the relay (FleetShipClient -> HubbleServer's "
              "retina.Fleet/Ship on 127.0.0.1) merged", flush=True)
        for eng in engines:
            check(eng.timetravel_ring.drain(30.0), "fleet transport: an engine's ring lags")
        check(agg.merge_errors == 0 and agg.invertible_decode_failed == 0,
              f"fleet transport: merge failed: {agg.last_error}")
        merged_n = m.fleet_windows_merged._value - merged0
        check(merged_n == epochs, f"fleet_windows_merged counted {merged_n} of {epochs} epochs")
        check(agg.received == {f"node-{i}": epochs for i in range(FT_NODES)},
              f"fleet transport: frames received {agg.received}")
        ship_drops = m.fleet_ship_dropped._value - dropped0
        check(ship_drops == 0, f"fleet transport: {ship_drops} frames dropped at the ship queue")
        rollups = [rollup_doc(r) for r in agg.rollups[-epochs:]]
        merge_ms = float(np.median([r["merge_seconds"] for r in agg.rollups[-epochs:]])) * 1e3
        for i, r in enumerate(rollups):  # the engines' sketches are cumulative
            check(len(r["nodes"]) == FT_NODES and set(r["tenants"]) == {"tenant-a", "tenant-b"}
                  and int(r["totals"][0]) == (i + 1) * FT_NODES * NODE_EVENTS,
                  f"fleet transport: epoch {r['epoch']} rollup: nodes {r['nodes']}, tenants "
                  f"{list(r['tenants'])}, totals[0] {int(r['totals'][0])}")

        # The same frames, merged by the same code under the plain versions.
        wait(lambda: len(frames) >= FT_EPOCHS * FT_NODES, "the tapped frames")
        sent = frames[:FT_EPOCHS * FT_NODES]
        check(sorted(decode_snapshot(f).epoch for f in sent) == sorted(
            FT_EPOCH0 + e for e in range(FT_EPOCHS) for _ in range(FT_NODES)),
            "fleet transport: the tapped frames' epochs")
        launches = kops.launch_counts()
        with kops.plain_versions():
            plain = FleetAggregator(acfg, device=dev)
            for f in sent:
                check(plain.ingest(f), "fleet transport: the plain merge refused a frame")
        check(kops.launch_counts() == launches, "the plain fleet merge launched kernels")
        for got, want in zip(rollups[:FT_EPOCHS], plain.rollups):
            same_doc(got, rollup_doc(want), f"fleet transport rollup {got['epoch']}")

        # /fleet/query over the aggregator's ring and over the engines' rings.
        # Every node answers in full (the plain versions' span folds take
        # longer than the deployed 0.25 s deadline), so the two runs compare.
        qcfg = dataclasses.replace(acfg, fleetquery_node_deadline_s=FT_WAIT_S,
                                   fleetquery_hedge_delay_s=FT_WAIT_S)

        def ring_service():
            svc = FleetQueryService(qcfg, device=dev)
            svc.add_ring(agg.epoch_ring)
            return svc

        def node_service():
            svc = FleetQueryService(qcfg, device=dev)
            fold = RangeFold(dev)
            for eng in engines:
                svc.add_client(LocalNodeClient(eng.cfg.fleet_node_name, eng.timetravel_ring,
                                               fold))
            return svc

        e1 = FT_EPOCH0 + epochs
        queries = (("ring", ring_service, {"last": ["4"]}),
                   ("nodes", node_service, {"t0": [str(e1 - 4)], "t1": [str(e1)]}))
        query_ms = {}
        for label, make, q in queries:
            svc = make()
            t0 = time.perf_counter()
            code, body, _ = svc.handle(q)
            cold = (time.perf_counter() - t0) * 1e3
            # The first answer teaches the service the fleet's newest epoch,
            # which re-keys a range over the live edge: the second query
            # folds again, the third is a cache hit.
            code2, body2, _ = svc.handle(q)
            t0 = time.perf_counter()
            code3, body3, _ = svc.handle(q)
            cached = (time.perf_counter() - t0) * 1e3
            doc = json.loads(body)
            check(code == code2 == code3 == 200 and body2 == body3 == body
                  and doc["windows"] == 4
                  and doc["topk"]["keys"] and not doc["coverage"]["partial"],
                  f"fleet transport: /fleet/query over the {label} answered {code}: {body[:300]}")
            svc.close()
            before = kops.launch_counts()
            with kops.plain_versions():
                psvc = make()
                pcode, pbody, _ = psvc.handle(q)
                psvc.close()
            check(kops.launch_counts() == before, "the plain /fleet/query run launched kernels")
            check(pcode == 200, f"fleet transport: the plain /fleet/query over the {label} "
                  f"answered {pcode}: {pbody[:300]}")
            same_doc(doc, json.loads(pbody), f"/fleet/query over the {label}")
            query_ms[label] = (cold, cached)
        print(f"fleet transport: {FT_NODES} Config() nodes x {epochs} epochs of {NODE_EVENTS} "
              f"events fed, closed, shipped and merged in {feed_s:.1f} s (the first "
              f"{FT_EPOCHS}); rollups equal to the plain merge of the {len(sent)} tapped "
              f"frames; a merged epoch {merge_ms:.3f} ms (median of {epochs}, frames in to "
              f"rollup out); ship-queue drops {ship_drops}; /fleet/query last=4 over the "
              f"aggregator's ring {query_ms['ring'][0]:.3f} ms cold, {query_ms['ring'][1]:.3f} "
              f"ms cached; over {FT_NODES} node clients {query_ms['nodes'][0]:.3f} ms cold, "
              f"{query_ms['nodes'][1]:.3f} ms cached; equal to the plain versions; card "
              f"{name_power}", flush=True)
    finally:
        agg.stop()
        bus.unsubscribe(FLEET_TOPIC, tap)
        if relay is not None:
            relay.stop(0)
        for eng in engines:
            eng.stop()
    del engines, agg, frames

    # The dryruns at their reference defaults, on the card.
    for name, fn in (("run_dryrun", run_dryrun), ("run_invertible_dryrun", run_invertible_dryrun),
                     ("run_fleetquery_dryrun", run_fleetquery_dryrun)):
        t0 = time.perf_counter()
        res = fn(device=dev)
        secs = time.perf_counter() - t0
        checks = res.get("checks", {})
        check(res["ok"], f"{name}: not ok: {[k for k, v in checks.items() if not v] or res}")
        extra = (f"recall {res['recall_min']}" if "recall_min" in res else
                 f"storm p99 {res['storm']['p99_ms']} ms, "
                 + ", ".join(f"{d} recall {sc['recall']}" for d, sc in res["detectors"].items()))
        print(f"fleet transport: {name} ok in {secs:.1f} s ({extra}); card {name_power}",
              flush=True)

    # The agent as a user starts it in the three fleet roles.
    print(f"fleet transport: this process's busiest threads over 1 s before the child "
          f"(CPU s): {busy_threads()}", flush=True)
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        print(f"fleet transport: card memory before the child: {free / 2**30:.2f} of "
              f"{total / 2**30:.2f} GiB free, {torch.cuda.memory_reserved(dev) / 2**30:.2f} "
              f"GiB reserved by this process", flush=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        child_port = sk.getsockname()[1]
    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if not k.startswith("RETINA_")}
    out_path = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_")) / "agent.log"

    def get(path: str) -> tuple[int, str]:
        with urllib.request.urlopen(f"http://127.0.0.1:{child_port}{path}", timeout=60) as r:
            return r.status, r.read().decode()

    sets = ["fleet_enabled=true", "fleet_aggregator=true", "fleetquery_enabled=true",
            "timetravel_enabled=true", "fleet_expected_nodes=1",
            f"api_server_addr=127.0.0.1:{child_port}"]
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        child = subprocess.Popen(
            [sys.executable, "-m", "retina_tpu_torch", "agent"]
            + [a for s_ in sets for a in ("--set", s_)],
            cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        text = ""

        def merged() -> bool:
            nonlocal text
            check(child.poll() is None, "fleet transport: the agent child exited: "
                  + out_path.read_text()[-2000:])
            try:
                text = get("/metrics")[1]
            except OSError:
                return False
            return any(line.startswith("networkobservability_fleet_windows_merged_counter_total ")
                       and float(line.rsplit(" ", 1)[1]) >= 1 for line in text.splitlines())

        wait(merged, "the agent child's first merged epoch", DAEMON_CHILD_S)
        child_s = time.perf_counter() - t0
        fleet_lines = [ln for ln in text.splitlines()
                       if ln.startswith("networkobservability_fleet_")]
        check(any(ln.startswith("networkobservability_fleet_nodes_reporting 1") for ln in
                  fleet_lines), "fleet transport: the child's fleet_nodes_reporting is not 1")
        # Under SHEDDING and above the query plane starts no fold and answers
        # 503 busy (the reference's contract): ask again until the child's
        # overload controller lets one through, and count the refusals.
        busy, states, last_top = 0, set(), None
        deadline = time.monotonic() + FT_WAIT_S
        while True:
            t1 = time.perf_counter()
            try:
                code, body = get("/fleet/query?last=4")
            except urllib.error.HTTPError as err:
                code, body = err.code, err.read().decode()
            child_q_ms = (time.perf_counter() - t1) * 1e3
            doc = json.loads(body)
            if code == 200:
                break
            check(code == 503 and doc.get("error") == "busy" and child.poll() is None,
                  f"fleet transport: the child's /fleet/query answered {code}: {body[:300]}")
            busy += 1
            block = overload_block(json.loads(get("/debug/vars")[1]))
            states.add(block["state"])
            last_top = top_signal(block["signals"])
            print(f"fleet transport: busy answer {busy}: overload {overload_line(block)}",
                  flush=True)
            check(time.monotonic() < deadline,
                  f"fleet transport: the child's /fleet/query stayed busy ({busy} answers, "
                  f"states {sorted(states)}, highest signal on the last {last_top}; this "
                  f"process's busiest threads {busy_threads()})")
            time.sleep(0.1)
        check(doc["windows"] >= 1 and doc["coverage"]["nodes_answered"] == 1,
              f"fleet transport: the child's /fleet/query answered {body[:300]}")
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    tail = out_path.read_text()[-2000:]
    check(rc == 0, f"fleet transport: the agent child exited {rc}: {tail}")
    print(f"fleet transport: python3 -m retina_tpu_torch agent in the fleet roles: first merged "
          f"epoch {child_s:.1f} s after its start, {len(fleet_lines)} fleet_* samples, "
          f"/fleet/query?last=4 {child_q_ms:.1f} ms ({doc['windows']} windows) after {busy} "
          f"busy answers (overload {sorted(states)}; highest signal on the last busy answer "
          f"{last_top}); exit {rc} on SIGTERM", flush=True)

    launches = kops.launch_counts()
    print(f"fleet transport launches: {launches}", flush=True)
    for name in FT_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the fleet transport phase")
    print(f"fleet transport: {time.perf_counter() - t_phase:.1f} s", flush=True)


SHARDS = 4  # the sharded phase's shards, all on the one card
SHARD_QUANTA = 3  # ingest path 1's three distinct quanta, a close after the second
SHARD_KERNELS = ("step_rows", "hh_update", "hll_update", "entropy_update", "conntrack",
                 "latency_update", "ingest_new", "fold", "topk_join", "ct_active",
                 "snapshot_flat", "window_close")
# The merged leaves equal to one shard's by construction: sums of the
# disjoint shards' per-row counts and maxes of their registers, and the
# totals but ct_reports (6) and lost (7). At low aggregation the flow and
# service sketches, the pod HLL bank, the entropy counts and the invertible
# planes take the conntrack reports, whose count depends on how each
# connection's rows fall into batches, and so on the shards' windows: only
# the export's leaves fed a row at a time are exact there. At high
# aggregation every sketch is fed a row at a time.
EXACT_SNAPSHOT = ("pod_forward", "pod_drop", "pod_tcpflags", "pod_dns", "pod_retrans",
                  "node_counters", "lat_hist", "hll_flows", "hll_src_per_reason")
EXACT_EXPORT_LOW = ("dns_cms", "hll_flows")
EXACT_EXPORT_HIGH = ("flow_cms", "svc_cms", "dns_cms", "hll_flows", "hll_src_per_pod",
                     "entropy", "inv_flow_planes", "inv_flow_weights", "inv_hi_planes",
                     "inv_hi_weights")


def sharded_phase(dev, quanta, pods, smi, equal_any) -> None:
    """The engine over SHARDS shards on one card (``SketchEngine(cfg,
    devices=[card] * SHARDS)``) at ``Config()`` and at
    ``Config(heavy_keys_source="invertible")``: SHARD_QUANTA of ingest path
    1's quanta flushed (a close after the second), then the fleet export, a
    snapshot and the last close (with the invertible decode). Each run must
    equal the same run under ``kops.plain_versions()`` bit for bit (every
    shard's state, the closes, snapshots, exports and decodes); its merged
    leaves that are exact by construction (EXACT_SNAPSHOT, totals[0:6] and
    EXACT_EXPORT_LOW; at high aggregation, a third run without the plain
    one, EXACT_EXPORT_HIGH) must equal a one-shard engine's over the same
    quanta; the union's
    candidate tables must hold the quanta's 10 heaviest flows in their top
    100. K1 must launch SHARDS times a step, K8 and K9 where the merges
    are. Then the same four shards' merges again in a world-size-1 NCCL
    process group (``make_mesh(..., group=)``), equal to the group-less
    merges bit for bit, with the collectives' added device time. Prints the
    flush rate at SHARDS shards and at one, the close's and the snapshot's
    device time at both (the merge's K8 alone), and the snapshot's latency,
    each beside ``smi`` (the card's name and power limit)."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.convert import state_from_numpy, state_to_numpy
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.parallel.mesh import make_mesh
    from retina_tpu_torch.parallel.telemetry import (
        HLL_LEAVES,
        SUM_LEAVES,
        ShardedTelemetry,
        topk_from_snapshot,
    )
    from retina_tpu_torch.u32 import to_numpy

    t_phase = time.perf_counter()
    schedule = quanta[:SHARD_QUANTA]
    fed = sum(len(b) for blocks in schedule for b in blocks)

    def run(cfg, devices, plain):
        eng = SketchEngine(cfg, devices=devices)
        eng.update_identities(pods)
        ctx = kops.plain_versions if plain else contextlib.nullcontext
        out: dict = {"wins": [], "flush_s": 0.0}
        for i, blocks in enumerate(schedule):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx():
                eng.flush(blocks, 100 + i)
            torch.cuda.synchronize()
            out["flush_s"] += time.perf_counter() - t0
            if i == 1:
                with ctx():
                    out["wins"].append(eng.close_window(epoch=i))
        with ctx():
            out["export"] = eng.telemetry.fleet_export(eng.states)
            out["snap"] = eng.snapshot(max_age_s=0, now_s=200)
            out["wins"].append(eng.close_window(epoch=SHARD_QUANTA))
        torch.cuda.synchronize()
        out["eng"] = eng
        return out

    def same_states(a, b, what):
        for d, (x, y) in enumerate(zip(a.states, b.states)):
            for leaf, (p, q) in enumerate(zip(state_to_numpy(x), state_to_numpy(y))):
                check(p.shape == q.shape and np.array_equal(p, q),
                      f"{what}: shard {d} leaf {leaf} differs")

    # The quanta's heaviest flows by packets, keyed as flow_hh: (src, dst,
    # ports, proto).
    rows = np.concatenate([b for blocks in schedule for b in blocks])
    keys = np.stack([rows[:, F.SRC_IP], rows[:, F.DST_IP], rows[:, F.PORTS],
                     rows[:, F.META] >> np.uint32(24)], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    weight = np.zeros(len(uniq), np.uint64)
    np.add.at(weight, inv.reshape(-1), rows[:, F.PACKETS].astype(np.uint64))
    heavy = {tuple(k) for k in uniq[np.argsort(weight)[::-1][:10]]}

    devices = [dev] * SHARDS
    for label, cfg, exact in (
            ("deployed", Config(), EXACT_EXPORT_LOW),
            ("invertible", Config(heavy_keys_source="invertible"), EXACT_EXPORT_LOW),
            ("high aggregation", Config(heavy_keys_source="invertible",
                                        data_aggregation_level="high"), EXACT_EXPORT_HIGH)):
        name = f"sharded path ({label}, {SHARDS} shards)"
        timed = label != "high aggregation"
        # The flush rates in turns: one shard, SHARDS, SHARDS, one.
        one_a = run(cfg, [dev], plain=False)["flush_s"] if timed else 0.0
        kops.reset_launch_counts()
        got = run(cfg, devices, plain=False)
        launches = kops.launch_counts()
        eng = got["eng"]
        got_b = run(cfg, devices, plain=False)["flush_s"] if timed else 0.0
        one = run(cfg, [dev], plain=False)
        for k in EXACT_SNAPSHOT:
            equal_any(got["snap"][k], one["snap"][k], f"{name} {k} vs one shard")
        equal_any(got["snap"]["totals"][:6], one["snap"]["totals"][:6],
                  f"{name} totals[0:6] vs one shard")
        for k in got["export"]:
            if k in exact:
                equal_any(got["export"][k], one["export"][k], f"{name} export {k} vs one shard")
            else:
                diff = int((got["export"][k] != one["export"][k]).sum())
                print(f"{name}: export {k} differs from one shard's in {diff} of "
                      f"{got['export'][k].numel()}", flush=True)
        if not timed:
            continue
        print(f"{name} launches: {launches}", flush=True)
        check_sketch_launches(launches, name)
        kernels = SHARD_KERNELS + (("inv_update", "inv_decode", "cms_query", "ingest_packed")
                                   if label == "invertible" else ())
        for k in kernels:
            if k != "ingest_new" or label == "deployed":
                check(launches[k] > 0, f"{k} was not launched on the {name}")
        check(launches["step_rows"] == SHARDS * eng.counts.steps,
              f"{name}: K1 launched {launches['step_rows']} times in {eng.counts.steps} "
              f"steps of {SHARDS} shards")
        check(launches["topk_join"] == 1, f"{name}: the export launched K9 "
              f"{launches['topk_join']} times")
        before = kops.launch_counts()
        ref = run(cfg, devices, plain=True)
        check(kops.launch_counts() == before, f"the plain {name} run launched kernels")
        same_states(eng, ref["eng"], name)
        for w, (a, b) in enumerate(zip(got["wins"], ref["wins"])):
            equal_any(a, b, f"{name} close {w}")
        equal_any(got["export"], ref["export"], f"{name} export")
        equal_any(dict(got["snap"]), dict(ref["snap"]), f"{name} snapshot")
        check(int(to_numpy(got["snap"]["totals"])[0]) == fed & 0xFFFFFFFF,
              f"{name}: totals[0] != raw events fed")
        check(eng.counts.events == fed, f"{name}: events counted != fed")

        tk, _ = topk_from_snapshot(got["snap"], "flow_hh", 100)
        found = {tuple(k) for k in tk} & heavy
        check(len(found) == len(heavy), f"{name}: the union's top 100 holds {len(found)} "
              "of the 10 heaviest flows")

        # -- the same shards in a world-size-1 NCCL group --
        fd, init = tempfile.mkstemp(prefix="nccl-init-")
        os.close(fd)
        os.unlink(init)
        dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
        try:
            grouped = ShardedTelemetry(eng.pcfg, make_mesh(devices, group=dist.group.WORLD))
            plain_tel = eng.telemetry
            states = eng.states
            for what, fn in (("snapshot", lambda t: t.snapshot(states, 300)),
                             ("export", lambda t: t.fleet_export(states)),
                             ("decode", lambda t: t.inv_decode(states, 0))):
                if what == "decode" and not eng.pcfg.enable_invertible:
                    continue
                equal_any(fn(grouped), fn(plain_tel), f"{name} NCCL {what}")
            copies = [[state_from_numpy(state_to_numpy(s), s) for s in states] for _ in range(2)]
            _, win_g = grouped.end_window(copies[0])
            _, win_p = plain_tel.end_window(copies[1])
            equal_any(win_g, win_p, f"{name} NCCL close")
            for d, (x, y) in enumerate(zip(copies[0], copies[1])):
                for leaf, (p, q) in enumerate(zip(state_to_numpy(x), state_to_numpy(y))):
                    check(np.array_equal(p, q), f"{name} NCCL close: shard {d} leaf {leaf}")
            g_ms = device_ms(lambda: grouped.snapshot_flat_dispatch(states, 300))
            p_ms = device_ms(lambda: plain_tel.snapshot_flat_dispatch(states, 300))
            nccl_ms = device_ms(lambda: grouped.snapshot_flat_dispatch(states, 300),
                                kernel="nccl", require=False)
        finally:
            dist.destroy_process_group()
        print(f"{name}: NCCL (world size 1) snapshot device {g_ms:.4f} ms vs {p_ms:.4f} ms "
              f"without a group (the collectives add {g_ms - p_ms:.4f} ms); the NCCL kernels "
              f"{'not measured' if nccl_ms is None else f'{nccl_ms:.4f} ms'} a snapshot "
              f"[{smi}]", flush=True)

        # -- timings, beside the card --
        tel1 = one["eng"].telemetry
        st1 = one["eng"].states
        snap_ms = device_ms(lambda: eng.telemetry.snapshot_flat_dispatch(eng.states, 300))
        snap1_ms = device_ms(lambda: tel1.snapshot_flat_dispatch(st1, 300))
        fold_ms = device_ms(lambda: eng.telemetry.snapshot_flat_dispatch(eng.states, 300),
                            kernel="fold")
        close_ms = device_ms(lambda: eng.telemetry.end_window(eng.states))
        close1_ms = device_ms(lambda: tel1.end_window(st1))
        close_fold_ms = device_ms(lambda: eng.telemetry.end_window(eng.states), kernel="fold")

        def plain(fn):
            with kops.plain_versions():
                return fn()

        snap_plain_ms = device_ms(lambda: plain(
            lambda: eng.telemetry.snapshot_flat_dispatch(eng.states, 300)))
        close_plain_ms = device_ms(lambda: plain(lambda: eng.telemetry.end_window(eng.states)))
        lat = []
        for _ in range(8):
            t0 = time.perf_counter()
            eng.snapshot(max_age_s=0, now_s=300)
            lat.append((time.perf_counter() - t0) * 1e3)
        lat1 = []
        for _ in range(8):
            t0 = time.perf_counter()
            one["eng"].snapshot(max_age_s=0, now_s=300)
            lat1.append((time.perf_counter() - t0) * 1e3)
        leaf_bytes = sum(t.numel() * t.element_size() for s in eng.states for t in (
            [getattr(s, k) for k in SUM_LEAVES] + [getattr(s, k).registers for k in HLL_LEAVES]))
        bound_ms = leaf_bytes * (1 + 1 / SHARDS) / HBM_BYTES_PER_S * 1e3
        turns = (one_a, got["flush_s"], got_b, one["flush_s"])
        print(f"{name}: flush events/s in turns (one shard, {SHARDS}, {SHARDS}, one) "
              + ", ".join(f"{fed / t:.0f}" for t in turns)
              + f" ({fed} events; {eng.counts.steps} steps at {SHARDS} shards, "
              f"{one['eng'].counts.steps} at one) [{smi}]", flush=True)
        print(f"{name}: close device {close_ms:.4f} ms at {SHARDS} shards (K8 at {SHARDS} "
              f"shards {close_fold_ms:.4f}; plain versions {close_plain_ms:.4f}), "
              f"{close1_ms:.4f} at one; snapshot device {snap_ms:.4f} ms at {SHARDS} shards "
              f"(K8 at {SHARDS} shards {fold_ms:.4f}, bound of the merge's {leaf_bytes} bytes "
              f"read {bound_ms:.4f}; plain versions {snap_plain_ms:.4f}), {snap1_ms:.4f} at "
              f"one; snapshot latency median {np.median(lat):.3f} ms at {SHARDS} shards, "
              f"{np.median(lat1):.3f} at one [{smi}]", flush=True)
    print(f"sharded phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def sticky_child() -> int:
    """(``chip_smoke.py --sticky-child``.) The lanes (``SketchEngine.start``,
    inline feed) on the card, fed one block through the sink; then the
    card's context is poisoned with a device-side assert (an out-of-range
    index on a CUDA tensor, run through the device proxy) and more blocks
    are fed. The next dispatch fails on the lost context, which is fatal;
    every recovery attempt fails on it too (restart_max_failures 2, a 50 ms
    backoff), so the circuit opens and ``recovery_failed`` latches, the
    state left on the card. Prints one JSON line and leaves with
    ``os._exit`` (the lost context makes torch's own teardown unsafe)."""
    import os
    import threading

    import torch

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip

    t0 = time.perf_counter()
    out: dict = {"poisoned": "", "recovery_failed": False, "state_device": "", "restarts": -1}
    try:
        cfg = Config(restart_max_failures=2, restart_backoff_base_s=0.05,
                     restart_backoff_jitter=0.0, watchdog_deadline_s=SUP_DEADLINE_S,
                     feed_workers=1)
        eng = SketchEngine(cfg, device=torch.device("cuda"))
        eng.update_identities({pod_ip(i): i for i in range(1, 64)})
        gen = TrafficGen(n_flows=10_000, n_pods=64, seed=SEED)
        stop = threading.Event()
        lanes = threading.Thread(target=eng.start, args=(stop,), daemon=True)
        lanes.start()

        def wait(pred, bound: float) -> bool:
            deadline = time.monotonic() + bound
            while not pred() and time.monotonic() < deadline:
                time.sleep(0.01)
            return pred()

        eng.sink.write_records(gen.batch(BLOCK), "gen")
        out["stepped_before"] = wait(lambda: eng.counts.events >= BLOCK, 60)

        def poison():
            x = torch.zeros(4, device="cuda")
            x[torch.tensor([1 << 20], device="cuda")].sum()
            torch.cuda.synchronize()

        try:
            eng._proxy.run(poison)
        except Exception as e:  # the assert surfaces at the synchronize
            out["poisoned"] = str(e).splitlines()[0]
        deadline = time.monotonic() + 120
        while not eng.recovery_failed.is_set() and time.monotonic() < deadline:
            eng.sink.write_records(gen.batch(BLOCK), "gen")
            time.sleep(0.05)
        stop.set()
        lanes.join(90)
        out.update(recovery_failed=eng.recovery_failed.is_set(),
                   state_device=str(eng.state.totals.device), restarts=eng.restarts,
                   attempts=eng.errors["recovery"], degraded=eng.degraded,
                   lanes_stopped=not lanes.is_alive(), errors=dict(eng.errors),
                   lost_events=dict(eng.lost_events),
                   seconds=round(time.perf_counter() - t0, 3))
    except Exception as e:
        out["error"] = repr(e)[:500]
    print(json.dumps({"sticky": out}), flush=True)
    sys.stderr.flush()
    os._exit(0 if "error" not in out else 1)


if __name__ == "__main__":
    if sys.argv[1:] == ["--sticky-child"]:
        sys.exit(sticky_child())
    sys.exit(main())
