"""Where one step of the PyTorch/CUDA port spends its time on the card.

    python3 -m retina_tpu_torch.step_profile [--steps N] [--config NAME]
    python3 -m retina_tpu_torch.step_profile --feed
    python3 -m retina_tpu_torch.step_profile --sketches
    python3 -m retina_tpu_torch.step_profile --conntrack
    python3 -m retina_tpu_torch.step_profile --rows
    python3 -m retina_tpu_torch.step_profile --fold
    python3 -m retina_tpu_torch.step_profile --hll-inv
    python3 -m retina_tpu_torch.step_profile --ingest
    python3 -m retina_tpu_torch.step_profile --readout
    python3 -m retina_tpu_torch.step_profile --detect-query

Runs the port's main path (Telemetry.step at DEPLOYED_CONFIG, the deployed
agent: conntrack on, low aggregation; or the configuration ``--config``
names: ``no-conntrack``, ``production`` for PipelineConfig(), ``invertible``
for INVERTIBLE_CONFIG; two
2^21-event batches of a 1M-flow Zipf stream, as chip_smoke.py) and
reports, after a warm-up:

- steady-state step throughput with no synchronisation between steps
  (the host enqueues, the card runs), from the host clock;
- the device time of each kernel and torch op over the profiled steps,
  from torch.profiler, with the device's busy and idle share of the
  wall time, and the launches a step (the kernels, copies and fills the
  profiler saw on the card, divided by the steps);
- the device time of the step's K1 and K14 calls (captured at the
  wrappers and replayed, by kernel, from torch.profiler) and of the
  latency match's plain version (torch ops), from CUDA events.

With ``--feed`` it profiles the feed path instead: ``SketchEngine.flush``
at ``Config()`` (the deployed agent) over quanta of 256 blocks of 2^13
events of the same stream, as chip_smoke.py's ingest path 1, and reports
the wall time with and without the profiler and the device's busy share
of each (the device time of every kernel, memcpy and memset, from
torch.profiler), with the device time by kernel.

With ``--sketches`` it times the heavy-hitter update (K2, the three
instances of a step) and the entropy histograms (K4) as a step calls them,
by CUDA events over 10 replays after 2 warm-ups and by their device time in
torch.profiler (which leaves out the host's launch gaps, most of a short
call's CUDA-event span), at two weight sets of the
deployed widths: "per-row" (NO_CONNTRACK_CONFIG, high aggregation: every
masked row weighted) and "report" (DEPLOYED_CONFIG: the conntrack reports
weight the sketches). Each set is the calls of the 8th step of a fresh
state, captured at the wrappers. Then it times each step path
(DEPLOYED_CONFIG, PipelineConfig(), NO_CONNTRACK_CONFIG) by the host clock
around 16 synchronised steps, as chip_smoke.py's paths do. The script runs
unchanged in a copy of an older tree (copy this file into the copy's
package, then ``python3 -m retina_tpu_torch.step_profile --sketches`` from
the copy's root), so that two trees are compared in one call.

With ``--conntrack`` it times connection tracking (K5) as the deployed step
calls it: the K5 calls of DEPLOYED_CONFIG's 8th step, captured at the
wrapper and replayed 10 times after 2 warm-ups, by device time in
torch.profiler (by kernel, with the memset) and by CUDA events. Then the
same call on three batches that pull K5's costs apart, each on a table of
its own: every masked row a connection of its own ("distinct"), pairs of
rows a connection ("pairs": a repeated key in every warp, no hot one), and
every masked row one connection ("one": the hottest key there can be).
Like ``--sketches``, it runs unchanged in a copy of an older tree.

With ``--rows`` it times the step's per-event body (K1) as the deployed step
calls it: the K1 call of DEPLOYED_CONFIG's 8th step, captured at the wrapper
and replayed 10 times after 2 warm-ups, by device time in torch.profiler
(by kernel) and by CUDA events, and the same call with the step's latency
match (K14) after it. Then the K1 call on batches that pull its costs
apart, each on rectangles of their own: the step's batch ("zipf"); the same
rows with the pods of row i spread evenly over all P pods ("spread": no hot
pod); every masked row on one local pod ("one": the hottest address there
can be); every proto set to UDP ("udp": no TCP-flag counts); and no valid
row ("masked": the record reads and the scratch writes alone). It too runs
unchanged in a copy of an older tree.

With ``--fold`` it times the N-way fold (K8) of a range query and a fleet
epoch: the arrays ``fold_stacked`` sums or maxes (the fleet catalog of
``Config(heavy_keys_source="invertible")``, as chip_smoke.py's time-travel
and fleet paths export it, less the candidate tables), stacked 32 and 64
deep with random contents, by the device time of the fold kernels of one
``fold_stacked`` call and their launches, beside one ``sum``/``amax`` call
an array. Then the candidate-table join (K9) of the catalog's three
families (flow, svc, dns) at the same depths (random keys, counts below
2^16, a fifth of the slots empty in every table): the device time of its
kernels for all three families, back to back and with the L2 flushed by a
128 MiB write before each call, its launches in a ``fold_stacked`` call,
the plain version by CUDA events, and the bound (every table and count
read once, the result written once). It too runs unchanged in a copy of an
older tree (one ``topk_join`` call a family there).

With ``--hll-inv`` it times the HLL banks (K3) and the invertible sketches
(K6) as the step calls them: the K3 and K6 calls of the 8th step of a fresh
state at INVERTIBLE_CONFIG (the conntrack reports weight and mask them:
"report") and at the same configuration with high aggregation (every
masked row: "per-row"), captured at the step's wrappers (one
``hll_update_many`` and one ``inv_update_pair`` call, or, in an older tree,
three ``hll_update`` and two ``inv_update`` calls) and replayed 10 times
after 2 warm-ups, by device time in torch.profiler (by kernel) and by CUDA
events. An older tree's K6 replay includes the step's torch ops that split
the weights by the priority class (``!=`` and two ``where``), as its step
runs them; its K3 replay lacks the step's ``pod_mask & report``, which the
step profile shows. The batches beside the step's: weights and masks all 0
("zero": the scan floor), every masked row on the first row's key
("one-key", at the per-row weights: one bucket a depth, the hottest), and
the report weights with a priority class (src or dst in pods 1-255, the
/24 of ``pod_ip(0)``: "priority", which feeds inv_hi). It too runs
unchanged in a copy of an older tree.

With ``--ingest`` it times the three ingest entries (K7: ``ingest_packed``,
``ingest_new``, ``ingest_known``), each call 10 times after 2 warm-ups, by
its device time by kernel in torch.profiler, back to back (the batch stays
in the L2) and with the L2 flushed before each call, by the CUDA-event span
of one call, and by the difference of span and device time (the wrapper's
host cost a call), beside its launches and its sector bound (each wire byte
once, 64 bytes an output row; on the new side 48 bytes a distinct id's table
row and 32 a distinct sector of claim words; on the known side 32 a distinct
sector of the table rows read). The batches: "default" (chip_smoke.py's
default-flush inputs: a bucket of 2^17 rows in windows of 2^15, 2^18 slots)
and "bench" (a bucket of 2^18 in one window of 2^19, 2^21 slots: the table
does not fit in L2), for all three entries; on the new side the wires of
``new_claim_wires``: "a third padding", "one id" (the hottest claim),
"distinct" and "distinct 98304" (the claim's floor); "path 1", the two
new-side dispatches of ``SketchEngine.flush`` at ``Config()`` on the second
quantum of bench.py's traffic (a full 2^17-row bucket and a 98,304-row one
padded with id-0 rows), and "path 2 known", the known-side dispatch at bench
sizing on a quantum fed again, both captured at the wrapper and replayed;
the known side's batches beside ``index_select`` + copy. It too runs
unchanged in a copy of an older tree.

With ``--readout`` it times the window close (K16) and the scrape's readout
(K17 and the copies around it), each call 10 times after 2 warm-ups, by its
device time by kernel, copy and fill in torch.profiler (every one that one
call launches), back to back and with the L2 flushed by a 128 MiB write
before each call, beside the launches of one call, the CUDA-event span of
one call (each call synchronised alone), the host cost (span less device
time) and the sector bound (``readout_sector_bytes``: K16's row read and
written once; the readout's copied leaves, HLL banks, conntrack keys and
the 32-byte sectors of resident slots' value rows read once, the flat
buffer written once), with the launch floor (a one-word fill) and
``torch.cat`` of the copied leaves (the readout's library call) beside.
The batches: "close" (``Telemetry.end_window`` on DEPLOYED_CONFIG after one
window of the bench stream, K16 at (3, 4096), the histogram restored
before each call), "collapse" (each group's mass in one bucket), "dense"
(every bucket nonzero), "K max" (K = 16384, the wrapper's limit) through
``kops.window_close``; "bits" (``kops.entropy_bits`` on a histogram
summed over 32 windows, the range query's call); and ``Telemetry.snapshot``
and ``snapshot_flat_dispatch`` on the same state ("scrape", the conntrack
table filled), on a zero state ("empty": every HLL group counts linearly)
and on INVERTIBLE_CONFIG's state after one window ("invertible scrape").
In a tree whose wrappers have the knobs ``kops.ENTROPY_SLICES`` and
``kops.READOUT_BLOCK_BYTES``, it also times the designs measured on the
way: K16 at 1 to 48 blocks a group, the readout at 4 to 64 KiB a block. It
too runs unchanged in a copy of an older tree.

With ``--detect-query`` it times the portscan score (K11), the invertible
decode (K15) and the Count-Min query (K10) by device time by kernel in
torch.profiler, back to back and with the L2 flushed before each call,
beside the launches of a call, the CUDA-event span of a call and the sector
bound. K15's batch: a window close's decode of both regions of
INVERTIBLE_CONFIG's state after one window of the bench stream ("close":
one launch, or one a region in an older tree). K11's batches: the tap's
2^16 keys of a portscan-regime window ("2^16"), 40 rows padded to 64
("padded 64"), every source in one hash-group ("one group": every register
update lands in one group's registers) and a benign 2^16-row window with the
detection path's 24-port sweep in it (2^15 rows of each: "sweep"). K10's
batches: a window close's verify of both invertible regions (the query and
``decode_verified``'s filter after K15's decode, on INVERTIBLE_CONFIG's state
after one window of the bench stream: "close"), the fleet union of 131,072
candidate rows (a row-major (R, 4) tensor, "union"), one row ("1 row") and
65,536 and 262,144 rows;
beside them ``torch.gather`` + ``amin`` on indices computed beforehand (the
library call). The bank's close kernel (``kops.bank_close``) on the sweep
window's features, a close of the three built-in detectors, by device time
and by the host's wall time of a call, beside ``torch.special.entr`` +
``sum`` (the library call). End to end, each by the host clock around
calls synchronised alone: ``Telemetry.inv_decode`` on that state (its span,
device time and launches); the detector bank's close of the sweep window,
whole, its launches, host syncs and device time a close from
torch.profiler, and split into the portscan feature build, the copies to
the card, K11, and the scores and EWMA (``kops.bank_close``) (each stage
synchronised; the rest is the host's judging and the bank's bookkeeping); a warm merge of 64
nodes' frames (``FleetAggregator``: 64 engines' closes of 2^18 events each,
as chip_smoke.py's fleet path) and a warm 32-window range query
(``QueryService._query`` over the ring of 34 closed windows of 2^21 events).
Before it measures, it keeps the card busy for 3 s, so that its clocks have
risen. It too runs unchanged in a copy of an older tree.

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
STEPS = 8  # steps of a window, as chip_smoke.py's main path
# The wrappers of K2 and K4 that a step calls (hh_update_many is absent
# from older trees, whose step calls hh_update once per sketch).
SKETCH_WRAPPERS = {"hh_update": "k2", "hh_update_many": "k2", "entropy_update": "k4"}


def cuda_ms(fn, reps: int = 10) -> float:
    """ms of one call of ``fn`` by CUDA events over ``reps`` calls after 2
    warm-ups."""
    import torch

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


def device_ms(fn, reps: int = 10) -> float:
    """ms of device time of one call of ``fn`` (see ``kernel_ms``): the
    summed durations of what the calls ran on the card, without the host's
    launch gaps a CUDA-event span holds."""
    return sum(kernel_ms(fn, reps).values())


def capture_sketch_calls(step) -> dict[str, list]:
    """Run ``step()`` and return the K2 and K4 wrapper calls it made, as
    {"k2": [(wrapper, args)], "k4": [...]}: replaying them repeats the
    step's sketch updates on the same tensors. A wrapper called from
    inside another is not recorded twice."""
    from retina_tpu_torch.kernels import ops as kops

    calls: dict[str, list] = {"k2": [], "k4": []}
    depth = [0]
    saved = {n: getattr(kops, n) for n in SKETCH_WRAPPERS if hasattr(kops, n)}

    def recording(name, fn):
        def call(*args):
            if depth[0] == 0:
                calls[SKETCH_WRAPPERS[name]].append((fn, args))
            depth[0] += 1
            try:
                return fn(*args)
            finally:
                depth[0] -= 1
        return call

    for name, fn in saved.items():
        setattr(kops, name, recording(name, fn))
    try:
        step()
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)
    return calls


def replay(calls: list) -> None:
    for fn, args in calls:
        fn(*args)


def call_weights(calls: list) -> list:
    """The weight lane of each sketch update in K2 or K4 calls."""
    out = []
    for fn, args in calls:
        if fn.__name__ == "hh_update_many":
            out += [inst[-1] for inst in args[0]]
        else:
            out.append(args[-1])
    return out


def sketch_calls(dev, recs, ident, steps: int = STEPS) -> dict[str, dict[str, list]]:
    """{"per-row": calls, "report": calls}: the K2 and K4 calls of the last
    of ``steps`` steps of a fresh state at NO_CONNTRACK_CONFIG and at
    DEPLOYED_CONFIG (now_s 2, the batches in turn, as chip_smoke.py's main
    path steps its first window)."""
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG, NO_CONNTRACK_CONFIG
    from retina_tpu_torch.parallel.telemetry import Telemetry

    out = {}
    for label, cfg in (("per-row", NO_CONNTRACK_CONFIG), ("report", DEPLOYED_CONFIG)):
        tel = Telemetry(cfg, device=dev)
        state = tel.init_state()
        for s in range(steps - 1):
            state, _ = tel.step(state, recs[s % 2], len(recs[0]), 2, ident)
        out[label] = capture_sketch_calls(
            lambda: tel.step(state, recs[(steps - 1) % 2], len(recs[0]), 2, ident))
    return out


def sketches(dev, recs, ident) -> dict:
    """K2 and K4 at both weight sets, then ms/step of the three step paths."""
    import torch

    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import (
        DEPLOYED_CONFIG,
        NO_CONNTRACK_CONFIG,
        PipelineConfig,
    )
    from retina_tpu_torch.parallel.telemetry import Telemetry

    result: dict = {}
    for label, calls in sketch_calls(dev, recs, ident).items():
        for kernel, group in calls.items():
            before = sum(kops.launch_counts().values())
            replay(group)
            launches = sum(kops.launch_counts().values()) - before
            ms = cuda_ms(lambda: replay(group))
            dev_ms = device_ms(lambda: replay(group))
            weighted = [int((w != 0).sum()) for w in call_weights(group)]
            result[f"{kernel}_{label}_ms"] = ms
            result[f"{kernel}_{label}_device_ms"] = dev_ms
            result[f"{kernel}_{label}_launches"] = launches
            print(f"{kernel.upper()} at the {label} weights: {ms:.4f} ms (CUDA events), device "
                  f"time {dev_ms:.4f} ms, {len(group)} wrapper calls, {launches} launches, "
                  f"weighted rows {weighted} of {BATCH}", flush=True)
        del calls
    for name, cfg in (("main path", DEPLOYED_CONFIG), ("production path", PipelineConfig()),
                      ("no-conntrack path", NO_CONNTRACK_CONFIG)):
        tel = Telemetry(cfg, device=dev)
        state = tel.init_state()
        for s in range(2):
            state, _ = tel.step(state, recs[s % 2], BATCH, 2, ident)
        wall = 0.0
        for s in range(2 * STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _ = tel.step(state, recs[s % 2], BATCH, 2 + s // STEPS, ident)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t
        result[f"{name} ms_per_step"] = wall / (2 * STEPS) * 1e3
        print(f"{name}: {wall / (2 * STEPS) * 1e3:.3f} ms/step over {2 * STEPS} synchronised "
              f"steps", flush=True)
        del state, tel
    return result


def capture_calls(step, names: tuple[str, ...]) -> list:
    """Run ``step()`` and return its calls of the kernel wrappers ``names``,
    in order, as (name, wrapper, args, kwargs): replaying them repeats the
    step's calls on the same tensors. A wrapper called from inside another
    is not recorded twice."""
    from retina_tpu_torch.kernels import ops as kops

    calls, saved, depth = [], {n: getattr(kops, n) for n in names}, [0]

    def recording(name, fn):
        def call(*args, **kwargs):
            if depth[0] == 0:  # a wrapper called from inside another is not recorded
                calls.append((name, fn, args, kwargs))
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return call

    for name, fn in saved.items():
        setattr(kops, name, recording(name, fn))
    try:
        step()
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)
    return calls


def replay_calls(calls: list) -> None:
    for _, fn, args, kwargs in calls:
        fn(*args, **kwargs)


def conntrack_variants(args: tuple) -> dict[str, tuple]:
    """K5's arguments on batches that separate its costs: the step's own
    ("step"), every row its own connection ("distinct": src = the row),
    pairs of rows one connection ("pairs": src = the row // 2) and every row
    one connection ("one"). Each variant but the step's has a fresh table
    and scratch of its own."""
    import torch

    keys, vals, seed, src = args[:4]
    rows = torch.arange(src.shape[0], dtype=torch.int32, device=src.device)
    one = torch.ones_like(rows)
    out = {"step": args}
    for name, cols in (("distinct", (rows, one, one, 6 * one)),
                       ("pairs", (rows // 2, one, one, 6 * one)),
                       ("one", (0 * one, one, one, 6 * one))):
        out[name] = (torch.zeros_like(keys), torch.zeros_like(vals), seed, *cols, *args[7:-1],
                     {})
    return out


def kernel_ms(fn, reps: int = 10) -> dict[str, float]:
    """Device ms of one call of ``fn`` by kernel, memcpy or memset name, from
    torch.profiler over ``reps`` calls after 2 warm-ups. A trace with no
    device time is taken again, at most four times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    rows: list = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows, _ = device_rows(prof)
        if rows:
            break
    out: dict[str, float] = {}
    for us, _, key in rows:  # names that share their first 60 characters add up
        out[key[:60]] = out.get(key[:60], 0.0) + us / 1e3 / reps
    return out


def conntrack(dev, recs, ident) -> dict:
    """K5 at the deployed step's calls and at the variants."""
    import torch

    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG
    from retina_tpu_torch.ops.conntrack import fingerprint
    from retina_tpu_torch.parallel.telemetry import Telemetry

    tel = Telemetry(DEPLOYED_CONFIG, device=dev)
    state = tel.init_state()
    for s in range(STEPS - 1):
        state, _ = tel.step(state, recs[s % 2], BATCH, 2, ident)
    calls = capture_calls(lambda: tel.step(state, recs[(STEPS - 1) % 2], BATCH, 2, ident),
                          ("conntrack_process",))
    result: dict = {}
    for _, fn, args, _ in calls:
        for name, vargs in conntrack_variants(args).items():
            def once(fn=fn, vargs=vargs):
                return fn(*vargs)
            out = once()
            mask = vargs[10] != 0
            lo, hi, _ = fingerprint(*vargs[3:7], vargs[2])
            key = (lo << 32) | hi
            n_conn = int(torch.unique(key[mask]).numel())
            chunk = torch.arange(BATCH, device=dev) // 2048  # the rows' 2048-row chunk
            per_chunk = torch.unique(torch.stack([chunk[mask], key[mask]]), dim=1).shape[1] \
                / (BATCH // 2048)
            ms = cuda_ms(once)
            by_kernel = kernel_ms(once)
            dev_ms = sum(by_kernel.values())
            result[f"k5_{name}_ms"] = ms
            result[f"k5_{name}_device_ms"] = dev_ms
            print(f"K5 on the {name} batch: {ms:.4f} ms (CUDA events), device time "
                  f"{dev_ms:.4f} ms ({', '.join(f'{k} {v:.4f}' for k, v in by_kernel.items())}); "
                  f"{int(mask.sum())} masked rows, {n_conn} connections, "
                  f"{per_chunk:.1f} a 2048-row chunk, {int(out[0].sum())} reports", flush=True)
    return result


def rows_variants(args: tuple, kwargs: dict, spread_ident) -> dict[str, tuple]:
    """K1's (args, kwargs) on batches that separate its costs: the step's
    own rows ("zipf"); the pods of row i spread evenly over all P pods
    ("spread": source and destination pod_ip(1 + i mod (P - 1)), looked up
    in ``spread_ident``, which maps them); every row on pod 1 ("one");
    every proto UDP ("udp"); and n_valid 0 ("masked"). Each has zeroed
    rectangles, node counters and totals of its own."""
    import torch

    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.events.synthetic import pod_ip

    rec, cfg = args[0], args[14]
    idx = torch.arange(rec.shape[0], device=rec.device)

    def with_lanes(**lanes):
        r = rec.clone()
        for lane, v in lanes.items():
            r[:, getattr(F, lane)] = v
        return r

    spread = (pod_ip(1) + idx % (cfg.n_pods - 1)).to(torch.int32)
    udp = (rec[:, F.META] & 0x00FFFFFF) | (17 << 24)
    out = {}
    for name, r, n_valid, ident in (
        ("zipf", rec, args[1], None),
        ("spread", with_lanes(SRC_IP=spread, DST_IP=spread), args[1], spread_ident),
        ("one", with_lanes(SRC_IP=pod_ip(1), DST_IP=pod_ip(1)), args[1], None),
        ("udp", with_lanes(META=udp), args[1], None),
        ("masked", rec, 0, None),
    ):
        a = list(args)
        a[0], a[1] = r, n_valid
        if ident is not None:
            a[3], a[4] = ident.table, ident.seed
        a[7:14] = [torch.zeros_like(t) for t in args[7:14]]
        out[name] = (tuple(a), kwargs)
    return out


def rows_profile(dev, recs, ident) -> dict:
    """K1 at the deployed step's call, with K14 after it, and at the
    variants."""
    import torch

    from retina_tpu_torch.events.synthetic import pod_ip
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.identity import IdentityMap
    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG
    from retina_tpu_torch.parallel.telemetry import Telemetry

    P = DEPLOYED_CONFIG.n_pods
    tel = Telemetry(DEPLOYED_CONFIG, device=dev)
    state = tel.init_state()
    for s in range(STEPS - 1):
        state, _ = tel.step(state, recs[s % 2], BATCH, 2, ident)
    calls = capture_calls(lambda: tel.step(state, recs[(STEPS - 1) % 2], BATCH, 2, ident),
                          ("step_rows", "latency_update"))
    result: dict = {}
    by_kernel = kernel_ms(lambda: replay_calls(calls))
    k14 = sum(v for k, v in by_kernel.items() if "step_rows" not in k)
    result["k1_k14_device_ms"] = sum(by_kernel.values())
    result["k14_device_ms"] = k14
    print(f"K1 + K14 as the step calls them: device time {sum(by_kernel.values()):.4f} ms "
          f"({', '.join(f'{k} {v:.4f}' for k, v in by_kernel.items())}); K14's part {k14:.4f} "
          f"ms; {len(calls)} wrapper calls", flush=True)
    spread_ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, P)}, n_slots=1 << 16,
                                          device=dev)
    _, fn, args, kwargs = calls[0]
    lane = {n: i for i, n in enumerate(kops.SCRATCH)}
    for name, (a, kw) in rows_variants(args, kwargs, spread_ident).items():
        def once(a=a, kw=kw):
            return fn(*a, **kw)
        scratch, _ = once()
        m = scratch[lane["mask"]] != 0
        ing = scratch[lane["pod_mask"]] != 0
        lc = torch.where(ing, scratch[lane["dst_pod"]], scratch[lane["src_pod"]]).clamp(max=P - 1)
        addr = (lc.long() * 2 + (~ing).long())[m]
        hot = int(torch.bincount(addr).max()) if addr.numel() else 0
        chunk_pod = (torch.arange(BATCH, device=dev) // 1024 * P + lc)[m]
        per_chunk = torch.unique(chunk_pod).numel() / (BATCH // 1024)
        ms = cuda_ms(once)
        by_kernel = kernel_ms(once)
        k1 = sum(v for k, v in by_kernel.items() if "step_rows" in k)
        result[f"k1_{name}_ms"] = ms
        result[f"k1_{name}_device_ms"] = k1
        print(f"K1 on the {name} batch: {ms:.4f} ms (CUDA events), device time {k1:.4f} ms "
              f"({', '.join(f'{k} {v:.4f}' for k, v in by_kernel.items())}); "
              f"{int(m.sum())} masked rows, {hot} on the hottest (pod, direction), "
              f"{per_chunk:.1f} local pods a 1024-row chunk", flush=True)
        del scratch
    return result


def join_call(families):
    """One call of K9 over ``families`` [(keys, counts)]: the many-family
    entry, or, in an older tree, one ``topk_join`` call a family."""
    from retina_tpu_torch.kernels import ops as kops

    if hasattr(kops, "topk_join_many"):
        return kops.topk_join_many(families)
    return [kops.topk_join(k, c) for k, c in families]


def fold(dev) -> dict:
    """K8 of fold_stacked at 32 and 64 slots, beside the library calls; K9
    for the three families at the same depths."""
    import numpy as np
    import torch

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.timetravel.fold import fold_stacked, host_arrays

    eng = SketchEngine(Config(heavy_keys_source="invertible"), device=dev)
    exported = host_arrays(eng.telemetry.fleet_export(eng.state))
    eng.stop()
    arrays = {k: v for k, v in exported.items() if not k.endswith(("_keys", "_counts"))}
    fams = [fam for fam in ("flow", "svc", "dns") if f"{fam}_keys" in exported]
    l2 = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)
    result: dict = {}
    for n in (32, 64):
        stacked = {}
        for k, a in arrays.items():
            shape = (n, *a.shape)
            if a.dtype == np.float32:
                x = torch.from_numpy(rng.integers(0, 1 << 20, shape).astype(np.float32))
            else:
                high = 34 if k.startswith("hll_") else 1 << 32
                x = torch.from_numpy(rng.integers(0, high, shape, dtype=np.uint64)
                                     .astype(np.uint32).view(np.int32))
            stacked[k] = x.to(dev)
        before = kops.launch_counts()["fold"]
        fold_stacked(stacked)
        launches = kops.launch_counts()["fold"] - before
        by_kernel = kernel_ms(lambda: fold_stacked(stacked))
        ms = sum(v for k, v in by_kernel.items() if "fold_kernel" in k)
        lib = sum(kernel_ms(lambda: [
            torch.amax(x, 0) if k.startswith("hll_") else torch.sum(x, 0, dtype=x.dtype)
            for k, x in stacked.items()]).values())
        n_elems = sum(x[0].numel() for x in stacked.values())
        bound = 4 * n_elems * (n + 1) / 3.35e12 * 1e3
        result |= {f"k8_{n}_ms": ms, f"k8_{n}_library_ms": lib, f"k8_{n}_launches": launches}
        print(f"K8 at {n} slots: {len(stacked)} arrays, {n_elems} elements a slot; device time "
              f"of the fold kernels of one fold_stacked call {ms:.4f} ms in {launches} "
              f"launches; library (one sum or amax an array) {lib:.4f} ms; bound {bound:.4f} "
              f"ms", flush=True)
        # K9: the families' candidate tables, counts below 2^16 with a fifth of
        # the slots empty in every table (there every table ties and K9 reads
        # every key row).
        joins, nbytes = [], 0
        for fam in fams:
            s, c = exported[f"{fam}_keys"].shape
            keys = rng.integers(0, 1 << 32, (n, s, c), dtype=np.uint64).astype(np.uint32)
            counts = rng.integers(1, 1 << 16, (n, s)).astype(np.uint32)
            empty = rng.random(s) < 0.2
            keys[:, empty], counts[:, empty] = 0, 0
            joins.append((torch.from_numpy(keys.view(np.int32)).to(dev),
                          torch.from_numpy(counts.view(np.int32)).to(dev)))
            stacked[f"{fam}_keys"], stacked[f"{fam}_counts"] = joins[-1]
            nbytes += 4 * s * (c + 1) * (n + 1)
        before = kops.launch_counts()["topk_join"]
        fold_stacked(stacked)
        k9_launches = kops.launch_counts()["topk_join"] - before
        warm = sum(v for k, v in kernel_ms(lambda: join_call(joins)).items()
                   if "join_kernel" in k)
        cold = sum(v for k, v in kernel_ms(lambda: (l2.zero_(), join_call(joins))).items()
                   if "join_kernel" in k)
        with kops.plain_versions():
            plain = cuda_ms(lambda: join_call(joins))
        k9_bound = nbytes / 3.35e12 * 1e3
        result |= {f"k9_{n}_ms": warm, f"k9_{n}_flushed_ms": cold, f"k9_{n}_plain_ms": plain,
                   f"k9_{n}_launches": k9_launches, f"k9_{n}_bound_ms": k9_bound}
        print(f"K9 at {n} slots, {len(joins)} families ({', '.join(fams)}): device time of the "
              f"join kernels of one call {warm:.4f} ms back to back, {cold:.4f} ms L2 flushed; "
              f"{k9_launches} launches a fold_stacked call; plain {plain:.4f} ms; bound "
              f"{k9_bound:.4f} ms ({nbytes} bytes)", flush=True)
        del stacked, joins
    return result


K3_K6_WRAPPERS = ("hll_update", "hll_update_many", "inv_update", "inv_update_pair")


def hll_inv_calls(dev, recs, ident, cfg) -> tuple[list, tuple]:
    """The K3 and K6 calls of the 8th step of a fresh state at ``cfg``, as
    (banks, inv): banks a list of (registers, seed, key_cols, group, mask,
    mask2), inv (regions, key_cols, weights, select), whichever wrappers the
    tree's step calls (an older tree's second mask is None: its step ANDs
    the masks before the call)."""
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.parallel.telemetry import Telemetry

    tel = Telemetry(cfg, device=dev)
    state = tel.init_state()
    for s in range(STEPS - 1):
        state, _ = tel.step(state, recs[s % 2], BATCH, 2, ident)
    calls = capture_calls(lambda: tel.step(state, recs[(STEPS - 1) % 2], BATCH, 2, ident),
                          tuple(n for n in K3_K6_WRAPPERS if hasattr(kops, n)))
    banks, inv = [], []
    for name, _, args, kwargs in calls:
        if name == "hll_update_many":
            banks += [tuple(u) for u in args[0]]
        elif name == "hll_update":
            banks.append((*args, None))
        else:
            inv.append((name, args, kwargs))
    if inv[0][0] == "inv_update_pair":
        (_, args, kwargs), = inv
        regions, cols, w = args[:3]
        return banks, (regions, cols, w, args[3] if len(args) > 3 else kwargs["select"])
    (_, (p0, w0, s0, cols, lo), _), (_, (p1, w1, s1, _, hi), _) = inv
    return banks, ([(p0, w0, s0), (p1, w1, s1)], cols, lo + hi, (hi != 0).to(lo.dtype))


def run_k3(banks) -> None:
    """The banks through the tree's K3 wrappers."""
    from retina_tpu_torch.kernels import ops as kops

    if hasattr(kops, "hll_update_many"):
        kops.hll_update_many(banks)
        return
    for regs, seed, cols, group, mask, mask2 in banks:
        kops.hll_update(regs, seed, cols, group, mask if mask2 is None else mask & mask2)


def run_k6(regions, cols, w, select) -> None:
    """Both regions through the tree's K6 wrappers; an older tree's split of
    the weights by the selector is the step's own torch ops."""
    import torch

    from retina_tpu_torch.kernels import ops as kops

    if hasattr(kops, "inv_update_pair"):
        kops.inv_update_pair(regions, cols, w, select)
        return
    prio = select != 0
    for (planes, weights, seed), x in zip(regions, (torch.where(prio, 0, w),
                                                    torch.where(prio, w, 0))):
        kops.inv_update(planes, weights, seed, cols, x)


def hll_inv(dev, recs, ident) -> dict:
    """K3 and K6 at the step's calls and at the batches that pull them apart."""
    import dataclasses

    import torch

    from retina_tpu_torch.events.synthetic import pod_ip
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import INVERTIBLE_CONFIG
    from retina_tpu_torch.u32 import widen

    report = hll_inv_calls(dev, recs, ident, INVERTIBLE_CONFIG)
    per_row = hll_inv_calls(dev, recs, ident,
                            dataclasses.replace(INVERTIBLE_CONFIG, data_aggregation_level="high"))
    (banks, (regions, cols, w, sel)), (row_banks, (_, row_cols, row_w, _)) = report, per_row

    def one_key(cs):
        return [c[:1].expand(c.shape[0]).contiguous() for c in cs]

    src, dst = (widen(c) for c in cols[:2])
    pmask, match = 0xFFFFFF00, pod_ip(0) & 0xFFFFFF00
    prio = (((src & pmask) == match) | ((dst & pmask) == match)).to(torch.int32)
    zero = torch.zeros_like(w)
    k3 = {"zero": [(r, s, c, g, zero, None) for r, s, c, g, _, _ in banks],
          "report": banks, "per-row": row_banks,
          "one-key": [(r, s, one_key(c), g, m, m2) for r, s, c, g, m, m2 in row_banks]}
    k6 = {"zero": (regions, cols, zero, sel), "report": (regions, cols, w, sel),
          "per-row": (regions, row_cols, row_w, sel),
          "one-key": (regions, one_key(row_cols), row_w, sel),
          "priority": (regions, cols, w, prio)}
    result: dict = {}
    names = {"k3": ("hll_kernel",), "k6": ("inv_kernel", "bin_kernel", "apply_kernel")}
    for kernel, sets, run in (("k3", k3, run_k3), ("k6", k6, run_k6)):
        for name, args in sets.items():
            def once(args=args, run=run):
                return run(*args) if kernel == "k6" else run(args)
            before = sum(kops.launch_counts().values())
            once()
            launches = sum(kops.launch_counts().values()) - before
            ms = cuda_ms(once)
            by_kernel = kernel_ms(once)
            dev_ms = sum(by_kernel.values())
            mine = sum(v for k, v in by_kernel.items() if any(x in k for x in names[kernel]))
            result[f"{kernel}_{name}_ms"] = ms
            result[f"{kernel}_{name}_device_ms"] = dev_ms
            result[f"{kernel}_{name}_kernel_ms"] = mine
            if kernel == "k3":
                what = [int((m != 0).sum() if m2 is None else ((m & m2) != 0).sum())
                        for *_, m, m2 in args]
                what = f"masked rows {what} of {BATCH}"
            else:
                wt = args[2] != 0
                what = (f"weighted rows {int(wt.sum())} of {BATCH}, "
                        f"{int((wt & (args[3] != 0)).sum())} of them to inv_hi")
            print(f"{kernel.upper()} on the {name} batch: {ms:.4f} ms (CUDA events), device time "
                  f"{dev_ms:.4f} ms ({', '.join(f'{k} {v:.4f}' for k, v in by_kernel.items())}); "
                  f"{launches} launches; {what}", flush=True)
    return result


def ingest_wires(dev, bucket: int, slots: int, seed: int = 7) -> dict:
    """One flush's K7 wires at these shapes: packed lanes with unstamped
    rows, saturated spreads (the low word carries) and saturated MISC; a new
    wire whose ids repeat (every 7th row's is 0) and whose last tenth is
    padding; a v4 dense stream and a v3 two-lane wire of ids inside the
    table; a random table. ``known_ids`` are the known rows' ids."""
    import numpy as np

    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.parallel.wire import dense_known_rows, dense_words, known_rows
    from retina_tpu_torch.u32 import from_numpy

    rng = np.random.default_rng(seed)
    id_bits = (slots - 1).bit_length()
    packed = rng.integers(0, 1 << 32, (bucket, 12), dtype=np.uint64).astype(np.uint32)
    packed[::5, 0] = 0
    packed[1::5, 0] = 0xFFFFFFFF
    packed[2::5, 7] = 0xFFFFFFFF
    n_valid = bucket - bucket // 10
    new = np.zeros((bucket, 13), np.uint32)
    new[:n_valid, 1:] = packed[:n_valid]
    new[:n_valid, 0] = rng.integers(0, min(slots, bucket // 2), n_valid)
    new[::7, 0] = 0
    rows = np.zeros((n_valid, 16), np.uint32)
    rows[:, F.PACKETS] = rng.integers(0, 1 << 10, n_valid)
    rows[:, F.BYTES] = rng.integers(0, 1 << 22, n_valid)
    ids = rng.integers(0, slots, n_valid).astype(np.uint32)
    dense = np.zeros(dense_words(bucket, id_bits), np.uint32)
    dense_known_rows(rows, ids, id_bits, dense)
    two = np.zeros((bucket, 2), np.uint32)
    known_rows(rows, ids, np.uint32(id_bits), two[:n_valid])
    table = rng.integers(0, 1 << 32, (slots, 12), dtype=np.uint64).astype(np.uint32)
    return {k: from_numpy(v, dev) for k, v in (
        ("packed", packed), ("new", new), ("dense", dense), ("two", two), ("table", table))} \
        | {"id_bits": id_bits, "known_ids": ids, "bucket": bucket}


def new_claim_wires(seed: int, slots: int = 1 << 18) -> dict:
    """New-side wires (13 random lanes a row, ids inside ``slots``) that pull
    the claims' costs apart, by label as (valid rows, wire): "a third
    padding" (98,304 rows, random ids, the last third zero, as the engine
    pads a bucket: every padding row claims slot 0), "one id" (2^17 rows of
    one id: the hottest claim) and "distinct" and "distinct 98304" (every
    row an id of its own, no padding: the claim's floor)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for label, bucket, n_valid, ids in (
            ("a third padding", 98304, 98304 - 98304 // 3, rng.integers(0, slots, 98304)),
            ("one id", 1 << 17, 1 << 17, np.full(1 << 17, 12345)),
            ("distinct", 1 << 17, 1 << 17, rng.permutation(slots)[: 1 << 17]),
            ("distinct 98304", 98304, 98304, rng.permutation(slots)[:98304])):
        w = rng.integers(0, 1 << 32, (bucket, 13), dtype=np.uint64).astype(np.uint32)
        w[:, 0] = ids
        w[n_valid:] = 0
        out[label] = (n_valid, w)
    return out


def k7_sector_bytes(entry: str, wire, ids, n_out: int) -> int:
    """The bytes of K7's sector bound: each wire byte once and 64 bytes a
    record; on the new side 48 a distinct id's table row and 32 a distinct
    32-byte sector of its claim words (eight 4-byte words a sector); on the
    known side 32 a distinct 32-byte sector of the 48-byte table rows read,
    two a row, a sector shared by neighbouring rows counted once (``ids``:
    the ids inside the table)."""
    import numpy as np

    ids = np.unique(np.asarray(ids, dtype=np.int64))
    if entry == "ingest_new":
        table = ids.size * 48 + np.unique(ids // 8).size * 32
    elif entry == "ingest_known":
        table = np.union1d(ids * 48 // 32, (ids * 48 + 47) // 32).size * 32
    else:
        table = 0
    return wire.numel() * 4 + int(table) + n_out * 64


def capture_feed_calls(dev, cfg, schedule, name: str) -> list:
    """The ``name`` wrapper calls that ``SketchEngine.flush`` makes on the last
    quantum of ``schedule`` (the earlier quanta fill the dictionary), as
    capture_calls returns them: their replay repeats the dispatches' K7 calls
    on the same wires, table and scratch."""
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.synthetic import pod_ip

    eng = SketchEngine(cfg, device=dev)
    eng.update_identities({pod_ip(i): i for i in range(1, 2048)})
    for i, blocks in enumerate(schedule[:-1]):
        eng.flush(blocks, 100 + i)
    calls = capture_calls(lambda: eng.flush(schedule[-1], 100 + len(schedule)), (name,))
    eng.stop()
    return calls


def ingest(dev) -> dict:
    """K7's three entries on the batches of ``--ingest``: device time by
    kernel, the CUDA-event span of one call and their difference (the
    wrapper's host cost), launches, the sector bound, and the known side's
    library call."""
    import numpy as np
    import torch

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.events.synthetic import TrafficGen
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.parallel.wire import dense_known_unpack_plain
    from retina_tpu_torch.u32 import from_numpy

    batches = []  # (label, entry, fn, bytes of the sector bound, library args or None)
    for label, cap, bucket, slots in (("default", 1 << 15, 1 << 17, 1 << 18),
                                      ("bench", 1 << 19, 1 << 18, 1 << 21)):
        x = ingest_wires(dev, bucket, slots)
        n_out = -(-bucket // cap) * cap
        winner = torch.zeros(slots, dtype=torch.int32, device=dev)
        table = x["table"].clone()
        new_ids = x["new"][:, 0].cpu().numpy().view(np.uint32)
        known_ids = x["known_ids"]
        batches += [
            (label, "ingest_packed",
             lambda x=x, n_out=n_out: kops.ingest_packed(x["packed"], True, 0xFFFFFF00, 7, n_out),
             k7_sector_bytes("ingest_packed", x["packed"], [], n_out), None),
            (label, "ingest_new",
             lambda x=x, t=table, w=winner, n_out=n_out:
                 kops.ingest_new(x["new"], t, w, 0xFFFFFF00, 7, n_out),
             k7_sector_bytes("ingest_new", x["new"], new_ids[new_ids < slots], n_out), None),
            (label, "ingest_known",
             lambda x=x, n_out=n_out: kops.ingest_known(x["dense"], x["bucket"], True,
                                                        x["id_bits"], x["table"], 1, 0xFFFFFF00,
                                                        7, n_out),
             k7_sector_bytes("ingest_known", x["dense"], known_ids, n_out),
             (x["table"], torch.from_numpy(known_ids.astype(np.int64)).to(dev), n_out)),
        ]

    # The new side's claims at their floor and at their hottest, and a
    # bucket of ingest path 1's second dispatch a third of which is padding.
    slots = 1 << 18
    table = torch.zeros((slots, 12), dtype=torch.int32, device=dev)
    winner = torch.zeros(slots, dtype=torch.int32, device=dev)
    for label, (_, w) in new_claim_wires(1, slots).items():
        wire = from_numpy(w, dev)
        n_out = -(-w.shape[0] // (1 << 15)) * (1 << 15)
        batches.append((label, "ingest_new",
                        lambda w=wire, n_out=n_out, t=table, c=winner:
                            kops.ingest_new(w, t, c, 5, 0, n_out),
                        k7_sector_bytes("ingest_new", wire, w[:, 0], n_out), None))

    # Ingest path 1's new-side dispatches and ingest path 2's known-side
    # dispatch, captured at the wrappers on bench.py's traffic.
    gen = TrafficGen(n_flows=1_000_000, n_pods=2048, seed=42)
    quanta = [np.split(gen.batch(QUANTUM), QUANTUM // BLOCK) for _ in range(3)]
    for label, cfg, schedule, name in (
            ("path 1", Config(), quanta[:2], "ingest_new"),
            ("path 2 known",
             Config(batch_capacity=1 << 19, feed_coalesce_windows=8, flow_dict_slots=1 << 21),
             quanta + quanta[:1], "ingest_known")):
        for i, (_, fn, args, kwargs) in enumerate(capture_feed_calls(dev, cfg, schedule, name)):
            lib = None
            if name == "ingest_new":
                wire, tbl, _, _, _, n_out = args
                ids = wire[:, 0].cpu().numpy().view(np.uint32)
                what = f"bucket {wire.shape[0]}, {int((ids == 0).sum())} rows with id 0"
                ids = ids[ids < tbl.shape[0]]
            else:
                wire, bucket, _, id_bits, tbl, _, _, _, n_out = args
                kid = dense_known_unpack_plain(wire, bucket, id_bits)[0].clamp(
                    max=tbl.shape[0] - 1)
                ids = kid.cpu().numpy()
                lib = (tbl, kid, n_out)
                what = f"bucket {bucket}, {np.unique(ids).size} distinct ids"
            print(f"{label} dispatch {i}: {what}", flush=True)
            batches.append((f"{label} #{i}", name,
                            lambda fn=fn, args=args, kwargs=kwargs: fn(*args, **kwargs),
                            k7_sector_bytes(name, wire, ids, n_out), lib))
    del quanta

    # Timed back to back, a batch's wire, table and records stay in the 50 MB
    # L2 from one call to the next. The L2-flushed time writes a 128 MiB
    # buffer before each call, as a dispatch meets a wire just copied in and
    # a table last touched a step ago; only the batch's own kernels count.
    l2 = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    result: dict = {}
    for label, entry, fn, nbytes, lib in batches:
        before = kops.launch_counts()[entry]
        fn()
        launches = kops.launch_counts()[entry] - before
        by_kernel = kernel_ms(fn)
        dev_ms = sum(by_kernel.values())
        cold = kernel_ms(lambda fn=fn: (l2.zero_(), fn()))
        cold_ms = sum(v for k, v in cold.items() if k in by_kernel)
        span = cuda_ms(fn)
        bound = nbytes / 3.35e12 * 1e3
        lib_ms = None
        if lib is not None:
            tbl, ids, n_out = lib
            lib_out = torch.zeros((n_out, 16), dtype=torch.int32, device=dev)

            def lib_fn(tbl=tbl, ids=ids, lib_out=lib_out):
                lib_out[: ids.shape[0], :12].copy_(tbl.index_select(0, ids))

            lib_ms = sum(kernel_ms(lib_fn).values())
        key = f"{entry} {label}"
        result[key] = {"device_ms": dev_ms, "flushed_ms": cold_ms, "span_ms": span,
                       "host_ms": span - dev_ms, "bound_ms": bound, "bytes": nbytes,
                       "launches": launches, "library_ms": lib_ms}
        print(f"K7 {key}: device time {dev_ms:.4f} ms "
              f"({', '.join(f'{k} {v:.4f}' for k, v in by_kernel.items())}), L2 flushed "
              f"{cold_ms:.4f} ms; CUDA-event span {span:.4f} ms; host cost "
              f"{span - dev_ms:.4f} ms a call; {launches} launches; sector bound {bound:.4f} ms "
              f"({nbytes} bytes); {dev_ms / bound:.2f}x the bound, {cold_ms / bound:.2f}x "
              "L2 flushed"
              + (f"; index_select + copy {lib_ms:.4f} ms" if lib_ms is not None else ""),
              flush=True)
    return result


def _drain_profiler() -> None:
    """One empty profiling session: the card's activity records that a
    session before it delivered late land here and are dropped."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


def _device_ops(run, reps: int) -> dict[str, tuple[float, float]]:
    """{name: (device ms, launches)} of one ``run()``, from torch.profiler
    over ``reps`` runs, after a drained session. An empty trace is taken
    again, at most four times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out: dict[str, tuple[float, float]] = {}
    for _ in range(4):
        _drain_profiler()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.002)  # the tracer is on before the first run
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                ms, n = out.get(e.key, (0.0, 0.0))
                out[e.key] = (ms + e.self_device_time_total / 1e3 / reps, n + e.count / reps)
        if out:
            break
    return out


def call_names(fn, prep=None, reps: int = 10) -> dict[str, float]:
    """{name: launches a call} of the kernels, copies and fills that a call
    of ``fn`` runs on the card: those of ``reps`` runs of ``prep()`` then
    ``fn()``, less the names that ``prep()`` alone runs."""
    prep_names = set(_device_ops(prep, reps)) if prep is not None else set()

    def both():
        if prep is not None:
            prep()
        fn()

    both()
    return {k: v[1] for k, v in _device_ops(both, reps).items() if k not in prep_names}


def call_profile(fn, prep=None, reps: int = 10, names=None) -> dict[str, tuple[float, float]]:
    """{name: (device ms, launches)} of one call of ``fn``, from
    torch.profiler over ``reps`` calls after 2 warm-ups, each call after
    ``prep()``. Only the kernels, copies and fills named in ``names`` count
    (all, if None), so that ``prep``'s own device work is left out."""
    def once():
        if prep is not None:
            prep()
        fn()

    for _ in range(2):
        once()
    return {k: v for k, v in _device_ops(once, reps).items() if names is None or k in names}


def span_ms(fn, prep=None, reps: int = 10) -> float:
    """The CUDA-event span of one call of ``fn``, each call after ``prep()``
    and synchronised alone (the events bracket ``fn`` only), the mean of
    ``reps`` calls after 2 warm-ups."""
    import torch

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for i in range(reps + 2):
        if prep is not None:
            prep()
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        if i >= 2:
            total += e0.elapsed_time(e1)
    return total / reps


def copied_leaves(state) -> list:
    """The state leaves the scrape's snapshot copies as they are, in the
    flat buffer's order."""
    s = state
    return [s.ct_totals, s.dns_hh.table.counts, s.dns_hh.table.key_rows,
            s.flow_hh.table.counts, s.flow_hh.table.key_rows, s.lat_hist, s.node_counters,
            s.pod_dns, s.pod_drop, s.pod_forward, s.pod_retrans, s.pod_tcpflags,
            s.svc_hh.table.counts, s.svc_hh.table.key_rows, s.totals]


def readout_sector_bytes(state) -> dict[str, int]:
    """The sector bound of the scrape's readout of ``state``: the copied
    leaves read once, the three HLL banks read once, the conntrack keys
    read once and the 32-byte sectors of the value rows of resident slots
    (keys not 0; two 16-byte rows a sector), and the flat buffer written
    once (the copies, an estimate a group, the live count)."""
    s = state
    copied = copied_leaves(s)
    banks = [s.hll_flows.registers, s.hll_src_per_reason.registers,
             s.hll_src_per_pod.registers]
    keys, vals = s.conntrack.keys, s.conntrack.vals
    resident = (keys != 0).any(dim=1)
    n = resident.shape[0]
    sectors = int(resident[: n - n % 2].view(-1, 2).any(dim=1).sum()) + int(
        n % 2 and bool(resident[-1]))
    out = {"copied": sum(t.numel() * 4 for t in copied),
           "hll banks": sum(t.numel() * 4 for t in banks),
           "conntrack keys": keys.numel() * 4,
           "conntrack value sectors": sectors * 32,
           "conntrack value sectors, all slots": vals.numel() * 4}
    out["flat written"] = out["copied"] + 4 * (sum(t.shape[0] for t in banks) + 1)
    out["total"] = (out["copied"] + out["hll banks"] + out["conntrack keys"]
                    + out["conntrack value sectors"] + out["flat written"])
    return out


def readout_inputs(dev, recs, ident) -> dict:
    """The inputs of the readout batches: "state" (DEPLOYED_CONFIG's after
    one window of ``recs``, not closed; "tel" its Telemetry), "counts" (the
    (3, 4096) histograms of K16's batches by label: the state's "close",
    "collapse", "dense" and the (3, 16384) "K max"), "merged" (the
    histogram summed over 32 one-step windows, as a range query reads it),
    "invertible" (INVERTIBLE_CONFIG's Telemetry and state after one window)
    and "empty" (a zero DEPLOYED_CONFIG state)."""
    import numpy as np
    import torch

    from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG, INVERTIBLE_CONFIG
    from retina_tpu_torch.parallel.telemetry import Telemetry

    def window(cfg):
        t = Telemetry(cfg, device=dev)
        st = t.init_state()
        for i in range(STEPS):
            st, _ = t.step(st, recs[i % 2], recs[i % 2].shape[0], 2, ident)
        return t, st

    tel, st = window(DEPLOYED_CONFIG)
    c0 = st.entropy.counts.clone()
    g, k = c0.shape
    t32 = Telemetry(DEPLOYED_CONFIG, device=dev)
    s32 = t32.init_state()
    merged = torch.zeros_like(c0)
    for w in range(32):
        s32, _ = t32.step(s32, recs[w % 2], recs[w % 2].shape[0], 2 + w, ident)
        merged += s32.entropy.counts
        s32, _ = t32.end_window(s32)
    rng = np.random.default_rng(14)
    collapse = torch.zeros_like(c0)
    for j in range(g):
        collapse[j, (977 * j + 5) % k] = float(1 << 20)
    dense = torch.from_numpy(rng.integers(1, 1 << 10, (g, k)).astype(np.float32)).to(dev)
    kmax = torch.from_numpy(rng.integers(1, 1 << 10, (g, 1 << 14)).astype(np.float32)).to(dev)
    return {"tel": tel, "state": st, "merged": merged, "invertible": window(INVERTIBLE_CONFIG),
            "empty": tel.init_state(),
            "counts": {"close": c0, "collapse": collapse, "dense": dense, "K max": kmax}}


def k16_bytes(g: int, k: int, close: bool = True) -> int:
    """K16's sector bound: the (g, k) row read once (and written once by the
    close); mean, var and n_obs read and written, bits, z and a flag byte
    written: 33 bytes a group."""
    return 2 * g * k * 4 + 33 * g if close else g * k * 4 + g * 4


def readout(dev, recs, ident) -> dict:
    """K16 and the scrape's readout (K17 and what surrounds it) on the
    batches of ``--readout``: device time by kernel back to back and with the
    L2 flushed, the launches of a call, the CUDA-event span of a call, the
    host cost, the sector bound; the launch floor; the library call of the
    readout's copies."""
    import torch

    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.parallel.telemetry import Telemetry

    l2 = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    floor = call_profile(lambda: l2[:1].zero_(), reps=50)
    floor = {k: v for k, v in floor.items() if "Fill" in k}
    floor_ms = sum(v[0] for v in floor.values())
    print(f"launch floor (a one-word fill, device time): {floor_ms:.4f} ms", flush=True)
    inp = readout_inputs(dev, recs, ident)
    tel, st, c0 = inp["tel"], inp["state"], inp["counts"]["close"]

    def close_batch(counts):
        """kops.window_close on a copy of ``counts`` restored before each call."""
        c = counts.clone()
        ewma = [torch.zeros(counts.shape[0], device=dev) for _ in range(3)]
        return (lambda: kops.window_close(c, *ewma, 0.1, 4.0, 10)), (lambda: c.copy_(counts))

    batches = [  # (label, fn, prep, bytes)
        ("K16 close", lambda: tel.end_window(st), lambda: st.entropy.counts.copy_(c0),
         k16_bytes(*c0.shape)),
        *((f"K16 {label}", *close_batch(inp["counts"][label]),
           k16_bytes(*inp["counts"][label].shape)) for label in ("collapse", "dense", "K max")),
        ("K16 bits", lambda: kops.entropy_bits(inp["merged"]), None,
         k16_bytes(*c0.shape, close=False)),
    ]
    inv_tel, inv_st = inp["invertible"]
    empty_st = inp["empty"]
    for label, t, s in (("scrape", tel, st), ("empty", tel, empty_st),
                        ("invertible scrape", inv_tel, inv_st)):
        nb = readout_sector_bytes(s)
        print(f"readout bytes ({label}): " + ", ".join(f"{a} {b}" for a, b in nb.items()),
              flush=True)
        batches += [(f"snapshot {label}", lambda t=t, s=s: t.snapshot(s, 3), None, nb["total"]),
                    (f"snapshot_flat_dispatch {label}",
                     lambda t=t, s=s: t.snapshot_flat_dispatch(s, 3), None, nb["total"])]

    result: dict = {"launch_floor_ms": floor_ms}
    for label, fn, prep, nbytes in batches:
        names = call_names(fn, prep)
        launches = round(sum(names.values()), 2)
        warm = call_profile(fn, prep, names=names)
        dev_ms = sum(v[0] for v in warm.values())
        cold = call_profile(fn, (lambda p=prep: (p is not None and p(), l2.zero_())),
                            names=names)
        cold_ms = sum(v[0] for v in cold.values())
        span = span_ms(fn, prep)
        bound = nbytes / 3.35e12 * 1e3
        result[label] = {"device_ms": dev_ms, "flushed_ms": cold_ms, "span_ms": span,
                         "host_ms": span - dev_ms, "bound_ms": bound, "bytes": nbytes,
                         "launches": launches}
        print(f"{label}: device time {dev_ms:.4f} ms back to back, {cold_ms:.4f} ms L2 "
              f"flushed ({', '.join(f'{n[:50]} {v[0]:.4f}' for n, v in cold.items())}); "
              f"{launches} launches a call; CUDA-event span {span:.4f} ms; host cost "
              f"{span - dev_ms:.4f} ms a call; sector bound {bound:.4f} ms ({nbytes} bytes); "
              f"{cold_ms / bound:.2f}x the bound L2 flushed", flush=True)

    # The library call of the readout's copy part: one torch.cat of the
    # copied leaves, by device time.
    flat = [x.reshape(-1) for x in copied_leaves(st)]
    cat = lambda: torch.cat(flat)  # noqa: E731
    names = call_names(cat)
    cat_ms = sum(v[0] for v in call_profile(cat, names=names).values())
    cat_cold = sum(v[0] for v in call_profile(cat, lambda: l2.zero_(), names=names).values())
    result["torch.cat"] = {"device_ms": cat_ms, "flushed_ms": cat_cold}
    print(f"library: torch.cat of the {len(flat)} copied leaves ({sum(x.numel() for x in flat)} "
          f"words): device time {cat_ms:.4f} ms back to back, {cat_cold:.4f} ms L2 flushed",
          flush=True)

    # The designs measured on the way (only in a tree that has their knobs):
    # K16's blocks a group and the readout's bytes a block.
    if hasattr(kops, "ENTROPY_SLICES") and hasattr(kops, "READOUT_BLOCK_BYTES"):
        designs = {}
        for label, fn, prep, _ in batches[:4]:
            for slices in (1, 4, 8, 16, 32, 48):
                saved, kops.ENTROPY_SLICES = kops.ENTROPY_SLICES, slices
                try:
                    names = call_names(fn, prep)
                    ms = sum(v[0] for v in call_profile(
                        fn, (lambda p=prep: (p(), l2.zero_())), names=names).values())
                finally:
                    kops.ENTROPY_SLICES = saved
                designs[f"{label} slices {slices}"] = ms
                print(f"design {label}, {slices} blocks a group: {ms:.4f} ms L2 flushed",
                      flush=True)
        for label, t, s in (("scrape", tel, st), ("empty", tel, empty_st)):
            for per in (4 << 10, 8 << 10, 16 << 10, 32 << 10, 64 << 10):
                saved, kops.READOUT_BLOCK_BYTES = kops.READOUT_BLOCK_BYTES, per
                try:
                    fn = lambda t=t, s=s: t.snapshot_flat_dispatch(s, 3)  # noqa: E731
                    names = call_names(fn)
                    ms = sum(v[0] for v in call_profile(fn, lambda: l2.zero_(),
                                                        names=names).values())
                finally:
                    kops.READOUT_BLOCK_BYTES = saved
                designs[f"readout {label} {per} bytes a block"] = ms
                print(f"design readout {label}, {per} bytes a block: {ms:.4f} ms L2 flushed",
                      flush=True)
        # The readout's parts, each alone in a launch of its own.
        jobs = [job for _, job, _, _ in Telemetry.readout_jobs(st)]
        parts = {"copies": [j for j in jobs if j[0] == "copy"],
                 "hll, a block a group": [j for j in jobs if j[0] == "hll"
                                          and j[1].shape[1] > 128],
                 "hll, lanes a group": [j for j in jobs if j[0] == "hll"
                                        and j[1].shape[1] <= 128],
                 "live": [j for j in jobs if j[0] == "live"]}
        for part, sub in parts.items():
            fn = lambda sub=sub: kops.snapshot_flat(sub, 3)  # noqa: E731
            names = call_names(fn)
            warm = sum(v[0] for v in call_profile(fn, names=names).values())
            cold = sum(v[0] for v in call_profile(fn, lambda: l2.zero_(), names=names).values())
            designs[f"readout part {part}"] = [warm, cold]
            print(f"design readout scrape, {part} alone: {warm:.4f} ms back to back, "
                  f"{cold:.4f} ms L2 flushed", flush=True)
        result["designs"] = designs
    return result


def detect_query_inputs(dev, recs, ident) -> dict:
    """The inputs of ``--detect-query``: K11's (keys, weights) by label, and
    INVERTIBLE_CONFIG's Telemetry and state after one window of ``recs``
    ("tel", "state") with the regions' decodes ("decoded": (cols, ok) of
    inv_flow and inv_hi), the union's table, seed and (R, 4) rows."""
    import numpy as np

    from retina_tpu_torch.detect import features
    from retina_tpu_torch.events.schema import F
    from retina_tpu_torch.events.synthetic import TrafficGen, preset_params
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import INVERTIBLE_CONFIG
    from retina_tpu_torch.parallel.telemetry import Telemetry
    from retina_tpu_torch.u32 import from_numpy

    def gen(seed=42, **kw):
        return TrafficGen(n_flows=1_000_000, n_pods=2048, seed=seed, **kw)

    scan = gen(**preset_params("portscan"))
    sweep = np.concatenate([gen(seed=43).batch(1 << 15),
                            gen(seed=44).portscan_batch(1 << 15, n_scanners=4, n_ports=24)])
    one = scan.batch(1 << 16)
    one[:, F.SRC_IP] = 0x0A000001
    k11 = {}
    for label, rows in (("2^16", scan.batch(1 << 16)), ("padded 64", scan.batch(40)),
                        ("one group", one), ("sweep", sweep)):
        keys, w = features.padded_flow_keys(rows)
        k11[label] = (from_numpy(keys, dev), from_numpy(w, dev))
    tel = Telemetry(INVERTIBLE_CONFIG, device=dev)
    st = tel.init_state()
    for i in range(STEPS):
        st, _ = tel.step(st, recs[i % 2], recs[i % 2].shape[0], 2, ident)
    decoded = [kops.inv_decode(inv.planes, inv.weights, inv.seed, inv.n_key_cols)
               for inv in (st.inv_flow, st.inv_hi)]
    rng = np.random.default_rng(15)
    rows = from_numpy(rng.integers(0, 1 << 32, (262_144, 4), dtype=np.uint64)
                      .astype(np.uint32), dev)
    table = from_numpy(rng.integers(0, 1 << 12, (4, 1 << 15)).astype(np.uint32), dev)
    return {"k11": k11, "tel": tel, "state": st, "decoded": decoded, "union": rows[:131_072],
            "rows": rows, "table": table, "sweep": sweep}


def fleet_and_range(dev) -> dict:
    """The warm 64-node merge and the warm 32-window range query, host ms
    around calls synchronised alone, as chip_smoke.py's fleet and time-travel
    paths run them (64 engines' closes of 2^18 events of TrafficGen(seed=i)
    into FleetAggregator; 34 windows of one 2^21-event quantum each into the
    engine's ring, then QueryService._query over the newest 32)."""
    import numpy as np
    import torch

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.engine import SketchEngine
    from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip
    from retina_tpu_torch.fleet.aggregator import FleetAggregator
    from retina_tpu_torch.fleet.codec import FleetSnapshot, encode_snapshot
    from retina_tpu_torch.timetravel.fold import host_arrays
    from retina_tpu_torch.timetravel.query import QueryService

    pods = {pod_ip(i): i for i in range(1, 2048)}

    def synced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    eng = SketchEngine(Config(heavy_keys_source="invertible", fleet_enabled=True), device=dev)
    eng.update_identities(pods)
    frames = []
    for i in range(64):
        eng.states = eng._proxy.run(eng.telemetry.init_state)
        eng.flush(np.split(TrafficGen(n_flows=1_000_000, n_pods=2048, seed=i).batch(1 << 18),
                           32), 500)
        epoch, arrays, window_s, seeds = eng.close_window(epoch=7)["export"]
        frames.append(encode_snapshot(FleetSnapshot(
            node=f"node-{i:02d}", tenant="tenant-a" if i < 32 else "tenant-b",
            priority=int(i < 32), epoch=epoch, seq=1, window_s=window_s, seeds=seeds,
            arrays=host_arrays(arrays))))
    eng.stop()
    acfg = Config(fleet_expected_nodes=64)

    def merge():
        agg = FleetAggregator(acfg, device=dev)
        for f in frames:
            agg.ingest(f)
        assert agg.epochs_merged == 1

    merge_ms = [synced_ms(merge) for _ in range(3)][1:]
    gen = TrafficGen(n_flows=1_000_000, n_pods=2048, seed=42)
    quanta = [np.split(gen.batch(1 << 21), 256) for _ in range(3)]
    tcfg = Config(heavy_keys_source="invertible", timetravel_enabled=True)
    eng = SketchEngine(tcfg, device=dev)
    eng.update_identities(pods)
    for i in range(34):
        eng.flush(quanta[i % 3], 300 + i)
        eng.close_window(epoch=i)
        eng.timetravel_ring.drain(60.0)
    svc = QueryService(tcfg, device=dev)
    svc.add_ring(eng.timetravel_ring)
    query_ms = [synced_ms(lambda: svc._query(eng.timetravel_ring, 2, 34, 32, "flow"))
                for _ in range(3)][1:]
    eng.stop()
    print(f"fleet merge of 64 frames (warm): {', '.join(f'{x:.3f}' for x in merge_ms)} ms; "
          f"32-window range query (warm): {', '.join(f'{x:.3f}' for x in query_ms)} ms",
          flush=True)
    return {"merge_64_ms": merge_ms, "query_32_ms": query_ms}


# The CUDA runtime calls that make the host wait for the card.
HOST_SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy")


def close_counts(close, reps: int = 10) -> dict:
    """A close's work on the card and the host's waits for it, from
    torch.profiler over ``reps`` calls of ``close()`` (each observes a window
    and flushes it): {"launches": kernels, copies and fills a close on the
    card, "host_syncs": HOST_SYNCS calls a close, "device_ms": device time a
    close, "by_name": {name: (device ms, launches) a close}}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    close()
    for _ in range(4):
        _drain_profiler()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.002)  # the tracer is on before the first close
            for _ in range(reps):
                close()
        by_name, syncs = {}, 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                by_name[e.key] = (e.self_device_time_total / 1e3 / reps, e.count / reps)
            elif e.key in HOST_SYNCS:
                syncs += e.count
        if by_name:
            break
    return {"launches": sum(v[1] for v in by_name.values()), "host_syncs": syncs / reps,
            "device_ms": sum(v[0] for v in by_name.values()), "by_name": by_name}


def bank_close(dev, sweep) -> dict:
    """The detector bank's close of one window (``sweep``, 2^16 rows): ms
    of the whole close (the card synchronised before and after); its
    launches, host syncs and device time by kernel (``close_counts``); then
    the close split by stage, each stage synchronised: the portscan feature
    build (``padded_flow_keys``, host), the copies to the card
    (``from_numpy``), K11, and the scores and EWMA (``kops.bank_close``);
    the rest is the host's judging, arbitration and metrics."""
    import torch

    from retina_tpu_torch.config import Config
    from retina_tpu_torch.detect import build_default_bank, detectors, features, programs
    from retina_tpu_torch.kernels import ops as kops

    def close_ms(bank, epoch) -> float:
        """Observe one window, then close it (``flush``: the next observe
        starts a window of its own)."""
        bank.observe(epoch, sweep, now_s=float(epoch))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bank.flush(now_s=float(epoch))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    bank = build_default_bank(Config(), device=dev)
    whole = [close_ms(bank, e) for e in range(12)]
    whole = whole[2:]
    epoch = [100]

    def one_close():
        bank.observe(epoch[0], sweep, now_s=float(epoch[0]))
        bank.flush(now_s=float(epoch[0]))
        epoch[0] += 1

    counts = close_counts(one_close)
    stage_of = [(features, "padded_flow_keys", "features"), (detectors, "from_numpy", "copies"),
                (programs, "portscan_program", "K11"), (kops, "bank_close", "scores and EWMA")]
    stages = {stage: 0.0 for _, _, stage in stage_of}
    saved = []

    def timed(obj, name, stage):
        fn = getattr(obj, name)
        saved.append((obj, name, fn))

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[stage] += time.perf_counter() - t0
            return out

        setattr(obj, name, wrapper)

    for obj, name, stage in stage_of:
        timed(obj, name, stage)
    try:
        split = [close_ms(bank, e) for e in range(12, 22)]
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)
    n = len(split)
    out = {k: v * 1e3 / n for k, v in stages.items()}
    out["rest"] = sum(split) / n - sum(out.values())
    out["whole_ms"] = whole
    out["whole_instrumented_ms"] = sum(split) / n
    out |= {k: counts[k] for k in ("launches", "host_syncs", "device_ms")}
    print(f"bank close (sweep window, {len(sweep)} rows): "
          f"{', '.join(f'{x:.3f}' for x in whole)} ms; {counts['launches']:.1f} launches "
          f"(kernels, copies, fills), {counts['host_syncs']:.1f} host syncs "
          f"({'/'.join(HOST_SYNCS)}), device time {counts['device_ms']:.4f} ms a close ("
          + ", ".join(f"{k[:40]} {v[1]:.0f}x {v[0]:.4f}" for k, v in counts["by_name"].items())
          + f"); instrumented {out['whole_instrumented_ms']:.3f} ms = "
          + ", ".join(f"{k} {out[k]:.3f}" for k in (*stages, "rest")), flush=True)
    return out


def bank_close_kernel(dev, sweep, measure, l2) -> dict:
    """The bank's close kernel alone on the sweep window's features (its
    histogram, lanes and K11's estimates, made beforehand), a close of the
    three built-ins from a warm state: device time back to back and L2
    flushed (``measure``), and the host's wall time of a call (the
    wrapper waits for its rows), the mean of 200 after 20."""
    import torch

    from retina_tpu_torch.detect import features, programs
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.u32 import from_numpy

    hist = features.qname_length_hist(sweep)
    lanes = features.tcpflag_lanes(sweep)
    keys, w = features.padded_flow_keys(sweep)
    est = programs.portscan_program(from_numpy(keys, dev), from_numpy(w, dev))
    slots = [(kops.BANK_DNSTUNNEL, hist, 8.0, 3, 0.1), (kops.BANK_PORTSCAN, est, 8.0, 3, 0.1),
             (kops.BANK_SYNFLOOD, lanes, 8.0, 3, 0.1)]
    # The features and the state read once, the state and rows written once.
    nbytes = 4 * (hist.size + lanes.size + est.numel()) + 2 * 3 * 3 * 4 + 3 * kops.BANK_ROW * 4
    out = {}
    io = kops.BankCloseIO(dev, 3)
    state = [torch.zeros(3, device=dev) for _ in range(3)]
    fn = lambda: kops.bank_close(slots, *state, io=io)  # noqa: E731
    label = "bank close"
    measure(label, fn, None, nbytes)
    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    out[label] = (time.perf_counter() - t0) / 200 * 1e3
    print(f"{label}: host wall time of a call {out[label]:.4f} ms", flush=True)
    p = torch.from_numpy(hist).to(dev) / float(hist.sum())
    lib = lambda: torch.special.entr(p).sum()  # noqa: E731
    names = call_names(lib)
    out["library"] = sum(v[0] for v in call_profile(lib, names=names).values())
    out["library_flushed"] = sum(v[0] for v in call_profile(
        lib, lambda: l2.zero_(), names=names).values())
    print(f"library: torch.special.entr + sum on p computed beforehand, device time "
          f"{out['library']:.4f} ms back to back, {out['library_flushed']:.4f} ms L2 flushed",
          flush=True)
    return out


def detect_query(dev, recs, ident) -> dict:
    """K11, K15 and K10 on the batches of ``--detect-query``: device time by
    kernel back to back and with the L2 flushed, launches and span of a call,
    the sector bound; the library call; the end-to-end stages."""
    import torch

    from retina_tpu_torch.detect import programs
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.ops.countmin import indices
    from retina_tpu_torch.u32 import narrow

    l2 = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    floor = call_profile(lambda: l2[:1].zero_(), reps=50)
    floor_ms = sum(v[0] for k, v in floor.items() if "Fill" in k)
    print(f"launch floor (a one-word fill, device time): {floor_ms:.4f} ms", flush=True)
    inp = detect_query_inputs(dev, recs, ident)
    tel, st = inp["tel"], inp["state"]
    cms = st.flow_hh.cms
    regions = [(list(c), ok) for c, ok in inp["decoded"]]

    def verify(min_weight=0):
        """The verify of both regions after their decode: one launch of the
        many-job query, or, in an older tree, decode_verified's query and
        filter a region."""
        if hasattr(kops, "cms_query_many"):
            return kops.cms_query_many([(cms.table, cms.seed, c, ok, min_weight)
                                        for c, ok in regions])
        out = []
        for c, ok in regions:
            est = cms.query(c)
            ok = ok & (est >= min_weight)
            out.append((narrow(torch.where(ok, est, 0)), ok))
        return out

    invs = (st.inv_flow, st.inv_hi)

    def decode():
        """Both regions' decode: one launch of the many-region entry, or, in
        an older tree, one ``inv_decode`` call a region."""
        if hasattr(kops, "inv_decode_many"):
            return kops.inv_decode_many([(inv.planes, inv.weights, inv.seed, t)
                                         for t, inv in enumerate(invs)])
        return [kops.inv_decode(inv.planes, inv.weights, inv.seed, inv.n_key_cols)
                for inv in invs]

    union = inp["union"]
    ucols = [union[:, j] for j in range(4)]
    one = [union[:1, j] for j in range(4)]
    table = inp["table"]
    r_close = sum(ok.shape[0] for _, ok in regions)
    batches = [(f"K11 {label}", lambda k=k, w=w: programs.portscan_program(k, w), None,
                k.shape[0] * 20 + programs.PORTSCAN_GROUPS * 4)
               for label, (k, w) in inp["k11"].items()]
    # K15: planes and weights read once; key words, ok and tier written once.
    batches.append(("K15 close (both regions)", decode, None, sum(
        4 * (inv.planes.numel() + inv.weights.numel())
        + inv.weights.numel() * (4 * inv.n_key_cols + 1 + 4) for inv in invs)))
    batches += [  # key words and masks read once, answers written once, the table's
        # words gathered at most once
        ("K10 close (both regions)", verify, None, r_close * (16 + 1 + 4 + 1)
         + 4 * min(cms.table.numel(), 4 * r_close)),
        ("K10 union", lambda: kops.cms_query(table, 7, ucols), None,
         union.shape[0] * (16 + 4) + 4 * min(table.numel(), 4 * union.shape[0])),
        ("K10 1 row", lambda: kops.cms_query(table, 7, one), None, 16 + 4 + 16),
    ]
    for r in (65_536, 262_144):  # either side of the union: where the depth loop's form changes
        cols_r = [inp["rows"][:r, j] for j in range(4)]
        batches.append((f"K10 {r} rows", lambda c=cols_r: kops.cms_query(table, 7, c), None,
                        r * (16 + 4) + 4 * min(table.numel(), 4 * r)))
    result: dict = {"launch_floor_ms": floor_ms}

    def measure(label, fn, prep, nbytes, names=None):
        names = names or call_names(fn, prep)
        launches = round(sum(names.values()), 2)
        warm = call_profile(fn, prep, names=names)
        cold = call_profile(fn, (lambda p=prep: (p is not None and p(), l2.zero_())),
                            names=names)
        dev_ms = sum(v[0] for v in warm.values())
        cold_ms = sum(v[0] for v in cold.values())
        kern = {"K11": "portscan", "K10": "query_kernel", "K15": "decode_kernel",
                "ban": "bank_close_kernel"}.get(label[:3])
        k_warm = sum(v[0] for k, v in warm.items() if kern and kern in k)
        k_cold = sum(v[0] for k, v in cold.items() if kern and kern in k)
        span = span_ms(fn, prep)
        bound = nbytes / 3.35e12 * 1e3
        result[label] = {"device_ms": dev_ms, "flushed_ms": cold_ms, "kernel_ms": k_warm,
                         "kernel_flushed_ms": k_cold, "span_ms": span, "bound_ms": bound,
                         "bytes": nbytes, "launches": launches}
        print(f"{label}: device time {dev_ms:.4f} ms back to back, {cold_ms:.4f} ms L2 "
              f"flushed (the kernel {k_warm:.4f}, {k_cold:.4f}; "
              f"{', '.join(f'{n[:40]} {v[0]:.4f}' for n, v in cold.items())}); {launches} "
              f"launches a call; CUDA-event span {span:.4f} ms; sector bound {bound:.4f} ms "
              f"({nbytes} bytes)", flush=True)

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3.0:  # the clocks up before the first reading
        for _ in range(50):
            l2.zero_()
        torch.cuda.synchronize()
    for label, fn, prep, nbytes in batches:
        measure(label, fn, prep, nbytes)
    # The library call: torch.gather + amin on indices computed beforehand.
    for label, cols_, tab in (("union", ucols, table),
                              ("close", [torch.cat([c[j] for c, _ in regions])
                                         for j in range(4)], cms.table)):
        idx = indices(tab, 7, cols_)

        def lib(idx=idx, tab=tab):
            return torch.gather(tab, 1, idx).amin(dim=0)

        names = call_names(lib)
        warm = sum(v[0] for v in call_profile(lib, names=names).values())
        cold = sum(v[0] for v in call_profile(lib, lambda: l2.zero_(), names=names).values())
        result[f"library K10 {label}"] = {"device_ms": warm, "flushed_ms": cold}
        print(f"library: torch.gather + amin at the {label} ({idx.shape[1]} rows): device "
              f"time {warm:.4f} ms back to back, {cold:.4f} ms L2 flushed", flush=True)

    result["bank_close_kernel"] = bank_close_kernel(dev, inp["sweep"], measure, l2)
    # End to end: a close's inv_decode, the bank's close, the merge and query.
    dec = lambda: tel.inv_decode(st)  # noqa: E731
    names = call_names(dec)
    warm = call_profile(dec, names=names)
    result["inv_decode"] = {"device_ms": sum(v[0] for v in warm.values()),
                            "launches": round(sum(names.values()), 2),
                            "span_ms": span_ms(dec)}
    print(f"Telemetry.inv_decode: {result['inv_decode']['launches']} launches, device time "
          f"{result['inv_decode']['device_ms']:.4f} ms, span {result['inv_decode']['span_ms']:.4f}"
          f" ms ({', '.join(f'{n[:40]} {v[1]:.0f}x {v[0]:.4f}' for n, v in warm.items())})",
          flush=True)
    result["bank_close"] = bank_close(dev, inp["sweep"])
    result |= fleet_and_range(dev)
    return result


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
    ap.add_argument("--config", choices=["deployed", "no-conntrack", "production", "invertible"],
                    default="deployed", help="the configuration of the profiled step")
    ap.add_argument("--sketches", action="store_true",
                    help="time K2 and K4 at both weight sets and the step paths' ms/step")
    ap.add_argument("--fold", action="store_true",
                    help="time K8 at a range query's and a fleet epoch's shapes")
    ap.add_argument("--conntrack", action="store_true",
                    help="time K5 at the deployed step's calls and at batches that separate "
                    "its costs")
    ap.add_argument("--rows", action="store_true",
                    help="time K1 at the deployed step's call and at batches that separate "
                    "its costs")
    ap.add_argument("--ingest", action="store_true",
                    help="time K7's three entries by device time and CUDA events on the "
                    "default-flush, bench and feed-path batches")
    ap.add_argument("--readout", action="store_true",
                    help="time K16 and the scrape's readout (K17) by device time and CUDA "
                    "events, back to back and with the L2 flushed")
    ap.add_argument("--detect-query", action="store_true",
                    help="time K11 and K10 by device time, back to back and with the L2 "
                    "flushed, and the close, merge and query around them")
    ap.add_argument("--hll-inv", action="store_true",
                    help="time K3 and K6 at the invertible step's calls and at batches that "
                    "separate their costs")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip
    from retina_tpu_torch.models.identity import IdentityMap
    from retina_tpu_torch.kernels import ops as kops
    from retina_tpu_torch.models.pipeline import (
        DEPLOYED_CONFIG,
        INVERTIBLE_CONFIG,
        NO_CONNTRACK_CONFIG,
        PipelineConfig,
    )
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
    if args.fold:
        print(json.dumps(fold(dev) | {"device": torch.cuda.get_device_name(0)}))
        return 0
    if args.ingest:
        print(json.dumps(ingest(dev) | {"device": torch.cuda.get_device_name(0)}))
        return 0
    gen = TrafficGen(n_flows=1_000_000, n_pods=2048, seed=42)
    recs = [from_numpy(gen.batch(BATCH), dev) for _ in range(2)]
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, 2048)}, n_slots=1 << 16,
                                   device=dev)
    if args.sketches:
        print(json.dumps(sketches(dev, recs, ident) | {"device": torch.cuda.get_device_name(0)}))
        return 0
    if args.conntrack:
        print(json.dumps(conntrack(dev, recs, ident) | {"device": torch.cuda.get_device_name(0)}))
        return 0
    if args.rows:
        print(json.dumps(rows_profile(dev, recs, ident) | {"device": torch.cuda.get_device_name(0)}))
        return 0
    if args.readout:
        print(json.dumps(readout(dev, recs, ident) | {"device": torch.cuda.get_device_name(0)}))
        return 0
    if args.hll_inv:
        print(json.dumps(hll_inv(dev, recs, ident) | {"device": torch.cuda.get_device_name(0)}))
        return 0
    if args.detect_query:
        print(json.dumps(detect_query(dev, recs, ident)
                         | {"device": torch.cuda.get_device_name(0)}))
        return 0
    cfg = {"deployed": DEPLOYED_CONFIG, "no-conntrack": NO_CONNTRACK_CONFIG,
           "production": PipelineConfig(), "invertible": INVERTIBLE_CONFIG}[args.config]
    print(f"config: {args.config}")
    tel = Telemetry(cfg, device=dev)
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

    # The step's K1 and K14 calls, replayed: K14's kernels by device time,
    # its plain version by CUDA events.
    calls = capture_calls(lambda: tel.step(state, recs[0], BATCH, 2, ident),
                          ("step_rows", "latency_update"))
    by_kernel = kernel_ms(lambda: replay_calls(calls))
    k14_ms = sum(v for k, v in by_kernel.items() if "step_rows" not in k)
    lat_calls = [c for c in calls if c[0] == "latency_update"]
    with kops.plain_versions():
        plain_ms = cuda_ms(lambda: replay_calls(lat_calls))
    print(f"K1 + K14 replayed: {', '.join(f'{k} {v:.4f}' for k, v in by_kernel.items())} ms "
          f"(device time); the latency match's kernels {k14_ms:.4f} ms, its plain version "
          f"(torch ops) {plain_ms:.4f} ms")

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
