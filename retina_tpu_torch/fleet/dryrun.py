"""Multi-agent fleet rollup dryrun (port of retina_tpu/fleet/dryrun.py).

Simulates N node agents in one process: each agent thread builds real
sketches (``ops/``: ``HeavyHitterSketch``, ``HyperLogLog``,
``EntropyWindow``, on a card K2, K3 and K4), ships real RFLT frames through
a real :class:`SnapshotShipper` over the in-process pubsub bus to one
subscribed :class:`FleetAggregator`, which merges each epoch on its device:
the full wire path minus the engines and the gRPC hop. Exact per-flow
ground-truth counts ride alongside, so the run scores cluster top-k recall
against the exact merged counts of the nodes each rollup actually merged.

One agent is killed mid-run (``kill_after``): epochs after the kill must
still close through the straggler timeout, never blocking on the dead node.

:func:`run_invertible_dryrun` is the key-recovery variant: nodes ship only
counter arrays (the flow CMS and the invertible bit planes, K6 on a card;
no candidate key tables), the aggregator decodes cluster-wide heavy keys
from the merged sketch state (K15, K10), and the scorecard checks recall
>= 0.95 against exact ground truth, including under a forced SHEDDING
episode where background flows are 1-in-k sampled with Horvitz-Thompson
rescale while priority-class flows ride the never-sampled region and must
keep recall 1.0.

Every sketch build and the aggregator run on ``device`` (the card unless
the caller names another).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import Counter
from typing import Any, Callable

import numpy as np
import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.config import Config
from retina_tpu_torch.fleet.aggregator import FleetAggregator
from retina_tpu_torch.fleet.shipper import SnapshotShipper
from retina_tpu_torch.obs.recorder import get_recorder
from retina_tpu_torch.ops.countmin import CountMinSketch
from retina_tpu_torch.ops.entropy import EntropyWindow
from retina_tpu_torch.ops.hyperloglog import HyperLogLog
from retina_tpu_torch.ops.invertible import InvertibleSketch
from retina_tpu_torch.ops.topk import HeavyHitterSketch
from retina_tpu_torch.u32 import from_numpy, to_numpy
from retina_tpu_torch.utils import metric_names as mn

# Sketch shapes of the simulated agents: small enough that 8+ agents build
# a window in milliseconds, wide enough that CMS noise stays far below the
# heavy/light weight separation.
_SLOTS = 1 << 10
_WIDTH = 1 << 12
_DEPTH = 4
_PODS = 16

SEEDS = {
    "flow": 1, "svc": 2, "dns": 3,
    "hll_flows": 4, "hll_src_per_pod": 6, "entropy": 7,
}

# The invertible dryrun's shapes and seeds (the engine's inv_flow/inv_hi
# region split, small enough to build a window in milliseconds).
INV_SEEDS = dict(SEEDS, inv_flow=9, inv_hi=10)
_INV_DEPTH = 2
_INV_WIDTH = 1 << 9
_INV_HI_WIDTH = 1 << 7


def _u32(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Non-negative integers (< 2^32) as u32 bits on ``device``."""
    return from_numpy(np.asarray(x).astype(np.uint32), device)


def _sketch_arrays(keys: np.ndarray, w: np.ndarray,
                   device: torch.device | str | None = None) -> dict[str, np.ndarray]:
    """One node-window's wire arrays from (B, 4) uint32 keys and integer
    weights: the array catalog of the engine's fleet export."""
    dev = resolve_device(device)
    b = keys.shape[0]
    kt = _u32(keys, dev)
    cols = [kt[:, i].contiguous() for i in range(4)]
    wv = _u32(w, dev)
    ones = torch.ones((b,), dtype=torch.int32, device=dev)
    g0 = torch.zeros((b,), dtype=torch.int32, device=dev)
    flow = HeavyHitterSketch.zeros(4, depth=_DEPTH, width=_WIDTH, n_slots=_SLOTS,
                                   seed=SEEDS["flow"], device=dev).update(cols, wv)
    svc = HeavyHitterSketch.zeros(2, depth=_DEPTH, width=_WIDTH, n_slots=_SLOTS,
                                  seed=SEEDS["svc"], device=dev).update(cols[:2], wv)
    dns = HeavyHitterSketch.zeros(1, depth=_DEPTH, width=_WIDTH, n_slots=_SLOTS,
                                  seed=SEEDS["dns"], device=dev).update([cols[3]], wv)
    hllf = HyperLogLog.zeros(1, 10, seed=SEEDS["hll_flows"], device=dev).update(cols, g0, ones)
    pods = _u32(keys[:, 1] % np.uint32(_PODS), dev)
    hllp = HyperLogLog.zeros(_PODS, 6, seed=SEEDS["hll_src_per_pod"], device=dev).update(
        [cols[0]], pods, ones)
    # Group g hashes its own column: src IP, dst IP, dst port.
    ent = EntropyWindow.zeros(3, 1 << 10, seed=SEEDS["entropy"], device=dev).update(
        [cols[0], cols[1], cols[3]], wv)
    totals = np.zeros(8, np.uint32)
    totals[0] = np.uint32(min(int(w.sum()), 0xFFFFFFFF))
    return {
        "flow_cms": to_numpy(flow.cms.table),
        "flow_keys": to_numpy(flow.table.key_rows),
        "flow_counts": to_numpy(flow.table.counts),
        "svc_cms": to_numpy(svc.cms.table),
        "svc_keys": to_numpy(svc.table.key_rows),
        "svc_counts": to_numpy(svc.table.counts),
        "dns_cms": to_numpy(dns.cms.table),
        "dns_keys": to_numpy(dns.table.key_rows),
        "dns_counts": to_numpy(dns.table.counts),
        "hll_flows": to_numpy(hllf.registers),
        "hll_src_per_pod": to_numpy(hllp.registers),
        "entropy": to_numpy(ent.counts),
        "totals": totals,
    }


def run_dryrun(
    nodes: int = 8,
    epochs: int = 5,
    kill_after: int = 2,
    heavy_flows: int = 40,
    light_flows: int = 192,
    seed: int = 0,
    straggler_timeout_s: float | None = None,
    log: Callable[[str], None] = lambda s: None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Run the simulation; returns the scorecard dict (see the module doc).

    ``kill_after``: the last agent stops shipping after this many epochs;
    epochs 0..kill_after-1 close on full quorum. ``straggler_timeout_s``
    defaults to 0.1 s a node (at least 1 s): the per-node sketch builds
    share one process, so epoch-0 arrivals spread out with the fleet."""
    assert nodes >= 2 and epochs >= 1
    dev = resolve_device(device)
    if straggler_timeout_s is None:
        straggler_timeout_s = max(1.0, 0.1 * nodes)
    rng = np.random.default_rng(seed)
    base = Config(
        fleet_enabled=True,
        fleet_aggregator=True,
        fleet_expected_nodes=nodes,
        fleet_straggler_timeout_s=straggler_timeout_s,
        fleet_topk_k=32,
        fleet_max_tenants=4,
        fleet_tenant_series_max=8,
    )
    k = base.fleet_topk_k
    agg = FleetAggregator(base, device=dev)
    agg.start(subscribe=True)

    # Global heavy flows: every node carries a share every epoch, so the
    # cluster totals exist on no single node.
    heavy = rng.integers(0, 2**32, size=(heavy_flows, 4), dtype=np.uint32)
    victim = nodes - 1
    exact_lock = threading.Lock()
    # (epoch, node) -> Counter of the exact per-flow weights shipped.
    exact: dict[tuple[int, str], Counter] = {}

    shippers: list[SnapshotShipper] = []
    for i in range(nodes):
        cfg_i = dataclasses.replace(base, fleet_node_name=f"sim{i:02d}",
                                    fleet_tenant=f"tenant{i % 4}", fleet_priority=i % 4)
        s = SnapshotShipper(cfg_i)
        s.start()
        shippers.append(s)

    # A first build at the real batch shape before pacing starts (the
    # kernels' first launches load their libraries).
    _sketch_arrays(np.zeros((heavy_flows + light_flows, 4), np.uint32),
                   np.ones(heavy_flows + light_flows), dev)

    epoch_interval = 0.25
    t0 = time.monotonic()

    def agent(i: int) -> None:
        node_rng = np.random.default_rng(seed * 1000 + i)
        ship = shippers[i]
        for e in range(epochs):
            if i == victim and e >= kill_after:
                return  # killed mid-run: stops shipping, no goodbye
            # Agents on a shared epoch cadence (NTP-close clocks).
            wait = t0 + e * epoch_interval - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            hw = node_rng.integers(100, 200, size=heavy_flows)
            lkeys = node_rng.integers(0, 2**32, size=(light_flows, 4), dtype=np.uint32)
            lw = node_rng.integers(1, 4, size=light_flows)
            keys = np.concatenate([heavy, lkeys])
            w = np.concatenate([hw, lw]).astype(np.float64)
            arrays = _sketch_arrays(keys, w, dev)
            c = Counter()
            for row, wt in zip(keys, w):
                c[tuple(int(x) for x in row)] += int(wt)
            with exact_lock:
                exact[(e, ship.node)] = c
            ship.offer(e, arrays, 15.0, dict(SEEDS))

    threads = [threading.Thread(target=agent, args=(i,), name=f"fleet-sim{i}")
               for i in range(nodes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # Let the straggler timeout close the post-kill epochs; the loop exits
    # as soon as every epoch is merged.
    deadline = time.monotonic() + straggler_timeout_s * 4 + 60.0 + 2.0 * nodes
    while agg.epochs_merged < epochs and time.monotonic() < deadline:
        time.sleep(0.05)
    for s in shippers:
        s.stop()
    agg.stop()

    # -- scorecard ------------------------------------------------------------
    rollups = list(agg.rollups)
    recalls: dict[int, float] = {}
    top_err: dict[int, float] = {}
    for r in rollups:
        e = r["epoch"]
        merged_exact: Counter = Counter()
        for node in r["nodes"]:
            merged_exact.update(exact.get((e, node), Counter()))
        if not merged_exact:
            continue
        exact_top = [kk for kk, _ in merged_exact.most_common(k)]
        keys_arr, counts_arr = r["top_flow"]
        got = {tuple(int(x) for x in row) for row in keys_arr}
        recalls[e] = sum(1 for kk in exact_top if kk in got) / len(exact_top)
        # Count accuracy on the true heaviest flow (CMS may overestimate,
        # never under): relative error of the reported cluster count.
        kk = exact_top[0]
        for row, cnt in zip(keys_arr, counts_arr):
            if tuple(int(x) for x in row) == kk:
                top_err[e] = abs(float(cnt) - merged_exact[kk]) / max(merged_exact[kk], 1)
                break
    recall = min(recalls.values()) if recalls else 0.0
    tenants_seen = max((len(r["tenants"]) for r in rollups), default=0)
    series_obs = max((len(tr["top_flows"][0]) for r in rollups for tr in r["tenants"].values()),
                     default=0)
    bound = min(base.fleet_topk_k, base.fleet_tenant_series_max)
    straggled = sum(1 for r in rollups if r.get("straggled"))
    post_kill = [r for r in rollups if r["epoch"] >= kill_after]
    # Span lineage across the wire: the shipper's send span and the
    # aggregator's merge span of one window share its epoch as trace ID.
    spans = get_recorder().spans()
    ship_tids = {s["trace_id"] for s in spans if s["stage"] == mn.STAGE_SHIP_SEND}
    merge_tids = {s["trace_id"] for s in spans if s["stage"] == mn.STAGE_AGG_MERGE}
    merged_epochs = {r["epoch"] for r in rollups}
    lineage_ok = bool(merged_epochs) and merged_epochs <= (ship_tids & merge_tids)
    res = {
        "nodes": nodes,
        "epochs": epochs,
        "epochs_merged": agg.epochs_merged,
        "recall_min": round(recall, 4),
        "recall_per_epoch": {e: round(v, 4) for e, v in recalls.items()},
        "top_count_rel_err": {e: round(v, 4) for e, v in top_err.items()},
        "killed_node": shippers[victim].node,
        "kill_after": kill_after,
        "straggled_epochs": straggled,
        "post_kill_nodes": [len(r["nodes"]) for r in post_kill],
        "frames_shipped": sum(s.shipped for s in shippers),
        "tenants_seen": tenants_seen,
        "tenant_series_bound": bound,
        "tenant_series_max_observed": series_obs,
        "epoch_history_bound": int(base.fleet_epoch_history),
        "open_buckets_max": agg.open_buckets_max,
        "trace_lineage_ok": lineage_ok,
        "ok": bool(
            agg.epochs_merged >= epochs
            and recall >= 0.95
            and series_obs <= bound
            and tenants_seen <= base.fleet_max_tenants
            and agg.open_buckets_max <= base.fleet_epoch_history
            and lineage_ok
        ),
    }
    log(f"fleet dryrun: {nodes} agents, {agg.epochs_merged}/{epochs} epochs merged, min recall "
        f"{recall:.3f}, {straggled} straggled (node {shippers[victim].node} killed after "
        f"epoch {kill_after - 1}), tenant series {series_obs}<={bound}")
    return res


def _invertible_arrays(keys: np.ndarray, w: np.ndarray, is_pri: np.ndarray,
                       device: torch.device | str | None = None) -> dict[str, np.ndarray]:
    """One node-window's counter-only wire arrays: the flow CMS and the two
    invertible regions, and no ``flow_keys``/``flow_counts``: the frame
    carries no raw key and the aggregator still names the heavy flows."""
    dev = resolve_device(device)
    kt = _u32(keys, dev)
    cols = [kt[:, i].contiguous() for i in range(4)]
    wv = _u32(w, dev)
    pri = torch.from_numpy(np.asarray(is_pri, bool)).to(dev)
    zero = torch.zeros_like(wv)
    cms = CountMinSketch.zeros(depth=_DEPTH, width=_WIDTH, seed=INV_SEEDS["flow"],
                               device=dev).update(cols, wv)
    inv_flow = InvertibleSketch.zeros(depth=_INV_DEPTH, width=_INV_WIDTH,
                                      seed=INV_SEEDS["inv_flow"], device=dev).update(
        cols, torch.where(pri, zero, wv))
    inv_hi = InvertibleSketch.zeros(depth=_INV_DEPTH, width=_INV_HI_WIDTH,
                                    seed=INV_SEEDS["inv_hi"], device=dev).update(
        cols, torch.where(pri, wv, zero))
    return {
        "flow_cms": to_numpy(cms.table),
        "inv_flow_planes": to_numpy(inv_flow.planes),
        "inv_flow_weights": to_numpy(inv_flow.weights),
        "inv_hi_planes": to_numpy(inv_hi.planes),
        "inv_hi_weights": to_numpy(inv_hi.weights),
    }


def run_invertible_dryrun(
    nodes: int = 4,
    epochs: int = 3,
    shed_from: int = 1,
    shed_k: int = 8,
    heavy_flows: int = 32,
    light_flows: int = 256,
    priority_flows: int = 8,
    seed: int = 0,
    straggler_timeout_s: float = 1.0,
    log: Callable[[str], None] = lambda s: None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Cluster key-recovery dryrun (see the module doc). Epochs at or past
    ``shed_from`` run a forced SHEDDING episode: background (light) flows
    are 1-in-``shed_k`` sampled with Horvitz-Thompson rescale, while heavy
    and priority-class flows stay exempt. Scorecard: heavy-key recall >=
    0.95 every epoch, priority recall 1.0 including the shedding epochs."""
    assert nodes >= 2 and epochs >= 1
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    base = Config(
        fleet_enabled=True,
        fleet_aggregator=True,
        fleet_expected_nodes=nodes,
        fleet_straggler_timeout_s=straggler_timeout_s,
        fleet_topk_k=64,
    )
    agg = FleetAggregator(base, device=dev)
    agg.start(subscribe=True)

    # Global heavy flows (every node carries a share) and priority-class
    # flows (src IP in 10.0.0.0/8: top byte 0x0A).
    heavy = rng.integers(0, 2**32, size=(heavy_flows, 4), dtype=np.uint32)
    pri = rng.integers(0, 2**32, size=(priority_flows, 4), dtype=np.uint32)
    pri[:, 0] = (pri[:, 0] & np.uint32(0x00FFFFFF)) | np.uint32(0x0A000000)

    shippers: list[SnapshotShipper] = []
    for i in range(nodes):
        cfg_i = dataclasses.replace(base, fleet_node_name=f"inv{i:02d}",
                                    fleet_tenant=f"tenant{i % 2}", fleet_priority=i % 2)
        s = SnapshotShipper(cfg_i)
        s.start()
        shippers.append(s)

    n_rows = heavy_flows + priority_flows + light_flows
    _invertible_arrays(np.zeros((n_rows, 4), np.uint32), np.ones(n_rows),
                       np.zeros(n_rows, bool), dev)

    epoch_interval = 0.25
    t0 = time.monotonic()

    def agent(i: int) -> None:
        node_rng = np.random.default_rng(seed * 1000 + i)
        ship = shippers[i]
        for e in range(epochs):
            wait = t0 + e * epoch_interval - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            hw = node_rng.integers(100, 200, size=heavy_flows)
            # Priority flows are light on any one node: only the
            # never-sampled hi region makes them recoverable.
            pw = node_rng.integers(5, 15, size=priority_flows)
            lkeys = node_rng.integers(0, 2**32, size=(light_flows, 4), dtype=np.uint32)
            # Keep ambient light keys out of the priority class.
            lkeys[:, 0] |= np.uint32(0x80000000)
            lw = node_rng.integers(1, 4, size=light_flows).astype(np.int64)
            if e >= shed_from:
                # Forced SHEDDING: background tier only, HT rescale.
                keep = node_rng.random(light_flows) < 1.0 / shed_k
                lw = np.where(keep, lw * shed_k, 0)
            keys = np.concatenate([heavy, pri, lkeys])
            w = np.concatenate([hw, pw, lw]).astype(np.int64)
            is_pri = (keys[:, 0] >> 24) == 0x0A
            ship.offer(e, _invertible_arrays(keys, w, is_pri, dev), 15.0, dict(INV_SEEDS))

    threads = [threading.Thread(target=agent, args=(i,), name=f"inv-sim{i}")
               for i in range(nodes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    deadline = time.monotonic() + straggler_timeout_s * 4 + 60.0
    while agg.epochs_merged < epochs and time.monotonic() < deadline:
        time.sleep(0.05)
    for s in shippers:
        s.stop()
    agg.stop()

    # -- scorecard ------------------------------------------------------------
    rollups = list(agg.rollups)
    heavy_set = {tuple(int(x) for x in row) for row in heavy}
    pri_set = {tuple(int(x) for x in row) for row in pri}
    recalls: dict[int, float] = {}
    hi_recalls: dict[int, float] = {}
    precisions: dict[int, float] = {}
    for r in rollups:
        e = r["epoch"]
        inv = r.get("invertible")
        if inv is None:
            recalls[e] = hi_recalls[e] = precisions[e] = 0.0
            continue
        got = {tuple(int(x) for x in row) for row in inv["keys"]}
        recalls[e] = len(heavy_set & got) / len(heavy_set) if heavy_set else 1.0
        hi_recalls[e] = len(pri_set & got) / len(pri_set) if pri_set else 1.0
        truth = heavy_set | pri_set
        precisions[e] = len(truth & got) / max(len(got), 1)
    recall = min(recalls.values()) if recalls else 0.0
    hi_recall = min(hi_recalls.values()) if hi_recalls else 0.0
    shed_epochs = [e for e in recalls if e >= shed_from]
    res = {
        "nodes": nodes,
        "epochs": epochs,
        "epochs_merged": agg.epochs_merged,
        "recall_min": round(recall, 4),
        "recall_per_epoch": {e: round(v, 4) for e, v in recalls.items()},
        "hi_recall_min": round(hi_recall, 4),
        "hi_recall_per_epoch": {e: round(v, 4) for e, v in hi_recalls.items()},
        "precision_per_epoch": {e: round(v, 4) for e, v in precisions.items()},
        "shed_from": shed_from,
        "shed_k": shed_k,
        "shed_epochs_scored": len(shed_epochs),
        "frames_shipped": sum(s.shipped for s in shippers),
        "raw_keys_on_wire": 0,  # structural: no *_keys arrays shipped
        "ok": bool(
            agg.epochs_merged >= epochs
            and recall >= 0.95
            and hi_recall >= 1.0
            and len(shed_epochs) >= 1
        ),
    }
    log(f"invertible dryrun: {nodes} agents, {agg.epochs_merged}/{epochs} epochs merged, min "
        f"recall {recall:.3f}, priority recall {hi_recall:.3f} (shedding from epoch "
        f"{shed_from}, 1-in-{shed_k})")
    return res
