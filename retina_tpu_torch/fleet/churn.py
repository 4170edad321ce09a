"""Multi-process fleet churn harness (port of retina_tpu/fleet/churn.py, the
reference's ``bench.py --churn-dryrun``).

The real topology, end to end, with real failures:

- N node agents as SEPARATE OS processes (fleet/node_agent.py, torch-free)
  shipping RFLT frames over real ``retina.Fleet/Ship`` gRPC sockets;
- Z zone relays, each a :class:`HubbleServer` feeding a zone
  :class:`FleetAggregator` whose merged epochs RE-SHIP (tier 1) to a
  root relay + root aggregator — the two-level rollup. Every aggregator
  merges on ``device`` (the card unless the caller names the CPU): K8's
  fold and K9's candidate join for each epoch, then the rollup's queries;
- a scripted fault timeline: a rolling restart of ``churn_frac`` of
  the nodes, a node→relay partition (zone 0's relay goes away and
  comes back on the same port), a relay→root partition (zone 1's
  uplink refuses), and a live fleet-wide seed rotation.

Scorecard gates (the reference's acceptance contract):

- root-tier top-k recall ≥ 0.95 every epoch, scored against EXACT
  per-flow counts of exactly the nodes each rollup merged (traffic is
  deterministic per (seed, node, epoch) — hostsketch.epoch_traffic —
  so the parent recomputes ground truth with zero IPC);
- partitions heal with spooled frames REPLAYED (child spools for the
  node→relay cut, the zone re-shipper's spool for the relay→root cut),
  and no frame is lost silently: every send attempt is accounted
  accepted-or-counted-drop on the receiving side;
- the seed rotation re-admits EVERY live node at the new generation;
- ``trace_lineage_ok`` across all three tiers: every root-merged epoch
  appears as a SHIP_SEND trace ID in some child, a SHIP_SEND in the
  parent (zone re-ship), and ≥2 AGG_MERGE spans (zone + root);
- operator scrape latency p99 stays bounded while all of this churns.

Beside the reference's scorecard the port's reports the children's
largest peak and largest final resident set (``VmHWM`` and ``VmRSS`` from
each child's ``/proc/self/status``, in its STATS line; None where
``/proc`` does not give them) and the zone and root merges' seconds.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Any, Callable

import numpy as np

import retina_tpu_torch
from retina_tpu_torch.config import Config
from retina_tpu_torch.fleet.aggregator import FleetAggregator
from retina_tpu_torch.fleet.codec import FleetSnapshot, encode_snapshot
from retina_tpu_torch.fleet.hostsketch import (
    exact_counter, rotated_seeds, sketch_arrays_np,
)
from retina_tpu_torch.hubble.observer import FlowObserver
from retina_tpu_torch.hubble.server import FleetShipClient, HubbleServer
from retina_tpu_torch.metrics import get_exporter, get_metrics
from retina_tpu_torch.obs.recorder import get_recorder
from retina_tpu_torch.utils import metric_names as mn

_REPO_ROOT = Path(retina_tpu_torch.__file__).resolve().parents[1]


class _Child:
    """One node-agent process + a stdout reader thread (deadline-based
    readiness — satellite: no fixed sleeps anywhere in this harness)."""

    def __init__(self, index: int, relay: str, *, interval: float,
                 heavy: int, light: int, seed: int, gen: int = 0):
        self.index = index
        self.node = f"node{index:03d}"
        self.ready = threading.Event()
        self.stats: dict | None = None
        self._stats_evt = threading.Event()
        env = dict(os.environ)
        env["PYTHONPATH"] = (
            str(_REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        )
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "retina_tpu_torch.fleet.node_agent",
             "--node-index", str(index), "--relay", relay,
             "--interval", str(interval), "--heavy", str(heavy),
             "--light", str(light), "--seed", str(seed),
             "--gen", str(gen)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env,
            cwd=str(_REPO_ROOT),
        )
        self._reader = threading.Thread(
            target=self._read, name=f"churn-read-{index}", daemon=True
        )
        self._reader.start()

    def _read(self) -> None:
        import json

        for line in self.proc.stdout:
            if line.startswith("READY "):
                self.ready.set()
            elif line.startswith("STATS "):
                try:
                    self.stats = json.loads(line[len("STATS "):])
                except ValueError:
                    self.stats = None
                self._stats_evt.set()
        self._stats_evt.set()  # EOF without STATS (killed child)

    def send(self, line: str) -> None:
        try:
            self.proc.stdin.write(line + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, ValueError, OSError):  # noqa: RT101 - a dead child's pipe is expected mid-churn; its STATS collection accounts for it
            pass

    def stop(self, deadline_s: float = 15.0) -> dict | None:
        self.send("STOP")
        self._stats_evt.wait(deadline_s)
        try:
            self.proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
        return self.stats

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait()


class _ZoneUplink:
    """Zone→root transport with a partition switch. Counts every
    attempt so the scorecard can prove nothing vanished in transit."""

    def __init__(self, root_addr: str):
        self.root_addr = root_addr
        self.partitioned = False
        self.sent = 0
        self._client: FleetShipClient | None = None
        self._lock = threading.Lock()

    def __call__(self, frame: bytes) -> None:
        with self._lock:
            if self.partitioned:
                raise ConnectionError("relay->root partition (scripted)")
            if self._client is None:
                # Default (short) deadline on purpose: the root handler
                # merges inline, so a cold jit compile can outlive the
                # RPC — failing fast keeps the replay queue moving and
                # the frame that did land server-side just re-ships as
                # a counted duplicate (tolerated by the >= accounting).
                self._client = FleetShipClient(self.root_addr)
            client = self._client
        client.ship(frame)
        with self._lock:
            self.sent += 1

    def close(self) -> None:
        with self._lock:
            if self._client is not None:
                self._client.close()
                self._client = None


class _CountedIngest:
    """Wrap an aggregator's ingest with accept/reject accounting (the
    reject side is the aggregator's counted drop — late/dup/skew — so
    accepted + rejected == frames that arrived: no silent loss)."""

    def __init__(self, ingest: Callable[[bytes], bool]):
        self._ingest = ingest
        self.accepted = 0
        self.rejected = 0
        self._lock = threading.Lock()

    def __call__(self, frame: bytes) -> bool:
        ok = self._ingest(frame)
        with self._lock:
            if ok:
                self.accepted += 1
            else:
                self.rejected += 1
        return ok


def _wait(predicate: Callable[[], bool], deadline_s: float,
          poll_s: float = 0.05) -> bool:
    """Deadline-based condition wait (never a bare fixed sleep)."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll_s)
    return predicate()


def _sleep_until_epoch(interval: float, epoch: int) -> None:
    """Sleep until wall-clock window ``epoch`` begins."""
    target = epoch * interval
    while True:
        dt = target - time.time()
        if dt <= 0:
            return
        time.sleep(min(dt, 0.2))


def run_churn_dryrun(
    nodes: int = 64,
    zones: int = 4,
    heavy_flows: int = 40,
    light_flows: int = 64,
    seed: int = 0,
    interval_s: float = 1.0,
    churn_frac: float = 0.10,
    scrape_p99_budget_s: float = 0.5,
    log: Callable[[str], None] = lambda s: None,
    device: Any = None,
) -> dict[str, Any]:
    """Run the full churn timeline; returns the scorecard dict. The zone
    and root aggregators merge on ``device`` (None: the card)."""
    if not (nodes >= zones >= 2 and nodes % zones == 0):
        raise ValueError(f"need nodes >= zones >= 2 and nodes % zones == 0, "
                         f"got {nodes} nodes, {zones} zones")
    per_zone = nodes // zones
    k = 32
    rotation_gen = 1

    # -- root tier -----------------------------------------------------
    root_cfg = Config(
        fleet_enabled=True, fleet_aggregator=True,
        fleet_expected_nodes=zones,
        fleet_straggler_timeout_s=2.5 * interval_s,
        fleet_topk_k=k, fleet_node_name="root",
        fleet_max_tenants=8,
        fleet_merge_async=True,
    )
    root = FleetAggregator(root_cfg, device=device)
    # The default rollup retention (64) can evict scored-window epochs
    # while post-timeline merges drain; keep the whole run.
    root.rollups_keep = 512
    root_ingest = _CountedIngest(root.ingest)
    root_server = HubbleServer(
        FlowObserver(), "127.0.0.1:0", fleet_ingest=root_ingest
    )
    root_server.start()
    root_addr = f"127.0.0.1:{root_server.port}"
    # NB: root.start() is deferred until after the prewarm below — its
    # poll thread straggler-closes buckets, and the prewarm's zone
    # merges arrive seconds apart (cold compiles), which would close
    # the warm epoch at n=1 and leave the full-quorum path cold.

    # -- zone tier -----------------------------------------------------
    zone_aggs: list[FleetAggregator] = []
    zone_uplinks: list[_ZoneUplink] = []
    zone_ingests: list[_CountedIngest] = []
    zone_servers: list[HubbleServer | None] = []
    zone_addrs: list[str] = []
    for z in range(zones):
        up = _ZoneUplink(root_addr)
        zcfg = Config(
            fleet_enabled=True, fleet_aggregator=True,
            fleet_expected_nodes=per_zone,
            fleet_straggler_timeout_s=1.5 * interval_s,
            fleet_topk_k=k, fleet_node_name=f"zone{z}",
            fleet_reship_addr=root_addr,  # transport below overrides
            fleet_ship_spool=64,
            fleet_ship_backoff_base_s=0.05,
            fleet_ship_backoff_max_s=0.5,
            fleet_max_tenants=8,
            fleet_merge_async=True,
        )
        agg = FleetAggregator(zcfg, device=device, reship_transport=up)
        agg.rollups_keep = 512
        ing = _CountedIngest(agg.ingest)
        srv = HubbleServer(FlowObserver(), "127.0.0.1:0", fleet_ingest=ing)
        srv.start()
        agg.start(subscribe=False)
        zone_aggs.append(agg)
        zone_uplinks.append(up)
        zone_ingests.append(ing)
        zone_servers.append(srv)
        zone_addrs.append(f"127.0.0.1:{srv.port}")

    # -- prewarm -------------------------------------------------------
    # The reference warms its merge/rollup jit caches here (they key on
    # batch size and seeds, so a live rotation would set off a compile
    # storm inside the gRPC handlers). The port's first merge pays the
    # kernels' load (and build, where no earlier call built them), their
    # first launches and the card's allocations, and the warm epochs prove the
    # full-quorum path through both tiers for BOTH generations before the
    # timeline: synthetic zero-traffic epochs 1 (gen 0) and 2 (gen 1)
    # ingested at every zone; the re-ship cascade warms the root. Real
    # window epochs are ~1e9, so the warm epochs never collide.
    log(f"churn: prewarming the merge path for gens 0/{rotation_gen}")
    for warm_epoch, warm_gen in ((1, 0), (2, rotation_gen)):
        wseeds = rotated_seeds(warm_gen)
        warrays = sketch_arrays_np(
            np.zeros((0, 4), np.uint32), np.zeros(0, np.uint32), wseeds
        )
        for z, agg in enumerate(zone_aggs):
            for n in range(per_zone):
                agg.ingest(encode_snapshot(FleetSnapshot(
                    node=f"warm{n:03d}", tenant="warm", priority=0,
                    epoch=warm_epoch, seq=warm_epoch, window_s=interval_s,
                    seeds=dict(wseeds),
                    arrays={k: v.copy() for k, v in warrays.items()},
                    seed_gen=warm_gen,
                )))
    def _warm_done() -> bool:
        # The root's poll thread isn't running yet (started below) —
        # drive its deferred-merge queue here. now=0.0 makes every
        # straggler check negative, so only quorum-complete warm
        # buckets merge; a partially-arrived one keeps waiting.
        root.poll(now=0.0)
        return {1, 2} <= {r["epoch"] for r in root.rollups}

    warm_ok = _wait(_warm_done, deadline_s=180.0, poll_s=0.1)
    log(f"churn: prewarm done (root warmed across tiers: {warm_ok})")
    root.start(subscribe=False)

    # -- scrape-latency probe (operator view under fan-in) -------------
    scrape_times: list[float] = []
    scrape_stop = threading.Event()

    def scraper() -> None:
        exp = get_exporter()
        while not scrape_stop.is_set():
            t0 = time.monotonic()
            exp.gather_text()
            scrape_times.append(time.monotonic() - t0)
            scrape_stop.wait(0.05)

    scrape_thread = threading.Thread(
        target=scraper, name="churn-scrape", daemon=True
    )
    scrape_thread.start()

    # -- node tier: real child processes -------------------------------
    def spawn(i: int, gen: int = 0) -> _Child:
        return _Child(
            i, zone_addrs[i % zones], interval=interval_s,
            heavy=heavy_flows, light=light_flows, seed=seed, gen=gen,
        )

    children: dict[int, _Child] = {i: spawn(i) for i in range(nodes)}
    ready_ok = _wait(
        lambda: all(c.ready.is_set() for c in children.values()),
        deadline_s=60.0,
    )
    events: list[str] = []
    if not ready_ok:
        missing = [c.node for c in children.values() if not c.ready.is_set()]
        events.append(f"READY timeout: {missing}")

    def mark(msg: str) -> None:
        # Stamp every fault event with the ACTUAL epoch offset it fired
        # at — on a loaded host a deadline wait can push an event past
        # its scripted slot, and scorecard triage needs the real times.
        events.append(f"[e+{int(time.time() // interval_s) - e0}] {msg}")
        log(f"churn: {events[-1]}")
    # First fully-observed epoch: the next wall-clock window boundary.
    e0 = int(time.time() // interval_s) + 1
    log(f"churn: {nodes} children ready across {zones} zones; "
        f"timeline starts at epoch {e0}")

    # -- fault timeline (wall-clock epochs, e = offset from e0) --------
    churn_n = max(1, int(round(nodes * churn_frac)))
    # Evenly spread victims across the fleet (distinct by construction:
    # i*nodes//churn_n is strictly increasing for churn_n <= nodes).
    restart_ids = sorted(i * nodes // churn_n for i in range(churn_n))
    total_epochs = 14

    _sleep_until_epoch(interval_s, e0 + 3)
    for i in restart_ids:  # rolling restart, 10% of the fleet
        old = children[i]
        old.kill()
        children[i] = spawn(i)
        mark(f"restarted {old.node}")
    _wait(lambda: all(
        children[i].ready.is_set() for i in restart_ids
    ), deadline_s=30.0)

    _sleep_until_epoch(interval_s, e0 + 5)
    # node→relay partition: zone 0's relay disappears mid-epoch...
    z0_port = zone_servers[0].port
    zone_servers[0].stop(grace=0)
    zone_servers[0] = None
    mark("zone0 relay down")
    _sleep_until_epoch(interval_s, e0 + 6)
    time.sleep(interval_s / 2.0)
    # ...and comes back on the SAME port: children re-dial and replay.
    # Deadline-based rebind (the dead server's socket can linger for a
    # beat; add_insecure_port reports failure as port 0).
    rebind_deadline = time.monotonic() + 15.0
    srv = None
    while srv is None:
        cand = HubbleServer(
            FlowObserver(), f"127.0.0.1:{z0_port}",
            fleet_ingest=zone_ingests[0],
        )
        if cand.port == z0_port:
            srv = cand
        else:
            cand.stop(grace=0)
            if time.monotonic() > rebind_deadline:
                raise RuntimeError(
                    f"zone0 relay could not rebind port {z0_port}"
                )
            time.sleep(0.2)
    srv.start()
    zone_servers[0] = srv
    mark("zone0 relay back")

    _sleep_until_epoch(interval_s, e0 + 7)
    zone_uplinks[1].partitioned = True  # relay→root partition
    mark("zone1 uplink partitioned")
    # Heal only once the cut has provably bitten: at least one merged
    # epoch must land in zone1's re-ship spool first. On a loaded host
    # the zone's poll-thread merge of e+7 can lag past a fixed heal
    # point — and a partition nothing tried to cross exercises nothing.
    spool_armed = _wait(
        lambda: zone_aggs[1].stats().get("reship", {}).get(
            "spool_depth", 0) > 0,
        deadline_s=4 * interval_s + 15.0,
    )
    _sleep_until_epoch(interval_s, e0 + 8)
    time.sleep(interval_s / 2.0)
    zone_uplinks[1].partitioned = False
    mark(f"zone1 uplink healed (spool_armed={spool_armed})")

    _sleep_until_epoch(interval_s, e0 + 9)
    # Live fleet-wide seed rotation. The deadline waits above can push
    # the clock past the scripted e+9 slot, so the rotation's effective
    # epoch is whatever boundary comes NEXT (children flip generation
    # at their next window build) — and the scored window extends to
    # keep ≥5 observable post-rotation epochs no matter how far the
    # timeline slipped.
    rot_e = int(time.time() // interval_s) + 1
    for c in children.values():
        c.send(f"ROTATE {rotation_gen}")
    mark(f"rotation to gen {rotation_gen} (effective e+{rot_e - e0})")
    total_epochs = max(total_epochs, rot_e - e0 + 5)

    # Give the last scored epoch one full extra window to ship, then
    # stop the children FIRST: on a loaded host the merge backlog can
    # only drain once the fleet stops competing for the cores, and a
    # child shipping epochs past the scored window adds nothing.
    last_scored = e0 + total_epochs - 1
    _sleep_until_epoch(interval_s, e0 + total_epochs + 1)

    # -- teardown + collection -----------------------------------------
    child_stats: dict[int, dict | None] = {}
    stoppers = []
    for i, c in children.items():
        t = threading.Thread(
            target=lambda i=i, c=c: child_stats.__setitem__(i, c.stop()),
            daemon=True,
        )
        t.start()
        stoppers.append(t)
    for t in stoppers:
        t.join(timeout=30.0)
    # Now let stragglers close and the root work through its deferred
    # merge queue up to the end of the scored window.
    _wait(
        lambda: any(
            r["epoch"] >= last_scored for r in root.rollups
        ),
        deadline_s=60.0,
    )
    # Zone re-ship spools drain on their own retry timers post-heal.
    _wait(lambda: all(
        a.stats().get("reship", {}).get("spool_depth", 0) == 0
        for a in zone_aggs
    ), deadline_s=15.0)
    # Capture live aggregator state BEFORE stop(): open buckets and the
    # deferred-merge queue are exactly what a stalled tier leaves behind.
    root_stats_end = root.stats()
    drop_reasons: dict[str, int] = {}
    for suffix, labels, value in get_metrics().fleet_snapshots_dropped.samples():
        if suffix == "_total" and value:
            drop_reasons[labels.get("reason", "?")] = int(value)
    scrape_stop.set()
    scrape_thread.join(timeout=5.0)
    for a in zone_aggs:
        a.stop()
    root.stop()
    for s in zone_servers:
        if s is not None:
            s.stop(grace=0)
    root_server.stop(grace=0)
    for up in zone_uplinks:
        up.close()

    # -- scorecard -----------------------------------------------------
    # A frame replayed after its epoch already merged can open a second
    # bucket and publish a second, smaller rollup for the same epoch
    # (the recovery path doing its job). Pairing across tiers must be
    # FIRST-wins on both: a root bucket dedupes per zone name keeping
    # the first-arriving frame, and the re-shipper is FIFO (spool
    # replays oldest-first), so the root's sketch content for an epoch
    # is exactly the FIRST rollup each zone published for it — scoring
    # against any other instance compares the wrong ground truth.
    zone_rollups: list[dict[int, dict]] = []
    for a in zone_aggs:
        first: dict[int, dict] = {}
        for r in a.rollups:
            first.setdefault(r["epoch"], r)
        zone_rollups.append(first)

    root_first: dict[int, dict] = {}
    for r in root.rollups:
        root_first.setdefault(r["epoch"], r)
    recalls: dict[int, float] = {}
    for r in root_first.values():
        e = r["epoch"]
        if e < e0 or e > last_scored:
            continue
        merged_exact: Counter = Counter()
        for zname in r["nodes"]:
            zr = zone_rollups[int(zname[4:])].get(e)
            if zr is None:
                continue
            for node in zr["nodes"]:
                merged_exact.update(exact_counter(
                    seed, int(node[4:]), e, heavy_flows, light_flows
                ))
        if not merged_exact:
            continue
        exact_top = [kk for kk, _ in merged_exact.most_common(k)]
        got = {tuple(int(x) for x in row) for row in r["top_flow"][0]}
        recalls[e] = (
            sum(1 for kk in exact_top if kk in got) / len(exact_top)
        )
    recall_min = min(recalls.values()) if recalls else 0.0

    # Spool/replay evidence: the node→relay cut must show child-side
    # replay (zone-0 children), the relay→root cut re-ship replay.
    zone0_children = [
        s for i, s in child_stats.items()
        if s is not None and i % zones == 0
    ]
    child_replayed = sum(s["spool_replayed"] for s in zone0_children)
    child_evicted = sum(
        s["spool_evicted"] for s in child_stats.values() if s is not None
    )
    reship_stats = [a.stats().get("reship", {}) for a in zone_aggs]
    reship_replayed = sum(
        int(s.get("spool_replayed", 0)) for s in reship_stats
    )
    reship_spool_left = sum(
        int(s.get("spool_depth", 0)) for s in reship_stats
    )
    # Frame accounting, node tier: every frame a graceful child queued
    # was either shipped or is an explicitly counted eviction; and at
    # the relays, every arrived frame was accepted or counted-dropped.
    child_acct_ok = all(
        s["shipped"] + s["spool_evicted"] + s["spool_depth"]
        == sum(1 for o in s["offered"] if o["queued"])
        for s in child_stats.values() if s is not None
    )
    # Direction matters: a send the uplink believes delivered must have
    # arrived (accepted or counted-drop). Arrivals can EXCEED counted
    # sends — an RPC that times out after server-side processing is a
    # counted failure on the sender and a counted duplicate on replay —
    # so >= is the no-silent-loss invariant, not ==.
    uplink_sent = sum(u.sent for u in zone_uplinks)
    root_acct_ok = (
        root_ingest.accepted + root_ingest.rejected >= uplink_sent
    )
    no_silent_loss = bool(
        child_acct_ok and root_acct_ok and reship_spool_left == 0
    )

    # Rotation re-admission: some scored epoch at the new generation
    # must merge EVERY zone at the root and EVERY live node in every
    # zone (live = all of them; restarts completed long before).
    readmit_epochs = [
        r["epoch"] for r in root.rollups
        if r.get("seed_gen") == rotation_gen
        and len(r["nodes"]) == zones
        # Post-rotation scored window only: the gen-1 PREWARM epoch is
        # also a full-quorum gen-1 rollup and must not satisfy this.
        and rot_e <= r["epoch"] <= last_scored
        and all(
            len(zone_rollups[int(z[4:])].get(r["epoch"], {}).get(
                "nodes", ())) == per_zone
            for z in r["nodes"]
        )
    ]
    rotation_ok = bool(readmit_epochs)
    # Post-rotation tail diagnostics (what merged, at which generation,
    # with how many nodes per zone) — the first thing to read when the
    # re-admission gate fails.
    rotation_tail = [
        {
            "e": r["epoch"] - e0,
            "gen": r.get("seed_gen"),
            "zones": list(r["nodes"]),
            "zone_nodes": {
                z: len(zone_rollups[int(z[4:])].get(
                    r["epoch"], {}).get("nodes", ()))
                for z in r["nodes"]
            },
        }
        for r in root.rollups if r["epoch"] >= rot_e
    ]

    # Three-tier trace lineage over the window-epoch trace ID.
    spans = get_recorder().spans()
    parent_ship_tids = {
        s["trace_id"] for s in spans if s["stage"] == mn.STAGE_SHIP_SEND
    }
    merge_tid_counts = Counter(
        s["trace_id"] for s in spans if s["stage"] == mn.STAGE_AGG_MERGE
    )
    child_ship_tids: set[int] = set()
    for s in child_stats.values():
        if s is not None:
            child_ship_tids.update(int(t) for t in s["ship_tids"])
    root_epochs = {
        r["epoch"] for r in root.rollups
        if e0 <= r["epoch"] <= last_scored
    }
    lineage_ok = bool(root_epochs) and all(
        e in child_ship_tids
        and e in parent_ship_tids
        and merge_tid_counts.get(e, 0) >= 2
        for e in root_epochs
    )

    scrape_p99 = (
        float(np.quantile(np.array(scrape_times), 0.99))
        if scrape_times else float("inf")
    )

    zone_merge_s = [float(r.get("merge_seconds", 0.0))
                    for a in zone_aggs for r in a.rollups]
    root_merge_s = [float(r.get("merge_seconds", 0.0)) for r in root.rollups]
    mems = [s.get("memory_kb", {}) for s in child_stats.values() if s]
    peaks = [m["VmHWM"] for m in mems if "VmHWM" in m]
    finals = [m["VmRSS"] for m in mems if "VmRSS" in m]

    res: dict[str, Any] = {
        "nodes": nodes,
        "zones": zones,
        "per_zone": per_zone,
        "epochs_scored": len(recalls),
        "root_epochs_merged": root.epochs_merged,
        "zone_epochs_merged": [a.epochs_merged for a in zone_aggs],
        # Triage aid: WHERE the root's merges actually landed relative
        # to the scored window. A healthy run is all "in"; "above"
        # means merges drained after the window closed (host overload),
        # "below" is warm/prewarm traffic.
        "root_state_at_teardown": {
            "watermark_offset": root_stats_end["watermark"] - e0,
            "open_epoch_offsets": [
                e - e0 for e in root_stats_end["open_epochs"]
            ][:32],
            "ready_q": root_stats_end.get("ready_q", 0),
        },
        # In-process drop accounting by reason (all tiers share the
        # process-global counter; zone + root combined).
        "frames_dropped_by_reason": drop_reasons,
        "root_epoch_dist": {
            "below": sum(1 for r in root.rollups if r["epoch"] < e0),
            "in": sum(
                1 for r in root.rollups
                if e0 <= r["epoch"] <= last_scored
            ),
            "above": sum(
                1 for r in root.rollups if r["epoch"] > last_scored
            ),
            "offsets": sorted(
                {r["epoch"] - e0 for r in root.rollups}
            )[:64],
        },
        "recall_min": round(recall_min, 4),
        "recall_per_epoch": {
            e - e0: round(v, 4) for e, v in sorted(recalls.items())
        },
        "restarted": [children[i].node for i in restart_ids],
        "child_spool_replayed": child_replayed,
        "child_spool_evicted": child_evicted,
        "reship_spool_replayed": reship_replayed,
        "uplink_frames_sent": uplink_sent,
        "root_frames_accepted": root_ingest.accepted,
        "root_frames_rejected_counted": root_ingest.rejected,
        "no_silent_frame_loss": no_silent_loss,
        "rotation_gen": rotation_gen,
        "rotation_readmitted_all": rotation_ok,
        "rotation_readmit_epochs": [e - e0 for e in readmit_epochs],
        "rotation_tail": rotation_tail,
        "child_summary": {
            (s["node"] if s else f"node{i:03d}"): (
                [s["n_offered"], s["shipped"], s["spool_replayed"],
                 s["spool_evicted"], s["seed_gen"]]
                if s else "no-stats"
            )
            for i, s in sorted(child_stats.items())
        },
        "zone_nodes_by_epoch": [
            {
                e - e0: sorted(zr[e]["nodes"])
                for e in sorted(zr) if e0 <= e <= last_scored
            }
            for zr in zone_rollups
        ],
        "trace_lineage_ok": lineage_ok,
        "scrape_p99_s": round(scrape_p99, 4),
        "scrape_samples": len(scrape_times),
        "zone_merge_s": {"n": len(zone_merge_s), "sum": sum(zone_merge_s),
                         "max": max(zone_merge_s, default=0.0)},
        "root_merge_s": {"n": len(root_merge_s), "sum": sum(root_merge_s),
                         "max": max(root_merge_s, default=0.0)},
        "child_peak_rss_kb": max(peaks) if peaks else None,
        "child_rss_at_stop_kb": max(finals) if finals else None,
        "events": events,
        "ok": bool(
            len(recalls) >= total_epochs - 4
            and recall_min >= 0.95
            and child_replayed > 0
            and reship_replayed > 0
            and no_silent_loss
            and rotation_ok
            and lineage_ok
            and scrape_p99 <= scrape_p99_budget_s
        ),
    }
    log(
        f"churn dryrun: {nodes} procs/{zones} zones, "
        f"{len(recalls)} epochs scored, min recall {recall_min:.3f}, "
        f"child replay {child_replayed}, reship replay {reship_replayed}, "
        f"rotation re-admitted={rotation_ok}, lineage={lineage_ok}, "
        f"scrape p99 {scrape_p99 * 1e3:.1f}ms"
    )
    return res
