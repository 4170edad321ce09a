"""Operator-side fleet aggregator: epoch alignment and the merge on the card
(port of retina_tpu/fleet/aggregator.py).

``ingest`` decodes RFLT frames (``fleet/codec.py``) from N node agents and
buckets them by window epoch. An epoch closes when every expected node has
reported (``fleet_expected_nodes``), when the straggler timeout has passed
since its first arrival (``poll``), or when more than
``fleet_epoch_history`` epochs are open (the oldest is force-closed).
Duplicates (same node and epoch), late frames (epoch at or below the
watermark), undecodable frames and frames whose seeds or shapes disagree
with their seed generation's reference are dropped and counted in
``dropped``; with several seed generations in one epoch the dominant one
merges and the rest count as ``gen_skew``.

The merge runs on the card through the range fold's own functions
(``timetravel/fold.py`` ``stack_slots`` and ``fold_stacked``): one copy of
each stacked array, then K8 (sum, max) and K9 (the candidate-table join).
Cluster heavy hitters are the merged CMS queried (K10) at the union of the
nodes' candidates, or, with invertible state, at the keys decoded from the
merged sketch. ``rollups`` keeps the rollup dicts: cluster and per-tenant
top flows, per-service cardinality, distinct flows, entropy bits and
totals, under the reference's label-space guardrails (at most
``fleet_max_tenants`` tenants, lowest priority shed first, at most
``fleet_tenant_series_max`` series each). With ``timetravel_enabled``
every merged epoch is also a slot of ``epoch_ring``.

Transport and publication, as the reference's: ``start(subscribe=True)``
subscribes ``ingest`` to the in-process ``FLEET_TOPIC`` (the co-located
nodes' shippers publish there; a relay calls ``ingest`` itself) and starts
the poll thread, registered with the optional ``supervisor`` as
``fleet-agg``; ``stop`` unsubscribes. With ``fleet_reship_addr`` (or an
injected ``reship_transport``) every merged epoch is re-encoded as a node
snapshot (tier 1) and shipped one tier up by a ``SnapshotShipper``, so a
root aggregator folds zone rollups like node frames. Each merged epoch is
published (``_publish``): every ``fleet_*`` gauge of the reference, the
keyed ones cleared and set again each epoch, then the rollup on
``ROLLUP_TOPIC``. The counters go to the registry (``metrics.py``:
``fleet_snapshots_received``/``_dropped``, ``fleet_windows_merged``/
``_stragglers``, ``fleet_merge_errors``, ``fleet_merge_seconds``, ...) and
stay attributes too (``dropped``, ``received``, ``stragglers``, ...); the
flight recorder takes the merge span (``aggregator_merge``, the window
epoch its trace ID).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from collections import deque
from typing import Any

import numpy as np
import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.fleet.codec import (
    FLEET_TOPIC,
    ROLLUP_TOPIC,
    FleetDecodeError,
    FleetSnapshot,
    decode_snapshot,
)
from retina_tpu_torch.log import logger, rate_limited
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.obs.recorder import get_recorder
from retina_tpu_torch.ops.countmin import CountMinSketch
from retina_tpu_torch.ops.hyperloglog import HyperLogLog
from retina_tpu_torch.timetravel.fold import (
    HH_FAMILIES,
    cardinality,
    decode_regions,
    entropy_bits_by_dim,
    fold_stacked,
    host_arrays,
    stack_slots,
)
from retina_tpu_torch.pubsub import get_pubsub
from retina_tpu_torch.timetravel.ring import SnapshotRing
from retina_tpu_torch.u32 import from_numpy, to_numpy
from retina_tpu_torch.utils import metric_names as mn

# Seed-generation references kept: a live rotation is a few generations.
_GEN_HISTORY = 8
DROP_REASONS = ("decode", "late", "seed_mismatch", "shape_mismatch", "duplicate", "gen_skew")


def format_key(row: np.ndarray) -> str:
    """Stable label rendering of one candidate key row (C u32 columns)."""
    return "-".join(f"{int(c):08x}" for c in row)


class _EpochBucket:
    """Snapshots collected for one not-yet-closed epoch."""

    __slots__ = ("snaps", "first_t")

    def __init__(self, now: float) -> None:
        self.snaps: dict[str, FleetSnapshot] = {}
        self.first_t = now


class FleetAggregator:
    """Thread-safe: ``ingest`` runs on transport threads (the pubsub pool,
    a relay's handlers), ``poll`` on the aggregator's own thread
    (``start``)."""

    def __init__(self, cfg, device: torch.device | str | None = None, supervisor=None,
                 reship_transport=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.log = logger("fleet.agg")
        self._supervisor = supervisor
        self._lock = threading.Lock()
        self._buckets: dict[int, _EpochBucket] = {}
        self._watermark = -1  # highest closed epoch
        # (seeds, shapes) of the first frame of each seed generation.
        self._gen_refs: dict[int, tuple[dict[str, int], dict[str, tuple]]] = {}
        # Quorum-closed buckets waiting for poll (fleet_merge_async).
        self._ready_q: deque[tuple[int, _EpochBucket]] = deque()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._sub_id: str | None = None
        # Tier-2 re-ship: every merged epoch re-encoded as a (tier 1) node
        # snapshot and shipped to the next rollup tier, over an injected
        # transport or to the relay at fleet_reship_addr.
        self._reshipper = None
        if reship_transport is not None or str(cfg.fleet_reship_addr):
            from retina_tpu_torch.fleet.shipper import SnapshotShipper

            ship_cfg = dataclasses.replace(cfg, fleet_relay_addr=str(cfg.fleet_reship_addr))
            self._reshipper = SnapshotShipper(ship_cfg, supervisor=supervisor,
                                              transport=reship_transport)
            self._reshipper.tier = 1
        self.epoch_ring: SnapshotRing | None = None
        if cfg.timetravel_enabled:
            self.epoch_ring = SnapshotRing(cfg.timetravel_ring_windows, name="fleet")
        self.rollups: list[dict] = []
        self.rollups_keep = 64
        self.epochs_merged = 0
        self.open_buckets_max = 0
        self.dropped = dict.fromkeys(DROP_REASONS, 0)
        self.received: dict[str, int] = {}
        self.stragglers = 0
        self.merge_errors = 0
        self.tenants_shed = 0
        self.series_capped = 0
        self.invertible_decode_failed = 0
        self.last_error: str | None = None  # traceback of the last counted failure

    @property
    def timetravel_ring(self) -> SnapshotRing | None:
        return self.epoch_ring

    # -- lifecycle ----------------------------------------------------------
    def start(self, subscribe: bool = True) -> None:
        """Start the thread that calls ``poll`` (straggler timeouts and, with
        ``fleet_merge_async``, the quorum-closed merges) and the re-shipper;
        with ``subscribe``, take the co-located nodes' frames from
        ``FLEET_TOPIC``."""
        if subscribe and self._sub_id is None:
            self._sub_id = get_pubsub().subscribe(FLEET_TOPIC, self.ingest)
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._poll_loop, name="fleet-agg",
                                            daemon=True)
            self._thread.start()
        if self._reshipper is not None:
            self._reshipper.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._reshipper is not None:
            self._reshipper.stop(timeout_s=timeout_s)
        if self._sub_id is not None:
            try:
                get_pubsub().unsubscribe(FLEET_TOPIC, self._sub_id)
            except KeyError:  # already unsubscribed; stop is idempotent
                pass
            self._sub_id = None
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            if self._supervisor is not None:
                self._supervisor.deregister("fleet-agg")
        self._thread = None

    def _poll_loop(self) -> None:
        hb = None
        if self._supervisor is not None:
            hb = self._supervisor.register("fleet-agg", self.cfg.watchdog_deadline_s)
        cadence = max(0.05, self.cfg.fleet_straggler_timeout_s / 4.0)
        while not self._stop.is_set():
            if hb is not None:
                hb.beat()
            try:
                self.poll()
            except Exception:  # counted; the loop keeps the tier alive
                self._count_error("merge_errors")
                if rate_limited("fleet.poll"):
                    self.log.exception("fleet poll failed")
            if hb is not None:
                hb.park()
            self._stop.wait(cadence)

    # -- ingest -------------------------------------------------------------
    def ingest(self, frame: bytes) -> bool:
        """Decode and bucket one wire frame; True when accepted."""
        try:
            snap = decode_snapshot(frame)
        except FleetDecodeError as e:
            self._count_drop("decode")
            if rate_limited("fleet.decode"):
                self.log.warning("fleet frame rejected: %s", e)
            return False
        ready = None
        with self._lock:
            if snap.epoch <= self._watermark:
                self._count_drop_locked("late")
                return False
            gen = int(snap.seed_gen)
            ref = self._gen_refs.get(gen)
            if ref is None:
                while len(self._gen_refs) >= _GEN_HISTORY:
                    del self._gen_refs[min(self._gen_refs)]
                ref = (dict(snap.seeds), {k: v.shape for k, v in snap.arrays.items()})
                self._gen_refs[gen] = ref
            ref_seeds, ref_shapes = ref
            if snap.seeds != ref_seeds:
                self._count_drop_locked("seed_mismatch")
                return False
            if {k: v.shape for k, v in snap.arrays.items()} != ref_shapes:
                self._count_drop_locked("shape_mismatch")
                return False
            bucket = self._buckets.get(snap.epoch)
            if bucket is None:
                bucket = self._buckets[snap.epoch] = _EpochBucket(time.monotonic())
                self.open_buckets_max = max(self.open_buckets_max, len(self._buckets))
            if snap.node in bucket.snaps:
                self._count_drop_locked("duplicate")
                return False
            bucket.snaps[snap.node] = snap
            self.received[snap.node] = self.received.get(snap.node, 0) + 1
            get_metrics().fleet_snapshots_received.labels(node=snap.node).inc()
            expected = int(self.cfg.fleet_expected_nodes)
            if expected > 0 and len(bucket.snaps) >= expected:
                ready = [(snap.epoch, self._buckets.pop(snap.epoch))]
            else:
                ready = self._overflow_locked()
            if ready and self.cfg.fleet_merge_async:
                self._ready_q.extend(ready)  # merged by the poll thread
                ready = None
        for epoch, b in ready or ():
            self._merge_or_count(epoch, b, straggled=False)
        return True

    def _count_drop(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self._count_drop_locked(reason, n)

    def _count_drop_locked(self, reason: str, n: int = 1) -> None:
        self.dropped[reason] += n
        get_metrics().fleet_snapshots_dropped.labels(reason=reason).inc(n)

    def _overflow_locked(self) -> list[tuple[int, _EpochBucket]]:
        """Keep at most fleet_epoch_history open buckets, force-closing the
        oldest."""
        out = []
        limit = max(1, int(self.cfg.fleet_epoch_history))
        while len(self._buckets) > limit:
            oldest = min(self._buckets)
            out.append((oldest, self._buckets.pop(oldest)))
        return out

    def poll(self, now: float | None = None) -> int:
        """Merge the deferred quorum-closed epochs, then close epochs whose
        straggler timeout has expired. Returns the number of epochs merged."""
        now = time.monotonic() if now is None else now
        timeout = self.cfg.fleet_straggler_timeout_s
        ready: list[tuple[int, _EpochBucket, bool]] = []
        with self._lock:
            while self._ready_q:
                epoch, bucket = self._ready_q.popleft()
                ready.append((epoch, bucket, False))
            for epoch in sorted(self._buckets):
                if now - self._buckets[epoch].first_t >= timeout:
                    ready.append((epoch, self._buckets.pop(epoch), True))
        for epoch, bucket, straggled in ready:
            self._merge_or_count(epoch, bucket, straggled)
        return len(ready)

    def _merge_or_count(self, epoch: int, bucket: _EpochBucket, straggled: bool) -> None:
        try:
            self._merge_epoch(epoch, bucket, straggled)
        except Exception:  # counted: a bad epoch must not stop the tier
            self._count_error("merge_errors")
            if rate_limited("fleet.merge"):
                self.log.exception("fleet merge failed (epoch %d)", epoch)

    def _count_error(self, counter: str) -> None:
        """Count a failure under ``counter`` (an attribute, and its registry
        series ``fleet_<counter>``) and keep its traceback."""
        getattr(get_metrics(), f"fleet_{counter}").inc()
        with self._lock:
            setattr(self, counter, getattr(self, counter) + 1)
            self.last_error = traceback.format_exc()

    # -- merge --------------------------------------------------------------
    def _merge_epoch(self, epoch: int, bucket: _EpochBucket, straggled: bool) -> None:
        t0 = time.monotonic()
        m = get_metrics()
        rec = get_recorder()
        span_t0 = rec.begin()
        snaps = sorted(bucket.snaps.values(), key=lambda s: s.node)
        if not snaps:
            return
        # Cross-generation sketches do not merge: the dominant generation
        # (ties to the newer) merges, the rest count as skew.
        by_gen: dict[int, list[FleetSnapshot]] = {}
        for s in snaps:
            by_gen.setdefault(int(s.seed_gen), []).append(s)
        gen = max(by_gen, key=lambda g: (len(by_gen[g]), g))
        if len(by_gen) > 1:
            skewed = len(snaps) - len(by_gen[gen])
            self._count_drop("gen_skew", skewed)
            if rate_limited("fleet.gen_skew"):
                self.log.warning("fleet epoch %d: %d frame(s) outside dominant seed generation "
                                 "%d dropped (rotation in flight)", epoch, skewed, gen)
            snaps = by_gen[gen]
        # Lineage across processes: the shipped trace context carries the
        # window epoch of the node's close (the epoch itself when absent).
        trace_id = next((int(s.trace["tid"]) for s in snaps
                         if s.trace is not None and "tid" in s.trace), int(epoch))
        with self._lock:
            self._watermark = max(self._watermark, epoch)
        names = sorted(set.intersection(*(set(s.arrays) for s in snaps)))
        seeds = snaps[0].seeds
        merged = fold_stacked(stack_slots([s.arrays for s in snaps], names, self.device))
        host = (host_arrays(merged)
                if self.epoch_ring is not None or self._reshipper is not None else None)
        if self.epoch_ring is not None:
            self.epoch_ring.append_host(epoch, host, float(snaps[0].window_s), dict(seeds))
        if self._reshipper is not None:
            # The merged arrays are a valid node snapshot (the algebra is
            # closed under merge): the next tier ingests this aggregator as
            # one big node.
            self._reshipper.offer(epoch, host, float(snaps[0].window_s), dict(seeds),
                                  seed_gen=gen)
            m.fleet_rollups_reshipped.inc()
        rollup = self._rollup(epoch, snaps, merged, seeds)
        rollup["straggled"] = straggled
        rollup["seed_gen"] = gen
        rollup["merge_seconds"] = time.monotonic() - t0
        self._publish(rollup)
        rec.record(mn.STAGE_AGG_MERGE, span_t0, trace_id)
        m.fleet_windows_merged.inc()
        if straggled:
            m.fleet_windows_stragglers.inc()
        m.fleet_merge_seconds.set(rollup["merge_seconds"])
        with self._lock:
            self.epochs_merged += 1
            self.stragglers += int(straggled)
            self.rollups.append(rollup)
            del self.rollups[:-self.rollups_keep]

    # -- the rollup -----------------------------------------------------------
    def _cluster_topk(self, fam: str, snaps: list[FleetSnapshot],
                      merged: dict[str, torch.Tensor], seeds: dict[str, int], k: int,
                      candidates: np.ndarray | None = None,
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k of the candidate set counted by the summed CMS (K10).
        ``candidates`` defaults to the union of every node's candidate
        tables; with invertible state the caller passes the decoded keys."""
        if candidates is not None:
            cand = [candidates.astype(np.uint32).reshape(-1, 4)]
        else:
            cand = []
            for s in snaps:
                keys = s.arrays.get(f"{fam}_keys")
                counts = s.arrays.get(f"{fam}_counts")
                if keys is None or counts is None:
                    continue
                cand.append(keys[counts > 0])
        if not cand:
            return np.zeros((0, 0), np.uint32), np.zeros((0,), np.uint64)
        union = np.unique(np.concatenate(cand, axis=0), axis=0)
        if not len(union):
            return union, np.zeros((0,), np.uint64)
        cms = CountMinSketch(table=merged[f"{fam}_cms"], seed=int(seeds.get(fam, 0)))
        u = from_numpy(union, self.device)
        est = to_numpy(cms.query([u[:, c] for c in range(u.shape[1])])).astype(np.uint64)
        order = np.argsort(est)[::-1][:k]
        sel = est[order] > 0
        return union[order][sel], est[order][sel]

    def _invertible_decode(self, merged: dict[str, torch.Tensor], seeds: dict[str, int],
                           ) -> dict[str, Any] | None:
        """Cluster-wide heavy keys decoded from the merged invertible
        arrays, verified against the merged flow CMS: ``keys``, ``est``,
        ``tier`` sorted descending and ``sources`` = (src_ips, packets)."""
        if "inv_flow_planes" not in merged or "flow_cms" not in merged:
            return None
        cms = CountMinSketch(table=merged["flow_cms"], seed=int(seeds.get("flow", 0)))
        return decode_regions(merged, seeds, cms)

    def _rollup(self, epoch: int, snaps: list[FleetSnapshot],
                merged: dict[str, torch.Tensor], seeds: dict[str, int]) -> dict:
        cfg = self.cfg
        k = int(cfg.fleet_topk_k)
        rollup: dict[str, Any] = {
            "epoch": epoch,
            "nodes": [s.node for s in snaps],
            "window_s": snaps[0].window_s,
        }
        inv = None
        if "inv_flow_planes" in merged:
            try:
                inv = self._invertible_decode(merged, seeds)
            except Exception:  # counted, as the reference does; the rollup goes on
                self._count_error("invertible_decode_failed")
                if rate_limited("fleet.invdec"):
                    self.log.exception("fleet invertible decode failed")
        if inv is not None:
            rollup["invertible"] = inv
        inv_keys = inv["keys"] if inv is not None and len(inv["keys"]) else None
        for fam in HH_FAMILIES:
            if f"{fam}_cms" not in merged:
                continue
            rollup[f"top_{fam}"] = self._cluster_topk(
                fam, snaps, merged, seeds, k, candidates=inv_keys if fam == "flow" else None)
        if "hll_src_per_pod" in merged:
            est = HyperLogLog(registers=merged["hll_src_per_pod"],
                              seed=int(seeds.get("hll_src_per_pod", 0))).estimate().cpu().numpy()
            top = np.argsort(est)[::-1][: int(cfg.fleet_service_top)]
            rollup["service_cardinality"] = [(int(i), float(est[i])) for i in top
                                             if est[i] >= 1.0]
        if "hll_flows" in merged:
            rollup["distinct_flows"] = cardinality(merged["hll_flows"],
                                                   int(seeds.get("hll_flows", 0)))
        if "entropy" in merged:
            rollup["entropy_bits"] = entropy_bits_by_dim(merged["entropy"],
                                                         int(seeds.get("entropy", 0)))
        if "totals" in merged:
            rollup["totals"] = to_numpy(merged["totals"])
        rollup["tenants"] = self._tenant_rollups(snaps, seeds, inv_keys=inv_keys)
        return rollup

    def _tenant_rollups(self, snaps: list[FleetSnapshot], seeds: dict[str, int],
                        inv_keys: np.ndarray | None = None) -> dict[str, dict]:
        """Per-tenant flow top-k under the guardrails: at most
        ``fleet_max_tenants`` tenants (lowest priority shed first), at most
        ``fleet_tenant_series_max`` series each. A tenant's flow CMS is the
        K8 sum of its nodes' tables."""
        cfg = self.cfg
        by_tenant: dict[str, list[FleetSnapshot]] = {}
        prio: dict[str, int] = {}
        for s in snaps:
            by_tenant.setdefault(s.tenant, []).append(s)
            prio[s.tenant] = max(prio.get(s.tenant, s.priority), s.priority)
        ranked = sorted(by_tenant, key=lambda t: (-prio[t], t))
        kept = ranked[: max(0, int(cfg.fleet_max_tenants))]
        m = get_metrics()
        for t in ranked[len(kept):]:
            m.fleet_tenants_shed.inc()
            if rate_limited("fleet.tenant_shed"):
                self.log.warning("fleet: tenant %s shed (priority %d, budget %d)",
                                 t, prio[t], cfg.fleet_max_tenants)
        cap = max(1, int(cfg.fleet_tenant_series_max))
        out: dict[str, dict] = {}
        for tenant in kept:
            group = [s for s in by_tenant[tenant] if "flow_cms" in s.arrays]
            if not group:
                continue
            merged_cms = fold_stacked(stack_slots([s.arrays for s in group], ["flow_cms"],
                                                  self.device))
            keys, counts = self._cluster_topk("flow", by_tenant[tenant], merged_cms, seeds,
                                              min(int(cfg.fleet_topk_k), cap),
                                              candidates=inv_keys)
            if len(keys) > cap:  # defense in depth; min() above caps
                self.series_capped += len(keys) - cap
                m.fleet_series_capped.inc(len(keys) - cap)
                keys, counts = keys[:cap], counts[:cap]
            out[tenant] = {
                "priority": prio[tenant],
                "top_flows": (keys, counts),
                "nodes": [s.node for s in by_tenant[tenant]],
            }
        with self._lock:
            self.tenants_shed += len(ranked) - len(kept)
        return out

    # -- publication ----------------------------------------------------------
    def _publish(self, rollup: dict) -> None:
        """The epoch's ``fleet_*`` gauges, then the rollup on
        ``ROLLUP_TOPIC``. Keyed gauges are cleared and set again each epoch,
        so the exported label space never exceeds this epoch's (capped)
        series."""
        m = get_metrics()
        m.fleet_nodes_reporting.set(len(rollup["nodes"]))
        m.fleet_top_flows.clear()
        m.fleet_tenant_top_flows.clear()
        m.fleet_service_cardinality.clear()
        m.fleet_tenant_series.clear()
        m.fleet_invertible_sources.clear()
        inv = rollup.get("invertible")
        if inv is not None:
            m.fleet_invertible_keys.set(float(len(inv["keys"])))
            srcs, spk = inv["sources"]
            cap = max(0, int(self.cfg.fleet_topk_k))
            for ip, pk in zip(srcs[:cap], spk[:cap]):
                m.fleet_invertible_sources.labels(key=f"{int(ip):08x}").set(float(pk))
        pair = rollup.get("top_flow")
        if pair is not None:
            for row, count in zip(*pair):
                m.fleet_top_flows.labels(key=format_key(row)).set(float(count))
        for idx, est in rollup.get("service_cardinality", ()):
            m.fleet_service_cardinality.labels(service=f"pod{idx}").set(est)
        for dim, bits in rollup.get("entropy_bits", {}).items():
            m.fleet_entropy_bits.labels(dimension=dim).set(bits)
        if "distinct_flows" in rollup:
            m.fleet_distinct_flows.set(rollup["distinct_flows"])
        for tenant, tr in rollup["tenants"].items():
            keys, counts = tr["top_flows"]
            for row, count in zip(keys, counts):
                m.fleet_tenant_top_flows.labels(tenant=tenant, key=format_key(row)).set(
                    float(count))
            m.fleet_tenant_series.labels(tenant=tenant).set(len(keys))
        get_pubsub().publish(ROLLUP_TOPIC, rollup)

    # -- observability --------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = {
                "watermark": self._watermark,
                "open_epochs": sorted(self._buckets),
                "ready_q": len(self._ready_q),
                "epochs_merged": self.epochs_merged,
                "generations": sorted(self._gen_refs),
                "nodes_last": self.rollups[-1]["nodes"] if self.rollups else [],
            }
        if self._reshipper is not None:
            out["reship"] = self._reshipper.stats()
        return out
