"""SketchEngine: one node agent's feed path on one card (port of retina_tpu/engine.py).

A flush quantum of raw record blocks goes through the reference engine's
feed path, synchronously:

1. ``_build_quantum``: combine identical descriptors
   (``parallel/combine.py``, native), cut the rows into chunks of
   ``batch_capacity * feed_coalesce_windows`` and partition each
   (``parallel/partition.py``, one card: a (1, B, 16) batch);
2. ``_dispatch_sharded`` per chunk: with the flow dictionary
   (``parallel/flowdict.py``) and at least ``transfer_min_bucket`` rows,
   ``_dispatch_flowdict`` splits the rows into new descriptors and known
   flows and builds the 13-lane new wire and the v4 dense (or v3) known
   wire (``parallel/wire.py``, native); otherwise, and always with
   ``heavy_keys_source="invertible"``, the rows cross as the packed wire;
3. one host-to-card copy per side, of the wire alone; the flush's base
   timestamp, TS_REL flag, ``now_s`` and losses go to the kernels and the
   step as scalars;
4. ``_ingest``, ``_ingest_new`` and ``_ingest_known`` (kernel K7,
   ``kernels/csrc/ingest.cu``) turn the wire back into (capacity, 16)
   windows; the new side runs first, because known rows may name ids
   first assigned in the same flush;
5. ``Telemetry.step`` per window; host losses fold into the first step
   of the flush only.

``close_window`` closes the window in the reference's order: with the
time-travel ring or the fleet tier on, it first copies the window's
sketches (``Telemetry.fleet_export``) and offers them to the engine's
``SnapshotRing`` (``timetravel_ring``) and, with ``fleet_enabled``, returns
them for the caller to encode; then the invertible decode; then
``end_window``, whose anomaly flags go to ``anomaly_hook``.

The two hooks of the reference engine close the detection loop:
``record_hook(records, now_s)`` sees every block ``_dispatch`` steps and
every quantum's post-combine rows in ``_build_quantum``, before
partitioning (the detector bank's tap); ``anomaly_hook(epoch, dims)``
gets the flagged entropy dims at each close (``AutoCapture.notify``). A
hook that raises is counted in ``errors`` under its name and never
propagates. ``snapshot`` reads the state back in one copy
(``Telemetry.snapshot_host``). The method names are the reference's, so
each has its counterpart there. Left out, for later
slices: the threads (feed loop, feed pool, dispatch worker, device proxy),
the supervisor, metrics, the flight recorder, AOT caches, checkpoints, the
harvest lane and overload control (the sampler stays at NOMINAL: k = 1, no
row dropped), and multi-card partitioning.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.config import Config
from retina_tpu_torch.events.schema import F
from retina_tpu_torch.fleet.shipper import window_epoch
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models.identity import HostIdentityTable, IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig, PipelineState
from retina_tpu_torch.parallel.combine import combine_blocks
from retina_tpu_torch.parallel.flowdict import make_flow_dict
from retina_tpu_torch.parallel.partition import ShardedBatch, _next_bucket, partition_events
from retina_tpu_torch.parallel.telemetry import Telemetry
from retina_tpu_torch.parallel.wire import (
    DENSE_BY_BITS,
    DENSE_PK_BITS,
    PACKED_FIELDS,
    batch_ts_base,
    dense_words,
    pack_records,
)
from retina_tpu_torch.timetravel.ring import SnapshotRing

_log = logging.getLogger("retina_tpu_torch.engine")

# The entropy groups of end_window's anomaly flags, in order.
ANOMALY_DIMS = ("src_ip", "dst_ip", "dst_port")


def pipeline_config_from(cfg: Config) -> PipelineConfig:
    return PipelineConfig(
        n_pods=cfg.n_pods,
        cms_width=cfg.cms_width,
        cms_depth=cfg.cms_depth,
        topk_slots=cfg.topk_slots,
        hll_precision=cfg.hll_precision,
        entropy_buckets=cfg.entropy_buckets,
        conntrack_slots=cfg.conntrack_slots,
        enable_conntrack=cfg.enable_conntrack_metrics,
        bypass_filter=cfg.bypass_lookup_ip_of_interest or not cfg.enable_pod_level,
        # Annotation opt-in: only the filter map decides interest.
        identity_implies_interest=not cfg.enable_annotations,
        # Low aggregation needs conntrack reports to drive the sketches.
        data_aggregation_level=(
            cfg.data_aggregation_level if cfg.enable_conntrack_metrics else "high"
        ),
        enable_invertible=cfg.heavy_keys_source in ("invertible", "both"),
        inv_depth=cfg.invertible_depth,
        inv_width=cfg.invertible_width,
        inv_hi_width=cfg.invertible_hi_width,
        priority_ip_mask=cfg.overload_priority_ip_mask,
        priority_ip_match=cfg.overload_priority_ip_match,
    )


class FeedStages:
    """Time of the feed path per stage. Host stages use the host clock;
    card stages (``CARD``) use CUDA events on a card and the host clock on
    the CPU. A card span is folded into the totals once its end event has
    completed, so at most ``MAX_PENDING`` pairs of events are held."""

    HOST = ("combine", "partition", "dict and wire")
    CARD = ("copy", "ingest", "steps")
    MAX_PENDING = 64

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self.reset()

    def reset(self) -> None:
        self._s = dict.fromkeys(self.HOST + self.CARD, 0.0)
        self._events: collections.deque = collections.deque()

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        if self._cuda and name in self.CARD:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            yield
            e1.record()
            self._events.append((name, e0, e1))
            self._fold(wait=False)
        else:
            t0 = time.perf_counter()
            yield
            self._s[name] += time.perf_counter() - t0

    def _fold(self, wait: bool) -> None:
        """Add finished card spans to the totals, oldest first; wait for the
        card when ``wait`` or when more than ``MAX_PENDING`` are held."""
        ev = self._events
        while ev and (wait or len(ev) > self.MAX_PENDING or ev[0][2].query()):
            name, e0, e1 = ev.popleft()
            e1.synchronize()
            self._s[name] += e0.elapsed_time(e1) / 1e3

    def seconds(self) -> dict[str, float]:
        """Seconds per stage since the last reset (waits for the card)."""
        self._fold(wait=True)
        return dict(self._s)


@dataclasses.dataclass
class FeedCounts:
    """What the feed path moved since the engine started."""

    events: int = 0  # raw events fed
    steps: int = 0
    wire_bytes: int = 0  # bytes copied to the card
    new_rows: int = 0
    known_rows: int = 0
    packed_rows: int = 0


class SketchEngine:
    """The feed path and the state of one node agent on one card."""

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        cfg.validate()
        self.cfg = cfg
        self.pcfg = pipeline_config_from(cfg)
        self.device = resolve_device(device)
        self.telemetry = Telemetry(self.pcfg, self.device)
        self.state: PipelineState = self.telemetry.init_state()
        if cfg.host_combine_threads > 0:
            from retina_tpu_torch.native import set_combine_threads

            set_combine_threads(cfg.host_combine_threads)
        # The flow dictionary; heavy_keys_source="invertible" takes it off
        # the path and every flush ships packed full rows.
        self._flow_dict = (
            make_flow_dict(cfg.flow_dict_slots)
            if cfg.transfer_packed and cfg.wire_flow_dict
            and cfg.heavy_keys_source != "invertible"
            else None
        )
        # v3 known rows: [id | packets << id_bits, bytes]; v4: dense rows
        # of id_bits + 10 + 22 bits. Rows the narrow lanes cannot carry
        # exactly escalate to the new side (see _dispatch_flowdict).
        self._fd_id_bits = max(1, (cfg.flow_dict_slots - 1).bit_length())
        self._fd_pk_bits = 32 - self._fd_id_bits
        self._fd_dense = bool(cfg.wire_dense_known)
        # The card's descriptor table (slots, 12) and K7's per-slot claim
        # scratch, made on the card at first use and after a resync.
        self._desc_table: torch.Tensor | None = None
        self._desc_winner: torch.Tensor | None = None
        # Bumped by failure resyncs only (not by capacity clears).
        self._fd_epoch = 0

        self.ident = IdentityMap.zeros(cfg.identity_slots, device=self.device)
        self.filter_map = IdentityMap.zeros(cfg.identity_slots, seed=99, device=self.device)
        self.apiserver_ip = 0
        self._ident_host = HostIdentityTable(n_slots=cfg.identity_slots)
        self._ident_dict: dict[int, int] = {}
        # Entries dropped from overfull identity and filter maps.
        self.lost_table_entries = {"identity": 0, "filter": 0}
        self.stages = FeedStages(self.device)
        self.counts = FeedCounts()
        # The detection loop's hooks (see the module docstring) and the
        # failures they raised, by hook.
        self.record_hook: Callable[[np.ndarray, int], Any] | None = None
        self.anomaly_hook: Callable[[int, list[str]], Any] | None = None
        self.errors: collections.Counter = collections.Counter()
        self._tt_ring: SnapshotRing | None = None
        if cfg.timetravel_enabled:
            self._tt_ring = SnapshotRing(cfg.timetravel_ring_windows, name="engine")
            self._tt_ring.start()

    @property
    def timetravel_ring(self) -> SnapshotRing | None:
        """The ring of this engine's window-close exports (None unless
        ``timetravel_enabled``)."""
        return self._tt_ring

    def stop(self) -> None:
        """Stop the ring's readback thread."""
        if self._tt_ring is not None:
            self._tt_ring.stop()

    # -- identity / filter wiring ---------------------------------------
    def update_identities(self, ip_to_index: dict[int, int]) -> None:
        """Reconcile the identity table to ``ip_to_index``: apply the
        changed keys to the host cuckoo table, then upload it once. An
        overfull map keeps the lowest IPs and counts the rest."""
        new = {ip: idx for ip, idx in ip_to_index.items() if ip != 0}
        if len(new) > self._ident_host.capacity:
            self.lost_table_entries["identity"] += len(new) - self._ident_host.capacity
            new = {ip: new[ip] for ip in sorted(new)[: self._ident_host.capacity]}
        old = self._ident_dict
        for ip in old.keys() - new.keys():
            self._ident_host.remove(ip)
        for ip, idx in new.items():
            if old.get(ip) != idx:
                self._ident_host.insert(ip, idx)
        self._ident_dict = new
        self.ident = self._ident_host.to_device(self.device)

    def update_filter_ips(self, ips: set[int]) -> None:
        """Replace the IPs-of-interest map; an overfull set keeps the
        lowest IPs and counts the rest."""
        host = HostIdentityTable(n_slots=self.cfg.identity_slots, seed=99)
        live = sorted(ip for ip in ips if ip)
        if len(live) > host.capacity:
            self.lost_table_entries["filter"] += len(live) - host.capacity
            live = live[: host.capacity]
        for ip in live:
            host.insert(ip, 1)
        self.filter_map = host.to_device(self.device)

    def set_apiserver_ips(self, ips: list[int]) -> None:
        self.apiserver_ip = ips[0] if ips else 0

    # -- the feed path ---------------------------------------------------
    def step_records(self, records: np.ndarray, now_s: int | None = None) -> None:
        """Feed one host block (no combining), as the reference's
        ``step_records`` does."""
        self._dispatch(records, now_s or int(time.time()))

    def _call_hook(self, name: str, *args) -> None:
        """Call a hook; a failure is logged and counted, never raised."""
        hook = getattr(self, name)
        if hook is None:
            return
        try:
            hook(*args)
        except Exception:
            self.errors[name] += 1
            _log.exception("%s failed", name)

    def _dispatch(self, records: np.ndarray, now_s: int) -> None:
        self._call_hook("record_hook", records, now_s)
        with self.stages("partition"):
            sb = partition_events(records, 1, self.cfg.batch_capacity,
                                  min_bucket=self.cfg.transfer_min_bucket)
        self._dispatch_sharded(sb, now_s, n_raw=len(records))

    def flush(self, blocks: list[np.ndarray], now_s: int) -> None:
        """One flush of the feed loop: ``_build_quantum`` over the blocks,
        then ``_dispatch_sharded`` for each item."""
        n_raw = sum(len(b) for b in blocks)
        for _, sb, now, n in self._build_quantum(blocks, n_raw, now_s):
            self._dispatch_sharded(sb, now, n)

    def _build_quantum(self, blocks: list[np.ndarray], n_raw: int, now_s: int,
                       ) -> list[tuple]:
        """Combine + partition one flush quantum into ("step", batch, now_s,
        n_raw) items of at most ``batch_capacity * feed_coalesce_windows``
        rows. The overload sampler sits at NOMINAL: k = 1."""
        coal = self.cfg.batch_capacity * max(1, self.cfg.feed_coalesce_windows)
        with self.stages("combine"):
            if self.cfg.host_combine:
                all_rec = combine_blocks(blocks)
            elif len(blocks) == 1:
                all_rec = blocks[0]
            else:
                all_rec = np.concatenate(blocks, axis=0)
        self._call_hook("record_hook", all_rec, now_s)
        items: list[tuple] = []
        with self.stages("partition"):
            for off in range(0, len(all_rec), coal):
                sb = partition_events(all_rec[off: off + coal], 1, coal,
                                      min_bucket=self.cfg.transfer_min_bucket)
                # Raw-row accounting goes to the chunk that carries it.
                items.append(("step", sb, now_s, n_raw if off == 0 else 0))
        return items

    def _wire_bucket(self, n_max: int) -> int:
        cap_total = self.cfg.batch_capacity * max(1, self.cfg.feed_coalesce_windows)
        return min(_next_bucket(max(n_max, self.cfg.transfer_min_bucket)), cap_total)

    def _flowdict_resync(self) -> None:
        """Invalidate the host dictionary and the card's table together
        after a failure that may have desynced them."""
        self._flow_dict.clear()
        self._fd_epoch += 1
        self._desc_table = None
        self._desc_winner = None

    def _ensure_desc_table(self) -> torch.Tensor:
        """The card's descriptor table, zeros made on the card (never
        uploaded), with K7's claim scratch beside it."""
        if self._desc_table is None:
            slots = self.cfg.flow_dict_slots
            self._desc_table = torch.zeros((slots, PACKED_FIELDS), dtype=torch.int32,
                                           device=self.device)
            self._desc_winner = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        return self._desc_table

    def _to_card(self, wire: np.ndarray) -> torch.Tensor:
        """One host-to-card copy of a u32 wire array (int32 bit patterns)."""
        self.counts.wire_bytes += wire.nbytes
        return torch.from_numpy(wire.view(np.int32)).to(self.device)

    def _slice_windows(self, buf: torch.Tensor, n_valid: int, bucket: int,
                       ) -> list[tuple[torch.Tensor, int]]:
        """(n_win * cap, 16) windows buffer -> [(window, its n_valid)], the
        reference's slice-and-clip over the bucket."""
        cap = self.cfg.batch_capacity
        out = []
        for w in range(max(1, -(-bucket // cap))):
            lo = w * cap
            hi = min(lo + cap, bucket)
            out.append((buf[lo: lo + cap], min(max(n_valid - lo, 0), hi - lo)))
        return out

    def _n_out(self, bucket: int) -> int:
        cap = self.cfg.batch_capacity
        return max(1, -(-bucket // cap)) * cap

    def _ingest(self, bucket: int, packed: bool, wire: torch.Tensor, base_lo: int,
                base_hi: int, n_valid: int) -> list[tuple[torch.Tensor, int]]:
        """The packed (or 16-lane) wire -> step windows (K7 ingest_packed)."""
        buf = kops.ingest_packed(wire, packed, base_lo, base_hi, self._n_out(bucket))
        return self._slice_windows(buf, n_valid, bucket)

    def _ingest_new(self, bucket: int, wire: torch.Tensor, base_lo: int, base_hi: int,
                    n_valid: int) -> list[tuple[torch.Tensor, int]]:
        """The new wire -> descriptors into the table, and step windows
        (K7 ingest_new)."""
        table = self._ensure_desc_table()
        buf = kops.ingest_new(wire, table, self._desc_winner, base_lo, base_hi,
                              self._n_out(bucket))
        return self._slice_windows(buf, n_valid, bucket)

    def _ingest_known(self, bucket: int, wire: torch.Tensor, ts_rel: int, base_lo: int,
                      base_hi: int, n_valid: int) -> list[tuple[torch.Tensor, int]]:
        """The known wire + the resident table -> step windows (K7
        ingest_known)."""
        buf = kops.ingest_known(wire, bucket, self._fd_dense, self._fd_id_bits,
                                self._ensure_desc_table(), ts_rel, base_lo, base_hi,
                                self._n_out(bucket))
        return self._slice_windows(buf, n_valid, bucket)

    def _step_windows(self, sides: list, now_s: int, lost: int, sample_k: int) -> None:
        """Step every window of every side in order; host losses fold into
        the first step only."""
        first = True
        with self.stages("steps"):
            for wins in sides:
                for rec, n_valid in wins:
                    self.state, _ = self.telemetry.step(
                        self.state, rec, n_valid, now_s, self.ident, self.apiserver_ip,
                        filter_map=self.filter_map, lost=lost if first else 0,
                        sample_k=sample_k)
                    first = False
                    self.counts.steps += 1

    def _dispatch_flowdict(self, sb: ShardedBatch, now_s: int, n_raw: int) -> None:
        """Split the batch into new-descriptor rows (13-lane upload + table
        insert) and known rows (a few bytes each against the resident
        table). Known rows the narrow lanes cannot carry exactly escalate
        to the new side (re-writing a resident descriptor is harmless)."""
        from retina_tpu_torch.native import flowwire_dense_native, flowwire_native

        with self.stages("dict and wire"):
            nv = int(sb.n_valid[0])
            rows = np.ascontiguousarray(sb.records[0, :nv])
            ids, is_new = self._flow_dict.lookup_or_assign(rows)
            base = batch_ts_base(sb.records)
            dense = self._fd_dense
            pk_cap = 1 << (DENSE_PK_BITS if dense else self._fd_pk_bits)
            # Escalate: new descriptors, packet counts over the lane,
            # TSval/TSecr carriers (the latency match needs their exact
            # send time) and unstamped rows (TS_REL 0 must round-trip);
            # on the dense wire also bytes over the 22-bit lane.
            sel = (
                is_new
                | (rows[:, F.PACKETS] >= pk_cap)
                | ((rows[:, F.TSVAL] | rows[:, F.TSECR]) != 0)
                | ((rows[:, F.TS_LO] | rows[:, F.TS_HI]) == 0)
            )
            if dense:
                sel |= rows[:, F.BYTES] >= (1 << DENSE_BY_BITS)
            n_new = int(sel.sum())
            n_known = nv - n_new
            bn, bk = self._wire_bucket(n_new), self._wire_bucket(n_known)
            if n_new > bn or n_known > bk:
                # Dropping new rows would leave registered descriptors that
                # never reach the table: fail; the caller resyncs.
                raise RuntimeError(
                    f"flow-dict wire overflow: {n_new}/{bn} new, {n_known}/{bk} known rows")
            new_wire = np.zeros((bn, 13), np.uint32)
            known_wire = np.zeros(
                (dense_words(bk, self._fd_id_bits),) if dense else (bk, 2), np.uint32)
            if nv:
                build = flowwire_dense_native if dense else flowwire_native
                lanes = (DENSE_PK_BITS, DENSE_BY_BITS) if dense else ()
                got = build(rows, ids, sel.astype(np.uint8), int(base), self._fd_id_bits,
                            *lanes, new_wire, known_wire)
                if got != n_new:
                    raise RuntimeError(f"flow wire build wrote {got} new rows, expected {n_new}")
            base_lo, base_hi = int(base) & 0xFFFFFFFF, int(base) >> 32
            # Known rows' TS_REL: the flush base itself (1), or 0 when the
            # flush is unstamped.
            ts_flag = 1 if int(base) > 0 else 0
        if not (n_new or n_known):
            return  # nothing valid
        with self.stages("copy"):
            new_dev = self._to_card(new_wire) if n_new else None
            known_dev = self._to_card(known_wire) if n_known else None
        sides = []
        with self.stages("ingest"):
            if n_new:
                sides.append(self._ingest_new(bn, new_dev, base_lo, base_hi, n_new))
            if n_known:
                sides.append(self._ingest_known(bk, known_dev, ts_flag, base_lo, base_hi,
                                                n_known))
        self._step_windows(sides, now_s, sb.lost, sb.sample_k)
        self.counts.new_rows += n_new
        self.counts.known_rows += n_known
        self.counts.events += n_raw

    def _dispatch_sharded(self, sb: ShardedBatch, now_s: int, n_raw: int) -> None:
        """Wire build, copy, ingest and step for one partitioned batch.

        With the flow dictionary and at least ``transfer_min_bucket`` rows
        the batch takes the dictionary wire; a smaller flush is cheaper as
        one packed transfer and leaves the dictionary untouched."""
        if self._flow_dict is not None and int(sb.n_valid.sum()) >= self.cfg.transfer_min_bucket:
            try:
                self._dispatch_flowdict(sb, now_s, n_raw)
            except Exception:
                # A failure after lookup_or_assign may leave descriptors
                # registered whose lanes never reached the table: rebuild
                # both sides, then report the failure.
                self._flowdict_resync()
                raise
            return
        with self.stages("dict and wire"):
            n_valid = int(sb.n_valid[0])
            if self.cfg.transfer_packed:
                wire, b_lo, b_hi = pack_records(np.ascontiguousarray(sb.records[0]))
                packed = True
            else:
                wire, b_lo, b_hi = np.ascontiguousarray(sb.records[0]), 0, 0
                packed = False
        bucket = wire.shape[0]
        with self.stages("copy"):
            wire_dev = self._to_card(wire)
        with self.stages("ingest"):
            wins = self._ingest(bucket, packed, wire_dev, int(b_lo), int(b_hi), n_valid)
        self._step_windows([wins], now_s, sb.lost, sb.sample_k)
        self.counts.packed_rows += n_valid
        self.counts.events += n_raw

    # -- window close and scrape ------------------------------------------
    def close_window(self, z_thresh: float = 4.0, epoch: int | None = None) -> dict:
        """Close the entropy window: ``end_window``'s outputs, and with the
        invertible sketch its verified decode under ``"inv"``. With the
        ring or the fleet tier on, the window's export (copies taken before
        ``end_window``) goes to the ring and, with ``fleet_enabled``, under
        ``"export"`` as ``(epoch, arrays, window_s, seeds)``. ``epoch``
        defaults to ``window_epoch(window_seconds)``, the wall clock's
        window; ``anomaly_hook`` gets the same epoch (the reference passes
        the wall clock's)."""
        out: dict = {}
        cfg = self.cfg
        epoch = window_epoch(cfg.window_seconds) if epoch is None else int(epoch)
        if cfg.timetravel_enabled or cfg.fleet_enabled:
            export = self.telemetry.fleet_export(self.state)
            seeds = self.telemetry.fleet_seeds(self.state)
            if self._tt_ring is not None:
                self._tt_ring.offer(epoch, export, cfg.window_seconds, seeds)
            if cfg.fleet_enabled:
                out["export"] = (epoch, export, cfg.window_seconds, seeds)
        if self.pcfg.enable_invertible:
            out["inv"] = self.telemetry.inv_decode(self.state, self.cfg.invertible_min_weight)
        self.state, win = self.telemetry.end_window(self.state, z_thresh)
        out.update(win)
        if self.anomaly_hook is not None:
            flags = win["anomaly"].tolist()
            flagged = [d for d, f in zip(ANOMALY_DIMS, flags) if f]
            if flagged:
                self._call_hook("anomaly_hook", epoch, flagged)
        return out

    def snapshot(self, now_s: int) -> dict:
        """The scrape-time readout of the current state, read back to the
        host in one copy (CPU tensors)."""
        return self.telemetry.snapshot_host(self.state, now_s)
