"""SketchEngine: one node agent's feed path and runtime lanes on one card
(port of retina_tpu/engine.py).

A flush quantum of raw record blocks goes through the reference engine's
feed path:

1. ``_build_quantum``: combine identical descriptors
   (``parallel/combine.py``, native), sample them under overload
   (``runtime/overload.py``: at NOMINAL every row, k = 1), cut the rows into
   chunks of ``batch_capacity * feed_coalesce_windows`` and partition each
   (``parallel/partition.py``, one card: a (1, B, 16) batch);
2. ``_dispatch_sharded`` per chunk: with the flow dictionary
   (``parallel/flowdict.py``) and at least ``transfer_min_bucket`` rows,
   ``_dispatch_flowdict`` splits the rows into new descriptors and known
   flows and builds the 13-lane new wire and the v4 dense (or v3) known
   wire (``parallel/wire.py``, native); otherwise, and always with
   ``heavy_keys_source="invertible"``, the rows cross as the packed wire.
   The wires are built in pinned host staging buffers;
3. on the device proxy (``utils/device_proxy.py``: one thread that owns the
   card's stream and runs every card call of the engine): one
   ``non_blocking`` host-to-card copy per side, of the wire alone; the
   flush's base timestamp, TS_REL flag, ``now_s`` and losses go to the
   kernels and the step as scalars;
4. ``_ingest``, ``_ingest_new`` and ``_ingest_known`` (kernel K7,
   ``kernels/csrc/ingest.cu``) turn the wire back into (capacity, 16)
   windows; the new side runs first, because known rows may name ids
   first assigned in the same flush;
5. ``Telemetry.step`` per window; host losses fold into the first step
   of the flush only.

``flush``, ``step_records`` and ``close_window`` run that path
synchronously (each card call through the proxy, the caller waiting).
``start(stop)`` runs it as the reference agent does, in lanes: the feed
loop drains the bounded ``sink`` (``plugins/api.py``), runs the observers
and, inline or through ``feed_workers`` threads (``parallel/feed.py``),
builds quanta; the one dispatch thread takes them through a
``TransferMux``, builds the wires and submits each dispatch to the proxy
without waiting (at most ``feed_pipeline_depth`` in flight); window ticks
take the mux's control lane and a close lane of their own
(``_submit_close_window``); the close copies its window's outputs to the
host asynchronously and the harvest thread (``_harvest_loop``) publishes
them in close order (``last_window``, the anomaly hook with the wall
clock's epoch). A close with no event since the last one is idle: it
publishes a zero window and does no export, ring offer, decode or
``end_window``. The overload controller ticks on the feed loop and samples
on the quantum builds (inline or the feed workers).

``close_window`` closes the window in the reference's order: with the
time-travel ring or the fleet tier on, it first copies the window's
sketches (``Telemetry.fleet_export``) and starts one copy of them to the
host (``to_host``), which goes to the engine's ``SnapshotRing``
(``timetravel_ring``) and, with ``fleet_enabled``, to the engine's
``SnapshotShipper`` (``fleet/shipper.py``: one export and one pinned copy
feed both, as the reference's one export does); ``close_window`` also
returns the export for the caller; then the invertible decode; then
``end_window``, whose anomaly flags go to ``anomaly_hook`` with the close's
epoch. The lanes' close offers to the ring and the shipper alike. A failed
export or offer counts ``fleet_ship_errors`` and ``errors["fleet_export"]``
and the close goes on. ``start(stop)`` starts the shipper's worker and
stops it after the last close (``close_window`` starts it too).

Crash-only supervision, as the reference's: with a ``Supervisor`` every
long-lived lane thread (``engine-feed``, ``engine-dispatch``,
``window-harvest``, the feed workers, ``engine-recover``) beats a heartbeat
and parks it around its waits; a hung harvest thread is superseded
(``_restart_harvest``). A fatal device error on an asynchronous dispatch or
close (``_fatal_device_error``: a CUDA error, an out-of-memory error, a
wrapper's launch error or an injected fault) puts the engine in degraded
mode: asynchronous dispatches drop and count under
``lost_events["degraded"]`` and closes defer, while the ``engine-recover``
thread fences the proxy, rebuilds the state on the card from the last
checkpoint (``snapshot_dir``) or zeros, probes with a zero-row dispatch
through the real copy, ingest and step, and resumes; retries follow the
restart policy, whose open circuit latches ``recovery_failed``. Checkpoints
(``save_snapshot_state``, ``load_snapshot_state``, ``checkpoint.py``) copy
the state to the host on the proxy, in order with the steps, and write
the file on the caller's thread. The flight recorder
(``obs/recorder.py``) takes the reference's spans (``wire_build``,
``transfer``, ``device_step``, ``window_close``, ``harvest``, ``publish``,
``combine``, ``generator_emit``, and the workers' ``feed_fill`` and
``staging_handoff``) into ``stage_seconds``.

The two hooks of the reference engine close the detection loop:
``record_hook(records, now_s)`` sees every block ``_dispatch`` steps and
every quantum's post-combine rows in ``_build_quantum``, before sampling
and partitioning (the detector bank's tap); ``anomaly_hook(epoch, dims)``
gets the flagged entropy dims of a close (``AutoCapture.notify``). A hook
or observer that raises is counted in ``errors`` under its name and never
propagates. ``snapshot`` reads the state back in one copy
(``Telemetry.snapshot_host``), cached for ``max_age_s``. The method names
are the reference's, so each has its counterpart there. The engine's own
accounting is plain counters (``errors``, ``lost_events``, ``windows``,
``lane_s``, ``feed_stats()``); the supervision series (``engine_restarts``,
``watchdog_stalls``, ``thread_restarts``, ``degraded_mode``,
``recovery_seconds``, ``stage_seconds``) are the registry's
(``metrics.get_metrics()``), with the boot's ``build_info``, the
``uptime_seconds`` the window publish ticks and ``windows_closed``.

``compile()`` is the daemon's boot step (``managers/controllermanager.py``
owns the engine, the supervisor and the periodic checkpointer): it builds
the kernels and runs the boot dispatches before the agent reports ready.
Left out, for later slices: multi-card partitioning, and the background
warm and AOT caches: torch compiles nothing ahead of time, so a cold close
never defers (``windows["deferred"]`` counts closes refused because both
close slots were in flight, and closes during a recovery).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
import queue as queue_mod
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.config import Config
from retina_tpu_torch.convert import tensor_leaves
from retina_tpu_torch.events.schema import NUM_FIELDS, VERDICT_FORWARDED, F
from retina_tpu_torch.fleet.shipper import SnapshotShipper, window_epoch
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.models.identity import HostIdentityTable, IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig, PipelineState
from retina_tpu_torch.obs.recorder import FlightRecorder, initialize_recorder
from retina_tpu_torch.parallel.combine import combine_blocks
from retina_tpu_torch.parallel.feed import FeedWorkerPool, TransferMux, TransferQueue
from retina_tpu_torch.parallel.flowdict import flow_dict_stats, make_flow_dict
from retina_tpu_torch.parallel.partition import ShardedBatch, _next_bucket, partition_events
from retina_tpu_torch.parallel.telemetry import Telemetry, topk_from_snapshot
from retina_tpu_torch.parallel.wire import (
    DENSE_BY_BITS,
    DENSE_PK_BITS,
    PACKED_FIELDS,
    batch_ts_base,
    dense_words,
    pack_records,
)
from retina_tpu_torch.plugins.api import QueueSink
from retina_tpu_torch.runtime import faults
from retina_tpu_torch.runtime.overload import OverloadController
from retina_tpu_torch.runtime.supervisor import Heartbeat, Supervisor, policy_from_config
from retina_tpu_torch.timetravel.ring import SnapshotRing
from retina_tpu_torch.u32 import to_numpy
from retina_tpu_torch.utils import metric_names as mn
from retina_tpu_torch.utils.device_proxy import PinnedStaging, proxy_for, to_host

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


def zero_window() -> dict[str, np.ndarray]:
    """What an idle close publishes: a real empty close's outputs."""
    z = np.zeros((3,), np.float32)
    return {"entropy_bits": z, "anomaly": z, "zscore": z}


class FeedStages:
    """Time of the feed path per stage. Host stages use the host clock;
    card stages (``CARD``) use CUDA events on a card and the host clock on
    the CPU. A card span is folded into the totals once its end event has
    completed, so at most ``MAX_PENDING`` pairs of events are held. Stages
    run on several threads (feed workers, the dispatch thread, the proxy): the
    totals are summed under a lock, so a host stage of parallel workers
    counts each worker's seconds. With a flight recorder, the stages in
    ``SPANS`` also record the recorder's span of the same stretch (host
    clock), with the wall clock's window epoch as its trace id."""

    HOST = ("combine", "partition", "dict and wire")
    CARD = ("copy", "ingest", "steps")
    SPANS = {"combine": mn.STAGE_COMBINE, "dict and wire": mn.STAGE_WIRE_BUILD,
             "steps": mn.STAGE_DEVICE_STEP}
    MAX_PENDING = 64

    def __init__(self, device: torch.device, recorder: FlightRecorder | None = None,
                 window_s: float = 1.0):
        self._cuda = device.type == "cuda"
        self._lock = threading.Lock()
        self._recorder = recorder
        self._window_s = window_s
        self.reset()

    def reset(self) -> None:
        self._s = dict.fromkeys(self.HOST + self.CARD, 0.0)
        self._events: collections.deque = collections.deque()

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        if self._cuda and name in self.CARD:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            yield
            e1.record()
            t1 = time.perf_counter()
            with self._lock:
                self._events.append((name, e0, e1))
                self._fold(wait=False)
        else:
            yield
            t1 = time.perf_counter()
            with self._lock:
                self._s[name] += t1 - t0
        span = self.SPANS.get(name)
        if span is not None and self._recorder is not None:
            self._recorder.record(span, t0, window_epoch(self._window_s), t1=t1)

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
        with self._lock:
            self._fold(wait=True)
            return dict(self._s)


@dataclasses.dataclass
class FeedCounts:
    """What the feed path moved since the engine started."""

    events: int = 0  # raw events stepped
    steps: int = 0
    wire_bytes: int = 0  # bytes copied to the card
    new_rows: int = 0
    known_rows: int = 0
    packed_rows: int = 0


class SketchEngine:
    """The feed path, the lanes and the state of one node agent on one card."""

    def __init__(self, cfg: Config, device: torch.device | str | None = None,
                 supervisor: Supervisor | None = None):
        cfg.validate()
        self.cfg = cfg
        self._supervisor = supervisor
        # The flight recorder: rebuild the process singleton from the config
        # so every span site (here and the feed workers) shares its rings.
        self._recorder = initialize_recorder(
            capacity=cfg.trace_ring_spans, sample_every=cfg.trace_sample_every,
            enabled=cfg.trace_enabled)
        self.pcfg = pipeline_config_from(cfg)
        self.device = resolve_device(device)
        self.sink = QueueSink(max_blocks=1024)
        # Every card call of the engine runs on this device's proxy thread,
        # on its stream; the wires cross from the staging buffers.
        self._proxy = proxy_for(self.device)
        self._staging = PinnedStaging(self.device)
        self.telemetry = Telemetry(self.pcfg, self.device)
        self.state: PipelineState = self._proxy.run(self.telemetry.init_state)
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
        # The dictionary, its epoch and the ground truth are touched by the
        # dispatch thread and the proxy.
        self._fd_lock = threading.Lock()
        # The card's descriptor table (slots, 12) and K7's per-slot claim
        # scratch, made on the card at first use and after a resync.
        self._desc_table: torch.Tensor | None = None
        self._desc_winner: torch.Tensor | None = None
        # Bumped by failure resyncs only (not by capacity clears): a queued
        # batch from an older epoch names a table that no longer exists and
        # drops itself.
        self._fd_epoch = 0
        # heavy_keys_source="both": the host's per-key packet ground truth
        # (forward-verdict packets by flow key), cumulative like the
        # sketches; the harvest scores the invertible decode against it.
        self._hk_counts: dict | None = (
            {} if cfg.heavy_keys_source == "both" and self._flow_dict is not None else None
        )
        self._inv_lock = threading.Lock()
        self._inv_last: dict | None = None
        self.invertible_scores: dict[str, float] = {}  # recall, precision ("both")

        self.ident = IdentityMap.zeros(cfg.identity_slots, device=self.device)
        self.filter_map = IdentityMap.zeros(cfg.identity_slots, seed=99, device=self.device)
        self.apiserver_ip = 0
        self._ident_host = HostIdentityTable(n_slots=cfg.identity_slots)
        self._ident_dict: dict[int, int] = {}
        # Entries dropped from overfull identity and filter maps.
        self.lost_table_entries = {"identity": 0, "filter": 0}
        self.stages = FeedStages(self.device, self._recorder, cfg.window_seconds)
        self.counts = FeedCounts()
        # The detection loop's hooks (see the module docstring), the
        # observers (fn(records, plugin), name: the shed stage that skips
        # them) and the failures they raised, by site.
        self.record_hook: Callable[[np.ndarray, int], Any] | None = None
        self.anomaly_hook: Callable[[int, list[str]], Any] | None = None
        self._observers: list[tuple[Callable[[np.ndarray, str], None], str]] = []
        self._count_lock = threading.Lock()
        self.errors: collections.Counter = collections.Counter()
        # Events lost, by stage: "handoff" (no worker could stage a block),
        # "dispatch" (a dead dispatch thread, a failed build, a stale
        # epoch), "device" (a failed card call), "partition" (overflow).
        self.lost_events: collections.Counter = collections.Counter()
        # Closes: "closed", "idle" (of them), "deferred" (both close slots
        # in flight), "end_window" and "exports" (what a close ran).
        self.windows: collections.Counter = collections.Counter()
        # Busy seconds by lane: "feed", "build", "dispatch", "inflight_wait",
        # "proxy", "close", "harvest".
        self.lane_s: collections.Counter = collections.Counter()
        self._tt_ring: SnapshotRing | None = None
        if cfg.timetravel_enabled:
            self._tt_ring = SnapshotRing(cfg.timetravel_ring_windows, name="engine")
            self._tt_ring.start()

        # -- the lanes ------------------------------------------------------
        # Dispatches in flight on the proxy (the dispatch thread builds
        # batch N+1 while N crosses), and their count for the flush policy.
        self._inflight = threading.Semaphore(max(1, cfg.feed_pipeline_depth))
        self._busy_lock = threading.Lock()
        self._inflight_busy = 0
        # The protected close lane: two slots of its own, never the steps'.
        self._close_inflight = threading.Semaphore(2)
        self._closed_events_in = 0
        # Closed windows awaiting publication on the harvest thread, in
        # close order: ("win", HostCopy, meta), ("zero", None, meta), or
        # None to stop it. Window-cadence items, so unbounded.
        self._harvest_q: queue_mod.Queue = queue_mod.Queue()
        self._harvest_thread: threading.Thread | None = None
        self._harvest_lock = threading.Lock()
        self._harvest_retired = False
        self._harvest_gen = 0
        self.last_window: dict[str, Any] = {}
        self._feed_pool: FeedWorkerPool | None = None
        self._overload = OverloadController(cfg, self._overload_signals)
        # The fleet rollup tier: ship the window-close export to the
        # aggregator. offer() on the proxy never blocks the close; the
        # SHEDDING backoff reads the same controller.
        self._fleet_shipper: SnapshotShipper | None = None
        if cfg.fleet_enabled:
            self._fleet_shipper = SnapshotShipper(cfg, overload=self._overload,
                                                  supervisor=supervisor)
        self._ov_wait_prev = 0.0
        self._ov_wait_t = time.monotonic()
        self._dispatch_lat_ewma = 0.0  # seconds, on the proxy thread
        self._dispatch_lat_t = 0.0
        self._snap_lock = threading.Lock()
        self._snap_flight = threading.Lock()
        self._snap_cache: dict[str, Any] | None = None
        self._snap_time = 0.0
        self.started = threading.Event()
        # Crash-only recovery: while _degraded is set, asynchronous
        # dispatches drop and count (lost_events["degraded"]) and closes
        # defer; recovery_failed latches when the recovery's circuit opens
        # (unhealthy until the orchestrator restarts the agent).
        self._degraded = threading.Event()
        self._recover_lock = threading.Lock()
        self._recovering = False
        self._recover_thread: threading.Thread | None = None  # guarded by _recover_lock
        self.recovery_failed = threading.Event()
        self.restarts = 0
        self._last_resume_src = ""
        self._snapshot_path = (os.path.join(cfg.snapshot_dir, "sketch_state.npz")
                               if cfg.snapshot_dir else None)
        self._start_monotonic = time.monotonic()
        self._publish_build_info()

    def _publish_build_info(self) -> None:
        """One-shot build/runtime identity gauge (value always 1; the labels
        are the payload) plus the uptime baseline, with the reference's label
        names: ``jax`` carries torch's version and ``backend`` the device
        type."""
        from retina_tpu_torch.utils import buildinfo

        sig = "|".join(str(x) for x in (
            self.cfg.batch_capacity, self.cfg.flow_dict_slots,
            int(bool(self.cfg.transfer_packed)), self._fd_id_bits,
            int(self._fd_dense), NUM_FIELDS))
        m = get_metrics()
        m.build_info.labels(version=buildinfo.VERSION, jax=torch.__version__,
                            backend=self.device.type, devices="1", config=sig).set(1)
        m.uptime_seconds.set(0.0)

    def compile(self) -> None:
        """Make the agent ready to feed before it reports ready: build every
        kernel from the repo's sources (``kernels/build.py``, one nvcc a
        source in parallel; nothing on the CPU), then run the reference's
        boot dispatches through the real dispatch path: a full-capacity
        zero-row batch (the packed wire at ``batch_capacity``, K7 and the
        step's kernels) and the smallest plain bucket (an idle flush). So
        neither nvcc nor a first launch lands after ready. The reference
        warms the rest of its per-bucket programs in the background after
        ready; the port compiles no per-bucket programs, so nothing follows.
        """
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from retina_tpu_torch.kernels import build

            libs = build.build_all()
            _log.info("compile: %d kernels built at +%.1fs", len(libs),
                      time.perf_counter() - t0)
        # The boot dispatches are not traffic: as the reference's
        # record_metrics=False, they leave the feed's counts and the
        # overload controller's dispatch-latency signal as they were (a
        # first launch's latency would otherwise read as pressure).
        counts = dataclasses.replace(self.counts)
        full = ShardedBatch(
            records=np.zeros((1, self.cfg.batch_capacity, NUM_FIELDS), np.uint32),
            n_valid=np.zeros((1,), np.uint32), lost=0)
        self._dispatch_sharded(full, now_s=1, n_raw=0)
        self._dispatch(np.zeros((0, NUM_FIELDS), np.uint32), now_s=1)
        for f in dataclasses.fields(counts):
            setattr(self.counts, f.name, getattr(counts, f.name))
        self._dispatch_lat_ewma = self._dispatch_lat_t = 0.0
        _log.info("engine compiled: device %s, batch=%d, %.1fs", self.device,
                  self.cfg.batch_capacity, time.perf_counter() - t0)

    @property
    def timetravel_ring(self) -> SnapshotRing | None:
        """The ring of this engine's window-close exports (None unless
        ``timetravel_enabled``)."""
        return self._tt_ring

    @property
    def _events_in(self) -> int:
        """Raw events stepped (the reference's counter; the idle check)."""
        return self.counts.events

    def stop(self) -> None:
        """Stop the shipper (after the frames it has queued) and the ring's
        readback thread, join a recovery in flight (for at most its fence
        bound and a backoff) and deregister the harvest's heartbeat (the
        other lanes deregister theirs as they end)."""
        if self._fleet_shipper is not None:
            self._fleet_shipper.stop()
        if self._tt_ring is not None:
            self._tt_ring.stop()
        with self._recover_lock:
            rt = self._recover_thread
        if rt is not None:
            rt.join(timeout=self.cfg.watchdog_deadline_s + self.cfg.restart_backoff_max_s)
        self._deregister_hb("window-harvest")

    # -- supervision helpers -----------------------------------------------
    def _register_hb(self, name: str, deadline_s: float | None = None,
                     on_stall: Callable[[], None] | None = None) -> Heartbeat:
        """The supervisor's heartbeat cell for ``name``, or a detached one
        (watched by nobody) when the engine runs without a supervisor."""
        dl = deadline_s or self.cfg.watchdog_deadline_s
        if self._supervisor is not None:
            return self._supervisor.register(name, dl, on_stall)
        return Heartbeat(name, dl, on_stall)

    def _deregister_hb(self, name: str) -> None:
        if self._supervisor is not None:
            self._supervisor.deregister(name)

    # -- crash-only recovery -----------------------------------------------
    @property
    def degraded(self) -> bool:
        return self._degraded.is_set()

    @staticmethod
    def _fatal_device_error(e: BaseException) -> bool:
        """Classify a step, copy or close failure: fatal (the card or its
        context: the resident state is suspect, rebuild it) or a bad batch
        (already dropped and counted; carry on). Fatal: an injected fault,
        an out-of-memory error, and the CUDA errors torch raises ("CUDA
        error: ...") and the wrappers raise ("<kernel>: CUDA error <rc> at
        launch"). A kernel's error is asynchronous: it may surface at a
        later launch, an event wait or the probe."""
        if isinstance(e, (faults.InjectedFault, torch.cuda.OutOfMemoryError)):
            return True
        return "CUDA error" in str(e)

    def _request_recovery(self, reason: str) -> None:
        """Enter degraded drop-and-count mode and start the recovery
        thread. Idempotent: concurrent fatal errors fold into the one
        recovery in flight."""
        with self._recover_lock:
            if self._recovering or self.recovery_failed.is_set():
                return
            self._recovering = True
        self._degraded.set()
        get_metrics().degraded_mode.set(1)
        _log.error("engine entering DEGRADED mode (crash-only recovery): %s", reason)
        t = threading.Thread(target=self._recover, name="engine-recover", daemon=True)
        with self._recover_lock:
            self._recover_thread = t
        t.start()

    def _recover(self) -> None:
        """Crash-only recovery: fence the proxy, rebuild the card's state
        from the last checkpoint (zeros when there is none), probe with a
        zero-row dispatch, then leave degraded mode. Retries under the
        restart policy; an open circuit latches ``recovery_failed``."""
        t0 = time.monotonic()
        hb = self._register_hb("engine-recover")
        policy = policy_from_config(self.cfg, seed_key="engine-recover")
        m = get_metrics()
        attempt = 0
        try:
            while True:
                attempt += 1
                hb.beat()
                policy.note_start()
                try:
                    self._recover_once(hb)
                    break
                except Exception:
                    self._count(self.errors, "recovery")
                    _log.exception("engine recovery attempt %d failed", attempt)
                    delay = policy.record_failure()
                    if delay is None:
                        _log.error("engine recovery crash-looping; giving up (unhealthy "
                                   "until the orchestrator restarts the agent)")
                        self.recovery_failed.set()
                        return
                    hb.park()
                    time.sleep(delay)
            self._degraded.clear()
            m.degraded_mode.set(0)
            m.engine_restarts.inc()
            self.restarts += 1
            dt = time.monotonic() - t0
            m.recovery_seconds.observe(dt)
            _log.warning("engine recovered in %.2fs (attempt %d, %s)", dt, attempt,
                         self._last_resume_src)
        finally:
            with self._recover_lock:
                self._recovering = False
            self._deregister_hb("engine-recover")

    def _recover_once(self, hb: Heartbeat) -> None:
        # The chaos site: recover:hangN holds the engine degraded, and
        # recover:raise fails an attempt.
        faults.inject("recover")
        # 1) Drain the proxy: no stale closure may touch the state about to
        #    be replaced. Bounded: a wedged proxy fails this attempt.
        hb.park()
        if not self._proxy.fence(timeout=self.cfg.watchdog_deadline_s):
            raise RuntimeError("device proxy did not drain for recovery")
        hb.beat()
        path = self._snapshot_path

        def rebuild() -> bool:
            # The descriptor table is made anew by the next dispatch; the
            # host dictionary clears with it (the epoch bump drops queued
            # batches of before the recovery).
            with self._fd_lock:
                self._desc_table = None
                self._desc_winner = None
                if self._flow_dict is not None:
                    self._flow_dict.clear()
                    self._fd_epoch += 1
            if path:
                from retina_tpu_torch.checkpoint import load_state

                state, resumed = load_state(path, self.telemetry, self.pcfg)
            else:
                state, resumed = self.telemetry.init_state(), False
            self.state = state
            with self._snap_lock:
                self._snap_cache = None
            return resumed

        hb.park()
        resumed = self._proxy.run(rebuild)
        hb.beat()
        self._last_resume_src = f"resumed from {path}" if resumed else "cold start"
        # 2) Probe: one zero-row dispatch through the real copy, ingest and
        #    step proves the card works before asynchronous traffic is
        #    readmitted.
        hb.park()
        self._dispatch(np.zeros((0, NUM_FIELDS), np.uint32), now_s=int(time.time()))
        hb.beat()

    def _count(self, counter: collections.Counter, key: str, n: int = 1) -> None:
        with self._count_lock:
            counter[key] += n

    def _lane(self, name: str, seconds: float) -> None:
        self._count(self.lane_s, name, seconds)

    # -- identity / filter wiring ---------------------------------------
    def update_identities(self, ip_to_index: dict[int, int]) -> None:
        """Reconcile the identity table to ``ip_to_index``: apply the
        changed keys to the host cuckoo table, then upload it once, on the
        proxy (queue order is visibility order for the lanes). An overfull
        map keeps the lowest IPs and counts the rest."""
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
        self.ident = self._proxy.run(self._ident_host.to_device, self.device)

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
        self.filter_map = self._proxy.run(host.to_device, self.device)

    def set_apiserver_ips(self, ips: list[int]) -> None:
        self.apiserver_ip = ips[0] if ips else 0

    def add_observer(self, fn: Callable[[np.ndarray, str], None], name: str = "") -> None:
        """Observers see every accepted record block on the feed loop (dns
        tally, flow export, a replay capture). Fast, and never raising:
        a failure is counted under ``errors["observer"]``. ``name`` ties one
        to an overload shed stage: while "dns" is shed, observers named
        "dns" are skipped and the skipped events counted."""
        self._observers.append((fn, name))

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
            self._count(self.errors, name)
            _log.exception("%s failed", name)

    def _dispatch(self, records: np.ndarray, now_s: int) -> None:
        self._call_hook("record_hook", records, now_s)
        with self.stages("partition"):
            sb = partition_events(records, 1, self.cfg.batch_capacity,
                                  min_bucket=self.cfg.transfer_min_bucket)
        self._dispatch_sharded(sb, now_s, n_raw=len(records))

    def flush(self, blocks: list[np.ndarray], now_s: int) -> None:
        """One flush of the feed loop, synchronously: ``_build_quantum``
        over the blocks, then ``_dispatch_sharded`` for each item."""
        n_raw = sum(len(b) for b in blocks)
        for _, sb, now, n in self._build_quantum(blocks, n_raw, now_s):
            self._dispatch_sharded(sb, now, n)

    def _build_quantum(self, blocks: list[np.ndarray], n_raw: int, now_s: int,
                       ) -> list[tuple]:
        """Combine, sample and partition one flush quantum into ("step",
        batch, now_s, n_raw) items of at most ``batch_capacity *
        feed_coalesce_windows`` rows. Pure host work, shared by the inline
        flush and the feed workers, where it runs concurrently."""
        t0 = time.perf_counter()
        coal = self.cfg.batch_capacity * max(1, self.cfg.feed_coalesce_windows)
        with self.stages("combine"):
            if self.cfg.host_combine:
                all_rec = combine_blocks(blocks)
            elif len(blocks) == 1:
                all_rec = blocks[0]
            else:
                all_rec = np.concatenate(blocks, axis=0)
        self._call_hook("record_hook", all_rec, now_s)
        # Sampling sits after the combine (a row's weight is final) and
        # before partitioning; k rides the batch to the step's rescale.
        all_rec, samp_k = self._overload.sample_rows(all_rec)
        items: list[tuple] = []
        with self.stages("partition"):
            for off in range(0, len(all_rec), coal):
                sb = partition_events(all_rec[off: off + coal], 1, coal,
                                      min_bucket=self.cfg.transfer_min_bucket)
                sb.sample_k = samp_k
                # Raw-row accounting goes to the chunk that carries it.
                items.append(("step", sb, now_s, n_raw if off == 0 else 0))
        self._lane("build", time.perf_counter() - t0)
        return items

    def _wire_bucket(self, n_max: int) -> int:
        cap_total = self.cfg.batch_capacity * max(1, self.cfg.feed_coalesce_windows)
        return min(_next_bucket(max(n_max, self.cfg.transfer_min_bucket)), cap_total)

    def _flowdict_resync(self) -> None:
        """Invalidate the host dictionary and the card's table together
        after a failure that may have desynced them."""
        with self._fd_lock:
            self._flow_dict.clear()
            self._fd_epoch += 1
            self._desc_table = None
            self._desc_winner = None

    def _ensure_desc_table(self) -> torch.Tensor:
        """(Proxy.) The card's descriptor table, zeros made on the card
        (never uploaded), with K7's claim scratch beside it."""
        if self._desc_table is None:
            slots = self.cfg.flow_dict_slots
            self._desc_table = torch.zeros((slots, PACKED_FIELDS), dtype=torch.int32,
                                           device=self.device)
            self._desc_winner = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        return self._desc_table

    def _to_card(self, wire: np.ndarray, buf: torch.Tensor) -> torch.Tensor:
        """(Proxy.) One host-to-card copy of a u32 wire built in a staging
        buffer (int32 bit patterns)."""
        self.counts.wire_bytes += wire.nbytes
        return self._staging.to_card(wire, buf, self.device)

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
        """(Proxy.) Step every window of every side in order; host losses
        fold into the first step only."""
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

    def _hk_account(self, rows: np.ndarray) -> None:
        """("both".) Fold one dispatch's forward-verdict packets into the
        ground truth, keyed like the invertible sketch: (src_ip, dst_ip,
        ports, proto). The caller holds ``_fd_lock``. Counts are after
        sampling (the heavy and priority tiers are exempt, so keys at or
        above the heavy threshold stay exact)."""
        fwd = rows[:, F.VERDICT] == VERDICT_FORWARDED
        if not fwd.any():
            return
        r = rows[fwd]
        keys = np.stack([r[:, F.SRC_IP], r[:, F.DST_IP], r[:, F.PORTS],
                         r[:, F.META] >> np.uint32(24)], axis=1).astype(np.uint32)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        sums = np.zeros(len(uniq), np.uint64)
        np.add.at(sums, inv.reshape(-1), r[:, F.PACKETS].astype(np.uint64))
        hk = self._hk_counts
        for kb, s in zip((u.tobytes() for u in uniq), sums):
            hk[kb] = hk.get(kb, 0) + int(s)

    def _issue(self, fn: Callable[[], None], sync: bool, n_events: int,
               resync: bool = False) -> None:
        """Run one dispatch's card work on the proxy: waiting for it
        (``sync``: errors reach the caller), or fire-and-forget, bounded by
        the in-flight semaphore, its failure counted and its events lost; a
        fatal failure starts the crash-only recovery. A failure that is not
        fatal (a bad batch) may leave the step half applied: the state is
        updated in place, kernel by kernel."""
        if sync:
            self._proxy.run(fn)
            return

        def safe() -> None:
            try:
                fn()
            except Exception as e:
                self._count(self.errors, "device_step")
                self._count(self.lost_events, "device", n_events)
                _log.exception("device step failed")
                if resync:
                    # The host dictionary may no longer match the table:
                    # rebuild both; queued batches of this epoch drop.
                    self._flowdict_resync()
                if self._fatal_device_error(e):
                    self._request_recovery(repr(e))
            finally:
                with self._busy_lock:
                    self._inflight_busy -= 1
                self._inflight.release()

        t0 = time.perf_counter()
        self._inflight.acquire()
        self._lane("inflight_wait", time.perf_counter() - t0)
        with self._busy_lock:
            self._inflight_busy += 1
        try:
            self._proxy.submit(safe)
        except BaseException:
            # Not queued (a lost CUDA context fails the caller's event):
            # give the slot back.
            with self._busy_lock:
                self._inflight_busy -= 1
            self._inflight.release()
            raise

    def _note_latency(self, t0: float) -> None:
        """(Proxy.) The overload signal: EWMA of a dispatch's host seconds."""
        self._dispatch_lat_ewma = 0.8 * self._dispatch_lat_ewma + 0.2 * (
            time.perf_counter() - t0)
        self._dispatch_lat_t = time.monotonic()

    def _dispatch_flowdict(self, sb: ShardedBatch, now_s: int, n_raw: int,
                           sync: bool) -> None:
        """Split the batch into new-descriptor rows (13-lane upload + table
        insert) and known rows (a few bytes each against the resident
        table). Known rows the narrow lanes cannot carry exactly escalate
        to the new side (re-writing a resident descriptor is harmless).
        Both sides ride one proxy call, new first."""
        from retina_tpu_torch.native import flowwire_dense_native, flowwire_native

        with self.stages("dict and wire"):
            nv = int(sb.n_valid[0])
            rows = np.ascontiguousarray(sb.records[0, :nv])
            with self._fd_lock:
                ids, is_new = self._flow_dict.lookup_or_assign(rows)
                if self._hk_counts is not None and nv:
                    self._hk_account(rows)
                epoch = self._fd_epoch
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
            new_wire, new_buf = self._staging.array((bn, 13))
            known_wire, known_buf = self._staging.array(
                (dense_words(bk, self._fd_id_bits),) if dense else (bk, 2))
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
            self._staging.give(new_buf)
            self._staging.give(known_buf)
            return  # nothing valid
        n_events = int(sb.events)

        def xfer_and_step() -> None:
            faults.inject("transfer")
            if self._fd_epoch != epoch:
                # A resync after this batch was built dropped the table its
                # ids name.
                self._count(self.lost_events, "dispatch", n_events)
                _log.warning("dropping an in-flight flow-dict batch of an older epoch")
                return
            t0 = time.perf_counter()
            with self.stages("copy"):
                new_dev = self._to_card(new_wire, new_buf) if n_new else None
                known_dev = self._to_card(known_wire, known_buf) if n_known else None
            sides = []
            with self.stages("ingest"):
                if n_new:
                    sides.append(self._ingest_new(bn, new_dev, base_lo, base_hi, n_new))
                if n_known:
                    sides.append(self._ingest_known(bk, known_dev, ts_flag, base_lo, base_hi,
                                                    n_known))
            self._recorder.record(mn.STAGE_TRANSFER, t0, window_epoch(self.cfg.window_seconds))
            self._step_windows(sides, now_s, sb.lost, sb.sample_k)
            self.counts.new_rows += n_new
            self.counts.known_rows += n_known
            self.counts.events += n_raw
            self._note_latency(t0)

        self._issue(xfer_and_step, sync, n_events, resync=True)

    def _dispatch_sharded(self, sb: ShardedBatch, now_s: int, n_raw: int,
                          sync: bool = True) -> None:
        """Wire build (on the calling thread), then copy, ingest and step
        (on the proxy) for one partitioned batch. ``sync`` waits and raises
        on failure; otherwise (the dispatch thread) the card work is
        submitted without waiting and a failure is counted and lost.

        With the flow dictionary and at least ``transfer_min_bucket`` rows
        the batch takes the dictionary wire; a smaller flush is cheaper as
        one packed transfer and leaves the dictionary untouched.

        While a crash-only recovery rebuilds the state, asynchronous
        dispatches drop here, counted under ``lost_events["degraded"]``;
        synchronous ones (the recovery's probe, direct callers who want the
        error) pass through."""
        if not sync and self._degraded.is_set():
            self._count(self.lost_events, "degraded", int(sb.events) + int(sb.lost))
            return
        if sb.lost:
            self._count(self.lost_events, "partition", int(sb.lost))
        if self._flow_dict is not None and int(sb.n_valid.sum()) >= self.cfg.transfer_min_bucket:
            try:
                self._dispatch_flowdict(sb, now_s, n_raw, sync)
            except Exception as e:
                # A failure after lookup_or_assign may leave descriptors
                # registered whose lanes never reached the table: rebuild
                # both sides, then report the failure.
                self._flowdict_resync()
                if sync:
                    raise
                self._count(self.errors, "flowdict_dispatch")
                self._count(self.lost_events, "dispatch", int(sb.events))
                _log.exception("flow-dict dispatch failed")
                if self._fatal_device_error(e):
                    # The staging buffers are the card's pinned memory: a
                    # lost context surfaces here too.
                    self._request_recovery(repr(e))
            return
        with self.stages("dict and wire"):
            n_valid = int(sb.n_valid[0])
            if self.cfg.transfer_packed:
                rows, b_lo, b_hi = pack_records(np.ascontiguousarray(sb.records[0]))
                packed = True
            else:
                rows, b_lo, b_hi = sb.records[0], 0, 0
                packed = False
            wire, buf = self._staging.array(rows.shape)
            np.copyto(wire, rows)
        bucket = wire.shape[0]

        def xfer_and_step() -> None:
            faults.inject("transfer")
            t0 = time.perf_counter()
            with self.stages("copy"):
                wire_dev = self._to_card(wire, buf)
            with self.stages("ingest"):
                wins = self._ingest(bucket, packed, wire_dev, int(b_lo), int(b_hi), n_valid)
            self._recorder.record(mn.STAGE_TRANSFER, t0, window_epoch(self.cfg.window_seconds))
            self._step_windows([wins], now_s, sb.lost, sb.sample_k)
            self.counts.packed_rows += n_valid
            self.counts.events += n_raw
            self._note_latency(t0)

        self._issue(xfer_and_step, sync, int(sb.events))

    # -- window close ------------------------------------------------------
    def _close_dispatch(self, z_thresh: float, epoch: int) -> dict:
        """(Proxy.) The close itself: the export (copies taken before
        ``end_window``), one host copy of it offered to the ring and the
        shipper, and the export under "export" with ``fleet_enabled``; the
        invertible decode under "inv", then ``end_window``'s outputs. A
        failed export, offer or decode is counted and the close goes on."""
        t_c0 = time.perf_counter()
        out: dict = {}
        cfg = self.cfg
        if cfg.timetravel_enabled or cfg.fleet_enabled:
            try:
                export = self.telemetry.fleet_export(self.state)
                seeds = self.telemetry.fleet_seeds(self.state)
                # One copy feeds both: the workers wait for it off the proxy.
                host = to_host(export)
                if self._fleet_shipper is not None:
                    self._fleet_shipper.offer(epoch, host, cfg.window_seconds, seeds)
                if self._tt_ring is not None:
                    self._tt_ring.offer(epoch, host, cfg.window_seconds, seeds)
                if cfg.fleet_enabled:
                    out["export"] = (epoch, export, cfg.window_seconds, seeds)
                self._count(self.windows, "exports")
            except Exception:
                get_metrics().fleet_ship_errors.inc()
                self._count(self.errors, "fleet_export")
                _log.exception("fleet export failed")
        if self.pcfg.enable_invertible:
            try:
                out["inv"] = self.telemetry.inv_decode(self.state,
                                                       self.cfg.invertible_min_weight)
            except Exception:
                self._count(self.errors, "inv_decode")
                _log.exception("invertible decode failed")
        self.state, win = self.telemetry.end_window(self.state, z_thresh)
        self._count(self.windows, "end_window")
        out.update(win)
        self._recorder.record(mn.STAGE_WINDOW_CLOSE, t_c0, epoch)
        return out

    def close_window(self, z_thresh: float = 4.0, epoch: int | None = None) -> dict:
        """Close the entropy window synchronously: ``end_window``'s outputs,
        with the invertible sketch its verified decode under ``"inv"``, and
        with the ring or the fleet tier on the export (see
        ``_close_dispatch``), as ``(epoch, arrays, window_s, seeds)`` under
        ``"export"``. ``epoch`` defaults to ``window_epoch(window_seconds)``,
        the wall clock's window; ``anomaly_hook`` gets the same epoch. A
        window with no event since the last close is idle: it returns
        ``zero_window()`` and runs nothing on the card."""
        self._count(self.windows, "closed")
        if self._events_in == self._closed_events_in:
            self._count(self.windows, "idle")
            return zero_window()
        ingested = self._events_in
        epoch = window_epoch(self.cfg.window_seconds) if epoch is None else int(epoch)
        if self._fleet_shipper is not None:
            self._fleet_shipper.start()
        out = self._proxy.run(self._close_dispatch, z_thresh, epoch)
        self._closed_events_in = ingested
        if self.anomaly_hook is not None:
            flagged = [d for d, f in zip(ANOMALY_DIMS, out["anomaly"].tolist()) if f]
            if flagged:
                self._call_hook("anomaly_hook", epoch, flagged)
        return out

    def _close_window(self) -> None:
        """End the window on the proxy, whatever thread calls this."""
        self._proxy.run(self._close_window_impl)

    def _close_window_impl(self) -> None:
        """(Proxy.) The lanes' close: queued after the steps that fed the
        window, it dispatches the close and hands its outputs, copying to
        the host, to the harvest thread. An idle window (no event since
        the last close) publishes a zero window through the same queue, so
        publication order stays close order. During a recovery the close
        defers (counted) and the next tick closes the window against the
        recovered state."""
        t0 = time.perf_counter()
        if self._degraded.is_set():
            self._count(self.windows, "deferred")
            return
        self._count(self.windows, "closed")
        if self._events_in == self._closed_events_in:
            self._count(self.windows, "idle")
            get_metrics().windows_closed.inc()
            meta = self._overload.window_annotation()
            meta["events"] = 0  # idle, not stalled: nothing arrived
            self._ensure_harvest_thread()
            self._harvest_q.put(("zero", None, meta))
            self._lane("close", time.perf_counter() - t0)
            return
        ingested = self._events_in
        # The annotation before the count advances: the raw events this
        # window took and the sampler's accounting.
        meta = self._overload.window_annotation()
        meta["events"] = ingested - self._closed_events_in
        out = self._close_dispatch(4.0, window_epoch(self.cfg.window_seconds))
        stacked = to_host({k: out[k].to(torch.float32)
                           for k in ("entropy_bits", "anomaly", "zscore")})
        # Advance only after a successful dispatch: a failed close is
        # retried by the next tick, never skipped.
        self._closed_events_in = ingested
        if "inv" in out:
            meta["inv_decode"] = to_host(out["inv"])
        self._ensure_harvest_thread()
        self._harvest_q.put(("win", stacked, meta))
        get_metrics().windows_closed.inc()
        self._lane("close", time.perf_counter() - t0)

    def _submit_close_window(self) -> None:
        """Fire-and-forget close on the protected close lane: after the
        steps submitted before it, bounded by its own two slots. When both
        are in flight the tick defers (counted) and the next closes a
        longer window."""

        def safe_close() -> None:
            try:
                self._close_window_impl()
            except Exception as e:
                self._count(self.errors, "window_close")
                _log.exception("window close failed")
                if self._fatal_device_error(e):
                    self._request_recovery(repr(e))
            finally:
                self._close_inflight.release()

        if not self._close_inflight.acquire(blocking=False):
            self._count(self.windows, "deferred")
            return
        try:
            self._proxy.submit(safe_close)
        except BaseException:
            self._close_inflight.release()
            raise

    # -- the harvest lane --------------------------------------------------
    def _publish_window(self, win_host: dict[str, np.ndarray], meta: dict | None = None,
                        ) -> None:
        """(Harvest.) Publish one closed window: ``last_window`` (with the
        overload annotation taken at the close), the window's entropy and
        anomaly series (``metrics.get_metrics()``) and the anomaly hook with
        the wall clock's epoch at publication, as the reference does."""
        if meta is not None:
            win_host = dict(win_host)
            win_host["overload"] = meta
        self.last_window = win_host
        m = get_metrics()
        # Uptime rides the window-publish cadence (>= one update a
        # window_seconds): cheap, and always fresh at scrape time.
        m.uptime_seconds.set(time.monotonic() - self._start_monotonic)
        for i, dim in enumerate(ANOMALY_DIMS):
            m.entropy_bits.labels(dimension=dim).set(float(win_host["entropy_bits"][i]))
            m.anomaly_flag.labels(dimension=dim).set(float(win_host["anomaly"][i]))
            m.anomaly_zscore.labels(dimension=dim).set(float(win_host["zscore"][i]))
            if win_host["anomaly"][i]:
                # A counter: a short anomalous window stays visible at a
                # slower scrape.
                m.anomaly_windows.labels(dimension=dim).inc()
        flagged = [d for i, d in enumerate(ANOMALY_DIMS)
                   if i < len(win_host["anomaly"]) and win_host["anomaly"][i]]
        if flagged:
            self._call_hook("anomaly_hook", window_epoch(self.cfg.window_seconds), flagged)

    def _ensure_harvest_thread(self) -> None:
        # Spawn and retire are serialized: a straggler close must not spawn
        # a thread after shutdown consumed the sentinel.
        with self._harvest_lock:
            if self._harvest_retired:
                return
            if self._harvest_thread is None or not self._harvest_thread.is_alive():
                self._harvest_thread = threading.Thread(
                    target=self._harvest_loop, args=(self._harvest_gen,),
                    name="window-harvest", daemon=True)
                self._harvest_thread.start()

    def _restart_harvest(self) -> None:
        """(Watchdog.) Supersede a hung harvest thread: bump the generation
        and start a replacement. The hung one exits at its next generation
        check; its item publishes late or never (every later window
        refreshes the series)."""
        with self._harvest_lock:
            if self._harvest_retired:
                return
            self._harvest_gen += 1
            self._harvest_thread = None
        get_metrics().thread_restarts.labels(thread="window-harvest").inc()
        _log.error("harvest thread stalled; superseding it with a replacement (gen %d)",
                   self._harvest_gen)
        self._ensure_harvest_thread()

    def _harvest_loop(self, gen: int) -> None:
        """(Harvest.) Wait for each closed window's copy to the host, off
        the proxy, and publish it; FIFO keeps close order. The heartbeat is
        parked around the waits (the queue, the copy's event), so only a
        publication that stops making progress is a stall. ``gen`` is this
        instance's generation: superseded, it exits at its next check."""
        hb = self._register_hb("window-harvest", on_stall=self._restart_harvest)
        while True:
            hb.park()
            try:
                item = self._harvest_q.get(timeout=1.0)
            except queue_mod.Empty:
                if self._harvest_gen != gen:
                    return  # superseded while idle
                continue
            hb.beat()
            t0 = time.perf_counter()
            try:
                if item is None:
                    return
                kind, stacked, meta = item
                faults.inject("harvest")
                if kind == "zero":
                    self._publish_window(zero_window(), meta)
                else:
                    tid = window_epoch(self.cfg.window_seconds)
                    t_h0 = time.perf_counter()
                    hb.park()
                    host = stacked.result(timeout=self.cfg.harvest_timeout_s)
                    hb.beat()
                    self._recorder.record(mn.STAGE_HARVEST, t_h0, tid)
                    t_p0 = time.perf_counter()
                    self._publish_window({k: v.numpy() for k, v in host.items()}, meta)
                    self._recorder.record(mn.STAGE_PUBLISH, t_p0, tid)
                    inv = meta.pop("inv_decode", None)
                    if inv is not None:
                        self._harvest_invertible(inv)
            except Exception:
                self._count(self.errors, "harvest_readback")
                _log.exception("window readback failed")
            finally:
                self._lane("harvest", time.perf_counter() - t0)
                self._harvest_q.task_done()
            if self._harvest_gen != gen:
                return  # superseded mid-item: a replacement runs

    def _harvest_invertible(self, dec) -> None:
        """(Harvest.) One window's invertible decode: dedupe (a key can
        decode from up to D buckets), keep it for ``invertible_report`` and,
        with ``heavy_keys_source="both"``, score recall and precision
        against the host ground truth (``_hk_account``)."""
        host = dec.result(timeout=self.cfg.harvest_timeout_s)
        ok = host["ok"].numpy().astype(bool)
        keys = host["keys"].numpy().view(np.uint32)[ok]
        est = host["est"].numpy().view(np.uint32)[ok]
        tier = host["tier"].numpy().view(np.uint32)[ok]
        if len(keys):
            uniq, idx = np.unique(keys, axis=0, return_index=True)
            keys, est, tier = uniq, est[idx], tier[idx]
        with self._inv_lock:
            self._inv_last = {"keys": keys, "est": est, "tier": tier}
        if self._hk_counts is None:
            return
        thr = max(1, int(self.cfg.invertible_min_weight))
        with self._fd_lock:
            truth = dict(self._hk_counts)
        heavy = {k for k, v in truth.items() if v >= thr}
        rec = {k.tobytes() for k in keys}
        scores = {"keys_recovered": float(len(keys))}
        if heavy:
            scores["recall"] = len(heavy & rec) / len(heavy)
        if rec:
            scores["precision"] = sum(1 for k in rec if truth.get(k, 0) >= thr) / len(rec)
        self.invertible_scores = scores

    def invertible_report(self) -> dict:
        """The latest window's recovered heavy keys (host arrays): ``keys``
        (N, 4) u32 rows of (src_ip, dst_ip, ports, proto), ``est`` (N,)
        CMS estimates, ``tier`` (N,) (0 the main region, 1 the priority
        region). Empty before the first decoded window."""
        with self._inv_lock:
            last = self._inv_last
        if last is None:
            return {"keys": np.zeros((0, 4), np.uint32), "est": np.zeros((0,), np.uint32),
                    "tier": np.zeros((0,), np.uint32)}
        return dict(last)

    def _harvest_window(self, timeout: float | None = None) -> None:
        """Wait until every window queued so far has published, or for
        ``timeout`` (default ``harvest_timeout_s``)."""
        if timeout is None:
            timeout = self.cfg.harvest_timeout_s
        deadline = time.monotonic() + timeout
        while self._harvest_q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)

    # -- overload control ----------------------------------------------------
    def _resolve_feed_workers(self) -> int:
        """Feed workers: the configured count, or cores minus one capped at
        4. 1 means the inline feed."""
        n = self.cfg.feed_workers
        if n <= 0:
            n = max(1, min(4, (os.cpu_count() or 1) - 1))
        return n

    def _busy_count(self) -> int:
        """In-flight dispatches (the interval-flush gate)."""
        with self._busy_lock:
            return self._inflight_busy

    def _overload_signals(self) -> dict[str, float]:
        """The normalized [0, 1] pressure signals; their max is the
        controller's pressure."""
        sig: dict[str, float] = {}
        pool = self._feed_pool
        now = time.monotonic()
        if pool is not None:
            # The worst staging fill, and the handoff wait rate (seconds
            # waited per wall second).
            sig["staging"] = pool.max_staging_fill()
            wait = pool.handoff_wait_total()
            dt = max(now - self._ov_wait_t, 1e-6)
            sig["handoff_wait"] = min(1.0, max(0.0, wait - self._ov_wait_prev) / dt)
            self._ov_wait_prev = wait
            self._ov_wait_t = now
        sig["inflight"] = min(1.0, self._busy_count() / max(1, self.cfg.feed_pipeline_depth))
        sig["harvest"] = min(1.0, self._harvest_q.unfinished_tasks / 4.0)
        # A dispatch eating half a window is pressure; a stale sample (no
        # dispatch for two windows) means idle, not slow.
        if now - self._dispatch_lat_t <= 2.0 * self.cfg.window_seconds:
            sig["dispatch_lat"] = min(
                1.0, self._dispatch_lat_ewma / max(0.5 * self.cfg.window_seconds, 1e-3))
        # Injected backpressure (faults.py feed.backpressure): between the
        # shed (0.90) and degrade (0.98) thresholds.
        if faults.pressure("feed.backpressure"):
            sig["fault"] = 0.95
        # A recovery pins the controller at DEGRADED while it lasts.
        if self._degraded.is_set():
            sig["degraded"] = 1.0
        return sig

    @property
    def overload(self) -> OverloadController:
        """The controller (tests drive ``tick`` with injected clocks)."""
        return self._overload

    def shed_active(self, stage: str) -> bool:
        return self._overload.shed_active(stage)

    def overload_stats(self) -> dict[str, Any]:
        return self._overload.stats()

    def feed_stats(self) -> dict[str, Any]:
        """The feed path's self-observability: the pool's (or the inline
        feed's) stats, the dictionary's residency, the controller, losses
        and the lanes' busy seconds."""
        pool = self._feed_pool
        st = pool.stats() if pool is not None else {"workers": 0, "mode": "inline",
                                                      "per_worker": []}
        st["flow_dict"] = flow_dict_stats(self._flow_dict)
        st["overload"] = self._overload.stats()
        with self._count_lock:
            st["lost_events"] = dict(self.lost_events)
            st["lane_s"] = dict(self.lane_s)
            st["windows"] = dict(self.windows)
        return st

    # -- the lanes -------------------------------------------------------------
    def _dispatch_loop(self, q) -> None:
        """Dispatch thread: builds the wires of partitioned steps and
        submits them (and window closes) to the proxy in feed order without
        waiting for the card. ``q`` is a TransferMux; ``None`` stops it.
        The heartbeat is parked around each wait for an item."""
        hb = self._register_hb("engine-dispatch")
        try:
            while True:
                hb.park()
                try:
                    item = q.get(timeout=1.0)
                except queue_mod.Empty:
                    continue
                hb.beat()
                if item is None:
                    return
                kind, payload, now_s, n_raw = item
                t0 = time.perf_counter()
                try:
                    if kind == "step":
                        self._dispatch_sharded(payload, now_s, n_raw, sync=False)
                    else:
                        self._submit_close_window()
                except Exception as e:
                    self._count(self.errors, "dispatch")
                    _log.exception("%s dispatch failed", kind)
                    if self._fatal_device_error(e):
                        self._request_recovery(repr(e))
                self._lane("dispatch", time.perf_counter() - t0)
        finally:
            self._deregister_hb("engine-dispatch")

    def start(self, stop: threading.Event) -> None:
        """The feed loop, until ``stop`` is set: drain the sink, run the
        observers, build quanta (inline, or dealt to feed workers), hand
        them to the dispatch thread, and tick the window on time. With
        ``feed_pipeline_depth`` 0 every dispatch runs here, synchronously.
        On stop: the workers flush, the dispatch thread drains, the proxy
        is fenced, the harvest publishes the last window and retires."""
        self.started.set()
        if self._fleet_shipper is not None:
            self._fleet_shipper.start()
        if self._tt_ring is not None:
            self._tt_ring.start()
        proxy_busy0 = self._proxy.busy_s
        cap = self.cfg.batch_capacity
        quantum = max(cap, self.cfg.flush_max_events)
        depth = self.cfg.feed_pipeline_depth
        n_workers = self._resolve_feed_workers() if depth > 0 else 0
        q: Any = None
        worker: threading.Thread | None = None
        pool: FeedWorkerPool | None = None
        inline_tq: TransferQueue | None = None
        if depth > 0 and n_workers <= 1:
            # The inline feed rides the pool's mux shape: steps through one
            # bounded TransferQueue, ticks through the control lane.
            inline_data = threading.Event()
            inline_tq = TransferQueue(depth, inline_data)
            q = TransferMux([inline_tq], inline_data)

        def drop_item(item) -> None:
            """A dead dispatch thread: count the loss, never enqueue."""
            _log.error("dispatch worker dead; dropping %s", item[0])
            if item[0] == "step":
                self._count(self.lost_events, "dispatch",
                            int(item[1].events) + int(item[1].lost))

        def submit(item) -> None:
            if q is not None:
                if item[0] != "step":
                    # Closes ride the control lane, past the step backlog.
                    if worker is None or not worker.is_alive():
                        drop_item(item)
                    else:
                        q.put_ctl(item)
                elif not inline_tq.put(item, alive=lambda: worker.is_alive()):
                    drop_item(item)
            elif item[0] == "step":
                self._dispatch_sharded(item[1], item[2], item[3])
            else:
                self._submit_close_window()

        if depth > 0:
            if n_workers > 1:
                pool = FeedWorkerPool(
                    n_workers=n_workers,
                    quantum=max(cap, quantum // n_workers),
                    staging_blocks=self.cfg.feed_staging_blocks,
                    flush_interval_s=self.cfg.flush_interval_s,
                    flush_max_age_s=self.cfg.flush_max_age_s,
                    build_steps=self._build_quantum,
                    drop=drop_item,
                    busy=self._busy_count,
                    alive=lambda: worker is not None and worker.is_alive(),
                    register_hb=self._register_hb,
                    deregister_hb=self._deregister_hb,
                    restart_policy=lambda name: policy_from_config(self.cfg, seed_key=name),
                )
                self._feed_pool = pool
                q = pool.mux
            worker = threading.Thread(target=self._dispatch_loop, args=(q,),
                                      name="engine-dispatch", daemon=True)
            worker.start()
            if pool is not None:
                pool.start()

        pending: list[np.ndarray] = []
        n_pending = 0
        last_flush = time.monotonic()
        next_window = time.monotonic() + self.cfg.window_seconds

        def flush() -> None:
            nonlocal pending, n_pending, last_flush
            blocks, n_raw = pending, n_pending
            pending, n_pending = [], 0
            last_flush = time.monotonic()
            for item in self._build_quantum(blocks, n_raw, int(time.time())):
                submit(item)

        hb_feed = self._register_hb("engine-feed")
        try:
            while not stop.is_set():
                hb_feed.beat()
                t0 = time.perf_counter()
                self._overload.tick()
                blocks = self.sink.drain(max_blocks=64)
                shed_dns = self._overload.shed_active("dns")
                # The emit span: the drained blocks dealt into the feed
                # (observers and staging); none for an idle spin.
                t_g0 = self._recorder.begin() if blocks else 0.0
                for rec, plugin in blocks:
                    for obs, oname in self._observers:
                        if shed_dns and oname == "dns":
                            self._overload.note_shed("dns", len(rec))
                            continue
                        try:
                            obs(rec, plugin)
                        except Exception:
                            self._count(self.errors, "observer")
                            _log.exception("observer failed")
                    if pool is not None:
                        # Deal the block and move on: a saturated pool
                        # drops and counts, it never blocks the loop.
                        if not pool.stage(rec):
                            pool.count_drop(len(rec))
                            self._count(self.lost_events, "handoff",
                                        int(rec[:, F.PACKETS].sum()))
                        continue
                    pending.append(rec)
                    n_pending += len(rec)
                    # Flush in bounded quanta as blocks accumulate.
                    if n_pending >= quantum:
                        flush()
                if blocks:
                    self._recorder.record(mn.STAGE_GENERATOR_EMIT, t_g0,
                                          window_epoch(self.cfg.window_seconds))
                now = time.monotonic()
                if n_pending and now - last_flush >= self.cfg.flush_interval_s:
                    # Interval flushes serve latency while nothing is in
                    # flight; under load, accumulate up to the age bound.
                    if self._busy_count() == 0 or now - last_flush >= self.cfg.flush_max_age_s:
                        flush()
                if now >= next_window:
                    submit(("window", None, 0, 0))
                    # One close per catch-up, phase-locked to the start.
                    n_missed = int((now - next_window) // self.cfg.window_seconds)
                    next_window += (n_missed + 1) * self.cfg.window_seconds
                if blocks:
                    self._lane("feed", time.perf_counter() - t0)
                else:
                    stop.wait(0.002)
        finally:
            hb_feed.park()
            self._deregister_hb("engine-feed")
            if pending:
                flush()
            if pool is not None:
                # The workers flush first; the sentinel reaches the
                # dispatch thread only after their queues drained.
                pool.stop(timeout=30.0)
                q.put_ctl(None)
                worker.join(timeout=30.0)
            elif q is not None:
                q.put_ctl(None)
                worker.join(timeout=30.0)
            # Everything submitted before shutdown has run once this
            # returns; then the last window publishes.
            if not self._proxy.fence(timeout=60.0):
                _log.error("device proxy did not drain within 60 s at shutdown")
            else:
                self._harvest_window()
            with self._harvest_lock:
                self._harvest_retired = True
                ht = self._harvest_thread
            if ht is not None:
                self._harvest_q.put(None)
                ht.join(timeout=5.0)
            self._lane("proxy", self._proxy.busy_s - proxy_busy0)
            # After the fence: the last close's export is queued by then,
            # so the last window still ships before the worker stops.
            if self._fleet_shipper is not None:
                self._fleet_shipper.stop()
            if self._tt_ring is not None:
                self._tt_ring.stop()

    # -- scrape-time readout -----------------------------------------------
    def snapshot(self, max_age_s: float = 0.5, now_s: int | None = None) -> dict[str, Any]:
        """The state read back to the host in one copy (CPU tensors, plus
        ``steps`` and ``events_in``), cached for ``max_age_s`` (0: always
        fresh). ``now_s`` (default the wall clock) dates the conntrack
        liveness count. Concurrent readers share one queued readback."""
        with self._snap_lock:
            if self._snap_cache is not None and time.monotonic() - self._snap_time < max_age_s:
                return self._snap_cache
        with self._snap_flight:
            with self._snap_lock:
                if (self._snap_cache is not None
                        and time.monotonic() - self._snap_time < max_age_s):
                    return self._snap_cache
            now = int(time.time()) if now_s is None else int(now_s)

            def snap_dispatch():
                flat, layout = self.telemetry.snapshot_flat_dispatch(self.state, now)
                return to_host({"flat": flat}), layout, self.counts.steps, self.counts.events

            copy, layout, steps, events_in = self._proxy.run(snap_dispatch)
            host = self.telemetry.snapshot_flat_finish(copy.result()["flat"], layout)
            host["steps"] = steps
            host["events_in"] = events_in
            with self._snap_lock:
                self._snap_cache = host
                self._snap_time = time.monotonic()
            return host

    # -- checkpoint/resume ---------------------------------------------------
    def save_snapshot_state(self, path: str) -> None:
        """Write the state to ``path`` (``checkpoint.save_state``). The
        kernels update the state in place, so its copy is taken on the
        proxy, in order with the steps (one copy to pinned host memory and
        an event); the file is written here, on the caller's thread, once
        the copy is done (bounded by ``watchdog_deadline_s``)."""
        from retina_tpu_torch.checkpoint import save_state

        def copy():
            return to_host({str(i): t for i, t in enumerate(tensor_leaves(self.state))})

        host = self._proxy.run(copy).result(timeout=self.cfg.watchdog_deadline_s)
        save_state(path, [to_numpy(host[str(i)]) for i in range(len(host))], self.pcfg)

    def load_snapshot_state(self, path: str) -> bool:
        """Restore the state from ``path`` on the card. Crash-only: a
        missing or unusable checkpoint cold-starts (quarantined by
        ``load_state``); True only when the state was resumed."""
        from retina_tpu_torch.checkpoint import load_state

        def load() -> bool:
            state, resumed = load_state(path, self.telemetry, self.pcfg)
            self.state = state
            with self._snap_lock:
                self._snap_cache = None
            return resumed

        return self._proxy.run(load)

    def top_flows(self, k: int = 20) -> tuple[np.ndarray, np.ndarray]:
        return topk_from_snapshot(self.snapshot(), "flow_hh", k)

    def top_services(self, k: int = 20) -> tuple[np.ndarray, np.ndarray]:
        return topk_from_snapshot(self.snapshot(), "svc_hh", k)

    def top_dns(self, k: int = 20) -> tuple[np.ndarray, np.ndarray]:
        return topk_from_snapshot(self.snapshot(), "dns_hh", k)

    def conntrack_gc(self) -> dict[str, int]:
        """Conntrack liveness and accounting from a snapshot at most 5 s
        old: active connections, reports, and the cumulative packets and
        bytes the reports carried (two-limb u32 counters)."""
        snap = self.snapshot(max_age_s=5.0)
        totals = snap["totals"].numpy().view(np.uint32)
        ctt = snap["ct_totals"].numpy().view(np.uint32).reshape(-1, 4).astype(np.uint64)
        pkts = int((ctt[:, 0] + (ctt[:, 1] << np.uint64(32))).sum())
        byts = int((ctt[:, 2] + (ctt[:, 3] << np.uint64(32))).sum())
        return {
            "active": int(snap["active_conns"]),
            "reports": int(totals[6]),
            "packets": pkts,
            "bytes": byts,
        }
