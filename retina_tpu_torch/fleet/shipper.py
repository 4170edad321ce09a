"""Node-side snapshot shipper: window close -> wire frame -> relay (port of
retina_tpu/fleet/shipper.py).

At each window close the engine copies the window's sketches
(``Telemetry.fleet_export``, before ``end_window``) and starts one copy of
them to the host on the device proxy (``utils/device_proxy.to_host``). The
same ``HostCopy`` goes to the time-travel ring and to this shipper's
bounded queue: one export and one pinned copy feed both, as the reference's
one export feeds its shipper and its ring.

Readback contract: ``offer`` takes a ``HostCopy`` (the close path's), a dict
of host numpy arrays (the aggregator's re-ship, tests) or a dict of CPU
tensors, and never a dict of card tensors (``TypeError``): the proxy's later
steps and ``end_window`` reuse the state in place (K16 zeroes the entropy
window), so a bare card tensor read later on another thread would read a
later window. The worker thread does everything slow off the proxy: it
waits for the copy's event (``HostCopy.result``), encodes the frame
(``fleet/codec.py``) and sends it.

Backpressure contract: never block the close path. A full queue drops the
snapshot and counts it. Overload contract: under SHEDDING and above the
shipper ships 1 window in ``fleet_shed_ship_every``.

Delivery contract: a transport failure opens the send circuit and the frame
goes to a bounded in-memory spool (oldest evicted, both counted) instead of
being lost. The worker retries with jittered exponential backoff,
recreating the gRPC client on each retry so a bounced relay is dialed
afresh, and on heal replays the spool oldest first before new frames.

Transport: by default the in-process pubsub bus (``FLEET_TOPIC``; the
aggregator subscribes when co-located); with ``fleet_relay_addr`` set, the
relay's ``retina.Fleet/Ship`` RPC (``hubble/server.FleetShipClient``, which
imports ``grpc`` when it is built). A missing ``grpc`` is a failed send,
counted and spooled, never a fall back to the bus. Counters are the
registry's ``fleet_ship_*`` and ``fleet_snapshots_shipped`` series
(``metrics.py``); the flight recorder takes the readback, encode and send
spans.
"""

from __future__ import annotations

import os
import queue as queue_mod
import random
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

from retina_tpu_torch.fleet.codec import FLEET_TOPIC, FleetSnapshot, encode_snapshot
from retina_tpu_torch.log import logger, rate_limited
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.obs.recorder import get_recorder
from retina_tpu_torch.pubsub import get_pubsub
from retina_tpu_torch.runtime.overload import SHEDDING
from retina_tpu_torch.utils import metric_names as mn
from retina_tpu_torch.utils.hostcopy import HostCopy

# Worker wake sentinel: a retry-timer tick, not a frame.
_TICK = object()


def _host_arrays(arrays: HostCopy | dict[str, Any]) -> dict[str, np.ndarray]:
    """(Worker.) The catalog's host numpy arrays of an offered export."""
    if isinstance(arrays, HostCopy):
        arrays = arrays.result()
    out = {}
    for k, v in arrays.items():
        if not isinstance(v, np.ndarray):
            from retina_tpu_torch.u32 import to_numpy  # a tensor: torch is loaded

            v = to_numpy(v)
        out[k] = v
    return out


class SnapshotShipper:
    """Owns the ship queue and worker thread of one node agent."""

    def __init__(
        self,
        cfg,
        overload=None,  # OverloadController (state read only)
        supervisor=None,  # runtime/supervisor.py Supervisor
        transport: Optional[Callable[[bytes], None]] = None,
    ) -> None:
        self.cfg = cfg
        self.log = logger("fleet.shipper")
        self.node = cfg.fleet_node_name or cfg.node_name or f"node-{os.getpid()}"
        self.tenant = cfg.fleet_tenant
        self.priority = int(cfg.fleet_priority)
        # Live seed generation: rotated by set_seed_generation (or per
        # offer); tags every frame so the aggregator can tell a rotated node
        # from a misconfigured one.
        self.seed_gen = int(cfg.fleet_seed_generation)
        # Tier stamped on outgoing frames (0 = node agent; the aggregator's
        # re-shipper sets 1).
        self.tier = 0
        self._overload = overload
        self._supervisor = supervisor
        self._transport = transport
        self._grpc_client: Any = None
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, int(cfg.fleet_ship_queue)))
        self._seq = 0
        self._win_count = 0  # windows offered (the shed backoff's modulus)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.shipped = 0  # frames actually sent
        # -- spool and circuit (worker thread only, read by stats) --
        self._spool: deque[bytes] = deque()
        self._spool_cap = max(0, int(cfg.fleet_ship_spool))
        self.circuit_open = False
        self._fail_streak = 0
        self._next_retry_t = 0.0
        self.spooled = 0
        self.spool_evicted = 0
        self.spool_replayed = 0
        self.reconnects = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name=f"fleet-ship-{self.node}",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop the worker once it has shipped the frames queued before the
        stop (the engine stops its shipper after the last close, whose
        export must still ship); a spooled frame stays unsent. The wait for
        the worker is bounded by ``timeout_s``."""
        self._stop.set()
        try:
            self._q.put(None, timeout=timeout_s)  # wake the worker
        except queue_mod.Full:
            pass  # the worker sees _stop after its current item
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
        if self._supervisor is not None and self._thread is not None:
            self._supervisor.deregister(f"fleet-ship-{self.node}")
        self._thread = None

    def set_seed_generation(self, gen: int) -> None:
        """Rotate the live seed generation (tags frames from the next offer
        on; frames in flight keep theirs). One int write: any thread."""
        self.seed_gen = int(gen)

    # -- the close path (the device proxy; never blocks) ---------------------
    def offer(
        self,
        epoch: int,
        arrays: HostCopy | dict[str, Any],
        window_s: float,
        seeds: dict[str, int],
        seed_gen: int | None = None,
    ) -> bool:
        """Enqueue one window's export for shipping: a ``HostCopy`` or a
        dict of host arrays (see the module docstring). False when deferred
        (overload backoff) or dropped (queue full, stopped)."""
        # A process that never loaded torch (a churn node agent) holds no
        # tensor, card or CPU.
        torch = sys.modules.get("torch")
        if torch is not None and not isinstance(arrays, HostCopy) and any(
                isinstance(v, torch.Tensor) and v.device.type != "cpu" for v in arrays.values()):
            raise TypeError("offer a HostCopy of card tensors (to_host), not the tensors")
        if self._stop.is_set():
            return False
        m = get_metrics()
        with self._lock:
            self._win_count += 1
            count = self._win_count
        ov = self._overload
        if ov is not None and ov.state >= SHEDDING:
            every = max(1, int(self.cfg.fleet_shed_ship_every))
            if count % every != 0:
                m.fleet_ship_deferred.inc()
                return False
        gen = self.seed_gen if seed_gen is None else int(seed_gen)
        try:
            self._q.put_nowait((epoch, arrays, window_s, seeds, gen))
            return True
        except queue_mod.Full:
            m.fleet_ship_dropped.inc()
            if rate_limited("fleet.ship_queue_full"):
                self.log.warning("fleet ship queue full; dropping epoch %d", epoch)
            return False

    # -- the worker ------------------------------------------------------------
    def _run(self) -> None:
        hb = None
        if self._supervisor is not None:
            hb = self._supervisor.register(f"fleet-ship-{self.node}",
                                           self.cfg.watchdog_deadline_s)
        while not (self._stop.is_set() and self._q.empty()):
            if hb is not None:
                hb.park()
            # With frames in the spool, wake at the next retry time even if
            # the queue stays empty: the replay must not wait for closes.
            timeout = None
            if self._spool:
                timeout = max(0.01, self._next_retry_t - time.monotonic())
            try:
                item = self._q.get(timeout=timeout)
            except queue_mod.Empty:
                item = _TICK
            if item is None:
                break
            if hb is not None:
                hb.beat()
            try:
                if item is _TICK:
                    self._try_drain()
                else:
                    self._ship_one(*item)
            except Exception:
                get_metrics().fleet_ship_errors.inc()
                if rate_limited("fleet.ship"):
                    self.log.exception("fleet snapshot ship failed")

    def _ship_one(self, epoch: int, arrays: HostCopy | dict[str, Any], window_s: float,
                  seeds: dict[str, int], seed_gen: int = 0) -> None:
        rec = get_recorder()
        t0 = rec.begin()
        host = _host_arrays(arrays)
        rec.record(mn.STAGE_SHIP_READBACK, t0, int(epoch))
        with self._lock:
            seq = self._seq
            self._seq += 1
        snap = FleetSnapshot(
            node=self.node, tenant=self.tenant, priority=self.priority,
            epoch=int(epoch), seq=seq, window_s=float(window_s),
            seeds=seeds, arrays=host,
            # Trace context: the window epoch is the trace ID; the
            # aggregator's merge span joins this lineage across the wire.
            trace={"tid": int(epoch), "node": self.node},
            seed_gen=int(seed_gen),
            tier=int(self.tier),
        )
        t0 = rec.begin()
        frame = encode_snapshot(snap)
        rec.record(mn.STAGE_SHIP_ENCODE, t0, int(epoch))
        t0 = rec.begin()
        self._deliver(frame)
        rec.record(mn.STAGE_SHIP_SEND, t0, int(epoch))

    # -- delivery: circuit, spool, backoff ---------------------------------
    def _deliver(self, frame: bytes) -> None:
        """Send one fresh frame in epoch order: behind the spooled frames
        when there are any (and drain if the retry timer expired), else
        directly, spooled on failure."""
        if self._spool:
            self._spool_frame(frame)
            self._try_drain()
            return
        try:
            self._send(frame)
        except Exception:
            self._note_send_failure()
            self._spool_frame(frame)
            return
        self._note_send_ok(len(frame))

    def _try_drain(self) -> None:
        """Replay the spool oldest first once the backoff timer allows; a
        failure re-arms the timer and keeps the remaining frames."""
        if not self._spool or time.monotonic() < self._next_retry_t:
            return
        while self._spool:
            frame = self._spool[0]
            try:
                self._send(frame)
            except Exception:
                self._note_send_failure()
                return
            self._spool.popleft()
            self.spool_replayed += 1
            get_metrics().fleet_ship_spool_replayed.inc()
            self._note_send_ok(len(frame))

    def _spool_frame(self, frame: bytes) -> None:
        m = get_metrics()
        if self._spool_cap <= 0:
            return  # spooling off: dropped (the failure was counted)
        while len(self._spool) >= self._spool_cap:
            self._spool.popleft()  # oldest evicted
            self.spool_evicted += 1
            m.fleet_ship_spool_evicted.inc()
        self._spool.append(frame)
        self.spooled += 1
        m.fleet_ship_spooled.inc()

    def _note_send_ok(self, nbytes: int) -> None:
        m = get_metrics()
        m.fleet_snapshots_shipped.inc()
        m.fleet_ship_bytes.inc(nbytes)
        self.shipped += 1
        if self.circuit_open:
            self.log.info("fleet ship circuit closed after %d failures (%d frames spooled)",
                          self._fail_streak, len(self._spool))
        self.circuit_open = False
        self._fail_streak = 0
        m.fleet_ship_circuit_open.set(0.0)

    def _note_send_failure(self) -> None:
        m = get_metrics()
        m.fleet_ship_errors.inc()
        self._fail_streak += 1
        self.circuit_open = True
        m.fleet_ship_circuit_open.set(1.0)
        # Jittered exponential backoff, uniform in [base/2, backoff], so the
        # nodes cut off by one relay outage do not re-dial in lockstep.
        base = max(1e-3, float(self.cfg.fleet_ship_backoff_base_s))
        cap = max(base, float(self.cfg.fleet_ship_backoff_max_s))
        backoff = min(cap, base * (2.0 ** min(self._fail_streak - 1, 16)))
        delay = random.uniform(base / 2.0, backoff)
        self._next_retry_t = time.monotonic() + delay
        # A failed channel is torn down so the next attempt re-dials (the
        # relay may have restarted on the same address).
        if self._grpc_client is not None:
            try:
                self._grpc_client.close()
            except Exception:  # best-effort channel teardown
                pass
            self._grpc_client = None
        if rate_limited("fleet.ship_circuit"):
            self.log.warning("fleet ship failed (streak %d); retry in %.3fs, %d frames spooled",
                             self._fail_streak, delay, len(self._spool))

    def _send(self, frame: bytes) -> None:
        if self._transport is not None:
            self._transport(frame)
            return
        addr = self.cfg.fleet_relay_addr
        if addr:
            if self._grpc_client is None:
                from retina_tpu_torch.hubble.server import FleetShipClient

                if self._fail_streak:
                    self.reconnects += 1
                    get_metrics().fleet_ship_reconnects.inc()
                self._grpc_client = FleetShipClient(addr)
            self._grpc_client.ship(frame)
            return
        get_pubsub().publish(FLEET_TOPIC, frame)

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        return {
            "node": self.node,
            "tenant": self.tenant,
            "seq": self._seq,
            "shipped": self.shipped,
            "queue_depth": self._q.qsize(),
            "seed_gen": self.seed_gen,
            "circuit_open": self.circuit_open,
            "spool_depth": len(self._spool),
            "spooled": self.spooled,
            "spool_evicted": self.spool_evicted,
            "spool_replayed": self.spool_replayed,
            "reconnects": self.reconnects,
        }


def window_epoch(window_s: float, now: float | None = None) -> int:
    """Wall-clock window epoch, aligned across nodes whose clocks are
    NTP-close (a skew below window_s/2 lands in the right bucket; the
    aggregator's straggler timeout absorbs the rest)."""
    now = time.time() if now is None else now
    return int(now // max(window_s, 1e-6))
