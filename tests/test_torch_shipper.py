"""The port's fleet transport against the reference's (CPU): the node's
SnapshotShipper, the engine's close paths that feed it, the relay client
across packages, and the aggregator's subscription, publication and tier-2
re-ship.

- Shipper: for the same arrays, epoch, seeds, node, tenant, priority,
  generation and tier, the port's shipped frame equals the reference
  shipper's and ``encode_snapshot``'s byte for byte; the queue-full drop,
  the SHEDDING backoff, spool eviction and replay order through a transport
  that fails and then heals, the backoff schedule under a fixed seed, the
  circuit and ``stats()`` equal the reference's.
- Relay: the reference's ``HubbleServer`` on 127.0.0.1:0 fronts the port's
  ``FleetAggregator.ingest``; the port's shipper ships over
  ``FleetShipClient``; a stopped relay opens the circuit and spools, and a
  restarted one takes the replay with no frame lost. Without ``grpc`` a
  relay address is a failed send, never a fall back to the bus.
- Engine: a port engine with ``fleet_enabled`` ships one frame a close,
  through ``close_window`` and through ``start(stop)``, each decoding to the
  engine's own export of that close.
- Aggregator: subscribed to the bus, its rollups, ``stats()`` and
  ``fleet_*`` exposition equal the reference aggregator's on the same
  frames; a zone aggregator's re-ship through an injected transport gives a
  root aggregator the rollup of a direct merge.

Every thread join, wait and gRPC call has its own bound.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import retina_tpu.exporter as jexporter
import retina_tpu.fleet.shipper as jshipper_mod
from retina_tpu.config import Config as JConfig
from retina_tpu.fleet.aggregator import FleetAggregator as JAggregator
from retina_tpu.fleet.codec import FleetSnapshot as JSnapshot
from retina_tpu.fleet.codec import encode_snapshot as jencode
from retina_tpu.fleet.shipper import SnapshotShipper as JShipper
from retina_tpu.hubble.observer import FlowObserver
from retina_tpu.hubble.server import HubbleServer
from retina_tpu.metrics import get_metrics as jmetrics
from retina_tpu_torch import exporter, metrics
from retina_tpu_torch.config import Config
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.fleet import shipper as port_shipper
from retina_tpu_torch.fleet.aggregator import FleetAggregator
from retina_tpu_torch.fleet.codec import (
    ARRAY_CATALOG,
    FLEET_TOPIC,
    decode_snapshot,
    encode_snapshot,
)
from retina_tpu_torch.fleet.shipper import SnapshotShipper
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.pubsub import get_pubsub
from retina_tpu_torch.runtime.overload import SHEDDING
from retina_tpu_torch.timetravel.fold import host_arrays
from retina_tpu_torch.utils.device_proxy import to_host
from test_torch_engine import SMALL, escalating
from test_torch_fleet import compare_rollups, node_exports, snap
from test_torch_pipeline import PODS

WAIT_S = 30.0


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


@pytest.fixture(scope="module")
def exports():
    return node_exports("invertible", 6, seed=300)


def wait_for(pred, what: str, bound: float = WAIT_S) -> None:
    deadline = time.monotonic() + bound
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def shippers(transports=(None, None), **kw):
    """The port's and the reference's shipper at the same configuration."""
    kw = dict(fleet_enabled=True, fleet_node_name="node-a", **kw)
    return (SnapshotShipper(Config(**kw), transport=transports[0]),
            JShipper(JConfig(**kw), transport=transports[1]))


def port_value(counter) -> float:
    return counter._value


def ref_value(counter) -> float:
    return counter._value.get()


# -- the shipper ---------------------------------------------------------------------


@pytest.mark.parametrize("gen,tier", [(0, 0), (3, 0), (0, 1), (2, 1)])
def test_shipped_frames_equal_the_reference_byte_for_byte(exports, gen, tier):
    arrays, seeds = exports
    got, want = [], []
    port, ref = shippers((got.append, want.append), fleet_tenant="gold", fleet_priority=7,
                         fleet_seed_generation=gen)
    port.tier = ref.tier = tier
    port.start()
    ref.start()
    try:
        for e in range(3):
            # The engine's close hands a HostCopy; the re-shipper host arrays.
            offered = (to_host({k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                                    else v) for k, v in arrays[e].items()})
                       if e == 1 else arrays[e])
            assert port.offer(40 + e, offered, 15.0, dict(seeds))
            assert ref.offer(40 + e, arrays[e], 15.0, dict(seeds))
        wait_for(lambda: len(got) == 3 and len(want) == 3, "three frames each")
    finally:
        port.stop()
        ref.stop()
    assert got == want
    for e in range(3):
        direct = jencode(JSnapshot(
            node="node-a", tenant="gold", priority=7, epoch=40 + e, seq=e, window_s=15.0,
            seeds=dict(seeds), arrays=arrays[e], trace={"tid": 40 + e, "node": "node-a"},
            seed_gen=gen, tier=tier))
        assert got[e] == direct
    assert port.stats() == ref.stats()
    assert port_value(get_metrics().fleet_snapshots_shipped) == 3
    assert port_value(get_metrics().fleet_ship_bytes) == sum(map(len, got))
    # Bare card tensors are refused: their state moves on after the close.
    with pytest.raises(TypeError, match="HostCopy"):
        port.offer(1, {"totals": torch.zeros(8, dtype=torch.int32, device="meta")}, 1.0, seeds)


def test_queue_full_drops_without_blocking():
    port, ref = shippers(fleet_ship_queue=1)
    arrays = {"totals": np.zeros(8, np.uint32)}
    t0 = time.monotonic()
    got = [port.offer(e, arrays, 15.0, {"flow": 1}) for e in range(3)]
    assert time.monotonic() - t0 < 0.5
    assert got == [ref.offer(e, arrays, 15.0, {"flow": 1}) for e in range(3)] == [
        True, False, False]
    assert port_value(get_metrics().fleet_ship_dropped) == ref_value(
        jmetrics().fleet_ship_dropped) == 2
    port.stop(timeout_s=0.1)  # no worker: the stop must not hang on the full queue


def test_shedding_ships_one_window_in_n():
    class Shedding:
        state = SHEDDING

    port = SnapshotShipper(Config(fleet_enabled=True, fleet_shed_ship_every=4),
                           overload=Shedding())
    ref = JShipper(JConfig(fleet_enabled=True, fleet_shed_ship_every=4), overload=Shedding())
    arrays = {"totals": np.zeros(8, np.uint32)}
    got = [port.offer(e, arrays, 15.0, {}) for e in range(8)]
    assert got == [ref.offer(e, arrays, 15.0, {}) for e in range(8)]
    assert got.count(True) == 2 and port._q.qsize() == ref._q.qsize() == 2
    assert port_value(get_metrics().fleet_ship_deferred) == ref_value(
        jmetrics().fleet_ship_deferred) == 6


class Flaky:
    """A transport that raises while ``broken`` and records what it sent."""

    def __init__(self) -> None:
        self.broken = True
        self.sent: list[bytes] = []

    def __call__(self, frame: bytes) -> None:
        if self.broken:
            raise ConnectionError("relay down")
        self.sent.append(frame)


def test_spool_evicts_the_oldest_and_replays_in_order_on_heal(exports):
    arrays, seeds = exports
    tp, tr = Flaky(), Flaky()
    port, ref = shippers((tp, tr), fleet_ship_spool=3, fleet_ship_queue=8,
                         fleet_ship_backoff_base_s=0.01, fleet_ship_backoff_max_s=0.02)
    port.start()
    ref.start()
    try:
        for e in range(6):
            assert port.offer(e, arrays[e], 1.0, dict(seeds))
            assert ref.offer(e, arrays[e], 1.0, dict(seeds))
        wait_for(lambda: port.spooled == ref.spooled == 6, "six frames spooled")
        assert port.circuit_open and ref.circuit_open
        assert port.spool_evicted == ref.spool_evicted == 3
        assert port_value(get_metrics().fleet_ship_circuit_open) == 1.0
        tp.broken = tr.broken = False
        wait_for(lambda: port.shipped == ref.shipped == 3, "the replay")
        assert port.offer(6, arrays[0], 1.0, dict(seeds)) and ref.offer(6, arrays[0], 1.0,
                                                                          dict(seeds))
        wait_for(lambda: port.shipped == ref.shipped == 4, "a fresh frame after the heal")
    finally:
        port.stop()
        ref.stop()
    assert [decode_snapshot(f).epoch for f in tp.sent] == [3, 4, 5, 6]
    assert tp.sent == tr.sent
    assert port.stats() == ref.stats()
    assert port.stats()["spool_replayed"] == 3 and not port.stats()["circuit_open"]
    m, jm = get_metrics(), jmetrics()
    for name in ("fleet_ship_spooled", "fleet_ship_spool_evicted", "fleet_ship_spool_replayed",
                 "fleet_snapshots_shipped"):
        assert port_value(getattr(m, name)) == ref_value(getattr(jm, name)), name
    assert port_value(m.fleet_ship_errors) >= 1 and port_value(m.fleet_ship_circuit_open) == 0.0


def test_backoff_schedule_and_circuit_under_a_fixed_seed(monkeypatch):
    clock = types.SimpleNamespace(monotonic=lambda: 100.0)
    monkeypatch.setattr(port_shipper, "time", clock)
    monkeypatch.setattr(jshipper_mod, "time", clock)
    monkeypatch.setattr(port_shipper, "random", random.Random(7))
    monkeypatch.setattr(jshipper_mod, "random", random.Random(7))
    port, ref = shippers(fleet_ship_backoff_base_s=0.05, fleet_ship_backoff_max_s=2.0)

    class Channel:
        closed = False

        def close(self):
            self.closed = True

    chan = Channel()
    port._grpc_client = chan
    delays = []
    for n in range(1, 12):
        port._note_send_failure()
        ref._note_send_failure(frame_lost=False)
        assert port._next_retry_t == ref._next_retry_t
        delay = port._next_retry_t - 100.0
        assert 0.025 <= delay <= min(2.0, 0.05 * 2 ** (n - 1))
        delays.append(delay)
        assert port.circuit_open and port._fail_streak == n
    assert chan.closed and port._grpc_client is None  # the channel is re-dialed
    assert max(delays[-4:]) > 0.4  # the schedule grew toward its cap
    assert port_value(get_metrics().fleet_ship_circuit_open) == 1.0
    port._note_send_ok(100)
    ref._note_send_ok(100)
    assert not port.circuit_open and port._fail_streak == 0
    assert port_value(get_metrics().fleet_ship_circuit_open) == 0.0
    assert port.stats() == ref.stats()


def test_relay_client_ships_to_the_reference_relay_and_survives_an_outage(exports):
    """The port's shipper over FleetShipClient to the reference's relay, which
    fronts the port's aggregator: three epochs merge to the rollups of the
    same frames ingested directly; a stopped relay opens the circuit and
    spools; the restarted relay takes the replay, no frame lost."""
    arrays, seeds = exports
    acfg = Config(fleet_expected_nodes=1, fleet_topk_k=12)
    agg = FleetAggregator(acfg, device="cpu")
    frames: list[bytes] = []

    def ingest(frame: bytes) -> bool:
        frames.append(frame)
        return agg.ingest(frame)

    srv = HubbleServer(FlowObserver(capacity=16), addr="127.0.0.1:0", fleet_ingest=ingest)
    srv.start()
    port_no = srv.port
    ship = SnapshotShipper(Config(fleet_enabled=True, fleet_node_name="relay-node",
                                  fleet_relay_addr=f"127.0.0.1:{port_no}", fleet_ship_queue=8,
                                  fleet_ship_backoff_base_s=0.02, fleet_ship_backoff_max_s=0.1))
    ship.start()
    srv2 = None
    try:
        for e in range(3):
            assert ship.offer(e, arrays[e], 1.0, dict(seeds))
        wait_for(lambda: agg.epochs_merged == 3, "three merged epochs over the relay")
        direct = FleetAggregator(acfg, device="cpu")
        for f in frames:
            assert direct.ingest(f)
        for got, want in zip(agg.rollups, direct.rollups):
            compare_rollups(got, want)
        assert [decode_snapshot(f).epoch for f in frames] == [0, 1, 2]

        srv.stop(0)
        for e in (3, 4):
            assert ship.offer(e, arrays[e], 1.0, dict(seeds))
        wait_for(lambda: ship.spooled == 2 and ship.circuit_open, "the outage's spool")
        srv2 = HubbleServer(FlowObserver(capacity=16), addr=f"127.0.0.1:{port_no}",
                            fleet_ingest=ingest)
        srv2.start()
        wait_for(lambda: agg.epochs_merged == 5, "the replay after the relay's restart")
    finally:
        ship.stop()
        srv.stop(0)
        if srv2 is not None:
            srv2.stop(0)
    st = ship.stats()
    assert (st["shipped"], st["spool_replayed"], st["spool_depth"], st["circuit_open"]) == (
        5, 2, 0, False)
    assert st["reconnects"] >= 1
    assert agg.received == {"relay-node": 5}
    assert [r["epoch"] for r in agg.rollups] == [0, 1, 2, 3, 4]


def test_relay_address_without_grpc_spools_and_never_uses_the_bus(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)
    seen: list[bytes] = []
    bus = get_pubsub()
    sub = bus.subscribe(FLEET_TOPIC, seen.append)
    ship = SnapshotShipper(Config(fleet_enabled=True, fleet_relay_addr="127.0.0.1:9",
                                  fleet_ship_backoff_base_s=0.01, fleet_ship_backoff_max_s=0.02))
    ship.start()
    try:
        assert ship.offer(1, {"totals": np.ones(8, np.uint32)}, 1.0, {"flow": 1})
        wait_for(lambda: ship.spooled == 1, "the failed send's spool")
        time.sleep(0.1)  # retries at the backoff's pace
    finally:
        ship.stop()
        bus.unsubscribe(FLEET_TOPIC, sub)
    assert ship.circuit_open and ship.shipped == 0 and not seen
    assert port_value(get_metrics().fleet_ship_errors) >= 1


# -- the engine's close paths ----------------------------------------------------------


def engine(**kw) -> SketchEngine:
    cfg = Config(**dict(SMALL, fleet_enabled=True, fleet_node_name="eng-test",
                        heavy_keys_source="invertible", invertible_width=1 << 8,
                        invertible_hi_width=1 << 6, **kw))
    eng = SketchEngine(cfg, device="cpu")
    eng.update_identities(PODS)
    return eng


def test_close_window_ships_one_frame_a_close():
    eng = engine()
    got: list[bytes] = []
    eng._fleet_shipper._transport = got.append
    exports = []
    try:
        for w in range(3):
            eng.step_records(escalating(60 + w), now_s=300 + w)
            epoch, arrays, window_s, seeds = eng.close_window(epoch=90 + w)["export"]
            exports.append((epoch, host_arrays(arrays), window_s, seeds))
        wait_for(lambda: len(got) == 3, "three frames")
    finally:
        eng.stop()
    for frame, (epoch, arrays, window_s, seeds) in zip(got, exports):
        s = decode_snapshot(frame)
        assert (s.node, s.epoch, s.window_s, s.seeds) == ("eng-test", epoch, window_s, seeds)
        assert set(s.arrays) == set(arrays) == set(ARRAY_CATALOG)
        for name, a in arrays.items():
            np.testing.assert_array_equal(s.arrays[name], a, err_msg=name)
        assert int(s.arrays["totals"][0]) > 0 and (s.arrays["inv_flow_weights"] > 0).any()
    assert [decode_snapshot(f).seq for f in got] == [0, 1, 2]


def test_the_lanes_ship_one_frame_a_close_and_the_last_at_stop():
    eng = engine(window_seconds=0.3, overload_enabled=False, feed_pipeline_depth=0)
    got: list[bytes] = []
    eng._fleet_shipper._transport = got.append
    exports: list[dict] = []
    fleet_export = eng.telemetry.fleet_export

    def recording_export(state):
        out = fleet_export(state)
        exports.append(host_arrays(out))
        return out

    eng.telemetry.fleet_export = recording_export
    stop = threading.Event()
    t = threading.Thread(target=eng.start, args=(stop,), daemon=True)
    t.start()
    try:
        for w in range(3):
            eng.sink.write_records(escalating(70 + w), "gen")
            wait_for(lambda: len(exports) > w, f"the close of window {w}")
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive()
    eng.stop()
    # The shipper stops after the lanes' last close: every export shipped.
    assert len(got) == len(exports) >= 3
    for frame, arrays in zip(got, exports):
        s = decode_snapshot(frame)
        assert s.node == "eng-test" and int(s.arrays["totals"][0]) > 0
        for name, a in arrays.items():
            np.testing.assert_array_equal(s.arrays[name], a, err_msg=name)
    assert not eng._fleet_shipper.offer(1, exports[0], 1.0, {})  # stopped


# -- the aggregator: subscription, publication, re-ship -------------------------------


def fleet_samples(text: bytes) -> dict[str, float]:
    """The fleet_* samples of an exposition (without counters' _created
    lines and the merge's wall time)."""
    out = {}
    for line in text.decode().splitlines():
        if not line.startswith("networkobservability_fleet_") or "_created" in line:
            continue
        if line.startswith("networkobservability_fleet_merge_seconds"):
            continue
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


def test_subscribed_aggregator_publishes_like_the_reference(exports):
    arrays, seeds = exports
    cfg = dict(fleet_expected_nodes=3, fleet_topk_k=10, fleet_service_top=6,
               fleet_tenant_series_max=4, fleet_max_tenants=2)
    port = FleetAggregator(Config(**cfg), device="cpu")
    ref = JAggregator(JConfig(fleet_aggregator=True, **cfg))
    rollups: list[dict] = []
    bus = get_pubsub()
    sub = bus.subscribe("fleet/rollups", rollups.append)
    port.start(subscribe=True)
    try:
        tenants = [("gold", 3), ("silver", 2), ("bronze", 1)]
        for epoch in (5, 6):
            for i in range(3):
                frame = encode_snapshot(snap(arrays[i + 3 * (epoch - 5)], seeds,
                                             node=f"n{i}", epoch=epoch, tenant=tenants[i][0],
                                             priority=tenants[i][1]))
                bus.publish(FLEET_TOPIC, frame)
                assert ref.ingest(frame)
            wait_for(lambda: port.epochs_merged == epoch - 4, f"epoch {epoch}")
            assert port.stats() == ref.stats()
            compare_rollups(port.rollups[-1], ref.rollups[-1])
            got = fleet_samples(exporter.get_exporter().gather_text())
            want = fleet_samples(jexporter.get_exporter().gather_text())
            assert set(got) == set(want)
            for series, v in want.items():
                assert got[series] == pytest.approx(v, rel=1e-5), series
        wait_for(lambda: len(rollups) == 2, "the rollups on ROLLUP_TOPIC")
    finally:
        port.stop()
        bus.unsubscribe("fleet/rollups", sub)
    assert port._sub_id is None and not bus.has_subscribers(FLEET_TOPIC)
    assert [r["epoch"] for r in rollups] == [5, 6] and port.tenants_shed == 2
    assert port_value(get_metrics().fleet_windows_merged) == 2


def test_zone_reship_gives_the_root_the_direct_merge(exports):
    """A zone aggregator re-ships its merged epoch (tier 1) through an
    injected transport to a root aggregator: the root's merged arrays equal
    a direct merge of the zone's three frames, and the root's rollup is the
    rollup of that merge as one node's frame (the reference's algebra: the
    root sees the zone as one big node)."""
    arrays, seeds = exports
    tt = dict(timetravel_enabled=True)
    root = FleetAggregator(Config(fleet_expected_nodes=1, **tt), device="cpu")
    zone = FleetAggregator(Config(fleet_expected_nodes=3, fleet_node_name="zone-a",
                                  fleet_tenant="zone"), device="cpu", reship_transport=root.ingest)
    direct = FleetAggregator(Config(fleet_expected_nodes=3, **tt), device="cpu")
    zone.start(subscribe=False)
    try:
        for i in range(3):
            frame = encode_snapshot(snap(arrays[i], seeds, node=f"n{i}", epoch=8))
            assert zone.ingest(frame) and direct.ingest(frame)
        wait_for(lambda: root.epochs_merged == 1, "the re-shipped epoch at the root")
    finally:
        zone.stop()
    assert zone.stats()["reship"]["shipped"] == 1
    (_, root_arrays, _, root_seeds), = root.epoch_ring.select(8, 9)
    (_, want_arrays, _, _), = direct.epoch_ring.select(8, 9)
    assert root_seeds == seeds and set(root_arrays) == set(want_arrays) == set(arrays[0])
    for name, a in want_arrays.items():
        np.testing.assert_array_equal(root_arrays[name], a, err_msg=name)
    one = FleetAggregator(Config(fleet_expected_nodes=1), device="cpu")
    assert one.ingest(encode_snapshot(snap(want_arrays, seeds, node="zone-a", epoch=8,
                                           tenant="zone")))
    got = root.rollups[-1]
    assert got["nodes"] == ["zone-a"] and list(got["tenants"]) == ["zone"]
    compare_rollups(got, one.rollups[-1])
    # What the merged arrays alone decide equals the direct merge's rollup.
    want = direct.rollups[-1]
    np.testing.assert_array_equal(got["totals"], want["totals"])
    assert got["distinct_flows"] == want["distinct_flows"]
    assert got["entropy_bits"] == want["entropy_bits"]
    for key in ("keys", "est", "tier"):
        np.testing.assert_array_equal(got["invertible"][key], want["invertible"][key])
    for g, w in zip(got["top_flow"], want["top_flow"]):  # counted at the decoded keys
        np.testing.assert_array_equal(g, w)
    assert port_value(get_metrics().fleet_rollups_reshipped) == 1


def test_aggregator_supervisor_registers_and_deregisters_fleet_agg():
    from retina_tpu_torch.runtime.supervisor import Supervisor

    sup = Supervisor()
    agg = FleetAggregator(Config(), device="cpu", supervisor=sup)
    agg.start(subscribe=False)
    try:
        wait_for(lambda: sup.heartbeat("fleet-agg") is not None, "the heartbeat")
    finally:
        agg.stop()
    assert sup.heartbeat("fleet-agg") is None


def test_reshipper_config_dials_the_reship_address():
    agg = FleetAggregator(Config(fleet_reship_addr="127.0.0.1:9"), device="cpu")
    assert agg._reshipper is not None and agg._reshipper.tier == 1
    assert agg._reshipper.cfg.fleet_relay_addr == "127.0.0.1:9"
    assert dataclasses.replace(agg.cfg, fleet_relay_addr="") == agg.cfg
    assert FleetAggregator(Config(), device="cpu")._reshipper is None
