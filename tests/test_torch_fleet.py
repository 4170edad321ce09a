"""The port's fleet tier against the reference's (CPU): the MessagePack
subset against ``msgpack``, RFLT frames byte for byte in both directions,
and the FleetAggregator's drops, quorum, straggler poll, epoch overflow,
seed-generation vote, tenant guardrails and rollup.

Frames are real window exports: nodes step traffic through the port's
Telemetry at small cuts of the deployed and invertible configurations.
Rollup rules: keys, counts, totals, decoded keys, tenants and node lists
exactly; the HLL cardinalities and entropy bits within rtol 1e-5 (float32
sums and logarithms in two libraries).
"""

from __future__ import annotations

import dataclasses
import struct
import time

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from retina_tpu.config import Config as JConfig
from retina_tpu.fleet.aggregator import FleetAggregator as JAggregator
from retina_tpu.fleet.codec import FleetSnapshot as JSnapshot
from retina_tpu.fleet.codec import decode_snapshot as jdecode
from retina_tpu.fleet.codec import encode_snapshot as jencode
from retina_tpu.fleet.shipper import window_epoch as jwindow_epoch
from retina_tpu_torch.config import Config
from retina_tpu_torch.utils import _msgpack
from retina_tpu_torch.fleet.aggregator import FleetAggregator, format_key
from retina_tpu_torch.fleet.codec import (
    ARRAY_CATALOG,
    FleetDecodeError,
    FleetSnapshot,
    decode_snapshot,
    encode_snapshot,
)
from retina_tpu_torch.fleet.shipper import window_epoch
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig
from retina_tpu_torch.parallel.telemetry import Telemetry
from retina_tpu_torch.timetravel.fold import host_arrays
from retina_tpu_torch.u32 import from_numpy
from test_torch_pipeline import API, B, PODS, SMALL_CUTS, traffic

# -- the MessagePack subset ------------------------------------------------------

WIDTHS = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x100000000,
          (1 << 64) - 1, -1, -0x20, -0x21, -0x80, -0x81, -0x8000, -0x8001, -(1 << 31),
          -(1 << 31) - 1, -(1 << 63)]
_scalars = (st.none() | st.booleans() | st.sampled_from(WIDTHS)
            | st.integers(-(1 << 63), (1 << 64) - 1) | st.floats(allow_nan=False)
            | st.text(max_size=40) | st.binary(max_size=300))
_values = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=20) | st.dictionaries(st.text(max_size=12), inner,
                                                                 max_size=20),
    max_leaves=40,
)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_msgpack_subset_matches_msgpack(obj):
    packed = _msgpack.packb(obj)
    assert packed == msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.unpackb(packed) == msgpack.unpackb(packed, raw=False)


@pytest.mark.parametrize("n", [31, 32, 255, 256, 65535, 65536])
def test_msgpack_lengths_at_every_format_boundary(n):
    for obj in ("x" * n, b"y" * n, list(range(min(n, 70000))),
                {str(i): i for i in range(min(n, 17))}):
        assert _msgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True)
        assert _msgpack.unpackb(_msgpack.packb(obj)) == msgpack.unpackb(
            msgpack.packb(obj, use_bin_type=True), raw=False)


def test_msgpack_rejects_what_msgpack_rejects():
    for bad in (b"\x92\x01", b"\x01\x02", b"\xc1", b"\x81\x01\x02"):
        with pytest.raises(ValueError):
            _msgpack.unpackb(bad)
        with pytest.raises(Exception):
            msgpack.unpackb(bad, raw=False)
    with pytest.raises(ValueError):
        _msgpack.packb(1 << 64)
    with pytest.raises(ValueError):
        _msgpack.packb(object())


# -- frames ----------------------------------------------------------------------------


def node_exports(cut: str, n_nodes: int, seed: int = 80) -> tuple[list[dict], dict]:
    """One window's export (host arrays) of each of n nodes, and the seeds."""
    tel = Telemetry(PipelineConfig(**SMALL_CUTS[cut]), device="cpu")
    ident = IdentityMap.build_host(PODS, n_slots=1 << 8, device="cpu")
    out = []
    for i in range(n_nodes):
        rec = from_numpy(traffic(seed + i, 1)[0], "cpu")
        st, _ = tel.step(tel.init_state(), rec, B, 100 + i, ident, apiserver_ip=API)
        out.append(host_arrays(tel.fleet_export(st)))
    return out, Telemetry.fleet_seeds(st)


def snap(arrays, seeds, node="n0", epoch=5, tenant="default", priority=0, seq=1, **kw):
    return FleetSnapshot(node=node, tenant=tenant, priority=priority, epoch=epoch, seq=seq,
                         window_s=1.0, seeds=dict(seeds), arrays=arrays, **kw)


def as_reference(s: FleetSnapshot) -> JSnapshot:
    return JSnapshot(**{f.name: getattr(s, f.name) for f in dataclasses.fields(FleetSnapshot)})


@pytest.fixture(scope="module")
def exports():
    return node_exports("invertible", 4)


@pytest.mark.parametrize("extra", [{}, {"trace": {"tid": 77, "node": "n0"}}, {"seed_gen": 3},
                                   {"tier": 1}, {"trace": {"tid": 1}, "seed_gen": 2, "tier": 2}],
                         ids=["plain", "trace", "sgen", "tier", "all"])
def test_frames_are_byte_identical_and_cross_decode(exports, extra):
    arrays, seeds = exports
    s = snap(arrays[0], seeds, node="node-é", tenant="t1", priority=3, seq=7, **extra)
    frame = encode_snapshot(s)
    assert frame == jencode(as_reference(s))
    for decoded in (decode_snapshot(frame), jdecode(frame)):
        for f in ("node", "tenant", "priority", "epoch", "seq", "window_s", "seeds", "trace",
                  "seed_gen", "tier"):
            assert getattr(decoded, f) == getattr(s, f), f
        assert set(decoded.arrays) == set(arrays[0])
        for name, a in arrays[0].items():
            assert decoded.arrays[name].dtype == ARRAY_CATALOG[name][0]
            np.testing.assert_array_equal(decoded.arrays[name], a)
    # The HLL banks travel as u8.
    hdr = _msgpack.unpackb(frame[9:9 + struct.unpack("<I", frame[5:9])[0]])
    assert {r["n"]: r["d"] for r in hdr["arrays"]}["hll_src_per_pod"] == "uint8"


def test_decoder_rejects_malformed_frames(exports):
    arrays, seeds = exports
    frame = encode_snapshot(snap(arrays[1], seeds))
    hlen = struct.unpack("<I", frame[5:9])[0]
    header = _msgpack.unpackb(frame[9:9 + hlen])
    header["arrays"][0]["n"] = "not_in_catalog"
    new = _msgpack.packb(header)
    tampered = frame[:5] + struct.pack("<I", len(new)) + new + frame[9 + hlen:]
    for bad in (b"", b"XXXX" + frame[4:], frame[:4] + b"\x02" + frame[5:], frame[:-10],
                frame + b"\x00", tampered, frame[:9] + b"\xc1" + frame[10:]):
        with pytest.raises(FleetDecodeError):
            decode_snapshot(bad)
        with pytest.raises(Exception):
            jdecode(bad)
    with pytest.raises(ValueError, match="catalog"):
        encode_snapshot(snap({"nope": np.zeros(2, np.uint32)}, seeds))
    with pytest.raises(ValueError, match="must be"):
        encode_snapshot(snap({"totals": np.zeros(8, np.int64)}, seeds))


def test_window_epoch_matches_reference():
    for w, now in ((1.0, 1234.5), (15.0, 1_700_000_007.9), (0.0, 3.0)):
        assert window_epoch(w, now) == jwindow_epoch(w, now)
    assert abs(window_epoch(1.0) - int(time.time())) <= 1


# -- the aggregator ----------------------------------------------------------------


def aggregators(**kw):
    return (FleetAggregator(Config(**kw), device="cpu"),
            JAggregator(JConfig(fleet_aggregator=True, **kw)))


def compare_rollups(got: dict, want: dict) -> None:
    want = dict(want)
    assert set(got) == set(want)
    for key in ("epoch", "nodes", "window_s", "straggled", "seed_gen"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["totals"], want["totals"])
    assert got["totals"].dtype == want["totals"].dtype
    for fam in ("flow", "svc", "dns"):
        for g, w in zip(got[f"top_{fam}"], want[f"top_{fam}"]):
            np.testing.assert_array_equal(g, w, err_msg=fam)
            assert g.dtype == w.dtype
    if "invertible" in want:
        for key in ("keys", "est", "tier"):
            np.testing.assert_array_equal(got["invertible"][key], want["invertible"][key])
        for g, w in zip(got["invertible"]["sources"], want["invertible"]["sources"]):
            np.testing.assert_array_equal(g, w)
    assert got["distinct_flows"] == pytest.approx(want["distinct_flows"], rel=1e-5)
    assert set(got["entropy_bits"]) == set(want["entropy_bits"])
    for dim, bits in want["entropy_bits"].items():
        assert got["entropy_bits"][dim] == pytest.approx(bits, rel=1e-5), dim
    # Per-service cardinality: the same estimates; pods of near-equal
    # estimates may swap places across the top-N cut.
    g_svc, w_svc = dict(got["service_cardinality"]), dict(want["service_cardinality"])
    assert len(g_svc) == len(w_svc)
    np.testing.assert_allclose(sorted(g_svc.values()), sorted(w_svc.values()), rtol=1e-5)
    for pod in g_svc.keys() & w_svc.keys():
        assert g_svc[pod] == pytest.approx(w_svc[pod], rel=1e-5)
    assert set(got["tenants"]) == set(want["tenants"])
    for tenant, w in want["tenants"].items():
        g = got["tenants"][tenant]
        assert (g["priority"], g["nodes"]) == (w["priority"], w["nodes"])
        for a, b in zip(g["top_flows"], w["top_flows"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cut", ["invertible", "deployed"])
def test_rollup_matches_reference_aggregator(cut):
    arrays, seeds = node_exports(cut, 6, seed=90)
    port, ref = aggregators(fleet_expected_nodes=6, fleet_topk_k=12, fleet_service_top=8,
                            fleet_tenant_series_max=5, timetravel_enabled=True)
    tenants = ["gold", "gold", "silver", "silver", "silver", "bronze"]
    kops.reset_launch_counts()
    for i in (3, 0, 5, 1, 4, 2):  # arrival order is not merge order
        frame = encode_snapshot(snap(arrays[i], seeds, node=f"n{i}", epoch=9,
                                     tenant=tenants[i], priority=5 - i))
        assert port.ingest(frame) and ref.ingest(frame)
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}  # CPU: plain
    assert port.epochs_merged == ref.epochs_merged == 1
    got, want = port.rollups[-1], ref.rollups[-1]
    compare_rollups(got, want)
    assert len(got["top_flow"][0]) == 12 and len(got["tenants"]["gold"]["top_flows"][0]) == 5
    assert ("invertible" in got) == (cut == "invertible")
    if cut == "invertible":
        assert len(got["invertible"]["keys"]) > 0
    # The merged epoch is a slot of both epoch rings.
    (_, g_arrays, _, g_seeds), = port.epoch_ring.select(9, 10)
    (_, w_arrays, _, w_seeds), = ref.epoch_ring.select(9, 10)
    assert g_seeds == w_seeds and set(g_arrays) == set(w_arrays)
    for name in w_arrays:
        np.testing.assert_array_equal(g_arrays[name], np.asarray(w_arrays[name]), err_msg=name)
    assert port.stats()["watermark"] == 9 and format_key(got["top_flow"][0][0]).count("-") == 3


def test_every_drop_reason_matches_reference():
    arrays, seeds = node_exports("deployed", 3, seed=100)
    port, ref = aggregators(fleet_expected_nodes=2)
    small = {k: v[..., :4] if k.endswith("_cms") else v for k, v in arrays[2].items()}
    frames = [
        (encode_snapshot(snap(arrays[0], seeds, node="a", epoch=4)), True, None),
        (encode_snapshot(snap(arrays[1], seeds, node="a", epoch=4)), False, "duplicate"),
        (encode_snapshot(snap(arrays[1], dict(seeds, flow=999), node="b", epoch=4)), False,
         "seed_mismatch"),
        (encode_snapshot(snap(small, seeds, node="b", epoch=4)), False, "shape_mismatch"),
        (b"not a frame", False, "decode"),
        (encode_snapshot(snap(arrays[1], seeds, node="b", epoch=4)), True, None),  # quorum
        (encode_snapshot(snap(arrays[2], seeds, node="c", epoch=4)), False, "late"),
        (encode_snapshot(snap(arrays[2], seeds, node="c", epoch=3)), False, "late"),
    ]
    want = dict.fromkeys(port.dropped, 0)
    for frame, accepted, reason in frames:
        assert port.ingest(frame) is accepted and ref.ingest(frame) is accepted
        if reason:
            want[reason] += 1
    assert port.dropped == want
    assert port.epochs_merged == ref.epochs_merged == 1
    assert port.received == {"a": 1, "b": 1}
    compare_rollups(port.rollups[-1], ref.rollups[-1])


def test_straggler_poll_overflow_and_async_merge():
    arrays, seeds = node_exports("deployed", 3, seed=110)
    port, ref = aggregators(fleet_expected_nodes=3, fleet_straggler_timeout_s=0.5)
    for i in range(2):  # the third node is dead
        frame = encode_snapshot(snap(arrays[i], seeds, node=f"n{i}", epoch=9))
        assert port.ingest(frame) and ref.ingest(frame)
    assert port.poll() == 0 and port.epochs_merged == 0  # not yet timed out
    later = time.monotonic() + 5.0
    assert port.poll(now=later) == ref.poll(now=later) == 1
    assert port.rollups[-1]["straggled"] and port.stragglers == 1
    compare_rollups(port.rollups[-1], ref.rollups[-1])
    # fleet_epoch_history: the oldest open epoch is force-closed.
    port, ref = aggregators(fleet_expected_nodes=4, fleet_epoch_history=2)
    for e in range(5):
        frame = encode_snapshot(snap(arrays[e % 3], seeds, node="solo", epoch=e))
        assert port.ingest(frame) and ref.ingest(frame)
    assert port.stats()["open_epochs"] == ref.stats()["open_epochs"] == [3, 4]
    assert port.epochs_merged == ref.epochs_merged == 3
    assert port.open_buckets_max == ref.open_buckets_max == 3
    for g, w in zip(port.rollups, ref.rollups):
        compare_rollups(g, w)
    # fleet_merge_async: ingest defers the quorum-closed merge to poll.
    port = FleetAggregator(Config(fleet_expected_nodes=2, fleet_merge_async=True),
                           device="cpu")
    for i in range(2):
        assert port.ingest(encode_snapshot(snap(arrays[i], seeds, node=f"n{i}", epoch=1)))
    assert port.epochs_merged == 0 and port.stats()["ready_q"] == 1
    port.start()
    deadline = time.monotonic() + 10.0
    while port.epochs_merged == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    port.stop()
    assert port.epochs_merged == 1 and not port.rollups[-1]["straggled"]


def test_seed_generation_vote_and_tenant_shedding():
    arrays, seeds = node_exports("deployed", 4, seed=120)
    port, ref = aggregators(fleet_expected_nodes=4, fleet_max_tenants=2,
                            fleet_tenant_series_max=3)
    for i, (tenant, prio, gen) in enumerate([("gold", 9, 1), ("silver", 5, 1),
                                            ("bronze", 1, 1), ("gold", 9, 0)]):
        frame = encode_snapshot(snap(arrays[i], seeds, node=f"n{i}", epoch=2, tenant=tenant,
                                     priority=prio, seed_gen=gen))
        assert port.ingest(frame) and ref.ingest(frame)
    got, want = port.rollups[-1], ref.rollups[-1]
    compare_rollups(got, want)
    assert got["seed_gen"] == 1 and got["nodes"] == ["n0", "n1", "n2"]
    assert port.dropped["gen_skew"] == 1
    assert set(got["tenants"]) == {"gold", "silver"} and port.tenants_shed == 1
    assert all(len(t["top_flows"][0]) <= 3 for t in got["tenants"].values())
    assert port.stats()["generations"] == [0, 1]
