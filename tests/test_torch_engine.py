"""The port's SketchEngine feed path against the reference SketchEngine (CPU).

The same records go through the reference engine's ``step_records`` (on one
CPU device: ``tests/conftest.py`` makes eight, and a default engine would
partition across all of them) and the port's, and the whole state is
compared after every quantum under the rules of
``tests/test_torch_pipeline.py``: integers exactly, except top-k key rows of
tied estimates; floats within rtol 1e-5. The feed path adds no allowance.
The cases cover both aggregation levels, the v3 and v4 known wires, a
dictionary small enough to clear, rows that escalate (over 2^10 packets,
over 2^22 bytes, TSval carriers, unstamped rows), a flush below
``transfer_min_bucket``, the unpacked wire and the invertible
configuration, which has no dictionary. The configuration itself is held
to the reference's ``Config`` and ``pipeline_config_from``.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from retina_tpu.config import Config as JConfig
from retina_tpu.engine import SketchEngine as JEngine
from retina_tpu.engine import pipeline_config_from as jpipeline_config_from
from retina_tpu.events.synthetic import TrafficGen
from retina_tpu_torch.config import Config
from retina_tpu_torch.engine import FeedStages, SketchEngine, pipeline_config_from
from retina_tpu_torch.events.schema import F
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models.pipeline import DEPLOYED_CONFIG, INVERTIBLE_CONFIG
from retina_tpu_torch.ops.countmin import CountMinSketch
from retina_tpu_torch.ops.topk import slots as topk_slots
from retina_tpu_torch.timetravel.fold import host_arrays
from retina_tpu_torch.u32 import to_numpy
from test_torch_pipeline import PODS, compare_states
from test_torch_wire import reference_native  # noqa: F401 (a fixture)

SMALL = dict(
    batch_capacity=1 << 10, n_pods=64, cms_width=1 << 10, cms_depth=4, topk_slots=1 << 6,
    hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 8, identity_slots=1 << 8,
    flow_dict_slots=1 << 12, transfer_min_bucket=64,
)


def _configs(**kw):
    jcfg, cfg = JConfig(), Config()
    for k, v in dict(SMALL, **kw).items():
        setattr(jcfg, k, v)
        setattr(cfg, k, v)
    return jcfg, cfg


def _engines(**kw):
    jcfg, cfg = _configs(**kw)
    jeng = JEngine(jcfg, devices=[jax.devices("cpu")[0]])
    eng = SketchEngine(cfg, device="cpu")
    jeng.update_identities(PODS)
    eng.update_identities(PODS)
    return jeng, eng


def _compare(jeng, eng):
    compare_states(jax.tree.map(lambda x: x[0], jeng.state), eng.state)


def escalating(seed: int, n: int = 900, n_flows: int = 300) -> np.ndarray:
    """TrafficGen rows with some that the known wire cannot carry."""
    rec = TrafficGen(n_flows=n_flows, n_pods=48, seed=seed).batch(n)
    rng = np.random.default_rng(seed)
    rec[::50, F.PACKETS] = 2000  # over the dense lane's 2^10
    rec[3::50, F.BYTES] = 5_000_000  # over the dense lane's 2^22
    rec[5::40, F.TSVAL] = rng.integers(1, 1 << 31, len(rec[5::40]))
    rec[7::40, F.TS_LO] = 0  # unstamped
    rec[7::40, F.TS_HI] = 0
    return rec


def _feed(jeng, eng, quanta, now0=100):
    for i, q in enumerate(quanta):
        jeng.step_records(q, now_s=now0 + 3 * i)
        eng.step_records(q, now_s=now0 + 3 * i)
        _compare(jeng, eng)


CASES = {
    "low_v4": {},
    "high_v4": dict(data_aggregation_level="high"),
    "low_v3": dict(wire_dense_known=False),
    "high_v3": dict(data_aggregation_level="high", wire_dense_known=False),
    "clearing": dict(flow_dict_slots=1 << 8),
    "clearing_v3": dict(flow_dict_slots=1 << 8, wire_dense_known=False),
    "unpacked": dict(transfer_packed=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_records_matches_reference_engine(case):
    jeng, eng = _engines(**CASES[case])
    ring = [escalating(s) for s in (1, 2, 3)]
    kops.reset_launch_counts()
    _feed(jeng, eng, ring + ring)  # the replay meets known descriptors
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}  # CPU: plain versions
    if eng._flow_dict is not None:
        assert (len(eng._flow_dict), eng._flow_dict.generation) == (
            len(jeng._flow_dict), jeng._flow_dict.generation)
        assert eng.counts.known_rows > 0 and eng.counts.new_rows > 0
        if "clearing" in case:
            assert eng._flow_dict.generation > 0
    assert int(to_numpy(eng.state.totals)[0]) == sum(
        int(q[:, F.PACKETS].astype(np.uint64).sum()) for q in ring + ring) & 0xFFFFFFFF


def test_invertible_takes_the_packed_wire():
    jeng, eng = _engines(heavy_keys_source="invertible")
    assert eng._flow_dict is None and jeng._flow_dict is None
    assert eng.pcfg.enable_invertible
    ring = [escalating(s) for s in (4, 5)]
    _feed(jeng, eng, ring + ring)
    assert eng.counts.packed_rows == 4 * 900 and eng.counts.new_rows == 0
    out = eng.close_window()
    assert {"inv", "entropy_bits", "anomaly", "zscore"} <= set(out)
    assert out["inv"]["ok"].any()


@pytest.mark.parametrize("source", ["flowdict", "invertible"])
def test_close_window_exports_to_the_ring_and_the_caller_like_reference(source):
    """The export close_window takes before end_window equals the reference
    engine's fleet_export for the same records (candidate key rows under
    the tie rule of compare_states), goes to the ring unchanged, and comes
    back under "export" with the epoch, window and seeds."""
    jcfg, cfg = _configs(heavy_keys_source=source)
    jeng = JEngine(jcfg, devices=[jax.devices("cpu")[0]])
    eng = SketchEngine(dataclasses.replace(cfg, timetravel_enabled=True, fleet_enabled=True,
                                           timetravel_ring_windows=2), device="cpu")
    jeng.update_identities(PODS)
    eng.update_identities(PODS)
    for w in range(3):
        _feed(jeng, eng, [escalating(20 + 2 * w), escalating(21 + 2 * w)], now0=100 + 10 * w)
        want = {k: np.asarray(v) for k, v in jeng.sharded.fleet_export(jeng.state).items()}
        jseeds = jeng.sharded.fleet_seeds(jeng.state)
        out = eng.close_window(epoch=50 + w)
        jeng.state, _ = jeng.sharded.end_window(jeng.state)
        epoch, arrays, window_s, seeds = out["export"]
        assert (epoch, window_s, seeds) == (50 + w, 1.0, jseeds)
        assert ("inv" in out) == (source == "invertible")
        got = host_arrays(arrays)
        assert set(got) == set(want)
        for name, ref in want.items():
            assert got[name].dtype == ref.dtype and got[name].shape == ref.shape, name
            if not name.endswith("_keys"):
                np.testing.assert_array_equal(got[name], ref, err_msg=name)
                continue
            fam = name[: -len("_keys")]
            diff = np.nonzero((got[name] != ref).any(axis=1))[0]
            rows = torch.from_numpy(got[name][diff].astype(np.int64))
            cols = [rows[:, c] for c in range(rows.shape[1])]
            seed = seeds[fam]
            np.testing.assert_array_equal(topk_slots(len(ref), seed, cols).numpy(), diff)
            cms = CountMinSketch(torch.from_numpy(got[f"{fam}_cms"].view(np.int32)), seed)
            np.testing.assert_array_equal(cms.query(cols).numpy(), got[f"{fam}_counts"][diff])
        assert eng.timetravel_ring.drain(5.0)
        (_, ring_arrays, _, _), = eng.timetravel_ring.select(50 + w, 51 + w)
        for name in got:
            np.testing.assert_array_equal(ring_arrays[name], got[name], err_msg=name)
    stats = eng.timetravel_ring.stats()
    assert (stats["depth"], stats["appended"], stats["evicted"]) == (2, 3, 1)
    eng.stop()


def test_small_flush_takes_the_packed_wire_and_leaves_the_dictionary():
    jeng, eng = _engines(transfer_min_bucket=512)
    big, small = escalating(6), escalating(7, n=300)
    _feed(jeng, eng, [big])
    entries = (len(eng._flow_dict), eng._flow_dict.generation)
    _feed(jeng, eng, [small, big], now0=200)
    assert eng.counts.packed_rows == 300
    assert eng._flow_dict.generation == entries[1] and len(eng._flow_dict) >= entries[0]


@pytest.mark.usefixtures("reference_native")
def test_build_quantum_and_flush_match_reference():
    """The feed loop's flush: combine + chunk + partition, then dispatch
    each chunk (2 windows a chunk here, so a quantum spans several)."""
    jeng, eng = _engines(batch_capacity=256, feed_coalesce_windows=2)
    gen = TrafficGen(n_flows=2000, n_pods=48, seed=8)
    quanta = [[gen.batch(700) for _ in range(3)] for _ in range(3)]
    quanta[1][0][::30, F.TSVAL] = 99
    for i, blocks in enumerate(quanta + quanta[:1]):
        n_raw = sum(len(b) for b in blocks)
        items = jeng._build_quantum(blocks, n_raw, 50 + i)
        mine = eng._build_quantum(blocks, n_raw, 50 + i)
        assert len(items) == len(mine) > 1
        for (jk, jsb, jnow, jn), (k, sb, now, n) in zip(items, mine):
            assert (jk, jnow, jn) == (k, now, n)
            np.testing.assert_array_equal(sb.records, jsb.records)
            np.testing.assert_array_equal(sb.n_valid, jsb.n_valid)
            assert (sb.lost, sb.events, sb.sample_k) == (jsb.lost, jsb.events, jsb.sample_k)
        for _, jsb, jnow, jn in items:
            jeng._dispatch_sharded(jsb, jnow, jn)
        eng.flush(blocks, 50 + i)
        _compare(jeng, eng)
    assert eng.counts.events == sum(len(b) for q in quanta + quanta[:1] for b in q)
    assert int(to_numpy(eng.state.totals)[0]) == eng.counts.events


def test_failure_after_assignment_resyncs_then_reraises(monkeypatch):
    _, eng = _engines()
    eng.step_records(escalating(9), now_s=5)
    table = eng._desc_tables[0]
    assert table is not None and len(eng._flow_dict) > 0
    gen, before = eng._flow_dict.generation, eng.state.totals.clone()

    def broken(*args, **kwargs):
        raise RuntimeError("ingest failed")

    monkeypatch.setattr(kops, "ingest_known", broken)
    with pytest.raises(RuntimeError, match="ingest failed"):
        eng.step_records(escalating(9), now_s=6)
    assert len(eng._flow_dict) == 0 and eng._flow_dict.generation == gen + 1
    assert eng._fd_epoch == 1 and eng._desc_tables[0] is None
    assert torch.equal(eng.state.totals, before)
    monkeypatch.undo()
    eng.step_records(escalating(9), now_s=7)  # every descriptor new again
    assert eng._desc_tables[0] is not None and eng._desc_tables[0] is not table
    assert int(eng.state.totals[0]) == 2 * int(escalating(9)[:, F.PACKETS].sum())


def test_identity_and_filter_maps_match_reference():
    jeng, eng = _engines(bypass_lookup_ip_of_interest=False)
    filt = {0x0A000000 + i for i in range(3, 30)} | {0xC0000001}
    jeng.update_filter_ips(filt)
    eng.update_filter_ips(filt)
    pods = dict(PODS)
    del pods[0x0A000004]
    pods[0x0A0000FE] = 60
    jeng.update_identities(pods)
    eng.update_identities(pods)
    np.testing.assert_array_equal(to_numpy(eng.ident.table), np.asarray(jeng.ident.table))
    np.testing.assert_array_equal(to_numpy(eng.filter_map.table),
                                  np.asarray(jeng.filter_map.table))
    _feed(jeng, eng, [escalating(10), escalating(11)])
    # An overfull map keeps the lowest IPs and counts the rest.
    eng.update_filter_ips(set(range(1, 200)))
    assert eng.lost_table_entries["filter"] == 199 - 128


def test_engine_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SketchEngine(Config())


@pytest.mark.parametrize("card_done", [True, False], ids=["card_keeps_up", "card_behind"])
def test_feed_stages_hold_a_bounded_number_of_card_events(monkeypatch, card_done):
    """A long-running feed loop never reads ``seconds()``: the card spans it
    times must fold into the totals as they go, not pile up."""

    class FakeEvent:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            pass

        def query(self):
            return card_done

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 2.0  # ms

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    stages = FeedStages(torch.device("cpu"))
    stages._cuda = True
    most = 0
    for i in range(1000):
        with stages(FeedStages.CARD[i % 3]):
            pass
        most = max(most, len(stages._events))
    assert most == (0 if card_done else FeedStages.MAX_PENDING)
    got = stages.seconds()
    assert not stages._events
    assert [got[n] for n in FeedStages.CARD] == pytest.approx([0.668, 0.666, 0.666])


# -- configuration ---------------------------------------------------------------


def test_config_defaults_match_reference():
    ref = JConfig()
    for f in dataclasses.fields(Config):
        assert getattr(Config(), f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("knobs", [
    {}, {"enable_conntrack_metrics": False}, {"heavy_keys_source": "invertible"},
    {"heavy_keys_source": "both", "data_aggregation_level": "high"},
    {"enable_annotations": True, "bypass_lookup_ip_of_interest": True,
     "overload_priority_ip_mask": 0xFFFFFF00, "overload_priority_ip_match": 0x0A000000},
], ids=["deployed", "no_conntrack", "invertible", "both_high", "annotations"])
def test_pipeline_config_from_matches_reference(knobs):
    got = dataclasses.asdict(pipeline_config_from(Config(**knobs)))
    assert got == dataclasses.asdict(jpipeline_config_from(JConfig(**knobs)))


def test_default_config_is_the_deployed_agent():
    assert pipeline_config_from(Config()) == DEPLOYED_CONFIG
    assert pipeline_config_from(Config(heavy_keys_source="invertible")) == INVERTIBLE_CONFIG


@pytest.mark.parametrize("field, value", [
    ("data_aggregation_level", "medium"), ("batch_capacity", 1000),
    ("flow_dict_slots", 1 << 18), ("heavy_keys_source", "dict"),
    ("invertible_width", 3000), ("invertible_depth", 0), ("overload_priority_ip_mask", -1),
    ("overload_sample_k", 0), ("overload_exempt_packets", -1),
    ("overload_enter_pressure", 0.3), ("overload_degrade_pressure", 1.5),
    ("overload_dwell_s", 0.0), ("overload_shed_order", ["dns", "bogus"]),
    ("overload_shed_order", ["labels"]), ("harvest_timeout_s", 0.0),
    ("overload_tick_s", 0.0), ("feed_workers", 4),
])
def test_validate_agrees_with_reference(field, value):
    ref, cfg = JConfig(), Config()
    setattr(ref, field, value)
    setattr(cfg, field, value)
    try:
        ref.validate()
    except ValueError:
        with pytest.raises(ValueError):
            cfg.validate()
    else:
        cfg.validate()
