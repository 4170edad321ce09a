"""Parity of the port's TelemetryPipeline.step / end_window with the JAX
reference's registered jitted_step / jitted_end_window (CPU).

Each case runs the same batches through both, from the same state, and
compares the whole state after every step, leaf by leaf:

- integers exactly, except the top-k key rows where tied estimates race
  (the reference leaves that winner unspecified; the port fixes "last row
  in batch order"): a differing key row must hash to its slot and its CMS
  estimate must equal the slot's count, and the counts must be equal;
- the latency slots exactly, because the reference's CPU scatter already
  lets the last row win, which is the port's documented rule; the RTT
  histogram is held against a numpy model of the rule (see
  test_latency_rules);
- entropy counts exactly (integer weights, every bucket far below 2^24);
- entropy bits, z-scores and the EWMA state within rtol 1e-5 (float32
  reductions and log2 evaluated by two libraries);
- the step summaries exactly: events, ct_reports and the per-row report
  mask and payloads.

The configurations are small cuts of the deployed agent with conntrack
metrics off (SMALL), of the deployed agent (conntrack on, low aggregation),
of the invertible heavy-key agent, and of ``PipelineConfig()``
(bench.py's production shapes: conntrack on, high aggregation).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retina_tpu.config import Config
from retina_tpu.engine import pipeline_config_from
from retina_tpu.events.schema import F
from retina_tpu.events.synthetic import TrafficGen as JTrafficGen
from retina_tpu.models.identity import IdentityMap as JIdentityMap
from retina_tpu.models.pipeline import PipelineConfig as JConfig
from retina_tpu.models.pipeline import TelemetryPipeline as JPipeline
from retina_tpu.ops.hashing_np import hash_cols_np
from retina_tpu_torch.convert import state_to_numpy, tensor_leaves
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import (
    DEPLOYED_CONFIG,
    INVERTIBLE_CONFIG,
    NO_CONNTRACK_CONFIG,
    PipelineConfig,
    TelemetryPipeline,
)
from retina_tpu_torch.ops.topk import slots
from retina_tpu_torch.u32 import from_numpy, to_numpy

B = 1024
# The deployed agent's configuration, cut to test size.
SMALL = dict(
    n_pods=64, cms_depth=4, cms_width=1 << 10, topk_slots=1 << 6,
    hll_precision=8, hll_pod_precision=6, entropy_buckets=1 << 8,
    conntrack_slots=1 << 8, latency_slots=1 << 6, enable_conntrack=False,
    bypass_filter=False, identity_implies_interest=True,
)
# Small cuts of the conntrack configurations (the conntrack table keeps 2^8
# slots, so connections of one batch often share a slot).
SMALL_CUTS = {
    "deployed": dict(SMALL, enable_conntrack=True, data_aggregation_level="low"),
    "invertible": dict(SMALL, enable_conntrack=True, data_aggregation_level="low",
                       enable_invertible=True, inv_width=1 << 8, inv_hi_width=1 << 5,
                       priority_ip_mask=0xFFFFFFF0, priority_ip_match=0x0A000000),
    "production": dict(SMALL, enable_conntrack=True, bypass_filter=True, cms_depth=2),
}
API = 0x7F000001  # the capture's loopback address stands in for the apiserver
PODS = {0x0A000000 + i: i for i in range(1, 48)} | {API: 5}


def leaf_names(obj, prefix="") -> list[str]:
    if isinstance(obj, torch.Tensor):
        return [prefix]
    names = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            names += leaf_names(v, f"{prefix}.{f.name}" if prefix else f.name)
    return names


def compare_states(jstate, tstate) -> None:
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    port = state_to_numpy(tstate)
    names = leaf_names(tstate)
    assert len(ref) == len(port) == len(names)
    by_name = dict(zip(names, zip(ref, port)))
    for name, (r, p) in by_name.items():
        assert r.shape == p.shape, name
        if name.endswith("table.key_rows"):
            continue
        if r.dtype == np.float32:
            if name == "entropy.counts":
                np.testing.assert_array_equal(p, r, err_msg=name)
            else:
                np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(p, r.astype(np.uint32), err_msg=name)
    for hh in ("flow_hh", "svc_hh", "dns_hh"):
        r, p = by_name[f"{hh}.table.key_rows"]
        diff = np.nonzero((r != p).any(axis=1))[0]
        if not len(diff):
            continue
        sk = getattr(tstate, hh)
        rows = torch.from_numpy(p[diff].astype(np.int64))
        cols = [rows[:, c] for c in range(rows.shape[1])]
        np.testing.assert_array_equal(slots(sk.table.n_slots, sk.table.seed, cols).numpy(), diff)
        counts = to_numpy(sk.table.counts)[diff]
        np.testing.assert_array_equal(sk.cms.query(cols).numpy(), counts)


def latency_batch(rng, n=B) -> np.ndarray:
    """Apiserver probes and replies whose RTTs cover every bucket, the
    power-of-two boundaries where XLA's float log2 rounds down, duplicate
    (ip, tsval) probes and colliding slots."""
    rec = np.zeros((n, 16), np.uint32)
    pod = np.uint32(0x0A000007)
    rec[:, F.SRC_IP] = pod
    rec[:, F.DST_IP] = pod
    rec[:, F.META] = (6 << 24) | (0x10 << 16) | (2 << 8) | (1 << 4)
    rec[:, F.PACKETS] = 1
    rec[:, F.BYTES] = 100
    rec[:, F.VERDICT] = 1
    rtts = [0, 1, 2, 3, 7, 8, 100, 1023, 4095, 8191, 8192, 16383, 32767, 40000,
            (1 << 20), 0xFFFFFFFF]
    half = n // 2
    tsv = rng.integers(1, 1 << 31, half).astype(np.uint32)
    tsv[1::7] = tsv[0::7][: len(tsv[1::7])]  # duplicate probes: the last one wins
    send = rng.integers(1 << 21, 1 << 30, half).astype(np.int64)
    rtt = np.array([rtts[i % len(rtts)] for i in range(half)], np.int64)
    ms = np.concatenate([send, (send + rtt) & 0xFFFFFFFF])
    ns = ms << 20
    rec[:, F.TS_LO] = (ns & 0xFFFFFFFF).astype(np.uint32)
    rec[:, F.TS_HI] = (ns >> 32).astype(np.uint32)
    rec[:half, F.DST_IP] = API
    rec[:half, F.TSVAL] = tsv
    rec[half:, F.SRC_IP] = API
    rec[half:, F.TSECR] = tsv
    return rec


def latency_model(rec, n_valid, lat_key, lat_ts, lat_hist, log2_bucket, api=API, pods=None):
    """Numpy model of the latency rule over one batch: every row inside
    ``n_valid`` takes part, or, given ``pods``, those whose source or
    destination is one of them."""
    L, H = len(lat_key), len(lat_hist)
    key, ts, hist = lat_key.copy(), lat_ts.copy(), lat_hist.copy()
    r = rec[:n_valid]
    m = np.ones(len(r), bool)
    if pods is not None:
        ips = np.array(sorted(pods), np.uint32)
        m = np.isin(r[:, F.SRC_IP], ips) | np.isin(r[:, F.DST_IP], ips)
    ts_ms = ((r[:, F.TS_HI] << np.uint32(12)) | (r[:, F.TS_LO] >> np.uint32(20))).astype(np.uint32)
    out = m & (r[:, F.DST_IP] == np.uint32(api)) & (r[:, F.TSVAL] > 0)
    inn = m & (r[:, F.SRC_IP] == np.uint32(api)) & (r[:, F.TSECR] > 0)
    k_out = hash_cols_np([r[:, F.DST_IP], r[:, F.TSVAL]], np.uint32(0x1A7))
    k_in = hash_cols_np([r[:, F.SRC_IP], r[:, F.TSECR]], np.uint32(0x1A7))
    for i in np.nonzero(out)[0]:
        key[k_out[i] & (L - 1)] = k_out[i]
        ts[k_out[i] & (L - 1)] = ts_ms[i]
    slot_in = k_in & np.uint32(L - 1)
    hit = inn & (key[slot_in] == k_in)
    rtt = (ts_ms[hit] - ts[slot_in[hit]]).astype(np.uint32)
    key[slot_in[hit]] = 0
    for b in log2_bucket(rtt):
        hist[min(int(b), H - 1)] += 1
    return key, ts, hist


def exact_bucket(rtt):
    return [(int(v) + 1).bit_length() - 1 for v in rtt]


def xla_bucket(rtt):
    return np.asarray(jnp.floor(jnp.log2(jnp.asarray(rtt).astype(jnp.float32) + 1.0)))


def compare_summaries(jsum, tsum) -> None:
    assert int(tsum["events"]) & 0xFFFFFFFF == int(jsum["events"])
    assert int(tsum["ct_reports"]) & 0xFFFFFFFF == int(jsum["ct_reports"])
    assert tsum["report_mask"].dtype == torch.bool
    np.testing.assert_array_equal(tsum["report_mask"].numpy(), np.asarray(jsum["report_mask"]))
    for key in ("report_packets", "report_bytes"):
        assert tsum[key].dtype == torch.int32, key
        np.testing.assert_array_equal(to_numpy(tsum[key]), np.asarray(jsum[key]), err_msg=key)


def clock(w, i):
    """now_s of step i of window w: steps 1 s apart, windows 40 s apart, so
    a run crosses the report interval and the UDP lifetime."""
    return 100 + 40 * w + i


def run_case(cfg_kw, batches, *, n_valid=None, sample_k=1, filter_ips=None,
             apiserver_ip=0, ident_pods=PODS, windows=1, check_latency=False,
             now=lambda w, i: 1 + w):
    jcfg, tcfg = JConfig(**cfg_kw), PipelineConfig(**cfg_kw)
    jp, tp = JPipeline(jcfg), TelemetryPipeline(tcfg, device="cpu")
    step, end = jp.jitted_step(), jp.jitted_end_window()
    js, ts = jp.init_state(), tp.init_state()
    ji = JIdentityMap.build_host(ident_pods, n_slots=1 << 8)
    ti = IdentityMap.build_host(ident_pods, n_slots=1 << 8, device="cpu")
    jf = tf = None
    if filter_ips is not None:
        jf = JIdentityMap.build_host({ip: 1 for ip in filter_ips}, n_slots=1 << 8, seed=4)
        tf = IdentityMap.build_host({ip: 1 for ip in filter_ips}, n_slots=1 << 8, seed=4,
                                    device="cpu")
    for w in range(windows):
        for i, rec in enumerate(batches):
            nv = len(rec) if n_valid is None else n_valid
            before = [to_numpy(t) for t in (ts.lat_key, ts.lat_ts, ts.lat_hist)]
            js, jsum = step(js, jnp.asarray(rec), jnp.uint32(nv), jnp.uint32(now(w, i)), ji,
                            jnp.uint32(apiserver_ip), jf, np.uint32(sample_k))
            ts, tsum = tp.step(ts, from_numpy(rec, "cpu"), nv, now(w, i), ti, apiserver_ip,
                               filter_map=tf, sample_k=sample_k)
            compare_summaries(jsum, tsum)
            if not tcfg.enable_conntrack:
                assert int(tsum["ct_reports"]) == 0 and not tsum["report_mask"].any()
            if check_latency:
                k, t, h = latency_model(rec, nv, *before, exact_bucket)
                np.testing.assert_array_equal(to_numpy(ts.lat_key), k)
                np.testing.assert_array_equal(to_numpy(ts.lat_ts), t)
                np.testing.assert_array_equal(to_numpy(ts.lat_hist), h)
                _, _, h_xla = latency_model(rec, nv, *before, xla_bucket)
                np.testing.assert_array_equal(np.asarray(js.lat_hist), h_xla)
                # The reference's histogram is the port's except where XLA's
                # log2 rounds a power of two down; carry the port's over so
                # the rest of the state is compared exactly.
                js = dataclasses.replace(js, lat_hist=jnp.asarray(to_numpy(ts.lat_hist)))
            compare_states(js, ts)
        js, jout = end(js)
        ts, tout = tp.end_window(ts)
        np.testing.assert_array_equal(tout["anomaly"].numpy(), np.asarray(jout["anomaly"]))
        for key in ("entropy_bits", "zscore"):
            np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
        compare_states(js, ts)
    return js, ts


def traffic(seed, n_batches, n=B):
    gen = JTrafficGen(n_flows=400, n_pods=48, seed=seed)
    return [gen.batch(n) for _ in range(n_batches)]


@pytest.mark.parametrize("port, knobs", [
    (DEPLOYED_CONFIG, {}),
    (NO_CONNTRACK_CONFIG, {"enable_conntrack_metrics": False}),
    (INVERTIBLE_CONFIG, {"heavy_keys_source": "invertible"}),
], ids=["deployed", "no_conntrack", "invertible"])
def test_deployed_config_matches_reference_agent_config(port, knobs):
    ref = pipeline_config_from(Config(**knobs))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_slice_config_over_traffic_and_windows():
    run_case(SMALL, traffic(1, 3), windows=2)


def test_bypass_filter_default_shapes():
    run_case(dict(SMALL, bypass_filter=True), traffic(2, 2))


def test_real_capture_batch_with_latency():
    cap = JTrafficGen(mode="pcap_replay", seed=0)
    batches = [cap.batch(B), traffic(3, 1)[0], cap.batch(B)]
    run_case(SMALL, batches, apiserver_ip=API, check_latency=True)


def test_latency_rules():
    rng = np.random.default_rng(5)
    run_case(SMALL, [latency_batch(rng), latency_batch(rng)], apiserver_ip=API,
             check_latency=True)


def test_filter_map_with_and_without_identity_interest():
    rng = np.random.default_rng(6)
    batches = traffic(4, 2)
    outsiders = rng.integers(0xC0000000, 0xC0000100, (B, 2)).astype(np.uint32)
    for rec in batches:  # a third of the rows talk to IPs that are no pod
        rec[::3, F.SRC_IP] = outsiders[::3, 0]
        rec[1::6, F.DST_IP] = outsiders[1::6, 1]
    filt = [int(x) for x in np.unique(outsiders[:40])] + [0x0A000003]
    run_case(SMALL, batches, filter_ips=filt)
    run_case(dict(SMALL, identity_implies_interest=False), batches, filter_ips=filt)


def test_sampled_batch_rescale():
    rng = np.random.default_rng(7)
    batches = traffic(5, 2)
    for rec in batches:
        rec[::5, F.PACKETS] = rng.integers(1, 200, len(rec[::5, F.PACKETS]))  # some exempt
        rec[3::11, F.TSVAL] = 99  # latency probes are exempt
        rec[7::13, F.PACKETS] = 0x7FFFFFFF  # saturates
        rec[7::13, F.BYTES] = 0xFFFFFFF0
    run_case(dict(SMALL, priority_ip_mask=0xFFFFFF00, priority_ip_match=0x0A000000),
             batches, sample_k=4)


def test_partial_batch_masks_garbage_rows():
    rng = np.random.default_rng(8)
    batches = traffic(6, 2)
    for rec in batches:
        rec[700:] = rng.integers(0, 1 << 32, rec[700:].shape, dtype=np.uint64).astype(np.uint32)
    run_case(SMALL, batches, n_valid=700)
    run_case(SMALL, batches[:1], n_valid=0)


def test_low_aggregation_requires_conntrack():
    with pytest.raises(ValueError, match="low requires"):
        PipelineConfig(enable_conntrack=False, data_aggregation_level="low")


@pytest.mark.parametrize("cut", sorted(SMALL_CUTS))
def test_conntrack_configs_over_traffic_and_windows(cut):
    run_case(SMALL_CUTS[cut], traffic(21, 3), windows=3, now=clock)


@pytest.mark.parametrize("cut", sorted(SMALL_CUTS))
def test_conntrack_configs_with_filter_sampling_and_partial_batches(cut):
    rng = np.random.default_rng(22)
    batches = traffic(23, 3)
    outsiders = rng.integers(0xC0000000, 0xC0000100, (B, 2)).astype(np.uint32)
    for rec in batches:
        rec[::3, F.SRC_IP] = outsiders[::3, 0]
        rec[::5, F.PACKETS] = rng.integers(1, 200, len(rec[::5, F.PACKETS]))
        rec[7::13, F.PACKETS] = 0x7FFFFFFF  # saturates under sampling
        rec[900:] = rng.integers(0, 1 << 32, rec[900:].shape, dtype=np.uint64).astype(np.uint32)
    filt = [int(x) for x in np.unique(outsiders[:40])]
    run_case(SMALL_CUTS[cut], batches, n_valid=900, sample_k=4, filter_ips=filt, windows=2,
             now=lambda w, i: 65_530 + 100 * w + 2 * i)  # across the 16-bit wrap


def test_deployed_cut_with_real_capture_and_latency():
    cap = JTrafficGen(mode="pcap_replay", seed=0)
    run_case(SMALL_CUTS["deployed"], [cap.batch(B), traffic(24, 1)[0], cap.batch(B)],
             apiserver_ip=API, windows=2, now=clock)


@pytest.mark.parametrize("cut", ["slice", "deployed"])
def test_skewed_batch_with_flags_and_probes(cut):
    """The pattern the card's K1 sums in shared memory: one hot pod pair
    takes ~80% of the other rows, with random TCP flags, its drops and DNS rows;
    apiserver probes and replies sit among them. Rectangles, totals and the
    latency state equal the reference's as integers."""
    rng = np.random.default_rng(25)
    batches = traffic(25, 2)
    for rec in batches:
        hot = rng.random(B) < 0.8
        rec[hot, F.SRC_IP], rec[hot, F.DST_IP] = 0x0A000003, 0x0A000004
        flags = rng.integers(0, 256, B).astype(np.uint32)
        rec[:, F.META] = (rec[:, F.META] & np.uint32(0xFF00FFFF)) | (flags << np.uint32(16))
        rec[hot & (rng.random(B) < 0.9), F.META] &= np.uint32(0x00FFFFFF)
        rec[hot & (rng.random(B) < 0.9), F.META] |= np.uint32(6 << 24)  # mostly TCP
        probes = latency_batch(rng)  # sends, then their replies
        rec[0::6] = probes[:171]
        rec[3::6] = probes[B // 2:B // 2 + 171]
    js, ts = run_case(SMALL if cut == "slice" else SMALL_CUTS["deployed"], batches,
                      apiserver_ip=API, check_latency=True, now=clock)
    fwd = to_numpy(ts.pod_forward)
    assert fwd[3:5, :, 0].sum() > 0.45 * 2 * B and to_numpy(ts.pod_tcpflags)[3:5].all()
    assert int(to_numpy(ts.lat_hist).sum()) > 0


def test_invertible_at_high_aggregation_with_a_priority_class():
    """Per-row weights: the step's one K6 call splits every forwarded row
    between inv_flow and inv_hi by the priority class, and its one K3 call
    takes the three banks at the per-row masks."""
    js, ts = run_case(SMALL_CUTS["invertible"] | dict(enable_conntrack=False,
                                                      data_aggregation_level="high"),
                      traffic(26, 2), windows=2, now=clock)
    assert to_numpy(ts.inv_flow.weights).any() and to_numpy(ts.inv_hi.weights).any()


def test_state_leaves_line_up_with_reference():
    jp = JPipeline(JConfig(**SMALL))
    tp = TelemetryPipeline(PipelineConfig(**SMALL), device="cpu")
    ref = jax.tree_util.tree_leaves(jp.init_state())
    port = tensor_leaves(tp.init_state())
    assert [tuple(r.shape) for r in ref] == [tuple(p.shape) for p in port]
