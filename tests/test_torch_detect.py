"""The port's detection loop against the reference's (CPU).

Covers the generator's regimes and attack batches, the detector features
and programs, the detector bank's scenarios of tests/test_detectors.py, the
engine's record and anomaly hooks, the capture pieces (filter, replay
filter, pcap bytes, the numpy pcap reader) and AutoCapture's closed loop.
The same inputs, made from a seed with numpy, go through the reference and
the port. Rules: integers, bytes, firings, epochs and counters exactly;
the synflood program exactly (IEEE divisions); HLL estimates, entropy bits
and scores within rtol 1e-5 (float32 sums in another order, two log
libraries); z-scores within rtol 1e-4 and atol 1e-2, because the EWMA's
standard-deviation floor of 1e-3 multiplies a score's rounding by up to
1e3.
"""

from __future__ import annotations

import dataclasses
import pathlib
import tarfile
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retina_tpu.capture.providers import ReplayProvider as JReplayProvider
from retina_tpu.capture.providers import _apply_filter as japply_filter
from retina_tpu.capture.translator import synthesize_filter as jsynthesize_filter
from retina_tpu.config import Config as JConfig
from retina_tpu.detect import features as jfeatures
from retina_tpu.detect import programs as jprograms
from retina_tpu.detect.base import DetectorBank as JBank
from retina_tpu.detect.base import build_default_bank as jbuild_default_bank
from retina_tpu.detect.detectors import DnsTunnelDetector as JDnsTunnel
from retina_tpu.detect.detectors import PortScanDetector as JPortScan
from retina_tpu.detect.detectors import SynFloodDetector as JSynFlood
from retina_tpu.engine import SketchEngine as JEngine
from retina_tpu.events.synthetic import MODES as JMODES
from retina_tpu.events.synthetic import PRESETS as JPRESETS
from retina_tpu.events.synthetic import TrafficGen as JTrafficGen
from retina_tpu.fleet.dryrun import INV_SEEDS
from retina_tpu.metrics import get_metrics
from retina_tpu.sources.pcapdecode import _decode_pcap_numpy as jdecode_pcap
from retina_tpu.sources.pcapdecode import synthesize_pcap as jsynthesize_pcap
from retina_tpu.timetravel.dryrun import _keys_from_records, _window_arrays
from retina_tpu.timetravel.query import QueryService as JQueryService
from retina_tpu.timetravel.ring import SnapshotRing as JSnapshotRing
from retina_tpu_torch.capture.manager import CaptureManager
from retina_tpu_torch.capture.providers import (
    CaptureError,
    NetshProvider,
    ReplayProvider,
    SocketProvider,
    TcpdumpProvider,
    _apply_filter,
)
from retina_tpu_torch.capture.translator import CaptureJob, synthesize_filter
from retina_tpu_torch.config import Config
from retina_tpu_torch.detect import features, programs
from retina_tpu_torch.detect.base import (
    MAX_WINDOW_RECORDS,
    Detector,
    DetectorBank,
    build_default_bank,
    register,
    registered,
)
from retina_tpu_torch.detect.detectors import (
    DnsTunnelDetector,
    PortScanDetector,
    SynFloodDetector,
)
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.events.schema import NUM_FIELDS, PROTO_UDP, F, u32_to_ip
from retina_tpu_torch.events.synthetic import MODES, PRESETS, TrafficGen, pod_ip, preset_params
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.ops.entropy import AnomalyEWMA, EntropyWindow
from retina_tpu_torch.sources.pcapdecode import _decode_pcap_numpy, synthesize_pcap
from retina_tpu_torch.timetravel.autocapture import AutoCapture
from retina_tpu_torch.timetravel.query import QueryService
from retina_tpu_torch.timetravel.ring import SnapshotRing
from retina_tpu_torch.u32 import from_numpy
from test_torch_engine import SMALL
from test_torch_wire import reference_native  # noqa: F401 (a fixture)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "real"
EPOCH0 = 1000
WINDOWS = 8
EVENTS = 4096
SYNTHETIC = sorted(p for p in PRESETS if p != "pcap_replay")


def _gens(seed=3, **kw):
    kw.setdefault("n_flows", 256)
    kw.setdefault("n_pods", 16)
    return JTrafficGen(seed=seed, **kw), TrafficGen(seed=seed, **kw)


# -- the generator -----------------------------------------------------------


def test_presets_and_modes_are_the_references():
    assert PRESETS == JPRESETS and MODES == JMODES
    assert preset_params("portscan") == {"mode": "portscan", "zipf_a": 1.2}
    with pytest.raises(ValueError, match="unknown gen_preset"):
        preset_params("nope")
    with pytest.raises(ValueError, match="mode"):
        TrafficGen(mode="nope")
    assert len(TrafficGen(mode="pcap_replay").batch(16)) == 16  # the banked captures
    with pytest.raises(ValueError, match="no decodable records"):
        TrafficGen(mode="pcap_replay", pcap_paths=("/dev/null",))


@pytest.mark.parametrize("preset", SYNTHETIC)
def test_traffic_gen_regimes_are_bit_identical(preset):
    ref, port = _gens(seed=5, n_flows=512, n_pods=32, **preset_params(preset))
    for n in (1000, 777, 64):
        np.testing.assert_array_equal(port.batch(n), ref.batch(n))
    np.testing.assert_array_equal(port.true_counts(), ref.true_counts())


def test_attack_batches_are_bit_identical():
    ref, port = _gens(seed=6, n_flows=300, n_pods=20)
    for g in (ref, port):
        g.calls = [
            lambda g=g: g.batch(500),
            lambda g=g: g.ddos_batch(700, target_pod=3, n_sources=48),
            lambda g=g: g.portscan_batch(600, n_scanners=4, n_ports=24),
            lambda g=g: g.tunnel_batch(650, n_clients=48),
            lambda g=g: g.ddos_batch(98, n_sources=50_000),
            lambda g=g: g.batch(300),
        ]
    for a, b in zip(ref.calls, port.calls):
        np.testing.assert_array_equal(b(), a())


# -- features and programs ---------------------------------------------------


def _record_sets():
    ref, _ = _gens(seed=7, n_flows=400, n_pods=24)
    dns, _ = _gens(seed=8, **preset_params("dns_flood"))
    udp = ref.batch(300)
    udp[:, F.META] = (udp[:, F.META] & np.uint32(0x00FFFFFF)) | np.uint32(PROTO_UDP << 24)
    udp[:, F.DNS] = 0
    heavy = ref.batch(200)
    heavy[::3, F.PACKETS] = 1000
    return {
        "mix": ref.batch(EVENTS),
        "dns_flood": dns.batch(2000),
        "tunnel": ref.tunnel_batch(900),
        "portscan": ref.portscan_batch(5000),
        "heavy": heavy,
        "udp_no_dns": udp,
        "empty": np.zeros((0, NUM_FIELDS), np.uint32),
        "one": ref.batch(1),
    }


RECORDS = _record_sets()


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_features_are_exact(name):
    rec = RECORDS[name]
    keys, w = features.padded_flow_keys(rec)
    jkeys, jw = jfeatures.padded_flow_keys(rec)
    assert keys.dtype == jkeys.dtype and w.dtype == jw.dtype
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(w, jw)
    for fn, jfn in ((features.tcpflag_lanes, jfeatures.tcpflag_lanes),
                    (features.qname_length_hist, jfeatures.qname_length_hist)):
        got, want = fn(rec), jfn(rec)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _portscan_inputs(p: int, seed: int):
    """(P, 4) keys with sources over the whole u32 range (top bit set on
    about half), a few scanners, and padding rows of weight 0."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, (p, 4), dtype=np.uint64).astype(np.uint32)
    keys[: p // 4, 0] = 0xC9000000 + rng.integers(0, 4, p // 4)
    keys[: p // 4, 3] = rng.integers(1, 1025, p // 4)
    keys[p // 4:, 3] = rng.choice([80, 443, 53, 8080, 5432], p - p // 4)
    w = rng.integers(1, 5, p).astype(np.float32)
    w[-(p // 8):] = 0  # padding
    w[::9] = 0
    return keys, w


@pytest.mark.parametrize("p", [64, 4096, 1 << 16])
def test_portscan_program_matches_reference(p):
    keys, w = _portscan_inputs(p, 20 + p.bit_length())
    want = np.asarray(jprograms.portscan_program(
        p, jprograms.PORTSCAN_GROUPS, jprograms.PORTSCAN_PRECISION,
        jprograms.PORTSCAN_SEED)(jnp.asarray(keys), jnp.asarray(w)))
    kops.reset_launch_counts()
    got = programs.portscan_program(from_numpy(keys, "cpu"), torch.from_numpy(w))
    assert kops.launch_counts()["portscan_score"] == 0
    assert got.dtype == torch.float32 and got.shape == (programs.PORTSCAN_GROUPS,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # Weight-0 rows do not count: zeroing them changes nothing, dropping
    # every weighted row empties the bank.
    keys2 = keys.copy()
    keys2[w == 0] = np.random.default_rng(p).integers(
        0, 1 << 32, (int((w == 0).sum()), 4), dtype=np.uint64).astype(np.uint32)
    again = programs.portscan_program(from_numpy(keys2, "cpu"), torch.from_numpy(w))
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    empty = programs.portscan_program(from_numpy(keys, "cpu"), torch.zeros(p))
    assert not empty.any()


def test_portscan_program_on_the_taps_keys():
    gen = JTrafficGen(n_flows=400, n_pods=24, seed=11, **preset_params("portscan"))
    keys, w = features.padded_flow_keys(gen.batch(3000))  # padded to 4096
    want = np.asarray(jprograms.portscan_program(len(keys), 32, 8, 0x5CA7)(
        jnp.asarray(keys), jnp.asarray(w)))
    got = programs.portscan_program(from_numpy(keys, "cpu"), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert want.max() >= PortScanDetector.fire_thresh


def _hists():
    rng = np.random.default_rng(30)
    benign = np.zeros((1, 64), np.float32)
    benign[0, 8:17] = rng.integers(1, 300, 9)
    tunnel = rng.integers(0, 500, (1, 64)).astype(np.float32)
    one = np.zeros((1, 64), np.float32)
    one[0, 5] = 77
    big = rng.integers(0, 1 << 20, (1, 64)).astype(np.float32)
    return {"empty": np.zeros((1, 64), np.float32), "benign": benign, "tunnel": tunnel,
            "one_bin": one, "big": big,
            "taps": jfeatures.qname_length_hist(RECORDS["dns_flood"])}


@pytest.mark.parametrize("name", sorted(_hists()))
def test_dnstunnel_program_matches_reference(name):
    hist = _hists()[name]
    want = np.asarray(jprograms.dnstunnel_program(64, jprograms.DNSTUNNEL_SEED)(
        jnp.asarray(hist)))
    got = programs.dnstunnel_program(torch.from_numpy(hist))
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("lanes", [
    np.zeros(9), np.arange(9) * 17.0, [0, 5000, 0, 0, 0, 0, 0, 0, 5000],
    [3, 700, 1, 0, 9000, 2, 0, 0, 9700], [0, 0.5, 0, 0, 0.25, 0, 0, 0, 0.75],
    jfeatures.tcpflag_lanes(RECORDS["mix"]), jfeatures.tcpflag_lanes(RECORDS["portscan"]),
], ids=["zeros", "ramp", "all_syn", "mixed", "fractions", "mix", "portscan"])
def test_synflood_program_is_exact(lanes):
    lanes = np.asarray(lanes, np.float32)
    want = np.asarray(jprograms.synflood_program()(jnp.asarray(lanes)))
    got = programs.synflood_program(torch.from_numpy(lanes))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# -- the bank against the reference's ------------------------------------------


def _same_detections(got, want):
    assert len(got) == len(want), (got, want)
    for a, b in zip(got, want):
        assert (a.detector, a.epoch, a.dims, a.priority) == (
            b.detector, b.epoch, b.dims, b.priority)
        np.testing.assert_allclose(a.score, b.score, rtol=1e-5)
        np.testing.assert_allclose(a.zscore, b.zscore, rtol=1e-4, atol=1e-2)


def _same_counters(bank: DetectorBank):
    m = get_metrics()
    for d in bank.detectors:
        n = d.name
        np.testing.assert_allclose(bank.detector_score.get(n, 0.0),
                                   m.detector_score.labels(detector=n)._value.get(), rtol=1e-5)
        np.testing.assert_allclose(bank.detector_zscore.get(n, 0.0),
                                   m.detector_zscore.labels(detector=n)._value.get(),
                                   rtol=1e-4, atol=1e-2)
        assert bank.detector_fired[n] == m.detector_fired.labels(detector=n)._value.get()
        assert bank.detector_last_epoch.get(n, 0) == \
            m.detector_last_epoch.labels(detector=n)._value.get()
        for reason in ("disabled", "cooldown", "arbitration"):
            assert bank.detector_suppressed[(n, reason)] == m.detector_suppressed.labels(
                detector=n, reason=reason)._value.get(), (n, reason)


class _Pair:
    """A port bank and the reference's, fed the same blocks; every window's
    firings, sinks and counters must agree."""

    def __init__(self, port: DetectorBank, ref: JBank):
        self.port, self.ref = port, ref
        self.sunk, self.jsunk = [], []
        port.sink = lambda e, dims: self.sunk.append((e, tuple(dims)))
        ref.sink = lambda e, dims: self.jsunk.append((e, tuple(dims)))
        self.fired = []

    def observe(self, epoch, rec, extras=None, now_s=None):
        got = self.port.observe(epoch, rec, extras, now_s)
        _same_detections(got, self.ref.observe(epoch, rec, extras, now_s))
        self._check(got)
        return got

    def flush(self, now_s=None):
        got = self.port.flush(now_s)
        _same_detections(got, self.ref.flush(now_s))
        self._check(got)
        return got

    def _check(self, got):
        self.fired += got
        assert self.sunk == self.jsunk
        _same_counters(self.port)


def _default_pair(**kw):
    return _Pair(build_default_bank(Config(**kw), device="cpu"),
                 jbuild_default_bank(JConfig(**kw)))


def _run_preset(name, windows=WINDOWS, seed=3):
    ref, port = _gens(seed=seed, **preset_params(name))
    pair = _default_pair()
    for i in range(windows):
        rec = port.batch(EVENTS)
        np.testing.assert_array_equal(rec, ref.batch(EVENTS))
        pair.observe(EPOCH0 + i, rec, now_s=float(i))
    pair.flush(now_s=float(windows))
    return pair


@pytest.mark.parametrize("preset", ["zipf", "uniform", "elephant_mice", "default",
                                    "conntrack_churn"])
def test_benign_regimes_never_fire(preset):
    pair = _run_preset(preset)
    assert pair.fired == []
    for d in pair.port.detectors:
        assert d.last_score < d.fire_thresh, (d.name, d.last_score)


@pytest.mark.parametrize("preset, detector", [
    ("syn_storm", SynFloodDetector), ("dns_flood", DnsTunnelDetector),
    ("portscan", PortScanDetector)])
def test_attack_regimes_fire_their_detector_in_window(preset, detector):
    pair = _run_preset(preset)
    assert pair.fired[0].detector == detector.name
    assert pair.fired[0].epoch == EPOCH0
    assert pair.fired[0].score >= detector.fire_thresh
    assert pair.fired[0].dims == detector.dims


def test_priority_arbitration_single_winner():
    ref, port = _gens(seed=5)
    atk = np.concatenate([port.ddos_batch(8192, target_pod=1, n_sources=64),
                          port.portscan_batch(8192, n_scanners=4, n_ports=24)])
    pair = _default_pair()
    pair.observe(EPOCH0, atk, now_s=0.0)
    assert [d.detector for d in pair.flush(now_s=1.0)] == ["synflood"]
    assert pair.sunk == [(EPOCH0, ("src_ip",))]
    ps = next(d for d in pair.port.detectors if d.name == "portscan")
    assert ps.last_score >= PortScanDetector.fire_thresh
    assert pair.port.detector_suppressed[("portscan", "arbitration")] == 1


def test_cooldown_suppresses_refire_until_expiry():
    pair = _Pair(DetectorBank([SynFloodDetector(cooldown_s=2.0, device="cpu")]),
                 JBank([JSynFlood(cooldown_s=2.0)]))
    _, port = _gens(seed=7)
    atk = port.ddos_batch(8192, target_pod=1, n_sources=64)
    pair.observe(EPOCH0, atk, now_s=0.0)
    pair.observe(EPOCH0 + 1, atk, now_s=0.5)
    pair.observe(EPOCH0 + 2, atk, now_s=1.0)
    pair.flush(now_s=10.0)
    assert [d.epoch for d in pair.fired] == [EPOCH0, EPOCH0 + 2]
    assert pair.port.detector_suppressed[("synflood", "cooldown")] == 1


def test_disabled_bank_scores_but_never_sinks():
    pair = _Pair(DetectorBank([SynFloodDetector(device="cpu")], enabled=False),
                 JBank([JSynFlood()], enabled=False))
    _, port = _gens(seed=7)
    pair.observe(EPOCH0, port.ddos_batch(8192, n_sources=64), now_s=0.0)
    assert pair.flush(now_s=1.0) == []
    assert pair.sunk == []
    assert pair.port.detectors[0].last_score >= SynFloodDetector.fire_thresh
    assert pair.port.detector_suppressed[("synflood", "disabled")] == 1


def test_window_record_cap_bounds_memory():
    pair = _Pair(DetectorBank([PortScanDetector(device="cpu")]), JBank([JPortScan()]))
    _, port = _gens(seed=12, n_flows=5000)
    big = port.batch(MAX_WINDOW_RECORDS // 2 + 100)
    for _ in range(3):
        pair.observe(EPOCH0, big)
    d = pair.port.detectors[0]
    assert sum(len(b) for b in d._blocks) == MAX_WINDOW_RECORDS
    pair.flush(now_s=1.0)
    assert d.last_score == pytest.approx(pair.ref.detectors[0].last_score, rel=1e-5)


def test_no_signal_windows_do_not_judge():
    tun = DnsTunnelDetector(device="cpu")
    assert tun.score() is None
    assert tun.judge(EPOCH0) is None
    syn = SynFloodDetector(device="cpu")
    syn.add_records(np.zeros((0, NUM_FIELDS), np.uint32))
    assert syn.score() is None
    assert PortScanDetector(device="cpu").score() is None

    class Broken(Detector):
        name = "broken-port"

        def begin_window(self):
            pass

        def add_records(self, rec, extras=None):
            pass

        def score(self):
            raise RuntimeError("boom")

    _, port = _gens(seed=7)
    bank = DetectorBank([Broken(device="cpu"), SynFloodDetector(device="cpu")])
    bank.observe(EPOCH0, port.ddos_batch(8192, n_sources=64), now_s=0.0)
    assert [d.detector for d in bank.flush(now_s=1.0)] == ["synflood"]
    assert bank.flush() == []  # nothing in progress


def test_extras_paths_match_record_features():
    _, port = _gens(seed=9, dns_fraction=0.25)
    rec = port.batch(EVENTS)
    none = np.zeros((0, NUM_FIELDS), np.uint32)
    extras = {"tcpflag_lanes": features.tcpflag_lanes(rec),
              "qname_hist": features.qname_length_hist(rec)}
    for cls, jcls in ((SynFloodDetector, JSynFlood), (DnsTunnelDetector, JDnsTunnel)):
        a, b, ref = cls(device="cpu"), cls(device="cpu"), jcls()
        a.add_records(rec)
        b.add_records(none, extras=extras)
        ref.add_records(none, extras=extras)
        assert a.score() == pytest.approx(b.score(), rel=1e-6)
        assert b.score() == pytest.approx(ref.score(), rel=1e-5)


def test_registry_idempotent_and_conflict():
    assert register(SynFloodDetector) is SynFloodDetector
    with pytest.raises(ValueError, match="registered twice"):
        register(type("Impostor", (Detector,), {"name": "synflood"}))
    assert {"synflood", "portscan", "dnstunnel"} <= set(registered())
    bank = build_default_bank(Config(detector_cooldown_s=7.0, detector_z_thresh=5.0,
                                     detector_min_windows=4), device="cpu")
    assert [d.name for d in bank.detectors] == ["dnstunnel", "portscan", "synflood"]
    assert all((d.cooldown_s, d.z_thresh, d.min_windows) == (7.0, 5.0, 4)
               for d in bank.detectors)
    for cls, jcls in ((SynFloodDetector, JSynFlood), (PortScanDetector, JPortScan),
                      (DnsTunnelDetector, JDnsTunnel)):
        for attr in ("name", "priority", "dims", "fire_thresh", "min_score"):
            assert getattr(cls, attr) == getattr(jcls, attr), (cls.name, attr)


def test_bank_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_default_bank(Config())
    assert build_default_bank(Config(), device="cpu").detectors[0].device.type == "cpu"


# -- the engine's hooks ------------------------------------------------------


def _engines(**kw):
    jcfg, cfg = JConfig(), Config()
    for k, v in dict(SMALL, **kw).items():
        setattr(jcfg, k, v)
        setattr(cfg, k, v)
    return JEngine(jcfg, devices=[jax.devices("cpu")[0]]), SketchEngine(cfg, device="cpu")


@pytest.mark.usefixtures("reference_native")
@pytest.mark.parametrize("source", ["flowdict", "invertible"])
def test_record_hook_sees_the_references_rows(source):
    jeng, eng = _engines(heavy_keys_source=source)
    seen, jseen = [], []
    eng.record_hook = lambda r, now_s: seen.append((r.copy(), now_s))
    jeng.record_hook = lambda r, now_s: jseen.append((r.copy(), now_s))
    _, gen = _gens(seed=11, n_flows=64)  # few flows: the combine merges rows
    rec, rec2 = gen.batch(256), gen.batch(300)
    eng._dispatch(rec, now_s=1)
    jeng._dispatch(rec, now_s=1)
    eng._build_quantum([rec, rec2], n_raw=556, now_s=7)
    jeng._build_quantum([rec, rec2], n_raw=556, now_s=7)
    assert [s[1] for s in seen] == [s[1] for s in jseen] == [1, 7]
    for (a, _), (b, _) in zip(seen, jseen):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(seen[0][0], rec)
    assert len(seen[1][0]) < 556  # post-combine rows
    assert int(seen[1][0][:, F.PACKETS].sum()) == 556  # weights preserved

    def boom(r, now_s):
        raise RuntimeError("hook crash")

    eng.record_hook = boom
    eng._dispatch(rec, now_s=2)  # must not raise
    eng._build_quantum([rec], n_raw=len(rec), now_s=8)
    assert eng.errors["record_hook"] == 2


def test_anomaly_hook_gets_the_flagged_dims_at_the_close():
    _, eng = _engines(heavy_keys_source="invertible")
    eng.update_identities({pod_ip(i): i for i in range(1, 60)})
    _, gen = _gens(seed=13, n_flows=2000, n_pods=60)
    calls, flags = [], []
    eng.anomaly_hook = lambda epoch, dims: calls.append((epoch, dims))
    for i in range(13):
        blocks = [gen.batch(2000)]
        if i == 11:
            blocks.append(gen.ddos_batch(6000, target_pod=1, n_sources=48))
        eng.flush(blocks, 100 + i)
        out = eng.close_window(epoch=50 + i)
        flags.append([d for d, f in zip(("src_ip", "dst_ip", "dst_port"),
                                        out["anomaly"].tolist()) if f])
    want = [(50 + i, f) for i, f in enumerate(flags) if f]
    assert calls == want and calls[0][0] == 61 and "src_ip" in calls[0][1]

    def boom(epoch, dims):
        raise RuntimeError("hook crash")

    eng.anomaly_hook = boom
    eng.flush([gen.ddos_batch(6000, n_sources=48)], 200)
    eng.close_window()  # flagged again; the wall clock's epoch; must not raise
    assert eng.errors["anomaly_hook"] == 1
    eng.stop()


# -- the capture pieces --------------------------------------------------------


@pytest.mark.parametrize("args", [
    ([],), (["10.0.0.2", "10.0.0.1", "10.0.0.2"],), (["1.2.3.4"], "tcp", [443, 80, 443]),
    ([], "", [53]), ([], "udp"),
])
def test_synthesize_filter_is_the_references(args):
    assert synthesize_filter(*args) == jsynthesize_filter(*args)


def _packets(n=300, seed=14):
    rng = np.random.default_rng(seed)
    pk = []
    for i in range(n):
        p = dict(src_ip=int(rng.choice([0x0A000001, 0x0A000002, 0xC0000005, 0xFFFFFFFF])),
                 dst_ip=int(rng.choice([0x0A000001, 0x0A000003, 0x08080808])),
                 sport=int(rng.integers(1, 65536)), dport=int(rng.choice([53, 80, 443])),
                 proto=int(rng.choice([6, 17])), tcp_flags=int(rng.integers(0, 256)),
                 ts_ns=int(rng.integers(0, 1 << 60)), tsval=int(rng.integers(0, 3)) * 12345,
                 tsecr=int(rng.integers(0, 2)) * 777)
        if p["proto"] == 17 and i % 3 == 0:
            p.update(dns_qname=f"host{i}.example.com", dns_response=bool(i % 2),
                     dns_rcode=i % 4, dns_qtype=28)
        pk.append(p)
    return pk


@pytest.mark.parametrize("expr", ["", "(host 10.0.0.1)", "(host 10.0.0.2 or host 8.8.8.8)",
                                  "(port 53)", "(host 10.0.0.1) and (port 80 or port 443)"])
def test_apply_filter_is_the_references(expr):
    pk = _packets()
    assert _apply_filter(pk, expr) == japply_filter(pk, expr)


@pytest.mark.parametrize("ns", [True, False])
def test_synthesize_pcap_is_byte_equal_and_reads_back(ns):
    pk = _packets()
    data = synthesize_pcap(pk, ns=ns)
    assert data == jsynthesize_pcap(pk, ns=ns)
    got, want = _decode_pcap_numpy(data), jdecode_pcap(data)
    np.testing.assert_array_equal(got.records, want.records)
    assert got.dns_names == want.dns_names and got.n_decoded == want.n_decoded == len(pk)


@pytest.mark.parametrize("name", ["loopback_dns_real.pcap", "loopback_mixed_real.pcap",
                                  "loopback_real.pcap"])
def test_pcap_reader_matches_reference_on_fixtures(name):
    data = (FIXTURES / name).read_bytes()
    got, want = _decode_pcap_numpy(data), jdecode_pcap(data)
    np.testing.assert_array_equal(got.records, want.records)
    assert (got.dns_names, got.n_packets_total, got.n_decoded) == (
        want.dns_names, want.n_packets_total, want.n_decoded)


def test_replay_provider_writes_the_references_pcap(tmp_path):
    block = TrafficGen(n_flows=200, n_pods=10, seed=15).batch(8192)
    block[::4, F.TSVAL] = 99
    filt = synthesize_filter(["10.0.0.3", "10.0.0.4"])
    for provider, out in ((ReplayProvider(source=lambda: block), tmp_path / "port.pcap"),
                          (JReplayProvider(source=lambda: block), tmp_path / "ref.pcap")):
        provider.capture(str(out), filter_expr=filt, duration_s=1, max_size_mb=1)
    assert (tmp_path / "port.pcap").read_bytes() == (tmp_path / "ref.pcap").read_bytes()

    class Engine:
        """An engine whose feed loop hands the observer three blocks at once;
        the third passes the 1 MB bound and ends the capture."""

        def add_observer(self, fn, name=""):
            for _ in range(3):
                fn(block, "gen")

    for provider, out in ((ReplayProvider(engine=Engine()), tmp_path / "port_eng.pcap"),
                          (JReplayProvider(engine=Engine()), tmp_path / "ref_eng.pcap")):
        provider.capture(str(out), filter_expr=filt, duration_s=5, max_size_mb=1)
    assert (tmp_path / "port_eng.pcap").read_bytes() == (tmp_path / "ref_eng.pcap").read_bytes()
    with pytest.raises(CaptureError, match="no events"):
        ReplayProvider().capture(str(tmp_path / "x.pcap"))


def test_capture_manager_runs_a_job_into_a_tarball(tmp_path, monkeypatch):
    block = TrafficGen(n_flows=200, n_pods=10, seed=16).batch(4096)
    job = CaptureJob(capture_name="t", namespace="retina", node_name="n1",
                     filter_expr=synthesize_filter(["10.0.0.5"]), duration_s=1, max_size_mb=1,
                     packet_size_bytes=0, output={"host_path": str(tmp_path / "out")},
                     include_metadata=True)
    arts = CaptureManager(ReplayProvider(source=lambda: block)).run_job(job)
    assert len(arts) == 1 and arts[0].startswith(str(tmp_path / "out"))
    with tarfile.open(arts[0]) as tf:
        names = tf.getnames()
        pcap = next(n for n in names if n.endswith(".pcap"))
        data = tf.extractfile(pcap).read()
    assert pcap.startswith("capture-t-n1-") and "metadata" in names
    rows = _decode_pcap_numpy(data).records
    assert len(rows) and all(5 in ((s & 0xFF), (d & 0xFF)) for s, d in
                             zip(rows[:, F.SRC_IP], rows[:, F.DST_IP]))
    # With no provider the manager takes the best available one; where no
    # tcpdump, netsh or raw socket is available that is a ReplayProvider
    # with nothing to replay.
    for cls in (TcpdumpProvider, NetshProvider, SocketProvider):
        monkeypatch.setattr(cls, "available", staticmethod(lambda: False))
    with pytest.raises(CaptureError, match="no events"):
        CaptureManager().run_job(job)
    with pytest.raises(RuntimeError, match="output"):
        CaptureManager(ReplayProvider(source=lambda: block)).run_job(
            dataclasses.replace(job, output={}))


# -- AutoCapture ---------------------------------------------------------------


def _wait_captures(ac, n, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and len(ac.captures) < n:
        time.sleep(0.02)
    return ac.captures


def _settle(ac, timeout_s=60.0) -> None:
    """Wait until every queued capture has finished: the trigger queue is
    one deep, so a detection that arrives while one waits is dropped."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with ac._lock:
            if ac._q.empty() and ac.autocapture_triggered == (
                    ac.autocapture_completed + ac.autocapture_failed
                    + ac.autocapture_suppressed["no_keys"]):
                return
        time.sleep(0.01)
    raise AssertionError("captures did not finish")


def _artifact_rows(capture) -> np.ndarray:
    with tarfile.open(capture["artifacts"][0]) as tf:
        member = next(m for m in tf.getmembers() if m.name.endswith(".pcap"))
        return _decode_pcap_numpy(tf.extractfile(member).read()).records


def _only_attributed(rows, capture) -> bool:
    hosts = {ip for ip, _ in capture["sources"]}
    return bool(len(rows)) and all(u32_to_ip(int(s)) in hosts or u32_to_ip(int(d)) in hosts
                                   for s, d in zip(rows[:, F.SRC_IP], rows[:, F.DST_IP]))


def test_autocapture_closes_the_dryrun_loop():
    """timetravel/dryrun.py's loop on the port: window slots built as the
    dryrun builds them, an entropy burst detected at its window, the port's
    AutoCapture attributing it by the span-summed invertible decode, and a
    capture of only the attributed hosts."""
    n_attack, burst_at, windows = 48, 4, 7
    gen = JTrafficGen(n_flows=512, n_pods=16, seed=0, **preset_params("zipf"))
    out_dir = tempfile.mkdtemp(prefix="retina-ttdryrun-")
    cfg = Config(node_name="tt-dryrun", window_seconds=0.25, timetravel_enabled=True,
                 timetravel_ring_windows=windows + 8, autocapture_cooldown_s=300.0,
                 autocapture_lookback_windows=2, autocapture_lookahead_windows=1,
                 autocapture_max_sources=n_attack + 16,
                 autocapture_duration_s=1.0, autocapture_max_size_mb=4,
                 autocapture_output_dir=out_dir)
    ring = SnapshotRing(cfg.timetravel_ring_windows, name="engine")
    qs = QueryService(cfg, device="cpu")
    qs.add_ring(ring)

    def capture_source():
        return np.concatenate([gen.batch(256),
                               gen.ddos_batch(768, target_pod=1, n_sources=n_attack)])

    ac = AutoCapture(cfg, qs, manager=CaptureManager(ReplayProvider(source=capture_source)))
    ac.start()
    det = AnomalyEWMA.zeros(3, device="cpu")
    detected = []
    burst = EPOCH0 + burst_at
    for i in range(windows):
        rec = gen.batch(1024)
        if i == burst_at:
            atk = gen.ddos_batch(98_304, target_pod=1, n_sources=n_attack)
            attack_keys = {tuple(int(x) for x in r)
                           for r in np.unique(_keys_from_records(atk), axis=0)}
            rec = np.concatenate([rec, atk])
        slot = _window_arrays(rec)
        ring.append_host(EPOCH0 + i, slot, cfg.window_seconds, INV_SEEDS)
        h = EntropyWindow(counts=torch.from_numpy(np.array(slot["entropy"])),
                          seed=INV_SEEDS["entropy"]).entropy_bits()
        det, flags, _ = det.observe(h, z_thresh=8.0, min_windows=3)
        if bool(flags.any()) and not detected:
            detected = [EPOCH0 + i]
            assert ac.notify(EPOCH0 + i, ["src_ip"])
    caps = _wait_captures(ac, 1)
    ac.stop()
    assert detected == [burst] and len(caps) == 1 and caps[0]["epoch"] == burst
    assert caps[0]["range"] == (burst - 2, burst + 2) and caps[0]["windows"] == 4
    dec = qs.query_range("engine", burst - 2, burst + 2)["decode"]
    decoded = {tuple(int(x) for x in r) for r in dec["keys"]}
    assert len(decoded & attack_keys) / len(attack_keys) >= 0.95
    rows = _artifact_rows(caps[0])
    assert _only_attributed(rows, caps[0])
    attack_ips = {u32_to_ip(k[0]) for k in attack_keys}
    assert sum(u32_to_ip(int(s)) in attack_ips for s in rows[:, F.SRC_IP]) > 0
    assert 0 < caps[0]["artifact_bytes"] <= 4 << 20
    assert (ac.autocapture_triggered, ac.autocapture_completed, ac.autocapture_failed) == (
        1, 1, 0)
    assert ac.autocapture_last_epoch == burst and ac.autocapture_attributed_keys == len(
        dec["keys"])
    # The cooldown and the one-deep queue damp a trigger storm.
    assert not ac.notify(burst + 1, ["src_ip"])
    assert ac.autocapture_suppressed["cooldown"] == 1


def test_autocapture_busy_and_nothing_attributable():
    cfg = Config(timetravel_enabled=True, autocapture_cooldown_s=0)
    qs = QueryService(cfg, device="cpu")
    qs.add_ring(SnapshotRing(4, name="engine"))
    ac = AutoCapture(cfg, qs, CaptureManager())  # not started: the queue holds one trigger
    assert ac.notify(5, ["src_ip"]) and not ac.notify(6, ["src_ip"])
    assert ac.autocapture_suppressed["busy"] == 1 and ac.autocapture_triggered == 1
    ac._capture_one(5, ["src_ip"])  # an empty ring: nothing to attribute
    assert ac.autocapture_suppressed["no_keys"] == 1 and ac.captures == []


def test_closed_loop_on_an_engine_matches_the_reference_bank(tmp_path):
    """The wiring of the reference daemon on a small engine: the record tap
    feeds the bank, the bank and the engine's anomaly flags notify
    AutoCapture. The reference bank, fed the same tapped rows, fires the
    same detectors at the same windows; each attack window is captured."""
    cfg = Config(heavy_keys_source="invertible", timetravel_enabled=True, autocapture_cooldown_s=0,
                 autocapture_duration_s=1, autocapture_output_dir=str(tmp_path), **SMALL)
    eng = SketchEngine(cfg, device="cpu")
    eng.update_identities({pod_ip(i): i for i in range(1, 60)})
    gen = TrafficGen(n_flows=2000, n_pods=60, seed=17)
    attack = {}
    qs = QueryService(cfg, device="cpu")
    qs.add_ring(eng.timetravel_ring)

    def capture_source():
        return np.concatenate([gen.batch(256), attack["source"]()])

    ac = AutoCapture(cfg, qs, manager=CaptureManager(ReplayProvider(source=capture_source)))
    ac.start()
    bank = build_default_bank(cfg, sink=ac.notify, device="cpu")
    jbank = jbuild_default_bank(JConfig())
    epoch = [0]
    fired, jfired, hooks = [], [], []

    def tap(records, now_s):
        fired.extend(bank.observe(epoch[0], records, now_s=float(now_s)))
        jfired.extend(jbank.observe(epoch[0], records, now_s=float(now_s)))

    def anomaly(e, dims):
        hooks.append((e, dims))
        ac.notify(e, dims)

    eng.record_hook, eng.anomaly_hook = tap, anomaly
    attacks = {12: lambda: gen.portscan_batch(2048, n_scanners=4, n_ports=24),
               16: lambda: gen.tunnel_batch(2048, n_clients=48),
               20: lambda: gen.ddos_batch(6144, n_sources=48)}
    for i in range(24):
        epoch[0] = i
        blocks = [gen.batch(4096)]
        if i in attacks:
            blocks.append(attacks[i]())
            attack["source"] = lambda f=attacks[i]: f()[:768]
        eng.flush(blocks, 100 + i)
        eng.close_window(epoch=i)
        assert eng.timetravel_ring.drain(30.0)
        if i - 1 in attacks:  # the lookahead window landed: let the captures run
            _settle(ac)
    fired += bank.flush(now_s=1e9)
    jfired += jbank.flush(now_s=1e9)
    _settle(ac)
    caps = ac.captures
    ac.stop()
    eng.stop()
    _same_detections(fired, jfired)
    assert [(d.detector, d.epoch) for d in fired] == [
        ("portscan", 12), ("dnstunnel", 16), ("synflood", 20)]
    assert {e for e, _ in hooks} <= {12, 16, 20}
    assert eng.errors == {} and ac.autocapture_failed == 0
    assert {c["epoch"] for c in caps} == {12, 16, 20}
    for c in caps:
        assert c["range"] == (c["epoch"] - 2, c["epoch"] + 2) and c["windows"] == 4
        assert _only_attributed(_artifact_rows(c), c)


def test_ddos_attribution_at_the_deployed_widths_matches_the_reference_engine():
    """The DDoS capture's attribution on chip_smoke.py's detection traffic,
    with the reference engine, ring and range decode beside the port's.

    The engines run Config(heavy_keys_source="invertible") at the deployed
    sketch widths; the batch is cut to 2^13 events. They are fed windows
    W-2..W+1 of the smoke's schedule (W its DDoS window), one window a ring
    slot, from a fresh state, not the 18 windows before them. The sketches
    are cumulative (end_window resets only the entropy window) and the
    invertible sketch is keyed by the 5-tuple, so each of the DDoS's random
    source ports makes a key of one packet. Both decodes over [W-2, W+2)
    must be equal, key for key and source for source, and so must the
    recall of the attack's keys and sources that they give."""
    import chip_smoke as cs

    gen = TrafficGen(n_flows=cs.N_FLOWS, n_pods=cs.N_PODS_GEN, seed=cs.SEED)
    windows, attack_at, attack_rows = cs.detection_schedule(gen)
    burst = next(e for e, a in attack_at.items() if a[0] == "synflood")
    span = range(burst - 2, burst + 2)
    kw = dict(heavy_keys_source="invertible", batch_capacity=1 << 13)
    jcfg, cfg = JConfig(**kw), Config(timetravel_enabled=True, **kw)
    jeng = JEngine(jcfg, devices=[jax.devices("cpu")[0]])
    eng = SketchEngine(cfg, device="cpu")
    pods = {pod_ip(i): i for i in range(1, cs.N_PODS_GEN)}
    jeng.update_identities(pods)
    eng.update_identities(pods)
    jring = JSnapshotRing(len(span), name="engine")
    for e in span:
        rec = np.concatenate(windows[e])
        jeng.step_records(rec, now_s=1000 + e)
        eng.step_records(rec, now_s=1000 + e)
        export = {k: np.asarray(v) for k, v in jeng.sharded.fleet_export(jeng.state).items()}
        jring.append_host(e, export, 1.0, jeng.sharded.fleet_seeds(jeng.state))
        jeng.state, _ = jeng.sharded.end_window(jeng.state)
        eng.close_window(epoch=e)
    assert eng.timetravel_ring.drain(30.0)
    jqs = JQueryService(jcfg)
    jqs.add_ring(jring)
    qs = QueryService(cfg, device="cpu")
    qs.add_ring(eng.timetravel_ring)
    want = jqs.query_range("engine", span[0], span[-1] + 1)
    got = qs.query_range("engine", span[0], span[-1] + 1)
    eng.stop()
    assert got["windows"] == want["windows"] == len(span)
    jdec, dec = want["decode"], got["decode"]

    def keys(d):
        return {tuple(int(x) for x in k) for k in d["keys"]}

    def sources(d):
        return {int(s): int(p) for s, p in zip(*d["sources"])}

    assert len(keys(dec)) > 0 and keys(dec) == keys(jdec)
    assert sources(dec) == sources(jdec)
    atk = attack_rows[burst]
    atk_keys = {(int(r[F.SRC_IP]), int(r[F.DST_IP]), int(r[F.PORTS]), 6) for r in atk}
    atk_srcs = {int(s) for s in atk[:, F.SRC_IP]}
    recall = {name: (len(atk_keys & keys(d)) / len(atk_keys),
                     len(atk_srcs & set(sources(d))) / len(atk_srcs))
              for name, d in (("port", dec), ("reference", jdec))}
    print(f"DDoS attribution over [{span[0]}, {span[-1] + 1}): {len(atk_keys)} attack keys, "
          f"{len(atk_srcs)} attack sources, {len(keys(dec))} decoded keys; "
          f"(key recall, source recall) {recall}")
    assert recall["port"] == recall["reference"]
