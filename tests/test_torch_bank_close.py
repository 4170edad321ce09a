"""The bank's close (``kops.bank_close``: K12, K13 and the three built-in
detectors' anomaly EWMA in one launch) against the reference (CPU).

``bank_close_plain`` is held against the reference's per-detector
``judge`` sequence: its program's score, then ``AnomalyEWMA.observe`` on
the detector's own state, for every active slot, in the bank's order; an
inactive slot takes no step. Inputs are made from a seed with numpy
(``test_torch_kernels.bank_windows``). Tolerances (ROADMAP "Floats"):
flags and n_obs equal, the synflood ratio and the portscan maximum exact,
the dnstunnel bits rtol 1e-5, z atol 1e-4, mean rtol 1e-5, var atol 1e-6.
The bank's own path (which detectors go through the batched call, the
in-place state, failures) is checked here too; the table the wrapper
hands the kernel is read where the launch would enter C.
"""

from __future__ import annotations

import ctypes
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retina_tpu.detect import programs as jprograms
from retina_tpu.detect.base import DetectorBank as JBank
from retina_tpu.detect.detectors import DnsTunnelDetector as JDnsTunnel
from retina_tpu.detect.detectors import PortScanDetector as JPortScan
from retina_tpu.detect.detectors import SynFloodDetector as JSynFlood
from retina_tpu.ops.entropy import AnomalyEWMA as JEWMA
from retina_tpu_torch.config import Config
from retina_tpu_torch.detect import build_default_bank
from retina_tpu_torch.detect.base import BATCHED, DetectorBank
from retina_tpu_torch.detect.detectors import (
    DnsTunnelDetector,
    PortScanDetector,
    SynFloodDetector,
)
from retina_tpu_torch.kernels import ops as kops
from test_torch_detect import EPOCH0, _gens, _Pair
from test_torch_kernels import BANK_CASES, BANK_KINDS, BANK_KNOBS, REPO, bank_slots, bank_windows


def _reference_scores(window):
    """The reference programs' scores of one window's active slots."""
    hist, est, lanes = window
    return [None if hist is None else
            float(jprograms.dnstunnel_program(64, jprograms.DNSTUNNEL_SEED)(
                jnp.asarray(hist))[0]),
            None if est is None else float(jnp.max(jnp.asarray(est))),
            None if lanes is None else float(jprograms.synflood_program()(
                jnp.asarray(lanes))[0])]


@pytest.mark.parametrize("case", BANK_CASES)
def test_bank_close_plain_matches_the_reference_judges(case):
    refs = [JEWMA.zeros(1, alpha=alpha) for _, _, alpha in BANK_KNOBS]
    state = [torch.zeros(3) for _ in range(3)]
    kops.reset_launch_counts()
    flagged = []
    for window in bank_windows(case):
        score, z, flag = kops.bank_close(bank_slots(window, "cpu"), *state)
        assert score.dtype == z.dtype == torch.float32 and flag.dtype == torch.bool
        for j, (s, (z_thresh, min_windows, _)) in enumerate(zip(_reference_scores(window),
                                                               BANK_KNOBS)):
            if s is None:  # no step: zeros out, the state as it was
                assert (float(score[j]), float(z[j]), bool(flag[j])) == (0.0, 0.0, False)
            else:
                refs[j], f_ref, z_ref = refs[j].observe(
                    jnp.asarray([s], jnp.float32), z_thresh=z_thresh, min_windows=min_windows)
                assert bool(flag[j]) == bool(f_ref[0])
                flagged.append(bool(flag[j]))
                if BANK_KINDS[j] == kops.BANK_DNSTUNNEL:
                    np.testing.assert_allclose(float(score[j]), s, rtol=1e-5, atol=1e-7)
                else:
                    assert float(score[j]) == s
                np.testing.assert_allclose(float(z[j]), float(z_ref[0]), rtol=0, atol=1e-4)
            np.testing.assert_allclose(float(state[0][j]), float(refs[j].mean[0]), rtol=1e-5)
            np.testing.assert_allclose(float(state[1][j]), float(refs[j].var[0]), atol=1e-6)
            assert float(state[2][j]) == float(refs[j].n_obs[0])
    assert kops.launch_counts()["bank_close"] == 0
    assert any(flagged) or case not in ("flagged", "mixed")


def test_bank_close_lays_out_a_slot_an_active_detector(monkeypatch):
    """The wrapper's table without a card (csrc/detect.cu's BankTable, read
    back through ``kops._BankTable``; sizes pinned by the kernel's
    static_asserts): an active slot a detector in order, its histograms and
    lanes in the table end to end (the estimates where K11 wrote them), its
    row i and state i, its knobs; no launch when every slot is inactive;
    a table a launch when the slots pass one table's slots or floats, with
    one wait for all; the rows read back after the wait; K12 and K13 alone
    are one slot with no state, their rows in a tensor of their own."""
    src = (REPO / "retina_tpu_torch/kernels/csrc/detect.cu").read_text()
    assert f"kBankMaxSlots = {kops.BANK_MAX_SLOTS};" in src
    assert f"kBinsPerLane = {kops.BANK_MAX_BINS // 32};" in src
    assert f"kBankRow = {kops.BANK_ROW};" in src
    assert f"kBankFeatures = {kops.BANK_TABLE_FEATURES};" in src
    assert ctypes.sizeof(kops._BankSlot) == 48 and "sizeof(BankSlot) == 48" in src
    assert ctypes.sizeof(kops._BankTable) == (32 + 48 * kops.BANK_MAX_SLOTS
                                              + 4 * kops.BANK_TABLE_FEATURES)
    seen, waits = [], []

    class FakeIO:
        out = torch.zeros(16 * kops.BANK_ROW)
        out_np = out.numpy()
        out_dev = 1 << 41

        class event:
            record = staticmethod(lambda stream: None)
            synchronize = staticmethod(lambda: waits.append(1))

    def launch(name, dev, ptr, n_launches=1):
        t = kops._BankTable.from_address(ptr)
        seen.append((name, t.mean, t.var, t.n_obs, [
            (e.x, e.out, e.kind, e.n, e.state, e.z_thresh, e.min_windows, e.alpha)
            for e in t.slots[:t.n_slots]], [e.off for e in t.slots[:t.n_slots]],
            np.ctypeslib.as_array(t.feat).copy()))
        FakeIO.out_np.reshape(-1, kops.BANK_ROW)[:3] = [[1, 2, 3, 4, 0], [5, 0, 0, 6, 1],
                                                        [7, 8, 9, 10, 1]]

    monkeypatch.setattr(kops, "_on_card", lambda dev: True)
    monkeypatch.setattr(kops, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    state = [torch.zeros(3) for _ in range(3)]
    hist = np.arange(64, dtype=np.float32).reshape(1, 64)
    lanes = np.arange(9, dtype=np.float32)
    est = torch.ones(32)
    slots = [(kops.BANK_DNSTUNNEL, hist, 8.0, 3, 0.1), (kops.BANK_PORTSCAN, est, 4.0, 2, 0.25),
             (kops.BANK_SYNFLOOD, lanes, 3.0, 5, 0.5)]
    score, z, flag = kops.bank_close(slots, *state, io=FakeIO)
    (name, mean, var, n_obs, got, offs, feat), = seen
    assert (name, mean, var, n_obs) == ("bank_close", *(t.data_ptr() for t in state))
    row = lambda i: FakeIO.out_dev + 4 * kops.BANK_ROW * i  # noqa: E731
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    assert got == [(None, row(0), kops.BANK_DNSTUNNEL, 64, 0, 8.0, 3.0, f32(0.1)),
                   (est.data_ptr(), row(1), kops.BANK_PORTSCAN, 32, 1, 4.0, 2.0, 0.25),
                   (None, row(2), kops.BANK_SYNFLOOD, 9, 2, 3.0, 5.0, 0.5)]
    assert offs == [0, 0, 64]
    np.testing.assert_array_equal(feat[:73], np.concatenate([hist[0], lanes]))
    assert score.tolist() == [1, 5, 7] and z.tolist() == [4, 6, 10]
    assert flag.tolist() == [False, True, True] and len(waits) == 1
    # An inactive slot keeps its row and state out of the table.
    seen.clear()
    score, _, flag = kops.bank_close([slots[0], (kops.BANK_PORTSCAN, None, 4.0, 2, 0.1),
                                      slots[2]], *state, io=FakeIO)
    assert [(e[1], e[4]) for e in seen[0][4]] == [(row(0), 0), (row(2), 2)]
    assert seen[0][5] == [0, 64]
    assert score.tolist() == [1, 0, 7] and flag.tolist() == [False, False, True]
    # Past one table's floats (three 256-bin histograms) or slots (ten
    # slots): a table a launch, the slots in order, one wait.
    seen.clear()
    wide = (kops.BANK_DNSTUNNEL, np.ones((1, 256), np.float32), 8.0, 3, 0.1)
    kops.bank_close([wide, slots[1], wide, wide], *[torch.zeros(4) for _ in range(3)],
                    io=FakeIO)
    assert [[(e[4], o) for e, o in zip(t[4], t[5])] for t in seen] == [
        [(0, 0), (1, 0), (2, 256)], [(3, 0)]]
    assert len(waits) == 3
    seen.clear()
    many = [slots[i % 3] for i in range(10)]
    kops.bank_close(many, *[torch.zeros(10) for _ in range(3)], io=FakeIO)
    assert [[e[4] for e in t[4]] for t in seen] == [list(range(8)), [8, 9]]
    assert [t[4][0][1] for t in seen] == [row(0), row(8)] and len(waits) == 4
    with pytest.raises(ValueError, match="hold 16 slots, not 17"):
        kops.bank_close([slots[2]] * 17, *[torch.zeros(17) for _ in range(3)], io=FakeIO)
    seen.clear()
    out = kops.bank_close([(k, None, 1.0, 1, 0.1) for k in BANK_KINDS], *state, io=FakeIO)
    assert not seen and len(waits) == 4 and all(not t.any() for t in out)
    # The one-slot forms.
    for fn, x, kind, n in ((kops.dnstunnel_score, torch.zeros((1, 64)), kops.BANK_DNSTUNNEL, 64),
                           (kops.synflood_score, torch.zeros(9), kops.BANK_SYNFLOOD, 9)):
        seen.clear()
        got = fn(x)
        (name, mean, _, _, slot, _, _), = seen
        assert name == fn.__name__ and mean is None
        assert slot == [(x.data_ptr(), got.data_ptr(), kind, n, -1, 0.0, 0.0, 0.0)]
        assert got.shape == ((2,) if kind == kops.BANK_DNSTUNNEL else (3,))


def test_bank_close_rejects_what_the_kernel_does_not_take():
    state = [torch.zeros(2) for _ in range(3)]
    hist, lanes = np.zeros((1, 64), np.float32), np.zeros(9, np.float32)
    good = [(kops.BANK_DNSTUNNEL, hist, 8.0, 3, 0.1), (kops.BANK_SYNFLOOD, lanes, 8.0, 3, 0.1)]
    with pytest.raises(ValueError, match="no bank slots"):
        kops.bank_close([], *[t[:0] for t in state])
    with pytest.raises(ValueError, match="shape"):
        kops.bank_close(good * 5, *state)
    with pytest.raises(ValueError, match="shape"):
        kops.bank_close(good, torch.zeros(3), *state[1:])
    with pytest.raises(TypeError, match="float32"):
        kops.bank_close(good, *state[:2], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown kind"):
        kops.bank_close([(7, lanes, 8.0, 3, 0.1), good[1]], *state)
    with pytest.raises(TypeError, match="float32 numpy"):
        kops.bank_close([(kops.BANK_DNSTUNNEL, hist.astype(np.float64), 8.0, 3, 0.1), good[1]],
                        *state)
    with pytest.raises(ValueError, match="1, nbins"):
        kops.bank_close([(kops.BANK_DNSTUNNEL, np.zeros((1, 257), np.float32), 8.0, 3, 0.1),
                         good[1]], *state)
    with pytest.raises(ValueError, match="lanes"):
        kops.bank_close([good[0], (kops.BANK_SYNFLOOD, lanes[:8], 8.0, 3, 0.1)], *state)
    with pytest.raises(ValueError, match="groups"):
        kops.bank_close([good[0], (kops.BANK_PORTSCAN, torch.zeros((2, 16)), 8.0, 3, 0.1)],
                        *state)
    score, z, flag = kops.bank_close(good, *state)
    assert score.shape == z.shape == flag.shape == (2,)


def test_only_the_builtin_classes_are_batched(monkeypatch):
    """A subclass that overrides ``score`` is judged alone through
    ``judge()``; the built-ins of the bank go through one ``bank_close``
    call, in the bank's order, their ``_ewma`` views of the bank's state."""

    class Doubled(SynFloodDetector):
        name = "synflood-doubled"

        def score(self):
            s = super().score()
            return None if s is None else 2.0 * s

    calls, judged = [], []
    bank_close = kops.bank_close
    monkeypatch.setattr(kops, "bank_close", lambda slots, *a, **kw: (
        calls.append([k for k, *_ in slots]), bank_close(slots, *a, **kw))[1])
    judge = Doubled.judge
    monkeypatch.setattr(Doubled, "judge", lambda self, e: (judged.append(e), judge(self, e))[1])
    dets = [DnsTunnelDetector(device="cpu"), Doubled(device="cpu"),
            SynFloodDetector(device="cpu"), PortScanDetector(device="cpu")]
    bank = DetectorBank(dets)
    assert bank._batched == [dets[0], dets[2], dets[3]] and type(dets[1]) not in BATCHED
    assert dets[2]._ewma.mean.data_ptr() == bank._state[0][1:].data_ptr()
    _, port = _gens(seed=7)
    bank.observe(EPOCH0, port.ddos_batch(8192, n_sources=64), now_s=0.0)
    bank.flush(now_s=1.0)
    assert calls == [[kops.BANK_DNSTUNNEL, kops.BANK_SYNFLOOD, kops.BANK_PORTSCAN]]
    assert judged == [EPOCH0]
    assert dets[1].last_score == pytest.approx(2.0 * dets[2].last_score, rel=1e-6)
    assert float(dets[1]._ewma.n_obs[0]) == 1.0 and float(bank._state[2][1]) == 1.0


def test_judge_alone_steps_the_banks_state():
    """``Detector.judge`` on a banked detector steps the bank's state in
    place (its ``_ewma`` is a view), so bank closes and lone judges
    interleave as the reference's judges do."""
    _, port = _gens(seed=8)
    bank = DetectorBank([SynFloodDetector(min_windows=2, device="cpu")])
    syn, ref = bank.detectors[0], JSynFlood(min_windows=2)
    for e in range(6):
        rec = port.ddos_batch(4096, n_sources=64) if e == 5 else port.batch(4096)
        if e % 2:
            syn.begin_window()
            ref.begin_window()
            syn.add_records(rec)
            ref.add_records(rec)
            got, want = syn.judge(EPOCH0 + e), [ref.judge(EPOCH0 + e)]
        else:
            bank.observe(EPOCH0 + e, rec, now_s=float(e))
            got = bank.flush(now_s=float(e))
            ref.begin_window()
            ref.add_records(rec)
            want = [ref.judge(EPOCH0 + e)]
        assert bool(got) == any(want) == (e == 5)
        assert syn.last_z == pytest.approx(ref.last_z, abs=1e-4)
        for f in ("mean", "var", "n_obs"):
            assert float(bank._state[("mean", "var", "n_obs").index(f)][0]) == pytest.approx(
                float(getattr(ref._ewma, f)[0]), rel=1e-5, abs=1e-6)
    assert float(bank._state[2][0]) == 6.0


def test_a_failed_batched_call_skips_its_detectors(monkeypatch, caplog):
    """If ``bank_close`` raises, each batched detector is logged and
    skipped (no score, no firing) and the other detectors are judged; a
    detector whose features raise is skipped alone."""

    def boom(*a, **kw):
        raise RuntimeError("boom")

    _, port = _gens(seed=7)
    atk = port.ddos_batch(8192, n_sources=64)
    lone = type("LoneSyn", (SynFloodDetector,), {"name": "lone-syn"})(device="cpu")
    bank = DetectorBank([SynFloodDetector(device="cpu"), lone])
    monkeypatch.setattr(kops, "bank_close", boom)
    bank.observe(EPOCH0, atk, now_s=0.0)
    with caplog.at_level(logging.ERROR, logger="retina_tpu_torch.detect"):
        assert [d.detector for d in bank.flush(now_s=1.0)] == ["lone-syn"]
    assert "detector synflood failed" in caplog.text
    assert "synflood" not in bank.detector_score and float(bank._state[2][0]) == 0.0
    monkeypatch.undo()
    caplog.clear()
    bank = build_default_bank(Config(), device="cpu")
    ps = next(d for d in bank.detectors if d.name == "portscan")
    monkeypatch.setattr(ps, "bank_input", boom)
    bank.observe(EPOCH0, atk, now_s=0.0)
    with caplog.at_level(logging.ERROR, logger="retina_tpu_torch.detect"):
        assert [d.detector for d in bank.flush(now_s=1.0)] == ["synflood"]
    assert "detector portscan failed" in caplog.text and "portscan" not in bank.detector_score
    assert bank._state[2].tolist() == [0.0, 0.0, 1.0]


def test_a_batched_bank_with_a_reference_pair_over_many_windows():
    """The three built-ins batched against the reference's bank over a
    warm-up, a flood and a quiet tail (``_Pair``: firings, sinks and
    counters each window)."""
    from retina_tpu.detect.base import build_default_bank as jbuild_default_bank
    from retina_tpu.config import Config as JConfig

    pair = _Pair(build_default_bank(Config(detector_min_windows=2), device="cpu"),
                 jbuild_default_bank(JConfig(detector_min_windows=2)))
    ref, port = _gens(seed=11, dns_fraction=0.2)
    for e in range(10):
        rec = port.ddos_batch(4096, n_sources=32) if e == 6 else port.batch(4096)
        np.testing.assert_array_equal(rec, ref.ddos_batch(4096, n_sources=32) if e == 6
                                      else ref.batch(4096))
        pair.observe(EPOCH0 + e, rec, now_s=float(e))
    pair.flush(now_s=10.0)
    assert [(d.detector, d.epoch) for d in pair.fired] == [("synflood", EPOCH0 + 6)]


def test_a_bank_of_nine_builtins_scores_every_one():
    """More built-ins than one launch's table holds (nine: synflood at four
    thresholds, dnstunnel at three, portscan at two) are all batched and all
    scored every window: against the reference's bank of the same nine
    (``_Pair``: firings, sinks and counters; each score within rtol 1e-5 of
    its reference twin's), each score, z and EWMA state equal to those of a
    twin judged alone through ``judge()``."""
    knobs = [(JSynFlood, SynFloodDetector, 2.0, 2), (JSynFlood, SynFloodDetector, 4.0, 3),
             (JSynFlood, SynFloodDetector, 6.0, 2), (JSynFlood, SynFloodDetector, 8.0, 3),
             (JDnsTunnel, DnsTunnelDetector, 3.0, 2), (JDnsTunnel, DnsTunnelDetector, 8.0, 3),
             (JDnsTunnel, DnsTunnelDetector, 5.0, 2), (JPortScan, PortScanDetector, 4.0, 2),
             (JPortScan, PortScanDetector, 8.0, 3)]
    port = [cls(z_thresh=z, min_windows=k, device="cpu") for _, cls, z, k in knobs]
    ref = [cls(z_thresh=z, min_windows=k) for cls, _, z, k in knobs]
    alone = [type(f"Alone{cls.__name__}", (cls,), {})(z_thresh=z, min_windows=k, device="cpu")
             for _, cls, z, k in knobs]
    pair = _Pair(DetectorBank(port), JBank(ref))
    lone = DetectorBank(alone)
    assert pair.port._batched == port and not lone._batched
    jgen, gen = _gens(seed=13, dns_fraction=0.2)
    for e in range(8):
        rec = gen.ddos_batch(4096, n_sources=32) if e == 5 else gen.batch(4096)
        np.testing.assert_array_equal(rec, jgen.ddos_batch(4096, n_sources=32) if e == 5
                                      else jgen.batch(4096))
        pair.observe(EPOCH0 + e, rec, now_s=float(e))
        lone.observe(EPOCH0 + e, rec, now_s=float(e))
        if e:
            for d, r, t in zip(port, ref, alone):
                assert d.last_score == pytest.approx(r.last_score, rel=1e-5), d.name
                assert (d.last_score, d.last_z) == (t.last_score, t.last_z), d.name
    pair.flush(now_s=8.0)
    lone.flush(now_s=8.0)
    for i, f in enumerate(("mean", "var", "n_obs")):
        assert pair.port._state[i].tolist() == [float(getattr(t._ewma, f)[0]) for t in alone]
    assert min(pair.port._state[2].tolist()) >= 7.0 and pair.fired
