"""The port's flight recorder against the reference's (``obs/recorder.py``).

Scripted sequences of ``begin``/``record`` calls (explicit timestamps,
sampling gates, ring wraps, torn slots, several threads, a disabled
recorder) go to both recorders; ``spans``, ``stage_report``,
``chrome_trace`` and ``stats`` must be equal. Then the port's engine on the
CPU: a synchronous flush and close and a short run of the lanes with two
feed workers record the reference's stages, and ``stage_seconds`` counts
each recorded span.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

import retina_tpu_torch.metrics as port_metrics
from retina_tpu.obs import recorder as jrec
from retina_tpu_torch.config import Config
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip
from retina_tpu_torch.exporter import Exporter
from retina_tpu_torch.obs import recorder as prec
from retina_tpu_torch.utils import metric_names as mn


@pytest.fixture(autouse=True)
def _fresh_metrics():
    saved = port_metrics._singleton
    port_metrics.reset_for_tests()
    port_metrics.initialize_metrics(Exporter())
    yield
    port_metrics._singleton = saved


def _explicit(rec):
    for i in range(40):
        rec.record(mn.STAGES[i % 9], 1.0 + i, trace_id=i // 4, t1=1.0 + i + (i % 7) * 0.01)


def _sampled(rec):
    # begin() gates on the per-thread counter; record the gate's pattern.
    kept = []
    for i in range(23):
        t0 = rec.begin()
        kept.append(bool(t0))
        if t0:
            rec.record(mn.STAGE_PUBLISH, 10.0 + i, trace_id=i, t1=10.5 + i)
        else:
            rec.record(mn.STAGE_PUBLISH, t0, trace_id=i)
    rec.record(mn.STAGE_HARVEST, 0.0, t1=5.0)  # a sampled-out sentinel
    return kept


def _wrap(rec):
    for i in range(100):
        rec.record(mn.STAGE_PUBLISH, float(i + 1), trace_id=i, t1=float(i) + 1.5)


def _torn(rec):
    rec.record(mn.STAGE_HARVEST, 1.0, t1=2.0)
    ring = rec._ring()
    ring.slots[5][0] = mn.STAGE_PUBLISH
    ring.slots[5][1] = 9.0
    ring.slots[5][2] = 1.0


def _threads(rec):
    def work(k):
        for i in range(10):
            rec.record(mn.STAGES[(i + k) % 5], 100.0 * k + i + 1, trace_id=k,
                       t1=100.0 * k + i + 1.25)

    threads = [threading.Thread(target=work, args=(k,), name=f"rec-{k}") for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)


def _percentiles(rec):
    for i in range(100):
        rec.record(mn.STAGE_DEVICE_STEP, 1.0, t1=1.0 + (i + 1) / 1000)
    rec.record("not_a_registered_stage", 1.0, t1=1.5)


SCRIPTS = {
    "explicit": (_explicit, dict(capacity=64)),
    "sampled_every_4": (_sampled, dict(capacity=64, sample_every=4)),
    "sampled_every_1": (_sampled, dict(capacity=64)),
    "wrap": (_wrap, dict(capacity=16)),
    "torn": (_torn, dict(capacity=16)),
    "threads": (_threads, dict(capacity=32)),
    "percentiles": (_percentiles, dict(capacity=256)),
    "disabled": (_explicit, dict(capacity=64, enabled=False)),
}


def _normalized(doc):
    """A chrome trace as the JSON a dump would write."""
    return json.loads(json.dumps(doc))


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_recorder_equals_the_reference(script):
    fn, kw = SCRIPTS[script]
    port, ref = prec.FlightRecorder(**kw), jrec.FlightRecorder(**kw)
    ref._metrics_broken = True  # the reference's exposition is not under test
    out = fn(port), fn(ref)
    assert out[0] == out[1]
    assert port.spans() == ref.spans()
    assert port.spans(last=5) == ref.spans(last=5)
    assert port.stage_report() == ref.stage_report()
    assert port.stage_report(last=7) == ref.stage_report(last=7)
    assert _normalized(port.chrome_trace()) == _normalized(ref.chrome_trace())
    assert port.stats() == ref.stats()
    if kw.get("enabled", True):
        assert port.spans()


def test_spans_feed_stage_seconds():
    rec = prec.FlightRecorder(capacity=64)
    for i in range(5):
        rec.record(mn.STAGE_TRANSFER, 1.0, t1=1.0 + 0.001 * (i + 1))
    t0 = rec.begin()
    rec.record(mn.STAGE_HARVEST, t0)
    text = port_metrics.get_metrics().stage_seconds
    samples = {(s, labels.get("stage"), labels.get("le")): v for s, labels, v in text.samples()}
    assert samples[("_count", mn.STAGE_TRANSFER, None)] == 5
    assert samples[("_sum", mn.STAGE_TRANSFER, None)] == pytest.approx(0.015)
    assert samples[("_count", mn.STAGE_HARVEST, None)] == 1


def test_singleton_is_rebuilt_from_config():
    eng = SketchEngine(Config(trace_ring_spans=128, trace_sample_every=3, batch_capacity=1 << 10,
                              n_pods=64, cms_width=1 << 10, topk_slots=1 << 6, hll_precision=8,
                              entropy_buckets=1 << 8, conntrack_slots=1 << 8,
                              identity_slots=1 << 8), device="cpu")
    rec = prec.get_recorder()
    assert rec is eng._recorder and rec.capacity == 128 and rec.sample_every == 3
    off = prec.initialize_recorder(enabled=False)
    assert prec.get_recorder() is off and off.begin() == 0.0
    prec.initialize_recorder()


SMALL = dict(batch_capacity=1 << 10, n_pods=64, cms_width=1 << 10, topk_slots=1 << 6,
             hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 8,
             identity_slots=1 << 8, flow_dict_slots=1 << 12, transfer_min_bucket=64)


def test_engine_records_the_reference_stages():
    """A synchronous flush (dictionary wire) and close, then the lanes with
    two feed workers: every engine stage of the reference records spans,
    each in stage_seconds."""
    eng = SketchEngine(Config(**SMALL), device="cpu")
    pods = {pod_ip(i): i for i in range(1, 60)}
    eng.update_identities(pods)
    gen = TrafficGen(n_flows=400, n_pods=60, seed=5)
    eng.flush([gen.batch(500), gen.batch(500)], 100)
    eng.close_window(epoch=1)
    rep = eng._recorder.stage_report()
    for stage in (mn.STAGE_COMBINE, mn.STAGE_WIRE_BUILD, mn.STAGE_TRANSFER,
                  mn.STAGE_DEVICE_STEP, mn.STAGE_WINDOW_CLOSE):
        assert rep[stage]["count"] >= 1, stage
    cfg = Config(**SMALL, window_seconds=0.2, flush_interval_s=0.01, flush_max_age_s=0.05,
                 flush_max_events=2048, overload_enabled=False, feed_workers=2)
    eng = SketchEngine(cfg, device="cpu")
    eng.update_identities(pods)
    stop = threading.Event()
    lanes = threading.Thread(target=eng.start, args=(stop,), daemon=True)
    lanes.start()
    for _ in range(6):
        eng.sink.write_records(gen.batch(300), "gen")
        time.sleep(0.02)
    deadline = time.monotonic() + 30
    while eng.counts.events < 1800 and time.monotonic() < deadline:
        time.sleep(0.01)
    while eng.windows["end_window"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    stop.set()
    lanes.join(30)
    assert not lanes.is_alive() and eng.counts.events == 1800
    eng.stop()
    rep = eng._recorder.stage_report()
    for stage in (mn.STAGE_GENERATOR_EMIT, mn.STAGE_FEED_FILL, mn.STAGE_STAGING_HANDOFF,
                  mn.STAGE_COMBINE, mn.STAGE_WIRE_BUILD, mn.STAGE_TRANSFER,
                  mn.STAGE_DEVICE_STEP, mn.STAGE_WINDOW_CLOSE, mn.STAGE_HARVEST,
                  mn.STAGE_PUBLISH):
        assert rep[stage]["count"] >= 1, stage
    hist = {labels["stage"]: v for s, labels, v in
            port_metrics.get_metrics().stage_seconds.samples() if s == "_count"}
    for stage, st in rep.items():
        assert hist[stage] >= st["count"]
    threads = {s["thread"] for s in eng._recorder.spans()}
    # Each lane records on its own thread's ring.
    assert {"feed-worker-0", "feed-worker-1", "engine-dispatch", "window-harvest",
            "device-proxy-cpu"} <= threads, threads
    assert np.isfinite([st["p99_s"] for st in rep.values()]).all()
