"""K14, the apiserver latency match, on the CPU: its wrapper, its plain
version and the port's step against the JAX reference's step.

The reference's ``TelemetryPipeline.step`` and the port's run the same
batches from the same state; after every batch ``lat_key`` and ``lat_ts``
must be equal to the reference's exactly, and to a numpy model of the
settled rules (the last send row of a slot wins; every reply reads the
table after all of its batch's sends; every matching reply counts and the
matched slots are zeroed after all replies read them). The histogram is
held to the model's exact bucket floor(log2(rtt + 1)), and the reference's
to the same model with XLA's float32 log2, which rounds 2^13 and 2^15 down
(ROADMAP, settled rules). The cases: RTTs in every bucket and 0xFFFFFFFF,
the apiserver at address 0 with TSval rows, two replies to one slot in one
batch, replies to sends of their own batch (before and after the send in
batch order), probes past ``n_valid`` and in rows the filter drops, and the
loopback captures, whose rows are each a send and a reply.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retina_tpu.events.schema import F
from retina_tpu.events.synthetic import TrafficGen as JTrafficGen
from retina_tpu.models.identity import IdentityMap as JIdentityMap
from retina_tpu.models.pipeline import PipelineConfig as JConfig
from retina_tpu.models.pipeline import TelemetryPipeline as JPipeline
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models import pipeline as tpipeline
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig, TelemetryPipeline
from retina_tpu_torch.u32 import from_numpy, to_numpy
from test_torch_pipeline import (
    API,
    PODS,
    SMALL,
    exact_bucket,
    latency_batch,
    latency_model,
    traffic,
    xla_bucket,
)

B = 1024


def run_both(batches, api, n_valid=None, latency_slots=1 << 6, pods=PODS):
    """Step the reference and the port through ``batches`` and hold the
    latency state to each other and to ``latency_model`` after every batch
    (rows whose source or destination is one of ``pods`` take part);
    returns the port's final histogram."""
    cfg = dict(SMALL, latency_slots=latency_slots)
    jp, tp = JPipeline(JConfig(**cfg)), TelemetryPipeline(PipelineConfig(**cfg), device="cpu")
    step = jp.jitted_step()
    js, ts = jp.init_state(), tp.init_state()
    ji = JIdentityMap.build_host(pods, n_slots=1 << 8)
    ti = IdentityMap.build_host(pods, n_slots=1 << 8, device="cpu")
    kops.reset_launch_counts()
    for rec in batches:
        nv = len(rec) if n_valid is None else n_valid
        before = [to_numpy(t) for t in (ts.lat_key, ts.lat_ts, ts.lat_hist)]
        jhist = np.asarray(js.lat_hist)
        js, _ = step(js, jnp.asarray(rec), jnp.uint32(nv), jnp.uint32(1), ji,
                     jnp.uint32(api), None, np.uint32(1))
        ts, _ = tp.step(ts, from_numpy(rec, "cpu"), nv, 1, ti, api)
        key, t, hist = latency_model(rec, nv, *before, exact_bucket, api, pods)
        np.testing.assert_array_equal(to_numpy(ts.lat_key), key)
        np.testing.assert_array_equal(to_numpy(ts.lat_ts), t)
        np.testing.assert_array_equal(to_numpy(ts.lat_hist), hist)
        np.testing.assert_array_equal(np.asarray(js.lat_key), key)
        np.testing.assert_array_equal(np.asarray(js.lat_ts), t)
        _, _, hist_xla = latency_model(rec, nv, *before[:2], jhist, xla_bucket, api, pods)
        np.testing.assert_array_equal(np.asarray(js.lat_hist), hist_xla)
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}
    return to_numpy(ts.lat_hist)


def probes(n_pairs, api, pod=0x0A000007, rtts=(5,), t0=1 << 22):
    """n_pairs sends from ``pod`` to ``api`` then their replies, one RTT
    each (cycling ``rtts``), in a (2 n_pairs, 16) batch."""
    rec = np.zeros((2 * n_pairs, 16), np.uint32)
    rec[:, F.META] = (6 << 24) | (0x10 << 16)
    rec[:, F.PACKETS] = 1
    rec[:, F.VERDICT] = 1
    tsv = np.arange(1, n_pairs + 1, dtype=np.uint32) * np.uint32(7919)
    rtt = np.array([rtts[i % len(rtts)] for i in range(n_pairs)], np.int64)
    ms = np.concatenate([t0 + np.arange(n_pairs), (t0 + np.arange(n_pairs) + rtt) & 0xFFFFFFFF])
    ns = ms.astype(np.int64) << 20
    rec[:, F.TS_LO] = (ns & 0xFFFFFFFF).astype(np.uint32)
    rec[:, F.TS_HI] = (ns >> 32).astype(np.uint32)
    rec[:n_pairs, F.SRC_IP], rec[:n_pairs, F.DST_IP] = pod, api
    rec[:n_pairs, F.TSVAL] = tsv
    rec[n_pairs:, F.SRC_IP], rec[n_pairs:, F.DST_IP] = api, pod
    rec[n_pairs:, F.TSECR] = tsv
    return rec


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing(monkeypatch):
    rng = np.random.default_rng(1)
    rec = from_numpy(latency_batch(rng), "cpu")
    mask = torch.ones(B, dtype=torch.int32)
    mask[::5] = 0
    states = [[torch.zeros(n, dtype=torch.int32) for n in (64, 64, 16)] for _ in range(2)]
    calls = []
    plain = tpipeline.latency_update_plain

    def counted(*args):
        calls.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(tpipeline, "latency_update_plain", counted)
    kops.reset_launch_counts()
    for _ in range(2):
        kops.latency_update(*states[0], rec, mask, API)
        plain(*states[1], rec, mask, API)
    assert calls == [API, API]
    assert kops.launch_counts() == {k: 0 for k in kops.launch_counts()}
    for a, b in zip(*states):
        assert torch.equal(a, b)
    assert int(states[0][2].sum()) > 0


def test_step_matches_reference_over_every_bucket():
    rng = np.random.default_rng(5)
    hist = run_both([latency_batch(rng), latency_batch(rng), latency_batch(rng)], API)
    assert hist[15] > 0 and hist.sum() > 0  # 0xFFFFFFFF and 2^20 clamp to the last bucket


def test_step_matches_reference_with_the_apiserver_at_address_zero():
    rng = np.random.default_rng(6)
    batches = [probes(100, 0, rtts=(0, 3, 700, 0xFFFFFFFF)), traffic(7, 1)[0]]
    batches[1][::9, F.DST_IP] = 0  # ordinary rows to address 0 with a TSval are sends
    batches[1][::9, F.TSVAL] = rng.integers(1, 1 << 31, len(batches[1][::9]))
    hist = run_both(batches, 0)
    assert hist.sum() > 0


def test_two_replies_to_one_slot_and_replies_before_their_send():
    rec = probes(64, API, rtts=(1, 9000, 40000))
    # Each reply twice: both count, then the slot is zeroed.
    twice = np.concatenate([rec, rec[64:]])
    # Replies ahead of their sends in batch order still see them.
    ahead = np.concatenate([probes(64, API, t0=1 << 24)[64:], probes(64, API, t0=1 << 24)[:64]])
    hist = run_both([twice, ahead], API, latency_slots=1 << 12)
    assert hist.sum() > 64


def test_rows_past_n_valid_and_filtered_rows_take_no_part():
    rec = probes(200, API, rtts=(2, 20, 200))
    garbage = probes(200, API, rtts=(4000,), t0=1 << 23)
    batch = np.concatenate([rec[:200], rec[200:300], garbage, rec[300:]])
    batch[5::11, F.SRC_IP] = 0xC0000001  # sends from no pod: the filter drops them
    pods = {ip: pod for ip, pod in PODS.items() if ip != API}
    hist = run_both([batch], API, n_valid=300, pods=pods)
    assert 0 < hist.sum() < 100


def test_colliding_slots_keep_the_last_send():
    rec = probes(300, API, rtts=(1, 2, 3))  # 300 sends into 8 slots
    hist = run_both([rec, probes(300, API, t0=1 << 25)], API, latency_slots=1 << 3)
    assert 0 < hist.sum() <= 16


def test_loopback_captures_match_reference():
    cap = JTrafficGen(mode="pcap_replay", seed=0)
    hist = run_both([cap.batch(B) for _ in range(3)], API)
    assert hist.sum() > 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rec = torch.zeros((64, 16), dtype=torch.int32)
    mask = torch.ones(64, dtype=torch.int32)
    key, ts, hist = (torch.zeros(n, dtype=torch.int32) for n in (64, 64, 16))
    with pytest.raises(ValueError, match="B, 16"):
        kops.latency_update(key, ts, hist, rec[:, :12].contiguous(), mask, 0)
    with pytest.raises(ValueError, match="contiguous"):
        kops.latency_update(key, ts, hist, torch.zeros((16, 64), dtype=torch.int32).t(), mask, 0)
    with pytest.raises(ValueError, match="power of two"):
        kops.latency_update(key[:48], ts[:48], hist, rec, mask, 0)
    with pytest.raises(ValueError, match="shape"):
        kops.latency_update(key, ts[:32], hist, rec, mask, 0)
    with pytest.raises(ValueError, match="shape"):
        kops.latency_update(key, ts, hist, rec, mask[:10], 0)
    with pytest.raises(TypeError, match="int32"):
        kops.latency_update(key.long(), ts, hist, rec, mask, 0)
    with pytest.raises(TypeError, match="int32"):
        kops.latency_update(key, ts, hist, rec, mask.bool(), 0)
    with pytest.raises(ValueError, match="unsupported device"):
        kops.latency_update(key.to("meta"), ts.to("meta"), hist.to("meta"), rec.to("meta"),
                            mask.to("meta"), 0)
