"""The port's checkpoints against the reference's (``checkpoint.py``).

- A state the port stepped, saved by the port, loads in the reference's
  ``load_state`` (into its ``TelemetryPipeline``), and a state the reference
  stepped, saved by the reference, loads in the port's; the leaves are bit
  for bit those saved, and the two packages' fingerprints of the same
  ``PipelineConfig`` are equal. At ``__graft_entry__.entry()``'s sizes and
  at a smaller invertible cut.
- Every unusable file (missing, truncated, another fingerprint, a leaf of
  another shape, garbage) gives the same ``(resumed, quarantined)`` outcome
  in both packages, and a zero state.
- The engine's ``save_snapshot_state`` writes the same file format, which
  the reference loads, and a torn write (``checkpoint:corrupt``) leaves no
  file but the quarantined one.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import pytest

import __graft_entry__
from retina_tpu import checkpoint as jckpt
from retina_tpu.models.pipeline import PipelineConfig as JPipelineConfig
from retina_tpu.models.pipeline import TelemetryPipeline as JPipeline
from retina_tpu.runtime import faults as jfaults
from retina_tpu_torch import checkpoint
from retina_tpu_torch.config import Config
from retina_tpu_torch.convert import state_to_numpy
from retina_tpu_torch.engine import SketchEngine, pipeline_config_from
from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig, TelemetryPipeline
from retina_tpu_torch.runtime import faults
from retina_tpu_torch.u32 import from_numpy, to_numpy

# __graft_entry__.entry()'s PipelineConfig, and a smaller invertible cut.
GRAFT = dict(n_pods=1 << 8, cms_width=1 << 12, topk_slots=1 << 8, hll_precision=10,
             hll_pod_precision=6, entropy_buckets=1 << 10, conntrack_slots=1 << 12,
             latency_slots=1 << 8)
SMALL_INV = dict(n_pods=1 << 6, cms_width=1 << 10, topk_slots=1 << 6, hll_precision=8,
                 entropy_buckets=1 << 8, conntrack_slots=1 << 8, latency_slots=1 << 6,
                 enable_invertible=True, inv_width=1 << 8, inv_hi_width=1 << 5)
CUTS = {"graft_entry": GRAFT, "small_invertible": SMALL_INV}


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.clear()
    jfaults.clear()


def _port_state(knobs: dict, steps: int = 2):
    """A port state after ``steps`` steps of TrafficGen traffic and a
    window close (integers, float counts and EWMA state all nonzero)."""
    pipe = TelemetryPipeline(PipelineConfig(**knobs), device="cpu")
    ident = IdentityMap.build_host({pod_ip(i): i for i in range(1, 60)}, n_slots=1 << 10,
                                   device="cpu")
    gen = TrafficGen(n_flows=500, n_pods=100, seed=7)
    state = pipe.init_state()
    for i in range(steps):
        rec = gen.batch(256)
        state, _ = pipe.step(state, from_numpy(rec, "cpu"), len(rec), 100 + i, ident, 0)
    state, _ = pipe.end_window(state)
    return pipe, state


def _leaves_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert a.tobytes() == b.tobytes(), f"leaf {i} differs"


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_fingerprints_are_equal(cut):
    assert checkpoint._fingerprint(PipelineConfig(**CUTS[cut])) == jckpt._fingerprint(
        JPipelineConfig(**CUTS[cut]))


def test_the_deployed_fingerprint_is_the_reference_agents():
    from retina_tpu.config import Config as JConfig
    from retina_tpu.engine import pipeline_config_from as jpipeline_config_from

    assert checkpoint._fingerprint(pipeline_config_from(Config())) == jckpt._fingerprint(
        jpipeline_config_from(JConfig()))


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_a_port_checkpoint_loads_in_the_reference(cut, tmp_path):
    _, state = _port_state(CUTS[cut])
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, state, PipelineConfig(**CUTS[cut]))
    jcfg = JPipelineConfig(**CUTS[cut])
    jstate, resumed = jckpt.load_state(path, JPipeline(jcfg), jcfg)
    assert resumed and os.path.exists(path) and not os.path.exists(path + ".bad")
    _leaves_equal([np.asarray(x) for x in jax.tree.flatten(jstate)[0]], state_to_numpy(state))


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_a_reference_checkpoint_loads_in_the_port(cut, tmp_path):
    """The reference steps its own state (the graft entry's step, jitted) and
    saves it; the port loads it bit for bit."""
    fn, args = __graft_entry__.entry()
    jcfg = JPipelineConfig(**CUTS[cut])
    jpipe = JPipeline(jcfg)
    args = (jpipe.init_state(),) + args[1:]
    jstate, _ = jax.jit(jpipe.step)(*args)
    path = str(tmp_path / "state.npz")
    jckpt.save_state(path, jstate, jcfg)
    pipe = TelemetryPipeline(PipelineConfig(**CUTS[cut]), device="cpu")
    state, resumed = checkpoint.load_state(path, pipe, PipelineConfig(**CUTS[cut]))
    assert resumed and not os.path.exists(path + ".bad")
    want = [np.asarray(x) for x in jax.tree.flatten(jstate)[0]]
    assert int(want[6][0]) > 0  # totals[0]: the reference stepped events
    _leaves_equal(state_to_numpy(state), want)


def _truncate(path, _state, _knobs):
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size // 2)


def _garbage(path, _state, _knobs):
    with open(path, "wb") as fh:
        fh.write(b"not a checkpoint at all" * 10)


def _other_fingerprint(path, state, knobs):
    other = dict(knobs, n_drop_reasons=8)
    checkpoint.save_state(path, state_to_numpy(state), PipelineConfig(**other))


def _leaf_shape(path, state, knobs):
    leaves = state_to_numpy(state)
    leaves[3] = leaves[3][:-1]
    checkpoint.save_state(path, leaves, PipelineConfig(**knobs))


def _missing(path, _state, _knobs):
    os.remove(path)


def _missing_leaf(path, state, knobs):
    checkpoint.save_state(path, state_to_numpy(state)[:-1], PipelineConfig(**knobs))


@pytest.mark.parametrize("damage", [_missing, _truncate, _garbage, _other_fingerprint,
                                    _leaf_shape, _missing_leaf],
                         ids=lambda f: f.__name__.strip("_"))
def test_quarantine_outcomes_equal_the_reference(damage, tmp_path):
    knobs = CUTS["graft_entry"]
    _, state = _port_state(knobs, steps=1)
    outcomes = []
    for side in ("port", "reference"):
        path = str(tmp_path / f"{side}.npz")
        checkpoint.save_state(path, state, PipelineConfig(**knobs))
        damage(path, state, knobs)
        if side == "port":
            pipe = TelemetryPipeline(PipelineConfig(**knobs), device="cpu")
            got, resumed = checkpoint.load_state(path, pipe, PipelineConfig(**knobs))
            zero = state_to_numpy(got)
        else:
            jcfg = JPipelineConfig(**knobs)
            got, resumed = jckpt.load_state(path, JPipeline(jcfg), jcfg)
            zero = [np.asarray(x) for x in jax.tree.flatten(got)[0]]
        assert not any(a.any() for a in zero), f"{side}: not a zero state"
        outcomes.append((resumed, os.path.exists(path), os.path.exists(path + ".bad")))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] is False


def test_engine_checkpoint_loads_in_the_reference_and_a_torn_one_quarantines(tmp_path):
    cfg = Config(batch_capacity=1 << 10, n_pods=64, cms_width=1 << 10, topk_slots=1 << 6,
                 hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 8,
                 identity_slots=1 << 8)
    eng = SketchEngine(cfg, device="cpu")
    eng.update_identities({pod_ip(i): i for i in range(1, 60)})
    rec = TrafficGen(n_flows=300, n_pods=60, seed=3).batch(700)
    eng.step_records(rec, now_s=100)
    path = str(tmp_path / "sketch_state.npz")
    eng.save_snapshot_state(path)
    jcfg = JPipelineConfig(**dataclasses.asdict(eng.pcfg))
    jstate, resumed = jckpt.load_state(path, JPipeline(jcfg), jcfg)
    assert resumed
    _leaves_equal([np.asarray(x) for x in jax.tree.flatten(jstate)[0]],
                  state_to_numpy(eng.state))
    assert int(to_numpy(eng.state.totals)[0]) == 700
    # A second engine resumes it; a torn write is quarantined.
    eng2 = SketchEngine(cfg, device="cpu")
    assert eng2.load_snapshot_state(path) is True
    _leaves_equal(state_to_numpy(eng2.state), state_to_numpy(eng.state))
    faults.configure("checkpoint:corrupt@1")
    eng.save_snapshot_state(path)
    faults.clear()
    eng3 = SketchEngine(cfg, device="cpu")
    assert eng3.load_snapshot_state(path) is False
    assert not os.path.exists(path) and os.path.exists(path + ".bad")
    assert not any(a.any() for a in state_to_numpy(eng3.state))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp.npz")]
