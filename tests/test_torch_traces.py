"""The port's TracesModule and TracesConfiguration against the reference's.

The same record blocks (TrafficGen traffic with both directions, UDP rows,
drops, an EventBuilder block) go through both modules under the same
TracesConfiguration; the sampled events must be equal, field by field,
except the wall-clock ``ts`` each module stamps. The YAML form parses to
equal specs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from retina_tpu.crd.types import TracesConfiguration as RConf
from retina_tpu.crd.types import TracesSpec as RSpec
from retina_tpu.module.traces import TracesModule as RTraces
from retina_tpu_torch.crd.types import TracesConfiguration as PConf
from retina_tpu_torch.crd.types import TracesSpec as PSpec
from retina_tpu_torch.events.schema import (
    EV_DROP,
    OP_TO_NETWORK,
    PROTO_UDP,
    EventBuilder,
    F,
    pack_meta,
)
from retina_tpu_torch.events.synthetic import TrafficGen, pod_ip
from retina_tpu_torch.events.schema import u32_to_ip
from retina_tpu_torch.module.traces import MAX_EVENTS_PER_TARGET
from retina_tpu_torch.module.traces import TracesModule as PTraces

POD3 = u32_to_ip(pod_ip(3))
POD5 = u32_to_ip(pod_ip(5))

SPECS = {
    "by-ip": dict(trace_targets=[{"name": "pod3", "ips": [POD3]},
                                 {"name": "pod5", "ips": [POD5, "10.9.9.9"]}]),
    "by-port-proto": dict(trace_targets=[{"name": "dns", "ports": [53], "protocols": ["udp"]},
                                         {"name": "web", "ports": ["80", 443]},
                                         {"name": "tcp", "protocols": ["TCP", "sctp"]}]),
    "egress-only": dict(trace_targets=[{"name": "all"}], trace_points=["egress"]),
    "sampled": dict(trace_targets=[{"name": "all"}, {"name": "pod3", "ips": [POD3]}],
                    sampling_rate_per_mille=250),
    "invalid-target": dict(trace_targets=[{"name": "bad", "ips": ["not.an.ip"]},
                                          {"ports": [53]}], trace_points=["ingress", "nowhere"]),
    "empty": dict(),
}


def _blocks() -> list[tuple[np.ndarray, str]]:
    gen = TrafficGen(n_flows=300, n_pods=16, seed=11)
    rng = np.random.default_rng(11)
    out = []
    for i in range(4):
        rec = gen.batch(1500)
        egress = rng.random(len(rec)) < 0.4
        meta = rec[:, F.META]
        rec[:, F.META] = np.where(egress, (meta & ~np.uint32(0xF0)) | np.uint32(2 << 4), meta)
        udp = rng.random(len(rec)) < 0.3
        rec[udp, F.META] = (rec[udp, F.META] & np.uint32(0x00FFFFFF)) | np.uint32(PROTO_UDP << 24)
        rec[udp, F.PORTS] = (rec[udp, F.PORTS] & np.uint32(0xFFFF0000)) | np.uint32(53)
        out.append((rec, "packetparser" if i % 2 == 0 else "dropreason"))
    b = EventBuilder(64)
    for j in range(40):
        b.add(src_ip=pod_ip(3), dst_ip=pod_ip(5), src_port=1000 + j, dst_port=443,
              obs_point=OP_TO_NETWORK, bytes_=100 + j, packets=2, verdict=2,
              drop_reason=3, event_type=EV_DROP)
    out.append((np.concatenate([x.valid_rows() for x in b.drain()]), "drop"))
    return out


def _spec(cls_conf, cls_spec, kw):
    return cls_conf(spec=cls_spec(**{k: (list(v) if isinstance(v, list) else v)
                                     for k, v in kw.items()}))


def _strip(traces: dict) -> dict:
    return {n: [{k: v for k, v in e.items() if k != "ts"} for e in evs]
            for n, evs in traces.items()}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_traces_module_samples_the_reference_events(name):
    kw = SPECS[name]
    ref, port = RTraces(), PTraces()
    ref.reconcile(_spec(RConf, RSpec, kw))
    port.reconcile(_spec(PConf, PSpec, kw))
    for rec, plugin in _blocks():
        ref.observe(rec, plugin)
        port.observe(rec, plugin)
    r, p = ref.traces(limit=MAX_EVENTS_PER_TARGET), port.traces(limit=MAX_EVENTS_PER_TARGET)
    assert _strip(p) == _strip(r)
    assert port.stats() == ref.stats()
    if name not in ("empty", "invalid-target"):
        assert port.stats()["events_sampled"] > 0
    assert port.traces(target="nosuch") == {}


def test_reconcile_keeps_rings_as_the_reference():
    ref, port = RTraces(), PTraces()
    blocks = _blocks()
    for mod, conf, spec in ((ref, RConf, RSpec), (port, PConf, PSpec)):
        mod.reconcile(_spec(conf, spec, SPECS["by-ip"]))
        mod.observe(*blocks[0])
        mod.reconcile(_spec(conf, spec, dict(trace_targets=[{"name": "pod3", "ips": [POD3]},
                                                           {"name": "new"}])))
        mod.observe(*blocks[1])
    assert _strip(port.traces(limit=10**6)) == _strip(ref.traces(limit=10**6))
    assert dataclasses.asdict(port.active_spec()) == dataclasses.asdict(ref.active_spec())


def test_attach_registers_an_engine_observer():
    class Engine:
        observers = []

        def add_observer(self, fn, name=""):
            self.observers.append(fn)

    eng, mod = Engine(), PTraces()
    mod.attach(eng)
    assert eng.observers == [mod.observe]


@pytest.mark.parametrize("doc", [
    """
metadata: {name: t1, namespace: kube-system}
spec:
  traceTargets:
    - {name: a, ips: [10.0.0.1], ports: [53], protocols: [udp]}
  tracePoints: [egress]
  samplingRatePerMille: 100
""",
    """
metadata: {name: t2}
spec:
  traceTargets:
  trace_points: [ingress]
""",
    "",
])
def test_traces_configuration_from_yaml_equals_the_reference(doc):
    assert dataclasses.asdict(PConf.from_yaml(doc)) == dataclasses.asdict(RConf.from_yaml(doc))


def test_pack_helpers_equal_the_reference():
    from retina_tpu.events import schema as rs
    from retina_tpu_torch.events import schema as ps

    for args in [(6, 0x12, 2, 1, 1), (17, 0, 3, 2, 0), (0xFFF, 0xFFF, 0xFFF, 0xFF, 0xFF)]:
        assert ps.pack_meta(*args) == rs.pack_meta(*args)
    assert ps.pack_ports(0x1FFFF, 53) == rs.pack_ports(0x1FFFF, 53)
    for op in range(5):
        assert ps.obs_point_to_direction(op) == rs.obs_point_to_direction(op)
    assert pack_meta(6) == rs.pack_meta(6)
    pb, rb = ps.EventBuilder(3), rs.EventBuilder(3)
    for i in range(7):
        kw = dict(ts_ns=(1 << 40) + i, src_ip=i, dst_ip=2 * i, src_port=i, dst_port=80,
                  obs_point=i % 4, bytes_=10 * i, dns=i, event_type=i % 5, ifindex=i)
        pb.add(**kw)
        rb.add(**kw)
    pd, rd = list(pb.drain()), list(rb.drain())
    assert [b.n_valid for b in pd] == [b.n_valid for b in rd] == [3, 3, 1]
    for x, y in zip(pd, rd):
        np.testing.assert_array_equal(x.records, y.records)
        assert x.capacity == y.capacity
