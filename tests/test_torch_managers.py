"""The port's managers, watchers, identity cache and the metrics module's bus
handlers against the reference's.

The plugin manager's lifecycle, reconcile-failure count, restart in place,
open circuit, fatal unknown plugin, conntrack gating and engine wiring run
on both packages' mock plugin (``impl``). The watchers publish onto a
recording bus, so the two packages' event sequences compare exactly; the
cache and the metrics module's pod and namespace handlers take the same
update sequence on both sides.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from types import SimpleNamespace

import pytest

import retina_tpu.common as rcommon
import retina_tpu.controllers.cache as rcache
import retina_tpu.managers.filtermanager as rfm
import retina_tpu.managers.pluginmanager as rpm
import retina_tpu.managers.watchermanager as rwm
import retina_tpu.module.metrics_module as rmm
import retina_tpu.watchers.apiserver as rapi
import retina_tpu.watchers.endpoint as rend
import retina_tpu_torch.common as pcommon
import retina_tpu_torch.controllers.cache as pcache
import retina_tpu_torch.managers.filtermanager as pfm
import retina_tpu_torch.managers.pluginmanager as ppm
import retina_tpu_torch.managers.watchermanager as pwm
import retina_tpu_torch.module.metrics_module as pmm
import retina_tpu_torch.watchers.apiserver as papi
import retina_tpu_torch.watchers.endpoint as pend
from retina_tpu import metrics as rmetrics
from retina_tpu.config import Config as RConfig
from retina_tpu.plugins.mockplugin import MockPlugin as RMock
from retina_tpu.runtime import faults as rfaults
from retina_tpu_torch import exporter as pexporter
from retina_tpu_torch import metrics as pmetrics
from retina_tpu_torch.config import Config as PConfig
from retina_tpu_torch.plugins.mockplugin import MockPlugin as PMock
from retina_tpu_torch.pubsub import PubSub
from retina_tpu_torch.runtime import faults as pfaults

REF = SimpleNamespace(
    name="ref", Config=RConfig, PluginManager=rpm.PluginManager, Mock=RMock, faults=rfaults,
    metrics=rmetrics.get_metrics, val=lambda c: c._value.get(), WatcherManager=rwm.WatcherManager)
PORT = SimpleNamespace(
    name="port", Config=PConfig, PluginManager=ppm.PluginManager, Mock=PMock, faults=pfaults,
    metrics=pmetrics.get_metrics, val=lambda c: c._value, WatcherManager=pwm.WatcherManager)


@pytest.fixture(params=[REF, PORT], ids=lambda x: x.name)
def impl(request):
    pexporter.reset_for_tests()
    pmetrics.reset_for_tests()
    yield request.param
    RMock.fail_stage = PMock.fail_stage = None
    rfaults.clear()
    pfaults.clear()


def wait_for(pred, bound: float = 5.0) -> bool:
    deadline = time.monotonic() + bound
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# --------------------------------------------------------- plugin manager
def test_pluginmanager_lifecycle(impl):
    pm = impl.PluginManager(impl.Config(enabled_plugins=["mock"]))
    stop = threading.Event()
    pm.start(stop)
    p = pm.plugins["mock"]
    assert p.started.wait(5.0)
    assert p.calls[:4] == ["generate", "compile", "stop", "init"]
    stop.set()
    pm.stop()
    assert not pm.failed


def test_pluginmanager_reconcile_failure_counts(impl):
    impl.Mock.fail_stage = "compile"
    pm = impl.PluginManager(impl.Config(enabled_plugins=["mock"]))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="mock failure at compile"):
            pm.reconcile("mock")
    assert impl.val(impl.metrics().plugin_reconcile_failures.labels(plugin="mock")) == 2


def test_pluginmanager_crash_restarts_in_place(impl):
    impl.faults.configure("plugin.mock:raise@1")
    pm = impl.PluginManager(impl.Config(enabled_plugins=["mock"], restart_backoff_base_s=0.01,
                                        restart_backoff_jitter=0.0))
    stop = threading.Event()
    pm.start(stop)
    p = pm.plugins["mock"]
    assert p.started.wait(5.0)  # restarted after the injected crash
    assert not stop.is_set() and not pm.failed
    assert impl.val(impl.metrics().plugin_restarts.labels(plugin="mock")) == 1
    assert [n for n, _ in pm.errors] == ["mock"]
    # the restart tore the plugin down and re-initialized it
    assert p.calls[:6] == ["generate", "compile", "stop", "init", "stop", "init"]
    stop.set()
    pm.stop()


def test_pluginmanager_crash_loop_opens_circuit(impl):
    impl.Mock.fail_stage = "start"
    pm = impl.PluginManager(impl.Config(enabled_plugins=["mock"], restart_backoff_base_s=0.01,
                                        restart_backoff_jitter=0.0, restart_max_failures=3))
    stop = threading.Event()
    pm.start(stop)
    assert wait_for(lambda: pm.failed)
    assert not stop.is_set()  # crash-only: no in-process teardown
    st = pm.supervision_stats()["mock"]
    assert st["state"] == "open" and st["consecutive_failures"] == 3
    assert impl.val(impl.metrics().plugin_restarts.labels(plugin="mock")) == 2
    stop.set()
    pm.stop()


def test_pluginmanager_unknown_plugin_is_fatal(impl):
    with pytest.raises(KeyError, match="doesnotexist"):
        impl.PluginManager(impl.Config(enabled_plugins=["doesnotexist"]))


@pytest.mark.parametrize("enabled,expect", [
    (["packetparser"], ["packetparser", "conntrack"]),
    (["packetparser", "conntrack"], ["packetparser", "conntrack"]),
    (["dropreason", "dns"], ["dropreason", "dns"]),
    ([], []),
])
def test_pluginmanager_conntrack_gating(impl, enabled, expect):
    pm = impl.PluginManager(impl.Config(enabled_plugins=list(enabled)))
    assert list(pm.plugins) == expect


def test_pluginmanager_wires_the_engine(impl):
    class Engine:
        def __init__(self):
            self.observers = []

        def add_observer(self, fn, name=""):
            self.observers.append((fn, name))

    class Sink:
        def write_records(self, records, plugin):
            return len(records)

    eng, sink = Engine(), Sink()
    pm = impl.PluginManager(impl.Config(enabled_plugins=["packetparser", "dns", "mock"]),
                            sink=sink, engine=eng)
    assert [n for _, n in eng.observers] == ["dns"]  # the shed stage's name
    assert pm.plugins["conntrack"].engine is eng
    assert all(p.sink is sink for p in pm.plugins.values())


def test_pluginmanager_supervision_stats_equal_the_reference():
    stats = []
    for x in (REF, PORT):
        x.Mock.fail_stage = "start"
        pm = x.PluginManager(x.Config(enabled_plugins=["mock"], restart_backoff_base_s=0.01,
                                      restart_backoff_jitter=0.0, restart_max_failures=2,
                                      circuit_half_open_s=60))
        stop = threading.Event()
        pm.start(stop)
        assert wait_for(lambda: pm.failed)
        stop.set()
        pm.stop()
        x.Mock.fail_stage = None
        s = pm.supervision_stats()["mock"]
        stats.append({k: s[k] for k in ("state", "consecutive_failures")})
    assert stats[0] == stats[1] == {"state": "open", "consecutive_failures": 2}


# -------------------------------------------------------------- watchers
class RecordingBus:
    """Records what a watcher or the cache publishes, in call order."""

    def __init__(self):
        self.events = []

    def publish(self, topic, msg):
        self.events.append((topic, msg))


def test_endpoint_watcher_publishes_the_reference_sequence(tmp_path):
    net = tmp_path / "class" / "net"
    net.mkdir(parents=True)
    buses = {"ref": RecordingBus(), "port": RecordingBus()}
    watchers = {"ref": rend.EndpointWatcher(buses["ref"], sys_root=str(tmp_path)),
                "port": pend.EndpointWatcher(buses["port"], sys_root=str(tmp_path))}
    steps = [("mk", "eth0"), ("mk", "lo"), ("mk", "veth1"), ("rm", "eth0"), None,
             ("mk", "vethz"), ("rm", "lo")]
    for step in steps:
        if step is not None:
            op, name = step
            (net / name).mkdir() if op == "mk" else (net / name).rmdir()
        for w in watchers.values():
            w.refresh()
    assert buses["port"].events == buses["ref"].events
    assert ("endpoints", ("deleted", "eth0")) in buses["port"].events
    missing = pend.EndpointWatcher(RecordingBus(), sys_root=str(tmp_path / "nope"))
    missing.refresh()  # an absent sysfs reads as no interfaces


def test_apiserver_watcher_publishes_the_reference_sequence():
    resolved = {"ips": ["192.168.1.2", "192.168.1.1"]}
    calls = {"n": 0}

    def resolver(host):
        calls["n"] += 1
        if resolved["ips"] is None:
            raise OSError("resolve failed")
        return list(resolved["ips"])

    out = {}
    for name, fm_mod, mod in (("ref", rfm, rapi), ("port", pfm, papi)):
        bus, applied, pushed = RecordingBus(), [], []
        fm = fm_mod.FilterManager(apply_fn=applied.append)
        w = mod.ApiServerWatcher(bus, host="apiserver.test", filtermanager=fm,
                                 on_ips=pushed.append, resolver=resolver)
        resolved["ips"] = ["192.168.1.2", "192.168.1.1"]
        w.refresh()
        w.refresh()  # unchanged: nothing published
        resolved["ips"] = ["192.168.1.2", "192.168.1.3"]
        w.refresh()
        resolved["ips"] = None  # resolution fails: the last set stands
        w.refresh()
        out[name] = (bus.events, applied, pushed, sorted(fm._refs))
    assert out["port"] == out["ref"]
    events, _, pushed, _ = out["port"]
    assert pushed[-1] == [0xC0A80102, 0xC0A80103]
    assert [e[0] for e in events] == ["apiserver", "apiserver"]


def test_watchermanager_isolates_watcher_errors(impl):
    class Boom:
        name = "boom"

        def refresh(self):
            raise RuntimeError("no")

    class Ok:
        name = "ok"

        def __init__(self):
            self.n = 0

        def refresh(self):
            self.n += 1

    ok = Ok()
    wm = impl.WatcherManager([Boom(), ok], interval_s=0.01)
    stop = threading.Event()
    wm.start(stop)
    assert ok.n >= 1  # the initial refresh ran before start returned
    assert wait_for(lambda: ok.n >= 3)
    stop.set()
    wm._thread.join(5.0)
    assert not wm._thread.is_alive()


# ------------------------------------------------------------------ cache
def _objs(common):
    E, S, N = common.RetinaEndpoint, common.RetinaSvc, common.RetinaNode
    return [
        ("ep", E(name="a", namespace="prod", ips=("10.0.0.1",))),
        ("ep", E(name="b", namespace="prod", ips=("10.0.0.2", "fd00::2"))),
        ("svc", S(name="db", namespace="prod", cluster_ip="10.96.0.10")),
        ("ep", E(name="a", namespace="prod", ips=("10.0.0.9",))),  # IP change
        ("node", N(name="n1", ip="172.16.0.1")),
        ("ns", ("prod", True)),
        ("ns", ("prod", True)),  # no change: nothing published
        ("del", "prod/b"),
        ("ep", E(name="c", namespace="dev", ips=("10.0.1.1",),
                 annotations=(("retina.sh", "observe"),))),
        ("delsvc", "prod/db"),
        ("ns", ("prod", False)),
        ("del", "prod/nope"),
    ]


def _apply(cache, objs):
    idx = []
    for kind, o in objs:
        if kind == "ep":
            idx.append(cache.update_endpoint(o))
        elif kind == "svc":
            cache.update_service(o)
        elif kind == "node":
            cache.update_node(o)
        elif kind == "ns":
            cache.set_annotated_namespace(*o)
        elif kind == "del":
            cache.delete_endpoint(o)
        else:
            cache.delete_service(o)
    return idx


def _plain(x):
    return dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x


def test_cache_events_and_indexes_equal_the_reference():
    out = {}
    for name, mod, common in (("ref", rcache, rcommon), ("port", pcache, pcommon)):
        bus, dirty = RecordingBus(), []
        c = mod.Cache(bus, max_pods=4)
        c.on_identity_change(lambda d=dirty: d.append(1))
        idx = _apply(c, _objs(common))
        events = [(t, ev, _plain(o)) for t, (ev, o) in bus.events]
        out[name] = dict(
            idx=idx, events=events, dirty=len(dirty), ip_index=c.ip_index_map(),
            by_ip={ip: _plain(c.get_obj_by_ip(ip)) for ip in
                   ("10.0.0.1", "10.0.0.9", "10.0.0.2", "10.96.0.10", "10.0.1.1")},
            by_index={i: _plain(c.endpoint_by_index(i)) for i in range(5)},
            in_ns={ns: [_plain(e) for e in c.endpoints_in_namespace(ns)] for ns in ("prod", "dev")},
            counts=(c.pod_count(), c.namespace_count("prod"), c.namespace_count("dev")),
            nodes=[_plain(n) for n in c.list_nodes()], annotated=c.annotated_namespaces(),
            labels={i: _plain(e) for i, e in c.index_label_map().items()},
        )
    assert out["port"] == out["ref"]
    assert out["port"]["idx"] == [1, 2, 1, 2] and out["port"]["dirty"] == 5


# ---------------------------------------------------- metrics module handlers
@pytest.mark.parametrize("annotations", [False, True])
def test_metrics_module_pod_and_namespace_handlers_equal_the_reference(annotations):
    out = {}
    for name, mod, cmod, fm_mod, common, cfg in (
            ("ref", rmm, rcache, rfm, rcommon, RConfig(enable_annotations=annotations)),
            ("port", pmm, pcache, pfm, pcommon, PConfig(enable_annotations=annotations))):
        if name == "port":
            pexporter.reset_for_tests()
        E = common.RetinaEndpoint
        applied = []
        fm = fm_mod.FilterManager(apply_fn=applied.append)
        cache = cmod.Cache(max_pods=16)
        mm = mod.MetricsModule(cfg, engine=None, cache=cache, filtermanager=fm)
        seq = [
            E(name="a", namespace="prod", ips=("10.0.0.1",)),
            E(name="b", namespace="dev", ips=("10.0.0.2",),
              annotations=(("retina.sh", "observe"),)),
            E(name="a", namespace="prod", ips=("10.0.0.5",)),  # IP change
            E(name="c", namespace="prod", ips=("10.0.0.3",)),
        ]
        for ep in seq:
            cache.update_endpoint(ep)
            mm._on_pod_event(("updated", ep))
        interest = [ep for ep in seq if mm._pod_of_interest(ep)]
        cache.set_annotated_namespace("prod", True)
        mm._on_namespace_event(("annotated", "prod"))
        after_ns = sorted(fm._refs)
        cache.delete_endpoint("prod/c")
        mm._on_pod_event(("deleted", seq[3]))
        mm._on_pod_event(("updated", E(name="x", namespace="prod", ips=("not-an-ip",))))
        out[name] = dict(applied=applied, refs=sorted(fm._refs), after_ns=after_ns,
                         interest=[e.key() for e in interest])
    assert out["port"] == out["ref"]
    assert (out["port"]["interest"] == ["prod/a", "dev/b", "prod/a", "prod/c"]) != annotations


def test_metrics_module_follows_the_bus():
    bus = PubSub()
    fm = pfm.FilterManager()
    cache = pcache.Cache(bus)
    pmm.MetricsModule(PConfig(), engine=None, cache=cache, filtermanager=fm, pubsub=bus)
    cache.update_endpoint(pcommon.RetinaEndpoint(name="p", namespace="d", ips=("10.1.2.3",)))
    assert wait_for(lambda: fm.has_ip(0x0A010203))
    cache.delete_endpoint("d/p")
    assert wait_for(lambda: not fm.has_ip(0x0A010203))
    bus.shutdown()
