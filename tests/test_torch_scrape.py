"""The scrape surface against the reference on the CPU: the exporter's text
exposition, the metrics module's publication, the HTTP server's routes and
the ``/timetravel/query`` route.

- The exporter: one sequence of gauge, counter and histogram calls (label
  escapes, +Inf, large floats, a ``reset_advanced``) on the reference's
  ``Exporter`` (prometheus_client) and the port's gives byte-identical
  ``gather_text``, once the ``_created`` samples' values (wall-clock times)
  are masked.
- Publication: ``MetricsModule.publish_once`` of each side over equal
  snapshots built from one numpy state (counters past 2^31, a namespace
  exclusion, the labels shed under SHEDDING) gives equal expositions.
- The server: ``/metrics``, ``/healthz``, ``/readyz``, ``/version``,
  ``/debug/vars`` and an unknown route answer with the reference's codes,
  content types and bodies.
- The query route: the codes and documents of a 400, a 404, an empty ring, a
  hit, a ``stale`` reply under SHEDDING and a 503 ``busy`` are the
  reference's; the documents' float answers within rtol 1e-5.
- The control-plane pieces: the identity cache's dense pod indices, the
  publish/subscribe bus and the filter manager's refcounted pushes follow
  the reference's for one sequence of calls.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from retina_tpu.common import RetinaEndpoint as JEndpoint
from retina_tpu.config import Config as JConfig
from retina_tpu.controllers.cache import Cache as JCache
from retina_tpu.crd.types import MetricsConfiguration as JMetricsConfiguration
from retina_tpu.exporter import Exporter as JExporter
from retina_tpu.managers.filtermanager import FilterManager as JFilterManager
from retina_tpu import metrics as ref_metrics
from retina_tpu.metrics import initialize_metrics as j_initialize_metrics
from retina_tpu.metrics import reset_for_tests as j_reset_metrics
from retina_tpu.module.metrics_module import MetricsModule as JMetricsModule
from retina_tpu.pubsub import PubSub as JPubSub
from retina_tpu.server import Server as JServer
from retina_tpu.timetravel.query import QueryService as JQueryService
from retina_tpu.timetravel.ring import SnapshotRing as JSnapshotRing
from retina_tpu_torch.common import RetinaEndpoint
from retina_tpu_torch.config import Config
from retina_tpu_torch.controllers.cache import Cache
from retina_tpu_torch.crd.types import MetricsConfiguration
from retina_tpu_torch import metrics as port_metrics
from retina_tpu_torch.exporter import Exporter
from retina_tpu_torch.managers.filtermanager import FilterManager
from retina_tpu_torch.metrics import Metrics, initialize_metrics, reset_for_tests
from retina_tpu_torch.module.metrics_module import MetricsModule
from retina_tpu_torch.pubsub import PubSub
from retina_tpu_torch.runtime.overload import NOMINAL, SHEDDING
from retina_tpu_torch.server import Server
from retina_tpu_torch.timetravel.query import QueryService
from retina_tpu_torch.timetravel.ring import SnapshotRing
from retina_tpu_torch.u32 import from_numpy
from test_torch_timetravel import _doc_equal, window_slots


def mask_created(text: bytes) -> str:
    """The exposition with every ``*_created`` sample's value replaced."""
    out = []
    for line in text.decode().splitlines():
        if not line.startswith("#") and re.split(r"[{ ]", line, maxsplit=1)[0].endswith(
                "_created"):
            line = line.rsplit(" ", 1)[0] + " <created>"
        out.append(line)
    return "\n".join(out)


def drive_exporter(ex) -> bytes:
    g = ex.new_gauge("t_gauge", ["pod", "ns"])
    g.labels(pod='p"1\\x\ny', ns="default").set(2 ** 40)
    g.labels("p2", "kube").set(float("inf"))
    g.labels("p3", "kube").set(1e20)
    g.labels("p4", "kube").set(-3.5)
    g.labels("p5", "kube").set(12345678)
    g.labels("p6", "kube").set(0.1)
    g.labels("p7", "kube").set(float("-inf"))
    g.labels("p7", "kube").inc(1)
    g.remove("p6", "kube")
    ex.new_gauge("t_plain", []).set(7)
    c = ex.new_counter("t_things_total", ["kind"])
    c.labels(kind="x").inc(3)
    c.labels(kind="y").inc()
    ex.new_counter("t_plain_counter", []).inc(2.5)
    h = ex.new_histogram("t_seconds", [], buckets=[1e-4, 1e-3, 0.1, 1.0])
    for v in (5e-5, 0.01, 0.5, 3.0, 1.0):
        h.observe(v)
    h2 = ex.new_histogram("t_stage_seconds", ["stage"], buckets=[1e-5, 3e-5, 1.0])
    h2.labels(stage="a").observe(2e-5)
    h2.labels(stage="b").observe(7.0)
    ex.new_gauge("t_empty_family", ["x"])
    cleared = ex.new_gauge("t_cleared", ["x"])
    cleared.labels(x="1").set(1)
    cleared.clear()
    ex.new_adv_gauge("t_adv", ["podname"]).labels(podname="p").set(3)
    ex.reset_advanced()
    ex.new_adv_gauge("t_adv", ["podname"]).labels(podname="q").set(4)
    ex.new_adv_counter("t_adv_counter", []).inc(1)
    ex.new_hubble_gauge("t_hubble", []).set(1)
    return ex.gather_text()


def test_exposition_is_byte_identical_to_the_reference():
    got, want = drive_exporter(Exporter()), drive_exporter(JExporter())
    assert mask_created(got) == mask_created(want)
    assert b"t_hubble" not in got and "+Inf" in got.decode()


def test_exporter_refuses_what_prometheus_client_refuses():
    ex = Exporter()
    g = ex.new_gauge("t_dup", ["a"])
    with pytest.raises(ValueError):
        ex.new_gauge("t_dup", [])
    with pytest.raises(ValueError):
        g.set(1)  # a labelled family has no value of its own
    with pytest.raises(ValueError):
        g.labels("1", "2")
    with pytest.raises(ValueError):
        ex.new_counter("t_neg", []).inc(-1)


def test_basic_metric_families_are_the_references():
    ex, jex = Exporter(), JExporter()
    Metrics(ex)
    from retina_tpu.metrics import Metrics as JMetrics

    JMetrics(jex)
    assert mask_created(ex.gather_text()) == mask_created(jex.gather_text())


# -- publication ------------------------------------------------------------------

P, R, Q, S = 64, 16, 16, 32
NAMESPACES = ("default", "prod", "kube-system")


def _endpoints(make):
    return [make(name=f"pod-{i}", namespace=NAMESPACES[i % 3], ips=(f"10.0.0.{i}",),
                 owner_refs=(("ReplicaSet", f"rs-{i % 5}"),) if i % 2 else ())
            for i in range(1, 48)]


def _state(rng: np.random.Generator) -> dict:
    """One scrape's snapshot as host numpy (u32 leaves uint32), with counters
    past 2^31 and the three candidate tables."""
    def sparse(shape, p=0.3, hi=1 << 32):
        return np.where(rng.random(shape) < p, rng.integers(1, hi, shape, dtype=np.uint64),
                        0).astype(np.uint32)

    svc_keys = rng.integers(0, 50, (1, S, 2)).astype(np.uint32)
    return {
        "pod_forward": sparse((P, 2, 2), 0.6),
        "pod_drop": sparse((P, R, 2), 0.05),
        "pod_tcpflags": sparse((P, 8), 0.3, 1 << 20),
        "pod_dns": sparse((P, Q, 2), 0.05, 1 << 20),
        "pod_retrans": sparse((P,), 0.5),
        "lat_hist": sparse((16,), 0.7, 1 << 20),
        "hll_src_per_pod": np.where(rng.random(P) < 0.5, rng.random(P) * 5000,
                                    rng.random(P)).astype(np.float32),
        "hll_flows": np.array([123456.789], np.float32),
        "flow_hh": {"keys": rng.integers(0, 1 << 32, (1, S, 4), dtype=np.uint64).astype(
            np.uint32), "counts": sparse((1, S), 0.8)},
        "svc_hh": {"keys": svc_keys, "counts": sparse((1, S), 0.8, 1 << 20)},
        "dns_hh": {"keys": rng.integers(0, 1 << 32, (1, S, 1), dtype=np.uint64).astype(
            np.uint32), "counts": sparse((1, S), 0.8, 1 << 20)},
        "active_conns": np.int32(5),
    }


def _tensors(snap: dict) -> dict:
    """The port engine's snapshot of the same state: CPU tensors, u32 leaves
    as int32 bit patterns."""
    return {k: _tensors(v) if isinstance(v, dict) else from_numpy(np.asarray(v), "cpu")
            for k, v in snap.items()}


class _Overload:
    def __init__(self):
        self.state = NOMINAL
        self.shed: list[str] = []

    def note_shed(self, stage: str, amount: int = 1) -> None:
        self.shed.append(stage)


class _Engine:
    """What publish_once reads of an engine."""

    def __init__(self, snap):
        self.snap = snap
        self.overload = _Overload()
        self.shedding: set[str] = set()

    def snapshot(self, max_age_s: float = 0.5):
        return self.snap

    def shed_active(self, stage: str) -> bool:
        return stage in self.shedding


def _module(port: bool, snap: dict):
    conf = (MetricsConfiguration if port else JMetricsConfiguration).default()
    conf.spec.namespaces.exclude = ["kube-system"]
    cache = (Cache if port else JCache)()
    for ep in _endpoints(RetinaEndpoint if port else JEndpoint):
        cache.update_endpoint(ep)
    ex = (Exporter if port else JExporter)()
    eng = _Engine(_tensors(snap) if port else snap)
    mod = (MetricsModule if port else JMetricsModule)(
        (Config if port else JConfig)(), eng, cache, exporter=ex,
        dns_resolver=lambda h: f"q{h}.example")
    mod.reconcile(conf)
    return mod, eng, ex


def test_publication_matches_reference():
    rng = np.random.default_rng(50)
    snap = _state(rng)
    assert (snap["pod_forward"] >= 1 << 31).any()
    (mod, eng, ex), (jmod, jeng, jex) = _module(True, snap), _module(False, snap)
    assert mod.enabled_metrics() == jmod.enabled_metrics()
    for shed in (False, True, False):
        eng.shedding = jeng.shedding = {"labels"} if shed else set()
        mod.publish_once()
        jmod.publish_once()
        got, want = mask_created(ex.gather_text()), mask_created(jex.gather_text())
        assert got == want
    assert eng.overload.shed == jeng.overload.shed == ["labels"]
    assert mod.publish_failures == 0
    text = ex.gather_text().decode()
    assert 'namespace="kube-system"' not in text and 'namespace="prod"' in text
    big = [line for line in text.splitlines()
           if line.startswith("networkobservability_adv_forward_count")
           and float(line.rsplit(" ", 1)[1]) >= 2 ** 31]
    assert big


def test_a_failed_publish_is_counted_and_skipped_as_in_the_reference():
    snap = _state(np.random.default_rng(51))
    (mod, _, ex), (jmod, _, jex) = _module(True, snap), _module(False, snap)

    def fail(snap, ctx):
        raise RuntimeError("publish failed")

    mod._metrics["dns"].publish = jmod._metrics["dns"].publish = fail
    mod.publish_once()
    jmod.publish_once()
    assert mod.publish_failures == 1
    text = mask_created(ex.gather_text())
    assert text == mask_created(jex.gather_text())
    assert "networkobservability_adv_forward_count{" in text
    assert "networkobservability_adv_dns_request_count{" not in text


# -- the control-plane pieces ------------------------------------------------------


def test_cache_pod_indices_match_reference():
    def run(port: bool) -> list:
        make = RetinaEndpoint if port else JEndpoint
        cache = (Cache if port else JCache)(max_pods=8)
        eps = _endpoints(make)[:10]
        out = [cache.update_endpoint(ep) for ep in eps]  # 7 indices, then 0
        cache.delete_endpoint(eps[2].key())
        cache.delete_endpoint(eps[4].key())
        cache.delete_endpoint("default/missing")
        out += [cache.update_endpoint(ep) for ep in _endpoints(make)[20:23]]  # recycled
        out.append(cache.update_endpoint(make(name="pod-1", namespace="prod",
                                              ips=("10.0.1.1",))))  # an upsert
        out += [cache.get_index(ep.key()) for ep in eps]
        out.append(cache.get_endpoint(eps[0].key()).ips)
        out.append(cache.get_endpoint(eps[2].key()))
        out.append(sorted((i, ep.key(), ep.ips) for i, ep in cache.index_label_map().items()))
        return out

    got = run(True)
    assert got == run(False)
    assert got[7:10] == [0, 0, 0] and sorted(got[10:13]) == [0, 3, 5]


def test_pubsub_matches_reference():
    def run(bus) -> list:
        seen: list = []
        lock = threading.Lock()

        def record(tag):
            def cb(msg):
                with lock:
                    seen.append((tag, msg))
            return cb

        def boom(msg):
            raise RuntimeError("subscriber failed")

        a = bus.subscribe("pods", record("a"))
        bus.subscribe("pods", boom)
        bus.subscribe("svcs", record("s"))
        bus.publish_sync("pods", ("added", 1))  # boom is isolated
        bus.unsubscribe("pods", a)
        bus.publish_sync("pods", ("added", 2))
        bus.publish("svcs", ("updated", 3))
        try:
            bus.unsubscribe("pods", a)
        except KeyError:
            seen.append("KeyError")
        has = (bus.has_subscribers("pods"), bus.has_subscribers("svcs"),
               bus.has_subscribers("nodes"))
        bus.shutdown()  # waits for the pool's callbacks
        return [seen, has]

    got = run(PubSub())
    assert got == run(JPubSub())
    assert got == [[("a", ("added", 1)), ("s", ("updated", 3)), "KeyError"], (True, True, False)]


@pytest.fixture
def fresh_metrics():
    """Each side's metrics singleton on an exporter of its own for the test,
    the process's singletons put back after it (their families stay
    registered in the default registries, so a new one could not be made)."""
    saved = port_metrics._singleton, ref_metrics._singleton
    reset_for_tests()
    j_reset_metrics()
    ex, jex = Exporter(), JExporter()
    initialize_metrics(ex)
    j_initialize_metrics(jex)
    yield ex, jex
    port_metrics._singleton, ref_metrics._singleton = saved


def test_filtermanager_matches_reference(fresh_metrics):
    def run(make) -> list:
        pushes: list = []
        fm = make(apply_fn=lambda ips: pushes.append(sorted(ips)))
        fm.add_ips([1, 2], "a", "r1")
        fm.add_ips([2, 3], "b", "r2")
        fm.add_ips([1], "a", "r1")  # already held: no push
        fm.delete_ips([2], "a", "r1")  # still held by b: no push
        fm.delete_ips([2, 9], "b", "r2")
        with fm.deferred_push():
            with fm.deferred_push():
                fm.add_ips([4], "a", "r3")
                fm.add_ips([5], "a", "r3")
            fm.delete_ips([1], "a", "r1")
        with fm.deferred_push():  # nothing changed: no push
            fm.add_ips([3], "b", "r2")
        return [pushes, fm.has_ip(3), fm.has_ip(2), fm.ip_count()]

    got = run(FilterManager)
    assert got == run(JFilterManager)
    assert got == [[[1, 2], [1, 2, 3], [1, 3], [3, 4, 5]], True, False, 3]

    ex, jex = fresh_metrics
    tries = []

    def fail(ips):
        tries.append(len(ips))
        raise RuntimeError("device write failed")

    for make in (FilterManager, JFilterManager):
        t0 = time.perf_counter()
        make(apply_fn=fail, max_retries=2).add_ips([7], "a", "r")  # logged, not raised
        assert time.perf_counter() - t0 >= 0.05  # one backoff between the tries
    assert tries == [1, 1, 1, 1]

    def failures(text: bytes) -> list:
        return [line for line in mask_created(text).splitlines()
                if line.startswith("networkobservability_filter_push_failures")]

    assert failures(ex.gather_text()) == failures(jex.gather_text())
    assert failures(ex.gather_text())[0] == (
        "networkobservability_filter_push_failures_counter_total 1.0")


# -- the server --------------------------------------------------------------------


def _get(port: int, path: str) -> tuple[int, str, bytes]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.fixture
def servers():
    ex, jex = Exporter(), JExporter()
    drive_exporter(ex)
    drive_exporter(jex)
    srv = Server("127.0.0.1:0", exporter=ex, ready_check=lambda: False)
    jsrv = JServer("127.0.0.1:0", exporter=jex, ready_check=lambda: False)
    srv.start()
    jsrv.start()
    try:
        yield srv, jsrv
    finally:
        srv.stop()
        jsrv.stop()


def test_server_routes_match_reference(servers):
    srv, jsrv = servers
    for path in ("/metrics", "/metrics", "/healthz", "/readyz", "/version", "/debug/vars",
                 "/nope"):
        code, ctype, body = _get(srv.port, path)
        jcode, jctype, jbody = _get(jsrv.port, path)
        assert (code, ctype) == (jcode, jctype), path
        if path == "/metrics":
            assert mask_created(body) == mask_created(jbody)
        else:
            assert body == jbody, path
    assert _get(srv.port, "/readyz")[0] == 503 and _get(srv.port, "/nope")[0] == 404


def _query_pair(ttl: float = 1.0):
    jcfg, cfg = JConfig(timetravel_query_cache_ttl_s=ttl), Config(timetravel_query_cache_ttl_s=ttl)
    jov, ov = _Overload(), _Overload()
    ref, port = JQueryService(jcfg, overload=jov), QueryService(cfg, overload=ov, device="cpu")
    jring, ring = JSnapshotRing(4), SnapshotRing(4)
    ref.add_ring(jring)
    port.add_ring(ring)
    return (port, ring, ov), (ref, jring, jov)


def _ask(svc, q: dict) -> tuple[int, dict, str]:
    code, body, ctype = svc.handle({k: [str(v)] for k, v in q.items()})
    return code, json.loads(body), ctype


def _same(got: tuple, want: tuple) -> None:
    """Equal replies, a document's float answers within rtol 1e-5."""
    assert got[0] == want[0] and got[2] == want[2]
    _doc_equal(got[1], want[1])


def test_query_route_matches_reference():
    (port, ring, ov), (ref, jring, jov) = _query_pair(ttl=0.0)
    cases = [{"last": 2}, {"t0": 5}, {"t0": 7, "t1": 7}, {"ring": "fleet", "last": 1},
             {"t0": "x", "t1": 9}]
    for q in cases:  # the empty ring: 200 "empty" whatever the range, or 404
        _same(_ask(port, q), _ask(ref, q))
    assert _ask(port, {"t0": 5})[1]["empty"] and _ask(port, {"ring": "fleet"})[0] == 404
    for s in window_slots("invertible", n_windows=3):
        ring.append_host(*s)
        jring.append_host(*s)
    for q in cases:  # a hit and the parameter errors
        _same(_ask(port, q), _ask(ref, q))
    assert [_ask(port, q)[0] for q in cases] == [200, 400, 400, 404, 400]
    for q in ({"last": 1}, {"last": 8, "k": 4}, {"t0": 100, "t1": 102, "fam": "svc"},
              {"t0": 300, "t1": 400}):
        got = _ask(port, q)
        _same(got, _ask(ref, q))
        assert got[0] == 200
    # SHEDDING: a cached answer past its TTL serves, marked stale.
    ov.state = jov.state = SHEDDING
    got, want = _ask(port, {"last": 1}), _ask(ref, {"last": 1})
    assert got[1]["stale"] is want[1]["stale"] is True
    _same(got, want)
    ov.state = jov.state = NOMINAL
    # A fold in flight: a new range is busy, a cached one serves stale.
    held, release = threading.Event(), threading.Event()

    def hold():
        with port._flight, ref._flight:
            held.set()
            release.wait(30)

    th = threading.Thread(target=hold)
    th.start()
    held.wait(30)
    try:
        for q in ({"t0": 99, "t1": 101}, {"last": 1}):
            _same(_ask(port, q), _ask(ref, q))
        assert _ask(port, {"t0": 99, "t1": 101})[:2] == (503, {"error": "busy", "retry": True})
        assert _ask(port, {"last": 1})[1]["stale"] is True
    finally:
        release.set()
        th.join(30)


def test_query_route_is_served_by_the_server():
    (port, ring, _), _ = _query_pair()
    for s in window_slots("no_invertible", n_windows=2):
        ring.append_host(*s)
    ex = Exporter()
    srv = Server("127.0.0.1:0", exporter=ex, metrics_cache_ttl_s=0)
    port.attach(srv)
    srv.start()
    try:
        code, ctype, body = _get(srv.port, "/timetravel/query?last=2&k=3")
        doc = json.loads(body)
        assert code == 200 and ctype == "application/json" and doc["windows"] == 2
        assert doc == port._query(ring, 100, 102, 3, "flow")
        vars_doc = json.loads(_get(srv.port, "/debug/vars")[2])
        assert vars_doc["timetravel"]["engine"]["appended"] == 2
    finally:
        srv.stop()


def test_cache_keeps_at_most_128_keys_and_immutable_ranges_ignore_appends():
    (port, ring, _), _ = _query_pair(ttl=60.0)
    for s in window_slots("no_invertible", n_windows=2):
        ring.append_host(*s)
    for t0 in range(130):
        assert _ask(port, {"t0": t0, "t1": 200})[0] == 200
    assert len(port._cache) == 128
    # [100, 101) ends before the newest slot: its key ignores later appends.
    _ask(port, {"t0": 100, "t1": 101})
    queries = port.queries
    _, arrays, window_s, seeds = ring.select(101, 102)[0]
    ring.append_host(103, arrays, window_s, seeds)
    _ask(port, {"t0": 100, "t1": 101})
    assert port.queries == queries
