"""The port's agent with identity from a cluster (``daemon.py``'s kube
watchers and CRD bridge) on the CPU, against the reference's ``Daemon``
fed the same fake apiserver (``chip_smoke.FakeKube``): the identity cache,
the engine's identity map and the filter set after the LIST of 64 pods,
after WATCH events, a 410 and a dropped connection's resync; the filter
table pushed once a LIST by the port where the reference pushes it at each
listed pod, and once a WATCH event in both; a ``MetricsConfiguration`` CR
reconciled and its deletion returning the defaults; the in-cluster service
account over TLS; and CiliumEndpoints as the identity source.

The reference daemon is built with its own ``__init__`` but not started
(its engine's boot compiles JAX programs): its metrics module's default
reconcile, its watchers and its CRD bridge are started as its ``start``
starts them."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import struct
import threading
import time
import urllib.request

import pytest

from _torch_kube import (
    CEPS,
    NAMESPACES,
    NODES,
    PODS,
    SERVICES,
    cache_state,
    cep_doc,
    mod,
    node_doc,
    ns_doc,
    pod_doc,
    server_tls,
    stop_all,
    svc_doc,
    tls_chain,
    wait_for,
)
from chip_smoke import FakeKube
from retina_tpu_torch import exporter, metrics
from retina_tpu_torch.daemon import Daemon

SMALL = dict(batch_capacity=1 << 10, n_pods=1 << 8, cms_width=1 << 10, topk_slots=1 << 7,
             hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 10,
             identity_slots=1 << 10, flow_dict_slots=1 << 10, transfer_min_bucket=1 << 6,
             invertible_width=1 << 8, invertible_hi_width=1 << 6, window_seconds=0.5,
             metrics_interval_s=0.2, feed_workers=1, mesh_devices=1)
N_PODS = 64
METRICS = "/apis/retina.sh/v1alpha1/metricsconfigurations"
TRACES = "/apis/retina.sh/v1alpha1/tracesconfigurations"
ALL_METRICS = sorted(("forward", "drop", "tcpflags", "tcpretrans", "dns", "latency",
                      "distinct_sources", "flows", "services"))


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


def pod_addr(i: int) -> str:
    return f"10.1.{i >> 8}.{i & 0xFF}"


@pytest.fixture()
def empty_pcap(tmp_path):
    """A capture with no packets: the agents' own source stays quiet."""
    path = tmp_path / "empty.pcap"
    path.write_bytes(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))
    return str(path)


def agents(impls_kw: dict, pcap: str) -> dict:
    """The port's Daemon on the CPU and the reference's, each with
    ``impls_kw`` and its filter pushes counted ({impl: (daemon, pushes)})."""
    out = {}
    for impl in ("port", "reference"):
        cfg = mod(impl, "config").load_config(None, overrides=dict(
            SMALL, api_server_addr="127.0.0.1:0", event_source="pcap", pcap_path=pcap,
            pcap_loop=False, overload_enabled=False, device_platform="cpu", **impls_kw),
            env={})
        d = (Daemon if impl == "port" else mod(impl, "daemon").Daemon)(cfg)
        pushes = [0]
        fm = d.cm.filtermanager
        inner = fm._apply

        def apply(ips, inner=inner, pushes=pushes):
            pushes[0] += 1
            inner(ips)

        fm._apply = apply
        out[impl] = (d, pushes)
    return out


@contextlib.contextmanager
def started(pair: dict, kube: FakeKube):
    """Start the port's agent (on a thread, until ready) and the reference
    daemon's cluster parts, in its ``start``'s order."""
    port, ref = pair["port"][0], pair["reference"][0]
    stop = threading.Event()
    t = threading.Thread(target=port.start, args=(stop,), name="daemon", daemon=True)
    t.start()
    ref.metrics_module.reconcile(mod("reference", "crd.types").MetricsConfiguration.default())
    parts = [p for p in (ref.kubewatch, ref.ciliumwatch, ref.crd_bridge) if p is not None]
    for p in parts:
        p.start()
    try:
        wait_for(lambda: port.cm._ready.is_set() or not t.is_alive(), 120, "the port's ready")
        assert t.is_alive(), "the port's agent died while booting"
        yield port.cm.server.port
    finally:
        ours = [p for p in (port.kubewatch, port.ciliumwatch, port.crd_bridge) if p is not None]
        for p in ours:
            p._stop.set()
        stop_all(kube, parts)
        stop.set()
        t.join(60)
        assert not t.is_alive(), "the port's agent did not stop"


def settle(pair: dict, pred, what: str) -> dict:
    """Wait until each agent's identity map and filter set caught up with
    its cache, the caches and filter sets of both are equal and
    ``pred(state)`` holds; returns the port's cache state."""
    def ok() -> bool:
        states = []
        for d, _ in pair.values():
            s = cache_state(d.cm.cache)
            if d.cm.engine._ident_dict != s["ip_index_map"] or not pred(s):
                return False
            states.append((s, set(d.cm.filtermanager._refs)))
        return states[0] == states[1]

    wait_for(ok, 60, what)
    return cache_state(pair["port"][0].cm.cache)


def pushes_reach(pair: dict, port: int, ref: int, what: str) -> None:
    wait_for(lambda: pair["port"][1][0] >= port and pair["reference"][1][0] >= ref, 60, what)
    time.sleep(0.3)  # and no more come
    assert (pair["port"][1][0], pair["reference"][1][0]) == (port, ref), what


def seed(kube: FakeKube, pods: int = N_PODS) -> None:
    for i in range(1, pods + 1):
        kube.add(PODS, pod_doc(f"pod-{i}", pod_addr(i), ns="default" if i % 4 else "prod",
                               node=f"node-{i % 2}"), event=False)
    kube.add(PODS, pod_doc("hostnet-0", "10.9.0.1", host_network=True), event=False)
    for i in range(4):
        kube.add(SERVICES, svc_doc(f"svc-{i}", f"10.96.0.{i + 1}"), event=False)
    for i in range(2):
        kube.add(NODES, node_doc(f"node-{i}", f"192.168.0.{i + 1}", "z1"), event=False)


def scrape(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        return r.read().decode()


def test_agent_from_a_kubeconfig_equals_the_reference_daemon(tmp_path, empty_pcap):
    kube = FakeKube()
    try:
        seed(kube)
        pair = agents({"kubeconfig": kube.kubeconfig(tmp_path / "kc")}, empty_pcap)
        with started(pair, kube) as port:
            state = settle(pair, lambda s: len(s["endpoints"]) == N_PODS, "the LIST")
            assert state["indexes"] == {f"{'default' if i % 4 else 'prod'}/pod-{i}": i
                                        for i in range(1, N_PODS + 1)}
            assert set(pair["port"][0].cm.filtermanager._refs) == set(state["ip_index_map"])
            # One push for the LIST; the reference's one a listed pod.
            pushes_reach(pair, 1, N_PODS, "the LIST's pushes")

            # A WATCH event pushes once in both.
            kube.add(PODS, pod_doc("pod-new", pod_addr(200)))
            settle(pair, lambda s: "default/pod-new" in s["endpoints"], "the ADDED pod")
            pushes_reach(pair, 2, N_PODS + 1, "the ADDED pod's push")
            kube.delete(PODS, pod_doc("pod-1", pod_addr(1)))
            settle(pair, lambda s: "default/pod-1" not in s["endpoints"], "the DELETED pod")
            pushes_reach(pair, 3, N_PODS + 2, "the DELETED pod's push")
            kube.modify(PODS, pod_doc("pod-2", pod_addr(202)))
            settle(pair, lambda s: s["endpoints"]["default/pod-2"]["ips"] == (pod_addr(202),),
                   "the pod's new IP")
            pushes_reach(pair, 4, N_PODS + 3, "the new IP's push")
            kube.delete(SERVICES, svc_doc("svc-0", "10.96.0.1"))
            kube.bookmark(PODS)
            settle(pair, lambda s: "default/svc-0" not in s["services"], "the DELETED service")

            # A 410: a re-LIST that changes nothing pushes nothing.
            kube.wait(lambda: kube.open.get(PODS, 0) >= 2, 30, "both pod watches")
            kube.expire(PODS)
            kube.wait(lambda: kube.lists.get(PODS, 0) >= 4, 30, "both re-LISTs")
            settle(pair, lambda s: True, "the 410's re-LIST")
            pushes_reach(pair, 4, N_PODS + 3, "the 410's re-LIST")

            # A dropped connection: the re-LIST misses three pods.
            kube.wait(lambda: kube.open.get(PODS, 0) >= 2, 30, "both pod watches again")
            for i in (3, 5, 6):
                kube.forget(PODS, f"default/pod-{i}")
            kube.drop(PODS)
            state = settle(pair, lambda s: len(s["endpoints"]) == N_PODS - 3,
                           "the dropped connection's resync")
            pushes_reach(pair, 5, N_PODS + 6, "the resync's deletes")
            assert {"default/pod-3", "default/pod-5", "default/pod-6"}.isdisjoint(
                state["endpoints"])

            # The agents' CRD bridges reconcile a MetricsConfiguration.
            port_d, ref_d = pair["port"][0], pair["reference"][0]
            cr = {"apiVersion": "retina.sh/v1alpha1", "kind": "MetricsConfiguration",
                  "metadata": {"name": "fwd-drop", "namespace": "default"},
                  "spec": {"contextOptions": [
                      {"metricName": "forward", "sourceLabels": ["podname"]},
                      {"metricName": "drop", "sourceLabels": ["podname"]}],
                      "namespaces": {"exclude": ["kube-system"]}}}
            kube.add(METRICS, cr)
            wait_for(lambda: port_d.metrics_module.enabled_metrics()
                     == ref_d.metrics_module.enabled_metrics() == ["drop", "forward"], 30,
                     "the CR's reconcile")
            assert (dataclasses.asdict(port_d.metrics_module._spec)
                    == dataclasses.asdict(ref_d.metrics_module._spec))
            # The scrape serves its render cache's body until a re-render lands.
            wait_for(lambda: "networkobservability_adv_tcpflags_count" not in scrape(port), 30,
                     "a scrape without the families the CR left out")
            assert "# TYPE networkobservability_adv_forward_count gauge" in scrape(port)
            kube.delete(METRICS, cr)
            wait_for(lambda: port_d.metrics_module.enabled_metrics()
                     == ref_d.metrics_module.enabled_metrics() == ALL_METRICS, 30,
                     "the defaults after the CR's deletion")
            wait_for(lambda: "# TYPE networkobservability_adv_tcpflags_count gauge"
                     in scrape(port), 30, "a scrape with the defaults' families")
            kube.add(TRACES, {"metadata": {"name": "t", "namespace": "default"},
                              "spec": {"traceTargets": [{"name": "web", "ips": ["10.1.0.7"]}],
                                       "samplingRatePerMille": 10}})
            wait_for(lambda: port_d.traces_module.active_spec() is not None
                     and ref_d.traces_module.active_spec() is not None, 30,
                     "the TracesConfiguration's reconcile")
            assert (dataclasses.asdict(port_d.traces_module.active_spec())
                    == dataclasses.asdict(ref_d.traces_module.active_spec()))
            assert port_d.traces_module.stats()["targets"] == ["web"]
    finally:
        kube.close()


def test_in_cluster_agent_over_tls_equals_the_reference(tmp_path, monkeypatch, empty_pcap):
    """No kubeconfig and a mounted service account (token and CA): the
    agent watches the apiserver the environment names, over TLS."""
    chain = tls_chain(tmp_path / "tls")
    kube = FakeKube(tls=server_tls(chain, client_certs=False))
    try:
        seed(kube, pods=8)
        sa = tmp_path / "sa"
        sa.mkdir()
        (sa / "token").write_text("sa-token\n")
        (sa / "ca.crt").write_bytes(chain["ca.crt"].read_bytes())
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(kube.port))
        for impl in ("reference", "port"):
            kc = mod(impl, "operator.kubeclient")
            monkeypatch.setattr(kc.in_cluster_available, "__defaults__", (str(sa),))
            monkeypatch.setattr(kc.KubeClient.__init__, "__defaults__", ("", str(sa)))
        pair = agents({}, empty_pcap)
        assert pair["port"][0].kubewatch.client.server == f"https://127.0.0.1:{kube.port}"
        with started(pair, kube):
            settle(pair, lambda s: len(s["endpoints"]) == 8 and len(s["nodes"]) == 2,
                   "the in-cluster LIST")
            pushes_reach(pair, 1, 8, "the LIST's pushes")
        assert {r[2] for r in kube.requests} == {"Bearer sa-token"}
    finally:
        kube.close()


def test_cilium_identity_agent_equals_the_reference(tmp_path, empty_pcap, caplog):
    """identity_source="cilium": pods from CiliumEndpoints, services and
    nodes from core/v1; with enable_annotations the reference's warning,
    and the annotated namespace's pods in the filter set."""
    kube = FakeKube()
    try:
        seed(kube, pods=0)
        for i in range(1, 17):
            kube.add(CEPS, cep_doc(f"pod-{i}", pod_addr(i), ns="default" if i % 4 else "prod"),
                     event=False)
        kube.add(NAMESPACES, ns_doc("default"), event=False)
        kube.add(NAMESPACES, ns_doc("prod", observe=False), event=False)
        retina_log = logging.getLogger("retina")  # both packages' root; it does not propagate
        retina_log.addHandler(caplog.handler)
        try:
            pair = agents({"kubeconfig": kube.kubeconfig(tmp_path / "kc"),
                           "identity_source": "cilium", "enable_annotations": True}, empty_pcap)
        finally:
            retina_log.removeHandler(caplog.handler)
        warned = [r.name for r in caplog.records
                  if "per-pod observe annotations are invisible" in r.getMessage()]
        assert warned == ["retina.daemon", "retina.daemon"]
        assert not pair["port"][0].kubewatch.include_pods
        with started(pair, kube):
            state = settle(pair, lambda s: len(s["endpoints"]) == 16 and s["annotated"]
                           == ["default"] and len(pair["port"][0].cm.filtermanager._refs) == 12,
                           "the CiliumEndpoints' LIST")
            assert state["indexes"]["default/pod-1"] == 1
            assert state["endpoints"]["prod/pod-4"]["labels"] == (("app", "pod"),)
            kube.delete(CEPS, cep_doc("pod-1", pod_addr(1)))
            settle(pair, lambda s: "default/pod-1" not in s["endpoints"]
                   and len(pair["port"][0].cm.filtermanager._refs) == 11, "the DELETED CEP")
    finally:
        kube.close()


def test_wait_delivered_waits_for_every_callback_published_before_it():
    """The pod LIST scope's wait, under contention: 16 publisher threads,
    two subscribers whose callbacks yield, a short switch interval; each
    publisher's ``wait_delivered`` returns only once every callback it
    published has run, and the pending set empties."""
    import collections
    import sys

    from retina_tpu_torch.pubsub import PubSub

    bus = PubSub(max_workers=8)
    done: collections.Counter = collections.Counter()
    lock = threading.Lock()

    def cb(msg) -> None:
        time.sleep(0.0005)
        with lock:
            done[msg[0]] += 1

    bus.subscribe("t", cb)
    bus.subscribe("t", cb)
    failures = []

    def publisher(i: int) -> None:
        for j in range(50):
            bus.publish("t", (i, j))
        if not bus.wait_delivered("t", 30):
            failures.append((i, "timed out"))
        with lock:
            if done[i] != 100:
                failures.append((i, done[i]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=publisher, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert failures == [] and sum(done.values()) == 1600
    assert not bus._pending["t"]
    assert bus.wait_delivered("other", 0)  # nothing published: no wait
    bus.shutdown()
