"""The port's kube client and core/v1 identity watchers
(``retina_tpu_torch/operator/{kubeclient,kubewatch}.py``) against the
reference's: the same documents translate to equal endpoints, services and
nodes, and both packages' ``CoreWatcher``s, fed one fake apiserver
(``chip_smoke.FakeKube``), hold equal caches after the LIST, after each
WATCH event, after a bookmark's resume, a 410 and a dropped connection's
re-LIST and resync. Also the kubeconfig (tokens, contexts, TLS with a
client certificate), the in-cluster service account and the namespace
handler, each on both packages."""

from __future__ import annotations

import base64
import contextlib
import urllib.parse

import pytest
import yaml

from _torch_kube import (
    IMPLS,
    NAMESPACES,
    NODES,
    PODS,
    SERVICES,
    asdict,
    cache_state,
    mod,
    node_doc,
    ns_doc,
    pod_doc,
    server_tls,
    settle,
    stop_all,
    svc_doc,
    tls_chain,
)
from chip_smoke import FakeKube

# -- pure translations --------------------------------------------------------
POD_CASES = {
    "plain": pod_doc("web-0", "10.0.0.8"),
    "host-network": pod_doc("hostnet-0", "10.0.0.9", host_network=True),
    "no-ip": pod_doc("pending-0"),
    "pod-ips": pod_doc("dual-0", "10.0.0.7", ips=("10.0.0.7", "fd00::7")),
    "pod-ips-only": pod_doc("v6-0", ips=("fd00::8",)),
    "deleting": pod_doc("gone-0", "10.0.0.6", deleting=True),
    "annotated": pod_doc("obs-0", "10.0.0.5", annotations={"retina.sh": "observe"}),
    "bare": {"metadata": {"name": "bare"}},
    "nulls": {"metadata": {"name": "n", "namespace": "x", "labels": None,
                           "annotations": None, "ownerReferences": None},
              "spec": None, "status": {"podIP": "10.0.0.4", "podIPs": None}},
}
SVC_CASES = {
    "cluster-ip": svc_doc("api", "10.96.0.5"),
    "headless": svc_doc("h", "None"),
    "no-cluster-ip": {"metadata": {"name": "x", "namespace": "d"}, "spec": {}},
    "load-balancer": svc_doc("lb", "10.96.0.6", lb_ip="4.4.4.4"),
    "nulls": {"metadata": {"name": "n"}, "spec": None, "status": {"loadBalancer": None}},
}
NODE_CASES = {
    "internal-ip-zone": node_doc("node-a", "192.168.1.10", "z1"),
    "hostname-only": node_doc("node-b"),
    "nulls": {"metadata": {"name": "n", "labels": None}, "status": None},
}


@pytest.mark.parametrize("case", POD_CASES)
def test_pod_to_endpoint_equals_the_reference(case):
    doc = POD_CASES[case]
    ref, port = (mod(i, "operator.kubewatch").pod_to_endpoint(doc) for i in IMPLS)
    assert asdict(port) == asdict(ref)
    assert (port is None) == (case in ("host-network", "no-ip", "bare"))
    if case == "plain":
        assert port.key() == "default/web-0" and port.workload() == "web-rs"
        assert port.containers == ("main", "sidecar") and port.node == "node-a"
    if case == "pod-ips":
        assert port.ips == ("10.0.0.7", "fd00::7")


@pytest.mark.parametrize("case", SVC_CASES)
def test_service_to_svc_equals_the_reference(case):
    doc = SVC_CASES[case]
    ref, port = (mod(i, "operator.kubewatch").service_to_svc(doc) for i in IMPLS)
    assert asdict(port) == asdict(ref)
    if case == "headless":
        assert port.cluster_ip == ""
    if case == "load-balancer":
        assert port.lb_ip == "4.4.4.4"


@pytest.mark.parametrize("case", NODE_CASES)
def test_node_to_node_equals_the_reference(case):
    doc = NODE_CASES[case]
    ref, port = (mod(i, "operator.kubewatch").node_to_node(doc) for i in IMPLS)
    assert asdict(port) == asdict(ref)
    if case == "internal-ip-zone":
        assert (port.ip, port.zone) == ("192.168.1.10", "z1")


# -- both packages' watchers on one fake apiserver ------------------------------
def seed(kube: FakeKube) -> None:
    """The cluster every scenario LISTs first (no events)."""
    for doc in (pod_doc("web-0", "10.0.1.1"), pod_doc("web-1", "10.0.1.2"),
                pod_doc("hostnet-0", "10.0.1.9", host_network=True), pod_doc("pending-0"),
                pod_doc("dual-0", "10.0.1.3", ips=("10.0.1.3", "fd00::3")),
                pod_doc("gone-0", "10.0.1.4", deleting=True),
                pod_doc("db-0", "10.0.2.1", ns="prod")):
        kube.add(PODS, doc, event=False)
    for doc in (svc_doc("api", "10.96.0.1"), svc_doc("headless", "None"),
                svc_doc("lb", "10.96.0.3", ns="prod", lb_ip="4.4.4.4")):
        kube.add(SERVICES, doc, event=False)
    kube.add(NODES, node_doc("node-a", "192.168.1.10", "z1"), event=False)
    kube.add(NODES, node_doc("node-b"), event=False)
    kube.add(NAMESPACES, ns_doc("prod"), event=False)
    kube.add(NAMESPACES, ns_doc("dev", observe=False), event=False)


@pytest.fixture()
def kube(tmp_path):
    k = FakeKube()
    seed(k)
    k.kc = k.kubeconfig(tmp_path / "kubeconfig", token="sekrit")
    yield k
    k.close()


@contextlib.contextmanager
def both_watchers(kube: FakeKube):
    """A reference and a port CoreWatcher (pods, services, nodes and
    namespaces) over their own caches; yields {impl: cache} once both
    LISTs landed."""
    caches = {i: mod(i, "controllers.cache").Cache() for i in IMPLS}
    watchers = {i: mod(i, "operator.kubewatch").CoreWatcher(
        caches[i], kube.kc, retry_s=0.1, include_namespaces=True) for i in IMPLS}
    for w in watchers.values():
        w.start()
    try:
        settle(caches, lambda s: len(s["endpoints"]) == 4 and len(s["nodes"]) == 2
               and len(s["services"]) == 3 and s["annotated"] == ["prod"], "the LISTs")
        yield caches
    finally:
        stop_all(kube, watchers.values())


def test_core_watchers_after_the_list_equal_the_reference(kube):
    with both_watchers(kube) as caches:
        state = cache_state(caches["port"])
        assert state == cache_state(caches["reference"])
        # LIST order assigns the dense indexes; host-network, IP-less and
        # deleting pods never enter the cache.
        assert state["indexes"] == {"default/web-0": 1, "default/web-1": 2,
                                    "default/dual-0": 3, "prod/db-0": 4}
        assert state["ip_index_map"] == {0x0A000101: 1, 0x0A000102: 2, 0x0A000103: 3,
                                         0x0A000201: 4}
        assert state["services"]["default/headless"]["cluster_ip"] == ""
        assert caches["port"].get_obj_by_ip("10.96.0.3").name == "lb"
        # The kubeconfig's token rode every request.
        assert {r[2] for r in kube.requests} == {"Bearer sekrit"}


WATCH_SCRIPT = [
    ("pod added", lambda k: k.add(PODS, pod_doc("web-2", "10.0.1.5")),
     lambda s: "default/web-2" in s["endpoints"]),
    ("pod deleted", lambda k: k.delete(PODS, pod_doc("web-0", "10.0.1.1")),
     lambda s: "default/web-0" not in s["endpoints"]),
    ("pod ip changed", lambda k: k.modify(PODS, pod_doc("web-1", "10.0.1.22")),
     lambda s: s["endpoints"].get("default/web-1", {}).get("ips") == ("10.0.1.22",)),
    ("pod terminating", lambda k: k.modify(PODS, pod_doc("dual-0", "10.0.1.3", deleting=True)),
     lambda s: "default/dual-0" not in s["endpoints"]),
    ("host-network pod, then a pod", lambda k: (
        k.add(PODS, pod_doc("hostnet-1", "10.0.1.8", host_network=True)),
        k.add(PODS, pod_doc("web-3", "10.0.1.6"))),
     lambda s: "default/web-3" in s["endpoints"]),
    ("service deleted", lambda k: k.delete(SERVICES, svc_doc("api", "10.96.0.1")),
     lambda s: "default/api" not in s["services"]),
    ("node addressed", lambda k: k.modify(NODES, node_doc("node-b", "192.168.1.11")),
     lambda s: {"name": "node-b", "ip": "192.168.1.11", "zone": ""} in s["nodes"]),
    ("namespace unannotated", lambda k: k.modify(NAMESPACES, ns_doc("prod", observe=False)),
     lambda s: s["annotated"] == []),
    ("namespace annotated", lambda k: k.modify(NAMESPACES, ns_doc("dev")),
     lambda s: s["annotated"] == ["dev"]),
]


@pytest.mark.parametrize("last", range(len(WATCH_SCRIPT)),
                         ids=[s[0].replace(" ", "-") for s in WATCH_SCRIPT])
def test_core_watchers_after_each_watch_event_equal_the_reference(kube, last):
    with both_watchers(kube) as caches:
        for what, act, pred in WATCH_SCRIPT[:last + 1]:
            act(kube)
            settle(caches, pred, what)
        if last == len(WATCH_SCRIPT) - 1:
            state = cache_state(caches["port"])
            # Freed indexes are taken last in, first out: web-3 took dual-0's.
            assert state["indexes"] == {"default/web-1": 2, "default/web-2": 5,
                                        "default/web-3": 3, "prod/db-0": 4}
        # WATCH events need no LIST: one a watcher and resource.
        assert kube.lists[PODS] == 2


def watch_queries(kube: FakeKube, resource: str) -> list[dict]:
    return [urllib.parse.parse_qs(urllib.parse.urlsplit(p).query)
            for m, p, _ in kube.requests if m == "GET" and "watch=true" in p
            and urllib.parse.urlsplit(p).path == resource]


def test_watchers_resume_from_a_bookmark_without_a_list(kube):
    with both_watchers(kube) as caches:
        kube.wait(lambda: kube.watches.get(PODS, 0) >= 2, 10, "both pod watches")
        kube.bookmark(PODS)
        rv = str(kube.rv)
        kube.end(PODS)  # a clean close, as at timeoutSeconds
        kube.wait(lambda: kube.watches.get(PODS, 0) >= 4, 10, "both re-WATCHes")
        resumed = watch_queries(kube, PODS)[2:]
        assert [q["resourceVersion"] for q in resumed] == [[rv], [rv]]
        assert kube.lists[PODS] == 2  # no re-LIST
        kube.add(PODS, pod_doc("web-9", "10.0.1.99"))
        settle(caches, lambda s: "default/web-9" in s["endpoints"], "the event after resume")


def test_410_relists_and_the_caches_stay_equal(kube):
    with both_watchers(kube) as caches:
        kube.wait(lambda: kube.watches.get(PODS, 0) >= 2, 10, "both pod watches")
        # Changes the watch never delivered: a missed add and a missed delete.
        kube.add(PODS, pod_doc("late-0", "10.0.1.40"), event=False)
        kube.forget(PODS, "default/web-1")
        kube.expire(PODS)
        kube.wait(lambda: kube.lists.get(PODS, 0) >= 4, 10, "both re-LISTs")
        state = settle(caches, lambda s: "default/late-0" in s["endpoints"]
                       and "default/web-1" not in s["endpoints"], "the re-LIST's resync")
        # The re-LIST's adds come before its resync deletes.
        assert state["indexes"]["default/late-0"] == 5


def test_dropped_connection_relists_and_resyncs(kube):
    with both_watchers(kube) as caches:
        for res in (PODS, SERVICES):
            kube.wait(lambda r=res: kube.watches.get(r, 0) >= 2, 10, f"both {res} watches")
        kube.forget(PODS, "prod/db-0")
        kube.forget(SERVICES, "prod/lb")
        kube.drop(PODS)
        kube.drop(SERVICES)
        kube.wait(lambda: kube.lists.get(PODS, 0) >= 4 and kube.lists.get(SERVICES, 0) >= 4,
                  10, "both re-LISTs")
        state = settle(caches, lambda s: "prod/db-0" not in s["endpoints"]
                       and "prod/lb" not in s["services"], "the resync deletes")
        assert caches["port"].get_obj_by_ip("10.96.0.3") is None
        assert sorted(state["endpoints"]) == ["default/dual-0", "default/web-0",
                                              "default/web-1"]


# -- the handlers alone ----------------------------------------------------------
def offline_kubeconfig(tmp_path) -> str:
    kc = tmp_path / "kc"
    kc.write_text(yaml.safe_dump({"clusters": [{"name": "c", "cluster": {
        "server": "http://127.0.0.1:1"}}], "contexts": [], "users": []}))
    return str(kc)


@pytest.mark.parametrize("impl", IMPLS)
def test_resync_deletes_stale_objects(impl, tmp_path):
    """Informer resync semantics: a re-LIST's resync deletes cache entries
    the apiserver no longer has."""
    kw = mod(impl, "operator.kubewatch")
    cache = mod(impl, "controllers.cache").Cache()
    w = kw.CoreWatcher(cache, offline_kubeconfig(tmp_path))
    cache.update_endpoint(kw.pod_to_endpoint(pod_doc("old", "10.0.0.1")))
    cache.update_endpoint(kw.pod_to_endpoint(pod_doc("kept", "10.0.0.2")))
    w._sync_pods([{"namespace": "default", "name": "kept"}])
    assert cache.list_endpoint_keys() == ["default/kept"]
    cache.update_service(kw.service_to_svc(svc_doc("gone", "10.96.0.9")))
    w._sync_services([])
    assert cache.get_obj_by_ip("10.96.0.9") is None and cache.list_service_keys() == []


@pytest.mark.parametrize("impl", IMPLS)
def test_namespace_handler_sets_the_cache(impl, tmp_path):
    cache = mod(impl, "controllers.cache").Cache()
    w = mod(impl, "operator.kubewatch").CoreWatcher(cache, offline_kubeconfig(tmp_path),
                                                     include_namespaces=True)
    w._on_namespace("ADDED", ns_doc("prod"))
    assert cache.annotated_namespaces() == {"prod"}
    w._on_namespace("MODIFIED", ns_doc("prod", observe=False))
    assert cache.annotated_namespaces() == set()
    w._on_namespace("MODIFIED", ns_doc("prod", deleting=True))
    assert cache.annotated_namespaces() == set()
    w._on_namespace("ADDED", ns_doc("stale"))
    w._on_namespace("ADDED", ns_doc("kept"))
    w._on_namespace("ADDED", {"metadata": {}})  # no name: ignored
    w._sync_namespaces([{"name": "kept", "annotations": {"retina.sh": "observe"}}])
    assert cache.annotated_namespaces() == {"kept"}


# -- the client's configuration ---------------------------------------------------
def test_in_cluster_config_equals_the_reference(tmp_path, monkeypatch):
    """kubeconfig "" and a mounted service account: in-cluster config."""
    sa = tmp_path / "sa"
    sa.mkdir()
    (sa / "token").write_text("sa-token\n")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.96.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    clients = {}
    for impl in IMPLS:
        kc = mod(impl, "operator.kubeclient")
        assert kc.in_cluster_available(str(sa))
        clients[impl] = kc.KubeClient("", sa_dir=str(sa))
    assert {(c.server, c.token) for c in clients.values()} == {
        ("https://10.96.0.1:6443", "sa-token")}
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST")
    for impl in IMPLS:
        kc = mod(impl, "operator.kubeclient")
        assert not kc.in_cluster_available(str(sa))
        with pytest.raises(ValueError, match="not running in-cluster"):
            kc.KubeClient("", sa_dir=str(sa))


KUBECONFIGS = {
    "no-clusters": ({"clusters": [], "contexts": [], "users": []}, "no clusters"),
    "unknown-cluster": ({"clusters": [{"name": "c", "cluster": {"server": "http://x"}}],
                         "contexts": [{"name": "t", "context": {"cluster": "other"}}],
                         "current-context": "t"}, "unknown cluster"),
    "no-server": ({"clusters": [{"name": "c", "cluster": {}}]}, "no server"),
    "second-context": ({
        "current-context": "b",
        "clusters": [{"name": "ca", "cluster": {"server": "http://10.0.0.1:6443/"}},
                     {"name": "cb", "cluster": {"server": "http://10.0.0.2:6443"}}],
        "contexts": [{"name": "a", "context": {"cluster": "ca", "user": "ua"}},
                     {"name": "b", "context": {"cluster": "cb", "user": "ub"}}],
        "users": [{"name": "ua", "user": {"token": "ta"}},
                  {"name": "ub", "user": {"token": "tb"}}]}, None),
    "first-context": ({
        "clusters": [{"name": "ca", "cluster": {"server": "http://10.0.0.1:6443"}}],
        "contexts": [{"name": "a", "context": {"cluster": "ca", "user": "ua"}}],
        "users": [{"name": "ua", "user": {"token": "ta"}}]}, None),
}


@pytest.mark.parametrize("case", KUBECONFIGS)
def test_kubeconfig_reading_equals_the_reference(case, tmp_path):
    doc, err = KUBECONFIGS[case]
    path = tmp_path / "kc"
    path.write_text(yaml.safe_dump(doc))
    got = []
    for impl in IMPLS:
        kc = mod(impl, "operator.kubeclient")
        if err:
            with pytest.raises(ValueError, match=err):
                kc.KubeClient(str(path))
        else:
            c = kc.KubeClient(str(path))
            got.append((c.server, c.token, c.url("/api/v1", "pods", namespace="d",
                                                 suffix="/p", query="watch=true")))
    if not err:
        assert got[0] == got[1]
        want = {"second-context": ("http://10.0.0.2:6443", "tb"),
                "first-context": ("http://10.0.0.1:6443", "ta")}[case]
        assert got[1][:2] == want
        assert got[1][2] == want[0] + "/api/v1/namespaces/d/pods/p?watch=true"


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    return tls_chain(tmp_path_factory.mktemp("tls"))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("how", ["client-cert-data", "client-cert-files", "ca-file-token"])
def test_kubeconfig_over_tls(impl, how, chain, tmp_path):
    """HTTPS to a server whose certificate the kubeconfig's CA signed; with
    a client certificate the server requires (inline data, written to a
    temporary file for ``ssl``, or files), or a bearer token."""
    kube = FakeKube(tls=server_tls(chain, client_certs=how != "ca-file-token"))
    try:
        kube.add(PODS, pod_doc("web-0", "10.0.0.8"), event=False)
        b64 = lambda p: base64.b64encode(p.read_bytes()).decode()  # noqa: E731
        cluster = ({"certificate-authority": str(chain["ca.crt"])} if how != "client-cert-data"
                   else {"certificate-authority-data": b64(chain["ca.crt"])})
        user = {"client-cert-data": {"client-certificate-data": b64(chain["client.crt"]),
                                     "client-key-data": b64(chain["client.key"])},
                "client-cert-files": {"client-certificate": str(chain["client.crt"]),
                                      "client-key": str(chain["client.key"])},
                "ca-file-token": {"token": "tls-token"}}[how]
        path = kube.kubeconfig(tmp_path / "kc", cluster=cluster, user=user)
        c = mod(impl, "operator.kubeclient").KubeClient(path)
        assert c.server.startswith("https://127.0.0.1:")
        with c.request(c.url("/api/v1", "pods")) as r:
            import json

            assert [p["metadata"]["name"] for p in json.load(r)["items"]] == ["web-0"]
        auth = kube.requests[-1][2]
        assert auth == ("Bearer tls-token" if how == "ca-file-token" else "")
    finally:
        kube.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_tls_refuses_a_server_the_ca_did_not_sign(impl, chain, tmp_path):
    other = tls_chain(tmp_path / "other")
    kube = FakeKube(tls=server_tls(other, client_certs=False))
    try:
        path = kube.kubeconfig(tmp_path / "kc", cluster={
            "certificate-authority": str(chain["ca.crt"])})
        c = mod(impl, "operator.kubeclient").KubeClient(path)
        with pytest.raises(OSError, match="CERTIFICATE_VERIFY_FAILED"):
            c.request(c.url("/api/v1", "pods"), timeout=10)
    finally:
        kube.close()
