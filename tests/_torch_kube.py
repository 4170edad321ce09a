"""Shared pieces of the kube tests: the two packages side by side, the
documents the fake apiserver (``chip_smoke.FakeKube``) serves, a cache's
comparable state and a self-signed TLS chain made with ``openssl``."""

from __future__ import annotations

import dataclasses
import importlib
import subprocess
import time
from pathlib import Path

PKG = {"reference": "retina_tpu", "port": "retina_tpu_torch"}
IMPLS = tuple(PKG)
PODS = "/api/v1/pods"
SERVICES = "/api/v1/services"
NODES = "/api/v1/nodes"
NAMESPACES = "/api/v1/namespaces"
CEPS = "/apis/cilium.io/v2/ciliumendpoints"
CIDS = "/apis/cilium.io/v2/ciliumidentities"


def mod(impl: str, name: str):
    """``name`` (e.g. "operator.kubewatch") of the reference or the port."""
    return importlib.import_module(f"{PKG[impl]}.{name}")


def wait_for(pred, bound: float, what: str) -> None:
    deadline = time.monotonic() + bound
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def asdict(obj):
    return None if obj is None else dataclasses.asdict(obj)


def cache_state(cache) -> dict:
    """Everything the identity cache holds, comparable across packages."""
    with cache._lock:
        svcs = {k: dataclasses.asdict(v) for k, v in cache._svcs.items()}
    keys = sorted(cache.list_endpoint_keys())
    return {
        "endpoints": {k: dataclasses.asdict(cache.get_endpoint(k)) for k in keys},
        "indexes": {k: cache.get_index(k) for k in keys},
        "ip_index_map": cache.ip_index_map(),
        "services": svcs,
        "nodes": sorted((dataclasses.asdict(n) for n in cache.list_nodes()),
                        key=lambda n: n["name"]),
        "annotated": sorted(cache.annotated_namespaces()),
    }


def settle(caches: dict, pred, what: str) -> dict:
    """Wait until both packages' caches satisfy ``pred`` and are equal;
    returns the port's state."""
    def ok() -> bool:
        states = [cache_state(c) for c in caches.values()]
        return all(pred(s) for s in states) and states[0] == states[1]

    wait_for(ok, 20, what)
    return cache_state(caches["port"])


def stop_all(kube, watchers) -> None:
    """Stop watchers without waiting out their streams' timeouts."""
    for w in watchers:
        w._stop.set()
    kube.hangup()
    for w in watchers:
        w.stop()


# -- documents --------------------------------------------------------------
def pod_doc(name: str, ip: str = "", ns: str = "default", *, ips=(), host_network=False,
            deleting=False, labels=None, annotations=None, node="node-a") -> dict:
    status: dict = {}
    if ip:
        status["podIP"] = ip
    if ips:
        status["podIPs"] = [{"ip": x} for x in ips]
    meta = {"name": name, "namespace": ns, "labels": labels or {"app": name.split("-")[0]},
            "annotations": annotations or {},
            "ownerReferences": [{"kind": "ReplicaSet", "name": name.split("-")[0] + "-rs"}]}
    if deleting:
        meta["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"hostNetwork": host_network, "nodeName": node,
                     "containers": [{"name": "main"}, {"name": "sidecar"}]},
            "status": status}


def svc_doc(name: str, cluster_ip="10.96.0.10", ns: str = "default", lb_ip: str = "",
            selector=None) -> dict:
    doc = {"apiVersion": "v1", "kind": "Service", "metadata": {"name": name, "namespace": ns},
           "spec": {"clusterIP": cluster_ip, "selector": selector or {"app": name}}}
    if lb_ip:
        doc["status"] = {"loadBalancer": {"ingress": [{"ip": lb_ip}]}}
    return doc


def node_doc(name: str, ip: str = "", zone: str = "") -> dict:
    addrs = [{"type": "Hostname", "address": name}]
    if ip:
        addrs.append({"type": "InternalIP", "address": ip})
    labels = {"topology.kubernetes.io/zone": zone} if zone else {}
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": labels},
            "status": {"addresses": addrs}}


def ns_doc(name: str, observe: bool = True, deleting: bool = False) -> dict:
    meta: dict = {"name": name}
    if observe:
        meta["annotations"] = {"retina.sh": "observe"}
    if deleting:
        meta["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": meta}


def cep_doc(name: str, ip: str = "", ns: str = "default", *, ipv6: str = "", labels=None,
            node: str = "node-a") -> dict:
    addressing = []
    if ip:
        addressing.append({"ipv4": ip})
    if ipv6:
        addressing.append({"ipv6": ipv6})
    raw = [f"k8s:{k}={v}" for k, v in (labels or {"app": name.split("-")[0]}).items()]
    raw += [f"k8s:io.kubernetes.pod.namespace={ns}",
            "k8s:io.cilium.k8s.policy.cluster=default",
            "k8s:io.cilium.k8s.policy.serviceaccount=default", "reserved:init="]
    return {"apiVersion": "cilium.io/v2", "kind": "CiliumEndpoint",
            "metadata": {"name": name, "namespace": ns},
            "status": {"identity": {"id": 300, "labels": raw},
                       "networking": {"addressing": addressing, "node": node},
                       "state": "ready"}}


# -- TLS --------------------------------------------------------------------
def tls_chain(d: Path) -> dict[str, Path]:
    """A CA, a server certificate for 127.0.0.1 and a client certificate,
    each signed by the CA (``openssl``); returns their paths."""
    d.mkdir(parents=True, exist_ok=True)

    def run(*args: str) -> None:
        subprocess.run(["openssl", *args], cwd=d, check=True, capture_output=True, timeout=60)

    run("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "2", "-subj",
        "/CN=kube-ca", "-keyout", "ca.key", "-out", "ca.crt")
    (d / "server.ext").write_text("subjectAltName=IP:127.0.0.1\n")
    for who, ext in (("server", ["-extfile", "server.ext"]), ("client", [])):
        run("req", "-newkey", "rsa:2048", "-nodes", "-subj", f"/CN={who}", "-keyout",
            f"{who}.key", "-out", f"{who}.csr")
        run("x509", "-req", "-in", f"{who}.csr", "-CA", "ca.crt", "-CAkey", "ca.key",
            "-CAcreateserial", "-days", "2", "-out", f"{who}.crt", *ext)
    return {n: d / n for n in ("ca.crt", "server.crt", "server.key", "client.crt",
                               "client.key")}


def server_tls(chain: dict[str, Path], client_certs: bool):
    """The fake apiserver's TLS context; with ``client_certs`` it asks for
    a client certificate signed by the CA."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(chain["server.crt"], chain["server.key"])
    if client_certs:
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(chain["ca.crt"])
    return ctx
