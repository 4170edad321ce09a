"""The port's Cilium CRD interop (``retina_tpu_torch/operator/cilium.py``)
against the reference's: the identity allocator, the security labels, the
CiliumEndpoint translation, the publisher's PUT, POST and DELETE sequence
and its numeric identities (a shared identity, a relabel, a restart's
renumbering and GC) on one fake apiserver each (``chip_smoke.FakeKube``),
and both packages' ``CiliumWatcher``s feeding equal caches through a LIST,
WATCH events, a 410 and a dropped connection's resync."""

from __future__ import annotations

import contextlib

import pytest

from _torch_kube import CEPS, CIDS, IMPLS, asdict, cep_doc, mod, settle, stop_all
from chip_smoke import FakeKube


@pytest.mark.parametrize("impl", IMPLS)
def test_identity_allocator_dedupe_and_refcount(impl):
    """identitymanager.go semantics: one identity per distinct label set,
    refcounted, freed only on the last release."""
    alloc = mod(impl, "operator.cilium").IdentityAllocator(base=256)
    assert alloc.allocate({"app": "web"}) == alloc.allocate({"app": "web"}) == 256
    assert alloc.allocate({"app": "db"}) == 257
    assert alloc.release({"app": "web"}) is None
    assert alloc.release({"app": "web"}) == 256
    assert alloc.lookup({"app": "web"}) is None and alloc.lookup({"app": "db"}) == 257
    assert alloc.release({"app": "ghost"}) is None
    assert alloc.allocate({"app": "web"}) == 258  # numbers are never reused


def endpoint(impl: str, name: str, ip: str, ns: str = "d", **labels):
    return mod(impl, "common").RetinaEndpoint(
        name=name, namespace=ns, ips=(ip,), labels=tuple(sorted(labels.items())))


def test_security_labels_equal_the_reference():
    got = [mod(i, "operator.cilium").security_labels(endpoint(i, "p", "10.0.0.1", ns="prod",
                                                               app="web", tier="fe"))
           for i in IMPLS]
    assert got[0] == got[1] == {"k8s:app": "web", "k8s:tier": "fe",
                                "k8s:io.kubernetes.pod.namespace": "prod"}


CEP_CASES = {
    "plain": cep_doc("web-0", "10.0.1.5"),
    "ipv6": cep_doc("v6-0", ipv6="fd00::5"),
    "dual": cep_doc("dual-0", "10.0.1.6", ipv6="fd00::6"),
    "no-ip": cep_doc("pending-0"),
    "no-name": dict(cep_doc("x", "10.0.1.7"), metadata={"namespace": "d"}),
    "labels": cep_doc("lbl-0", "10.0.1.8", labels={"app": "web", "io.kubernetes.x": "y",
                                                    "io.cilium.k8s.z": "w", "tier": "db"}),
    "nulls": {"metadata": {"name": "n"}, "status": {"identity": None, "networking": None}},
}


@pytest.mark.parametrize("case", CEP_CASES)
def test_cep_to_endpoint_equals_the_reference(case):
    doc = CEP_CASES[case]
    ref, port = (mod(i, "operator.cilium").cep_to_endpoint(doc) for i in IMPLS)
    assert asdict(port) == asdict(ref)
    assert (port is None) == (case in ("no-ip", "no-name", "nulls"))
    if case == "labels":
        # Only genuine pod labels: the derived Cilium ones are dropped.
        assert dict(port.labels) == {"app": "web", "tier": "db"}
    if case == "dual":
        assert port.ips == ("10.0.1.6", "fd00::6") and port.node == "node-a"


def publish_script(impl: str, kube: FakeKube, kc: str) -> list[tuple[str, int]]:
    """The publisher through a restart's bootstrap and GC, a shared
    identity, relabels, an idempotent upsert and deletes; returns the
    identity of each pod after each step."""
    cil = mod(impl, "operator.cilium")
    pub = cil.CiliumPublisher(mod(impl, "operator.kubeclient").KubeClient(kc), node_name="n1")
    pub.bootstrap()
    ep = lambda name, ip, **lb: endpoint(impl, name, ip, **lb)  # noqa: E731
    ids = []

    def note(e) -> None:
        ids.append((e.name, pub.alloc.lookup(cil.security_labels(e))))

    for e in (ep("live-pod", "10.0.0.3", app="x"), ep("web-0", "10.0.0.4", app="web"),
              ep("web-1", "10.0.0.5", app="web"), ep("db-0", "10.0.0.6", app="db")):
        pub.pod_upsert(e)
        note(e)
    pub.gc_stale()
    pub.gc_stale()  # one-shot: deletes nothing more
    for e in (ep("web-1", "10.0.0.5", app="web2"), ep("web-1", "10.0.0.5", app="web2"),
              ep("db-0", "10.0.0.6", app="db2")):
        pub.pod_upsert(e)
        note(e)
    pub.on_pod_event(("deleted", ep("web-0", "10.0.0.4", app="web")))
    pub.on_pod_event(("updated", ep("web-0", "10.0.0.44", app="web")))
    pub.pod_delete("d/web-1")
    pub.pod_delete("d/never-published")
    return ids


def test_publisher_writes_equal_the_reference(tmp_path):
    """The same CEP/CID writes, in the same order, with the same bodies, on
    two fake apiservers left in the same state by a previous run."""
    writes, ids = {}, {}
    for impl in IMPLS:
        kube = FakeKube()
        try:
            for cid in ("256", "300", "not-a-number"):
                kube.add(CIDS, {"metadata": {"name": cid},
                                "security-labels": {"k8s:app": "old"}}, event=False)
            for name in ("gone-pod", "live-pod"):
                kube.add(CEPS, cep_doc(name, "10.0.9.9", ns="d"), event=False)
            ids[impl] = publish_script(impl, kube, kube.kubeconfig(tmp_path / f"{impl}.kc"))
            writes[impl] = [(m, p, b) for m, p, b in kube.writes]
            left = {c["metadata"]["name"] for c in kube.items(CIDS)}
            ceps = {FakeKube.key(c) for c in kube.items(CEPS)}
        finally:
            kube.close()
    assert writes["port"] == writes["reference"]
    assert ids["port"] == ids["reference"]
    # Renumbered above the leftover identities; web-0 and web-1 share one.
    assert ids["port"][:4] == [("live-pod", 301), ("web-0", 302), ("web-1", 302),
                               ("db-0", 303)]
    assert ids["port"][4:] == [("web-1", 304), ("web-1", 304), ("db-0", 305)]
    deleted = [p for m, p, _ in writes["port"] if m == "DELETE"]
    assert "/apis/cilium.io/v2/namespaces/d/ciliumendpoints/gone-pod" in deleted
    assert "/apis/cilium.io/v2/ciliumidentities/256" in deleted
    assert "/apis/cilium.io/v2/ciliumidentities/303" in deleted  # db-0's old identity
    assert "/apis/cilium.io/v2/ciliumidentities/301" not in deleted
    # A PUT to an absent object falls back to a POST create.
    assert [m for m, p, _ in writes["port"][:2]] == ["PUT", "POST"]
    # Left: the live pod's, db-0's and the re-added web-0's.
    assert left == {"301", "305", "306", "not-a-number"}
    assert ceps == {"d/live-pod", "d/web-0", "d/db-0"}


@contextlib.contextmanager
def both_watchers(kube: FakeKube, kc: str):
    caches = {i: mod(i, "controllers.cache").Cache() for i in IMPLS}
    watchers = {i: mod(i, "operator.cilium").CiliumWatcher(caches[i], kc, retry_s=0.1)
                for i in IMPLS}
    for w in watchers.values():
        w.start()
    try:
        yield caches
    finally:
        stop_all(kube, watchers.values())


def test_cilium_watchers_equal_the_reference(tmp_path):
    kube = FakeKube()
    try:
        for doc in (cep_doc("web-0", "10.0.1.1"), cep_doc("web-1", "10.0.1.2"),
                    cep_doc("pending-0"), cep_doc("db-0", "10.0.2.1", ns="prod")):
            kube.add(CEPS, doc, event=False)
        with both_watchers(kube, kube.kubeconfig(tmp_path / "kc")) as caches:
            state = settle(caches, lambda s: len(s["endpoints"]) == 3, "the LISTs")
            assert state["indexes"] == {"default/web-0": 1, "default/web-1": 2, "prod/db-0": 3}
            assert state["endpoints"]["default/web-0"]["labels"] == (("app", "web"),)
            kube.add(CEPS, cep_doc("web-2", "10.0.1.3"))
            kube.delete(CEPS, cep_doc("web-0", "10.0.1.1"))
            kube.modify(CEPS, cep_doc("web-1", "10.0.1.22"))
            settle(caches, lambda s: "default/web-0" not in s["endpoints"]
                   and s["endpoints"].get("default/web-1", {}).get("ips") == ("10.0.1.22",)
                   and "default/web-2" in s["endpoints"], "the WATCH events")
            kube.wait(lambda: kube.watches.get(CEPS, 0) >= 2, 10, "both watches")
            kube.add(CEPS, cep_doc("late-0", "10.0.1.4"), event=False)
            kube.expire(CEPS)
            settle(caches, lambda s: "default/late-0" in s["endpoints"], "the 410's re-LIST")
            kube.wait(lambda: kube.open.get(CEPS, 0) >= 2, 10, "both watches again")
            kube.forget(CEPS, "prod/db-0")
            kube.drop(CEPS)
            state = settle(caches, lambda s: "prod/db-0" not in s["endpoints"],
                           "the dropped connection's resync")
            assert sorted(state["endpoints"]) == ["default/late-0", "default/web-1",
                                                  "default/web-2"]
            assert kube.lists[CEPS] == 6
    finally:
        kube.close()
