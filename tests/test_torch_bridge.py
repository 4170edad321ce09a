"""The port's CRD plumbing (``retina_tpu_torch/operator/{store,bridge,
crdinstall}.py`` and the capture types of ``crd/types.py``) against the
reference's: the parsed Capture types and their validation errors, both
packages' ``KubeBridge``s on one fake apiserver (``chip_smoke.FakeKube``)
holding equal stores through a LIST, WATCH events, a poison CR, a 410 and
a dropped connection's resync, with equal status PATCH bodies; both
``FileBridge``s over copies of one directory (add, change, multi-doc,
delete, status beside the file); the CRD manifests and their install."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from pathlib import Path

import pytest
import yaml

from _torch_kube import IMPLS, mod, stop_all, wait_for
from chip_smoke import FakeKube

REPO = Path(__file__).resolve().parents[1]
GROUP = "/apis/retina.sh/v1alpha1"
CAPTURES = f"{GROUP}/captures"
METRICS = f"{GROUP}/metricsconfigurations"
TRACES = f"{GROUP}/tracesconfigurations"
KINDS = ("Capture", "MetricsConfiguration", "TracesConfiguration")


def capture_doc(name: str, ns: str = "default", **spec) -> dict:
    return {"apiVersion": "retina.sh/v1alpha1", "kind": "Capture",
            "metadata": {"name": name, "namespace": ns},
            "spec": spec or {"captureTarget": {"nodeNames": ["node-a"]},
                             "outputConfiguration": {"hostPath": "/tmp/x"}, "duration": 1}}


def metrics_doc(name: str, ns: str = "default", metrics=("forward", "drop")) -> dict:
    return {"apiVersion": "retina.sh/v1alpha1", "kind": "MetricsConfiguration",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"contextOptions": [{"metricName": m, "sourceLabels": ["podname"]}
                                        for m in metrics],
                     "namespaces": {"exclude": ["kube-system"]}}}


def traces_doc(name: str, ns: str = "default") -> dict:
    return {"apiVersion": "retina.sh/v1alpha1", "kind": "TracesConfiguration",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"traceTargets": [{"name": "t"}], "samplingRatePerMille": 5}}


def store_state(store) -> dict:
    return {kind: {f"{o.namespace}/{o.name}": dataclasses.asdict(o) for o in store.list(kind)}
            for kind in KINDS}


# -- the capture types ---------------------------------------------------------
CAPTURE_CASES = {
    "node-names": capture_doc("a"),
    "pod-selector": capture_doc("b", captureTarget={
        "podSelector": {"matchLabels": {"app": "web"}},
        "namespaceSelector": {"matchLabels": {"team": "x"}}},
        outputConfiguration={"persistentVolumeClaim": "pvc"}, duration=30),
    "capture-configuration": capture_doc("c", captureConfiguration={
        "captureTarget": {"nodeSelector": {"matchLabels": {"pool": "gpu"}}},
        "captureOption": {"duration": 120}, "filters": {"raw": "tcp port 53"}},
        outputConfiguration={"blobUpload": "secret"}),
    "s3": capture_doc("d", captureTarget={"nodeNames": ["n"]}, outputConfiguration={
        "s3Upload": {"bucket": "b", "region": "r"}}, tcpdumpFilter="udp"),
    "no-output": capture_doc("e", captureTarget={"nodeNames": ["n"]}),
    "status": dict(capture_doc("f"), status={"phase": "Completed", "jobs_completed": 1,
                                             "artifacts": ["/tmp/x/a.tar.gz"]}),
    "camel-status": dict(capture_doc("g"), status={"phase": "Running", "jobsActive": 2}),
    "no-target": capture_doc("h", outputConfiguration={"hostPath": "/x"}),
    "both-selectors": capture_doc("i", captureTarget={
        "nodeNames": ["n"], "podSelector": {"matchLabels": {"a": "b"}}}),
    "duration-zero": capture_doc("j", captureTarget={"nodeNames": ["n"]}, duration=0),
    "duration-past-an-hour": capture_doc("k", captureTarget={"nodeNames": ["n"]},
                                         duration=3601),
    "s3-no-region": capture_doc("l", captureTarget={"nodeNames": ["n"]},
                                outputConfiguration={"s3Upload": {"bucket": "b"}}),
    "no-name": dict(capture_doc("m"), metadata={"namespace": "x"}),
}


@pytest.mark.parametrize("case", CAPTURE_CASES)
def test_capture_from_yaml_equals_the_reference(case):
    text = yaml.safe_dump(CAPTURE_CASES[case])
    got = []
    for impl in IMPLS:
        types = mod(impl, "crd.types")
        try:
            got.append(("ok", dataclasses.asdict(types.Capture.from_yaml(text))))
        except types.ValidationError as e:
            got.append(("invalid", str(e)))
    assert got[0] == got[1]
    invalid = case in ("no-target", "both-selectors", "duration-zero", "duration-past-an-hour",
                       "s3-no-region", "no-name")
    assert (got[1][0] == "invalid") == invalid, got[1]
    if case == "capture-configuration":
        spec = got[1][1]["spec"]
        assert (spec["duration_s"], spec["tcpdump_filter"]) == (120, "tcp port 53")
        assert spec["target"]["node_selector"] == {"pool": "gpu"}
    if case == "status":
        assert got[1][1]["status"]["phase"] == "Completed"


@pytest.mark.parametrize("impl", IMPLS)
def test_module_crs_keep_their_namespace_and_tolerate_nulls(impl):
    types = mod(impl, "crd.types")
    t = types.TracesConfiguration.from_yaml(
        "metadata:\n  name: foo\n  namespace: monitoring\n"
        "spec:\n  traceTargets:\n  tracePoints:\n  samplingRatePerMille:\n")
    assert t.namespace == "monitoring" and t.spec.trace_targets == []
    assert t.spec.sampling_rate_per_mille == 0
    m = types.MetricsConfiguration.from_yaml(
        "metadata:\n  name: bar\n  namespace: monitoring\nspec: {}\n")
    assert m.namespace == "monitoring"
    assert types.CaptureOutput().is_empty() and not types.CaptureOutput(host_path="/x").is_empty()


# -- KubeBridge on one fake apiserver ----------------------------------------------
def test_kube_bridges_equal_the_reference(tmp_path):
    kube = FakeKube()
    try:
        kube.add(CAPTURES, capture_doc("from-list"), event=False)
        kube.add(CAPTURES, capture_doc("other-ns", ns="prod"), event=False)
        kube.add(METRICS, metrics_doc("m"), event=False)
        kube.add(METRICS, metrics_doc("poison", metrics=("no-such-metric",)), event=False)
        kube.add(TRACES, traces_doc("t"), event=False)
        kc = kube.kubeconfig(tmp_path / "kc", token="sekrit")
        stores = {i: mod(i, "operator.store").CRDStore() for i in IMPLS}
        bridges = {i: mod(i, "operator.bridge").KubeBridge(stores[i], kc, retry_s=0.1)
                   for i in IMPLS}
        for b in bridges.values():
            b.start()
        try:
            def settle(pred, what: str) -> dict:
                def ok() -> bool:
                    states = [store_state(s) for s in stores.values()]
                    return all(pred(s) for s in states) and states[0] == states[1]

                wait_for(ok, 20, what)
                return store_state(stores["port"])

            state = settle(lambda s: len(s["Capture"]) == 2 and len(s["TracesConfiguration"])
                           == 1 and len(s["MetricsConfiguration"]) == 1, "the LISTs")
            # The poison CR was skipped; its kind's watch goes on.
            assert list(state["MetricsConfiguration"]) == ["default/m"]
            assert state["Capture"]["prod/other-ns"]["namespace"] == "prod"
            kube.add(CAPTURES, capture_doc("from-watch"))
            kube.delete(CAPTURES, capture_doc("from-list"))
            kube.modify(METRICS, metrics_doc("poison", metrics=("dns",)))
            kube.delete(TRACES, traces_doc("t"))
            settle(lambda s: sorted(s["Capture"]) == ["default/from-watch", "prod/other-ns"]
                   and "default/poison" in s["MetricsConfiguration"]
                   and not s["TracesConfiguration"], "the WATCH events")
            for res in (CAPTURES, METRICS):
                kube.wait(lambda r=res: kube.open.get(r, 0) >= 2, 10, f"both {res} watches")
            kube.add(CAPTURES, capture_doc("missed-add"), event=False)
            kube.expire(CAPTURES)
            kube.forget(METRICS, "default/m")
            kube.drop(METRICS)
            state = settle(lambda s: "default/missed-add" in s["Capture"]
                           and "default/m" not in s["MetricsConfiguration"],
                           "the re-LISTs and their resync")
            assert kube.lists[CAPTURES] == kube.lists[METRICS] == 4

            # The status subresource write-back, from both packages.
            kube.writes.clear()
            for impl in IMPLS:
                cap = stores[impl].get("Capture", "other-ns", "prod")
                cap.status.phase, cap.status.jobs_completed = "Completed", 1
                cap.status.artifacts = ["/tmp/x/a.tar.gz"]
                bridges[impl].patch_status("Capture", cap)
            (m0, p0, b0), (m1, p1, b1) = kube.writes
            assert (m0, p0, b0) == (m1, p1, b1)
            assert (m1, p1) == ("PATCH", f"{GROUP}/namespaces/prod/captures/other-ns/status")
            assert b1["status"]["phase"] == "Completed" and b1["status"]["jobs_completed"] == 1
            assert kube.items(CAPTURES, "prod")[0]["status"]["phase"] == "Completed"
            assert {r[2] for r in kube.requests} == {"Bearer sekrit"}
        finally:
            stop_all(kube, bridges.values())
    finally:
        kube.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_kube_bridge_skips_a_poison_cr_and_keeps_reconciling(impl, tmp_path, monkeypatch):
    bridge_mod = mod(impl, "operator.bridge")
    store = mod(impl, "operator.store").CRDStore()
    kc = tmp_path / "kc"
    kc.write_text(yaml.safe_dump({"clusters": [{"name": "c", "cluster": {
        "server": "http://127.0.0.1:1"}}]}))
    bridge = bridge_mod.KubeBridge(store, str(kc))
    plural, parse = bridge_mod.KINDS["TracesConfiguration"]

    def poisoned(doc):
        if doc.get("metadata", {}).get("name") == "poison":
            raise ValueError("malformed")
        return parse(doc)

    monkeypatch.setitem(bridge_mod.KINDS, "TracesConfiguration", (plural, poisoned))
    bridge._ingest("TracesConfiguration", "ADDED", {"metadata": {"name": "poison"}})
    bridge._ingest("TracesConfiguration", "ADDED", traces_doc("good"))
    bridge._ingest("TracesConfiguration", "DELETED", traces_doc("never-applied"))
    assert [o.name for o in store.list("TracesConfiguration")] == ["good"]
    assert store.list("TracesConfiguration")[0].spec.trace_targets == [{"name": "t"}]


# -- FileBridge over copies of one directory ----------------------------------------
CAPTURE_YAML = """apiVersion: retina.sh/v1alpha1
kind: Capture
metadata:
  name: {name}
  namespace: default
spec:
  captureTarget:
    nodeNames: ["local"]
  outputConfiguration:
    hostPath: "/tmp/art"
  duration: {duration}
"""


def test_file_bridges_equal_the_reference(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    dirs = {i: tmp_path / i for i in IMPLS}
    stores = {i: mod(i, "operator.store").CRDStore() for i in IMPLS}
    bridges = {i: mod(i, "operator.bridge").FileBridge(stores[i], str(dirs[i]),
                                                       poll_interval=0.05) for i in IMPLS}
    events = {i: [] for i in IMPLS}
    for i in IMPLS:
        for kind in KINDS:
            stores[i].watch(kind, lambda ev, o, i=i, k=kind: events[i].append((k, ev, o.name)))
    stamp = [time.time()]

    def step(write: dict[str, str | None]) -> dict:
        """Apply ``write`` (file -> text, None removes) to both directories,
        sync both bridges and return the port's store once both agree."""
        stamp[0] += 10
        for name, text in write.items():
            for i in IMPLS:
                path = dirs[i] / name
                if text is None:
                    path.unlink()
                else:
                    path.write_text(text)
                    os.utime(path, (stamp[0], stamp[0]))
        for b in bridges.values():
            b.sync_once()
        states = [store_state(s) for s in stores.values()]
        assert states[0] == states[1]
        assert events["port"] == events["reference"]
        return states[1]

    for i in IMPLS:
        shutil.copytree(src, dirs[i])
    state = step({"capture.yaml": CAPTURE_YAML.format(name="grab", duration=1),
                  "metrics.yml": yaml.safe_dump(metrics_doc("m")),
                  "notes.txt": "not a CR",
                  "broken.yaml": "kind: [unclosed",
                  "unknown.yaml": "kind: Widget\nmetadata: {name: w}\n"})
    assert list(state["Capture"]) == ["default/grab"]
    assert list(state["MetricsConfiguration"]) == ["default/m"]
    # Status beside the file (one capture in it: "<file>.status").
    for i in IMPLS:
        cap = stores[i].get("Capture", "grab")
        cap.status.phase, cap.status.jobs_completed = "Completed", 1
        bridges[i].on_status("Capture", cap)
    got = [json.loads((dirs[i] / "capture.yaml.status").read_text()) for i in IMPLS]
    assert got[0] == got[1] and got[1]["phase"] == "Completed"
    # A change re-applies; a multi-doc file applies each doc.
    state = step({"capture.yaml": CAPTURE_YAML.format(name="grab", duration=5),
                  "multi.yaml": CAPTURE_YAML.format(name="one", duration=1) + "---\n"
                  + CAPTURE_YAML.format(name="two", duration=2) + "---\n"
                  + yaml.safe_dump(traces_doc("t"))})
    assert state["Capture"]["default/grab"]["spec"]["duration_s"] == 5
    assert sorted(state["Capture"]) == ["default/grab", "default/one", "default/two"]
    for i in IMPLS:
        assert bridges[i]._status_paths[("Capture", "default", "two")].endswith(
            "multi.yaml.two.status")
        bridges[i].on_status("Capture", stores[i].get("Capture", "two"))
    got = [(dirs[i] / "multi.yaml.two.status").read_text() for i in IMPLS]
    assert got[0] == got[1]
    # A doc dropped from a file deletes its CR; a removed file deletes all.
    state = step({"multi.yaml": CAPTURE_YAML.format(name="one", duration=1)})
    assert sorted(state["Capture"]) == ["default/grab", "default/one"]
    assert not state["TracesConfiguration"]
    state = step({"capture.yaml": None, "metrics.yml": None})
    assert list(state["Capture"]) == ["default/one"] and not state["MetricsConfiguration"]
    # The background loop does the same.
    for i in IMPLS:
        bridges[i].start()
    try:
        for i in IMPLS:
            (dirs[i] / "late.yaml").write_text(CAPTURE_YAML.format(name="late", duration=1))
        wait_for(lambda: all(len(s.list("Capture")) == 2 for s in stores.values()), 10,
                 "the bridges' loops")
    finally:
        for b in bridges.values():
            b.stop()


@pytest.mark.parametrize("impl", IMPLS)
def test_crd_store_contract(impl):
    store = mod(impl, "operator.store").CRDStore()
    types = mod(impl, "crd.types")
    seen = []
    store.apply("TracesConfiguration", types.TracesConfiguration(name="a"))
    store.watch("TracesConfiguration", lambda ev, o: seen.append((ev, o.name)))
    assert seen == [("applied", "a")]  # the informer's initial sync
    store.watch("TracesConfiguration", lambda ev, o: 1 / 0)  # a failing watcher is logged
    store.delete("TracesConfiguration", "a")
    assert seen == [("applied", "a"), ("deleted", "a")]
    with pytest.raises(KeyError):
        store.get("TracesConfiguration", "a")
    with pytest.raises(KeyError):
        store.delete("TracesConfiguration", "a")
    with pytest.raises(types.ValidationError):
        store.apply("Capture", types.Capture(name=""))


# -- the CRD manifests ------------------------------------------------------------
def test_crd_manifests_equal_the_reference_and_the_rendered_file(tmp_path):
    ref, port = (mod(i, "operator.crdinstall") for i in IMPLS)
    on_disk = [d for d in yaml.safe_load_all((REPO / "deploy/manifests/crds.yaml").read_text())
               if d]
    assert port.crd_manifests() == ref.crd_manifests() == on_disk
    port.render(str(tmp_path / "crds.yaml"))
    assert (tmp_path / "crds.yaml").read_bytes() == (
        REPO / "deploy/manifests/crds.yaml").read_bytes()


def test_install_crds_create_noop_and_upgrade_equal_the_reference(tmp_path):
    """Fresh cluster: 3 POSTs. Again: 409, GET, no write. Upgrade (the
    stored spec differs): 409, GET, PUT with the stored resourceVersion."""
    crds = "/apis/apiextensions.k8s.io/v1/customresourcedefinitions"
    writes = {}
    for impl in IMPLS:
        kube = FakeKube()
        try:
            inst = mod(impl, "operator.crdinstall")
            client = mod(impl, "operator.kubeclient").KubeClient(
                kube.kubeconfig(tmp_path / f"{impl}.kc"))
            assert inst.install_crds(client) == 3
            assert inst.install_crds(client) == 0
            old = kube.items(crds)[0]
            old["spec"]["versions"][0].pop("additionalPrinterColumns")
            kube.modify(crds, old)
            assert inst.install_crds(client) == 1
            writes[impl] = kube.writes
            current = {c["metadata"]["name"]: c["spec"] for c in kube.items(crds)}
        finally:
            kube.close()
    assert writes["port"] == writes["reference"]
    assert [m for m, _, _ in writes["port"]].count("POST") == 9
    assert [(m, p) for m, p, _ in writes["port"] if m != "POST"] == [
        ("PUT", f"{crds}/captures.retina.sh")]
    assert current == {d["metadata"]["name"]: d["spec"]
                       for d in mod("port", "operator.crdinstall").crd_manifests()}
