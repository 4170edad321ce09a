"""The port's ``Operator`` (``retina_tpu_torch/operator/operator.py``) and the
CLI's ``operator`` verb against the reference's.

Every case of the reference's operator tests (``tests/test_capture_operator.
py``, the managed-storage injection of ``tests/test_capture_managed.py``, the
``Operator`` cases of ``tests/test_bridge.py`` and ``tests/test_leaderelection.
py``) runs on both packages. The port is held to the reference on the same
inputs: one sequence of Capture CRs through each package's ``KubeBridge``,
``LeaderElector``, node watcher and ``KubeJobRunner`` on a fake apiserver
(``chip_smoke.FakeKube``) gives the same status documents and the same
writes; the ``operator`` verb refuses the same flag sets with the same
words. On the CPU, an agent with ``device="cpu"`` runs beside an
``Operator`` whose local capture records the blocks the agent steps: the
artifact equals the agent's synchronous replay of the same capture. The
verb's child process takes a Lease, fails a Capture and releases the Lease
on SIGTERM."""

from __future__ import annotations

import dataclasses
import io
import json
import os
import random
import re
import signal
import struct
import subprocess
import sys
import tarfile
import threading
import time
import types
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import yaml

from _torch_kube import CEPS, IMPLS, NODES, PODS, mod, node_doc, pod_doc, wait_for
from chip_smoke import FakeKube
from retina_tpu_torch import exporter, metrics

REPO = Path(__file__).resolve().parents[1]
JOBS = "/apis/batch/v1/jobs"
CAPTURES = "/apis/retina.sh/v1alpha1/captures"
LEASES = "/apis/coordination.k8s.io/v1/leases"
CRDS = "/apis/apiextensions.k8s.io/v1/customresourcedefinitions"
PCAP = REPO / "tests" / "fixtures" / "real" / "loopback_mixed_real.pcap"


def pkg(impl: str):
    return types.SimpleNamespace(
        op=mod(impl, "operator.operator"), store=mod(impl, "operator.store"),
        bridge=mod(impl, "operator.bridge"), le=mod(impl, "operator.leaderelection"),
        kw=mod(impl, "operator.kubewatch"), kc=mod(impl, "operator.kubeclient"),
        jobs=mod(impl, "capture.k8s_jobs"), mg=mod(impl, "capture.manager"),
        pr=mod(impl, "capture.providers"), managed=mod(impl, "capture.managed"),
        crd=mod(impl, "crd.types"), common=mod(impl, "common"),
        cache=mod(impl, "controllers.cache"), traces=mod(impl, "module.traces"),
        schema=mod(impl, "events.schema"), cli=mod(impl, "cli"))


def source(p):
    s = p.schema

    def src():
        time.sleep(0.05)
        rec = np.zeros((100, s.NUM_FIELDS), np.uint32)
        rec[:, s.F.SRC_IP] = s.ip_to_u32("10.0.0.5")
        rec[:, s.F.DST_IP] = s.ip_to_u32("10.0.0.9")
        rec[:, s.F.PORTS] = (40000 << 16) | 80
        rec[:, s.F.META] = s.PROTO_TCP << 24
        return rec

    return src


def replay_manager(p):
    return p.mg.CaptureManager(provider=p.pr.ReplayProvider(source=source(p)))


def capture_doc(name, nodes=("local",), host_path="/tmp/x", status=None, ns="default",
                **spec):
    out = {"hostPath": host_path} if host_path else {}
    doc = {"apiVersion": "retina.sh/v1alpha1", "kind": "Capture",
           "metadata": {"name": name, "namespace": ns},
           "spec": {"captureTarget": {"nodeNames": list(nodes)} if nodes else {},
                    "outputConfiguration": out, "duration": 1, **spec}}
    if status:
        doc["status"] = status
    return doc


def capture(p, *args, **kw):
    return p.crd.Capture.from_yaml(yaml.safe_dump(capture_doc(*args, **kw)))


# -- the store and the reconciles -----------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_store_apply_get_watch_replay(impl):
    p = pkg(impl)
    store = p.store.CRDStore()
    seen = []
    store.apply("MetricsConfiguration", p.crd.MetricsConfiguration.default())
    store.watch("MetricsConfiguration", lambda ev, o: seen.append((ev, o.name)))
    assert seen == [("applied", "default")]  # the initial sync's replay
    store.apply("MetricsConfiguration", p.crd.MetricsConfiguration(name="x"))
    assert ("applied", "x") in seen
    assert {o.name for o in store.list("MetricsConfiguration")} == {"default", "x"}
    store.delete("MetricsConfiguration", "x")
    assert ("deleted", "x") in seen
    with pytest.raises(KeyError):
        store.get("MetricsConfiguration", "x")


@pytest.mark.parametrize("impl", IMPLS)
def test_operator_capture_reconcile(impl, tmp_path):
    p = pkg(impl)
    store = p.store.CRDStore()
    op = p.op.Operator(store, node_name="local", capture_manager=replay_manager(p))
    op.start()
    cap = capture(p, "grab", host_path=str(tmp_path / "art"))
    store.apply(p.op.KIND_CAPTURE, cap)
    op.wait_capture("grab", timeout=30)
    assert cap.status.phase == "Completed" and cap.status.jobs_completed == 1
    assert cap.status.artifacts and os.path.exists(cap.status.artifacts[0])


@pytest.mark.parametrize("impl", IMPLS)
def test_operator_capture_validation_failure(impl):
    p = pkg(impl)
    store = p.store.CRDStore()
    p.op.Operator(store, node_name="local").start()
    cap = capture(p, "bad", nodes=["ghost"])
    store.apply(p.op.KIND_CAPTURE, cap)
    assert cap.status.phase == "Failed" and "ghost" in cap.status.message


@pytest.mark.parametrize("impl", IMPLS)
def test_operator_config_and_endpoint_reconciles(impl):
    p = pkg(impl)
    store, cache, reconciled = p.store.CRDStore(), p.cache.Cache(), []

    class FakeMM:
        def reconcile(self, conf):
            reconciled.append(conf.name)

    tm = p.traces.TracesModule()
    p.op.Operator(store, cache=cache, metrics_module=FakeMM(), traces_module=tm).start()
    store.apply(p.op.KIND_METRICS_CONF, p.crd.MetricsConfiguration(name="custom"))
    assert reconciled == ["custom"]
    store.delete(p.op.KIND_METRICS_CONF, "custom")
    assert reconciled[-1] == "default"
    store.apply(p.op.KIND_TRACES_CONF, p.crd.TracesConfiguration(name="t"))
    assert tm.active_spec() is not None
    store.delete(p.op.KIND_TRACES_CONF, "t")  # back to the empty default: no targets
    assert tm.active_spec().trace_targets == []
    ep = p.common.RetinaEndpoint(name="w", namespace="default", ips=("10.0.0.1",))
    store.apply(p.op.KIND_ENDPOINT, ep)
    assert cache.get_obj_by_ip("10.0.0.1").name == "w"
    store.delete(p.op.KIND_ENDPOINT, "w")
    assert cache.get_obj_by_ip("10.0.0.1") is None


@pytest.mark.parametrize("impl", IMPLS)
def test_operator_ignores_non_pending_and_dedupes_in_flight(impl):
    """An echo with a terminal status runs nothing; a Pending re-apply of
    an in-flight capture (a watch reconnect) starts no second job."""
    p = pkg(impl)
    store, ran = p.store.CRDStore(), []
    gate = threading.Event()

    class Slow:
        def run_job(self, job):
            ran.append(job.node_name)
            gate.wait(10)
            return []

    op = p.op.Operator(store, node_name="local", capture_manager=Slow())
    op.start()
    store.apply("Capture", capture(p, "echo", status={"phase": "Completed"}))
    op.wait_capture("echo", timeout=0.5)
    assert ran == []
    cap = capture(p, "twice")
    store.apply("Capture", cap)
    wait_for(lambda: ran == ["local"], 10, "the job")
    store.apply("Capture", capture(p, "twice"))  # Pending again, while in flight
    gate.set()
    op.wait_capture("twice", timeout=10)
    assert ran == ["local"] and cap.status.phase == "Completed"


@pytest.mark.parametrize("impl", IMPLS)
def test_operator_injects_managed_sas_for_outputless_capture(impl):
    """A Capture naming no output gets a provisioned SAS before translation;
    with a secret writer the spec carries the secret's name, without one
    the SAS itself."""
    p = pkg(impl)
    from test_torch_capture import FakeCloud

    secrets: dict[str, str] = {}

    def secret_writer(namespace: str, name: str, sas: str) -> str:
        secrets[f"{namespace}/{name}"] = sas
        return name

    mgr = p.managed.managed_manager_or_none(FakeCloud())
    store = p.store.CRDStore()
    p.op.Operator(store, node_name="local", storage_manager=mgr,
                  secret_writer=secret_writer).start()
    cap = capture(p, "no-output", host_path="", ns="team-a")
    store.apply("Capture", cap)
    wait_for(lambda: cap.status.phase != "Pending", 10, "the reconcile")
    assert cap.spec.output.blob_upload_secret == "capture-blob-no-output"
    sas = secrets["team-a/capture-blob-no-output"]
    assert sas.startswith("https://") and "retina-capture-team-a" in sas
    assert "output location" not in (cap.status.message or "")

    store2 = p.store.CRDStore()
    p.op.Operator(store2, node_name="local", storage_manager=mgr).start()
    cap2 = capture(p, "inline", host_path="", ns="team-b")
    store2.apply("Capture", cap2)
    wait_for(lambda: cap2.spec.output.blob_upload_secret, 10, "the SAS")
    assert cap2.spec.output.blob_upload_secret.startswith("https://")


@pytest.mark.parametrize("impl", IMPLS)
def test_operator_fails_a_capture_whose_managed_storage_fails(impl):
    p = pkg(impl)

    class Broken:
        def create_container_sas_url(self, namespace, duration_s):
            raise RuntimeError("quota exceeded")

    synced = []
    store = p.store.CRDStore()
    p.op.Operator(store, node_name="local", storage_manager=Broken(),
                  status_sink=lambda kind, obj: synced.append(obj.status.phase)).start()
    cap = capture(p, "nostore", host_path="")
    store.apply("Capture", cap)
    assert cap.status.phase == "Failed"
    assert cap.status.message == "managed storage: quota exceeded" and synced == ["Failed"]


# -- the file bridge (test_bridge.py) ---------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_filebridge_drives_capture_to_completion(impl, tmp_path):
    """``operator --watch-dir``: a Capture YAML in the directory runs to
    completion, its status is written beside the file, and removing the
    file deletes the CR."""
    p = pkg(impl)
    watch = tmp_path / "crds"
    watch.mkdir()
    store = p.store.CRDStore()
    bridge = p.bridge.FileBridge(store, str(watch), poll_interval=0.1)
    p.op.Operator(store, node_name="local", capture_manager=replay_manager(p),
                  status_sink=bridge.on_status).start()
    bridge.start()
    try:
        path = watch / "capture.yaml"
        path.write_text(yaml.safe_dump(capture_doc("grab-files",
                                                   host_path=str(tmp_path / "art"))))
        status_path = Path(str(path) + ".status")
        status: dict = {}

        def done() -> bool:
            if status_path.exists():
                try:
                    status.update(json.loads(status_path.read_text()))
                except ValueError:
                    return False
            return status.get("phase") in ("Completed", "Failed")

        wait_for(done, 30, "the status beside the file")
        assert status["phase"] == "Completed" and status["jobs_completed"] == 1
        assert os.path.exists(status["artifacts"][0])
        path.unlink()

        def gone() -> bool:
            try:
                store.get("Capture", "grab-files")
                return False
            except KeyError:
                return True

        wait_for(gone, 10, "the CR's deletion")
    finally:
        bridge.stop()


# -- leadership (test_leaderelection.py) -----------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_operator_follower_defers_until_leading(impl, tmp_path):
    p = pkg(impl)
    store = p.store.CRDStore()
    leading = {"v": False}
    op = p.op.Operator(store, node_name="local", capture_manager=replay_manager(p),
                       leading=lambda: leading["v"])
    op.start()
    cap = capture(p, "gated", host_path=str(tmp_path / "le-art"))
    store.apply("Capture", cap)
    op.wait_capture("gated", timeout=2.0)
    assert cap.status.phase == "Pending"  # the follower did nothing
    leading["v"] = True
    op.resync()
    op.wait_capture("gated", timeout=30.0)
    assert cap.status.phase == "Completed"


@pytest.mark.parametrize("impl", IMPLS)
def test_resync_fails_orphaned_running_captures(impl):
    p = pkg(impl)
    store, synced = p.store.CRDStore(), []
    op = p.op.Operator(store, node_name="local", status_sink=lambda kind, obj: synced.append(obj))
    op.start()
    cap = capture(p, "orphan", nodes=["elsewhere"], status={"phase": "Running",
                                                            "jobs_active": 2})
    store.apply("Capture", cap)
    op.resync()
    assert cap.status.phase == "Failed" and cap.status.jobs_active == 0
    assert cap.status.jobs_failed == 2 and "failover" in cap.status.message
    assert synced and synced[-1] is cap


@pytest.mark.parametrize("impl", IMPLS)
def test_wait_capture_returns_at_its_deadline_for_an_unknown_capture(impl):
    p = pkg(impl)
    op = p.op.Operator(p.store.CRDStore())
    t0 = time.monotonic()
    op.wait_capture("never", timeout=0.3)
    assert 0.3 <= time.monotonic() - t0 < 5


# -- one sequence of CRs on a fake apiserver ----------------------------------------
def finish(kube: FakeKube, n: int, outcome: str) -> None:
    """Play the kubelet: wait for ``n`` Jobs, then finish those without a
    status."""
    kube.wait(lambda: len(kube.objects.get(JOBS, {})) >= n, 30, f"{n} jobs")
    for doc in kube.items(JOBS):
        if not doc.get("status"):
            kube.modify(JOBS, dict(doc, status={outcome: 1}))


def phase(kube: FakeKube, name: str) -> str:
    doc = kube.objects.get(CAPTURES, {}).get(f"default/{name}", {})
    return (doc.get("status") or {}).get("phase", "")


SEQUENCE = [  # (name, nodes, host path?, extra spec, the kubelet's outcome, final phase)
    ("c-remote", ["node-b"], True, {}, "succeeded", "Completed"),
    ("c-fail", ["node-b"], True, {}, "failed", "Failed"),
    ("c-both", ["node-a", "node-b"], True, {"tcpdumpFilter": "port 80"}, "succeeded",
     "Completed"),
    ("c-noout", ["node-b"], False, {}, None, "Failed"),
    ("c-ghost-pods", [], True, {"captureTarget": {"podSelector": {"app": "x"}}}, None,
     "Failed"),
    ("c-nodesel", [], True, {"captureTarget": {"nodeSelector": {"zone": "z9"}}}, None,
     "Failed"),
]


def run_sequence(impl: str, tmp_path: Path) -> tuple[list, list]:
    p = pkg(impl)
    kube = FakeKube()
    parts: list = []
    try:
        for n in ("node-a", "node-b"):
            kube.add(NODES, node_doc(n), event=False)
        kc = kube.kubeconfig(tmp_path / f"{impl}.kc")
        store = p.store.CRDStore()
        bridge = p.bridge.KubeBridge(store, kc, kinds=["Capture"], retry_s=0.2)
        node_cache = p.cache.Cache()
        nodes = p.kw.CoreWatcher(node_cache, kc, include_pods=False, include_services=False,
                                 include_nodes=True, retry_s=0.2)
        elector = p.le.LeaderElector(p.kc.KubeClient(kc), identity="op-1",
                                     lease_duration_s=10.0, renew_period_s=0.5)
        op = p.op.Operator(store, node_name="node-a", capture_manager=replay_manager(p),
                           status_sink=bridge.patch_status, leading=elector.is_leader,
                           job_runner=p.jobs.KubeJobRunner(p.kc.KubeClient(kc), poll_s=0.05),
                           cluster_nodes=node_cache.list_nodes)
        elector.on_started_leading = op.resync
        parts = [nodes, bridge, elector]
        nodes.start()
        wait_for(lambda: len(node_cache.list_nodes()) == 2, 20, "the node inventory")
        elector.start()
        wait_for(elector.is_leader, 20, "the lease")
        op.start()
        bridge.start()
        random.seed(25)
        for name, target, host, spec, outcome, final in SEQUENCE:
            doc = capture_doc(name, nodes=target, host_path=str(tmp_path / impl) if host else "")
            for k, v in spec.items():
                doc["spec"][k] = v
            kube.add(CAPTURES, doc)
            if outcome is not None:
                finish(kube, len(kube.items(JOBS)) + 1, outcome)
            wait_for(lambda: phase(kube, name) in ("Completed", "Failed"), 30, f"{name}'s end")
            assert phase(kube, name) == final, (impl, name)
        statuses = {k: o.get("status") for k, o in sorted(kube.objects[CAPTURES].items())}
        writes = [(m, path, body) for m, path, body in kube.writes if "/leases" not in path]
        return statuses, writes
    finally:
        for part in parts:
            part._stop.set()
        kube.hangup()
        for part in parts:
            part.stop()
        kube.close()


def normalized(obj, tmp_path: Path):
    text = json.dumps(obj, sort_keys=True)
    text = text.replace(str(tmp_path / "port"), "<out>").replace(str(tmp_path / "reference"),
                                                                   "<out>")
    text = re.sub(r"-\d{14}\.tar\.gz", "-<stamp>.tar.gz", text)
    return re.sub(r'"retina.sh/capture-run": "[0-9a-f]+"', '"retina.sh/capture-run": "<run>"',
                  text)


def test_statuses_and_writes_equal_the_reference(tmp_path):
    got = {impl: run_sequence(impl, tmp_path) for impl in IMPLS}
    assert normalized(got["port"], tmp_path) == normalized(got["reference"], tmp_path)
    statuses, writes = got["port"]
    assert statuses["default/c-both"]["jobs_completed"] == 2
    assert statuses["default/c-fail"]["jobs_failed"] == 1
    assert "output location" in statuses["default/c-noout"]["message"]
    methods = [(m, path.rsplit("/", 2)[-2] if m == "PATCH" else path.rsplit("/", 1)[-1])
               for m, path, _ in writes]
    assert methods == [
        ("PATCH", "c-remote"), ("POST", "jobs"), ("PATCH", "c-remote"),
        ("PATCH", "c-fail"), ("POST", "jobs"), ("PATCH", "c-fail"),
        ("PATCH", "c-both"), ("POST", "jobs"), ("PATCH", "c-both"),
        ("PATCH", "c-noout"), ("PATCH", "c-ghost-pods"), ("PATCH", "c-nodesel")]


# -- the operator verb ---------------------------------------------------------------
REFUSALS = [
    [],
    ["--publish-cilium-crds", "--watch-dir", "{d}"],
    ["--install-crds", "--watch-dir", "{d}"],
    ["--leader-elect", "--watch-dir", "{d}"],
    ["--kubeconfig", "{d}/missing-kubeconfig"],
]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_operator_verb_refusals_equal_the_reference(case, tmp_path):
    argv = ["operator", *(a.format(d=tmp_path) for a in REFUSALS[case])]
    got = {}
    for impl in IMPLS:
        args = pkg(impl).cli.build_parser().parse_args(argv)
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            rc = args.fn(args)
        got[impl] = (rc, out.getvalue(), err.getvalue())
    assert got["port"] == got["reference"]
    assert got["port"][0] == 2 and got["port"][2].startswith("operator: ")


def test_operator_verb_parses_the_reference_flags():
    argv = ["operator", "--watch-dir", "/w", "--kubeconfig", "/k", "--in-cluster",
            "--namespace", "ns", "--publish-cilium-crds", "--leader-elect", "--install-crds",
            "--capture-image", "img:2", "--node-name", "n1", "--poll-interval", "0.5"]
    parsed = {impl: vars(pkg(impl).cli.build_parser().parse_args(argv)) for impl in IMPLS}
    for d in parsed.values():
        d.pop("fn")
    assert parsed["port"] == parsed["reference"]


def test_operator_verb_leads_fails_a_capture_and_releases_its_lease(tmp_path):
    """``python -m retina_tpu_torch operator --kubeconfig ... --leader-elect
    --install-crds --publish-cilium-crds`` as users start it: it installs
    the CRDs, publishes a pod's CiliumEndpoint, takes the Lease, reconciles
    a Capture that selects no pod to Failed on the apiserver, and on
    SIGTERM exits 0 and releases the Lease."""
    kube = FakeKube()
    try:
        for n in ("node-a", "node-b"):
            kube.add(NODES, node_doc(n), event=False)
        kube.add(PODS, pod_doc("web-0", "10.0.0.5"), event=False)
        kc = kube.kubeconfig(tmp_path / "kc")
        env = {k: v for k, v in os.environ.items() if not k.startswith("RETINA_")}
        log = tmp_path / "operator.log"
        with open(log, "w") as out:
            child = subprocess.Popen(
                [sys.executable, "-m", "retina_tpu_torch", "operator", "--kubeconfig", kc,
                 "--leader-elect", "--install-crds", "--publish-cilium-crds", "--namespace",
                 "default", "--node-name", "node-a"],
                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            lease = lambda: (kube.objects.get(LEASES, {}).get("default/retina-tpu-operator")  # noqa: E731
                             or {}).get("spec", {})
            kube.wait(lambda: lease().get("holderIdentity"), 120, "the child's lease")
            kube.add(CAPTURES, capture_doc("c-child", nodes=[], captureTarget={
                "podSelector": {"app": "none"}}))
            kube.wait(lambda: phase(kube, "c-child") == "Failed", 60, "the capture's Failed")
            msg = kube.objects[CAPTURES]["default/c-child"]["status"]["message"]
            assert "matched no pods" in msg
            kube.wait(lambda: "default/web-0" in kube.objects.get(CEPS, {}), 30,
                      "the pod's CiliumEndpoint")
            crds = {k.split("/")[-1] for k in kube.objects.get(CRDS, {})}
            assert {"captures.retina.sh", "metricsconfigurations.retina.sh"} <= crds
            child.send_signal(signal.SIGTERM)
            deadline = time.monotonic() + 60
            while child.poll() is None and time.monotonic() < deadline:
                kube.hangup()
                time.sleep(0.2)
            assert child.wait(timeout=10) == 0, log.read_text()[-3000:]
            assert lease().get("holderIdentity") == ""  # released for a fast failover
            assert "operator running" in log.read_text()
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=30)
    finally:
        kube.close()


# -- the agent beside the operator, on the CPU ---------------------------------------
SMALL = dict(batch_capacity=1 << 10, n_pods=1 << 8, cms_width=1 << 10, topk_slots=1 << 7,
             hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 10,
             identity_slots=1 << 10, flow_dict_slots=1 << 10, transfer_min_bucket=1 << 6,
             invertible_width=1 << 8, invertible_hi_width=1 << 6, window_seconds=0.5,
             metrics_interval_s=0.2, feed_workers=1, mesh_devices=1)


@pytest.fixture()
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


def test_local_capture_records_the_agents_stepped_blocks(tmp_path, fresh_port_metrics):
    """The Operator's local capture on an agent's engine (``ReplayProvider(
    engine=...)``): a RetinaEndpoint CR gives the capture's address a pod,
    a Capture selects it by label with a port filter, and the in-repo
    capture is replayed through a second packetparser while the window is
    open. The artifact's pcap equals the synchronous replay of the same
    capture through the same filter, byte for byte."""
    from retina_tpu_torch.capture.manager import CaptureManager
    from retina_tpu_torch.capture.providers import ReplayProvider
    from retina_tpu_torch.common import RetinaEndpoint
    from retina_tpu_torch.config import load_config
    from retina_tpu_torch.crd.types import Capture, CaptureOutput, CaptureSpec, CaptureTarget
    from retina_tpu_torch.daemon import Daemon
    from retina_tpu_torch.operator import CRDStore, Operator
    from retina_tpu_torch.plugins.packetparser import PacketParserPlugin
    from retina_tpu_torch.sources.pcapdecode import decode_pcap_bytes

    empty = tmp_path / "empty.pcap"
    empty.write_bytes(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))
    cfg = load_config(None, overrides=dict(
        SMALL, device_platform="cpu", api_server_addr="127.0.0.1:0", event_source="pcap",
        pcap_path=str(empty), pcap_loop=False, enabled_plugins=["packetparser"]), env={})
    d = Daemon(cfg, apiserver_host="127.0.0.1")
    assert d.cm.engine.device.type == "cpu"
    stop = threading.Event()
    t = threading.Thread(target=d.start, args=(stop,), daemon=True)
    t.start()
    try:
        wait_for(lambda: d.cm._ready.is_set() or not t.is_alive(), 120, "the agent's ready")
        eng = d.cm.engine
        store = CRDStore()
        op = Operator(store, cache=d.cm.cache, node_name="node-a",
                      capture_manager=CaptureManager(provider=ReplayProvider(engine=eng)))
        op.start()
        store.apply("RetinaEndpoint", RetinaEndpoint(
            name="lo-0", namespace="default", ips=("127.0.0.1",), labels=(("app", "lo"),),
            node="node-a"))
        n_obs = len(eng._observers)
        cap = Capture(name="grab", spec=CaptureSpec(
            target=CaptureTarget(pod_selector={"app": "lo"}),
            output=CaptureOutput(host_path=str(tmp_path / "art")), duration_s=3,
            tcpdump_filter="port 41443", include_metadata=False))
        store.apply("Capture", cap)
        wait_for(lambda: len(eng._observers) > n_obs, 10, "the capture's observer")
        rec = decode_pcap_bytes(PCAP.read_bytes()).records
        src = PacketParserPlugin(dataclasses.replace(cfg, pcap_path=str(PCAP)))
        src.set_sink(eng.sink)
        src.generate()
        src.compile()
        src.init()
        ev0 = eng.counts.events
        src.start(threading.Event())
        wait_for(lambda: eng.counts.events - ev0 == len(rec), 30, "the replay to be stepped")
        op.wait_capture("grab", timeout=30)
        assert cap.status.phase == "Completed", cap.status
        with tarfile.open(cap.status.artifacts[0]) as tf:
            (name,) = [n for n in tf.getnames() if n.endswith(".pcap")]
            artifact = tf.extractfile(name).read()
        # The synchronous replay: the same records, the same filter.
        sync = tmp_path / "sync.pcap"
        blocks = iter([rec])

        def once():
            nxt = next(blocks, None)
            if nxt is None:
                time.sleep(0.05)
                return rec[:0]
            return nxt

        ReplayProvider(source=once).capture(
            str(sync), filter_expr="(host 127.0.0.1) and (port 41443)", duration_s=0.2)
        assert artifact == sync.read_bytes()
        got = decode_pcap_bytes(artifact).records
        assert len(got) == 32 and len(got) < len(rec)
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive()
