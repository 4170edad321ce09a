"""The port's remote capture Jobs (``retina_tpu_torch/capture/k8s_jobs.py``)
against the reference's.

Every case of the reference's ``tests/test_k8s_jobs.py`` and the Job cases
of ``tests/test_capture_remote.py`` runs on both packages, on a fake
apiserver (``chip_smoke.FakeKube``) where the test plays the kubelet and
sets each Job's status. The port is held to the reference on the same
inputs: ``job_manifest`` equal document for document with ``random``
seeded (the name's suffix included), and the same writes to the apiserver
from the runner's create, wait (success, failure, a Job deleted under it,
the timeout's delete) and failover adoption."""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import types

import numpy as np
import pytest
import yaml

from _torch_kube import IMPLS, mod, wait_for
from chip_smoke import FakeKube

JOBS = "/apis/batch/v1/jobs"


def pkg(impl: str):
    return types.SimpleNamespace(
        jobs=mod(impl, "capture.k8s_jobs"), tr=mod(impl, "capture.translator"),
        mg=mod(impl, "capture.manager"), pr=mod(impl, "capture.providers"),
        crd=mod(impl, "crd.types"), common=mod(impl, "common"), op=mod(impl, "operator"),
        kc=mod(impl, "operator.kubeclient"), schema=mod(impl, "events.schema"))


def mk_job(p, node="remote-1", host_path="/var/cap", **kw):
    return p.tr.CaptureJob(**{**dict(
        capture_name="grab", namespace="default", node_name=node, filter_expr="(host 10.0.0.1)",
        duration_s=3, max_size_mb=50, packet_size_bytes=0, include_metadata=True,
        output={"host_path": host_path}), **kw})


def source(p):
    s = p.schema

    def src():
        time.sleep(0.05)
        rec = np.zeros((10, s.NUM_FIELDS), np.uint32)
        rec[:, s.F.SRC_IP] = s.ip_to_u32("10.0.0.5")
        rec[:, s.F.DST_IP] = s.ip_to_u32("10.0.0.9")
        return rec

    return src


@pytest.fixture
def kube(tmp_path):
    k = FakeKube()
    k.kc = k.kubeconfig(tmp_path / "kubeconfig")
    yield k
    k.close()


def runner(p, kube, **kw):
    return p.jobs.KubeJobRunner(p.kc.KubeClient(kube.kc), poll_s=0.05, **kw)


def finish(kube: FakeKube, n: int, outcome: str = "succeeded", names=None) -> list[str]:
    """Play the kubelet: wait for ``n`` Jobs, then give each one without a
    status (or each named one) the status ``{outcome: 1}``."""
    kube.wait(lambda: len(kube.objects.get(JOBS, {})) >= n, 30, f"{n} jobs")
    done = []
    for doc in kube.items(JOBS):
        name = doc["metadata"]["name"]
        if (names is None and not doc.get("status")) or (names and name in names):
            kube.modify(JOBS, dict(doc, status={outcome: 1}))
            done.append(name)
    return done


def capture_doc(name, nodes, status=None, **spec):
    doc = {"apiVersion": "retina.sh/v1alpha1", "kind": "Capture",
           "metadata": {"name": name, "namespace": "default"},
           "spec": {"captureTarget": {"nodeNames": nodes},
                    "outputConfiguration": {"hostPath": "/var/cap"}, "duration": 1, **spec}}
    if status:
        doc["status"] = status
    return doc


# -- the manifest -----------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_job_manifest_shape(impl):
    p = pkg(impl)
    doc = p.jobs.job_manifest(mk_job(p), image="retina-tpu:v9")
    assert doc["kind"] == "Job" and doc["spec"]["backoffLimit"] == 0
    pod = doc["spec"]["template"]["spec"]
    assert pod["nodeName"] == "remote-1" and pod["hostNetwork"] is True
    assert pod["restartPolicy"] == "Never"
    c = pod["containers"][0]
    assert c["image"] == "retina-tpu:v9"
    assert c["securityContext"]["capabilities"]["add"] == ["NET_ADMIN", "SYS_ADMIN"]
    assert "--filter" in c["args"] and "(host 10.0.0.1)" in c["args"]
    assert "--host-path" in c["args"] and "/var/cap" in c["args"]
    assert pod["volumes"][0]["hostPath"]["path"] == "/var/cap"
    assert c["volumeMounts"][0]["mountPath"] == "/var/cap"
    assert doc["metadata"]["labels"]["retina.sh/capture"] == "grab"
    assert len(doc["metadata"]["name"]) <= 63


@pytest.mark.parametrize("impl", IMPLS)
def test_job_manifest_rejects_inexpressible_outputs_and_names(impl):
    p = pkg(impl)
    with pytest.raises(ValueError, match="hostPath"):
        p.jobs.job_manifest(dataclasses.replace(mk_job(p), output={}))
    # Long capture+node names keep the suffix and never end in '-'.
    long_job = dataclasses.replace(mk_job(p, node="ip-10-0-12-34.us-west-2.compute.internal"),
                                   capture_name="a" * 40)
    doc = p.jobs.job_manifest(long_job)
    name = doc["metadata"]["name"]
    assert len(name) <= 63 and not name.endswith("-")
    assert name[-6] == "-" and name[-5:].isalnum()
    assert doc["spec"]["ttlSecondsAfterFinished"] == 3600
    args = p.jobs.job_manifest(dataclasses.replace(
        mk_job(p), packet_size_bytes=96, include_metadata=False))[
        "spec"]["template"]["spec"]["containers"][0]["args"]
    assert "--packet-size" in args and "96" in args and "--no-metadata" in args


@pytest.mark.parametrize("impl", IMPLS)
def test_blob_only_job_has_no_hostpath_volume(impl):
    p = pkg(impl)
    doc = p.jobs.job_manifest(mk_job(p, output={"blob_upload_secret": "my-blob-secret"}))
    pod = doc["spec"]["template"]["spec"]
    assert "volumes" not in pod
    c = pod["containers"][0]
    # The SAS URL is a credential: it reaches the pod only through the
    # Secret-injected BLOB_URL env, never in the args.
    assert "--host-path" not in c["args"] and "--blob-url" not in c["args"]
    (env,) = c["env"]
    assert env["name"] == "BLOB_URL"
    assert env["valueFrom"]["secretKeyRef"] == {"name": "my-blob-secret",
                                                "key": "blob-upload-url"}


@pytest.mark.parametrize("impl", IMPLS)
def test_s3_passthrough_args_and_secret_ref(impl):
    p = pkg(impl)
    args = p.jobs.job_manifest(mk_job(p, output={
        "host_path": "/tmp/caps", "s3_upload": {"bucket": "b", "region": "r", "key_prefix": "k",
                                                "endpoint": "http://e"}}))[
        "spec"]["template"]["spec"]["containers"][0]["args"]
    for flag, val in [("--s3-bucket", "b"), ("--s3-region", "r"), ("--s3-prefix", "k"),
                      ("--s3-endpoint", "http://e")]:
        assert args[args.index(flag) + 1] == val
    c = p.jobs.job_manifest(mk_job(p, output={"s3_upload": {"bucket": "b", "region": "r"}}))[
        "spec"]["template"]["spec"]["containers"][0]
    assert c["envFrom"] == [{"secretRef": {"name": "capture-s3-upload-secret"}}]


@pytest.mark.parametrize("impl", IMPLS)
def test_pvc_only_still_rejected(impl):
    p = pkg(impl)
    with pytest.raises(ValueError):
        p.jobs.job_manifest(mk_job(p, output={"persistent_volume_claim": "claim"}))


def test_job_manifests_equal_the_reference():
    """A seeded mix of jobs through both manifest builders, ``random``
    seeded alike: equal documents, the suffixes included, and equal
    refusals."""
    docs = {}
    for impl in IMPLS:
        p = pkg(impl)
        rng = random.Random(5)
        random.seed(25)
        out = []
        for i in range(40):
            output = rng.choice([
                {"host_path": f"/var/cap/{i}"}, {"blob_upload_secret": f"sec-{i}"},
                {"s3_upload": {"bucket": "b", "region": rng.choice(["", "eu-west-1"]),
                               "key_prefix": rng.choice(["", "p/q"]),
                               "endpoint": rng.choice(["", "http://minio:9000"]),
                               "secret_name": rng.choice(["", "s3-sec"])}},
                {"host_path": "/h", "blob_upload_secret": "b", "s3_upload": {"bucket": "x"}},
                {"persistent_volume_claim": "pvc"}, {}])
            job = mk_job(p, node=rng.choice(["n1", "ip-10-0-0-1.ec2.internal", "x" * 70]),
                         capture_name=rng.choice(["c", "capture-" + "y" * rng.randrange(60)]),
                         filter_expr=rng.choice(["", "(host 10.0.0.1 or host 10.0.0.2)"]),
                         duration_s=rng.choice([1, 60]), packet_size_bytes=rng.choice([0, 128]),
                         include_metadata=rng.random() < 0.5, output=output)
            try:
                out.append(p.jobs.job_manifest(job, image=rng.choice(["img:1", "r:2"]),
                                               run_id=rng.choice(["", "6650a1b2"])))
            except ValueError as e:
                out.append(f"ValueError: {e}")
        docs[impl] = out
    assert docs["port"] == docs["reference"]
    assert sum(isinstance(d, dict) for d in docs["port"]) >= 20


# -- the runner -------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_runner_creates_and_polls_to_success(impl, kube):
    p = pkg(impl)
    t = threading.Thread(target=finish, args=(kube, 1))
    t.start()
    assert runner(p, kube).run_job(mk_job(p)) == ["node://remote-1/var/cap"]
    t.join(30)
    (doc,) = kube.items(JOBS)
    assert doc["spec"]["template"]["spec"]["nodeName"] == "remote-1"


@pytest.mark.parametrize("impl", IMPLS)
def test_runner_raises_on_job_failure(impl, kube):
    p = pkg(impl)
    t = threading.Thread(target=finish, args=(kube, 1, "failed"))
    t.start()
    with pytest.raises(RuntimeError, match="failed on remote-1"):
        runner(p, kube).run_job(mk_job(p))
    t.join(30)


@pytest.mark.parametrize("impl", IMPLS)
def test_runner_fails_promptly_when_the_job_is_deleted(impl, kube):
    p = pkg(impl)
    r = runner(p, kube)
    name = r.create(mk_job(p))
    kube.delete(JOBS, kube.items(JOBS)[0])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="deleted externally"):
        r.wait(name, mk_job(p))
    assert time.monotonic() - t0 < 5


@pytest.mark.parametrize("impl", IMPLS)
def test_runner_deletes_the_job_at_its_deadline(impl, kube, monkeypatch):
    p = pkg(impl)
    monkeypatch.setattr(p.jobs, "TERMINATION_GRACE_S", 0.3)
    r = runner(p, kube)
    job = mk_job(p, duration_s=0)
    name = r.create(job)
    with pytest.raises(TimeoutError, match="did not complete"):
        r.wait(name, job)
    assert kube.items(JOBS) == []
    assert kube.writes[-1][0] == "DELETE" and kube.writes[-1][1].endswith(f"/jobs/{name}")


@pytest.mark.parametrize("impl", IMPLS)
def test_adopt_counts_only_the_newest_run(impl, kube):
    p = pkg(impl)
    r = runner(p, kube)
    assert r.adopt("grab", "default", timeout_s=1) is None  # nothing to adopt
    old = r.create(mk_job(p, node="n1"), run_id="00000001")
    new = [r.create(mk_job(p, node=n), run_id="00000002") for n in ("n1", "n2", "n3")]
    finish(kube, 4, "succeeded", names={old, new[0]})
    finish(kube, 4, "failed", names={new[1]})
    completed, failed, artifacts = r.adopt("grab", "default", timeout_s=0.5)
    # n3's Job never finished: failed at the deadline; the old run is ignored.
    assert (completed, failed) == (1, 2)
    assert artifacts == [f"node://n1 (adopted job {new[0]})"]


def test_runner_writes_equal_the_reference(tmp_path, monkeypatch):
    """Create, wait to success and to failure, a timeout's delete and an
    adoption, on one fresh apiserver per package: the same writes."""
    writes = {}
    for impl in IMPLS:
        p = pkg(impl)
        kube = FakeKube()
        kube.kc = kube.kubeconfig(tmp_path / f"{impl}.kc")
        try:
            random.seed(7)
            r = runner(p, kube, image="img:9")
            trace = []
            for outcome in ("succeeded", "failed"):
                t = threading.Thread(target=finish, args=(kube, len(trace) + 1, outcome))
                t.start()
                try:
                    trace.append(r.run_job(mk_job(p, node=f"n-{outcome}")))
                except RuntimeError as e:
                    trace.append(str(e))
                t.join(30)
            monkeypatch.setattr(p.jobs, "TERMINATION_GRACE_S", 0.2)
            job = mk_job(p, node="slow", duration_s=0)
            try:
                r.wait(r.create(job, run_id="0a"), job)
            except TimeoutError as e:
                trace.append(str(e))
            monkeypatch.undo()
            trace.append(r.adopt("grab", "default", timeout_s=0.3))
            writes[impl] = (trace, kube.writes)
        finally:
            kube.close()
    assert writes["port"] == writes["reference"]
    assert [m for m, _, _ in writes["port"][1]] == ["POST", "POST", "POST", "DELETE"]


# -- the operator over the runner ---------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_operator_fans_out_local_and_remote(impl, kube, tmp_path):
    """A capture on a local and a remote node runs both: the local one
    through the CaptureManager, the remote one as a Job."""
    p = pkg(impl)
    store = p.op.CRDStore()
    op = p.op.Operator(
        store, node_name="local",
        nodes=[p.common.RetinaNode(name="local"), p.common.RetinaNode(name="remote-1")],
        capture_manager=p.mg.CaptureManager(provider=p.pr.ReplayProvider(source=source(p))),
        job_runner=runner(p, kube))
    op.start()
    doc = capture_doc("both", ["local", "remote-1"])
    doc["spec"]["outputConfiguration"]["hostPath"] = str(tmp_path / "both-out")
    cap = p.crd.Capture.from_yaml(yaml.safe_dump(doc))
    store.apply("Capture", cap)
    finish(kube, 1)
    op.wait_capture("both", timeout=60.0)
    assert cap.status.phase == "Completed", cap.status
    assert (cap.status.jobs_completed, cap.status.jobs_failed) == (2, 0)
    assert any(a.startswith("node://remote-1") for a in cap.status.artifacts)
    assert any(str(tmp_path / "both-out") in a for a in cap.status.artifacts)
    assert len(kube.items(JOBS)) == 1


@pytest.mark.parametrize("impl", IMPLS)
def test_operator_defers_until_node_inventory_synced(impl, kube):
    """A capture that arrives before the node watcher's first LIST defers
    and reconciles once the inventory lands."""
    p = pkg(impl)
    store = p.op.CRDStore()
    inventory: list = []
    op = p.op.Operator(store, node_name="local", job_runner=runner(p, kube),
                       cluster_nodes=lambda: list(inventory))
    op.start()
    cap = p.crd.Capture.from_yaml(yaml.safe_dump(capture_doc("early", ["remote-1"])))
    store.apply("Capture", cap)
    time.sleep(1.0)
    assert cap.status.phase == "Pending"  # deferred, not Failed
    inventory.append(p.common.RetinaNode(name="remote-1"))
    finish(kube, 1)
    wait_for(lambda: cap.status.phase in ("Completed", "Failed"), 30, "the capture's end")
    assert cap.status.phase == "Completed", cap.status


@pytest.mark.parametrize("impl", IMPLS)
def test_resync_adopts_remote_jobs_from_dead_leader(impl, kube):
    """Failover: a Running capture whose leader died has live Jobs; the
    new leader adopts and settles them."""
    p = pkg(impl)
    r = runner(p, kube)
    r.create(mk_job(p))  # the dead leader's Job
    finish(kube, 1)
    store = p.op.CRDStore()
    op = p.op.Operator(store, node_name="local", job_runner=r)
    op.start()
    cap = p.crd.Capture.from_yaml(yaml.safe_dump(capture_doc(
        "grab", ["remote-1"], status={"phase": "Running", "jobs_active": 1})))
    store.apply("Capture", cap)
    op.resync()
    wait_for(lambda: cap.status.phase != "Running", 20, "the adoption")
    assert cap.status.phase == "Completed", cap.status
    assert cap.status.jobs_completed == 1
    assert any("adopted" in a for a in cap.status.artifacts)
