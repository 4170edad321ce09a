"""Remote capture execution via Kubernetes Jobs (port of
retina_tpu/capture/k8s_jobs.py).

Reference analog: pkg/capture/crd_to_job.go:112-170 (initJobTemplate) +
pkg/controllers/operator/capture/controller.go:102-142 — the operator
translates a Capture into one batch/v1 Job per target node; each Job
runs the captureworkload binary host-network on that node, and capture
status is derived from Job completion.

Here the "captureworkload binary" is the same retina-tpu image running
``capture create`` (cli.py): the manifest builder is pure (testable
without a cluster), and :class:`KubeJobRunner` creates the Job through
the shared KubeClient and polls its status to completion — filling the
role Job informers fill for the reference controller.
"""

from __future__ import annotations

import json
import random
import string
import time
import urllib.error
from typing import Optional

from retina_tpu_torch.capture.translator import CaptureJob
from retina_tpu_torch.log import logger
from retina_tpu_torch.operator.kubeclient import KubeClient

BATCH_V1 = "/apis/batch/v1"
DEFAULT_IMAGE = "retina-tpu:latest"
# Reference: capture pods may run 30 min past duration so uploads finish.
TERMINATION_GRACE_S = 1800


def _suffix() -> str:
    return "".join(random.choices(string.ascii_lowercase + string.digits,
                                  k=5))


def job_manifest(job: CaptureJob, image: str = DEFAULT_IMAGE,
                 run_id: str = "") -> dict:
    """CaptureJob → batch/v1 Job dict (initJobTemplate analog):
    host-network pod pinned to the node, NET_ADMIN/SYS_ADMIN only,
    backoffLimit 0, tiny resource envelope. hostPath outputs mount the
    node directory; blob/S3 outputs pass straight through to the in-Job
    workload, which uploads over REST (capture/remote.py) — matching the
    reference's blob.go/s3.go upload-from-the-capture-pod flow.

    Raises ValueError for outputs the in-Job workload cannot express
    (PVC-only without a hostPath) — a clear reconcile failure beats an
    argparse crash inside the pod."""
    out = job.output or {}
    host_path = out.get("host_path", "")
    blob_url = out.get("blob_upload_secret", "")
    s3 = out.get("s3_upload") or {}
    if not (host_path or blob_url or s3):
        raise ValueError(
            "remote capture jobs need a hostPath, blob, or s3 output "
            "(PVC-only outputs are not expressible by the in-job "
            "capture workload)"
        )
    args = [
        "capture", "create",
        "--name", job.capture_name,
        "--namespace", job.namespace,
        "--node-names", job.node_name,
        "--duration", str(job.duration_s),
        "--max-size", str(job.max_size_mb),
    ]
    env = []
    env_from = []
    if host_path:
        args += ["--host-path", host_path]
    if blob_url:
        # blob_upload_secret names a Kubernetes Secret (reference
        # contract: secret "capture-blob-upload-secret", key
        # "blob-upload-url", job_specification.go:23-27). The SAS URL is
        # a bearer credential — it must reach the pod via the Secret,
        # NEVER in plain-text container args.
        env.append({
            "name": "BLOB_URL",
            "valueFrom": {"secretKeyRef": {
                "name": blob_url, "key": "blob-upload-url",
            }},
        })
    if s3:
        args += ["--s3-bucket", s3.get("bucket", ""),
                 "--s3-region", s3.get("region", "")]
        if s3.get("key_prefix"):
            args += ["--s3-prefix", s3["key_prefix"]]
        if s3.get("endpoint"):
            args += ["--s3-endpoint", s3["endpoint"]]
        # AWS credentials come from a Secret carrying the standard env
        # names (AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY[/SESSION_TOKEN]).
        env_from.append({"secretRef": {
            "name": s3.get("secret_name", "capture-s3-upload-secret"),
        }})
    if job.filter_expr:
        args += ["--filter", job.filter_expr]
    if job.packet_size_bytes:
        args += ["--packet-size", str(job.packet_size_bytes)]
    if not job.include_metadata:
        args.append("--no-metadata")
    container = {
        "name": "capture",
        "image": image,
        "imagePullPolicy": "IfNotPresent",
        "args": args,
        **({"env": env} if env else {}),
        **({"envFrom": env_from} if env_from else {}),
        "securityContext": {
            "capabilities": {"add": ["NET_ADMIN", "SYS_ADMIN"]},
        },
        "resources": {
            "requests": {"cpu": "10m", "memory": "64Mi"},
            "limits": {"memory": "300Mi"},
        },
    }
    spec = {
        "nodeName": job.node_name,
        "hostNetwork": True,
        "restartPolicy": "Never",
        "terminationGracePeriodSeconds": TERMINATION_GRACE_S,
        "tolerations": [{"operator": "Exists"}],
        "containers": [container],
    }
    if host_path:
        spec["volumes"] = [{
            "name": "capture-output",
            "hostPath": {"path": host_path, "type": "DirectoryOrCreate"},
        }]
        container["volumeMounts"] = [{
            "name": "capture-output", "mountPath": host_path,
        }]
    # DNS-1123 safety: truncate the base, never the uniqueness suffix,
    # and never leave a trailing '-'.
    base = f"{job.capture_name}-{job.node_name}"[:56].rstrip("-.")
    labels = {
        "app.kubernetes.io/name": "retina-tpu",
        "retina.sh/capture": job.capture_name,
    }
    if run_id:
        # Scopes failover adoption to ONE reconcile generation: TTL'd
        # Jobs from a previous run of the same capture name must not be
        # re-counted by a new leader.
        labels["retina.sh/capture-run"] = run_id
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": f"{base}-{_suffix()}",
            "namespace": job.namespace,
            "labels": labels,
        },
        "spec": {
            "backoffLimit": 0,
            # Finished capture Jobs + pods must not pile up in etcd.
            "ttlSecondsAfterFinished": 3600,
            "template": {
                "metadata": {
                    "labels": {"retina.sh/capture": job.capture_name},
                },
                "spec": spec,
            },
        },
    }


class KubeJobRunner:
    """Create a capture Job on the apiserver and wait for completion —
    the remote half of Operator capture reconciliation (local nodes run
    the CaptureManager in-process)."""

    def __init__(self, client: KubeClient, image: str = DEFAULT_IMAGE,
                 poll_s: float = 2.0):
        self._log = logger("kubejobs")
        self.client = client
        self.image = image
        self.poll_s = poll_s

    def create(self, job: CaptureJob, run_id: str = "") -> str:
        """POST the Job; returns its name. Split from waiting so a
        multi-node capture creates EVERY Job up front — the per-node
        capture windows must overlap, not run back to back."""
        doc = job_manifest(job, image=self.image, run_id=run_id)
        name = doc["metadata"]["name"]
        self.client.request(
            self.client.url(BATCH_V1, "jobs", namespace=job.namespace),
            method="POST", body=json.dumps(doc).encode(), timeout=30,
        ).close()
        self._log.info("created capture job %s on node %s",
                       name, job.node_name)
        return name

    def wait(self, name: str, job: CaptureJob) -> list[str]:
        """Poll the Job to a terminal state. The deadline budgets the
        full post-capture grace the manifest grants for packaging/
        uploads (TERMINATION_GRACE_S), not just the capture duration;
        on timeout the Job is deleted best-effort so it cannot linger
        unkilled."""
        deadline = time.monotonic() + job.duration_s + TERMINATION_GRACE_S
        url = self.client.url(BATCH_V1, "jobs", namespace=job.namespace,
                              suffix=f"/{name}")
        while time.monotonic() < deadline:
            try:
                with self.client.request(url, timeout=30) as r:
                    st = json.load(r).get("status", {}) or {}
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    # Deleted from under us (kubectl, namespace cleanup):
                    # fail promptly, don't poll a tombstone for 30 min.
                    raise RuntimeError(
                        f"capture job {name} was deleted externally"
                    ) from e
                st = {}
            if st.get("succeeded"):
                out = job.output or {}
                hints = []
                if out.get("host_path"):
                    hints.append(
                        f"node://{job.node_name}{out['host_path']}"
                    )
                if out.get("blob_upload_secret"):
                    hints.append("blob://(container SAS)")
                s3 = out.get("s3_upload") or {}
                if s3.get("bucket"):
                    hints.append(
                        f"s3://{s3['bucket']}/"
                        f"{s3.get('key_prefix', 'retina/captures')}"
                    )
                return hints
            if st.get("failed"):
                raise RuntimeError(
                    f"capture job {name} failed on {job.node_name}"
                )
            time.sleep(self.poll_s)
        try:
            self.client.request(url, method="DELETE", timeout=30).close()
        except Exception:  # noqa: BLE001, RT101 — best-effort delete; the TimeoutError below surfaces the failure
            pass
        raise TimeoutError(
            f"capture job {name} did not complete within "
            f"{job.duration_s + TERMINATION_GRACE_S}s (deleted)"
        )

    def run_job(self, job: CaptureJob) -> list[str]:
        """Blocking create+wait (single-job convenience)."""
        return self.wait(self.create(job), job)

    # -- leader-failover adoption --------------------------------------
    def adopt(self, capture_name: str, namespace: str,
              timeout_s: float = TERMINATION_GRACE_S,
              ) -> Optional[tuple[int, int, list[str]]]:
        """Find Jobs a dead leader created for ``capture_name`` (by the
        retina.sh/capture label) and wait them out. Returns
        (completed, failed, artifacts), or None when no Jobs exist —
        remote batch/v1 Jobs outlive the leader, unlike its local
        capture threads, so failover must adopt rather than fail them."""
        url = self.client.url(
            BATCH_V1, "jobs", namespace=namespace,
            query=f"labelSelector=retina.sh/capture%3D{capture_name}",
        )
        try:
            with self.client.request(url, timeout=30) as r:
                items = json.load(r).get("items", [])
        except Exception as e:  # noqa: BLE001
            self._log.warning("job adoption list failed: %s", e)
            return None
        if not items:
            return None
        # Adopt only the NEWEST generation: TTL keeps a previous run's
        # finished Jobs around for up to an hour under the same capture
        # label, and those must not be re-counted.
        runs = [it.get("metadata", {}).get("labels", {})
                .get("retina.sh/capture-run", "") for it in items]
        newest = max(runs)
        items = [it for it, r in zip(items, runs) if r == newest]
        completed = failed = 0
        artifacts: list[str] = []
        deadline = time.monotonic() + timeout_s
        pending = {it["metadata"]["name"]: it for it in items}
        while pending and time.monotonic() < deadline:
            for name in list(pending):
                ju = self.client.url(BATCH_V1, "jobs",
                                     namespace=namespace,
                                     suffix=f"/{name}")
                try:
                    with self.client.request(ju, timeout=30) as r:
                        doc = json.load(r)
                except urllib.error.HTTPError as e:
                    if e.code == 404:  # deleted mid-adoption
                        failed += 1
                        del pending[name]
                    continue
                except Exception:  # noqa: BLE001
                    continue
                st = doc.get("status", {}) or {}
                if st.get("succeeded"):
                    completed += 1
                    node = (doc.get("spec", {}).get("template", {})
                            .get("spec", {}).get("nodeName", "?"))
                    artifacts.append(f"node://{node} (adopted job {name})")
                    del pending[name]
                elif st.get("failed"):
                    failed += 1
                    del pending[name]
            if pending:
                time.sleep(self.poll_s)
        failed += len(pending)  # still not terminal at deadline
        return completed, failed, artifacts
