"""Operator reconcilers (port of retina_tpu/operator/operator.py).

Reference analogs:
- Capture controller (pkg/controllers/operator/capture/controller.go:102):
  Reconcile → TranslateCaptureToJobs → create Jobs → update Capture status
  from Job completion (:142). Here "Jobs" are local worker threads running
  the CaptureManager on the nodes this process represents.
- Pod controller (operator/pod/pod_controller.go): publishes slim
  RetinaEndpoint objects — here, applies them into the identity cache.
- MetricsConfiguration controller
  (metricsconfiguration_controller.go:109): → MetricsModule.Reconcile.
- TracesConfiguration controller → TracesModule.
- Leader election (operator deployment.go): single-process here; the
  Operator is the leader by construction.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from retina_tpu_torch.capture.manager import CaptureManager
from retina_tpu_torch.capture.translator import translate_capture_to_jobs
from retina_tpu_torch.common import RetinaEndpoint, RetinaNode
from retina_tpu_torch.crd.types import (
    Capture,
    MetricsConfiguration,
    TracesConfiguration,
    ValidationError,
)
from retina_tpu_torch.log import logger
from retina_tpu_torch.operator.store import CRDStore

KIND_CAPTURE = "Capture"
KIND_METRICS_CONF = "MetricsConfiguration"
KIND_TRACES_CONF = "TracesConfiguration"
KIND_ENDPOINT = "RetinaEndpoint"


class Operator:
    def __init__(
        self,
        store: CRDStore,
        cache: Any = None,
        metrics_module: Any = None,
        traces_module: Any = None,
        node_name: str = "local",
        nodes: Optional[list[RetinaNode]] = None,
        capture_manager: Optional[CaptureManager] = None,
        status_sink: Optional[Any] = None,
        leading: Optional[Any] = None,
        job_runner: Optional[Any] = None,
        cluster_nodes: Optional[Any] = None,
        storage_manager: Optional[Any] = None,
        secret_writer: Optional[Any] = None,
    ):
        """``status_sink(kind, obj)`` is called when an object's status
        settles — the kube backend passes KubeBridge.patch_status so
        status reaches the apiserver's status subresource
        (controller.go:142 updateCaptureStatusFromJobs analog).

        ``leading()`` gates side-effectful reconciles (captures): a
        follower replica watches but does not act (controller-runtime
        leader election analog, operator/cmd/root.go:21-39). Call
        :meth:`resync` when leadership is gained so objects applied
        while following get reconciled."""
        self._log = logger("operator")
        self.store = store
        self.cache = cache
        self.metrics_module = metrics_module
        self.traces_module = traces_module
        self.node_name = node_name
        self.nodes = nodes or [RetinaNode(name=node_name)]
        self.capture_manager = capture_manager or CaptureManager()
        self.status_sink = status_sink
        self.leading = leading or (lambda: True)
        # Remote execution (capture controller.go:102 creates batch/v1
        # Jobs per node): non-local CaptureJobs go through this runner
        # when present; without it they are skipped as before.
        self.job_runner = job_runner
        # Live cluster node inventory for capture translation (the kube
        # backend wires a node watcher); falls back to the static list.
        self.cluster_nodes = cluster_nodes
        # Managed capture storage (capture/managed.py; reference
        # controller.go:310-350): when a Capture names no output and a
        # manager is configured, the operator mints a write-only
        # container SAS. ``secret_writer(namespace, name, sas_url) ->
        # secret name`` stores it as a k8s Secret (kube mode); without
        # one the SAS rides in the spec directly (in-process mode, where
        # BlobOutput accepts a literal URL).
        self.storage_manager = storage_manager
        self.secret_writer = secret_writer
        # Bounded not-yet-synced deferrals per capture key.
        self._defers: dict[str, int] = {}
        self.max_defers = 24  # x5s = 2 min of inventory warm-up
        self._jobs: dict[str, threading.Thread] = {}
        self._jobs_lock = threading.Lock()

    def _sync_status(self, kind: str, obj: Any) -> None:
        if self.status_sink is not None:
            try:
                self.status_sink(kind, obj)
            except Exception:  # noqa: BLE001
                self._log.exception("status sink failed for %s/%s",
                                    kind, getattr(obj, "name", "?"))

    def start(self) -> None:
        """Register all watches (controller manager start analog)."""
        self.store.watch(KIND_CAPTURE, self._on_capture)
        self.store.watch(KIND_METRICS_CONF, self._on_metrics_conf)
        self.store.watch(KIND_TRACES_CONF, self._on_traces_conf)
        self.store.watch(KIND_ENDPOINT, self._on_endpoint)
        self._log.info("operator started (node=%s)", self.node_name)

    # -- capture reconcile (controller.go:102) -------------------------
    def resync(self) -> None:
        """Leadership-gained hook: reconcile every Pending capture, and
        fail captures stuck Running from a dead leader — their "jobs"
        were threads in that process, so nobody will ever complete them
        (unlike the reference, whose k8s Jobs outlive the operator)."""
        for cap in self.store.list(KIND_CAPTURE):
            if cap.status.phase == "Running":
                key = f"{cap.namespace}/{cap.name}"
                with self._jobs_lock:
                    mine = self._jobs.get(key)
                if mine is None or not mine.is_alive():
                    self._handle_orphan(cap)
                continue
            self._on_capture("applied", cap)

    def _handle_orphan(self, cap: Capture) -> None:
        """A Running capture with no live local thread: the old leader
        died. Its LOCAL jobs died with it, but any remote batch/v1 Jobs
        are still running on the cluster — adopt those instead of
        failing them (they'd otherwise complete invisibly)."""

        def settle(completed: int, failed: int,
                   artifacts: list[str], msg: str) -> None:
            cap.status.jobs_completed += completed
            cap.status.jobs_failed += failed
            cap.status.jobs_active = 0
            cap.status.artifacts.extend(artifacts)
            cap.status.message = msg
            cap.status.phase = (
                "Failed" if failed or not completed else "Completed"
            )
            self._sync_status(KIND_CAPTURE, cap)

        if self.job_runner is None:
            settle(0, cap.status.jobs_active, [],
                   "orphaned by leader failover; re-apply to retry")
            self._log.warning("capture %s orphaned by failover", cap.name)
            return

        orphaned = cap.status.jobs_active

        def adopt() -> None:
            res = self.job_runner.adopt(cap.name, cap.namespace)
            if res is None:
                settle(0, orphaned, [],
                       "orphaned by leader failover; re-apply to retry")
                return
            completed, failed, artifacts = res
            # The dead leader's LOCAL jobs have no batch/v1 Job to
            # adopt — whatever the adoption didn't account for was lost
            # with that process and counts as failed.
            lost = max(0, orphaned - completed - failed)
            self._log.info(
                "capture %s: adopted %d job(s) from dead leader "
                "(%d failed, %d lost local)", cap.name,
                completed + failed, failed, lost,
            )
            settle(completed, failed + lost, artifacts,
                   "adopted from failed-over leader"
                   + (f"; {lost} local job(s) lost with it" if lost
                      else ""))

        # Registered under the capture key like a normal job thread so a
        # leadership flap cannot start a second adoption (double
        # counting); _on_capture's dedupe and this share _jobs.
        t = threading.Thread(target=adopt, daemon=True,
                             name=f"adopt-{cap.name}")
        key = f"{cap.namespace}/{cap.name}"
        with self._jobs_lock:
            prev = self._jobs.get(key)
            if prev is not None and prev.is_alive():
                return  # adoption (or a real run) already in flight
            self._jobs[key] = t
        t.start()

    def _on_capture(self, event: str, cap: Capture) -> None:
        if event != "applied" or cap.status.phase not in ("Pending",):
            return
        if not self.leading():
            return  # follower: watch only; resync() runs these later
        # Dedupe: a watch reconnect can re-LIST an in-flight capture whose
        # apiserver copy still says Pending; don't start a duplicate job.
        key = f"{cap.namespace}/{cap.name}"
        with self._jobs_lock:
            prev = self._jobs.get(key)
            if prev is not None and prev.is_alive():
                return
        def defer(reason: str) -> bool:
            """Bounded retry while the node watcher warms up; returns
            False when the budget is spent (caller then Fails)."""
            n = self._defers.get(key, 0)
            if n >= self.max_defers:
                return False
            self._defers[key] = n + 1
            self._log.info("capture %s deferred (%d/%d): %s", cap.name,
                           n + 1, self.max_defers, reason)
            t = threading.Timer(
                5.0, lambda: self._on_capture("applied", cap))
            t.daemon = True
            t.start()
            return True

        # Managed storage: a Capture with NO output location gets a
        # provisioned container + write-only SAS before translation
        # (reference controller.go:310-350 creates the secret, sets
        # Spec.OutputConfiguration.BlobUpload, then creates jobs).
        out = cap.spec.output
        if self.storage_manager is not None and out.is_empty():
            try:
                sas = self.storage_manager.create_container_sas_url(
                    cap.namespace, cap.spec.duration_s
                )
                if self.secret_writer is not None:
                    out.blob_upload_secret = self.secret_writer(
                        cap.namespace, f"capture-blob-{cap.name}", sas
                    )
                else:
                    out.blob_upload_secret = sas
                self._sync_status(KIND_CAPTURE, cap)
            except Exception as e:  # provisioning failed: Fail loudly
                cap.status.phase = "Failed"
                cap.status.message = f"managed storage: {e}"
                self._log.warning(
                    "capture %s managed storage failed: %s", cap.name, e
                )
                self._sync_status(KIND_CAPTURE, cap)
                return

        try:
            pods = (
                [ep for ep in self.cache.index_label_map().values()]
                if self.cache else []
            )
            if self.cluster_nodes is not None:
                inventory = self.cluster_nodes()
                if not inventory:
                    # Node watcher not synced yet (operator just booted
                    # and the kube bridge replayed captures first).
                    if defer("node inventory empty"):
                        return
                    inventory = self.nodes  # spent: fail loudly below
            else:
                inventory = self.nodes
            jobs = translate_capture_to_jobs(cap, inventory, pods)
        except ValidationError as e:
            if ("unknown nodes" in str(e)
                    and self.cluster_nodes is not None
                    and defer(f"inventory may be partial: {e}")):
                # A mid-LIST inventory can be non-empty but incomplete;
                # real unknown nodes still Fail once the budget is spent.
                return
            cap.status.phase = "Failed"
            cap.status.message = str(e)
            self._log.warning("capture %s rejected: %s", cap.name, e)
            self._sync_status(KIND_CAPTURE, cap)
            return
        self._defers.pop(key, None)
        # With a job runner, only THIS process's node runs in-process —
        # every other node gets a batch/v1 Job. Without one, self.nodes
        # is "nodes this process represents" (single-process mode).
        our_nodes = (
            {self.node_name} if self.job_runner is not None
            else {n.name for n in self.nodes}
        )
        local = [j for j in jobs if j.node_name in our_nodes]
        # Remote nodes get batch/v1 Jobs through the runner
        # (controller.go:102); without a runner they are skipped, as in
        # the single-process deployments.
        remote = (
            [j for j in jobs if j.node_name not in our_nodes]
            if self.job_runner is not None else []
        )
        cap.status.phase = "Running"
        cap.status.jobs_active = len(local) + len(remote)
        self._log.info(
            "capture %s: %d job(s) (%d local, %d remote)", cap.name,
            len(jobs), len(local), len(remote),
        )
        # Publish Running immediately so backends see the in-flight phase
        # (and a watch echo of this write is a no-op, not a re-trigger).
        self._sync_status(KIND_CAPTURE, cap)

        def run_all() -> None:
            failed = 0

            def account(fn, job) -> None:
                nonlocal failed
                try:
                    cap.status.artifacts.extend(fn(job))
                    cap.status.jobs_completed += 1
                except Exception as e:  # noqa: BLE001
                    self._log.exception("capture job %s failed",
                                        job.job_name())
                    failed += 1
                    cap.status.jobs_failed += 1
                    cap.status.message = str(e)
                cap.status.jobs_active -= 1

            # Create EVERY remote Job first so the per-node capture
            # windows overlap (controller.go creates all Jobs in one
            # reconcile), then run local capture, then wait the remotes.
            # The run id scopes a future failover adoption to THIS
            # generation of Jobs.
            run_id = f"{int(time.time()):x}"
            created: list[tuple[str, Any]] = []
            for job in remote:
                try:
                    created.append(
                        (self.job_runner.create(job, run_id=run_id), job))
                except Exception as e:  # noqa: BLE001
                    self._log.exception("capture job create failed: %s",
                                        job.job_name())
                    failed += 1
                    cap.status.jobs_failed += 1
                    cap.status.message = str(e)
                    cap.status.jobs_active -= 1
            for job in local:
                account(self.capture_manager.run_job, job)
            for name, job in created:
                account(lambda j, n=name: self.job_runner.wait(n, j), job)
            cap.status.phase = "Failed" if failed else "Completed"
            self._sync_status(KIND_CAPTURE, cap)

        t = threading.Thread(
            target=run_all, name=f"capture-{cap.name}", daemon=True
        )
        with self._jobs_lock:
            self._jobs[key] = t
        t.start()

    def wait_capture(self, name: str, timeout: float = 120.0,
                     namespace: str = "default") -> None:
        """Block until the capture's job thread finishes.

        The apply -> watch -> reconcile hop is asynchronous, so the job
        thread may not EXIST yet when a caller that just applied the CR
        waits on it — poll for it up to the deadline instead of treating
        absence as completion (that race intermittently returned before
        the capture ran)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._jobs_lock:
                t = self._jobs.get(f"{namespace}/{name}")
            if t is not None:
                t.join(max(0.0, deadline - time.monotonic()))
                return
            if time.monotonic() >= deadline:
                return
            time.sleep(0.02)

    # -- config reconciles ---------------------------------------------
    def _on_metrics_conf(self, event: str, conf: MetricsConfiguration) -> None:
        if self.metrics_module is None:
            return
        if event == "applied":
            self.metrics_module.reconcile(conf)
        elif event == "deleted":
            self.metrics_module.reconcile(MetricsConfiguration.default())

    def _on_traces_conf(self, event: str, conf: TracesConfiguration) -> None:
        if self.traces_module is None:
            return
        if event == "deleted":
            # Deleting the CR must deactivate sampling (reconcile back
            # to the empty default), mirroring _on_metrics_conf.
            self.traces_module.reconcile(TracesConfiguration())
            return
        if event == "applied":
            self.traces_module.reconcile(conf)

    # -- endpoint publishing (pod_controller.go analog) ----------------
    def _on_endpoint(self, event: str, ep: RetinaEndpoint) -> None:
        if self.cache is None:
            return
        if event == "applied":
            self.cache.update_endpoint(ep)
        elif event == "deleted":
            self.cache.delete_endpoint(ep.key())
