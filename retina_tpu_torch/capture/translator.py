"""Capture spec → per-node jobs + packet-filter synthesis (port of
retina_tpu/capture/translator.py).

Reference analog: pkg/capture/crd_to_job.go —
``TranslateCaptureToJobs`` (:352-465): validate the Capture, resolve its
node/pod selectors against the cluster to a node set
(``CalculateCaptureTargetsOnNode`` :622-718), synthesize the
tcpdump/netsh filter from target pod IPs and ports (:483-540, :719-841),
and render one job per node (:382-464). Here the "cluster" is the
identity cache + a node inventory, and a job is a descriptor the operator
(retina_tpu_torch/operator) runs in-process or as a batch/v1 Job.
"""

from __future__ import annotations

import dataclasses

from retina_tpu_torch.common import RetinaEndpoint, RetinaNode
from retina_tpu_torch.crd.types import Capture, ValidationError


@dataclasses.dataclass
class CaptureJob:
    """One node's capture work item (the batchv1.Job analog)."""

    capture_name: str
    namespace: str
    node_name: str
    filter_expr: str  # tcpdump-syntax packet filter
    duration_s: int
    max_size_mb: int
    packet_size_bytes: int
    output: "dict[str, str]"
    include_metadata: bool = True

    def job_name(self) -> str:
        return f"capture-{self.capture_name}-{self.node_name}"


def _match_labels(selector: dict[str, str], labels: dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def select_pods(
    capture: Capture,
    pods: list[RetinaEndpoint],
    namespace_labels: dict[str, dict[str, str]] | None = None,
) -> list[RetinaEndpoint]:
    """Pod-selector targeting (CalculateCaptureTargetsOnNode pod arm)."""
    t = capture.spec.target
    out = []
    ns_labels = namespace_labels or {}
    for pod in pods:
        if t.namespace_selector:
            if not _match_labels(
                t.namespace_selector, ns_labels.get(pod.namespace, {})
            ):
                continue
        elif pod.namespace != capture.namespace:
            # Without a namespace selector, pod selection is scoped to the
            # Capture's own namespace (reference behavior).
            continue
        if t.pod_selector and not _match_labels(
            t.pod_selector, pod.labels_dict()
        ):
            continue
        out.append(pod)
    return out


def select_nodes(
    capture: Capture,
    nodes: list[RetinaNode],
    node_labels: dict[str, dict[str, str]] | None = None,
    target_pods: list[RetinaEndpoint] | None = None,
) -> list[str]:
    """Node targeting: explicit names, node selector, or the nodes that
    host the selected pods (crd_to_job.go:622-718)."""
    t = capture.spec.target
    if t.node_names:
        known = {n.name for n in nodes}
        missing = [n for n in t.node_names if n not in known]
        if missing:
            raise ValidationError(f"unknown nodes: {missing}")
        return list(t.node_names)
    if t.node_selector:
        labels = node_labels or {}
        sel = [
            n.name for n in nodes
            if _match_labels(t.node_selector, labels.get(n.name, {}))
        ]
        if not sel:
            raise ValidationError("node selector matched no nodes")
        return sel
    # pod-based: nodes hosting the targeted pods
    node_set = sorted({p.node for p in (target_pods or []) if p.node})
    if not node_set:
        raise ValidationError("capture target matched no pods/nodes")
    return node_set


def synthesize_filter(
    pod_ips: list[str],
    extra_filter: str = "",
    ports: list[int] | None = None,
) -> str:
    """tcpdump filter synthesis (crd_to_job.go:483-540,719-841): OR the
    target pod IPs, AND optional ports, AND any raw extra filter."""
    clauses = []
    if pod_ips:
        hosts = " or ".join(f"host {ip}" for ip in sorted(set(pod_ips)))
        clauses.append(f"({hosts})")
    if ports:
        ps = " or ".join(f"port {p}" for p in sorted(set(ports)))
        clauses.append(f"({ps})")
    if extra_filter:
        clauses.append(f"({extra_filter})")
    return " and ".join(clauses)


def translate_capture_to_jobs(
    capture: Capture,
    nodes: list[RetinaNode],
    pods: list[RetinaEndpoint],
    node_labels: dict[str, dict[str, str]] | None = None,
    namespace_labels: dict[str, dict[str, str]] | None = None,
) -> list[CaptureJob]:
    """The TranslateCaptureToJobs entry point (:352)."""
    capture.validate()
    if capture.spec.output.is_empty():
        # Admission is lenient (the operator's managed-storage reconcile
        # may fill the output in); by job-creation time SOME output must
        # exist or the capture artifacts would have nowhere to go.
        raise ValidationError(
            "capture needs at least one output location "
            "(or managed storage enabled)"
        )
    t = capture.spec.target
    if t.pod_selector or t.namespace_selector:
        target_pods = select_pods(capture, pods, namespace_labels)
        node_names = select_nodes(capture, nodes, node_labels, target_pods)
        pod_ips = [ip for p in target_pods for ip in p.ips]
    else:
        target_pods = []
        node_names = select_nodes(capture, nodes, node_labels)
        pod_ips = []
    filt = synthesize_filter(pod_ips, capture.spec.tcpdump_filter)
    out = dataclasses.asdict(capture.spec.output)
    return [
        CaptureJob(
            capture_name=capture.name,
            namespace=capture.namespace,
            node_name=node,
            filter_expr=filt,
            duration_s=capture.spec.duration_s,
            max_size_mb=capture.spec.max_capture_size_mb,
            packet_size_bytes=capture.spec.packet_size_bytes,
            output=out,
            include_metadata=capture.spec.include_metadata,
        )
        for node in node_names
    ]
