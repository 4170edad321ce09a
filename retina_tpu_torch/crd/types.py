"""API types: MetricsConfiguration, Capture, TracesConfiguration (port of
retina_tpu/crd/types.py).

Reference analogs:
- MetricsConfiguration (crd/api/v1alpha1/metricsconfiguration_types.go:
  28-95): contextOptions (metricName + src/dst label dimensions) and
  namespace include/exclude — reconciled into the running metrics module.
- Capture (capture_types.go:53-201): targets (node/pod selectors), packet
  filters, duration/size limits, output locations; status conditions
  (:22-52). The agent's CRD bridge decodes them; the operator that runs
  them is not ported yet (ROADMAP §1 item 7).
- TracesConfiguration (tracesconfiguration_types.go:59-125), the
  reference's stub-parity CRD that ``module/traces.py`` compiles into
  matchers.

Validation mirrors crd/api/v1alpha1/validations/. PyYAML is imported only
by the ``from_yaml`` constructors.
"""

from __future__ import annotations

import dataclasses
from typing import Any


class ValidationError(ValueError):
    pass


# ---------------------------------------------------------------------------
# MetricsConfiguration

KNOWN_METRICS = ("forward", "drop", "tcpflags", "tcpretrans", "dns", "latency",
                 "distinct_sources", "flows", "services")
KNOWN_LABELS = ("ip", "namespace", "podname", "workload", "port", "protocol")


@dataclasses.dataclass
class MetricsContextOptions:
    metric_name: str
    src_labels: list[str] = dataclasses.field(default_factory=list)
    dst_labels: list[str] = dataclasses.field(default_factory=list)
    additional_labels: list[str] = dataclasses.field(default_factory=list)

    def validate(self) -> None:
        if self.metric_name not in KNOWN_METRICS:
            raise ValidationError(
                f"unknown metric {self.metric_name!r} (known: {KNOWN_METRICS})"
            )
        for lbl in (*self.src_labels, *self.dst_labels):
            if lbl not in KNOWN_LABELS:
                raise ValidationError(
                    f"unknown label {lbl!r} for metric {self.metric_name}"
                )


@dataclasses.dataclass
class MetricsNamespaces:
    include: list[str] = dataclasses.field(default_factory=list)
    exclude: list[str] = dataclasses.field(default_factory=list)

    def validate(self) -> None:
        if self.include and self.exclude:
            raise ValidationError(
                "namespaces.include and namespaces.exclude are exclusive"
            )

    def admits(self, ns: str) -> bool:
        if self.include:
            return ns in self.include
        return ns not in self.exclude


@dataclasses.dataclass
class MetricsSpec:
    context_options: list[MetricsContextOptions] = dataclasses.field(
        default_factory=list
    )
    namespaces: MetricsNamespaces = dataclasses.field(
        default_factory=MetricsNamespaces
    )

    def validate(self) -> None:
        seen = set()
        for co in self.context_options:
            co.validate()
            if co.metric_name in seen:
                raise ValidationError(
                    f"duplicate contextOption for {co.metric_name}"
                )
            seen.add(co.metric_name)
        self.namespaces.validate()


@dataclasses.dataclass
class MetricsConfiguration:
    name: str = "default"
    # Kept for CRDStore keying (ns/name): without it, a CR outside the
    # "default" namespace is stored under the wrong key and the bridge's
    # post-LIST resync deletes it right after applying it.
    namespace: str = "default"
    spec: MetricsSpec = dataclasses.field(default_factory=MetricsSpec)

    def validate(self) -> None:
        self.spec.validate()

    @classmethod
    def default(cls) -> "MetricsConfiguration":
        """The out-of-the-box pod-level metric set (reference helm
        defaults: forward/drop/dns/tcp in local context)."""
        return cls(
            spec=MetricsSpec(
                context_options=[
                    MetricsContextOptions("forward", ["podname", "namespace"]),
                    MetricsContextOptions("drop", ["podname", "namespace"]),
                    MetricsContextOptions("tcpflags", ["podname", "namespace"]),
                    MetricsContextOptions("tcpretrans", ["podname", "namespace"]),
                    MetricsContextOptions("dns", ["podname", "namespace"]),
                    MetricsContextOptions("latency", []),
                    MetricsContextOptions("distinct_sources",
                                          ["podname", "namespace"]),
                    MetricsContextOptions("flows", []),
                    MetricsContextOptions("services", []),
                ]
            )
        )

    @classmethod
    def from_yaml(cls, text: str) -> "MetricsConfiguration":
        import yaml  # only here: the agent imports no YAML parser otherwise

        doc = yaml.safe_load(text) or {}
        spec_doc = doc.get("spec", doc)
        cos = [
            MetricsContextOptions(
                metric_name=c.get("metricName", c.get("metric_name", "")),
                src_labels=c.get("sourceLabels", c.get("src_labels", [])),
                dst_labels=c.get("destinationLabels", c.get("dst_labels", [])),
                additional_labels=c.get("additionalLabels",
                                        c.get("additional_labels", [])),
            )
            for c in spec_doc.get("contextOptions", [])
        ]
        ns_doc = spec_doc.get("namespaces", {}) or {}
        meta = doc.get("metadata", {}) or {}
        obj = cls(
            name=meta.get("name", "default"),
            namespace=meta.get("namespace") or "default",
            spec=MetricsSpec(
                context_options=cos,
                namespaces=MetricsNamespaces(
                    include=ns_doc.get("include") or [],
                    exclude=ns_doc.get("exclude") or [],
                ),
            ),
        )
        obj.validate()
        return obj


# ---------------------------------------------------------------------------
# Capture

MAX_CAPTURE_DURATION_S = 3600  # capture_types.go duration ceiling


@dataclasses.dataclass
class CaptureTarget:
    """Node/pod selection (capture_types.go CaptureTarget)."""

    node_selector: dict[str, str] = dataclasses.field(default_factory=dict)
    node_names: list[str] = dataclasses.field(default_factory=list)
    pod_selector: dict[str, str] = dataclasses.field(default_factory=dict)
    namespace_selector: dict[str, str] = dataclasses.field(
        default_factory=dict
    )

    def validate(self) -> None:
        has_node = bool(self.node_selector or self.node_names)
        has_pod = bool(self.pod_selector or self.namespace_selector)
        if not has_node and not has_pod:
            raise ValidationError(
                "capture target needs a node selector or a pod selector"
            )
        if has_node and has_pod:
            raise ValidationError(
                "node and pod selectors are mutually exclusive"
            )


@dataclasses.dataclass
class CaptureOutput:
    """Output sinks (capture_types.go OutputConfiguration)."""

    host_path: str = ""
    persistent_volume_claim: str = ""
    blob_upload_secret: str = ""
    s3_upload: dict[str, str] = dataclasses.field(default_factory=dict)

    def is_empty(self) -> bool:
        """No output location configured (the managed-storage gate and
        the translator's job-time guard share this predicate)."""
        return not (self.host_path or self.persistent_volume_claim
                    or self.blob_upload_secret or self.s3_upload)

    def validate(self) -> None:
        # An EMPTY output is admissible: the reference CRD does not
        # require one, because the operator's managed-storage path fills
        # BlobUpload in during reconcile (controller.go:310-350 /
        # capture/managed.py). Translation enforces that SOME output
        # exists by job-creation time (translator.py).
        if self.s3_upload:
            for req in ("bucket", "region"):
                if req not in self.s3_upload:
                    raise ValidationError(f"s3Upload missing {req!r}")


@dataclasses.dataclass
class CaptureSpec:
    target: CaptureTarget = dataclasses.field(default_factory=CaptureTarget)
    output: CaptureOutput = dataclasses.field(default_factory=CaptureOutput)
    duration_s: int = 60
    max_capture_size_mb: int = 100
    packet_size_bytes: int = 0  # 0 = full packets
    tcpdump_filter: str = ""  # raw extra filter
    include_metadata: bool = True

    def validate(self) -> None:
        if not (0 < self.duration_s <= MAX_CAPTURE_DURATION_S):
            raise ValidationError(
                f"duration must be in (0, {MAX_CAPTURE_DURATION_S}]s"
            )
        self.target.validate()
        self.output.validate()


@dataclasses.dataclass
class CaptureStatus:
    """Status conditions (capture_types.go:22-52)."""

    phase: str = "Pending"  # Pending | Running | Completed | Failed
    jobs_active: int = 0
    jobs_completed: int = 0
    jobs_failed: int = 0
    message: str = ""
    artifacts: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Capture:
    name: str
    namespace: str = "default"
    spec: CaptureSpec = dataclasses.field(default_factory=CaptureSpec)
    status: CaptureStatus = dataclasses.field(default_factory=CaptureStatus)

    def validate(self) -> None:
        if not self.name:
            raise ValidationError("capture needs a name")
        self.spec.validate()

    @classmethod
    def from_yaml(cls, text: str) -> "Capture":
        import yaml  # only here: the agent imports no YAML parser otherwise

        doc = yaml.safe_load(text) or {}
        meta = doc.get("metadata", {})
        s = doc.get("spec", {})
        tgt = s.get("captureConfiguration", s).get("captureTarget",
                                                   s.get("target", {}))
        out = s.get("outputConfiguration", s.get("output", {}))
        obj = cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            spec=CaptureSpec(
                target=CaptureTarget(
                    node_selector=tgt.get("nodeSelector", {}).get(
                        "matchLabels", tgt.get("nodeSelector", {})
                    ) if isinstance(tgt.get("nodeSelector", {}), dict) else {},
                    node_names=tgt.get("nodeNames", []),
                    pod_selector=tgt.get("podSelector", {}).get(
                        "matchLabels", tgt.get("podSelector", {})
                    ) if isinstance(tgt.get("podSelector", {}), dict) else {},
                    namespace_selector=tgt.get("namespaceSelector", {}).get(
                        "matchLabels", tgt.get("namespaceSelector", {})
                    ) if isinstance(tgt.get("namespaceSelector", {}), dict)
                    else {},
                ),
                output=CaptureOutput(
                    host_path=out.get("hostPath", ""),
                    persistent_volume_claim=out.get("persistentVolumeClaim", ""),
                    blob_upload_secret=out.get("blobUpload", ""),
                    s3_upload=out.get("s3Upload", {}),
                ),
                duration_s=int(s.get("captureConfiguration", s).get(
                    "captureOption", {}).get("duration", s.get("duration", 60))
                ) if isinstance(s.get("duration", 60), (int, str)) else 60,
                tcpdump_filter=s.get("captureConfiguration", s).get(
                    "filters", {}).get("raw", s.get("tcpdumpFilter", ""))
                if isinstance(s.get("tcpdumpFilter", ""), str) else "",
            ),
        )
        # Preserve status if the document carries one: objects echoed back
        # by a backend (apiserver watch after our own status PATCH, or a
        # re-LIST of already-Completed captures) must NOT reset to Pending,
        # or the operator would re-run finished captures forever.
        st = doc.get("status") or {}
        if st:
            obj.status = CaptureStatus(
                phase=st.get("phase", "Pending"),
                jobs_active=int(st.get("jobs_active",
                                       st.get("jobsActive", 0)) or 0),
                jobs_completed=int(st.get("jobs_completed",
                                          st.get("jobsCompleted", 0)) or 0),
                jobs_failed=int(st.get("jobs_failed",
                                       st.get("jobsFailed", 0)) or 0),
                message=st.get("message", ""),
                artifacts=list(st.get("artifacts", [])),
            )
        obj.validate()
        return obj


# ---------------------------------------------------------------------------
# TracesConfiguration (stub parity: reference module is a skeleton too)


@dataclasses.dataclass
class TracesSpec:
    trace_targets: list[dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    trace_points: list[str] = dataclasses.field(default_factory=list)
    sampling_rate_per_mille: int = 0


@dataclasses.dataclass
class TracesConfiguration:
    name: str = "default"
    namespace: str = "default"  # CRDStore keying (see MetricsConfiguration)
    spec: TracesSpec = dataclasses.field(default_factory=TracesSpec)

    @classmethod
    def from_yaml(cls, text: str) -> "TracesConfiguration":
        # Null-tolerant throughout: a CR with `traceTargets:` left
        # empty (YAML null) must parse as [], not raise inside the
        # bridge's LIST loop — one malformed CR would wedge the whole
        # kind's watch in a re-LIST spin.
        import yaml  # only here: the agent imports no YAML parser otherwise

        doc = yaml.safe_load(text) or {}
        meta = doc.get("metadata", {}) or {}
        s = doc.get("spec", {}) or {}
        return cls(
            name=meta.get("name", "default"),
            namespace=meta.get("namespace") or "default",
            spec=TracesSpec(
                trace_targets=list(
                    s.get("traceTargets")
                    or s.get("trace_targets") or []
                ),
                trace_points=list(
                    s.get("tracePoints") or s.get("trace_points") or []
                ),
                sampling_rate_per_mille=int(
                    s.get("samplingRatePerMille")
                    or s.get("sampling_rate_per_mille") or 0
                ),
            ),
        )
