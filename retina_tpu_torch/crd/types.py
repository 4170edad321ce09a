"""API types: MetricsConfiguration and TracesConfiguration (port of the
metrics and traces parts of retina_tpu/crd/types.py).

Reference analog: MetricsConfiguration (crd/api/v1alpha1/
metricsconfiguration_types.go:28-95): contextOptions (metricName + src/dst
label dimensions) and namespace include/exclude, reconciled into the
running metrics module. Validation mirrors crd/api/v1alpha1/validations/.
TracesConfiguration is the reference's stub-parity CRD (its module is a
skeleton upstream too) that ``module/traces.py`` compiles into matchers.
PyYAML is imported only by ``from_yaml``. The capture types are not ported
yet.
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
