"""API types: MetricsConfiguration (port of the metrics part of
retina_tpu/crd/types.py).

Reference analog: MetricsConfiguration (crd/api/v1alpha1/
metricsconfiguration_types.go:28-95): contextOptions (metricName + src/dst
label dimensions) and namespace include/exclude, reconciled into the
running metrics module. Validation mirrors crd/api/v1alpha1/validations/.
PyYAML is imported only by ``from_yaml``. The capture and traces types are
not ported yet.
"""

from __future__ import annotations

import dataclasses


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
