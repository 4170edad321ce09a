"""Capture job descriptor and packet-filter synthesis (copy of
``CaptureJob`` and ``synthesize_filter`` of
retina_tpu/capture/translator.py)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CaptureJob:
    """One node's capture work item."""

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


def synthesize_filter(pod_ips: list[str], extra_filter: str = "",
                      ports: list[int] | None = None) -> str:
    """tcpdump filter: OR the target IPs, AND optional ports, AND any raw
    extra filter."""
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
