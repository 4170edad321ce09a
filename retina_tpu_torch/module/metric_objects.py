"""Advanced (pod-level) metric objects (port of
retina_tpu/module/metric_objects.py).

Each object implements ``publish(snapshot, ctx)``: it reads its slice of
the merged device snapshot and sets labeled gauges; aggregation already
happened on the card (the pipeline step), so publish cost is O(active label
sets), not O(events). Local context publishes per-pod series from the dense
rectangles; remote context publishes src x dst pod-pair series from the
service-graph heavy-hitter sketch.

The snapshot the objects read is ``host_snapshot`` of the engine's: numpy
arrays in which the port's int32 u32 bit patterns read as uint32, as the
reference's arrays do, so a counter at or past 2^31 publishes unsigned.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from retina_tpu_torch.common import RetinaEndpoint
from retina_tpu_torch.u32 import to_numpy
from retina_tpu_torch.crd.types import MetricsContextOptions, MetricsNamespaces
from retina_tpu_torch.exporter import Exporter
from retina_tpu_torch.utils import metric_names as mn


def host_snapshot(snap: dict[str, Any]) -> dict[str, Any]:
    """An engine snapshot with every tensor leaf as a numpy array: int32 u32
    bit patterns as uint32, float32 as float32; other leaves as they are."""
    out: dict[str, Any] = {}
    for k, v in snap.items():
        if isinstance(v, dict):
            out[k] = host_snapshot(v)
        elif hasattr(v, "detach"):
            out[k] = to_numpy(v)
        else:
            out[k] = v
    return out


@dataclasses.dataclass
class PublishCtx:
    """Everything a metric object needs at publish time."""

    labeler: dict[int, RetinaEndpoint]  # pod index -> identity
    namespaces: MetricsNamespaces
    dns_resolver: Any = None  # qname hash -> str
    top_k: int = 50

    def admit(self, idx: int) -> Optional[RetinaEndpoint]:
        ep = self.labeler.get(idx)
        if ep is None:
            return None
        return ep if self.namespaces.admits(ep.namespace) else None


_POD_LABELS = [mn.L_POD, mn.L_NAMESPACE, mn.L_WORKLOAD]


def _pod_label_values(ep: RetinaEndpoint) -> dict[str, str]:
    return {
        mn.L_POD: ep.name,
        mn.L_NAMESPACE: ep.namespace,
        mn.L_WORKLOAD: ep.workload(),
    }


class AdvMetricBase:
    """Init/publish/clean contract (AdvMetricsInterface analog)."""

    name = ""

    def __init__(self, opts: MetricsContextOptions, exporter: Exporter):
        self.opts = opts
        self.exporter = exporter
        self.init()

    def init(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def publish(self, snap: dict[str, Any], ctx: PublishCtx) -> None:
        raise NotImplementedError

    def clean(self) -> None:
        """Gauges live in the advanced registry; reset drops them."""


class ForwardMetrics(AdvMetricBase):
    name = "forward"

    def init(self) -> None:
        labels = [mn.L_DIRECTION, *_POD_LABELS]
        self.count = self.exporter.new_adv_gauge(mn.ADV_FORWARD_COUNT, labels)
        self.bytes = self.exporter.new_adv_gauge(mn.ADV_FORWARD_BYTES, labels)

    def publish(self, snap: dict[str, Any], ctx: PublishCtx) -> None:
        pf = snap["pod_forward"]  # (P, 2 dir, 2 {pkts, bytes})
        active = np.nonzero(pf.sum(axis=(1, 2)))[0]
        for idx in active:
            ep = ctx.admit(int(idx))
            if ep is None:
                continue
            lv = _pod_label_values(ep)
            for d, dname in ((0, "ingress"), (1, "egress")):
                self.count.labels(direction=dname, **lv).set(int(pf[idx, d, 0]))
                self.bytes.labels(direction=dname, **lv).set(int(pf[idx, d, 1]))


class DropMetrics(AdvMetricBase):
    name = "drop"

    def init(self) -> None:
        labels = [mn.L_REASON, *_POD_LABELS]
        self.count = self.exporter.new_adv_gauge(mn.ADV_DROP_COUNT, labels)
        self.bytes = self.exporter.new_adv_gauge(mn.ADV_DROP_BYTES, labels)

    def publish(self, snap: dict[str, Any], ctx: PublishCtx) -> None:
        from retina_tpu_torch.plugins.dropreason import DROP_REASONS

        pd = snap["pod_drop"]  # (P, R, 2)
        pods, reasons = np.nonzero(pd[:, :, 0])
        for idx, r in zip(pods, reasons):
            ep = ctx.admit(int(idx))
            if ep is None:
                continue
            lv = _pod_label_values(ep)
            rname = DROP_REASONS.get(int(r), str(int(r)))
            self.count.labels(reason=rname, **lv).set(int(pd[idx, r, 0]))
            self.bytes.labels(reason=rname, **lv).set(int(pd[idx, r, 1]))


class TcpFlagsMetrics(AdvMetricBase):
    name = "tcpflags"

    _FLAGS = ["FIN", "SYN", "RST", "PSH", "ACK", "URG", "ECE", "CWR"]

    def init(self) -> None:
        self.count = self.exporter.new_adv_gauge(
            mn.ADV_TCP_FLAG_COUNTERS, [mn.L_FLAG, *_POD_LABELS]
        )

    def publish(self, snap: dict[str, Any], ctx: PublishCtx) -> None:
        tf = snap["pod_tcpflags"]  # (P, 8)
        pods, bits = np.nonzero(tf)
        for idx, bit in zip(pods, bits):
            ep = ctx.admit(int(idx))
            if ep is None:
                continue
            self.count.labels(
                flag=self._FLAGS[int(bit)], **_pod_label_values(ep)
            ).set(int(tf[idx, bit]))


class TcpRetransMetrics(AdvMetricBase):
    name = "tcpretrans"

    def init(self) -> None:
        self.count = self.exporter.new_adv_gauge(
            mn.ADV_TCP_RETRANS_COUNT, _POD_LABELS
        )

    def publish(self, snap: dict[str, Any], ctx: PublishCtx) -> None:
        pr = snap["pod_retrans"]  # (P,)
        for idx in np.nonzero(pr)[0]:
            ep = ctx.admit(int(idx))
            if ep is None:
                continue
            self.count.labels(**_pod_label_values(ep)).set(int(pr[idx]))


class DnsMetrics(AdvMetricBase):
    name = "dns"

    _QTYPES = {1: "A", 5: "CNAME", 28: "AAAA", 12: "PTR"}

    def init(self) -> None:
        self.req = self.exporter.new_adv_gauge(
            mn.ADV_DNS_REQUEST_COUNT, [mn.L_QTYPE, *_POD_LABELS]
        )
        self.resp = self.exporter.new_adv_gauge(
            mn.ADV_DNS_RESPONSE_COUNT, [mn.L_QTYPE, *_POD_LABELS]
        )
        self.heavy = self.exporter.new_adv_gauge(
            mn.HEAVY_HITTER_DNS, ["query"]
        )

    def publish(self, snap: dict[str, Any], ctx: PublishCtx) -> None:
        pdns = snap["pod_dns"]  # (P, Q, 2)
        pods, qtypes = np.nonzero(pdns.sum(axis=2))
        for idx, qt in zip(pods, qtypes):
            ep = ctx.admit(int(idx))
            if ep is None:
                continue
            lv = _pod_label_values(ep)
            qname = self._QTYPES.get(int(qt), str(int(qt)))
            self.req.labels(query_type=qname, **lv).set(int(pdns[idx, qt, 0]))
            self.resp.labels(query_type=qname, **lv).set(int(pdns[idx, qt, 1]))
        # qname heavy hitters, resolved through the host string table
        if ctx.dns_resolver is not None and "dns_hh" in snap:
            from retina_tpu_torch.parallel.telemetry import topk_from_snapshot

            keys, counts = topk_from_snapshot(snap, "dns_hh", ctx.top_k)
            for key, cnt in zip(keys, counts):
                self.heavy.labels(
                    query=ctx.dns_resolver(int(key[0]))
                ).set(int(cnt))


class LatencyMetrics(AdvMetricBase):
    """Apiserver RTT histogram (reference latency.go:286-301)."""

    name = "latency"

    def init(self) -> None:
        self.hist = self.exporter.new_adv_gauge(
            mn.ADV_API_LATENCY, [mn.L_BUCKET]
        )
        self.no_resp = self.exporter.new_adv_gauge(mn.ADV_API_NO_RESPONSE, [])

    def publish(self, snap: dict[str, Any], ctx: PublishCtx) -> None:
        hist = snap["lat_hist"]  # (H,) exponential ms buckets
        for b in range(len(hist)):
            self.hist.labels(le_ms=str((1 << b) - 1)).set(int(hist[b]))


class DistinctSourcesMetrics(AdvMetricBase):
    """Per-pod distinct source IPs from the HLL bank (new capability the
    reference cannot express with bounded memory)."""

    name = "distinct_sources"

    def init(self) -> None:
        self.gauge = self.exporter.new_adv_gauge(
            mn.DISTINCT_SRC_PER_POD, _POD_LABELS
        )

    def publish(self, snap: dict[str, Any], ctx: PublishCtx) -> None:
        est = snap["hll_src_per_pod"]  # (P,) float estimates
        for idx in np.nonzero(est >= 1.0)[0]:
            ep = ctx.admit(int(idx))
            if ep is None:
                continue
            self.gauge.labels(**_pod_label_values(ep)).set(float(est[idx]))


class FlowsMetrics(AdvMetricBase):
    """Flow-level series: distinct 5-tuples + top flow heavy hitters."""

    name = "flows"

    def init(self) -> None:
        self.distinct = self.exporter.new_adv_gauge(mn.DISTINCT_FLOWS, [])
        self.heavy = self.exporter.new_adv_gauge(
            mn.HEAVY_HITTER_FLOWS,
            ["src_ip", "dst_ip", "src_port", "dst_port", mn.L_PROTO],
        )

    def publish(self, snap: dict[str, Any], ctx: PublishCtx) -> None:
        from retina_tpu_torch.events.schema import u32_to_ip
        from retina_tpu_torch.parallel.telemetry import topk_from_snapshot

        self.distinct.set(float(snap["hll_flows"][0]))
        keys, counts = topk_from_snapshot(snap, "flow_hh", ctx.top_k)
        for key, cnt in zip(keys, counts):
            src, dst, ports, proto = (int(k) for k in key)
            self.heavy.labels(
                src_ip=u32_to_ip(src), dst_ip=u32_to_ip(dst),
                src_port=str(ports >> 16), dst_port=str(ports & 0xFFFF),
                protocol={6: "TCP", 17: "UDP"}.get(proto, str(proto)),
            ).set(int(cnt))


class ServicesMetrics(AdvMetricBase):
    """Pod×pod service-graph edges from the svc heavy-hitter sketch —
    the REMOTE-context mode (src×dst pairs) with bounded memory."""

    name = "services"

    def init(self) -> None:
        self.edges = self.exporter.new_adv_gauge(
            mn.HEAVY_HITTER_SERVICES,
            ["src_" + mn.L_POD, "src_" + mn.L_NAMESPACE,
             "dst_" + mn.L_POD, "dst_" + mn.L_NAMESPACE],
        )

    def publish(self, snap: dict[str, Any], ctx: PublishCtx) -> None:
        from retina_tpu_torch.parallel.telemetry import topk_from_snapshot

        keys, counts = topk_from_snapshot(snap, "svc_hh", ctx.top_k)
        for key, cnt in zip(keys, counts):
            src = ctx.admit(int(key[0]))
            dst = ctx.admit(int(key[1]))
            if src is None or dst is None:
                continue
            self.edges.labels(
                src_podname=src.name, src_namespace=src.namespace,
                dst_podname=dst.name, dst_namespace=dst.namespace,
            ).set(int(cnt))


METRIC_CONSTRUCTORS = {
    cls.name: cls
    for cls in (
        ForwardMetrics, DropMetrics, TcpFlagsMetrics, TcpRetransMetrics,
        DnsMetrics, LatencyMetrics, DistinctSourcesMetrics, FlowsMetrics,
        ServicesMetrics,
    )
}
