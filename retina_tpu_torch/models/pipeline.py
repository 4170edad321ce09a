"""TelemetryPipeline: the fused per-batch step (port of retina_tpu/models/pipeline.py).

One batch of (B, 16) event records updates every aggregator:

- K1 (``kernels/csrc/step_rows.cu``, plain version ``step_rows_plain``)
  decodes the records, rescales sampled rows, joins IPs to pods, filters,
  adds into the dense counter rectangles, node counters and totals, and
  writes per-event lanes (pods, weights, masks) for the sketches; with
  ``enable_latency`` it also lists the apiserver probes for K14;
- K5 (``ConntrackTable.process_lanes``, with ``enable_conntrack``) decides
  the conntrack reports on K1's filtered mask and rescaled packets and
  bytes; at ``data_aggregation_level="low"`` the reports, and not the
  packets, drive the sketches (a few elementwise torch ops derive their
  weights and masks from the report lanes);
- K2 (``topk.update_many``) updates flow_hh, svc_hh and dns_hh in one
  call (three launches for the three sketches);
- K6 (``invertible.update_pair``, with ``enable_invertible``) the two
  invertible sketches in one call (two launches), priority rows to
  ``inv_hi`` and the rest to ``inv_flow``, with flow_hh's keys and weights;
- K3 (``hyperloglog.update_many``) the three HLL banks in one launch;
- K4 (``EntropyWindow.update``) the three entropy histograms;
- K14 (``kernels/csrc/latency.cu``, plain version ``latency_update_plain``)
  the apiserver latency match over K1's list: sends write their
  fingerprints into the latency slots, replies that match count their RTT
  bucket.

State is updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.events.schema import (
    DIR_INGRESS,
    EV_DNS_REQ,
    EV_DNS_RESP,
    EV_TCP_RETRANS,
    PROTO_TCP,
    VERDICT_DROPPED,
    VERDICT_FORWARDED,
    F,
)
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models.identity import IdentityMap, lookup_plain
from retina_tpu_torch.ops.conntrack import ConntrackTable
from retina_tpu_torch.ops.entropy import AnomalyEWMA, EntropyWindow, entropy_bits_plain
from retina_tpu_torch.ops.hashing import hash_cols, reduce_range
from retina_tpu_torch.ops.hyperloglog import HyperLogLog
from retina_tpu_torch.ops.invertible import InvertibleSketch
from retina_tpu_torch.ops import hyperloglog, invertible, topk
from retina_tpu_torch.ops.topk import HeavyHitterSketch
from retina_tpu_torch.u32 import M32, narrow, widen


EWMA_MIN_WINDOWS = 10  # the anomaly EWMA's warm-up at a window close (AnomalyEWMA.observe's)


def priority_class(src_ip: torch.Tensor, dst_ip: torch.Tensor, mask: int,
                   match: int) -> torch.Tensor:
    """(B,) bool: either endpoint inside the priority prefix; mask 0
    disables the class. Takes int64 u32 values."""
    if mask == 0:
        return torch.zeros(src_ip.shape, dtype=torch.bool, device=src_ip.device)
    return ((src_ip & mask) == match) | ((dst_ip & mask) == match)


def sample_exempt(packets: torch.Tensor, tsval: torch.Tensor, tsecr: torch.Tensor,
                  is_priority: torch.Tensor, exempt_packets: int) -> torch.Tensor:
    """(B,) bool: rows the host overload sampler keeps unsampled."""
    return (packets >= exempt_packets) | ((tsval | tsecr) != 0) | is_priority


def ht_rescale(packets: torch.Tensor, bytes_: torch.Tensor, exempt: torch.Tensor,
               sample_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Horvitz-Thompson re-weighting of a 1-in-k sampled batch: multiply
    non-exempt rows by k, saturating at 2^32 - 1 (int64 u32 values)."""
    k = int(sample_k) & M32
    if k <= 1:
        return packets, bytes_
    scale = torch.where(exempt, 1, k)
    lim = M32 // k
    packets = torch.where((scale > 1) & (packets > lim), M32, (packets * scale) & M32)
    bytes_ = torch.where((scale > 1) & (bytes_ > lim), M32, (bytes_ * scale) & M32)
    return packets, bytes_


def _sum64(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (lo, hi) u32 limbs of the sum of a (B,) batch of u32 values."""
    s = widen(x).sum()
    return s & M32, (s >> 32) & M32


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static shapes of every aggregator (same fields and checks as the
    reference's PipelineConfig)."""

    n_pods: int = 1 << 12
    n_drop_reasons: int = 16
    n_dns_qtypes: int = 16
    cms_depth: int = 2
    cms_width: int = 1 << 16
    topk_slots: int = 1 << 11
    hll_precision: int = 12
    hll_pod_precision: int = 6
    entropy_buckets: int = 1 << 12
    conntrack_slots: int = 1 << 18
    latency_slots: int = 1 << 12
    latency_buckets: int = 16
    enable_conntrack: bool = True
    enable_latency: bool = True
    bypass_filter: bool = True
    sample_exempt_packets: int = 64
    identity_implies_interest: bool = True
    data_aggregation_level: str = "high"
    enable_invertible: bool = False
    inv_depth: int = 2
    inv_width: int = 1 << 12
    inv_hi_width: int = 1 << 9
    priority_ip_mask: int = 0
    priority_ip_match: int = 0

    def __post_init__(self):
        if self.inv_width & (self.inv_width - 1):
            raise ValueError("inv_width must be a power of two")
        if self.inv_hi_width & (self.inv_hi_width - 1):
            raise ValueError("inv_hi_width must be a power of two")
        if self.data_aggregation_level not in ("low", "high"):
            raise ValueError(
                f"data_aggregation_level must be low|high, "
                f"got {self.data_aggregation_level!r}"
            )
        if self.data_aggregation_level == "low" and not self.enable_conntrack:
            raise ValueError(
                "data_aggregation_level=low requires enable_conntrack "
                "(reports drive the sketch sampling)"
            )


# The deployed node agent: the reference's engine.pipeline_config_from(Config()).
# Conntrack metrics on, data_aggregation_level "low" (the reports drive the
# sketches), the IPs-of-interest filter on (bypass_lookup_ip_of_interest is
# false and pod-level metrics are on).
DEPLOYED_CONFIG = PipelineConfig(
    n_pods=4096, cms_depth=4, cms_width=1 << 15, topk_slots=2048,
    hll_precision=12, entropy_buckets=4096, conntrack_slots=1 << 18,
    enable_conntrack=True, bypass_filter=False,
    identity_implies_interest=True, data_aggregation_level="low",
)
# The same agent under agent.enableConntrackMetrics=false, which also
# forces data_aggregation_level "high".
NO_CONNTRACK_CONFIG = dataclasses.replace(
    DEPLOYED_CONFIG, enable_conntrack=False, data_aggregation_level="high")
# The same agent with heavy_keys_source="invertible": the two invertible
# sketches recover heavy keys without a host flow dictionary.
INVERTIBLE_CONFIG = dataclasses.replace(DEPLOYED_CONFIG, enable_invertible=True)


@dataclasses.dataclass
class PipelineState:
    """All device-resident aggregation state; field order is the
    reference's, so ``convert.py`` maps the reference's flattened leaves
    onto it in order."""

    pod_forward: torch.Tensor  # (P, 2 dir, 2 {pkts, bytes}) u32
    pod_drop: torch.Tensor  # (P, R, 2) u32
    pod_tcpflags: torch.Tensor  # (P, 8) u32
    pod_dns: torch.Tensor  # (P, Q, 2 {req, resp}) u32
    pod_retrans: torch.Tensor  # (P,) u32
    node_counters: torch.Tensor  # (2 dir, 2 {pkts, bytes}) u32
    totals: torch.Tensor  # (8,) u32 [events, fwd, drop, dnsreq, dnsresp,
    #                                  retrans, ct_reports, lost]
    ct_totals: torch.Tensor  # (4,) u32 [pkts_lo, pkts_hi, bytes_lo, bytes_hi]
    flow_hh: HeavyHitterSketch
    svc_hh: HeavyHitterSketch
    dns_hh: HeavyHitterSketch
    hll_flows: HyperLogLog
    hll_src_per_reason: HyperLogLog
    hll_src_per_pod: HyperLogLog
    entropy: EntropyWindow
    anomaly: AnomalyEWMA
    inv_flow: InvertibleSketch
    inv_hi: InvertibleSketch
    conntrack: ConntrackTable
    lat_key: torch.Tensor  # (L,) u32 match fingerprints
    lat_ts: torch.Tensor  # (L,) u32 send time (ns >> 20)
    lat_hist: torch.Tensor  # (H,) u32 RTT histogram


def _add_rows(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """table[idx] += vals (u32, wrapping) for idx < len(table); other rows
    are dropped, as the reference's mode="drop" drops them."""
    keep = idx < table.shape[0]
    vals = torch.where(keep.reshape((-1,) + (1,) * (vals.dim() - 1)), vals, 0)
    table.index_add_(0, torch.where(keep, idx, 0), narrow(vals))


def step_rows_plain(records, n_valid, sample_k, ident_table, ident_seed,
                    filt_table, filt_seed, pod_forward, pod_drop, pod_tcpflags,
                    pod_dns, pod_retrans, node_counters, totals, cfg):
    """Plain version of K1 (see kernels.ops.step_rows for the contract)."""
    b = records.shape[0]
    dev = records.device
    P, R, Q = cfg.n_pods, cfg.n_drop_reasons, cfg.n_dns_qtypes

    def col(i):
        return widen(records[:, i])

    mask = torch.arange(b, device=dev) < n_valid
    src_ip, dst_ip = col(F.SRC_IP), col(F.DST_IP)
    ports, meta = col(F.PORTS), col(F.META)
    proto = meta >> 24
    tcp_flags = (meta >> 16) & 0xFF
    is_ingress = ((meta >> 4) & 0xF) == DIR_INGRESS
    bytes_, packets = col(F.BYTES), col(F.PACKETS)
    is_priority = priority_class(src_ip, dst_ip, cfg.priority_ip_mask, cfg.priority_ip_match)
    if cfg.sample_exempt_packets > 0:
        exempt = sample_exempt(packets, col(F.TSVAL), col(F.TSECR), is_priority,
                               cfg.sample_exempt_packets)
        packets, bytes_ = ht_rescale(packets, bytes_, exempt, sample_k)
    verdict, ev_type = col(F.VERDICT), col(F.EVENT_TYPE)
    reason = torch.clamp(col(F.DROP_REASON), max=R - 1)

    src_pod = torch.where(mask, lookup_plain(ident_table, ident_seed, src_ip), 0)
    dst_pod = torch.where(mask, lookup_plain(ident_table, ident_seed, dst_ip), 0)
    if not cfg.bypass_filter:
        if cfg.identity_implies_interest:
            interest = (src_pod > 0) | (dst_pod > 0)
        else:
            interest = torch.zeros((b,), dtype=torch.bool, device=dev)
        if filt_table is not None:
            interest |= (lookup_plain(filt_table, filt_seed, src_ip) > 0) | (
                lookup_plain(filt_table, filt_seed, dst_ip) > 0
            )
        mask = mask & interest
    is_fwd = mask & (verdict == VERDICT_FORWARDED)
    is_drop = mask & (verdict == VERDICT_DROPPED)
    is_dns_req = mask & (ev_type == EV_DNS_REQ)
    is_dns_resp = mask & (ev_type == EV_DNS_RESP)
    is_retrans = mask & (ev_type == EV_TCP_RETRANS)

    lc = torch.clamp(torch.where(is_ingress, dst_pod, src_pod), max=P - 1)
    dir_idx = torch.where(is_ingress, 0, 1)
    w_pkts = torch.where(is_fwd, packets, 0)
    w_bytes = torch.where(is_fwd, bytes_, 0)
    _add_rows(pod_forward.view(P * 2, 2), lc * 2 + dir_idx,
              torch.stack([w_pkts, w_bytes], dim=1))
    drop_idx = torch.where(is_drop, (lc * R + reason) & M32, P * R)
    _add_rows(pod_drop.view(P * R, 2), drop_idx,
              torch.stack([packets, bytes_], dim=1))
    is_tcp = mask & (proto == PROTO_TCP)
    bits = torch.arange(8, device=dev)
    flag_rows = torch.where(((tcp_flags[:, None] >> bits) & 1) == 1, packets[:, None], 0)
    _add_rows(pod_tcpflags, torch.where(is_tcp, lc, P), flag_rows)
    qtype = torch.clamp(col(F.DNS) >> 16, max=Q - 1)
    is_dns = is_dns_req | is_dns_resp
    w_dns_req = torch.where(is_dns_req, packets, 0)
    w_dns_resp = torch.where(is_dns_resp, packets, 0)
    w_retrans = torch.where(is_retrans, packets, 0)
    _add_rows(pod_dns.view(P * Q, 2), torch.where(is_dns, (lc * Q + qtype) & M32, P * Q),
              torch.stack([w_dns_req, w_dns_resp], dim=1))
    _add_rows(pod_retrans, torch.where(is_retrans, lc, P), w_retrans)

    ing = is_ingress.to(torch.int64)
    sums = torch.stack([
        torch.where(mask, packets, 0).sum(),
        w_pkts.sum(),
        torch.where(is_drop, packets, 0).sum(),
        w_dns_req.sum(),
        w_dns_resp.sum(),
        w_retrans.sum(),
        (w_pkts * ing).sum(),
        (w_bytes * ing).sum(),
        (w_pkts * (1 - ing)).sum(),
        (w_bytes * (1 - ing)).sum(),
    ]) & M32
    totals[:6].copy_(narrow(widen(totals[:6]) + sums[:6]))
    node_counters.view(-1).copy_(narrow(widen(node_counters.view(-1)) + sums[6:]))

    pods_known = (src_pod > 0) & (dst_pod > 0)
    scratch = torch.stack([
        src_pod, dst_pod, proto, ports & 0xFFFF, w_pkts,
        torch.where(pods_known, w_pkts, 0), w_dns_req,
        torch.where(mask, packets, 0), mask.to(torch.int64),
        is_drop.to(torch.int64), reason, torch.clamp(dst_pod, max=P - 1),
        (is_ingress & mask).to(torch.int64), torch.where(mask, bytes_, 0),
        is_priority.to(torch.int64),
    ])
    return narrow(scratch), narrow(sums)


def latency_update_plain(lat_key: torch.Tensor, lat_ts: torch.Tensor, lat_hist: torch.Tensor,
                         records: torch.Tensor, mask: torch.Tensor, apiserver_ip: int) -> None:
    """Plain version of K14, the apiserver latency (reference
    pipeline.py:565-596), in place: match the TSval of packets to the
    apiserver with the TSecr of its replies.

    Two rules differ from the reference, which leaves the first unspecified
    and computes the second in float32 with XLA's log2:
    - rows of one batch that hash to the same slot: the last row in batch
      order wins (key and send time come from that one row);
    - the RTT bucket is exactly floor(log2(rtt + 1)), clamped to the last
      bucket (XLA's CPU log2 rounds 2^13 and 2^15 down by one bucket).
    """
    L, H = lat_key.shape[0], lat_hist.shape[0]
    b = records.shape[0]
    dev = records.device

    def col(i):
        return widen(records[:, i])

    api = int(apiserver_ip) & M32
    m = mask != 0
    src_ip, dst_ip = col(F.SRC_IP), col(F.DST_IP)
    tsval, tsecr = col(F.TSVAL), col(F.TSECR)
    ts_ms = ((col(F.TS_HI) << 12) | (col(F.TS_LO) >> 20)) & M32
    out_to_api = m & (dst_ip == api) & (tsval > 0)
    in_from_api = m & (src_ip == api) & (tsecr > 0)
    k_out = hash_cols([dst_ip, tsval], 0x1A7)
    k_in = hash_cols([src_ip, tsecr], 0x1A7)
    slot_out = reduce_range(k_out, L)
    rows = torch.arange(b, device=dev)
    winner = torch.full((L,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, slot_out, torch.where(out_to_api, rows, -1), "amax")
    has = winner >= 0
    w = winner.clamp(min=0)
    lat_key.copy_(torch.where(has, narrow(k_out[w]), lat_key))
    lat_ts.copy_(torch.where(has, narrow(ts_ms[w]), lat_ts))
    slot_in = reduce_range(k_in, L)
    hit = in_from_api & (widen(lat_key)[slot_in] == k_in)
    rtt = torch.where(hit, (ts_ms - widen(lat_ts)[slot_in]) & M32, 0)
    killed = torch.zeros((L,), dtype=torch.int64, device=dev)
    killed.scatter_reduce_(0, slot_in, hit.to(torch.int64), "amax")
    lat_key.masked_fill_(killed > 0, 0)
    exp = torch.frexp((rtt + 1).to(torch.float64)).exponent.to(torch.int64)
    bucket = torch.clamp(exp - 1, max=H - 1)
    lat_hist.index_add_(0, torch.where(hit, bucket, 0), hit.to(torch.int32))


class TelemetryPipeline:
    """Builds zero state and runs the step for a PipelineConfig on one device
    (the card unless ``device`` names another)."""

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 device: torch.device | str | None = None):
        self.config = config
        self.device = resolve_device(device)

    def init_state(self) -> PipelineState:
        c, dev = self.config, self.device

        def u(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        inv_d = c.inv_depth if c.enable_invertible else 1
        return PipelineState(
            pod_forward=u(c.n_pods, 2, 2),
            pod_drop=u(c.n_pods, c.n_drop_reasons, 2),
            pod_tcpflags=u(c.n_pods, 8),
            pod_dns=u(c.n_pods, c.n_dns_qtypes, 2),
            pod_retrans=u(c.n_pods),
            node_counters=u(2, 2),
            totals=u(8),
            ct_totals=u(4),
            flow_hh=HeavyHitterSketch.zeros(4, c.cms_depth, c.cms_width, c.topk_slots,
                                            seed=1, device=dev),
            svc_hh=HeavyHitterSketch.zeros(2, c.cms_depth, c.cms_width, c.topk_slots,
                                           seed=2, device=dev),
            dns_hh=HeavyHitterSketch.zeros(1, c.cms_depth, c.cms_width, c.topk_slots,
                                           seed=3, device=dev),
            hll_flows=HyperLogLog.zeros(1, c.hll_precision, seed=4, device=dev),
            hll_src_per_reason=HyperLogLog.zeros(c.n_drop_reasons, c.hll_precision,
                                                 seed=5, device=dev),
            hll_src_per_pod=HyperLogLog.zeros(c.n_pods, c.hll_pod_precision, seed=6,
                                              device=dev),
            entropy=EntropyWindow.zeros(3, c.entropy_buckets, seed=7, device=dev),
            anomaly=AnomalyEWMA.zeros(3, device=dev),
            inv_flow=InvertibleSketch.zeros(
                inv_d, c.inv_width if c.enable_invertible else 1, n_key_cols=4,
                seed=9, device=dev),
            inv_hi=InvertibleSketch.zeros(
                inv_d, c.inv_hi_width if c.enable_invertible else 1, n_key_cols=4,
                seed=10, device=dev),
            conntrack=ConntrackTable.zeros(c.conntrack_slots, seed=8, device=dev),
            lat_key=u(c.latency_slots),
            lat_ts=u(c.latency_slots),
            lat_hist=u(c.latency_buckets),
        )

    def step(self, state: PipelineState, records: torch.Tensor, n_valid: int,
             now_s: int, ident: IdentityMap, apiserver_ip: int = 0,
             filter_map: IdentityMap | None = None, sample_k: int = 1,
             ) -> tuple[PipelineState, dict[str, torch.Tensor]]:
        """Process one (B, 16) int32 batch in place; rows at or past
        ``n_valid`` are masked; ``now_s`` (wall seconds) drives conntrack.
        Returns (state, summary) with the reference's keys: "events" and
        "ct_reports" (int32 scalars), "report_mask" (B,) bool,
        "report_packets" and "report_bytes" (B,) int32 u32 lanes, zeros
        without conntrack."""
        c = self.config
        b = records.shape[0]
        filt = None if c.bypass_filter or filter_map is None else filter_map
        scratch, sums = kops.step_rows(
            records, n_valid, sample_k, ident.table, ident.seed,
            None if filt is None else filt.table, 0 if filt is None else filt.seed,
            state.pod_forward, state.pod_drop, state.pod_tcpflags, state.pod_dns,
            state.pod_retrans, state.node_counters, state.totals, c,
            apiserver_ip=apiserver_ip if c.enable_latency else None,
        )
        r = dict(zip(kops.SCRATCH, scratch))
        src, dst, ports = records[:, F.SRC_IP], records[:, F.DST_IP], records[:, F.PORTS]
        if c.enable_conntrack:
            report, _, rep_pkts, rep_bytes = state.conntrack.process_lanes(
                src, dst, ports, r["proto"], (records[:, F.META] >> 16) & 0xFF, now_s,
                r["bytes"], r["mask"], r["ent_w"])
        else:
            report, rep_pkts, rep_bytes = torch.zeros((3, b), dtype=torch.int32,
                                                      device=records.device)
        if c.data_aggregation_level == "low":
            # One weighted update per reporting connection, carrying its
            # packets since its previous report; K3 ANDs the pod bank's
            # mask with the reports itself.
            flow_w, ent_w, sk_mask, pod_report = rep_pkts, rep_pkts, report, report
            svc_w = torch.where((r["src_pod"] != 0) & (r["dst_pod"] != 0), rep_pkts, 0)
        else:
            flow_w, svc_w, ent_w = r["flow_w"], r["svc_w"], r["ent_w"]
            sk_mask, pod_report = r["mask"], None
        five = [src, dst, ports, r["proto"]]
        topk.update_many([(state.flow_hh, five, flow_w),
                          (state.svc_hh, [r["src_pod"], r["dst_pod"]], svc_w),
                          (state.dns_hh, [records[:, F.DNS_QHASH]], r["dns_w"])])
        if c.enable_invertible:
            # Priority rows go only to inv_hi, the rest to inv_flow: one K6 call.
            invertible.update_pair(state.inv_flow, state.inv_hi, five, flow_w,
                                   r["is_priority"])
        hyperloglog.update_many([
            (state.hll_flows, five, None, sk_mask, None),
            (state.hll_src_per_reason, [src], r["reason"], r["is_drop"], None),
            (state.hll_src_per_pod, [src], r["pod_grp"], r["pod_mask"], pod_report)])
        state.entropy.update([src, dst, r["dport"]], ent_w)
        if c.enable_latency:
            kops.latency_update(state.lat_key, state.lat_ts, state.lat_hist, records,
                                r["mask"], apiserver_ip)
        n_reports = report.sum()
        if c.enable_conntrack:
            # Reported packets and bytes in two exact u32 limbs each.
            ct = widen(state.ct_totals)
            rp_lo, rp_hi = _sum64(rep_pkts)
            rb_lo, rb_hi = _sum64(rep_bytes)
            lo_p, lo_b = ct[0] + rp_lo, ct[2] + rb_lo
            state.ct_totals.copy_(narrow(torch.stack([
                lo_p, ct[1] + rp_hi + (lo_p >> 32), lo_b, ct[3] + rb_hi + (lo_b >> 32)])))
            state.totals[6:7].copy_(narrow(widen(state.totals[6:7]) + n_reports))
        return state, {
            "events": sums[0], "ct_reports": narrow(n_reports),
            "report_mask": report != 0, "report_packets": rep_pkts, "report_bytes": rep_bytes,
        }

    def end_window(self, state: PipelineState, z_thresh: float = 4.0,
                   ) -> tuple[PipelineState, dict[str, torch.Tensor]]:
        """Close an entropy window in one launch of K16: entropies, the
        anomaly EWMA (``state.anomaly``'s tensors updated in place) and the
        histogram reset. Idle windows do not touch the baseline."""
        a = state.anomaly
        h, flags, z = kops.window_close(state.entropy.counts, a.mean, a.var, a.n_obs, a.alpha,
                                        z_thresh, EWMA_MIN_WINDOWS)
        return state, {"entropy_bits": h, "anomaly": flags, "zscore": z}


def end_window_plain(counts: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     n_obs: torch.Tensor, alpha: float, z_thresh: float, min_windows: int,
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K16, in place as the kernel: the entropy bits of
    ``counts`` (G, K), ``AnomalyEWMA.observe`` with ``active`` = a row saw
    traffic, its new mean, var and n_obs copied into the given tensors, and
    ``counts`` zeroed. Returns (bits, flags, z)."""
    h = entropy_bits_plain(counts)
    active = counts.sum(dim=-1) > 0
    new, flags, z = AnomalyEWMA(mean=mean, var=var, n_obs=n_obs, alpha=alpha).observe(
        h, z_thresh=z_thresh, min_windows=min_windows, active=active)
    mean.copy_(new.mean)
    var.copy_(new.var)
    n_obs.copy_(new.n_obs)
    counts.zero_()
    return h, flags, z
