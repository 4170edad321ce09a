"""Single-card telemetry (port of retina_tpu/parallel/telemetry.py at D=1).

``Telemetry`` wraps the pipeline with the reference ShardedTelemetry's
interface on a one-device mesh, where every collective is an identity: the
step also counts host-side losses into totals[7], and ``snapshot`` returns
the same keys, shapes and dtypes (u32 leaves as int32 bit patterns),
including the leading device axis of size 1 on the gathered candidate
tables and ``ct_totals``. State has no device axis. Multi-card sharding
(NCCL collectives) is a later slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig, PipelineState, TelemetryPipeline
from retina_tpu_torch.u32 import M32, narrow, to_numpy, widen


class Telemetry:
    """TelemetryPipeline on one card with the sharded interface."""

    def __init__(self, config: PipelineConfig, device: torch.device | str | None = None):
        self.pipeline = TelemetryPipeline(config, device)
        self.device = self.pipeline.device
        self._no_filter = IdentityMap.zeros(1 << 4, seed=99, device=self.device)

    def init_state(self) -> PipelineState:
        return self.pipeline.init_state()

    def step(self, state: PipelineState, records: torch.Tensor, n_valid: int,
             now_s: int, ident: IdentityMap, apiserver_ip: int = 0,
             filter_map: IdentityMap | None = None, lost: int = 0,
             sample_k: int = 1) -> tuple[PipelineState, dict[str, torch.Tensor]]:
        """One (B, 16) batch; ``lost`` (host-side overflow) adds to totals[7]."""
        state, summary = self.pipeline.step(
            state, records, n_valid, now_s, ident, apiserver_ip,
            filter_map=self._no_filter if filter_map is None else filter_map,
            sample_k=sample_k,
        )
        if int(lost) & M32:
            state.totals[7:8].copy_(narrow(widen(state.totals[7:8]) + (int(lost) & M32)))
        return state, summary

    def end_window(self, state: PipelineState, z_thresh: float = 4.0,
                   ) -> tuple[PipelineState, dict[str, torch.Tensor]]:
        return self.pipeline.end_window(state, z_thresh)

    def snapshot(self, state: PipelineState, now_s: int) -> dict[str, Any]:
        """Scrape-time readout; every leaf is a copy, so later in-place
        steps do not change it."""
        s = state

        def hh(sk):
            return {"keys": sk.table.key_rows[None].clone(),
                    "counts": sk.table.counts[None].clone()}

        return {
            "pod_forward": s.pod_forward.clone(),
            "pod_drop": s.pod_drop.clone(),
            "pod_tcpflags": s.pod_tcpflags.clone(),
            "pod_dns": s.pod_dns.clone(),
            "pod_retrans": s.pod_retrans.clone(),
            "node_counters": s.node_counters.clone(),
            "totals": s.totals.clone(),
            "ct_totals": s.ct_totals[None].clone(),
            "lat_hist": s.lat_hist.clone(),
            "hll_flows": s.hll_flows.estimate(),
            "hll_src_per_reason": s.hll_src_per_reason.estimate(),
            "hll_src_per_pod": s.hll_src_per_pod.estimate(),
            "flow_hh": hh(s.flow_hh),
            "svc_hh": hh(s.svc_hh),
            "dns_hh": hh(s.dns_hh),
            "active_conns": s.conntrack.active_connections(now_s),
        }


def topk_from_snapshot(snap: dict[str, Any], name: str, k: int,
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side top-k over a snapshot's gathered candidate tables.

    Returns (keys (k', C) uint32, counts (k',) uint64) sorted descending,
    k' <= k; counts of the same key across devices are summed."""
    hh = snap[name]
    keys = to_numpy(hh["keys"])  # (D, S, C)
    counts = to_numpy(hh["counts"])  # (D, S)
    d, sl, c = keys.shape
    flat_keys = keys.reshape(d * sl, c)
    flat_counts = counts.reshape(d * sl).astype(np.uint64)
    nonzero = flat_counts > 0
    flat_keys, flat_counts = flat_keys[nonzero], flat_counts[nonzero]
    if not len(flat_keys):
        return flat_keys, flat_counts
    uniq, inv = np.unique(flat_keys, axis=0, return_inverse=True)
    summed = np.zeros(len(uniq), np.uint64)
    np.add.at(summed, inv.reshape(-1), flat_counts)
    order = np.argsort(summed)[::-1][:k]
    return uniq[order], summed[order]
