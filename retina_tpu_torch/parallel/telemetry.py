"""Single-card telemetry (port of retina_tpu/parallel/telemetry.py at D=1).

``Telemetry`` wraps the pipeline with the reference ShardedTelemetry's
interface on a one-device mesh, where every collective is an identity: the
step also counts host-side losses into totals[7] and returns the per-row
report lanes with a leading device axis of size 1; ``snapshot`` returns
the same keys, shapes and dtypes (u32 leaves as int32 bit patterns),
including the leading device axis of size 1 on the gathered candidate
tables and ``ct_totals``, every leaf a view of one flat buffer that one
launch of K17 writes (``snapshot_flat_dispatch``); ``inv_decode`` decodes
the invertible sketches at a window close. ``fleet_export`` copies the
window's sketches in the fleet array catalog (``fleet/codec.py``) and
``snapshot_host`` reads the flat snapshot back in one copy
(``snapshot_flat_dispatch`` / ``_finish``).
State has no device axis. Multi-card sharding (NCCL collectives) is a
later slice.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import PipelineConfig, PipelineState, TelemetryPipeline
from retina_tpu_torch.ops.conntrack import active_connections_plain
from retina_tpu_torch.ops.hyperloglog import estimate_plain
from retina_tpu_torch.u32 import M32, narrow, to_numpy, widen

# (key path, shape, dtype) of each leaf of a flat snapshot, in buffer order.
FlatLayout = list[tuple[tuple, tuple, torch.dtype]]


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
        """One (B, 16) batch; ``lost`` (host-side overflow) adds to totals[7].
        The summary's per-row lanes carry a leading device axis of 1."""
        state, summary = self.pipeline.step(
            state, records, n_valid, now_s, ident, apiserver_ip,
            filter_map=self._no_filter if filter_map is None else filter_map,
            sample_k=sample_k,
        )
        if int(lost) & M32:
            state.totals[7:8].copy_(narrow(widen(state.totals[7:8]) + (int(lost) & M32)))
        for key in ("report_mask", "report_packets", "report_bytes"):
            summary[key] = summary[key][None]
        return state, summary

    def end_window(self, state: PipelineState, z_thresh: float = 4.0,
                   ) -> tuple[PipelineState, dict[str, torch.Tensor]]:
        return self.pipeline.end_window(state, z_thresh)

    def snapshot(self, state: PipelineState, now_s: int) -> dict[str, Any]:
        """Scrape-time readout: one launch of K17 writes the flat buffer,
        and every leaf is a view of it, so later in-place steps do not
        change it."""
        return _unflatten(*self.snapshot_flat_dispatch(state, now_s))

    @staticmethod
    def readout_jobs(state: PipelineState) -> list[tuple[tuple, tuple, tuple, torch.dtype]]:
        """(key path, readout job, shape, dtype) of every snapshot leaf, in
        the reference's leaf order (sorted keys, depth first): the leaves
        the snapshot copies ("copy"; the gathered candidate tables and
        ``ct_totals`` with a leading device axis of 1), the HLL estimates
        ("hll") and the live connections ("live")."""
        s = state

        def copy(t, lead=False):
            return ("copy", t), (1,) * lead + tuple(t.shape), t.dtype

        def hh(sk):
            return {"keys": copy(sk.table.key_rows, True), "counts": copy(sk.table.counts, True)}

        def hll(bank):
            return ("hll", bank.registers), (bank.n_groups,), torch.float32

        tree = {
            "pod_forward": copy(s.pod_forward),
            "pod_drop": copy(s.pod_drop),
            "pod_tcpflags": copy(s.pod_tcpflags),
            "pod_dns": copy(s.pod_dns),
            "pod_retrans": copy(s.pod_retrans),
            "node_counters": copy(s.node_counters),
            "totals": copy(s.totals),
            "ct_totals": copy(s.ct_totals, True),
            "lat_hist": copy(s.lat_hist),
            "hll_flows": hll(s.hll_flows),
            "hll_src_per_reason": hll(s.hll_src_per_reason),
            "hll_src_per_pod": hll(s.hll_src_per_pod),
            "flow_hh": hh(s.flow_hh),
            "svc_hh": hh(s.svc_hh),
            "dns_hh": hh(s.dns_hh),
            "active_conns": (("live", s.conntrack.keys, s.conntrack.vals), (), torch.int32),
        }
        return [(path, *leaf) for path, leaf in _sorted_leaves(tree)]

    def fleet_export(self, state: PipelineState) -> dict[str, torch.Tensor]:
        """The window's sketches for the fleet tier and the time-travel
        ring, named by the fleet array catalog, as copies on the card: the
        window close that follows zeroes the entropy histograms in place,
        so the export must not alias the state. At D=1 the reference's
        psum, pmax and candidate-table fold are the identity."""
        s = state
        out: dict[str, torch.Tensor] = {}
        for fam, hh in (("flow", s.flow_hh), ("svc", s.svc_hh), ("dns", s.dns_hh)):
            out[f"{fam}_cms"] = hh.cms.table.clone()
            out[f"{fam}_keys"] = hh.table.key_rows.clone()
            out[f"{fam}_counts"] = hh.table.counts.clone()
        out["hll_flows"] = s.hll_flows.registers.clone()
        out["hll_src_per_pod"] = s.hll_src_per_pod.registers.clone()
        out["entropy"] = s.entropy.counts.clone()
        out["totals"] = s.totals.clone()
        if self.pipeline.config.enable_invertible:
            out["inv_flow_planes"] = s.inv_flow.planes.clone()
            out["inv_flow_weights"] = s.inv_flow.weights.clone()
            out["inv_hi_planes"] = s.inv_hi.planes.clone()
            out["inv_hi_weights"] = s.inv_hi.weights.clone()
        return out

    @staticmethod
    def fleet_seeds(state: PipelineState) -> dict[str, int]:
        """Per-family sketch hash seeds, shipped in every frame so that the
        aggregator refuses cross-seed merges."""
        return {
            "flow": int(state.flow_hh.cms.seed),
            "svc": int(state.svc_hh.cms.seed),
            "dns": int(state.dns_hh.cms.seed),
            "hll_flows": int(state.hll_flows.seed),
            "hll_src_per_pod": int(state.hll_src_per_pod.seed),
            "entropy": int(state.entropy.seed),
            "inv_flow": int(state.inv_flow.seed),
            "inv_hi": int(state.inv_hi.seed),
        }

    def snapshot_flat_dispatch(self, state: PipelineState,
                               now_s: int) -> tuple[torch.Tensor, FlatLayout]:
        """The snapshot as one flat int32 buffer on the card, written by one
        launch of K17: every leaf (int32 or float32), in the reference's
        leaf order (sorted keys, depth first), bitcast to int32 and
        flattened; and the leaf layout that ``snapshot_flat_finish`` needs
        to cut it up again."""
        leaves = self.readout_jobs(state)
        flat = kops.snapshot_flat([job for _, job, _, _ in leaves], now_s)
        return flat, [(path, shape, dtype) for path, _, shape, dtype in leaves]

    @staticmethod
    def snapshot_flat_finish(flat: torch.Tensor | np.ndarray,
                             layout: FlatLayout) -> dict[str, Any]:
        """A flat snapshot buffer (on the card or read back) and its layout
        -> the snapshot dict of CPU tensors, with ``snapshot``'s keys, shapes
        and dtypes."""
        if isinstance(flat, np.ndarray):
            flat = torch.from_numpy(np.ascontiguousarray(flat).view(np.int32))
        return _unflatten(flat.cpu(), layout)

    def snapshot_host(self, state: PipelineState, now_s: int) -> dict[str, Any]:
        """The snapshot read back to the host in one copy (CPU tensors)."""
        flat, layout = self.snapshot_flat_dispatch(state, now_s)
        return self.snapshot_flat_finish(flat.cpu(), layout)

    def inv_decode(self, state: PipelineState, min_weight: int = 0) -> dict[str, torch.Tensor]:
        """Window-close invertible decode, verified against flow_hh's CMS:
        ``keys`` (M, C) int32, ``est`` (M,) int32, ``ok`` (M,) bool and
        ``tier`` (M,) int32 (0 the main region, 1 the priority region),
        M = D*W_flow + D*W_hi. Rows with ``ok`` false are noise; a key can
        decode from up to D buckets. Both regions decode in one launch of
        K15 (``kops.inv_decode_many``), which writes ``keys``, ``ok`` and
        ``tier``; the query and ``decode_verified``'s filter of all M rows
        are one launch of K10 (``kops.cms_query_many``), reading the key
        columns at their stride, which writes ``est`` and ``ok``."""
        cms = state.flow_hh.cms
        keys, ok, tier = kops.inv_decode_many([
            (inv.planes, inv.weights, inv.seed, t)
            for t, inv in enumerate((state.inv_flow, state.inv_hi))])
        est, ok = kops.cms_query_many([(cms.table, cms.seed, list(keys.t()), ok, min_weight)])
        return {"keys": keys, "est": est, "ok": ok, "tier": tier}


def _unflatten(flat: torch.Tensor, layout: FlatLayout) -> dict[str, Any]:
    """The snapshot dict of a flat buffer: each leaf a view of it."""
    out: dict[str, Any] = {}
    chunks = flat.split([math.prod(shape) for _, shape, _ in layout])
    for (path, shape, dtype), chunk in zip(layout, chunks):
        if dtype != torch.int32:
            chunk = chunk.view(dtype)
        chunk = chunk.view(shape)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = chunk
    return out


def readout_plain(jobs: list[tuple], plan: kops.ReadoutPlan, now_s: int) -> torch.Tensor:
    """Plain version of K17's readout (``kops.snapshot_flat``): a fresh flat
    int32 buffer holding, at each job's offset in ``plan``, the words of a
    ("copy", leaf), the estimates of a ("hll", registers) bitcast to int32
    and the live count of a ("live", keys, vals) at ``now_s``."""
    flat = torch.empty((plan.total,), dtype=torch.int32, device=jobs[0][1].device)
    for job, off, n in zip(jobs, plan.offsets, plan.words):
        if job[0] == "copy":
            words = job[1].reshape(-1).view(torch.int32)
        elif job[0] == "hll":
            words = estimate_plain(job[1]).view(torch.int32)
        else:
            words = active_connections_plain(job[1], job[2], now_s).reshape(1)
        flat[off: off + n] = words
    return flat


def _sorted_leaves(d: dict, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(key path, leaf) of a nested dict, keys sorted at every level."""
    out = []
    for k in sorted(d):
        v = d[k]
        out += _sorted_leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


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
