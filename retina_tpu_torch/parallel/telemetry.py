"""Telemetry over one card and over D shards (port of
retina_tpu/parallel/telemetry.py).

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

``ShardedTelemetry`` is the reference's class: one ``Telemetry`` a local
shard of a mesh (``parallel/mesh.py``), each shard's state on its device,
events partitioned by connection (``parallel/partition.py``), and the
reference's five collective programs as merges (``parallel/collectives.py``:
K8 in the process, ``torch.distributed`` across processes):

    step          psum of the summary's events and ct_reports; host losses
                  on global shard 0 only; the report lanes (D, B)
    end_window    psum of the entropy counts, then K16 once on the union;
                  every shard takes the same EWMA state and zeroes its window
    snapshot      psum of the rectangles, node_counters, totals, lat_hist and
                  each shard's live connections; pmax of the HLL registers
                  before the estimate; gather of the candidate tables and
                  ct_totals; then one K17 launch writes the flat buffer
    fleet_export  psum of the CMS tables, entropy, totals and invertible
                  planes and weights; pmax of the two HLL banks; the D
                  candidate tables of each family joined by K9 (one launch)
    inv_decode    psum of the flow CMS, planes and weights; K15 and K10 once
                  on the union

Conntrack tables are not merged: connection-consistent partitioning makes
them disjoint. At one shard with no process group every method is the one
shard's ``Telemetry``'s: no copy, no fold.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.models.identity import IdentityMap
from retina_tpu_torch.models.pipeline import (
    EWMA_MIN_WINDOWS,
    PipelineConfig,
    PipelineState,
    TelemetryPipeline,
)
from retina_tpu_torch.ops.conntrack import active_connections_plain
from retina_tpu_torch.ops.hyperloglog import estimate_plain
from retina_tpu_torch.parallel.collectives import gather_many, psum, reduce_many
from retina_tpu_torch.parallel.mesh import Mesh
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
        copies: dict[str, Any] = {k: getattr(s, k) for k in SUM_LEAVES}
        copies["ct_totals"] = s.ct_totals[None]
        for name in HH_LEAVES:
            table = getattr(s, name).table
            copies[name] = {"keys": table.key_rows[None], "counts": table.counts[None]}
        hlls = {k: getattr(s, k).registers for k in HLL_LEAVES}
        return _readout_jobs(copies, hlls, ("live", s.conntrack.keys, s.conntrack.vals))

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
        return decode_regions(cms.table, cms.seed, [
            (inv.planes, inv.weights, inv.seed, t)
            for t, inv in enumerate((state.inv_flow, state.inv_hi))], min_weight)


def decode_regions(cms_table: torch.Tensor, cms_seed: int, regions: list[tuple],
                   min_weight: int) -> dict[str, torch.Tensor]:
    """Decode the invertible ``regions`` (planes, weights, seed, tier) in one
    launch of K15 and verify every row against the Count-Min table in one
    launch of K10 (``Telemetry.inv_decode``'s outputs)."""
    keys, ok, tier = kops.inv_decode_many(regions)
    est, ok = kops.cms_query_many([(cms_table, cms_seed, list(keys.t()), ok, min_weight)])
    return {"keys": keys, "est": est, "ok": ok, "tier": tier}


# The snapshot's leaves by merge: summed, HLL banks (maxed, then estimated)
# and candidate tables (gathered), as the reference's ``_build_snapshot``.
SUM_LEAVES = ("pod_forward", "pod_drop", "pod_tcpflags", "pod_dns", "pod_retrans",
              "node_counters", "totals", "lat_hist")
HLL_LEAVES = ("hll_flows", "hll_src_per_reason", "hll_src_per_pod")
HH_LEAVES = ("flow_hh", "svc_hh", "dns_hh")
# The fleet catalog's families: (name, sketch).
FAMILIES = (("flow", "flow_hh"), ("svc", "svc_hh"), ("dns", "dns_hh"))


def _readout_jobs(copies: dict[str, Any], hlls: dict[str, torch.Tensor],
                  live: tuple) -> list[tuple[tuple, tuple, tuple, torch.dtype]]:
    """The readout of a snapshot: a "copy" job a leaf of ``copies`` (a
    tensor, or a dict of them), an "hll" job a register bank of ``hlls`` and
    ``live`` (a "live" job, or a "copy" of the live count) as
    ``active_conns``, in the reference's leaf order."""
    def copy(t):
        return ("copy", t), tuple(t.shape), t.dtype

    tree: dict[str, Any] = {k: ({kk: copy(t) for kk, t in v.items()} if isinstance(v, dict)
                                else copy(v)) for k, v in copies.items()}
    for k, regs in hlls.items():
        tree[k] = ("hll", regs), (regs.shape[0],), torch.float32
    tree["active_conns"] = live, (), torch.int32
    return [(path, *leaf) for path, leaf in _sorted_leaves(tree)]


class ShardedTelemetry:
    """TelemetryPipeline spread over a shard mesh: one ``Telemetry`` a local
    shard, the states a list in shard order, the reference's interface."""

    def __init__(self, config: PipelineConfig, mesh: Mesh):
        self.mesh = mesh
        self.shards = [Telemetry(config, dev) for dev in mesh.devices]
        self.pipeline = self.shards[0].pipeline
        self.device = mesh.lead
        self.axes = tuple(mesh.axis_names)
        self.n_devices = mesh.size
        # One shard and no group: every collective is the identity.
        self._one = mesh.local_size == 1 and mesh.group is None

    @staticmethod
    def _list(states) -> list[PipelineState]:
        return list(states) if isinstance(states, (list, tuple)) else [states]

    def init_state(self) -> list[PipelineState]:
        """Zero state, one a local shard on its device."""
        return [t.init_state() for t in self.shards]

    def step(self, states, records, n_valid, now_s: int, ident, apiserver_ip: int = 0,
             filter_map=None, lost: int = 0, sample_k: int = 1,
             ) -> tuple[list[PipelineState], dict[str, torch.Tensor]]:
        """Shard i steps ``records[i]`` ((B, 16) on its device) and
        ``n_valid[i]``; ``ident`` and ``filter_map`` are one map, or one a
        shard on its device. ``lost`` adds to totals[7] of global shard 0
        only, so a snapshot counts it once. The summary's ``events`` and
        ``ct_reports`` are summed over the mesh; its per-row lanes are (D,
        B), gathered in global shard order."""
        states = self._list(states)

        def pick(x, i):
            return x[i] if isinstance(x, (list, tuple)) else x

        if self._one:
            st, summ = self.shards[0].step(
                states[0], records[0], int(n_valid[0]), now_s, pick(ident, 0), apiserver_ip,
                filter_map=pick(filter_map, 0), lost=lost, sample_k=sample_k)
            return [st], summ
        summs = []
        for i, tel in enumerate(self.shards):
            states[i], summ = tel.step(
                states[i], records[i], int(n_valid[i]), now_s, pick(ident, i), apiserver_ip,
                filter_map=pick(filter_map, i),
                lost=lost if self.mesh.global_index(i) == 0 else 0, sample_k=sample_k)
            summs.append(summ)
        events, reports = reduce_many(self.mesh, [
            ([s["events"] for s in summs], "sum_u32"),
            ([s["ct_reports"] for s in summs], "sum_u32")])
        mask, packets, nbytes = gather_many(self.mesh, [
            [s["report_mask"][0].view(torch.uint8) for s in summs],
            [s["report_packets"][0] for s in summs],
            [s["report_bytes"][0] for s in summs]])
        return states, {"events": events, "ct_reports": reports,
                        "report_mask": mask.view(torch.bool), "report_packets": packets,
                        "report_bytes": nbytes}

    def end_window(self, states, z_thresh: float = 4.0,
                   ) -> tuple[list[PipelineState], dict[str, torch.Tensor]]:
        """Close the window of the union: the entropy counts summed over the
        mesh, then one launch of K16 on them with shard 0's EWMA state, which
        every other shard copies (the EWMA state stays replicated); then each
        shard's window is zeroed."""
        states = self._list(states)
        if self._one:
            st, out = self.shards[0].end_window(states[0], z_thresh)
            return [st], out
        counts = psum(self.mesh, [s.entropy.counts for s in states])
        a = states[0].anomaly
        h, flags, z = kops.window_close(counts, a.mean, a.var, a.n_obs, a.alpha, z_thresh,
                                        EWMA_MIN_WINDOWS)
        for s in states:
            if s is not states[0]:
                for name in ("mean", "var", "n_obs"):
                    getattr(s.anomaly, name).copy_(getattr(a, name))
            s.entropy.counts.zero_()
        return states, {"entropy_bits": h, "anomaly": flags, "zscore": z}

    def snapshot(self, states, now_s: int) -> dict[str, Any]:
        """The merged scrape-time readout (``Telemetry.snapshot``'s keys;
        the candidate tables and ``ct_totals`` carry a leading axis of D)."""
        return _unflatten(*self.snapshot_flat_dispatch(states, now_s))

    def snapshot_flat_dispatch(self, states, now_s: int) -> tuple[torch.Tensor, FlatLayout]:
        """The merged snapshot as one flat int32 buffer on the lead device
        and its layout: every psum and pmax of the snapshot in one K8
        launch (each shard's live connections counted on its device by a
        one-job K17 launch first), the gathers stacked, and one K17 launch
        that copies the merged leaves and estimates the merged HLL banks."""
        states = self._list(states)
        if self._one:
            return self.shards[0].snapshot_flat_dispatch(states[0], now_s)
        now = int(now_s) & M32
        live = [kops.ct_active(s.conntrack.keys, s.conntrack.vals, now) for s in states]
        merged = reduce_many(self.mesh, [([getattr(s, k) for s in states], "sum_u32")
                                         for k in SUM_LEAVES]
                             + [(live, "sum_u32")]
                             + [([getattr(s, k).registers for s in states], "max_u32")
                                for k in HLL_LEAVES])
        gathered = gather_many(self.mesh, [[s.ct_totals for s in states]] + [
            [getattr(getattr(s, name).table, leaf) for s in states]
            for name in HH_LEAVES for leaf in ("key_rows", "counts")])
        copies: dict[str, Any] = dict(zip(SUM_LEAVES, merged))
        copies["ct_totals"] = gathered[0]
        for i, name in enumerate(HH_LEAVES):
            copies[name] = {"keys": gathered[1 + 2 * i], "counts": gathered[2 + 2 * i]}
        hlls = dict(zip(HLL_LEAVES, merged[len(SUM_LEAVES) + 1:]))
        leaves = _readout_jobs(copies, hlls, ("copy", merged[len(SUM_LEAVES)]))
        flat = kops.snapshot_flat([job for _, job, _, _ in leaves], now)
        return flat, [(path, shape, dtype) for path, _, shape, dtype in leaves]

    snapshot_flat_finish = staticmethod(Telemetry.snapshot_flat_finish)

    def snapshot_host(self, states, now_s: int) -> dict[str, Any]:
        """The merged snapshot read back to the host in one copy."""
        flat, layout = self.snapshot_flat_dispatch(states, now_s)
        return self.snapshot_flat_finish(flat.cpu(), layout)

    def fleet_export(self, states) -> dict[str, torch.Tensor]:
        """The union's sketches in the fleet array catalog, new tensors on
        the lead device: the sums and maxes in one K8 launch, and each
        family's D candidate tables joined slot by slot in one K9 launch
        for the three (the reference folds them with ``TopKTable.merge``
        in shard order; the join keeps the same greatest (count, key row))."""
        states = self._list(states)
        if self._one:
            return self.shards[0].fleet_export(states[0])
        leaves = [(f"{fam}_cms", "sum_u32", [getattr(s, hh).cms.table for s in states])
                  for fam, hh in FAMILIES]
        leaves += [("hll_flows", "max_u32", [s.hll_flows.registers for s in states]),
                   ("hll_src_per_pod", "max_u32", [s.hll_src_per_pod.registers for s in states]),
                   ("entropy", "sum_f32", [s.entropy.counts for s in states]),
                   ("totals", "sum_u32", [s.totals for s in states])]
        if self.pipeline.config.enable_invertible:
            leaves += [(f"{r}_{leaf}", "sum_u32", [getattr(getattr(s, r), leaf) for s in states])
                       for r in ("inv_flow", "inv_hi") for leaf in ("planes", "weights")]
        merged = dict(zip([k for k, _, _ in leaves],
                          reduce_many(self.mesh, [(ts, op) for _, op, ts in leaves])))
        gathered = gather_many(self.mesh, [
            [getattr(getattr(s, hh).table, leaf) for s in states]
            for _, hh in FAMILIES for leaf in ("key_rows", "counts")])
        joined = kops.topk_join_many([(gathered[2 * i], gathered[2 * i + 1])
                                      for i in range(len(FAMILIES))])
        out: dict[str, torch.Tensor] = {}
        for (fam, _), (keys, counts) in zip(FAMILIES, joined):
            out[f"{fam}_cms"] = merged.pop(f"{fam}_cms")
            out[f"{fam}_keys"] = keys
            out[f"{fam}_counts"] = counts
        out.update(merged)
        return out

    fleet_seeds = staticmethod(Telemetry.fleet_seeds)

    def inv_decode(self, states, min_weight: int = 0) -> dict[str, torch.Tensor]:
        """Decode the union: the flow CMS and both regions' planes and
        weights summed over the mesh in one K8 launch, then K15 and K10 once
        (``Telemetry.inv_decode``'s outputs)."""
        states = self._list(states)
        if self._one:
            return self.shards[0].inv_decode(states[0], min_weight)
        s0 = states[0]
        cms, fp, fw, hp, hw = reduce_many(self.mesh, [
            ([get(s) for s in states], "sum_u32") for get in (
                lambda s: s.flow_hh.cms.table, lambda s: s.inv_flow.planes,
                lambda s: s.inv_flow.weights, lambda s: s.inv_hi.planes,
                lambda s: s.inv_hi.weights)])
        return decode_regions(cms, s0.flow_hh.cms.seed, [(fp, fw, s0.inv_flow.seed, 0),
                                                         (hp, hw, s0.inv_hi.seed, 1)], min_weight)


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
