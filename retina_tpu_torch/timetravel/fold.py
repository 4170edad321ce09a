"""The range fold over ring slots and the range queries (port of
retina_tpu/timetravel/fold.py).

A range query stacks the selected ring slots and runs the batched
reduction the fleet aggregator runs across nodes: sum for CM tables,
entropy histograms, totals and invertible planes (K8,
``kernels/csrc/fold.cu``), max for HLL register banks (K8) and the
join-semilattice fold for the heavy-hitter candidate tables (K9,
``kernels/csrc/topk_join.cu``). ``stack_slots`` and ``fold_stacked`` are
that reduction; ``fleet/aggregator.py`` merges an epoch through the same
two functions.

Each array of the selected slots is copied once into one host buffer
(pinned when the device is a card) and from there once to the card. The
fold's result comes back as host numpy in the catalog's dtypes (uint32,
float32). The queries over a folded snapshot (``range_extract``,
``range_topk``, ``range_decode``, ...) run K17 for the HLL estimate, K16
for the entropy bits and K15 (``kernels/csrc/inv_decode.cu``, both regions
in one launch) for the invertible decode, and every Count-Min point query
goes through K10 (``kernels/csrc/cms_query.cu``).

The reference caches one compiled executable per span length and array
signature, in memory and on disk (``fold.py:43-88``). Nothing here is
compiled per shape, so there is no such cache.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.ops.countmin import CountMinSketch
from retina_tpu_torch.ops.entropy import EntropyWindow
from retina_tpu_torch.ops.hyperloglog import HyperLogLog
from retina_tpu_torch.ops.invertible import InvertibleSketch
from retina_tpu_torch.u32 import M32, from_numpy, narrow, to_numpy, widen

# Ring slots follow the fleet array catalog (fleet/codec.py).
HH_FAMILIES = ("flow", "svc", "dns")
ENTROPY_DIMS = ("src_ip", "dst_ip", "dst_port")


def fold_plain(stacked: torch.Tensor, op: str) -> torch.Tensor:
    """Plain version of K8: (N, *shape) -> (*shape). The u32 sum adds the
    int32 bit patterns in int64 (each differs from its u32 value by 0 or
    2^32, so the sum is the same mod 2^32) and the max compares widened u32
    values, both stored back mod 2^32; the f32 sum adds slot by slot in slot
    order, as each kernel thread does, so the two are bit-equal."""
    if op == "sum_f32":
        acc = stacked[0].clone()
        for k in range(1, stacked.shape[0]):
            acc = acc + stacked[k]
        return acc
    if op == "sum_u32":
        return narrow(stacked.sum(dim=0, dtype=torch.int64) & M32)
    return narrow(widen(stacked).amax(dim=0))


def stack_slots(slots: list[dict[str, np.ndarray]], names: list[str],
                device: torch.device) -> dict[str, torch.Tensor]:
    """One (N, *shape) tensor per named array on ``device``: the slots'
    host arrays (uint32 or float32) are copied into one host buffer per
    array, pinned for a card, which crosses in one copy."""
    pin = device.type == "cuda"
    out = {}
    for name in names:
        first = np.asarray(slots[0][name])
        is_float = first.dtype == np.float32
        buf = torch.empty((len(slots), *first.shape),
                          dtype=torch.float32 if is_float else torch.int32, pin_memory=pin)
        host = buf.numpy()
        for i, s in enumerate(slots):
            a = np.asarray(s[name])
            if a.shape != first.shape:
                raise ValueError(f"array {name!r}: slot {i} has shape {a.shape}, "
                                 f"slot 0 {first.shape}")
            host[i] = a if is_float else np.asarray(a, dtype=np.uint32).view(np.int32)
        out[name] = buf.to(device, non_blocking=pin)
    return out


def fold_stacked(stacked: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The batched merge of ``timetravel.range_fold`` and ``fleet.merge``
    over stacked arrays on one device: ``hll_*`` by u32 max, the
    ``<fam>_keys``/``<fam>_counts`` pairs by the candidate-table join, every
    other array by sum (f32 for float arrays, u32 wrapping otherwise). The
    sums and maxes take one launch of K8 (``kops.fold_many``) in all, the
    joins of the families present one launch of K9 (``kops.topk_join_many``)."""
    items = {name: (arr, "max_u32" if name.startswith("hll_") else
                    "sum_f32" if arr.dtype == torch.float32 else "sum_u32")
             for name, arr in stacked.items() if not name.endswith(("_keys", "_counts"))}
    out = dict(zip(items, kops.fold_many(list(items.values()))))
    fams = [fam for fam in HH_FAMILIES if f"{fam}_keys" in stacked]
    if fams:
        joined = kops.topk_join_many([(stacked[f"{fam}_keys"], stacked[f"{fam}_counts"])
                                      for fam in fams])
        for fam, (keys, counts) in zip(fams, joined):
            out[f"{fam}_keys"], out[f"{fam}_counts"] = keys, counts
    return out


def host_arrays(arrays: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Tensors -> host numpy in the catalog's dtypes (int32 bit patterns
    become uint32)."""
    return {k: to_numpy(v) for k, v in arrays.items()}


class RangeFold:
    """Folds N ring slots into one snapshot on one device."""

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.device = resolve_device(device)

    def fold(self, slots: list[dict[str, Any]], seeds: dict[str, int],
             ) -> dict[str, np.ndarray]:
        """Fold N ring slots (dicts of host arrays in the fleet array
        catalog) into one merged host snapshot. ``seeds`` is the slots'
        common seed dict (the join needs no seed: all tables share one)."""
        if not slots:
            raise ValueError("range fold over an empty slot selection")
        names = sorted(set.intersection(*(set(s) for s in slots)))
        return host_arrays(fold_stacked(stack_slots(slots, names, self.device)))


def _cms(merged: dict[str, np.ndarray], fam: str, seeds: dict[str, int],
         device: torch.device) -> CountMinSketch:
    return CountMinSketch(table=from_numpy(merged[f"{fam}_cms"], device),
                          seed=int(seeds.get(fam, 0)))


def entropy_bits_by_dim(counts: torch.Tensor, seed: int) -> dict[str, float]:
    """Entropy bits of each histogram of a (3, K) bank, by dimension."""
    bits = EntropyWindow(counts=counts, seed=seed).entropy_bits().cpu().numpy()
    return {dim: float(bits[i]) for i, dim in enumerate(ENTROPY_DIMS) if i < len(bits)}


def cardinality(registers: torch.Tensor, seed: int) -> float:
    """The HLL estimate of group 0 of a register bank."""
    return float(HyperLogLog(registers=registers, seed=seed).estimate()[0])


def range_extract(merged: dict[str, np.ndarray], seeds: dict[str, int],
                  device: torch.device | str | None = None) -> dict[str, Any]:
    """The derived answers of a folded snapshot: ``cardinality`` (float,
    the HLL estimate of ``hll_flows``), ``entropy_bits`` (dim -> bits) and
    ``<fam>_est``, the span CMS re-count (K10) of every row of
    ``merged[<fam>_keys]``, uint32 and aligned with it."""
    dev = resolve_device(device)
    out: dict[str, Any] = {}
    if "hll_flows" in merged:
        out["cardinality"] = cardinality(from_numpy(merged["hll_flows"], dev),
                                         int(seeds.get("hll_flows", 0)))
    if "entropy" in merged:
        out["entropy_bits"] = entropy_bits_by_dim(from_numpy(merged["entropy"], dev),
                                                  int(seeds.get("entropy", 0)))
    for fam in HH_FAMILIES:
        kname = f"{fam}_keys"
        if kname not in merged or f"{fam}_cms" not in merged:
            continue
        cms = _cms(merged, fam, seeds, dev)
        kr = from_numpy(merged[kname], dev)
        out[f"{fam}_est"] = to_numpy(kops.cms_query(
            cms.table, cms.seed, [kr[:, c] for c in range(kr.shape[1])]))
    return out


def range_topk(merged: dict[str, np.ndarray], seeds: dict[str, int], fam: str = "flow",
               k: int = 32, candidates: np.ndarray | None = None,
               est: np.ndarray | None = None, device: torch.device | str | None = None,
               ) -> tuple[np.ndarray, np.ndarray]:
    """Top-k over the span: candidate keys (the folded join table, or
    decoded invertible keys) counted by the summed CMS (K10). ``est``
    (range_extract's ``<fam>_est``, aligned with the folded table) skips
    the re-count."""
    kname, cname = f"{fam}_keys", f"{fam}_counts"
    if candidates is None and est is not None and kname in merged:
        cand, cest = merged[kname], est.astype(np.uint64)
        occupied = merged[cname] > 0
        cand, cest = cand[occupied], cest[occupied]
        order = np.argsort(cest)[::-1][:k]
        sel = cest[order] > 0
        return cand[order][sel], cest[order][sel]
    if candidates is not None and len(candidates):
        cand = candidates.astype(np.uint32).reshape(len(candidates), -1)
    elif kname in merged:
        cand = merged[kname][merged[cname] > 0]
    else:
        return np.zeros((0, 0), np.uint32), np.zeros((0,), np.uint64)
    if not len(cand):
        return np.zeros((0, 0), np.uint32), np.zeros((0,), np.uint64)
    cand = np.unique(cand, axis=0)
    dev = resolve_device(device)
    cms = _cms(merged, fam, seeds, dev)
    cd = from_numpy(cand, dev)
    est = to_numpy(cms.query([cd[:, c] for c in range(cd.shape[1])])).astype(np.uint64)
    order = np.argsort(est)[::-1][:k]
    sel = est[order] > 0
    return cand[order][sel], est[order][sel]


def range_cardinality(merged: dict[str, np.ndarray], seeds: dict[str, int],
                      device: torch.device | str | None = None) -> float:
    """Distinct flows over the span (max-merged HLL registers)."""
    if "hll_flows" not in merged:
        return 0.0
    return cardinality(from_numpy(merged["hll_flows"], resolve_device(device)),
                       int(seeds.get("hll_flows", 0)))


def range_entropy(merged: dict[str, np.ndarray], seeds: dict[str, int],
                  device: torch.device | str | None = None) -> dict[str, float]:
    """Plug-in Shannon entropy of the span-summed histograms."""
    if "entropy" not in merged:
        return {}
    return entropy_bits_by_dim(from_numpy(merged["entropy"], resolve_device(device)),
                               int(seeds.get("entropy", 0)))


def rank_decoded(all_keys: list[np.ndarray], all_est: list[np.ndarray],
                 all_tier: list[np.ndarray]) -> dict[str, Any]:
    """Decoded keys of the regions -> the reference's result: unique keys
    sorted by descending estimate with their ``est`` and ``tier``, and
    ``sources`` = (src_ips, packets) summed per source, descending."""
    keys = np.concatenate(all_keys)
    est = np.concatenate(all_est)
    tier = np.concatenate(all_tier)
    if len(keys):
        # A key decodes from up to depth buckets per region.
        uniq, idx = np.unique(keys, axis=0, return_index=True)
        keys, est, tier = uniq, est[idx], tier[idx]
        order = np.argsort(est)[::-1]
        keys, est, tier = keys[order], est[order], tier[order]
        srcs, sinv = np.unique(keys[:, 0], return_inverse=True)
        spk = np.zeros(len(srcs), np.uint64)
        np.add.at(spk, sinv.reshape(-1), est)
        sorder = np.argsort(spk)[::-1]
        sources = (srcs[sorder], spk[sorder])
    else:
        sources = (np.zeros((0,), np.uint32), np.zeros((0,), np.uint64))
    return {"keys": keys, "est": est, "tier": tier, "sources": sources}


def decode_regions(arrays: dict[str, torch.Tensor], seeds: dict[str, int],
                   cms: CountMinSketch) -> dict[str, Any] | None:
    """The invertible decode of the ``inv_flow`` (tier 0) and ``inv_hi``
    (tier 1) regions of a merged snapshot (tensors), the regions present in
    one launch of K15, verified against ``cms`` (one launch of K10), ranked
    by ``rank_decoded``; None when no region is present."""
    regions = [(arrays[f"{region}_planes"], arrays[f"{region}_weights"],
                int(seeds.get(region, 0)), tier)
               for region, tier in (("inv_flow", 0), ("inv_hi", 1))
               if f"{region}_planes" in arrays]
    if not regions:
        return None
    keys, ok, tiers = kops.inv_decode_many(regions)
    est, ok = kops.cms_query_many([(cms.table, cms.seed, list(keys.t()), ok, 0)])
    okh = ok.cpu().numpy()
    return rank_decoded([to_numpy(keys)[okh]], [to_numpy(est)[okh].astype(np.uint64)],
                        [to_numpy(tiers)[okh]])


def range_decode(merged: dict[str, np.ndarray], seeds: dict[str, int],
                 device: torch.device | str | None = None) -> dict[str, Any] | None:
    """Heavy keys recovered from the span-summed invertible planes,
    verified against the span-summed flow CMS: ``keys``, ``est``, ``tier``
    sorted descending and ``sources`` = (src_ips, packets); None when the
    slots carried no invertible state."""
    if "inv_flow_planes" not in merged or "flow_cms" not in merged:
        return None
    dev = resolve_device(device)
    regions = {k: from_numpy(v, dev) for k, v in merged.items() if k.startswith("inv_")}
    return decode_regions(regions, seeds, _cms(merged, "flow", seeds, dev))
