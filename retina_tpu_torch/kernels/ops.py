"""One wrapper per CUDA kernel: checks, dispatch, launch count.

A wrapper checks device, dtype, shape and contiguity and raises on what the
kernel does not take. For tensors on the CPU it runs the kernel's plain
PyTorch version (in the op's own module); for CUDA tensors it launches the
kernel on PyTorch's current stream and raises if the launch fails. There
is no fallback from the kernel to the plain version.

``launch_counts()`` counts kernel launches per wrapper, so a run can show
that it went through the kernels. ``plain_versions()`` runs the plain
versions on whatever device the tensors lie on; it exists to hold a kernel
against its plain version on the card, and launches nothing.

State tensors are int32 holding u32 bit patterns (float32 for the entropy
histogram); the kernels read them as ``uint32_t*``.

A wrapper whose kernel would have no element to work on (an empty fold,
join or query) returns its empty result without a launch.
"""

from __future__ import annotations

import array
import contextlib
import ctypes
from typing import Iterator, NamedTuple

import numpy as np
import torch

from retina_tpu_torch.kernels import build

_VP, _LL, _U32, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_int
_FLT = ctypes.c_float
_COLS = [_VP, _LL] * 4 + [_INT]

_ARGTYPES = {
    "step_rows": [_VP, _LL, _U32, _U32, _VP, _INT, _U32, _VP, _INT, _U32]
    + [_VP] * 9 + [_INT] * 5 + [_U32] * 4 + [_VP] * 3,
    "hh_update": [_VP, _INT, _LL, _VP],
    "cms_update": [_VP, _LL, _VP],
    "hll_update": [_VP, _INT, _LL, _VP],
    "entropy_update": [_VP, _INT, _U32] + _COLS + [_VP, _LL, _LL, _VP],
    "conntrack": [_VP, _VP, _INT, _U32] + [_VP, _LL] * 8
    + [_LL, _U32, _VP, _INT, _VP, _VP, _VP, _VP],
    "inv_update": [_VP, _INT] + _COLS + [_VP, _LL, _VP, _LL, _LL, _VP, _VP, _VP, _VP],
    "ingest_packed": [_VP, _LL, _INT, _U32, _U32, _VP, _LL, _VP],
    "ingest_new": [_VP, _LL, _VP, _LL, _VP, _U32, _U32, _VP, _LL, _VP],
    "ingest_known": [_VP, _LL, _INT, _INT, _VP, _LL, _U32, _U32, _U32, _VP, _LL, _VP],
    "fold": [_VP, _INT, _LL],
    "topk_join": [_VP],
    "cms_query": [_VP],
    "portscan_score": [_VP, _VP, _LL, _INT, _INT, _U32, _FLT, _INT, _VP],
    "bank_close": [_VP],
    "dnstunnel_score": [_VP],
    "synflood_score": [_VP],
    "latency_update": [_VP, _VP, _VP, _VP, _INT, _VP, _INT],
    "inv_decode": [_VP],
    "window_close": [_VP, _INT, _INT, _INT, _VP, _VP, _VP, _FLT, _FLT, _FLT, _VP, _VP, _VP,
                     _VP, _VP],
    "entropy_bits": [_VP, _INT, _INT, _INT, _VP, _VP, _VP],
    "snapshot_flat": [_VP],
    "hll_estimate": [_VP],
    "ct_active": [_VP],
}
# The library of each C function, where it is not the function's own name.
_LIBRARY = {"cms_update": "hh_update", "ingest_packed": "ingest", "ingest_new": "ingest", "ingest_known": "ingest",
            "portscan_score": "detect", "bank_close": "detect", "dnstunnel_score": "detect",
            "synflood_score": "detect", "latency_update": "latency",
            "entropy_bits": "window_close", "snapshot_flat": "snapshot_readout",
            "hll_estimate": "snapshot_readout", "ct_active": "snapshot_readout"}
# The C function of a launch count, where it is not the count's own name:
# the readout's three wrappers launch one kernel on tables of their own; K9
# and K15 count under their one-job wrappers' names; K12 and K13 alone are
# one-slot launches of the bank's close.
_SYMBOL = {"snapshot_flat": "snapshot_readout", "hll_estimate": "snapshot_readout",
           "ct_active": "snapshot_readout", "topk_join": "topk_join_many",
           "inv_decode": "inv_decode_many", "dnstunnel_score": "bank_close",
           "synflood_score": "bank_close"}

# Kernel launches per C function since the last reset (a call of
# hh_update counts its three phases, for up to three sketches; one of
# conntrack, ingest_new or inv_update its two; one of hll_update one, for
# up to three banks).
_launches = {name: 0 for name in _ARGTYPES}
_plain_on_card = False
_fns: dict[str, ctypes._CFuncPtr] = {}

# Per-event scratch lanes written by step_rows, in order (see
# csrc/step_rows.cu, enum Lane).
SCRATCH = (
    "src_pod", "dst_pod", "proto", "dport", "flow_w", "svc_w", "dns_w",
    "ent_w", "mask", "is_drop", "reason", "pod_grp", "pod_mask", "bytes",
    "is_priority",
)
N_SUMS = 10  # totals[0:6] then node_counters (ing pkts, ing bytes, eg pkts, eg bytes)


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Run the plain versions even for CUDA tensors (for comparisons)."""
    global _plain_on_card
    prev, _plain_on_card = _plain_on_card, True
    try:
        yield
    finally:
        _plain_on_card = prev


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = build.load(_LIBRARY.get(name, name))[_SYMBOL.get(name, name)]
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args, n_launches: int = 1) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = _fn(name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    _launches[name] += n_launches


def _on_card(device: torch.device) -> bool:
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return not _plain_on_card


def _state(t: torch.Tensor, name: str, device: torch.device,
           dtype: torch.dtype = torch.int32, shape: tuple | None = None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _col(t: torch.Tensor, name: str, n: int, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32 (u32 bits), got {t.dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")


def _key_cols(cols: list[torch.Tensor], n: int, device: torch.device) -> None:
    if not 1 <= len(cols) <= 4:
        raise ValueError(f"1 to 4 key columns, got {len(cols)}")
    for j, c in enumerate(cols):
        _col(c, f"key column {j}", n, device)


def _col_args(cols: list[torch.Tensor]) -> list:
    """Pointer and element stride of each key column, padded to four."""
    args = []
    for c in cols:
        args += [c.data_ptr(), c.stride(0)]
    return args + [None, 0] * (4 - len(cols)) + [len(cols)]


def _pow2(x: int, name: str) -> None:
    if x <= 0 or x & (x - 1):
        raise ValueError(f"{name} must be a power of two, got {x}")


# ---------------------------------------------------------------------------
# K1


STEP_CHUNK = 512  # rows a chunk of K1 (kChunk in csrc/step_rows.cu)
STEP_SLOTS = 1024  # keys K1 sums a chunk's counts under in shared memory (kSlots there)


def step_rows(records, n_valid, sample_k, ident_table, ident_seed,
              filt_table, filt_seed, pod_forward, pod_drop, pod_tcpflags,
              pod_dns, pod_retrans, node_counters, totals, cfg, apiserver_ip=None):
    """Per-event body of the step (K1): updates the rectangles, node
    counters and totals[0:6] in place and returns (scratch (15, B) int32
    with the lanes of SCRATCH, sums (10,) int32 of this batch).

    ``cfg`` is a PipelineConfig; ``filt_table`` is None when no filter map
    is consulted. With ``apiserver_ip`` (the step's latency match is on),
    the kernel also lists the batch's apiserver probes for the match, which
    ``latency_update`` on the same records finishes; the plain version lists
    nothing (``latency_update``'s plain version reads the records)."""
    dev = records.device
    if records.dim() != 2 or records.shape[1] != 16:
        raise ValueError(f"records must be (B, 16), got {tuple(records.shape)}")
    _state(records, "records", dev)
    b = records.shape[0]
    P, R, Q = cfg.n_pods, cfg.n_drop_reasons, cfg.n_dns_qtypes
    _state(ident_table, "identity table", dev)
    _pow2(ident_table.shape[0], "identity slots")
    if filt_table is not None:
        _state(filt_table, "filter table", dev)
        _pow2(filt_table.shape[0], "filter slots")
    for t, name, shape in (
        (pod_forward, "pod_forward", (P, 2, 2)), (pod_drop, "pod_drop", (P, R, 2)),
        (pod_tcpflags, "pod_tcpflags", (P, 8)), (pod_dns, "pod_dns", (P, Q, 2)),
        (pod_retrans, "pod_retrans", (P,)), (node_counters, "node_counters", (2, 2)),
        (totals, "totals", (8,)),
    ):
        _state(t, name, dev, shape=shape)
    n_valid = min(max(int(n_valid), 0), 0xFFFFFFFF)
    sample_k = int(sample_k) & 0xFFFFFFFF
    if not _on_card(dev):
        from retina_tpu_torch.models.pipeline import step_rows_plain

        return step_rows_plain(
            records, n_valid, sample_k, ident_table, ident_seed, filt_table,
            filt_seed, pod_forward, pod_drop, pod_tcpflags, pod_dns,
            pod_retrans, node_counters, totals, cfg,
        )
    if min(P, R, Q) < 1 or P * (1 + R + Q) >= 0xFFFFFFFF:
        raise ValueError(f"{P} pods, {R} drop reasons and {Q} DNS qtypes do not fit K1's "
                         f"32-bit keys")
    if records.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned")
    if ident_table.data_ptr() % 8 or (filt_table is not None and filt_table.data_ptr() % 8):
        raise ValueError("identity and filter tables must be 8-byte aligned")
    scratch = torch.empty((len(SCRATCH), b), dtype=torch.int32, device=dev)
    sums = torch.zeros((N_SUMS,), dtype=torch.int32, device=dev)
    if not b:
        return scratch, sums
    api, lst = 0, None
    if apiserver_ip is not None:
        if b >= 1 << 30:
            raise ValueError("batch too large for the latency list's 30-bit row index")
        api = int(apiserver_ip) & 0xFFFFFFFF
        lst = _latency_list(dev, b)
        if lst["pending"] is not None:  # filled and never finished: start it afresh
            lst["count"].zero_()
        lst["pending"] = (records.data_ptr(), b, api)
    _launch(
        "step_rows", dev, records.data_ptr(), b, n_valid, sample_k,
        ident_table.data_ptr(), ident_table.shape[0], int(ident_seed) & 0xFFFFFFFF,
        None if filt_table is None else filt_table.data_ptr(),
        0 if filt_table is None else filt_table.shape[0],
        int(filt_seed) & 0xFFFFFFFF,
        pod_forward.data_ptr(), pod_drop.data_ptr(), pod_tcpflags.data_ptr(),
        pod_dns.data_ptr(), pod_retrans.data_ptr(), node_counters.data_ptr(),
        totals.data_ptr(), sums.data_ptr(), scratch.data_ptr(),
        P, R, Q, int(cfg.bypass_filter), int(cfg.identity_implies_interest),
        cfg.sample_exempt_packets & 0xFFFFFFFF,
        cfg.priority_ip_mask & 0xFFFFFFFF, cfg.priority_ip_match & 0xFFFFFFFF, api,
        None if lst is None else lst["count"].data_ptr(),
        None if lst is None else lst["entries"].data_ptr(),
    )
    return scratch, sums


# ---------------------------------------------------------------------------
# K2


HH_CHUNK = 2048  # rows a chunk of K2's add phase (kChunk in csrc/hh_update.cu)
HH_MAX_DEPTH = 8  # CMS rows K2 hashes a key into


def hh_update(cms_table, cms_seed, key_rows, counts, table_seed, key_cols, weights):
    """Heavy-hitter update (K2) of one sketch in place: CMS add, query, slot
    max, winner key write. The winner of a slot is the last row in batch
    order among the rows whose estimate equals the slot's new count."""
    hh_update_many([(cms_table, cms_seed, key_rows, counts, table_seed, key_cols, weights)])


def _hh_check(cms_table, key_rows, counts, key_cols, weights, dev, b) -> None:
    _state(cms_table, "cms table", dev)
    if cms_table.dim() != 2:
        raise ValueError(f"cms table must be (depth, width), got {tuple(cms_table.shape)}")
    _pow2(cms_table.shape[1], "cms width")
    s = counts.shape[0]
    _pow2(s, "topk slots")
    _state(counts, "topk counts", dev, shape=(s,))
    _state(key_rows, "topk key rows", dev, shape=(s, len(key_cols)))
    _col(weights, "weights", b, dev)
    _key_cols(key_cols, b, dev)


def _hh_record(cms_table, cms_seed, key_rows, counts, table_seed, key_cols, weights,
               packed=0, lst=0, lst_n=0) -> list[int]:
    """One sketch's fields, in the order of csrc/hh_update.cu's record;
    the scratch regions are raw pointers (0 where the call has none)."""
    pad = [0] * (4 - len(key_cols))
    return [cms_table.data_ptr(), cms_table.shape[0], cms_table.shape[1],
            int(cms_seed) & 0xFFFFFFFF, 0 if key_rows is None else key_rows.data_ptr(),
            0 if counts is None else counts.data_ptr(),
            0 if counts is None else counts.shape[0], int(table_seed) & 0xFFFFFFFF,
            packed, lst, lst_n, weights.data_ptr(), weights.stride(0), len(key_cols),
            *[c.data_ptr() for c in key_cols], *pad, *[c.stride(0) for c in key_cols], *pad]


def hh_update_many(updates):
    """K2 over up to three heavy-hitter sketches of one batch, in place, in
    three launches in all. Each update is (cms_table, cms_seed, key_rows,
    counts, table_seed, key_cols, weights), as ``hh_update`` takes it; the
    key columns and weights of every update have the batch's length, and no
    two updates share a state tensor. Each sketch ends as ``hh_update``
    alone would leave it."""
    if not 1 <= len(updates) <= 3:
        raise ValueError(f"1 to 3 heavy-hitter updates, got {len(updates)}")
    dev = updates[0][0].device
    b = updates[0][6].shape[0]
    for cms_table, _, key_rows, counts, _, key_cols, weights in updates:
        _hh_check(cms_table, key_rows, counts, key_cols, weights, dev, b)
    state = {t.data_ptr() for u in updates for t in (u[0], u[2], u[3])}
    if len(state) != 3 * len(updates):
        raise ValueError("heavy-hitter updates share a state tensor")
    if not _on_card(dev):
        from retina_tpu_torch.ops.topk import hh_update_plain

        for u in updates:
            hh_update_plain(*u)
        return
    if b == 0:
        return
    if b >= 0x7FFFFFFF:
        raise ValueError("batch too large for the 32-bit row index")
    if any(u[0].shape[0] > HH_MAX_DEPTH for u in updates):
        raise ValueError(f"cms depth above {HH_MAX_DEPTH}")
    n_chunks = -(-b // HH_CHUNK)
    slots = [u[3].shape[0] for u in updates]
    sizes = [n_chunks * (u[0].shape[0] + 2) * HH_CHUNK for u in updates]
    # One scratch buffer: each sketch's packed slot words (8 bytes a slot),
    # then each sketch's chunk lists (each distinct key's CMS columns, slot
    # and last row) and their lengths (see csrc/hh_update.cu).
    scratch = torch.empty((2 * sum(slots) + sum(sizes) + n_chunks * len(updates),),
                          dtype=torch.int32, device=dev)
    p = scratch.data_ptr()
    q = p + 8 * sum(slots)
    fields = []
    for u, s, size in zip(updates, slots, sizes):
        fields += _hh_record(*u, p, q, q + 4 * size)
        p, q = p + 8 * s, q + 4 * (size + n_chunks)
    fields = array.array("q", fields)
    _launch("hh_update", dev, fields.buffer_info()[0], len(updates), b, n_launches=3)


def cms_update(table, seed, key_cols, weights):
    """The Count-Min update alone (row 12, ``cms.update_jit``) in place:
    add each row's u32 weight (masked rows carry 0) at its hashed column of
    every depth row; K2's add phase without the candidate table."""
    dev = table.device
    _state(table, "cms table", dev)
    if table.dim() != 2:
        raise ValueError(f"cms table must be (depth, width), got {tuple(table.shape)}")
    _pow2(table.shape[1], "cms width")
    b = weights.shape[0]
    _col(weights, "weights", b, dev)
    _key_cols(key_cols, b, dev)
    if not _on_card(dev):
        from retina_tpu_torch.ops.countmin import update_plain

        return update_plain(table, seed, key_cols, weights)
    if table.shape[0] > HH_MAX_DEPTH:
        raise ValueError(f"cms depth above {HH_MAX_DEPTH}")
    if b:
        fields = array.array("q", _hh_record(table, seed, None, None, 0, key_cols, weights))
        _launch("cms_update", dev, fields.buffer_info()[0], b)


# ---------------------------------------------------------------------------
# K3


HLL_MAX_BANKS = 3  # banks one launch of K3 updates (kMaxBanks in csrc/hll_update.cu)


def hll_update(registers, seed, key_cols, group, mask):
    """HyperLogLog bank update (K3) in place. ``group`` None means group 0;
    rows with ``mask`` 0 are skipped. One bank of ``hll_update_many``."""
    hll_update_many([(registers, seed, key_cols, group, mask, None)])


def hll_update_many(updates):
    """K3 over up to three HyperLogLog banks of one batch, in place, in one
    launch. Each update is (registers, seed, key_cols, group, mask, mask2):
    ``group`` None means group 0; a row counts where ``mask``, ANDed bit by
    bit with ``mask2`` where that is not None, is not 0. Every lane has the
    batch's length, and no two updates share a bank. Each bank ends as
    ``hll_update`` with the mask ``mask & mask2`` would leave it."""
    if not 1 <= len(updates) <= HLL_MAX_BANKS:
        raise ValueError(f"1 to {HLL_MAX_BANKS} HLL banks, got {len(updates)}")
    dev = updates[0][0].device
    b = updates[0][4].shape[0]
    for registers, _, key_cols, group, mask, mask2 in updates:
        _state(registers, "hll registers", dev)
        _pow2(registers.shape[1], "hll registers per group")
        _col(mask, "mask", b, dev)
        if mask2 is not None:
            _col(mask2, "second mask", b, dev)
        if group is not None:
            _col(group, "group", b, dev)
        _key_cols(key_cols, b, dev)
    if len({u[0].data_ptr() for u in updates}) != len(updates):
        raise ValueError("HLL updates share a bank")
    if not _on_card(dev):
        from retina_tpu_torch.ops.hyperloglog import update_plain

        for registers, seed, key_cols, group, mask, mask2 in updates:
            update_plain(registers, seed, key_cols, group,
                         mask if mask2 is None else mask & mask2)
        return
    if b == 0:
        return
    fields = []
    for registers, seed, key_cols, group, mask, mask2 in updates:
        pad = [0] * (4 - len(key_cols))
        fields += [registers.data_ptr(), registers.shape[0], registers.shape[1].bit_length() - 1,
                   int(seed) & 0xFFFFFFFF, len(key_cols), *[c.data_ptr() for c in key_cols],
                   *pad, *[c.stride(0) for c in key_cols], *pad,
                   0 if group is None else group.data_ptr(),
                   0 if group is None else group.stride(0), mask.data_ptr(), mask.stride(0),
                   0 if mask2 is None else mask2.data_ptr(),
                   0 if mask2 is None else mask2.stride(0)]
    fields = array.array("q", fields)
    _launch("hll_update", dev, fields.buffer_info()[0], len(updates), b)


# ---------------------------------------------------------------------------
# K4


ENTROPY_MAX_BYTES = 227 * 1024  # shared memory a block of K4 can hold (H100)


def entropy_update(counts, seed, key_cols, weights):
    """Entropy histograms update (K4) in place: group g hashes key_cols[g]
    and adds the row's weight (u32, converted to f32)."""
    dev = counts.device
    b = weights.shape[0]
    _state(counts, "entropy counts", dev, dtype=torch.float32)
    g, k = counts.shape
    _pow2(k, "entropy buckets")
    if len(key_cols) != g:
        raise ValueError(f"{g} groups need {g} key columns, got {len(key_cols)}")
    _col(weights, "weights", b, dev)
    _key_cols(key_cols, b, dev)
    if not _on_card(dev):
        from retina_tpu_torch.ops.entropy import update_plain

        return update_plain(counts, seed, key_cols, weights)
    if g * k * 8 > ENTROPY_MAX_BYTES:
        raise ValueError(f"a ({g}, {k}) histogram bank, 8 bytes a bucket while it is summed, "
                         f"exceeds the {ENTROPY_MAX_BYTES} bytes of shared memory a block "
                         f"can hold")
    if b == 0:
        return
    _launch(
        "entropy_update", dev, counts.data_ptr(), k, int(seed) & 0xFFFFFFFF,
        *_col_args(key_cols), weights.data_ptr(), weights.stride(0), b,
    )


# ---------------------------------------------------------------------------
# K5

CT_RECORD_WORDS = 8  # u32 words of one connection's record (kRecWords in csrc/conntrack.cu)
CT_CHUNK = 2048  # rows a block of K5 sums in shared memory (kChunk there)
CT_FREE_SLOT = [0, 0, 0, 0, -1, -1, 0, 0]  # a free key slot of K5's batch table (kEntWords)


def conntrack_process(keys, vals, seed, src_ip, dst_ip, ports, proto, tcp_flags, now_s,
                      bytes_, mask, packets, scratch):
    """Connection tracking over one batch (K5): updates the table ``keys``
    (S, 2) and ``vals`` (S, 4) in place and returns (4, B) int32 lanes
    [report, is_reply, report_packets, report_bytes] in batch order.

    Columns are (B,) int32 u32 lanes of any stride; ``mask`` is 0/1;
    ``packets`` None counts one packet per row. ``scratch`` is a dict the
    caller keeps per table: the kernel's batch-local tables are allocated
    there once and reused."""
    dev = keys.device
    n_slots = keys.shape[0]
    _pow2(n_slots, "conntrack slots")
    _state(keys, "conntrack keys", dev, shape=(n_slots, 2))
    _state(vals, "conntrack vals", dev, shape=(n_slots, 4))
    b = mask.shape[0]
    cols = [(src_ip, "src_ip"), (dst_ip, "dst_ip"), (ports, "ports"), (proto, "proto"),
            (tcp_flags, "tcp_flags"), (bytes_, "bytes"), (mask, "mask")]
    if packets is not None:
        cols.append((packets, "packets"))
    for t, name in cols:
        _col(t, name, b, dev)
    now = int(now_s) & 0xFFFFFFFF
    if not _on_card(dev):
        from retina_tpu_torch.ops.conntrack import process_plain

        return process_plain(keys, vals, seed, src_ip, dst_ip, ports, proto, tcp_flags,
                             now, bytes_, mask, packets)
    if b > 1 << 30:
        raise ValueError("batch too large for the 31-bit row index")
    if vals.data_ptr() % 16 or keys.data_ptr() % 8:
        raise ValueError("conntrack keys and vals must be 8- and 16-byte aligned")
    out = torch.empty((4, b), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    # Key slots: a power of two >= 2B, and >= 2 CT_CHUNK so that the records
    # (half as many, a region of CT_CHUNK a chunk) cover every chunk.
    key_slots = 1 << max(CT_CHUNK.bit_length(), (2 * b - 1).bit_length())
    if scratch.get("key_slots", 0) < key_slots or scratch["winner"].shape[0] != n_slots \
            or scratch["winner"].device != dev:
        # A free key slot: zero accumulators and the key ~0 (csrc/conntrack.cu);
        # phase B leaves them so for the next batch. The call clears the
        # winner words, and a record is written whole before it is read.
        scratch.clear()
        scratch.update(
            key_slots=key_slots,
            slots=torch.tensor(CT_FREE_SLOT, dtype=torch.int32, device=dev).repeat(key_slots, 1),
            rec=torch.empty((key_slots // 2, CT_RECORD_WORDS), dtype=torch.int32, device=dev),
            count=torch.empty((key_slots // 2 // CT_CHUNK,), dtype=torch.int32, device=dev),
            winner=torch.empty((n_slots,), dtype=torch.int64, device=dev),
        )
    args = []
    for t in (src_ip, dst_ip, ports, proto, tcp_flags, bytes_, mask):
        args += [t.data_ptr(), t.stride(0)]
    args += [None, 0] if packets is None else [packets.data_ptr(), packets.stride(0)]
    _launch(
        "conntrack", dev, keys.data_ptr(), vals.data_ptr(), n_slots,
        int(seed) & 0xFFFFFFFF, *args, b, now, scratch["slots"].data_ptr(),
        scratch["key_slots"], scratch["rec"].data_ptr(),
        scratch["count"].data_ptr(), scratch["winner"].data_ptr(), out.data_ptr(),
        n_launches=2,
    )
    return out


def conntrack_scratch_bytes(scratch: dict) -> int:
    """Bytes of K5's batch scratch held in ``scratch``."""
    return sum(t.numel() * t.element_size() for t in scratch.values()
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# K6


INV_CHUNK = 2048  # rows a block of K6's bin phase (kChunk in csrc/inv_update.cu)
INV_TILE = 32  # buckets an apply block of K6 owns (kTile there)
INV_MAX_DEPTH = 4  # kMaxDepth there
INV_MAX_TILES = 4096  # kMaxTiles there: buckets of both regions, in tiles
INV_MAX_CHUNKS = 8192  # kMaxChunks there: rows of a batch, in chunks


def inv_update(planes, weights_table, seed, key_cols, weights):
    """Invertible sketch update (K6) in place: bit planes (D, W, 32(C+1))
    and bucket weights (D, W) of the C key columns; rows of weight 0 add
    nothing. One region of ``inv_update_pair``."""
    inv_update_pair([(planes, weights_table, seed)], key_cols, weights)


def inv_update_pair(regions, key_cols, weights, select=None):
    """K6 over one or two invertible sketches of a batch, in place, in two
    launches. ``regions`` is [(planes, weights_table, seed)] or two such;
    with two, a row of weight != 0 adds to the second where ``select`` is
    not 0 and to the first otherwise (the step's inv_hi and inv_flow, split
    by the priority class); with one, ``select`` is None. The regions share
    the C key columns; each ends as ``inv_update`` of its own rows would
    leave it."""
    if not 1 <= len(regions) <= 2:
        raise ValueError(f"1 or 2 invertible regions, got {len(regions)}")
    if (select is None) != (len(regions) == 1):
        raise ValueError("a selector lane goes with two regions, and only with two")
    dev = regions[0][0].device
    b = weights.shape[0]
    for planes, weights_table, _ in regions:
        _state(planes, "invertible planes", dev)
        d, w, nb = planes.shape
        _pow2(w, "invertible width")
        _state(weights_table, "invertible weights", dev, shape=(d, w))
        if nb != 32 * (len(key_cols) + 1):
            raise ValueError(f"{nb} planes do not fit {len(key_cols)} key columns")
    if len({t.data_ptr() for r in regions for t in r[:2]}) != 2 * len(regions):
        raise ValueError("invertible regions share a state tensor")
    _col(weights, "weights", b, dev)
    if select is not None:
        _col(select, "select", b, dev)
    _key_cols(key_cols, b, dev)
    if not _on_card(dev):
        from retina_tpu_torch.ops.invertible import update_pair_plain

        return update_pair_plain(regions, key_cols, weights, select)
    depths = [r[0].shape[0] for r in regions]
    if max(depths) > INV_MAX_DEPTH:
        raise ValueError(f"invertible depth above {INV_MAX_DEPTH}")
    if any(r[0].data_ptr() % 16 for r in regions):
        raise ValueError("invertible planes must be 16-byte aligned")
    n_tiles = sum(-(-r[0].shape[0] * r[0].shape[1] // INV_TILE) for r in regions)
    n_chunks = -(-b // INV_CHUNK)
    if n_tiles > INV_MAX_TILES:
        raise ValueError(f"{n_tiles} tiles of {INV_TILE} buckets exceed {INV_MAX_TILES}")
    if n_chunks > INV_MAX_CHUNKS:
        raise ValueError(f"batch above {INV_MAX_CHUNKS * INV_CHUNK} rows")
    if b == 0:
        return
    # Scratch, every word written before it is read: each chunk's entries (8
    # words), its pair list (max depth words an entry), then the tile-major
    # (start, count) table of the chunks (see csrc/inv_update.cu).
    n_ent = n_chunks * INV_CHUNK
    scratch = torch.empty((n_ent * (8 + max(depths)) + n_tiles * n_chunks,), dtype=torch.int32,
                          device=dev)
    p = scratch.data_ptr()
    fields = array.array("q", [x for planes, weights_table, seed in regions
                               for x in (planes.data_ptr(), weights_table.data_ptr(),
                                         planes.shape[0], planes.shape[1],
                                         int(seed) & 0xFFFFFFFF)])
    _launch(
        "inv_update", dev, fields.buffer_info()[0], len(regions), *_col_args(key_cols),
        weights.data_ptr(), weights.stride(0),
        None if select is None else select.data_ptr(), 0 if select is None else select.stride(0),
        b, p, p + 4 * 8 * n_ent, p + 4 * (8 + max(depths)) * n_ent, n_launches=2,
    )


# ---------------------------------------------------------------------------
# K7


def _wire_rows(wire: torch.Tensor, name: str, width: int, device: torch.device) -> int:
    _state(wire, name, device)
    if wire.dim() != 2 or wire.shape[1] != width:
        raise ValueError(f"{name} must be (bucket, {width}), got {tuple(wire.shape)}")
    return wire.shape[0]


def _windows(n_out: int, bucket: int) -> None:
    if n_out < bucket:
        raise ValueError(f"{n_out} window rows cannot hold a bucket of {bucket}")


def _aligned(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("wire, table and windows must be 16-byte aligned")


def _desc_table(table: torch.Tensor, device: torch.device) -> int:
    _state(table, "descriptor table", device)
    if table.dim() != 2 or table.shape[1] != 12 or table.shape[0] < 1:
        raise ValueError(f"descriptor table must be (slots, 12), got {tuple(table.shape)}")
    if table.shape[0] > 0xFFFFFFFF:
        raise ValueError("descriptor table too large for 32-bit ids")
    return table.shape[0]


def ingest_packed(wire, packed, base_lo, base_hi, n_out):
    """The packed ingest (K7): the (bucket, 12) packed wire, unpacked with
    the flush's base (or, with ``packed`` false, the (bucket, 16) wire
    copied), into a new (n_out, 16) int32 buffer of step windows whose rows
    past ``bucket`` are zero."""
    dev = wire.device
    bucket = _wire_rows(wire, "wire", 12 if packed else 16, dev)
    _windows(n_out, bucket)
    base_lo, base_hi = int(base_lo) & 0xFFFFFFFF, int(base_hi) & 0xFFFFFFFF
    if not _on_card(dev):
        from retina_tpu_torch.parallel.wire import ingest_packed_plain

        return ingest_packed_plain(wire, bool(packed), base_lo, base_hi, n_out)
    out = torch.empty((n_out, 16), dtype=torch.int32, device=dev)
    _aligned(wire, out)
    _launch("ingest_packed", dev, wire.data_ptr(), bucket, int(bool(packed)), base_lo, base_hi,
            out.data_ptr(), n_out)
    return out


def ingest_new(wire, table, winner, base_lo, base_hi, n_out):
    """The new-descriptor ingest (K7): every row of the (bucket, 13) wire
    [id | 12 packed lanes] writes its lanes into ``table`` (slots, 12) at
    its id, in place (the last row in batch order wins a repeated id; ids
    past the table are dropped), and the lanes unpack into a new
    (n_out, 16) buffer of windows. ``winner`` is the caller's (slots,)
    int32 scratch, zero between calls (the plain version does not read
    it)."""
    dev = wire.device
    bucket = _wire_rows(wire, "new wire", 13, dev)
    _windows(n_out, bucket)
    slots = _desc_table(table, dev)
    _state(winner, "winner scratch", dev, shape=(slots,))
    base_lo, base_hi = int(base_lo) & 0xFFFFFFFF, int(base_hi) & 0xFFFFFFFF
    if not _on_card(dev):
        from retina_tpu_torch.parallel.wire import ingest_new_plain

        return ingest_new_plain(wire, table, base_lo, base_hi, n_out)
    if bucket >= 0x7FFFFFFF:
        raise ValueError("bucket too large for the 32-bit row claim")
    out = torch.empty((n_out, 16), dtype=torch.int32, device=dev)
    _aligned(wire, table, out)
    _launch("ingest_new", dev, wire.data_ptr(), bucket, table.data_ptr(), slots,
            winner.data_ptr(), base_lo, base_hi, out.data_ptr(), n_out, n_launches=2)
    return out


def ingest_known(wire, bucket, dense, id_bits, table, ts_rel, base_lo, base_hi, n_out):
    """The known-flow ingest (K7): decode (id, packets, bytes) of ``bucket``
    rows from the v4 dense stream (``dense``; 1-D, at least
    ``dense_words(bucket, id_bits)`` words) or the (bucket, 2) v3 wire,
    gather each row's 12 lanes from ``table`` (ids past it read the last
    slot), set TS_REL to ``ts_rel`` and BYTES and PACKETS to the row's,
    and unpack into a new (n_out, 16) buffer of windows."""
    from retina_tpu_torch.parallel.wire import dense_words

    dev = wire.device
    if not 1 <= int(id_bits) <= 32:
        raise ValueError(f"id_bits must be in [1, 32], got {id_bits}")
    if dense:
        _state(wire, "known wire", dev)
        if wire.dim() != 1 or wire.shape[0] < dense_words(bucket, id_bits):
            raise ValueError(f"known stream must be ({dense_words(bucket, id_bits)},) words, "
                             f"got {tuple(wire.shape)}")
    elif _wire_rows(wire, "known wire", 2, dev) != bucket:
        raise ValueError(f"known wire has {wire.shape[0]} rows, expected {bucket}")
    _windows(n_out, bucket)
    slots = _desc_table(table, dev)
    ts_rel = int(ts_rel) & 0xFFFFFFFF
    base_lo, base_hi = int(base_lo) & 0xFFFFFFFF, int(base_hi) & 0xFFFFFFFF
    if not _on_card(dev):
        from retina_tpu_torch.parallel.wire import ingest_known_plain

        return ingest_known_plain(wire, bucket, bool(dense), int(id_bits), table, ts_rel,
                                  base_lo, base_hi, n_out)
    out = torch.empty((n_out, 16), dtype=torch.int32, device=dev)
    _aligned(wire, table, out)
    _launch("ingest_known", dev, wire.data_ptr(), bucket, int(bool(dense)), int(id_bits),
            table.data_ptr(), slots, ts_rel, base_lo, base_hi, out.data_ptr(), n_out)
    return out


# ---------------------------------------------------------------------------
# K8, K9, K10: the folds of the catalog and the Count-Min query

# Reductions of K8 (csrc/fold.cu): the enum Op there.
FOLD_OPS = {"sum_u32": 0, "sum_f32": 1, "max_u32": 2}


FOLD_MAX_ARRAYS = 32  # arrays one launch of K8 folds (kMaxArrays in csrc/fold.cu)


def fold(stacked, op):
    """The N-way fold (K8) of one stacked array: (N, *shape) -> a new
    (*shape) tensor, by ``op`` "sum_u32" (wrapping), "sum_f32" (slot by
    slot, in slot order) or "max_u32". u32 arrays are int32 bit patterns,
    the f32 sum takes float32. The one-array case of ``fold_many``."""
    return fold_many([(stacked, op)])[0]


def fold_many(items):
    """K8 over several stacked arrays in one launch: each item is (stacked
    (N, *shape), op) as ``fold`` takes it, every item has the same N, and the
    result is the list of folded (*shape) tensors in the items' order."""
    if not items:
        return []
    dev = items[0][0].device
    n_slots = items[0][0].shape[0] if items[0][0].dim() else 0
    for stacked, op in items:
        if op not in FOLD_OPS:
            raise ValueError(f"fold op must be one of {sorted(FOLD_OPS)}, got {op!r}")
        _state(stacked, "stacked array", dev,
               dtype=torch.float32 if op == "sum_f32" else torch.int32)
        if stacked.dim() < 1 or stacked.shape[0] < 1:
            raise ValueError(f"a fold needs at least one slot, got shape {tuple(stacked.shape)}")
        if stacked.shape[0] != n_slots:
            raise ValueError(f"folded arrays differ in slots: {stacked.shape[0]} and {n_slots}")
    if not _on_card(dev):
        from retina_tpu_torch.timetravel.fold import fold_plain

        return [fold_plain(stacked, op) for stacked, op in items]
    outs = [torch.empty(x.shape[1:], dtype=x.dtype, device=dev) for x, _ in items]
    # Arrays with no element need no block; the rest go FOLD_MAX_ARRAYS a launch.
    live = [(x, op, o) for (x, op), o in zip(items, outs) if o.numel()]
    for g in range(0, len(live), FOLD_MAX_ARRAYS):
        group = live[g:g + FOLD_MAX_ARRAYS]
        fields = array.array("q", [f for x, op, o in group
                                   for f in (x.data_ptr(), o.numel(), FOLD_OPS[op], o.data_ptr())])
        _launch("fold", dev, fields.buffer_info()[0], len(group), n_slots)
    return outs


TOPK_JOIN_MAX_JOBS = 3  # kMaxJobs in csrc/topk_join.cu: the families of a fold
TOPK_JOIN_SLOTS = 32  # kSlots there: slots a block


class _JoinJob(ctypes.Structure):
    """``Job`` of csrc/topk_join.cu."""

    _fields_ = [("keys", _VP), ("counts", _VP), ("out_keys", _VP), ("out_counts", _VP),
                ("n_tables", _LL), ("n_slots", _LL), ("n_cols", _INT), ("block0", _INT)]


class _JoinTable(ctypes.Structure):
    """``Table`` of csrc/topk_join.cu: passed by value to the kernel."""

    _fields_ = [("n_jobs", _INT), ("n_blocks", _INT), ("jobs", _JoinJob * TOPK_JOIN_MAX_JOBS)]


def topk_join_many(families):
    """The N-way candidate-table join (K9) of several families in one launch:
    per slot of each family the greatest (count, key row) under the unsigned
    lexicographic order of TopKTable.merge. Each family is (keys (N, S, C),
    counts (N, S)), C from 1 to 4; the result is the list of new ((S, C),
    (S,)) pairs in the families' order."""
    if not 1 <= len(families) <= TOPK_JOIN_MAX_JOBS:
        raise ValueError(f"1 to {TOPK_JOIN_MAX_JOBS} candidate families, got {len(families)}")
    dev = families[0][0].device
    for keys, counts in families:
        _state(keys, "candidate keys", dev)
        if keys.dim() != 3 or keys.shape[0] < 1:
            raise ValueError(f"candidate keys must be (N >= 1, S, C), got {tuple(keys.shape)}")
        n, s, c = keys.shape
        _state(counts, "candidate counts", dev, shape=(n, s))
        if not 1 <= c <= 4:
            raise ValueError(f"candidate keys need 1 to 4 columns, got {c}")
    if not _on_card(dev):
        from retina_tpu_torch.ops.topk import topk_join_plain

        return [topk_join_plain(keys, counts) for keys, counts in families]
    outs = [(torch.empty(k.shape[1:], dtype=torch.int32, device=dev),
             torch.empty(k.shape[1:2], dtype=torch.int32, device=dev)) for k, _ in families]
    table = _JoinTable()
    table.n_jobs = len(families)
    block0 = 0
    for e, (keys, counts), (out_keys, out_counts) in zip(table.jobs, families, outs):
        n, s, c = keys.shape
        e.keys, e.counts = keys.data_ptr(), counts.data_ptr()
        e.out_keys, e.out_counts = out_keys.data_ptr(), out_counts.data_ptr()
        e.n_tables, e.n_slots, e.n_cols, e.block0 = n, s, c, block0
        block0 += -(-s // TOPK_JOIN_SLOTS)
    table.n_blocks = block0
    if block0:
        _launch("topk_join", dev, ctypes.addressof(table))
    return outs


def topk_join(keys, counts):
    """The N-way candidate-table join (K9) of one family: ``keys`` (N, S,
    C) and ``counts`` (N, S) -> new (S, C) and (S,); ``topk_join_many``'s one
    job."""
    return topk_join_many([(keys, counts)])[0]


CMS_QUERY_MAX_JOBS = 8  # kMaxJobs in csrc/cms_query.cu
CMS_QUERY_THREADS = 256  # kThreads there


class _QueryJob(ctypes.Structure):
    """``Job`` of csrc/cms_query.cu."""

    _fields_ = [("table", _VP), ("col", _VP * 4), ("est", _VP),
                ("ok_in", _VP), ("ok_out", _VP), ("n", _LL), ("stride", _INT * 4),
                ("wmask", _U32), ("seed", _U32), ("min_weight", _U32), ("depth", _INT),
                ("n_cols", _INT), ("block0", _INT)]


class _QueryTable(ctypes.Structure):
    """``Table`` of csrc/cms_query.cu: passed by value to the kernel."""

    _fields_ = [("n_jobs", _INT), ("n_blocks", _INT),
                ("jobs", _QueryJob * CMS_QUERY_MAX_JOBS)]


def _query_check(job, dev: torch.device) -> int:
    table, _, key_cols, ok = job[:4]
    _state(table, "cms table", dev)
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"cms table must be (depth >= 1, width), got {tuple(table.shape)}")
    _pow2(table.shape[1], "cms width")
    if not key_cols:
        raise ValueError("1 to 4 key columns, got 0")
    r = key_cols[0].shape[0] if key_cols[0].dim() == 1 else -1
    _key_cols(key_cols, r, dev)
    if any(not 0 <= c.stride(0) <= 0x7FFFFFFF for c in key_cols):
        raise ValueError("key column strides must lie in [0, 2^31)")
    if ok is not None:
        _state(ok, "ok mask", dev, dtype=torch.bool, shape=(r,))
    return r


def cms_query_many(jobs):
    """The Count-Min point query (K10) of several jobs in one launch. Each
    job is (table, seed, key_cols, ok, min_weight): a (depth, width) int32
    table, 1 to 4 (R,) int32 key columns and an (R,) bool mask or None (all
    true). Per row: est = the u32 minimum over the depth rows at the key's
    columns, ok' = ok & (est >= min_weight, unsigned), est' = est where ok'
    else 0 (``decode_verified``'s filter). Returns (est (sum R,) int32, ok
    (sum R,) bool), the jobs' rows end to end in job order."""
    if not 1 <= len(jobs) <= CMS_QUERY_MAX_JOBS:
        raise ValueError(f"1 to {CMS_QUERY_MAX_JOBS} query jobs, got {len(jobs)}")
    dev = jobs[0][0].device
    rows = [_query_check(job, dev) for job in jobs]
    if not _on_card(dev):
        from retina_tpu_torch.ops.countmin import query_many_plain

        return query_many_plain(jobs)
    total = sum(rows)
    est = torch.empty((total,), dtype=torch.int32, device=dev)
    ok = torch.empty((total,), dtype=torch.bool, device=dev)
    if not total:
        return est, ok
    table = _QueryTable()
    table.n_jobs = len(jobs)
    block0 = off = 0
    for e, (t, seed, key_cols, mask, min_weight), r in zip(table.jobs, jobs, rows):
        e.table, e.n, e.depth = t.data_ptr(), r, t.shape[0]
        e.wmask, e.seed = t.shape[1] - 1, int(seed) & 0xFFFFFFFF
        e.min_weight = int(min_weight) & 0xFFFFFFFF
        e.n_cols, e.block0 = len(key_cols), block0
        if r:
            for j, c in enumerate(key_cols):
                e.col[j], e.stride[j] = c.data_ptr(), c.stride(0)
            e.est, e.ok_out = est.data_ptr() + 4 * off, ok.data_ptr() + off
            e.ok_in = None if mask is None else mask.data_ptr()
        block0 += -(-r // CMS_QUERY_THREADS)
        off += r
    table.n_blocks = block0
    _launch("cms_query", dev, ctypes.addressof(table))
    return est, ok


def cms_query(table, seed, key_cols):
    """The Count-Min point query (K10) of one set of key columns: (R,) int32
    u32 estimates, the minimum over the depth rows of the table at the keys'
    columns: ``cms_query_many``'s one job, without a mask, at min_weight 0."""
    return cms_query_many([(table, seed, key_cols, None, 0)])[0]


# ---------------------------------------------------------------------------
# K11, K12, K13: the detector programs

SHARED_BYTES = 64 * 1024  # K11's registers, all of them in every block's shared memory
PORTSCAN_CLUSTER = 16  # K11's cluster size at most (16 the largest; non-portable above 8)
PORTSCAN_BLOCK_ROWS = 4096  # rows a block of K11 takes at least (4 a thread)


def portscan_cluster(groups: int, precision: int, n_rows: int) -> int:
    """K11's cluster size for ``n_rows`` keys: a block a PORTSCAN_BLOCK_ROWS
    rows, at least 1 and at most PORTSCAN_CLUSTER (the launch caps it again
    by the largest cluster the card can schedule). Every block holds all
    ``groups`` HLL groups of 2^precision registers; raises ValueError where
    they pass SHARED_BYTES."""
    bank = groups * (4 << int(precision))
    if groups < 1 or bank > SHARED_BYTES:
        raise ValueError(f"{groups} groups of 2^{precision} registers ({bank} bytes) do not fit "
                         f"a block's {SHARED_BYTES} bytes of shared memory")
    return max(1, min(PORTSCAN_CLUSTER, -(-n_rows // PORTSCAN_BLOCK_ROWS)))


def portscan_score(keys, weights, groups, precision, seed):
    """The portscan program (K11): (P, 4) int32 flow keys [src, dst, proto,
    dst port] and (P,) float32 weights -> (groups,) float32 HLL estimates
    of the distinct dst ports of the keys of weight > 0 in each source
    hash-group, group = (src * 2654435761) mod groups in u32. On the card,
    one launch of a cluster of ``portscan_cluster`` blocks."""
    dev = keys.device
    _state(keys, "flow keys", dev)
    if keys.dim() != 2 or keys.shape[1] != 4:
        raise ValueError(f"flow keys must be (P, 4), got {tuple(keys.shape)}")
    n = keys.shape[0]
    _state(weights, "weights", dev, dtype=torch.float32, shape=(n,))
    if not 4 <= int(precision) <= 16:
        raise ValueError(f"precision must be in [4, 16], got {precision}")
    blocks = portscan_cluster(int(groups), int(precision), n)
    if not _on_card(dev):
        from retina_tpu_torch.detect.programs import portscan_plain

        return portscan_plain(keys, weights, groups, precision, seed)
    if keys.data_ptr() % 16:
        raise ValueError("flow keys must be 16-byte aligned (a row a 16-byte load)")
    from retina_tpu_torch.ops.hyperloglog import _alpha

    m = 1 << int(precision)
    out = torch.empty((groups,), dtype=torch.float32, device=dev)
    _launch("portscan_score", dev, keys.data_ptr(), weights.data_ptr(), n, groups,
            int(precision), (0xC0FFEE + int(seed)) & 0xFFFFFFFF, _alpha(m) * m * m, blocks,
            out.data_ptr())
    return out


# The bank's close (K12, K13 and the detectors' EWMA): csrc/detect.cu
# bank_close_kernel.

BANK_MAX_SLOTS = 8  # kBankMaxSlots in csrc/detect.cu: slots a launch
BANK_MAX_BINS = 256  # 32 * kBinsPerLane there: histogram bins a slot
BANK_ROW = 5  # kBankRow there: a slot's row, [score vector (3), z, flag]
BANK_TABLE_FEATURES = 512  # kBankFeatures there: features a launch's table carries
BANK_DNSTUNNEL, BANK_SYNFLOOD, BANK_PORTSCAN = 0, 1, 2  # enum Kind there


class _BankSlot(ctypes.Structure):
    """``BankSlot`` of csrc/detect.cu."""

    _fields_ = [("x", _VP), ("out", _VP), ("kind", _INT), ("n", _INT), ("state", _INT),
                ("off", _INT), ("z_thresh", _FLT), ("min_windows", _FLT), ("alpha", _FLT),
                ("pad", _INT)]


class _BankTable(ctypes.Structure):
    """``BankTable`` of csrc/detect.cu: passed by value to the kernel."""

    _fields_ = [("mean", _VP), ("var", _VP), ("n_obs", _VP), ("n_slots", _INT),
                ("pad", _INT), ("slots", _BankSlot * BANK_MAX_SLOTS),
                ("feat", _FLT * BANK_TABLE_FEATURES)]


def _host_device_pointer(t: torch.Tensor) -> int:
    """The device address of the page-locked tensor ``t``
    (cudaHostGetDevicePointer)."""
    fn = build.load("detect")["host_device_pointer"]
    fn.argtypes, fn.restype = [_VP, ctypes.POINTER(_VP)], ctypes.c_int
    out = _VP()
    rc = fn(t.data_ptr(), ctypes.byref(out))
    if rc != 0 or not out.value:
        raise RuntimeError(f"cudaHostGetDevicePointer: CUDA error {rc}")
    return out.value


class BankCloseIO:
    """The page-locked rows of one detector bank's closes on one card
    (``out``: n_slots * BANK_ROW float32, which the kernel writes through
    the buffer's device address) and the event a close waits on. A close
    launches, then reads ``out`` after the event: its owner must not start
    another close before (the bank's lock orders them)."""

    def __init__(self, device: torch.device | str, n_slots: int = BANK_MAX_SLOTS) -> None:
        self.device = torch.device(device)
        self.out = torch.zeros(max(1, n_slots) * BANK_ROW, dtype=torch.float32, pin_memory=True)
        self.out_np = self.out.numpy()
        with torch.cuda.device(self.device):
            self.event = torch.cuda.Event()
            self.out_dev = _host_device_pointer(self.out)


def _bank_slots_check(slots, dev: torch.device) -> list[int]:
    """The features' lengths of ``slots`` (0 where a slot is inactive)."""
    if not slots:
        raise ValueError("no bank slots")
    sizes = []
    for i, (kind, x, *_knobs) in enumerate(slots):
        if kind not in (BANK_DNSTUNNEL, BANK_SYNFLOOD, BANK_PORTSCAN):
            raise ValueError(f"slot {i}: unknown kind {kind}")
        if x is None:
            sizes.append(0)
            continue
        if kind == BANK_PORTSCAN:
            _state(x, f"slot {i} estimates", dev, dtype=torch.float32)
            if x.dim() != 1 or x.shape[0] < 1:
                raise ValueError(f"slot {i} estimates must be (groups,), got {tuple(x.shape)}")
            sizes.append(x.shape[0])
            continue
        if not isinstance(x, np.ndarray) or x.dtype != np.float32:
            raise TypeError(f"slot {i} features must be a float32 numpy array")
        n = x.size
        if kind == BANK_SYNFLOOD and x.shape != (9,):
            raise ValueError(f"slot {i} tcpflag lanes must be (9,), got {x.shape}")
        if kind == BANK_DNSTUNNEL and (x.shape != (1, n) or not 1 <= n <= BANK_MAX_BINS):
            raise ValueError(f"slot {i} histogram must be (1, nbins), 1 <= nbins <= "
                             f"{BANK_MAX_BINS}, got {x.shape}")
        sizes.append(n)
    return sizes


def _bank_tables(slots, sizes, mean, var, n_obs, io) -> list[_BankTable]:
    """The kernel's tables of the active slots of ``slots``, in order: a
    table holds at most BANK_MAX_SLOTS slots and BANK_TABLE_FEATURES floats
    of histograms and lanes (end to end in its ``feat``; a portscan slot
    points at its estimates), so a bank of the three built-ins is one
    table. Slot i writes row i of ``io.out`` and steps state i."""
    tables: list[_BankTable] = []
    off = BANK_TABLE_FEATURES
    for i, ((kind, x, z_thresh, min_windows, alpha), n) in enumerate(zip(slots, sizes)):
        if not n:
            continue
        carried = 0 if kind == BANK_PORTSCAN else n
        if (not tables or tables[-1].n_slots == BANK_MAX_SLOTS
                or off + carried > BANK_TABLE_FEATURES):
            table = _BankTable()
            table.mean, table.var, table.n_obs = mean.data_ptr(), var.data_ptr(), n_obs.data_ptr()
            tables.append(table)
            off = 0
        table = tables[-1]
        e = table.slots[table.n_slots]
        table.n_slots += 1
        if kind == BANK_PORTSCAN:
            e.x = x.data_ptr()
        else:
            src = np.ascontiguousarray(x)
            ctypes.memmove(ctypes.addressof(table.feat) + 4 * off, src.ctypes.data, 4 * n)
            e.off = off
            off += n
        e.out = io.out_dev + 4 * BANK_ROW * i
        e.kind, e.n, e.state = kind, n, i
        e.z_thresh, e.min_windows, e.alpha = float(z_thresh), float(min_windows), float(alpha)
    return tables


def bank_close(slots, mean, var, n_obs, io=None):
    """The bank's close (K12, K13 and the EWMA of K11's maximum): a window's
    scores of the detectors of ``slots`` and their anomaly EWMA on the card,
    one launch for up to BANK_MAX_SLOTS active slots whose histograms and
    lanes fit BANK_TABLE_FEATURES floats (the three built-ins; more take a
    launch each such group) and one wait. Slot i is (kind, x, z_thresh,
    min_windows, alpha): x is a (1, nbins) float32 numpy histogram
    (BANK_DNSTUNNEL), the (9,) float32 numpy tcpflag lanes (BANK_SYNFLOOD),
    K11's (G,) float32 estimates on the state's device (BANK_PORTSCAN), or
    None: inactive, no score and no EWMA step. Slot i's EWMA state is
    ``mean``, ``var``, ``n_obs`` [i] ((S,) float32 on the device the close
    runs on), updated in place. Returns (score, z, flag) (S,) on the host
    (float32, float32, bool; 0 for inactive slots), after one wait on
    ``io``'s event (a BankCloseIO of at least S rows; a fresh one if
    None)."""
    dev = mean.device
    n_slots = len(slots)
    for t, name in ((mean, "ewma mean"), (var, "ewma var"), (n_obs, "ewma n_obs")):
        _state(t, name, dev, dtype=torch.float32, shape=(n_slots,))
    sizes = _bank_slots_check(slots, dev)
    if not _on_card(dev):
        from retina_tpu_torch.detect.programs import bank_close_plain

        return bank_close_plain(slots, mean, var, n_obs)
    if not any(sizes):
        return torch.zeros(n_slots), torch.zeros(n_slots), torch.zeros(n_slots, dtype=torch.bool)
    io = io if io is not None else BankCloseIO(dev, n_slots)
    if io.out_np.size < n_slots * BANK_ROW:
        raise ValueError(f"the bank's rows hold {io.out_np.size // BANK_ROW} slots, not "
                         f"{n_slots}")
    for table in _bank_tables(slots, sizes, mean, var, n_obs, io):
        _launch("bank_close", dev, ctypes.addressof(table))
    io.event.record(torch.cuda.current_stream(dev))
    io.event.synchronize()
    rows = np.where(np.array(sizes)[:, None] > 0, io.out_np.reshape(-1, BANK_ROW)[:n_slots], 0)
    return (torch.from_numpy(rows[:, 0].copy()), torch.from_numpy(rows[:, 3].copy()),
            torch.from_numpy(rows[:, 4] != 0))


def _one_slot(name, kind, x, n):
    """K12 or K13 alone: a one-slot launch of the bank's close with no EWMA
    step, its row written to a tensor on the card."""
    dev = x.device
    out = torch.empty((BANK_ROW,), dtype=torch.float32, device=dev)
    table = _BankTable()
    table.n_slots = 1
    e = table.slots[0]
    e.x, e.out, e.kind, e.n, e.state = x.data_ptr(), out.data_ptr(), kind, n, -1
    _launch(name, dev, ctypes.addressof(table))
    return out


def dnstunnel_score(hist):
    """The dnstunnel program (K12): a (1, nbins) float32 qname-length
    histogram -> (2,) float32 [entropy bits, total]. On the card a one-slot
    launch of the bank's close (nbins <= BANK_MAX_BINS)."""
    dev = hist.device
    _state(hist, "histogram", dev, dtype=torch.float32)
    if hist.dim() != 2 or hist.shape[0] != 1 or not 1 <= hist.shape[1] <= 0x7FFFFFFF:
        raise ValueError(f"histogram must be (1, nbins), got {tuple(hist.shape)}")
    if not _on_card(dev):
        from retina_tpu_torch.detect.programs import dnstunnel_plain

        return dnstunnel_plain(hist)
    if hist.shape[1] > BANK_MAX_BINS:
        raise ValueError(f"{hist.shape[1]} histogram bins do not fit the kernel (at most "
                         f"{BANK_MAX_BINS})")
    return _one_slot("dnstunnel_score", BANK_DNSTUNNEL, hist, hist.shape[1])[:2]


def synflood_score(lanes):
    """The synflood program (K13): (9,) float32 tcpflag lanes -> (3,)
    float32 [syn / max(ack, 1), syn / max(total, 1), syn]. On the card a
    one-slot launch of the bank's close."""
    dev = lanes.device
    _state(lanes, "tcpflag lanes", dev, dtype=torch.float32, shape=(9,))
    if not _on_card(dev):
        from retina_tpu_torch.detect.programs import synflood_plain

        return synflood_plain(lanes)
    return _one_slot("synflood_score", BANK_SYNFLOOD, lanes, 9)[:3]


# ---------------------------------------------------------------------------
# K14: the apiserver latency match

LATENCY_MAX_SLOTS = 1 << 15  # the slots and the histogram live in shared memory
LATENCY_MAX_BUCKETS = 64
# Per (device, stream): K14's probe list, its count (which the finish leaves
# at 0) and the (records, rows, apiserver) of the step_rows call that filled
# it and was not finished yet. One stream orders its steps, so they can
# share them.
_latency_scratch: dict[tuple[int, int], dict] = {}


def _stream_key(dev: torch.device) -> tuple[int, int]:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def _latency_list(dev: torch.device, b: int) -> dict:
    key = _stream_key(dev)
    got = _latency_scratch.get(key)
    if got is None:
        got = _latency_scratch[key] = {
            "count": torch.zeros(1, dtype=torch.int32, device=dev), "pending": None}
    if got.get("entries") is None or got["entries"].shape[0] < b:
        got["entries"] = torch.empty((max(b, 1 << 16), 4), dtype=torch.int32, device=dev)
    return got


def latency_update(lat_key, lat_ts, lat_hist, records, mask, apiserver_ip):
    """The apiserver latency match (K14) in place: rows of ``records``
    (B, 16) whose ``mask`` lane (K1's) is set write their send fingerprints
    into ``lat_key``/``lat_ts`` (L,) and count matched replies' RTTs into
    ``lat_hist`` (H,) (see models/pipeline.py latency_update_plain).

    On the card the rows come from the probe list that ``step_rows`` with
    the same ``apiserver_ip`` filled for these records (its mask lane is
    ``mask``), and one launch finishes it; without such a call this raises."""
    dev = records.device
    if records.dim() != 2 or records.shape[1] != 16:
        raise ValueError(f"records must be (B, 16), got {tuple(records.shape)}")
    _state(records, "records", dev)
    b = records.shape[0]
    n_slots, n_buckets = lat_key.shape[0], lat_hist.shape[0]
    _pow2(n_slots, "latency slots")
    _state(lat_key, "lat_key", dev, shape=(n_slots,))
    _state(lat_ts, "lat_ts", dev, shape=(n_slots,))
    _state(lat_hist, "lat_hist", dev, shape=(n_buckets,))
    _col(mask, "mask", b, dev)
    api = int(apiserver_ip) & 0xFFFFFFFF
    if not _on_card(dev):
        from retina_tpu_torch.models.pipeline import latency_update_plain

        return latency_update_plain(lat_key, lat_ts, lat_hist, records, mask, api)
    if n_slots > LATENCY_MAX_SLOTS or not 1 <= n_buckets <= LATENCY_MAX_BUCKETS:
        raise ValueError(f"{n_slots} latency slots and {n_buckets} buckets do not fit the "
                         f"kernel (at most {LATENCY_MAX_SLOTS} and {LATENCY_MAX_BUCKETS})")
    if not b:
        return None
    lst = _latency_scratch.get(_stream_key(dev))
    if lst is None or lst["pending"] != (records.data_ptr(), b, api):
        raise ValueError("no probe list for these records: on the card step_rows(..., "
                         "apiserver_ip=...) lists them, on the same stream, before "
                         "latency_update")
    _launch("latency_update", dev, lst["count"].data_ptr(), lst["entries"].data_ptr(),
            lat_key.data_ptr(), lat_ts.data_ptr(), n_slots, lat_hist.data_ptr(), n_buckets)
    lst["pending"] = None
    return None


# ---------------------------------------------------------------------------
# K15: the invertible decode


INV_DECODE_MAX_JOBS = 2  # kMaxJobs in csrc/inv_decode.cu: a close's two regions
INV_DECODE_WARPS = 8  # kWarps there: buckets a block, a warp each


class _DecodeJob(ctypes.Structure):
    """``Job`` of csrc/inv_decode.cu."""

    _fields_ = [("planes", _VP), ("weights", _VP), ("n", _LL), ("row0", _LL),
                ("seed", _U32), ("width_log2", _INT), ("tier", _INT), ("block0", _INT)]


class _DecodeTable(ctypes.Structure):
    """``Table`` of csrc/inv_decode.cu: passed by value to the kernel."""

    _fields_ = [("keys", _VP), ("ok", _VP), ("tier", _VP), ("n_jobs", _INT),
                ("n_cols", _INT), ("n_blocks", _INT), ("pad", _INT),
                ("jobs", _DecodeJob * INV_DECODE_MAX_JOBS)]


def _decode_cols(planes: torch.Tensor, weights: torch.Tensor, dev: torch.device) -> int:
    """Checks one region's planes (D, W, 32(C+1)) and weights (D, W); its C."""
    _state(planes, "invertible planes", dev)
    if planes.dim() != 3:
        raise ValueError(f"invertible planes must be (D, W, planes), got {tuple(planes.shape)}")
    d, w, nb = planes.shape
    _pow2(w, "invertible width")
    if nb % 32 or not 1 <= nb // 32 - 1 <= 4:
        raise ValueError(f"{nb} planes do not fit 1 to 4 key columns")
    _state(weights, "invertible weights", dev, shape=(d, w))
    return nb // 32 - 1


def inv_decode_many(regions):
    """The invertible decode (K15) of one or two regions in one launch. Each
    region is (planes (D, W, 32(C+1)), weights (D, W), seed, tier), every
    region of the same C. Returns (keys (M, C) int32 key words, ok (M,)
    bool, tier (M,) int32), the regions' D*W buckets end to end in order:
    ``ok`` marks buckets of weight != 0 whose majority key passed its
    checksum and re-hashes to its own bucket, ``tier`` is the region's."""
    if not 1 <= len(regions) <= INV_DECODE_MAX_JOBS:
        raise ValueError(f"1 to {INV_DECODE_MAX_JOBS} decode regions, got {len(regions)}")
    dev = regions[0][0].device
    n_cols = {_decode_cols(planes, weights, dev) for planes, weights, _, _ in regions}
    if len(n_cols) != 1:
        raise ValueError(f"decode regions differ in key columns: {sorted(n_cols)}")
    c = n_cols.pop()
    if not _on_card(dev):
        from retina_tpu_torch.ops.invertible import decode_many_plain

        return decode_many_plain(regions)
    rows = [weights.numel() for _, weights, _, _ in regions]
    keys = torch.empty((sum(rows), c), dtype=torch.int32, device=dev)
    ok = torch.empty((sum(rows),), dtype=torch.bool, device=dev)
    tier = torch.empty((sum(rows),), dtype=torch.int32, device=dev)
    table = _DecodeTable()
    table.keys, table.ok, table.tier = keys.data_ptr(), ok.data_ptr(), tier.data_ptr()
    table.n_jobs, table.n_cols = len(regions), c
    block0 = row0 = 0
    for e, (planes, weights, seed, t), n in zip(table.jobs, regions, rows):
        e.planes, e.weights, e.n, e.row0 = planes.data_ptr(), weights.data_ptr(), n, row0
        e.seed, e.width_log2 = int(seed) & 0xFFFFFFFF, planes.shape[1].bit_length() - 1
        e.tier, e.block0 = int(t), block0
        block0 += -(-n // INV_DECODE_WARPS)
        row0 += n
    table.n_blocks = block0
    if block0:
        _launch("inv_decode", dev, ctypes.addressof(table))
    return keys, ok, tier


def inv_decode(planes, weights, seed, n_key_cols):
    """The invertible decode (K15) of one region, ``inv_decode_many``'s one
    job: (cols (C, D*W) int32 key words, a transposed view of its keys,
    ok (D*W,) bool)."""
    if not 1 <= int(n_key_cols) <= 4:
        raise ValueError(f"1 to 4 key columns, got {n_key_cols}")
    if planes.dim() == 3 and planes.shape[2] != 32 * (int(n_key_cols) + 1):
        raise ValueError(f"{planes.shape[2]} planes do not fit {n_key_cols} key columns")
    keys, ok, _ = inv_decode_many([(planes, weights, seed, 0)])
    return keys.t(), ok


# ---------------------------------------------------------------------------
# K16: the window close and the entropy bits

ENTROPY_MAX_BUCKETS = 1 << 14  # the widest histogram bank the wrappers take
ENTROPY_SLICES = 16  # blocks a group (at most one a bucket, at most 64): csrc/window_close.cu
# Per (device, stream): K16's f64 block partials and its tickets, a word a
# group, which the kernel leaves at 0. One stream orders its calls, so they
# share them.
_close_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _entropy_counts(counts: torch.Tensor, dev: torch.device) -> tuple[int, int]:
    _state(counts, "entropy counts", dev, dtype=torch.float32)
    if counts.dim() != 2:
        raise ValueError(f"entropy counts must be (groups, buckets), got {tuple(counts.shape)}")
    g, k = counts.shape
    if dev.type == "cuda" and k > ENTROPY_MAX_BUCKETS:
        raise ValueError(f"{k} entropy buckets do not fit the kernel (at most "
                         f"{ENTROPY_MAX_BUCKETS})")
    return g, k


def _close_args(dev: torch.device, g: int, k: int) -> tuple[int, int, int]:
    """(blocks a group, partials, tickets) of a K16 launch over (g, k)."""
    slices = max(1, min(ENTROPY_SLICES, k, 64))
    key = _stream_key(dev)
    got = _close_scratch.get(key)
    if got is None or got[0].numel() < g * slices or got[1].numel() < g:
        got = _close_scratch[key] = (
            torch.empty((max(g * slices, 1024),), dtype=torch.float64, device=dev),
            torch.zeros((max(g, 64),), dtype=torch.int32, device=dev))
    return slices, got[0].data_ptr(), got[1].data_ptr()


def window_close(counts, mean, var, n_obs, alpha, z_thresh, min_windows):
    """The window close (K16): the (G,) float32 entropy bits of the (G, K)
    float32 histograms ``counts``, the anomaly EWMA of each group applied to
    ``mean``, ``var`` and ``n_obs`` (G,) in place, and ``counts`` zeroed.
    Returns (bits, flags (G,) bool, z (G,) float32)."""
    dev = counts.device
    g, k = _entropy_counts(counts, dev)
    for t, name in ((mean, "ewma mean"), (var, "ewma var"), (n_obs, "ewma n_obs")):
        _state(t, name, dev, dtype=torch.float32, shape=(g,))
    if not _on_card(dev):
        from retina_tpu_torch.models.pipeline import end_window_plain

        return end_window_plain(counts, mean, var, n_obs, alpha, z_thresh, min_windows)
    bits = torch.empty((g,), dtype=torch.float32, device=dev)
    flags = torch.empty((g,), dtype=torch.bool, device=dev)
    z = torch.empty((g,), dtype=torch.float32, device=dev)
    if g:
        slices, partials, tickets = _close_args(dev, g, k)
        _launch("window_close", dev, counts.data_ptr(), g, k, slices, mean.data_ptr(),
                var.data_ptr(), n_obs.data_ptr(), float(alpha), float(z_thresh),
                float(min_windows), bits.data_ptr(), flags.data_ptr(), z.data_ptr(), partials,
                tickets)
    return bits, flags, z


def entropy_bits(counts):
    """K16's read-only entry: the (G,) float32 plug-in entropy bits of the
    (G, K) float32 histograms ``counts``."""
    dev = counts.device
    g, k = _entropy_counts(counts, dev)
    if not _on_card(dev):
        from retina_tpu_torch.ops.entropy import entropy_bits_plain

        return entropy_bits_plain(counts)
    bits = torch.empty((g,), dtype=torch.float32, device=dev)
    if g:
        slices, partials, tickets = _close_args(dev, g, k)
        _launch("entropy_bits", dev, counts.data_ptr(), g, k, slices, bits.data_ptr(), partials,
                tickets)
    return bits


# ---------------------------------------------------------------------------
# K17: the snapshot readout

READOUT_BLOCK_BYTES = 16 << 10  # bytes a block of K17 reads and writes, about
READOUT_MAX_JOBS = 32  # kMaxJobs in csrc/snapshot_readout.cu
READOUT_LIVE_BLOCKS = 1024  # the most blocks of a live count
_READOUT_KINDS = {"copy": 0, "hll_block": 1, "hll_warp": 2, "live": 3}
# Per (device, stream): the live count's 64-bit ticket, which the kernel
# leaves at 0. One stream orders its calls, so they share it.
_ct_scratch: dict[tuple[int, int], torch.Tensor] = {}
# (bytes a block, device, the jobs' kinds, pointers, shapes, strides and
# dtypes) -> [plan, launch table or None]: a state's snapshot plans once.
_readout_plans: dict[tuple, list] = {}


class _ReadoutJob(ctypes.Structure):
    """``Job`` of csrc/snapshot_readout.cu."""

    _fields_ = [("src", _VP), ("src2", _VP), ("n", _LL), ("dst", _LL), ("kind", _INT),
                ("block0", _INT), ("m", _INT), ("alpha_mm", _FLT)]


class _ReadoutTable(ctypes.Structure):
    """``Table`` of csrc/snapshot_readout.cu: passed by value to the kernel."""

    _fields_ = [("out", _VP), ("ticket", _VP), ("n_jobs", _INT), ("n_blocks", _INT),
                ("now", _U32), ("tcp_life", _U32), ("other_life", _U32), ("wrap_floor", _U32),
                ("jobs", _ReadoutJob * READOUT_MAX_JOBS)]


class ReadoutPlan(NamedTuple):
    """Where each job of a readout writes and how many blocks it takes."""

    kinds: tuple[str, ...]  # "copy", "hll_block", "hll_warp" or "live"
    offsets: tuple[int, ...]  # the first word of each job's output in the buffer
    words: tuple[int, ...]  # the words of each job's output
    blocks: tuple[int, ...]  # the blocks of each job
    total: int  # the words of the buffer


def readout_plan(jobs) -> ReadoutPlan:
    """The layout and grid of a readout of ``jobs``, each ("copy", leaf)
    (its words), ("hll", registers) (an f32 estimate a group) or ("live",
    keys, vals) (one int32 count): the outputs laid end to end in job order,
    and each job given blocks in proportion to the bytes it reads and
    writes, READOUT_BLOCK_BYTES a block, at least one a job with output, at
    most one a 1024 words copied, 1024 / m groups (hll, 4 <= m <= 128: a
    group on m / 4 lanes), a group (other hll banks: a block a group) or
    READOUT_LIVE_BLOCKS."""
    kinds, offsets, words, blocks = [], [], [], []
    off = 0
    for job in jobs:
        if job[0] == "copy":
            n = job[1].numel()
            kind, out, nbytes, cap = "copy", n, 8 * n, -(-n // 1024)
        elif job[0] == "hll":
            g, m = job[1].shape
            kind = "hll_warp" if 4 <= m <= 128 else "hll_block"
            out, nbytes = g, 4 * g * (m + 1)
            cap = -(-g * m // 1024) if kind == "hll_warp" else g
        else:
            n = job[1].shape[0]
            kind, out, nbytes, cap = "live", 1, 24 * n + 4, READOUT_LIVE_BLOCKS
        kinds.append(kind)
        offsets.append(off)
        words.append(out)
        blocks.append(max(1, min(cap, -(-nbytes // READOUT_BLOCK_BYTES))) if cap else 0)
        off += out
    return ReadoutPlan(tuple(kinds), tuple(offsets), tuple(words), tuple(blocks), off)


def _readout_check(jobs, dev: torch.device) -> None:
    if not 1 <= len(jobs) <= READOUT_MAX_JOBS:
        raise ValueError(f"1 to {READOUT_MAX_JOBS} readout jobs, got {len(jobs)}")
    if sum(job[0] == "live" for job in jobs) > 1:
        raise ValueError("at most one live count a readout")
    for i, job in enumerate(jobs):
        if job[0] == "copy":
            t = job[1]
            _state(t, f"readout leaf {i}", dev, dtype=t.dtype)
            if t.element_size() != 4:
                raise TypeError(f"readout leaf {i} must have 4-byte elements, got {t.dtype}")
        elif job[0] == "hll":
            regs = job[1]
            _state(regs, "hll registers", dev)
            if regs.dim() != 2:
                raise ValueError(f"hll registers must be (groups, m), got {tuple(regs.shape)}")
            _pow2(regs.shape[1], "hll registers per group")
        elif job[0] == "live":
            keys, vals = job[1], job[2]
            n_slots = keys.shape[0]
            _state(keys, "conntrack keys", dev, shape=(n_slots, 2))
            _state(vals, "conntrack vals", dev, shape=(n_slots, 4))
            if dev.type == "cuda" and (vals.data_ptr() % 16 or keys.data_ptr() % 8):
                raise ValueError("conntrack keys and vals must be 8- and 16-byte aligned")
        else:
            raise ValueError(f"unknown readout job {job[0]!r}")


def _readout_table(jobs, plan: ReadoutPlan) -> _ReadoutTable:
    from retina_tpu_torch.ops.hyperloglog import _alpha

    table = _ReadoutTable()
    table.n_jobs = len(jobs)
    block0 = 0
    for i, (job, kind, off, nb) in enumerate(zip(jobs, plan.kinds, plan.offsets, plan.blocks)):
        e = table.jobs[i]
        e.kind, e.block0, e.dst, e.src = _READOUT_KINDS[kind], block0, off, job[1].data_ptr()
        if kind == "copy":
            e.n = job[1].numel()
        elif kind == "live":
            e.n, e.src2 = job[1].shape[0], job[2].data_ptr()
        else:
            e.n, e.m = job[1].shape
            e.alpha_mm = _alpha(e.m) * e.m * e.m
        block0 += nb
    table.n_blocks = block0
    return table


def _readout_cached(jobs, dev: torch.device) -> list:
    """[plan, launch table or None] of ``jobs``, checked and planned once
    for the same tensors; the launch fills in the table the first time."""
    key = (READOUT_BLOCK_BYTES, dev, *((job[0], *((t.data_ptr(), tuple(t.shape), t.stride(),
                                                   t.dtype) for t in job[1:])) for job in jobs))
    got = _readout_plans.get(key)
    if got is None:
        _readout_check(jobs, dev)
        if len(_readout_plans) >= 16:
            _readout_plans.clear()
        got = _readout_plans[key] = [readout_plan(jobs), None]
    return got


def _readout_launch(name: str, dev: torch.device, jobs, out: torch.Tensor, now: int) -> None:
    from retina_tpu_torch.ops.conntrack import (
        CLOCK_SKEW_SLACK,
        CT_NON_TCP_LIFETIME,
        CT_TCP_LIFETIME,
    )

    got = _readout_cached(jobs, dev)
    if got[1] is None:
        got[1] = _readout_table(jobs, got[0])
    table = got[1]
    key = _stream_key(dev)
    ticket = _ct_scratch.get(key)
    if ticket is None:
        ticket = _ct_scratch[key] = torch.zeros((1,), dtype=torch.int64, device=dev)
    table.out, table.ticket = out.data_ptr(), ticket.data_ptr()
    table.now, table.tcp_life, table.other_life = now, CT_TCP_LIFETIME, CT_NON_TCP_LIFETIME
    table.wrap_floor = 0xFFFF - CLOCK_SKEW_SLACK
    _launch(name, dev, ctypes.addressof(table))


def snapshot_flat(jobs, now_s):
    """The snapshot readout (K17) in one launch: a fresh flat int32 buffer
    holding, in job order (``readout_plan``), each ("copy", leaf)'s words,
    each ("hll", registers)'s f32 estimates bit for bit and ("live", keys,
    vals)'s int32 count of live connections at ``now_s``."""
    if not jobs:
        raise ValueError("1 to 32 readout jobs, got 0")
    dev = jobs[0][1].device
    plan, _ = _readout_cached(jobs, dev)
    now = int(now_s) & 0xFFFFFFFF
    if not _on_card(dev):
        from retina_tpu_torch.parallel.telemetry import readout_plain

        return readout_plain(jobs, plan, now)
    flat = torch.empty((plan.total,), dtype=torch.int32, device=dev)
    if plan.total:
        _readout_launch("snapshot_flat", dev, jobs, flat, now)
    return flat


def hll_estimate(registers):
    """The HLL estimate (K17) of every group of a (G, m) int32 (u32 bits)
    register bank: (G,) float32. On the card, a one-job launch of the
    readout."""
    dev = registers.device
    _readout_check([("hll", registers)], dev)
    g = registers.shape[0]
    if not _on_card(dev):
        from retina_tpu_torch.ops.hyperloglog import estimate_plain

        return estimate_plain(registers)
    out = torch.empty((g,), dtype=torch.float32, device=dev)
    if g:
        _readout_launch("hll_estimate", dev, [("hll", registers)], out, 0)
    return out


def ct_active(keys, vals, now_s):
    """The live connections (K17) of a conntrack table ``keys`` (S, 2) and
    ``vals`` (S, 4) at ``now_s``: an int32 scalar tensor. On the card, a
    one-job launch of the readout."""
    dev = keys.device
    _readout_check([("live", keys, vals)], dev)
    now = int(now_s) & 0xFFFFFFFF
    if not _on_card(dev):
        from retina_tpu_torch.ops.conntrack import active_connections_plain

        return active_connections_plain(keys, vals, now)
    out = torch.empty((), dtype=torch.int32, device=dev)
    _readout_launch("ct_active", dev, [("live", keys, vals)], out, now)
    return out
