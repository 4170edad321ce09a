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
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator

import torch

from retina_tpu_torch.kernels import build

_VP, _LL, _U32, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_int
_COLS = [_VP, _LL] * 4 + [_INT]

_ARGTYPES = {
    "step_rows": [_VP, _LL, _U32, _U32, _VP, _INT, _U32, _VP, _INT, _U32]
    + [_VP] * 9 + [_INT] * 5 + [_U32] * 3 + [_VP],
    "hh_update": [_VP, _INT, _INT, _U32, _VP, _VP, _INT, _U32, _VP]
    + _COLS + [_VP, _LL, _LL, _VP],
    "hll_update": [_VP, _INT, _INT, _U32] + _COLS + [_VP, _LL, _VP, _LL, _LL, _VP],
    "entropy_update": [_VP, _INT, _U32] + _COLS + [_VP, _LL, _LL, _VP],
}

# Kernel launches per wrapper since the last reset (a launch of hh_update
# counts its three phases).
_launches = {name: 0 for name in _ARGTYPES}
_plain_on_card = False
_fns: dict[str, ctypes._CFuncPtr] = {}

# Per-event scratch lanes written by step_rows, in order (see
# csrc/step_rows.cu, enum Lane).
SCRATCH = (
    "src_pod", "dst_pod", "proto", "dport", "flow_w", "svc_w", "dns_w",
    "ent_w", "mask", "is_drop", "reason", "pod_grp", "pod_mask",
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
        fn = getattr(build.load(name), name)
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


def step_rows(records, n_valid, sample_k, ident_table, ident_seed,
              filt_table, filt_seed, pod_forward, pod_drop, pod_tcpflags,
              pod_dns, pod_retrans, node_counters, totals, cfg):
    """Per-event body of the step (K1): updates the rectangles, node
    counters and totals[0:6] in place and returns (scratch (13, B) int32
    with the lanes of SCRATCH, sums (10,) int32 of this batch).

    ``cfg`` is a PipelineConfig; ``filt_table`` is None when no filter map
    is consulted."""
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
    if records.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned")
    scratch = torch.empty((len(SCRATCH), b), dtype=torch.int32, device=dev)
    sums = torch.zeros((N_SUMS,), dtype=torch.int32, device=dev)
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
        cfg.priority_ip_mask & 0xFFFFFFFF, cfg.priority_ip_match & 0xFFFFFFFF,
    )
    return scratch, sums


# ---------------------------------------------------------------------------
# K2


def hh_update(cms_table, cms_seed, key_rows, counts, table_seed, key_cols, weights):
    """Heavy-hitter update (K2) in place: CMS add, query, slot max, winner
    key write. The winner of a slot is the last row in batch order among
    the rows whose estimate equals the slot's new count."""
    dev = cms_table.device
    b = weights.shape[0]
    _state(cms_table, "cms table", dev)
    d, w = cms_table.shape
    _pow2(w, "cms width")
    s = counts.shape[0]
    _pow2(s, "topk slots")
    _state(counts, "topk counts", dev, shape=(s,))
    _state(key_rows, "topk key rows", dev, shape=(s, len(key_cols)))
    _col(weights, "weights", b, dev)
    _key_cols(key_cols, b, dev)
    if not _on_card(dev):
        from retina_tpu_torch.ops.topk import hh_update_plain

        return hh_update_plain(cms_table, cms_seed, key_rows, counts, table_seed,
                               key_cols, weights)
    if b >= 0x7FFFFFFF:
        raise ValueError("batch too large for the 32-bit row index")
    packed = torch.empty((s,), dtype=torch.int64, device=dev)
    _launch(
        "hh_update", dev, cms_table.data_ptr(), d, w, int(cms_seed) & 0xFFFFFFFF,
        key_rows.data_ptr(), counts.data_ptr(), s, int(table_seed) & 0xFFFFFFFF,
        packed.data_ptr(), *_col_args(key_cols), weights.data_ptr(), weights.stride(0), b,
        n_launches=3,
    )


# ---------------------------------------------------------------------------
# K3


def hll_update(registers, seed, key_cols, group, mask):
    """HyperLogLog bank update (K3) in place. ``group`` None means group 0;
    rows with ``mask`` 0 are skipped."""
    dev = registers.device
    b = mask.shape[0]
    _state(registers, "hll registers", dev)
    g, m = registers.shape
    _pow2(m, "hll registers per group")
    _col(mask, "mask", b, dev)
    if group is not None:
        _col(group, "group", b, dev)
    _key_cols(key_cols, b, dev)
    if not _on_card(dev):
        from retina_tpu_torch.ops.hyperloglog import update_plain

        return update_plain(registers, seed, key_cols, group, mask)
    _launch(
        "hll_update", dev, registers.data_ptr(), g, m.bit_length() - 1,
        int(seed) & 0xFFFFFFFF, *_col_args(key_cols),
        None if group is None else group.data_ptr(),
        0 if group is None else group.stride(0),
        mask.data_ptr(), mask.stride(0), b,
    )


# ---------------------------------------------------------------------------
# K4


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
    _launch(
        "entropy_update", dev, counts.data_ptr(), k, int(seed) & 0xFFFFFFFF,
        *_col_args(key_cols), weights.data_ptr(), weights.stride(0), b,
    )
