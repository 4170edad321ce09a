"""Connection tracking and report sampling (port of retina_tpu/ops/conntrack.py).

A direct-mapped table of 2^18 connections decides, per batch, which rows
report: always on SYN/FIN/RST, a new or expired connection, and otherwise
at most once per CT_REPORT_INTERVAL per connection. A report carries the
connection's packets and bytes since its previous report, this batch
included; the slot's accumulators then reset.

``process_plain`` follows the reference's algorithm in torch ops: the
direction-free fingerprint, a stable sort by (fp_lo, fp_hi), per-connection
sums, the resident-row gather, the report decision, the row write and the
scatter back to batch order. The kernel (K5, ``kernels/csrc/conntrack.cu``)
computes the same outputs without a sort, through a batch-local hash table
of connections. ``ConntrackTable.process`` reaches one or the other through
``kernels.ops.conntrack_process`` and updates ``keys`` and ``vals`` in place.

The rules the port fixes, in kernel and plain version alike (the reference
leaves the last two to XLA's sort and scatter; on its CPU backend they
agree with these):

- A connection's report and its payload land on its **last masked row in
  batch order**.
- A slot shared by several connections of one batch is written by the
  connection with the **largest (fp_lo, fp_hi)**, compared as unsigned
  and lexicographically.
- Every read of the resident table sees the table as it was **before this
  batch**: ``same_conn``, ``expired``, ``is_reply`` and the resident
  accumulators, for every connection that shares a slot.
- Per-connection packet and byte sums wrap modulo 2^32, as the
  reference's u32 scan does.
- Masked rows (past ``n_valid`` or filtered out) never report and never
  write; their ``is_reply`` is false.
"""

from __future__ import annotations

import dataclasses

import torch

from retina_tpu_torch.events.schema import TCP_FIN, TCP_RST, TCP_SYN
from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.ops.hashing import hash_cols
from retina_tpu_torch.u32 import M32, narrow, widen

CT_REPORT_INTERVAL = 30
CT_TCP_LIFETIME = 360
CT_NON_TCP_LIFETIME = 60
DEFAULT_SLOTS = 1 << 18
CLOCK_SKEW_SLACK = 256
# Lanes of process_lanes' (4, B) output, in order.
LANES = ("report", "is_reply", "report_packets", "report_bytes")


def fingerprint(src_ip, dst_ip, ports, proto, seed: int):
    """Direction-free connection key: (fp_lo, fp_hi, fwd_order), int64 u32
    values. ``fwd_order`` is true where src is the key's "a" side; ports
    break the tie for hairpin flows (src_ip == dst_ip)."""
    src, dst, ports = widen(src_ip), widen(dst_ip), widen(ports)
    sp, dp = ports >> 16, ports & 0xFFFF
    fwd = (src < dst) | ((src == dst) & (sp <= dp))
    a_pt, b_pt = torch.where(fwd, sp, dp), torch.where(fwd, dp, sp)
    cols = [torch.where(fwd, src, dst), torch.where(fwd, dst, src),
            (a_pt << 16) | b_pt, widen(proto)]
    s = (int(seed) * 2) & M32
    return (hash_cols(cols, (s + 0xC7) & M32), hash_cols(cols, (s + 0xC8) & M32), fwd)


def process_plain(keys, vals, seed, src_ip, dst_ip, ports, proto, tcp_flags, now_s,
                  bytes_, mask, packets) -> torch.Tensor:
    """Plain version of K5 (see kernels.ops.conntrack_process): updates
    ``keys``/``vals`` in place and returns the (4, B) int32 lanes of
    LANES in batch order. ``packets`` None counts one packet per row."""
    n_slots = keys.shape[0]
    b = mask.shape[0]
    dev = keys.device
    m = mask != 0
    fp_lo, fp_hi, fwd = fingerprint(src_ip, dst_ip, ports, proto, seed)
    slot = (fp_lo ^ fp_hi) & (n_slots - 1)
    k_lo = torch.where(m, fp_lo, M32)
    k_hi = torch.where(m, fp_hi, M32)
    # torch sorts int64 as signed: offset fp_lo by 2^31 so the order is the
    # unsigned lexicographic order of (k_lo, k_hi).
    order = torch.sort((k_lo - (1 << 31)) * (1 << 32) + k_hi, stable=True).indices
    s_lo, s_hi, s_slot, s_fwd, s_m = k_lo[order], k_hi[order], slot[order], fwd[order], m[order]
    s_tcp = widen(proto)[order] == 6
    s_int = ((widen(tcp_flags) & (TCP_SYN | TCP_FIN | TCP_RST)) > 0)[order] & s_m
    s_pkts = torch.where(s_m, 1 if packets is None else widen(packets)[order], 0)
    s_bytes = torch.where(s_m, widen(bytes_)[order], 0)

    diff = (s_lo[1:] != s_lo[:-1]) | (s_hi[1:] != s_hi[:-1])
    true = torch.ones((1,), dtype=torch.bool, device=dev)
    first = torch.cat([true, diff])
    last = torch.cat([diff, true]) & s_m
    seg = torch.cumsum(first.to(torch.int64), 0) - 1

    def seg_sum(x):  # each row's segment total (at most b segments)
        return torch.zeros((b,), dtype=torch.int64, device=dev).index_add_(0, seg, x)[seg]

    seg_pkts, seg_bytes = seg_sum(s_pkts), seg_sum(s_bytes)
    seg_int = seg_sum(s_int.to(torch.int64)) > 0

    krow, vrow = widen(keys)[s_slot], widen(vals)[s_slot]
    same = (krow[:, 0] == s_lo) & (krow[:, 1] == s_hi)
    meta = vrow[:, 0]
    seen16, rep14, init_a = meta & 0xFFFF, (meta >> 16) & 0x3FFF, ((meta >> 30) & 1) == 1
    now = int(now_s) & M32
    now16, now14 = now & 0xFFFF, now & 0x3FFF
    lifetime = torch.where(s_tcp, CT_TCP_LIFETIME, CT_NON_TCP_LIFETIME)
    idle = (now16 - seen16) & 0xFFFF
    expired = (idle > lifetime) & (idle <= 0xFFFF - CLOCK_SKEW_SLACK)
    is_new = ~same | expired
    rep_delta = (now14 - rep14) & 0x3FFF
    interval_up = (rep_delta >= CT_REPORT_INTERVAL) & (rep_delta <= 0x3FFF - CLOCK_SKEW_SLACK)
    report = last & (seg_int | is_new | (same & interval_up))
    is_reply = s_m & same & ~expired & (init_a != s_fwd)

    tot_pkts = (torch.where(is_new, 0, vrow[:, 1]) + seg_pkts) & M32
    tot_bytes = (torch.where(is_new, 0, vrow[:, 2]) + seg_bytes) & M32
    rep_pkts = torch.where(report, tot_pkts, 0)
    rep_bytes = torch.where(report, tot_bytes, 0)

    # Row write: among the last rows, the largest key of a slot (the last
    # in sorted order) writes it.
    new_meta = (now16 | (torch.where(report, now14, rep14) << 16)
                | (torch.where(is_new, s_fwd, init_a).to(torch.int64) << 30)
                | (s_tcp.to(torch.int64) << 31))
    pos = torch.arange(b, device=dev)
    win = torch.full((n_slots,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, s_slot, torch.where(last, pos, -1), "amax")
    has, w = (win >= 0)[:, None], win.clamp(min=0)
    new_keys = torch.stack([s_lo, s_hi], dim=1)[w]
    new_vals = torch.stack([new_meta, torch.where(report, 0, tot_pkts),
                            torch.where(report, 0, tot_bytes), torch.zeros_like(new_meta)],
                           dim=1)[w]
    keys.copy_(torch.where(has, narrow(new_keys), keys))
    vals.copy_(torch.where(has, narrow(new_vals), vals))

    out = torch.empty((4, b), dtype=torch.int32, device=dev)
    out[:, order] = narrow(torch.stack([report.to(torch.int64), is_reply.to(torch.int64),
                                        rep_pkts, rep_bytes]))
    return out


@dataclasses.dataclass
class ConntrackTable:
    """Direct-mapped connection table.

    keys: (S, 2) u32 [fp_lo, fp_hi]; (0, 0) marks an empty slot.
    vals: (S, 4) u32 [meta, packets, bytes, spare] where meta =
          seen16 | report14 << 16 | init_is_a << 30 | is_tcp << 31.

    ``scratch`` holds K5's batch-local tables, allocated at first use on
    the card and reused by every later call; it is not state.
    """

    keys: torch.Tensor
    vals: torch.Tensor
    seed: int = 0
    scratch: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                      compare=False)

    @classmethod
    def zeros(cls, n_slots: int = DEFAULT_SLOTS, seed: int = 0,
              device: torch.device | str | None = None) -> "ConntrackTable":
        if n_slots & (n_slots - 1):
            raise ValueError("n_slots must be a power of two")
        device = resolve_device(device)
        return cls(
            keys=torch.zeros((n_slots, 2), dtype=torch.int32, device=device),
            vals=torch.zeros((n_slots, 4), dtype=torch.int32, device=device),
            seed=seed,
        )

    @property
    def n_slots(self) -> int:
        return int(self.keys.shape[0])

    def process_lanes(self, src_ip, dst_ip, ports, proto, tcp_flags, now_s: int, bytes_,
                      mask, packets_=None) -> torch.Tensor:
        """One batch through K5, in place: the (4, B) int32 lanes of LANES
        in batch order. Columns are (B,) int32 u32 lanes (any stride);
        ``mask`` is 0/1 int32 or bool."""
        if mask.dtype == torch.bool:
            mask = mask.to(torch.int32)
        return kops.conntrack_process(self.keys, self.vals, self.seed, src_ip, dst_ip,
                                      ports, proto, tcp_flags, now_s, bytes_, mask,
                                      packets_, self.scratch)

    def process(self, src_ip, dst_ip, ports, proto, tcp_flags, now_s: int, bytes_, mask,
                packets_=None):
        """The reference's interface: (table, report_mask (B,) bool,
        is_reply (B,) bool, report_packets (B,) u32, report_bytes (B,) u32),
        aligned with the input batch order. ``packets_`` None counts one
        packet per row."""
        lanes = self.process_lanes(src_ip, dst_ip, ports, proto, tcp_flags, now_s, bytes_,
                                   mask, packets_)
        return self, lanes[0] != 0, lanes[1] != 0, lanes[2], lanes[3]

    def active_connections(self, now_s: int) -> torch.Tensor:
        """int32 count of non-expired resident connections (K17)."""
        return kops.ct_active(self.keys, self.vals, now_s)


def active_connections_plain(keys: torch.Tensor, vals: torch.Tensor, now_s: int) -> torch.Tensor:
    """Plain version of K17's count: the resident slots whose 16-bit idle
    time is within the protocol's lifetime or inside the clock-skew slack
    past the wrap, as an int32 scalar."""
    live = (keys[:, 0] | keys[:, 1]) != 0
    meta = widen(vals[:, 0])
    seen16 = meta & 0xFFFF
    is_tcp = (meta >> 31) > 0
    lifetime = torch.where(is_tcp, CT_TCP_LIFETIME, CT_NON_TCP_LIFETIME)
    idle = ((int(now_s) & 0xFFFFFFFF) - seen16) & 0xFFFF
    fresh = (idle <= lifetime) | (idle > 0xFFFF - CLOCK_SKEW_SLACK)
    return (live & fresh).sum().to(torch.int32)
