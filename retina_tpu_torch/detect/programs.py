"""Detector programs (port of retina_tpu/detect/programs.py).

Each detector's scoring is one call of a hand-written kernel on the bank's
device (``kernels/csrc/detect.cu``, through ``kernels/ops.py``): the
portscan program is an HLL bank keyed by source hash-group (K11), the
dnstunnel program the plug-in entropy of a qname-length histogram (K12),
the synflood program a SYN:ACK asymmetry over the tcpflag lanes (K13).
Their inputs are tiny host-built features (``features.py``). The bank's
close scores its built-in detectors and steps their anomaly EWMA in one
launch (``kops.bank_close``; K12 and K13 alone are one-slot launches of
it). Each has its plain PyTorch version beside it, which the kernel
wrapper runs for CPU tensors.
"""

from __future__ import annotations

import torch

from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.ops.entropy import AnomalyEWMA, entropy_bits_plain
from retina_tpu_torch.ops.hashing import _mul32
from retina_tpu_torch.ops.hyperloglog import HyperLogLog, estimate_plain, update_plain
from retina_tpu_torch.u32 import narrow, widen

# Portscan: sources fold into this many hash-groups, each an HLL of the
# distinct dst ports its sources probed, at precision 8 (256 registers).
PORTSCAN_GROUPS = 32
PORTSCAN_PRECISION = 8
PORTSCAN_SEED = 0x5CA7
GROUP_MUL = 2654435761  # the multiplicative source hash

# DNS tunneling: qname lengths bucketed 0..63.
DNSTUNNEL_BINS = 64

# Synflood input: 8 per-flag-bit packet counts (index = TCP flag bit) and
# the total TCP packets in lane 8.
SYNFLOOD_LANES = 9


def portscan_program(keys: torch.Tensor, weights: torch.Tensor,
                     groups: int = PORTSCAN_GROUPS, precision: int = PORTSCAN_PRECISION,
                     seed: int = PORTSCAN_SEED) -> torch.Tensor:
    """(P, 4) int32 keys [src, dst, proto, dst port], (P,) float32 weights
    -> (groups,) float32 distinct-dst-port estimates per source hash-group
    (K11). A scanning source lands in one group; weight-0 (padding) rows
    are masked out of the HLL."""
    return kops.portscan_score(keys, weights, groups, precision, seed)


def portscan_plain(keys: torch.Tensor, weights: torch.Tensor, groups: int, precision: int,
                   seed: int) -> torch.Tensor:
    """Plain version of K11: the group product wraps mod 2^32 before the
    modulus (``_mul32``: no int64 overflow for sources with the top bit
    set), then K3's plain update and the HLL estimate."""
    group = _mul32(widen(keys[:, 0]), GROUP_MUL) % groups
    hll = HyperLogLog.zeros(groups, precision, seed=seed, device=keys.device)
    update_plain(hll.registers, seed, [keys[:, 3]], narrow(group), (weights > 0).to(torch.int32))
    return estimate_plain(hll.registers)


def dnstunnel_program(hist: torch.Tensor) -> torch.Tensor:
    """(1, nbins) float32 qname-length histogram -> (2,) float32
    [entropy bits, total queries] (K12). Benign qnames cluster in a narrow
    length band; tunneled payloads spread toward the label ceiling."""
    return kops.dnstunnel_score(hist)


def dnstunnel_plain(hist: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: the plain entropy bits (K16's) and the sum."""
    bits = entropy_bits_plain(hist)
    return torch.stack([bits[0], hist.sum()])


def synflood_program(lanes: torch.Tensor) -> torch.Tensor:
    """(9,) float32 tcpflag lanes -> (3,) float32 [syn/ack ratio, syn
    fraction, syn count] (K13); denominators floor at 1."""
    return kops.synflood_score(lanes)


def synflood_plain(lanes: torch.Tensor) -> torch.Tensor:
    """Plain version of K13."""
    syn, ack, total = lanes[1], lanes[4], lanes[8]  # TCP_SYN = 1 << 1, TCP_ACK = 1 << 4
    return torch.stack([syn / torch.clamp(ack, min=1.0), syn / torch.clamp(total, min=1.0),
                        syn])


def bank_close_plain(slots, mean, var, n_obs):
    """Plain version of the bank's close (``kops.bank_close``): for each
    active slot in order, its score (``dnstunnel_plain``'s bits,
    ``synflood_plain``'s ratio or the maximum of K11's estimates), then
    ``AnomalyEWMA.observe`` of it on the slot's state, written back into
    ``mean``, ``var`` and ``n_obs`` in place. Returns (score, z, flag) (S,)
    on the host; 0 for inactive slots."""
    dev = mean.device
    n = len(slots)
    score, z, flag = torch.zeros(n), torch.zeros(n), torch.zeros(n, dtype=torch.bool)
    for i, (kind, x, z_thresh, min_windows, alpha) in enumerate(slots):
        if x is None:
            continue
        x = torch.as_tensor(x, device=dev)
        if kind == kops.BANK_DNSTUNNEL:
            h = dnstunnel_plain(x)[:1]
        elif kind == kops.BANK_SYNFLOOD:
            h = synflood_plain(x)[:1]
        else:
            h = torch.max(x).reshape(1)
        state = AnomalyEWMA(mean=mean[i:i + 1], var=var[i:i + 1], n_obs=n_obs[i:i + 1],
                            alpha=alpha)
        new, f, zs = state.observe(h, z_thresh=z_thresh, min_windows=min_windows)
        for dst, src in ((state.mean, new.mean), (state.var, new.var),
                         (state.n_obs, new.n_obs)):
            dst.copy_(src)
        score[i], z[i], flag[i] = h[0].cpu(), zs[0].cpu(), f[0].cpu()
    return score, z, flag
