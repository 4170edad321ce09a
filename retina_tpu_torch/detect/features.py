"""Host-side features of the detector programs (copy of
retina_tpu/detect/features.py).

Each helper turns one (N, NUM_FIELDS) record block into the small
fixed-shape feature array its program takes, in one vectorized numpy pass
on the record tap.
"""

from __future__ import annotations

import numpy as np

from retina_tpu_torch.detect.programs import DNSTUNNEL_BINS, SYNFLOOD_LANES
from retina_tpu_torch.events.schema import PROTO_TCP, F

# Flow-key batches pad to the next power of two, at least this.
_PAD_MIN = 1 << 6


def padded_flow_keys(rec: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, NUM_FIELDS) records -> ((P, 4) u32 keys, (P,) f32 weights) with
    P the next power of two >= N; padding rows carry weight 0."""
    n = int(len(rec))
    cap = _PAD_MIN
    while cap < n:
        cap <<= 1
    keys = np.zeros((cap, 4), np.uint32)
    w = np.zeros((cap,), np.float32)
    if n:
        keys[:n, 0] = rec[:, F.SRC_IP]
        keys[:n, 1] = rec[:, F.DST_IP]
        keys[:n, 2] = rec[:, F.META] >> np.uint32(24)
        keys[:n, 3] = rec[:, F.PORTS] & np.uint32(0xFFFF)
        w[:n] = rec[:, F.PACKETS]
    return keys, w


def tcpflag_lanes(rec: np.ndarray) -> np.ndarray:
    """(SYNFLOOD_LANES,) f32 packet counts: lane b = packets with TCP flag
    bit b set, lane 8 = total TCP packets."""
    lanes = np.zeros((SYNFLOOD_LANES,), np.float32)
    if not len(rec):
        return lanes
    meta = rec[:, F.META]
    tcp = (meta >> np.uint32(24)) == PROTO_TCP
    if not tcp.any():
        return lanes
    flags = (meta[tcp] >> np.uint32(16)) & np.uint32(0xFF)
    pk = rec[tcp, F.PACKETS].astype(np.float64)
    for bit in range(8):
        lanes[bit] = float(pk[(flags >> np.uint32(bit)) & 1 == 1].sum())
    lanes[8] = float(pk.sum())
    return lanes


def qname_length_hist(rec: np.ndarray, nbins: int = DNSTUNNEL_BINS) -> np.ndarray:
    """(1, nbins) f32 histogram of DNS qname lengths, read from the F.DNS
    low byte."""
    hist = np.zeros((1, nbins), np.float32)
    if not len(rec):
        return hist
    dns = rec[:, F.DNS]
    sel = dns != 0
    if not sel.any():
        return hist
    ln = np.clip(dns[sel] & np.uint32(0xFF), 0, nbins - 1).astype(np.int64)
    hist[0] = np.bincount(ln, minlength=nbins).astype(np.float32)
    return hist
