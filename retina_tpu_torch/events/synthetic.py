"""Synthetic traffic (copy of the "mix" mode of retina_tpu/events/synthetic.py).

A fixed table of ``n_flows`` 5-tuples between ``n_pods`` pod IPs is drawn
once; batches sample flow ids from a Zipf law, so heavy hitters exist by
construction and ``true_top_k`` scores recall. The random draws are made
in the reference's order, so a batch is bit-identical to the reference
generator's for the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from retina_tpu_torch.events.schema import (
    DIR_EGRESS,
    DIR_INGRESS,
    EV_DNS_REQ,
    EV_DNS_RESP,
    EV_DROP,
    EV_FORWARD,
    F,
    NUM_FIELDS,
    OP_FROM_NETWORK,
    OP_TO_NETWORK,
    PROTO_TCP,
    PROTO_UDP,
    TCP_ACK,
    TCP_SYN,
    VERDICT_DROPPED,
    VERDICT_FORWARDED,
)

POD_NET = 0x0A000000  # 10.0.0.0/8: pod IPs are POD_NET + pod_index


def pod_ip(index: int) -> int:
    return POD_NET + index


@dataclasses.dataclass
class TrafficGen:
    """Vectorized flow-event generator with Zipf flow popularity."""

    n_flows: int = 100_000
    n_pods: int = 256
    zipf_a: float = 1.2
    drop_fraction: float = 0.02
    dns_fraction: float = 0.01
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.n_flows
        self.src_pod = rng.integers(1, self.n_pods, n).astype(np.uint32)
        self.dst_pod = rng.integers(1, self.n_pods, n).astype(np.uint32)
        self.src_ip = (POD_NET + self.src_pod).astype(np.uint32)
        self.dst_ip = (POD_NET + self.dst_pod).astype(np.uint32)
        self.sport = rng.integers(1024, 65536, n).astype(np.uint32)
        self.dport = rng.choice(
            np.array([80, 443, 53, 8080, 5432], np.uint32), n
        ).astype(np.uint32)
        self.proto = np.where(
            rng.random(n) < 0.8, PROTO_TCP, PROTO_UDP
        ).astype(np.uint32)
        w = (np.arange(1, n + 1, dtype=np.float64)) ** (-self.zipf_a)
        self.flow_probs = w / w.sum()
        self._rng = rng
        self._counts = np.zeros(n, np.int64)
        self._now_ns = 1_700_000_000 * 1_000_000_000

    def batch(self, n_events: int) -> np.ndarray:
        """Generate (n_events, NUM_FIELDS) uint32 records."""
        rng = self._rng
        fid = rng.choice(self.n_flows, n_events, p=self.flow_probs)
        np.add.at(self._counts, fid, 1)
        rec = np.zeros((n_events, NUM_FIELDS), np.uint32)
        ts = self._now_ns + np.arange(n_events, dtype=np.int64) * 1000
        self._now_ns = int(ts[-1]) + 1000
        rec[:, F.TS_LO] = (ts & 0xFFFFFFFF).astype(np.uint32)
        rec[:, F.TS_HI] = (ts >> 32).astype(np.uint32)
        rec[:, F.SRC_IP] = self.src_ip[fid]
        rec[:, F.DST_IP] = self.dst_ip[fid]
        rec[:, F.PORTS] = (self.sport[fid] << np.uint32(16)) | self.dport[fid]
        flags = np.where(
            rng.random(n_events) < 0.05, TCP_SYN, TCP_ACK
        ).astype(np.uint32)
        obs = np.where(
            rng.random(n_events) < 0.5, OP_FROM_NETWORK, OP_TO_NETWORK
        ).astype(np.uint32)
        direction = np.where(
            obs == OP_FROM_NETWORK, DIR_INGRESS, DIR_EGRESS
        ).astype(np.uint32)
        rec[:, F.META] = (
            (self.proto[fid] << np.uint32(24))
            | (flags << np.uint32(16))
            | (obs << np.uint32(8))
            | (direction << np.uint32(4))
        )
        rec[:, F.BYTES] = rng.integers(64, 1500, n_events).astype(np.uint32)
        rec[:, F.PACKETS] = 1
        dropped = rng.random(n_events) < self.drop_fraction
        rec[:, F.VERDICT] = np.where(
            dropped, VERDICT_DROPPED, VERDICT_FORWARDED
        ).astype(np.uint32)
        rec[:, F.DROP_REASON] = np.where(
            dropped, rng.integers(1, 8, n_events), 0
        ).astype(np.uint32)
        rec[:, F.EVENT_TYPE] = np.where(dropped, EV_DROP, EV_FORWARD).astype(
            np.uint32
        )
        is_dns = rng.random(n_events) < self.dns_fraction
        is_resp = is_dns & (rng.random(n_events) < 0.5)
        rec[is_dns, F.EVENT_TYPE] = np.where(
            is_resp[is_dns], EV_DNS_RESP, EV_DNS_REQ
        ).astype(np.uint32)
        qtype = rng.choice(np.array([1, 28, 5], np.uint32), n_events)
        qlen = rng.integers(8, 17, n_events).astype(np.uint32)
        rec[is_dns, F.DNS] = (
            (qtype[is_dns] << np.uint32(16)) | qlen[is_dns]
        ).astype(np.uint32)
        rec[is_dns, F.DNS_QHASH] = (fid[is_dns] & 0xFFFF).astype(np.uint32)
        return rec

    def true_counts(self) -> np.ndarray:
        """(n_flows,) exact per-flow event counts generated so far."""
        return self._counts.copy()

    def true_top_k(self, k: int) -> np.ndarray:
        """Flow ids of the k most frequent flows so far."""
        return np.argsort(self._counts)[::-1][:k]
