"""Synthetic traffic (copy of retina_tpu/events/synthetic.py).

A fixed table of ``n_flows`` 5-tuples between ``n_pods`` pod IPs is drawn
once; batches sample flow ids from a Zipf law, so heavy hitters exist by
construction and ``true_top_k`` scores recall. A batch is the "mix" blend
(TCP/UDP forwards, drops, a DNS sprinkle) reshaped by the active ``mode``
(``_shape_regime``): the attack and churn regimes of the ``PRESETS`` table.
``ddos_batch``, ``portscan_batch`` and ``tunnel_batch`` make one attack
with attributable ground truth. The random draws are made in the
reference's order, so every batch is bit-identical to the reference
generator's for the same seed.

``mode="pcap_replay"`` serves the banked captures
(``tests/fixtures/real/*.pcap``, or ``pcap_paths``) as looping,
timestamp-rebased passes (``sources/pcapreplay.py``).
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

# Generator regime presets: overrides of the TrafficGen
# defaults. "zipf" and "uniform" change the flow-size skew; the attack and
# churn regimes set ``mode`` and the distribution that makes them
# adversarial for one subsystem. The single source of legal preset names.
PRESETS: dict[str, dict[str, float | str]] = {
    "default": {},
    "zipf": {"zipf_a": 1.6},
    "uniform": {"zipf_a": 1.001},
    "dns_flood": {"mode": "dns_flood", "dns_fraction": 0.8, "zipf_a": 1.5},
    "syn_storm": {"mode": "syn_storm", "zipf_a": 1.05, "drop_fraction": 0.15},
    "conntrack_churn": {"mode": "conntrack_churn", "zipf_a": 1.05},
    "elephant_mice": {"mode": "elephant_mice", "zipf_a": 2.0},
    # Vertical port sweep: a few scanner sources probe many dst ports on
    # one victim (detect.portscan's matching regime).
    "portscan": {"mode": "portscan", "zipf_a": 1.2},
    "pcap_replay": {"mode": "pcap_replay"},
}

# Legal TrafficGen.mode values ("mix" is the default blend).
MODES = ("mix", "dns_flood", "syn_storm", "conntrack_churn",
         "elephant_mice", "portscan", "pcap_replay")

_SYN_INGRESS = (
    (np.uint32(PROTO_TCP) << np.uint32(24))
    | (np.uint32(TCP_SYN) << np.uint32(16))
    | (np.uint32(OP_FROM_NETWORK) << np.uint32(8))
    | (np.uint32(DIR_INGRESS) << np.uint32(4))
)


def preset_params(name: str) -> dict[str, float | str]:
    """Overrides for one preset; unknown names raise."""
    try:
        return dict(PRESETS[name])
    except KeyError:
        raise ValueError(f"unknown gen_preset {name!r}") from None


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
    mode: str = "mix"  # batch-shaping regime (MODES)
    seed: int = 0
    # pcap_replay inputs; empty = the repo's banked fixtures.
    pcap_paths: tuple[str, ...] = ()

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"TrafficGen mode must be one of {MODES}, got {self.mode!r}")
        if self.mode == "pcap_replay":
            self._init_replay()
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

    # -- pcap replay (mode="pcap_replay") ------------------------------
    def _init_replay(self) -> None:
        """Decode the captures once; batches then come from looping,
        timestamp-rebased passes."""
        import pathlib

        from retina_tpu_torch.sources.pcapreplay import PcapReplaySource, safe_decode_bytes

        paths = [pathlib.Path(p) for p in self.pcap_paths]
        if not paths:
            fixture_dir = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "real"
            paths = sorted(fixture_dir.glob("*.pcap"))
        blocks = []
        for p in paths:
            dec = safe_decode_bytes(p.read_bytes())
            if len(dec.result.records):
                blocks.append(dec.result.records)
        if not blocks:
            raise ValueError("pcap_replay: no decodable records in "
                             + (", ".join(str(p) for p in paths) or "<no files>"))
        self._replay_src = PcapReplaySource(np.concatenate(blocks))
        self._replay_blocks = self._replay_src.blocks()
        self._replay_buf = np.zeros((0, NUM_FIELDS), np.uint32)
        self._replay_pos = 0

    def _replay_batch(self, n_events: int) -> np.ndarray:
        out = []
        have = 0
        while have < n_events:
            if self._replay_pos >= len(self._replay_buf):
                blk = next(self._replay_blocks, None)
                if blk is None:  # pass done: the next, rebased pass
                    self._replay_blocks = self._replay_src.blocks()
                    blk = next(self._replay_blocks)
                self._replay_buf, self._replay_pos = blk, 0
            take = min(n_events - have, len(self._replay_buf) - self._replay_pos)
            out.append(self._replay_buf[self._replay_pos: self._replay_pos + take])
            self._replay_pos += take
            have += take
        return np.concatenate(out).astype(np.uint32)

    def batch(self, n_events: int) -> np.ndarray:
        """Generate (n_events, NUM_FIELDS) uint32 records."""
        if self.mode == "pcap_replay":
            return self._replay_batch(n_events)
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
        # F.DNS low byte carries the qname length (qtype<<16 | rcode<<8 |
        # len); benign names cluster in 8..16, the detect.dnstunnel baseline.
        qlen = rng.integers(8, 17, n_events).astype(np.uint32)
        rec[is_dns, F.DNS] = (
            (qtype[is_dns] << np.uint32(16)) | qlen[is_dns]
        ).astype(np.uint32)
        rec[is_dns, F.DNS_QHASH] = (fid[is_dns] & 0xFFFF).astype(np.uint32)
        return self._shape_regime(rec, fid)

    def _shape_regime(self, rec: np.ndarray, fid: np.ndarray) -> np.ndarray:
        """Reshape one sampled batch into the active regime; the flow
        accounting of ``true_counts`` is unchanged."""
        if self.mode == "mix":
            return rec
        rng = self._rng
        n = len(rec)
        if self.mode == "dns_flood":
            # The DNS share all targets a few resolver pods over UDP:53 with
            # tiny frames and qname lengths spread toward the label ceiling.
            is_dns = np.isin(
                rec[:, F.EVENT_TYPE],
                np.array([EV_DNS_REQ, EV_DNS_RESP], np.uint32),
            )
            resolvers = (POD_NET + 1 + (fid % 4)).astype(np.uint32)
            rec[is_dns, F.DST_IP] = resolvers[is_dns]
            rec[is_dns, F.PORTS] = (
                rec[is_dns, F.PORTS] & np.uint32(0xFFFF0000)
            ) | np.uint32(53)
            rec[is_dns, F.META] = (
                rec[is_dns, F.META] & np.uint32(0x00FFFFFF)
            ) | (np.uint32(PROTO_UDP) << np.uint32(24))
            rec[is_dns, F.BYTES] = rng.integers(
                64, 140, int(is_dns.sum())
            ).astype(np.uint32)
            qlen = rng.integers(24, 64, int(is_dns.sum())).astype(np.uint32)
            rec[is_dns, F.DNS] = (
                rec[is_dns, F.DNS] & np.uint32(0xFFFFFF00)
            ) | qlen
        elif self.mode == "syn_storm":
            # Half-open flood: most rows become 64-byte SYNs from spoofed
            # (non-pod) sources onto a few victim pods.
            storm = rng.random(n) < 0.9
            ns = int(storm.sum())
            rec[storm, F.SRC_IP] = rng.integers(
                0xC6000000, 0xC7000000, ns
            ).astype(np.uint32)
            victims = (POD_NET + 1 + (fid % 8)).astype(np.uint32)
            rec[storm, F.DST_IP] = victims[storm]
            rec[storm, F.META] = _SYN_INGRESS
            rec[storm, F.BYTES] = 64
        elif self.mode == "conntrack_churn":
            # Every event gets a fresh ephemeral source port: nearly every
            # combined row is a distinct 5-tuple.
            eph = rng.integers(1024, 65536, n).astype(np.uint32)
            rec[:, F.PORTS] = (eph << np.uint32(16)) | (
                rec[:, F.PORTS] & np.uint32(0xFFFF)
            )
            syn = rng.random(n) < 0.3
            rec[syn, F.META] = (
                rec[syn, F.META] & np.uint32(0xFF00FFFF)
            ) | (np.uint32(TCP_SYN) << np.uint32(16))
        elif self.mode == "portscan":
            # Vertical sweep: most rows become SYN probes from a few scanner
            # sources walking dst ports 1..1024 on one victim.
            scan = rng.random(n) < 0.6
            ns = int(scan.sum())
            scanners = np.uint32(0xC9000000) + (fid % 4).astype(np.uint32)
            rec[scan, F.SRC_IP] = scanners[scan]
            rec[scan, F.DST_IP] = pod_ip(1)
            sweep = rng.integers(1, 1025, ns).astype(np.uint32)
            rec[scan, F.PORTS] = (np.uint32(40000) << np.uint32(16)) | sweep
            rec[scan, F.META] = _SYN_INGRESS
            rec[scan, F.BYTES] = 64
        elif self.mode == "elephant_mice":
            # Bimodal sizes: the head flows carry MTU frames, the mouse tail
            # minimum-size ones.
            elephant = fid < max(1, self.n_flows // 100)
            rec[elephant, F.BYTES] = rng.integers(
                1400, 1501, int(elephant.sum())
            ).astype(np.uint32)
            rec[~elephant, F.BYTES] = rng.integers(
                64, 200, int((~elephant).sum())
            ).astype(np.uint32)
        return rec

    def true_counts(self) -> np.ndarray:
        """(n_flows,) exact per-flow event counts generated so far."""
        return self._counts.copy()

    def true_top_k(self, k: int) -> np.ndarray:
        """Flow ids of the k most frequent flows so far."""
        return np.argsort(self._counts)[::-1][:k]

    # -- attacks with attributable ground truth ---------------------------
    def _attack_rows(self, n_events: int) -> np.ndarray:
        """Zeroed records with the generator's clock advanced 100 ns a row."""
        rec = np.zeros((n_events, NUM_FIELDS), np.uint32)
        ts = self._now_ns + np.arange(n_events, dtype=np.int64) * 100
        self._now_ns = int(ts[-1]) + 100
        rec[:, F.TS_LO] = (ts & 0xFFFFFFFF).astype(np.uint32)
        rec[:, F.TS_HI] = (ts >> 32).astype(np.uint32)
        return rec

    def ddos_batch(self, n_events: int, target_pod: int = 1,
                   n_sources: int = 50_000) -> np.ndarray:
        """A volumetric attack: many sources SYN one destination on port 80
        (src-IP entropy spikes, dst-IP entropy collapses)."""
        rng = self._rng
        rec = self._attack_rows(n_events)
        rec[:, F.SRC_IP] = rng.integers(
            0xC0000000, 0xC0000000 + n_sources, n_events
        ).astype(np.uint32)
        rec[:, F.DST_IP] = pod_ip(target_pod)
        rec[:, F.PORTS] = (
            rng.integers(1024, 65536, n_events).astype(np.uint32) << np.uint32(16)
        ) | np.uint32(80)
        rec[:, F.META] = _SYN_INGRESS
        rec[:, F.BYTES] = 64
        rec[:, F.PACKETS] = 1
        rec[:, F.VERDICT] = VERDICT_FORWARDED
        rec[:, F.EVENT_TYPE] = EV_FORWARD
        return rec

    def portscan_batch(self, n_events: int, target_pod: int = 1, n_scanners: int = 4,
                       n_ports: int = 24) -> np.ndarray:
        """A vertical port sweep: few scanners x few probed ports, so the
        flow keys are few and heavy while per-source distinct dst ports
        spike (detect.portscan's signature)."""
        rng = self._rng
        rec = self._attack_rows(n_events)
        scanner = rng.integers(0, n_scanners, n_events).astype(np.uint32)
        rec[:, F.SRC_IP] = np.uint32(0xC9000000) + scanner
        rec[:, F.DST_IP] = pod_ip(target_pod)
        port = (1 + rng.integers(0, n_ports, n_events)).astype(np.uint32)
        rec[:, F.PORTS] = (np.uint32(40000) << np.uint32(16)) | port
        rec[:, F.META] = _SYN_INGRESS
        rec[:, F.BYTES] = 64
        rec[:, F.PACKETS] = 1
        rec[:, F.VERDICT] = VERDICT_FORWARDED
        rec[:, F.EVENT_TYPE] = EV_FORWARD
        return rec

    def tunnel_batch(self, n_events: int, resolver_pod: int = 2,
                     n_clients: int = 48) -> np.ndarray:
        """DNS exfiltration: clients stream TXT queries of long, varied
        qname lengths at one resolver (detect.dnstunnel's signature)."""
        rng = self._rng
        rec = self._attack_rows(n_events)
        client = rng.integers(0, n_clients, n_events).astype(np.uint32)
        rec[:, F.SRC_IP] = np.uint32(0xCA000000) + client
        rec[:, F.DST_IP] = pod_ip(resolver_pod)
        eph = rng.integers(1024, 65536, n_events).astype(np.uint32)
        rec[:, F.PORTS] = (eph << np.uint32(16)) | np.uint32(53)
        rec[:, F.META] = (
            (np.uint32(PROTO_UDP) << np.uint32(24))
            | (np.uint32(OP_FROM_NETWORK) << np.uint32(8))
            | (np.uint32(DIR_INGRESS) << np.uint32(4))
        )
        qlen = rng.integers(24, 64, n_events).astype(np.uint32)
        rec[:, F.DNS] = (np.uint32(16) << np.uint32(16)) | qlen  # TXT
        rec[:, F.DNS_QHASH] = rng.integers(0, 1 << 16, n_events).astype(np.uint32)
        rec[:, F.BYTES] = rng.integers(100, 300, n_events).astype(np.uint32)
        rec[:, F.PACKETS] = 1
        rec[:, F.VERDICT] = VERDICT_FORWARDED
        rec[:, F.EVENT_TYPE] = EV_DNS_REQ
        return rec
