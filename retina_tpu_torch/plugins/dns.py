"""dns: DNS request/response metrics + query-name string table (port of
retina_tpu/plugins/dns.py).

Reference analog: pkg/plugin/dns — the Inspektor-Gadget DNS tracer turns
kernel DNS packets into flows with query/response/rcode/IPs
(dns_linux.go:49-62). Here DNS decode happens in the shared packet decoder
(sources/pcapdecode.py DNS pass), so this plugin owns the host-side pieces:
the qname hash → string table (merged from all sources via pubsub) and the
basic request/response gauges, while per-pod DNS counts and qname heavy
hitters ride the device pipeline (pod_dns rectangle, dns_hh sketch).
"""

from __future__ import annotations

import threading

import numpy as np

from retina_tpu_torch.config import Config
from retina_tpu_torch.events.schema import EV_DNS_REQ, EV_DNS_RESP, F
from retina_tpu_torch.metrics import get_metrics
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin

QTYPE_NAMES = {1: "A", 5: "CNAME", 28: "AAAA", 12: "PTR", 15: "MX", 16: "TXT",
               33: "SRV", 6: "SOA", 2: "NS"}
RCODE_NAMES = {0: "NOERROR", 1: "FORMERR", 2: "SERVFAIL", 3: "NXDOMAIN",
               4: "NOTIMP", 5: "REFUSED"}

TOPIC_DNS_NAMES = "dns_names"  # pubsub topic carrying {hash: qname} dicts


@registry.register
class DnsPlugin(Plugin):
    name = "dns"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.names: dict[int, str] = {}  # qname hash -> name
        self._req = np.zeros(32, np.int64)  # per-qtype-slot request counts
        self._resp: dict[tuple[int, int], int] = {}
        self._lock = threading.Lock()
        self._sub: str | None = None

    def init(self) -> None:
        from retina_tpu_torch.pubsub import get_pubsub

        self._sub = get_pubsub().subscribe(TOPIC_DNS_NAMES, self._on_names)

    def _on_names(self, table: dict[int, str]) -> None:
        with self._lock:
            self.names.update(table)
            # Bound the host string table (the device sketch is fixed-size;
            # the host side must be too).
            if len(self.names) > 65536:
                for k in list(self.names)[: len(self.names) - 65536]:
                    del self.names[k]

    def observe_records(self, records: np.ndarray) -> None:
        """Tally DNS events from a record block (called by the engine on
        the same blocks the device consumes — host-side cheap counts for
        the basic gauges; heavy aggregation stays on device)."""
        ev = records[:, F.EVENT_TYPE]
        dns_col = records[:, F.DNS]
        is_req = ev == EV_DNS_REQ
        is_resp = ev == EV_DNS_RESP
        if not (is_req.any() or is_resp.any()):
            return
        m = get_metrics()
        for qtype in np.unique(dns_col[is_req] >> 16):
            n = int(((dns_col[is_req] >> 16) == qtype).sum())
            m.dns_request_count.labels(
                query_type=QTYPE_NAMES.get(int(qtype), str(int(qtype)))
            ).inc(n)
        if is_resp.any():
            resp = dns_col[is_resp]
            pairs = np.stack([resp >> 16, (resp >> 8) & 0xFF], axis=1)
            uniq, counts = np.unique(pairs, axis=0, return_counts=True)
            for (qtype, rcode), n in zip(uniq, counts):
                m.dns_response_count.labels(
                    query_type=QTYPE_NAMES.get(int(qtype), str(int(qtype))),
                    return_code=RCODE_NAMES.get(int(rcode), str(int(rcode))),
                ).inc(int(n))

    def resolve(self, qname_hash: int) -> str:
        """Hash → query name for scrape-time heavy-hitter labels."""
        with self._lock:
            return self.names.get(qname_hash, f"unknown:{qname_hash:#x}")

    def qname_length_hist(self, nbins: int = 64) -> np.ndarray:
        """(1, nbins) f32 histogram of resolved qname string lengths —
        the high-fidelity ``extras["qname_hist"]`` feed for the
        dnstunnel detector: pcap-decoded records only carry a req/resp
        marker in the F.DNS low byte, but this table has the real
        names the wire carried."""
        hist = np.zeros((1, nbins), np.float32)
        with self._lock:
            lens = [len(v) for v in self.names.values()]
        if lens:
            ln = np.clip(np.asarray(lens, np.int64), 0, nbins - 1)
            hist[0] = np.bincount(ln, minlength=nbins).astype(np.float32)
        return hist

    def start(self, stop: threading.Event) -> None:
        stop.wait()  # passive: work happens in observe_records/pubsub

    def stop(self) -> None:
        if self._sub is not None:
            from retina_tpu_torch.pubsub import get_pubsub

            try:
                get_pubsub().unsubscribe(TOPIC_DNS_NAMES, self._sub)
            except KeyError:  # noqa: RT101 — unsubscribe after pubsub shutdown
                pass
            self._sub = None
