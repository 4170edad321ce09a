"""The port's default plugins against the reference's on the same inputs.

packetparser: the record blocks each source emits (the three in-repo
captures through the pcap source, the synthetic source at a seed and a
generator preset, with and without its pre-generated ring, and the live
source's socket loop over the captures' raw frames); dns: its request and
response series, the name table and the qname-length histogram;
packetforward and dropreason: the series they publish from the same host
counters. The reference's counters read ``._value.get()``, the port's
``._value``.
"""

from __future__ import annotations

import socket
import struct
import threading
from pathlib import Path

import numpy as np
import pytest

import retina_tpu.plugins  # noqa: F401  (self-registration)
import retina_tpu_torch.plugins  # noqa: F401
from retina_tpu.config import Config as RConfig
from retina_tpu.metrics import get_metrics as ref_metrics
from retina_tpu.plugins import registry as ref_registry
from retina_tpu.plugins.dns import DnsPlugin as RDns
from retina_tpu.plugins.dropreason import DropReasonPlugin as RDrop
from retina_tpu.plugins.packetforward import PacketForwardPlugin as RForward
from retina_tpu.plugins.packetparser import PacketParserPlugin as RParser
from retina_tpu_torch import exporter as port_exporter_mod
from retina_tpu_torch import metrics as port_metrics_mod
from retina_tpu_torch.config import Config as PConfig
from retina_tpu_torch.events.schema import EV_DNS_REQ, EV_DNS_RESP, NUM_FIELDS, F
from retina_tpu_torch.events.synthetic import TrafficGen
from retina_tpu_torch.metrics import get_metrics as port_metrics
from retina_tpu_torch.plugins import registry as port_registry
from retina_tpu_torch.plugins.api import UnsupportedPlatform
from retina_tpu_torch.plugins.dns import DnsPlugin as PDns
from retina_tpu_torch.plugins.dropreason import DropReasonPlugin as PDrop
from retina_tpu_torch.plugins.packetforward import PacketForwardPlugin as PForward
from retina_tpu_torch.plugins.packetparser import BLOCK, PacketParserPlugin as PParser

CAPTURES = sorted((Path(__file__).parent / "fixtures" / "real").glob("*.pcap"))


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    port_exporter_mod.reset_for_tests()
    port_metrics_mod.reset_for_tests()
    yield


def ref_val(metric, **labels):
    return metric.labels(**labels)._value.get()


def port_val(metric, **labels):
    return metric.labels(**labels)._value


class StopAfter:
    """A sink that keeps every block and sets ``stop`` after ``n`` of them."""

    def __init__(self, stop: threading.Event, n: int | None = None):
        self.stop, self.n, self.blocks = stop, n, []

    def write_records(self, records, plugin):
        self.blocks.append((records.copy(), plugin))
        if self.n is not None and len(self.blocks) >= self.n:
            self.stop.set()
        return len(records)


def run_parser(cls, cfg, n_blocks=None):
    p = cls(cfg)
    stop = threading.Event()
    sink = StopAfter(stop, n_blocks)
    p.set_sink(sink)
    p.generate(); p.compile(); p.init()
    t = threading.Thread(target=p.start, args=(stop,), daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive()
    p.stop()
    return p, sink.blocks


def both_cfgs(**kw):
    return RConfig(**kw), PConfig(**kw)


def test_registry_holds_the_default_plugins():
    assert set(PConfig().enabled_plugins) <= set(port_registry.names())
    assert set(port_registry.names()) <= set(ref_registry.names())
    with pytest.raises(KeyError):
        port_registry.get("nosuchplugin")
    with pytest.raises(ValueError):
        port_registry.add("dns", PDns)


@pytest.mark.parametrize("capture", CAPTURES, ids=lambda p: p.stem)
def test_packetparser_pcap_blocks_equal_the_reference(capture):
    rc, pc = both_cfgs(event_source="pcap", pcap_path=str(capture), pcap_loop=False,
                       synthetic_rate=0)
    rp, rb = run_parser(RParser, rc)
    pp, pb = run_parser(PParser, pc)
    assert len(pb) == len(rb) > 0
    for (r, rn), (p, pn) in zip(rb, pb):
        assert pn == rn == "packetparser"
        np.testing.assert_array_equal(p, r)
    assert pp.dns_names == rp.dns_names


@pytest.mark.parametrize("preset", ["default", "zipf", "uniform", "dns_flood"])
@pytest.mark.parametrize("pregen", [0, 3])
def test_packetparser_synthetic_blocks_equal_the_reference(preset, pregen):
    kw = dict(event_source="synthetic", synthetic_rate=1e9, synthetic_flows=2000,
              n_pods=1 << 8, gen_preset=preset, synthetic_pregen=pregen)
    _, rb = run_parser(RParser, RConfig(**kw), n_blocks=5)
    _, pb = run_parser(PParser, PConfig(**kw), n_blocks=5)
    assert len(rb) >= 5 and len(pb) >= 5
    for (r, _), (p, _) in zip(rb[:5], pb[:5]):
        assert p.shape == (BLOCK, NUM_FIELDS)
        np.testing.assert_array_equal(p, r)


def test_packetparser_regime_switch_equals_the_reference():
    kw = dict(event_source="synthetic", synthetic_flows=500, n_pods=1 << 6)
    r, p = RParser(RConfig(**kw)), PParser(PConfig(**kw))
    for x in (r, p):
        x.generate(); x.compile(); x.set_regime("zipf")
    np.testing.assert_array_equal(p._gen.batch(1024), r._gen.batch(1024))


def _frames(path: Path) -> list[bytes]:
    data = path.read_bytes()
    off, out = 24, []
    while off + 16 <= len(data):
        _, _, incl, _ = struct.unpack_from("<IIII", data, off)
        out.append(data[off + 16: off + 16 + incl])
        off += 16 + incl
    return out


class FakeSocket:
    """A raw socket that hands out ``frames`` in order, then times out,
    then fails (which ends the socket loop)."""

    def __init__(self, frames):
        self.frames, self.timed_out = list(frames), False

    def recv(self, n):
        if self.frames:
            return self.frames.pop(0)
        if not self.timed_out:
            self.timed_out = True
            raise socket.timeout()
        raise OSError("closed")

    def close(self):
        pass


@pytest.mark.parametrize("capture", CAPTURES, ids=lambda p: p.stem)
def test_packetparser_live_socket_loop_equals_the_reference(capture, monkeypatch):
    frames = _frames(capture)
    outs = []
    for cls, cfg in ((RParser, RConfig(event_source="live")),
                     (PParser, PConfig(event_source="live"))):
        p = cls(cfg)
        stop = threading.Event()
        sink = StopAfter(stop)
        p.set_sink(sink)
        # The reference's ring would take over where its native library has
        # one; the port's answers unavailable, so both run the socket loop.
        if cls is RParser:
            monkeypatch.setattr(p, "_run_live_native", lambda s: False)
        p._sock = FakeSocket(frames)
        p.start(stop)
        outs.append((sink.blocks, p.dns_names))
    (rb, rn), (pb, pn) = outs
    assert len(pb) == len(rb) > 0
    for (r, _), (p, _) in zip(rb, pb):
        keep = [i for i in range(NUM_FIELDS) if i not in (F.TS_LO, F.TS_HI)]  # stamped now
        np.testing.assert_array_equal(p[:, keep], r[:, keep])
    assert pn == rn


def test_packetparser_live_native_ring_is_unavailable():
    p = PParser(PConfig(event_source="live"))
    assert p._run_live_native(threading.Event()) is False


def test_packetparser_bad_config_raises_as_the_reference():
    for cls, cfg in ((RParser, RConfig(event_source="pcap")),
                     (PParser, PConfig(event_source="pcap")),
                     (RParser, RConfig(event_source="external")),
                     (PParser, PConfig(event_source="external"))):
        with pytest.raises(ValueError):
            cls(cfg).generate()


def test_packetparser_live_without_af_packet_is_unsupported(monkeypatch):
    def refuse(*a, **k):
        raise PermissionError("no CAP_NET_RAW")

    monkeypatch.setattr(socket, "socket", refuse)
    with pytest.raises(UnsupportedPlatform):
        PParser(PConfig(event_source="live")).init()


def _dns_records(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rec = TrafficGen(n_flows=500, n_pods=64, seed=seed).batch(4096)
    ev = rng.choice([0, EV_DNS_REQ, EV_DNS_RESP], size=len(rec)).astype(np.uint32)
    qtype = rng.choice([1, 5, 28, 12, 15, 16, 33, 99], size=len(rec)).astype(np.uint32)
    rcode = rng.choice([0, 2, 3, 5, 9], size=len(rec)).astype(np.uint32)
    rec[:, F.EVENT_TYPE] = ev
    rec[:, F.DNS] = (qtype << 16) | (rcode << 8) | (ev & 0xFF)
    return rec


def test_dns_plugin_equals_the_reference():
    r, p = RDns(RConfig()), PDns(PConfig())
    for x in (r, p):
        x.init()
    for seed in (1, 2):
        rec = _dns_records(seed)
        r.observe_records(rec)
        p.observe_records(rec)
    rm, pm = ref_metrics(), port_metrics()
    for q in ("A", "CNAME", "AAAA", "PTR", "MX", "TXT", "SRV", "99"):
        assert port_val(pm.dns_request_count, query_type=q) == ref_val(
            rm.dns_request_count, query_type=q) > 0
        for rc in ("NOERROR", "SERVFAIL", "NXDOMAIN", "REFUSED", "9"):
            assert port_val(pm.dns_response_count, query_type=q, return_code=rc) == ref_val(
                rm.dns_response_count, query_type=q, return_code=rc)
    names = {0xDEAD: "svc.cluster.local", 7: "a" * 90, 9: "x.example"}
    for x in (r, p):
        x._on_names(dict(names))
    for h in (0xDEAD, 7, 9, 1234):
        assert p.resolve(h) == r.resolve(h)
    np.testing.assert_array_equal(p.qname_length_hist(), r.qname_length_hist())
    for x in (r, p):
        x.stop()


def test_packetforward_publishes_the_reference_totals(monkeypatch):
    import psutil

    class IO:
        def __init__(self, *v):
            self.packets_recv, self.packets_sent, self.bytes_recv, self.bytes_sent = v

    seq = [IO(10, 5, 1000, 500), IO(14, 9, 1300, 900), IO(13, 12, 1350, 1000)]
    for cls, cfg in ((RForward, RConfig()), (PForward, PConfig())):
        it = iter(seq)
        monkeypatch.setattr(psutil, "net_io_counters", lambda pernic=False, _it=it: next(_it))
        p = cls(cfg)
        for _ in seq:
            p.read_and_publish()
    rm, pm = ref_metrics(), port_metrics()
    for d in ("ingress", "egress"):
        assert port_val(pm.forward_count, direction=d) == ref_val(rm.forward_count, direction=d)
        assert port_val(pm.forward_bytes, direction=d) == ref_val(rm.forward_bytes, direction=d)
    assert port_val(pm.forward_bytes, direction="egress") == 500


def test_dropreason_publishes_the_reference_deltas(tmp_path):
    net = tmp_path / "net"
    net.mkdir()

    def write(softnet, overflows, drops, rsts):
        (net / "softnet_stat").write_text(
            f"00000010 {softnet:08x} 00000000\n00000020 00000002 00000000\n")
        (net / "netstat").write_text(
            "TcpExt: ListenOverflows ListenDrops EmbryonicRsts\n"
            f"TcpExt: {overflows} {drops} {rsts}\n")

    write(1, 3, 4, 5)
    plugins = [RDrop(RConfig()), PDrop(PConfig())]
    for p in plugins:
        p.proc_root = str(tmp_path)
        p.init()
    write(7, 10, 4, 9)
    for p in plugins:
        p.read_and_publish()
    rm, pm = ref_metrics(), port_metrics()
    for reason in ("softnet_drop", "listen_overflow", "tcp_accept_basic"):
        assert port_val(pm.drop_count, reason=reason, direction="ingress") == ref_val(
            rm.drop_count, reason=reason, direction="ingress")
    assert port_val(pm.drop_count, reason="listen_overflow", direction="ingress") == 7
