"""The port's event sources against the reference's on the same inputs (CPU).

- The native decoder (``native/decoder.cpp``), the DNS name pass and
  ``decode_pcap_file``: bit for bit against the reference's
  ``decode_pcap_native`` and ``_decode_pcap_numpy`` on the three in-repo
  captures, synthesized nanosecond and microsecond captures made from a
  seed, and bytes that are not a pcap.
- ``NativeRing`` (``native/ring.cpp``): push and pop, drop accounting,
  wraparound, a bad capacity, another process, and a ring file the
  reference's ring reads.
- ``AfPacketRing`` (``native/afpacket.cpp``) on ``lo`` where the process may
  open an AF_PACKET socket (skipped elsewhere), and unavailable on an
  interface that does not exist.
- ``sources/procfs.py`` and the host-stat plugins (linuxutil, tcpretrans,
  infiniband) on fake ``/proc`` and ``/sys`` trees and the captured
  ``/proc/net`` fixtures: the reference's values.
- ``plugins/framing.py``: frames encoded by either package decode on the
  other, byte for byte; the externalevents round trip on both packages.
- The slice: an in-process agent on the CPU with the new plugins enabled,
  fed by the pcap source, an external producer and a Cilium monitor stream,
  whose engine equals its own synchronous replay and whose ``totals[0]`` is
  the rows the three sources delivered.

The reference's counters read ``._value.get()``, the port's ``._value``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import retina_tpu.plugins  # noqa: F401  (self-registration)
import retina_tpu_torch.plugins  # noqa: F401
from retina_tpu.config import Config as RConfig
from retina_tpu.metrics import get_metrics as ref_metrics
from retina_tpu.plugins import framing as rframing
from retina_tpu.plugins.api import QueueSink as RQueueSink
from retina_tpu.plugins.externalevents import ExternalEventsPlugin as RExternal
from retina_tpu.plugins.infiniband import InfinibandPlugin as RInfiniband
from retina_tpu.plugins.linuxutil import LinuxUtilPlugin as RLinuxUtil
from retina_tpu.plugins.tcpretrans import TcpRetransPlugin as RTcpRetrans
from retina_tpu.sources import pcapdecode as rdecode
from retina_tpu.sources import procfs as rprocfs
from retina_tpu_torch import exporter, metrics, native
from retina_tpu_torch.config import Config as PConfig
from retina_tpu_torch.daemon import Daemon
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.events.schema import (
    EV_DNS_REQ,
    EV_FORWARD,
    NUM_FIELDS,
    PROTO_TCP,
    PROTO_UDP,
    F,
    u32_to_ip,
)
from retina_tpu_torch.metrics import get_metrics as port_metrics
from retina_tpu_torch.plugins import framing, registry
from retina_tpu_torch.plugins.api import QueueSink
from retina_tpu_torch.plugins.externalevents import ExternalEventsPlugin as PExternal
from retina_tpu_torch.plugins.infiniband import InfinibandPlugin as PInfiniband
from retina_tpu_torch.plugins.linuxutil import LinuxUtilPlugin as PLinuxUtil
from retina_tpu_torch.plugins.tcpretrans import TcpRetransPlugin as PTcpRetrans
from retina_tpu_torch.sources import pcapdecode, procfs
from test_torch_cilium import IMPLS, _drop_data, _payload_encoder, _trace_data, _udp_frame, serve_monitor
from test_torch_daemon import config, get, register, running, wait_for
from test_torch_wire import reference_native  # noqa: F401 (a fixture)

REAL = Path(__file__).parent / "fixtures" / "real"
CAPTURES = sorted(REAL.glob("*.pcap"))
DECODE_WAIT_S = 10.0  # bound on each wait for a socket's rows


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


def ref_val(metric, **labels):
    return metric.labels(**labels)._value.get()


def port_val(metric, **labels):
    return metric.labels(**labels)._value


def seeded_pcap(seed: int, n: int, ns: bool) -> bytes:
    """A capture of ``n`` packets from a seed: TCP with and without the
    timestamp option and every flag, UDP, and DNS queries and responses of
    several qtypes and rcodes."""
    rng = np.random.default_rng(seed)
    pkts = []
    for i in range(n):
        p = dict(src_ip=int(rng.integers(1, 1 << 32)), dst_ip=int(rng.integers(1, 1 << 32)),
                 sport=int(rng.integers(1, 1 << 16)), dport=int(rng.choice([80, 443, 53, 8080])),
                 proto=PROTO_TCP if rng.random() < 0.6 else PROTO_UDP,
                 ts_ns=1_700_000_000_000_000_000 + i * int(rng.integers(1, 100_000)),
                 tcp_flags=int(rng.choice([0x10, 0x02, 0x12, 0x11, 0x04, 0x18])))
        if rng.random() < 0.3:
            p["tsval"], p["tsecr"] = int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32))
        if rng.random() < 0.2:
            p.update(proto=PROTO_UDP, dport=53,
                     dns_qname=f"svc-{int(rng.integers(0, 40))}.ns{i % 3}.cluster.local",
                     dns_qtype=int(rng.choice([1, 28, 5, 33])),
                     dns_response=bool(rng.random() < 0.5), dns_rcode=int(rng.integers(0, 6)))
        pkts.append(p)
    return pcapdecode.synthesize_pcap(pkts, ns=ns)


def _inputs() -> dict[str, bytes]:
    out = {p.stem: p.read_bytes() for p in CAPTURES}
    for ns in (True, False):
        out[f"seed_{'ns' if ns else 'us'}"] = seeded_pcap(22 + ns, 3000, ns)
    return out


INPUTS = _inputs()


# -- the decoder -----------------------------------------------------------------


def test_chip_smokes_capture_equals_synthesize_pcap_in_both_formats():
    """``chip_smoke.py``'s big capture: its specs on TrafficGen's flow keys
    decode to every packet, and its microsecond conversion is the bytes
    ``synthesize_pcap(..., ns=False)`` writes for the same packets."""
    specs = chip_smoke.capture_specs(3000)
    ns = pcapdecode.synthesize_pcap(specs)
    assert chip_smoke.pcap_to_microseconds(ns) == pcapdecode.synthesize_pcap(specs, ns=False)
    res = pcapdecode.decode_pcap_bytes(ns)
    assert res.n_decoded == res.n_packets_total == 3000
    assert set(res.dns_names.values()) == set(chip_smoke.SRC_QNAMES)
    with pytest.raises(ValueError):
        chip_smoke.pcap_to_microseconds(pcapdecode.synthesize_pcap(specs, ns=False))


def test_synthesized_captures_are_the_reference_bytes():
    rng = np.random.default_rng(7)
    pkts = [dict(src_ip=int(rng.integers(1, 1 << 32)), dst_ip=5, tsval=9, tsecr=3,
                 ts_ns=i * 1000, dns_qname="a.b" if i % 2 else "") for i in range(50)]
    for ns in (True, False):
        assert pcapdecode.synthesize_pcap(pkts, ns=ns) == rdecode.synthesize_pcap(pkts, ns=ns)


@pytest.mark.usefixtures("reference_native")
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_native_decode_equals_the_references_native_and_numpy(name):
    import retina_tpu.native as jnative

    data = INPUTS[name]
    got, total = native.decode_pcap_native(data)
    ref_native, ref_total = jnative.decode_pcap_native(data)
    ref_numpy = rdecode._decode_pcap_numpy(data)
    port_numpy = pcapdecode._decode_pcap_numpy(data)
    assert got.shape[1] == NUM_FIELDS and len(got) > 0
    for want in (ref_native, ref_numpy.records, port_numpy.records):
        np.testing.assert_array_equal(got, want)
    assert total == ref_total == ref_numpy.n_packets_total == port_numpy.n_packets_total


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decode_pcap_bytes_and_file_equal_the_reference(name, tmp_path):
    data = INPUTS[name]
    path = tmp_path / "capture.pcap"
    path.write_bytes(data)
    want = rdecode._decode_pcap_numpy(data)
    for got in (pcapdecode.decode_pcap_bytes(data),
                pcapdecode.decode_pcap_bytes(data, prefer_native=False),
                pcapdecode.decode_pcap_file(str(path))):
        np.testing.assert_array_equal(got.records, want.records)
        assert got.dns_names == want.dns_names
        assert (got.n_packets_total, got.n_decoded) == (want.n_packets_total, want.n_decoded)
    assert pcapdecode._dns_name_pass(data) == rdecode._dns_name_pass(data)
    assert pcapdecode.decode_pcap_bytes(data, parse_dns=False).dns_names == {}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_dns_names_from_frames_equal_the_reference(name):
    """The [u16 caplen][frame] blob that the AF_PACKET ring's DNS sidecar
    carries, built from the capture's frames."""
    data = INPUTS[name]
    ns = data[:4] == b"\x4d\x3c\xb2\xa1"
    _, offs, caps = pcapdecode._find_offsets(data, ns, False)
    blob = b"".join(int(c).to_bytes(2, "little") + data[int(o): int(o) + int(c)]
                    for o, c in zip(offs, caps))
    got = pcapdecode.dns_names_from_frames(blob)
    assert got == rdecode.dns_names_from_frames(blob)
    assert got == rdecode._dns_name_pass(data)
    # A blob cut inside a frame keeps the frames before the cut.
    assert pcapdecode.dns_names_from_frames(blob[:-3]) == rdecode.dns_names_from_frames(blob[:-3])


@pytest.mark.usefixtures("reference_native")
@pytest.mark.parametrize("garbage", [b"\x00" * 128, b"GIF89a" + bytes(range(200)), b"\xa1\xb2"],
                         ids=["zeros", "gif", "short"])
def test_native_decode_of_garbage_raises_or_is_empty_as_the_reference(garbage):
    import retina_tpu.native as jnative

    if len(garbage) < 24:  # shorter than a pcap header: nothing decoded, on both
        assert native.decode_pcap_native(garbage)[1] == jnative.decode_pcap_native(garbage)[1] == 0
        return
    for fn in (native.decode_pcap_native, jnative.decode_pcap_native):
        with pytest.raises(ValueError, match="not a pcap"):
            fn(garbage)
    with pytest.raises(ValueError):
        pcapdecode.decode_pcap_bytes(garbage)


@pytest.mark.usefixtures("reference_native")
def test_native_decode_of_a_truncated_capture_equals_the_reference():
    import retina_tpu.native as jnative

    data = INPUTS["seed_ns"]
    for cut in (25, 24 + 16 + 10, len(data) // 2, len(data) - 1):
        got, total = native.decode_pcap_native(data[:cut])
        want, want_total = jnative.decode_pcap_native(data[:cut])
        np.testing.assert_array_equal(got, want)
        assert total == want_total


def test_native_decode_grows_its_buffer_past_the_first_guess(monkeypatch):
    """Minimum-size frames outnumber the first buffer's guess (a record per
    70 bytes): the binding doubles the buffer until every record fits."""
    pkts = [dict(src_ip=i + 1, dst_ip=2, proto=PROTO_UDP, ts_ns=i) for i in range(4000)]
    data = pcapdecode.synthesize_pcap(pkts)
    calls = []
    lib = native.get_lib()
    decode = lib.rt_decode_pcap

    class Counting:
        def __call__(self, *args):
            calls.append(args[4])
            return decode(*args)

    monkeypatch.setattr(lib, "rt_decode_pcap", Counting())
    got, total = native.decode_pcap_native(data)
    assert len(calls) >= 2 and calls[1] == 2 * calls[0]
    assert total == len(got) == 4000
    np.testing.assert_array_equal(got, rdecode._decode_pcap_numpy(data).records)


def test_native_library_builds_every_source_once_with_one_abi():
    assert native.SOURCES == ("decoder.cpp", "ring.cpp", "combine.cpp", "afpacket.cpp",
                              "flowdict.cpp", "pack.cpp")
    assert not (native.SRC_DIR / "abi.cpp").exists()
    defs = [name for name in native.SOURCES
            if "uint32_t rt_abi_version(void) {" in (native.SRC_DIR / name).read_text()]
    assert defs == ["decoder.cpp"]
    assert native.native_abi_version() == native.NATIVE_ABI_VERSION


# -- the shared-memory ring --------------------------------------------------------


def test_ring_push_pop_and_drop_accounting():
    r = native.NativeRing(capacity=8)
    rec = np.arange(5 * NUM_FIELDS, dtype=np.uint32).reshape(5, NUM_FIELDS)
    assert r.push(rec) == 5 and len(r) == 5
    assert r.push(rec) == 3  # 3 free slots
    assert r.dropped == 2
    out = r.pop(100)
    assert len(out) == 8
    np.testing.assert_array_equal(out[:5], rec)
    np.testing.assert_array_equal(out[5:], rec[:3])
    assert len(r) == 0
    with pytest.raises(ValueError):
        r.push(np.zeros((2, 3), np.uint32))
    r.close()


def test_ring_wraparound():
    r = native.NativeRing(capacity=4)
    for i in range(10):
        rec = np.full((3, NUM_FIELDS), i, np.uint32)
        assert r.push(rec) == 3
        np.testing.assert_array_equal(r.pop(10), rec)
    assert r.dropped == 0
    r.close()


@pytest.mark.parametrize("capacity", [100, 0, 3])
def test_ring_bad_capacity(capacity):
    with pytest.raises(ValueError, match="power of two"):
        native.NativeRing(capacity=capacity)


def test_ring_attach_refuses_a_file_that_is_not_a_ring(tmp_path):
    path = tmp_path / "not-a-ring"
    path.write_bytes(b"\x00" * 4096)
    with pytest.raises(ValueError, match="not a retina ring"):
        native.NativeRing(capacity=8, path=str(path), create=False)


PRODUCER = """
import sys
import numpy as np
from retina_tpu_torch.native import NativeRing
ring = NativeRing(capacity=1 << 12, path=sys.argv[1], create=False)
for i in range(int(sys.argv[2])):
    rec = np.full((64, 16), i, np.uint32)
    while ring.push(rec) < 64:
        pass  # the test's producer retries; the agent's never would
ring.close()
"""


def test_ring_cross_process(tmp_path):
    path = str(tmp_path / "ring.shm")
    ring = native.NativeRing(capacity=1 << 12, path=path, create=True)
    proc = subprocess.Popen([sys.executable, "-c", PRODUCER, path, "50"],
                            cwd=Path(__file__).resolve().parents[1])
    got = []
    deadline = time.monotonic() + 60
    try:
        while sum(map(len, got)) < 50 * 64 and time.monotonic() < deadline:
            out = ring.pop(1024)
            got.append(out)
            if not len(out):
                time.sleep(0.002)
    finally:
        assert proc.wait(timeout=60) == 0
    rec = np.concatenate(got)
    assert len(rec) == 50 * 64 and ring.dropped == 0
    np.testing.assert_array_equal(rec[:, 0], np.repeat(np.arange(50, dtype=np.uint32), 64))
    ring.close()


@pytest.mark.usefixtures("reference_native")
def test_ring_files_cross_between_the_packages(tmp_path):
    """The ring's layout is the reference's: a ring file either package
    creates, the other attaches to and reads, drops counted in the file."""
    import retina_tpu.native as jnative

    rng = np.random.default_rng(3)
    for make, attach in ((native.NativeRing, jnative.NativeRing),
                         (jnative.NativeRing, native.NativeRing)):
        path = str(tmp_path / f"ring-{make.__module__}.shm")
        a = make(capacity=64, path=path, create=True)
        b = attach(capacity=64, path=path, create=False)
        rec = rng.integers(0, 1 << 32, (80, NUM_FIELDS), dtype=np.uint64).astype(np.uint32)
        assert a.push(rec) == 64
        assert b.dropped == 16 and len(b) == 64
        np.testing.assert_array_equal(b.pop(100), rec[:64])
        assert len(a) == 0
        a.close()
        b.close()


# -- the AF_PACKET ring ------------------------------------------------------------


def _can_af_packet() -> bool:
    if not hasattr(socket, "AF_PACKET"):
        return False
    try:
        socket.socket(socket.AF_PACKET, socket.SOCK_RAW, socket.htons(3)).close()
        return True
    except OSError:
        return False


@pytest.fixture
def lo_ring():
    if not _can_af_packet():
        pytest.skip("needs AF_PACKET and CAP_NET_RAW (Linux)")
    ring = native.AfPacketRing(iface="lo")
    yield ring
    ring.close()


def _udp_pair():
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    tx.connect(("127.0.0.1", rx.getsockname()[1]))
    return tx, rx, rx.getsockname()[1]


def _poll_until(ring, port: int, want: int, bound: float = DECODE_WAIT_S) -> np.ndarray:
    got, deadline = [], time.monotonic() + bound
    while time.monotonic() < deadline and sum(map(len, got)) < want:
        rec, _seen, _dns = ring.poll(100)
        got.append(rec[(rec[:, F.PORTS] & 0xFFFF) == port])
    return np.concatenate(got)


def test_afpacket_ring_captures_loopback(lo_ring):
    """Real UDP over ``lo`` arrives as decoded records, both directions."""
    tx, rx, port = _udp_pair()
    with tx, rx:
        for _ in range(500):
            tx.send(b"ring-test-payload")
        ours = _poll_until(lo_ring, port, 1000)
    assert len(ours) >= 500
    assert (ours[:, F.SRC_IP] == 0x7F000001).all()
    assert ((ours[:, F.META] >> 24) == PROTO_UDP).all()
    assert (ours[:, F.EVENT_TYPE] == EV_FORWARD).all()
    assert (ours[:, F.BYTES] > 0).all()
    assert lo_ring.drops() >= 0


def test_afpacket_ring_resume_does_not_duplicate(lo_ring):
    """A poll buffer smaller than the burst resumes mid-block on the next
    poll without repeating a frame: tx and rx over ``lo``, 2n frames."""
    lo_ring.POLL_RECORDS = 64
    lo_ring._buf = np.empty((64, NUM_FIELDS), np.uint32)
    n = 400
    tx, rx, port = _udp_pair()
    with tx, rx:
        for i in range(n):
            tx.send(b"seq-%06d" % i)
        ours = _poll_until(lo_ring, port, 2 * n)
        time.sleep(0.2)
        rest = _poll_until(lo_ring, port, 1, bound=0.3)
    assert len(ours) + len(rest) == 2 * n


def test_afpacket_ring_dns_sidecar_names(lo_ring):
    """The ring's DNS sidecar carries the DNS frames, and the host's name
    pass resolves their qnames."""
    q = (b"\x12\x34\x01\x00\x00\x01\x00\x00\x00\x00\x00\x00"
         b"\x07example\x03com\x00\x00\x01\x00\x01")
    names, recs = {}, []
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for _ in range(5):
            try:
                tx.sendto(q, ("127.0.0.1", 53))
            except OSError:
                pass  # the ICMP port-unreachable of an earlier send
            time.sleep(0.02)
        deadline = time.monotonic() + DECODE_WAIT_S
        while time.monotonic() < deadline and not names:
            rec, _seen, dns = lo_ring.poll(100)
            recs.append(rec)
            names.update(pcapdecode.dns_names_from_frames(dns))
    rec = np.concatenate(recs)
    h = pcapdecode.dns_qname_hash(b"example.com")
    assert names.get(h) == "example.com"
    dnsr = rec[rec[:, F.EVENT_TYPE] == EV_DNS_REQ]
    assert len(dnsr) >= 1 and (dnsr[:, F.DNS_QHASH] == np.uint32(h)).any()


def test_afpacket_ring_unavailable_without_the_interface():
    with pytest.raises(RuntimeError, match="AF_PACKET"):
        native.AfPacketRing(iface="definitely-not-a-real-iface-9x")


def test_packetparser_live_runs_the_ring_and_counts_kernel_drops(lo_ring, monkeypatch):
    """packetparser's live source on ``lo`` through the ring: the rows reach
    the sink, and the ring's kernel drops are counted as "kernel" losses."""
    lo_ring.close()
    from retina_tpu_torch.plugins.packetparser import PacketParserPlugin

    p = PacketParserPlugin(PConfig(event_source="live", capture_iface="lo"))
    sink = QueueSink(max_blocks=1 << 12)
    p.set_sink(sink)
    # The kernel's drop counter reads 12 from the first poll on: 12 losses.
    monkeypatch.setattr(native.AfPacketRing, "drops", lambda self: 12)
    stop = threading.Event()
    t = threading.Thread(target=p.start, args=(stop,), daemon=True)
    t.start()
    tx, rx, port = _udp_pair()
    got = []
    try:
        time.sleep(0.3)
        with tx, rx:
            for _ in range(100):
                tx.send(b"parser-ring")
            deadline = time.monotonic() + DECODE_WAIT_S
            while time.monotonic() < deadline and sum(map(len, got)) < 100:
                got += [r[(r[:, F.PORTS] & 0xFFFF) == port] for r, _ in sink.drain(64)]
                time.sleep(0.02)
    finally:
        stop.set()
        t.join(10)
    assert not t.is_alive()
    assert sum(map(len, got)) >= 100
    assert port_val(port_metrics().lost_events, stage="kernel", plugin="packetparser") == 12


# -- procfs and the host-stat plugins ------------------------------------------------


@pytest.fixture
def fake_proc(tmp_path):
    net = tmp_path / "proc" / "net"
    net.mkdir(parents=True)
    (net / "snmp").write_text(
        "Ip: InReceives OutRequests InDiscards\n"
        "Ip: 1000 900 5\n"
        "Tcp: ActiveOpens CurrEstab RetransSegs InSegs\n"
        "Tcp: 10 3 7 5000\n"
        "Udp: InDatagrams OutDatagrams InErrors\n"
        "Udp: 200 180 1\n")
    (net / "netstat").write_text("TcpExt: ListenOverflows ListenDrops EmbryonicRsts\n"
                                 "TcpExt: 2 3 1\n")
    (net / "softnet_stat").write_text("0000aaaa 00000005 00000000\n0000bbbb 00000003 00000000\n")
    return tmp_path / "proc"


@pytest.fixture
def fake_sys(tmp_path):
    """Two NICs (one idle, which linuxutil skips for good), an InfiniBand
    device with two ports, and debug status params, numeric and not."""
    base = tmp_path / "sys" / "class"
    for iface, vals in (("eth9", (12345, 6789, 100, 90)), ("veth0", (0, 0, 0, 0))):
        stats = base / "net" / iface / "statistics"
        stats.mkdir(parents=True)
        for name, v in zip(("rx_bytes", "tx_bytes", "rx_packets", "tx_packets"), vals):
            (stats / name).write_text(f"{v}\n")
        (stats / "rx_errors").write_text("not-a-number\n")
    dbg = base / "net" / "ib0" / "debug"
    dbg.mkdir(parents=True)
    (dbg / "lro_sessions").write_text("17\n")
    (dbg / "mode").write_text("datagram\n")
    for dev, port, counters in (("mlx5_0", "1", {"port_rcv_data": 91, "port_xmit_data": 19}),
                                ("mlx5_0", "2", {"symbol_error": 2}),
                                ("mlx5_1", "1", {"port_rcv_packets": 1 << 40})):
        cdir = base / "infiniband" / dev / "ports" / port / "counters"
        cdir.mkdir(parents=True)
        for name, v in counters.items():
            (cdir / name).write_text(f"{v}\n")
    return tmp_path / "sys"


def test_procfs_readers_equal_the_reference(fake_proc, fake_sys, tmp_path):
    for fn in ("read_iface_stats", "read_infiniband_counters", "read_infiniband_status_params"):
        got, want = getattr(procfs, fn)(str(fake_sys)), getattr(rprocfs, fn)(str(fake_sys))
        assert got == want and got, fn
        assert getattr(procfs, fn)(str(tmp_path / "absent")) == {}
    for fn in ("read_snmp", "read_netstat", "read_softnet_drops"):
        assert getattr(procfs, fn)(str(fake_proc)) == getattr(rprocfs, fn)(str(fake_proc))
    assert procfs.read_infiniband_counters(str(fake_sys))[("mlx5_1", "1")] == {
        "port_rcv_packets": 1 << 40}


@pytest.mark.parametrize("name", ["netstat-upstream-correct", "netstat-upstream-wrong",
                                  "proc_net_netstat_captured", "proc_net_snmp_captured"])
def test_procfs_parses_the_captured_files_as_the_reference(name):
    got = procfs.parse_kv_pairs_file(str(REAL / name))
    assert got == rprocfs.parse_kv_pairs_file(str(REAL / name))
    assert bool(got) == (name != "netstat-upstream-wrong")


def _captured_proc(tmp_path, netstat: str, snmp: str) -> Path:
    net = tmp_path / "captured" / "net"
    net.mkdir(parents=True)
    (net / "netstat").write_bytes((REAL / netstat).read_bytes())
    (net / "snmp").write_bytes((REAL / snmp).read_bytes())
    return tmp_path / "captured"


def children(gauge) -> list[tuple]:
    """The label tuples a gauge holds (prometheus_client's ``_metrics``, the
    port exporter's ``_children``)."""
    return list(getattr(gauge, "_metrics", None) or gauge._children)


def _linuxutil_series(m, val) -> dict:
    out = {}
    for gauge, labels in ((m.tcp_connection_stats, ("statistic_name",)),
                          (m.udp_connection_stats, ("statistic_name",)),
                          (m.ip_connection_stats, ("statistic_name",)),
                          (m.interface_stats, ("interface_name", "statistic_name"))):
        for key in children(gauge):
            out[(gauge._name, key)] = val(gauge, **dict(zip(labels, key)))
    return out


@pytest.mark.parametrize("proc", ["fake", "captured", "upstream"])
def test_linuxutil_publishes_the_reference_values(proc, fake_proc, fake_sys, tmp_path):
    netstat = {"captured": "proc_net_netstat_captured", "upstream": "netstat-upstream-correct"}
    root = (fake_proc if proc == "fake"
            else _captured_proc(tmp_path, netstat[proc], "proc_net_snmp_captured"))
    r, p = RLinuxUtil(RConfig()), PLinuxUtil(PConfig())
    for x in (r, p):
        x.proc_root, x.sys_root = str(root), str(fake_sys)
        x.read_and_publish()
        x.read_and_publish()
    got = _linuxutil_series(port_metrics(), port_val)
    assert got == _linuxutil_series(ref_metrics(), ref_val) and got
    assert p._unsupported == r._unsupported == {"veth0"}  # ib0 has no statistics
    assert port_val(port_metrics().interface_stats, interface_name="eth9",
                    statistic_name="rx_bytes") == 12345


def test_tcpretrans_publishes_the_reference_deltas(fake_proc):
    r, p = RTcpRetrans(RConfig()), PTcpRetrans(PConfig())
    snmp = fake_proc / "net" / "snmp"
    for x in (r, p):
        x.proc_root = str(fake_proc)
    # Before init the plugin takes the first read as its base.
    for x in (r, p):
        x.read_and_publish()
    assert port_val(port_metrics().tcp_connection_stats, statistic_name="RetransSegs") == 0
    for x in (r, p):
        x.init()
    snmp.write_text(snmp.read_text().replace("Tcp: 10 3 7 5000", "Tcp: 10 3 19 5000"))
    for x in (r, p):
        x.read_and_publish()
    got = port_val(port_metrics().tcp_connection_stats, statistic_name="RetransSegs")
    assert got == ref_val(ref_metrics().tcp_connection_stats, statistic_name="RetransSegs") == 12
    snmp.write_text(snmp.read_text().replace("Tcp: 10 3 19 5000", "Tcp: 10 3 2 5000"))
    for x in (r, p):
        x.read_and_publish()  # a counter reset reads as 0, not negative
    assert port_val(port_metrics().tcp_connection_stats, statistic_name="RetransSegs") == 0


def _ib_series(m, val) -> dict:
    out = {}
    for gauge, labels in ((m.infiniband_counter_stats, ("device", "port", "statistic_name")),
                          (m.infiniband_status_params, ("interface", "statistic_name"))):
        for key in children(gauge):
            out[(gauge._name, key)] = val(gauge, **dict(zip(labels, key)))
    return out


def test_infiniband_publishes_the_reference_values(fake_sys, tmp_path):
    r, p = RInfiniband(RConfig()), PInfiniband(PConfig())
    for x in (r, p):
        x.sys_root = str(fake_sys)
        x.read_and_publish()
    got = _ib_series(port_metrics(), port_val)
    assert got == _ib_series(ref_metrics(), ref_val)
    # 4 counters and 2 status params: "mode" is not a number, and its series
    # stays at 0, as the reference's does (the label is made before the parse).
    assert len(got) == 6
    p.sys_root = str(tmp_path / "no-infiniband")
    p.read_and_publish()  # no hardware: nothing new, no error


@pytest.mark.parametrize("cls", [PLinuxUtil, PTcpRetrans, PInfiniband],
                         ids=lambda c: c.name)
def test_host_stat_plugins_poll_until_stopped(cls, fake_proc, fake_sys):
    p = cls(PConfig(metrics_interval_s=0.01))
    p.proc_root, p.sys_root = str(fake_proc), str(fake_sys)
    p.init()
    calls = []
    read = p.read_and_publish
    p.read_and_publish = lambda: (calls.append(1), read())
    stop = threading.Event()
    t = threading.Thread(target=p.start, args=(stop,), daemon=True)
    t.start()
    wait_for(lambda: len(calls) >= 3, 10, "three reads")
    stop.set()
    t.join(5)
    assert not t.is_alive()


def test_the_new_plugins_are_registered_and_not_default():
    new = {"linuxutil", "tcpretrans", "infiniband", "externalevents", "ciliumeventobserver"}
    assert new <= set(registry.names())
    assert not new & set(PConfig().enabled_plugins)
    assert PConfig().external_socket == RConfig().external_socket == "/tmp/retina-events.sock"
    assert PConfig().monitor_sock_path == RConfig().monitor_sock_path


# -- framing and externalevents ------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 37, 4096])
def test_frames_cross_decode_between_the_packages(n):
    rng = np.random.default_rng(n)
    rec = rng.integers(0, 1 << 32, (n, NUM_FIELDS), dtype=np.uint64).astype(np.uint32)
    names = {int(rng.integers(0, 1 << 32)): f"q{i}.example" for i in range(n % 5)}
    frame = framing.encode_record_frame(rec, names)

    class Capture:
        data = b""

        def sendall(self, b):
            self.data += b

    ref = Capture()
    rframing.send_frame(ref, rec, names)
    assert frame == ref.data
    for decode in (framing.decode_record_frame, rframing.decode_record_frame):
        for payload in (frame[4:], ref.data[4:]):
            got, got_names = decode(payload)
            np.testing.assert_array_equal(got, rec)
            assert got_names == names


def test_read_frames_splits_a_stream_and_drops_an_oversized_frame():
    a, b = socket.socketpair()
    rec = np.arange(3 * NUM_FIELDS, dtype=np.uint32).reshape(3, NUM_FIELDS)
    got, logs = [], []

    class Log:
        def error(self, *args):
            logs.append(args)

    stream = framing.encode_record_frame(rec) * 3
    with a, b:
        for i in range(0, len(stream), 11):
            a.sendall(stream[i: i + 11])
        a.sendall((framing.MAX_FRAME + 1).to_bytes(4, "little"))
        b.settimeout(1.0)
        framing.read_frames(b, threading.Event(), got.append, Log())
    assert len(got) == 3 and logs
    for frame in got:
        np.testing.assert_array_equal(framing.decode_record_frame(frame)[0], rec)


def _run_external(cls, cfg, frames: list[bytes], want: int, sink) -> list[np.ndarray]:
    p = cls(cfg)
    p.set_sink(sink)
    p.init()
    stop = threading.Event()
    t = threading.Thread(target=p.start, args=(stop,), daemon=True)
    t.start()
    got = []
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(cfg.external_socket)
            for f in frames:
                c.sendall(f)
        deadline = time.monotonic() + DECODE_WAIT_S
        while time.monotonic() < deadline and sum(len(r) for r in got) < want:
            got += [r for r, _name in sink.drain(16)]
            time.sleep(0.01)
    finally:
        stop.set()
        t.join(5)
        p.stop()
    assert not t.is_alive() and not os.path.exists(cfg.external_socket)
    return got


def test_externalevents_round_trip_equals_the_reference(tmp_path):
    rng = np.random.default_rng(11)
    blocks = [rng.integers(0, 1 << 32, (k, NUM_FIELDS), dtype=np.uint64).astype(np.uint32)
              for k in (2, 500, 1)]
    frames = [framing.encode_record_frame(b, {i + 1: f"x{i}.example.com"})
              for i, b in enumerate(blocks)]
    frames.insert(1, (5).to_bytes(4, "little") + b"\xc1junk")  # a bad frame: counted, skipped
    outs = []
    for cls, cfg_cls, sink in ((RExternal, RConfig, RQueueSink()), (PExternal, PConfig, QueueSink())):
        cfg = cfg_cls()
        # Unix socket paths are short (108 bytes): under xdist tmp_path is long.
        cfg.external_socket = str(tmp_path / ("r.sock" if cls is RExternal else "p.sock"))
        outs.append(_run_external(cls, cfg, frames, 503, sink))
    ref_blocks, port_blocks = outs
    assert len(port_blocks) == len(ref_blocks) == 3
    for x, y, want in zip(port_blocks, ref_blocks, blocks):
        np.testing.assert_array_equal(x, want)
        np.testing.assert_array_equal(y, want)
    assert port_val(port_metrics().lost_events, stage="decode", plugin="externalevents") == 1
    assert ref_val(ref_metrics().lost_events, stage="decode", plugin="externalevents") == 1


# -- the slice: an agent on the CPU with the new sources --------------------------------


def test_agent_with_the_new_sources_equals_its_synchronous_replay(tmp_path):
    """packetparser replays a capture once, a producer writes a second
    capture's records to ``external_socket`` as frames, a fake Cilium agent
    serves drop and trace notifications at ``monitor_sock_path``, and
    linuxutil, tcpretrans and infiniband poll the host: the engine equals
    its own synchronous replay, totals[0] is the packets the three sources
    delivered, and /metrics carries the host-stat series."""
    capture = REAL / "loopback_mixed_real.pcap"
    ext_rec = pcapdecode.decode_pcap_file(str(REAL / "loopback_real.pcap")).records
    cfg = config(enabled_plugins=["packetparser", "linuxutil", "tcpretrans", "infiniband",
                                  "externalevents", "ciliumeventobserver"],
                 event_source="pcap", pcap_path=str(capture), pcap_loop=False,
                 synthetic_rate=0, overload_enabled=False,
                 external_socket=str(tmp_path / "e.sock"),
                 monitor_sock_path=str(tmp_path / "m.sock"))
    port_mon = IMPLS["port"]
    payloads = [{"Data": _drop_data(port_mon, _udp_frame(src=f"10.9.0.{i + 1}"), 133),
                 "Type": port_mon.mon.PAYLOAD_EVENT_SAMPLE} for i in range(6)]
    payloads += [{"Data": _trace_data(port_mon, _udp_frame(src=f"10.9.1.{i + 1}")),
                  "Type": port_mon.mon.PAYLOAD_EVENT_SAMPLE} for i in range(4)]
    server, served = serve_monitor(cfg.monitor_sock_path, b"".join(
        _payload_encoder(port_mon.gob).encode(p) for p in payloads), chunk=64)
    d = Daemon(cfg, apiserver_host="127.0.0.1")
    ips = {u32_to_ip(int(ip)) for ip in np.concatenate([
        pcapdecode.decode_pcap_file(str(capture)).records[:, [F.SRC_IP, F.DST_IP]].ravel(),
        ext_rec[:, [F.SRC_IP, F.DST_IP]].ravel()])}
    ips |= {f"10.9.0.{i + 1}" for i in range(6)} | {f"10.9.1.{i + 1}" for i in range(4)}
    ips |= {"10.1.0.9"}
    register(d, sorted(ips))
    log, published, summaries = [], [], []
    chip_smoke.instrument(d.cm.engine, log, published, summaries)
    want = len(pcapdecode.decode_pcap_file(str(capture)).records) + len(ext_rec) + 10
    try:
        with running(d) as port:
            eng = d.cm.engine
            wait_for(lambda: os.path.exists(cfg.external_socket), 30, "the external socket")
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                c.connect(cfg.external_socket)
                framing.send_frame(c, ext_rec)
            wait_for(lambda: eng.counts.events >= want, 60, "every source's rows")
            text = ""

            def host_stats() -> bool:
                nonlocal text
                text = get(port, "/metrics")[1]
                return "networkobservability_tcp_connection_stats{" in text

            wait_for(host_stats, 30, "the host-stat series")
    finally:
        server.close()
        served.join(5)
    assert eng.counts.events == want
    for name in ("tcp_connection_stats", "udp_connection_stats", "ip_connection_stats"):
        assert f"networkobservability_{name}{{" in text, name
    assert not eng.errors and not eng.lost_events
    ref = SketchEngine(cfg, device="cpu")
    ref.update_identities(d.cm.cache.ip_index_map())
    ref.update_filter_ips(set(d.cm.filtermanager._refs))
    ref.set_apiserver_ips([0x7F000001])
    for entry in log:
        if entry[0] == "step":
            ref._dispatch_sharded(*entry[1:])
        else:
            ref._close_window()
    ref._harvest_window(timeout=60)
    for (leaf, x), (_, y) in zip(chip_smoke.named_leaves(eng.state),
                                 chip_smoke.named_leaves(ref.state)):
        if x.dtype.is_floating_point:
            torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6, msg=leaf)
        else:
            assert torch.equal(x, y), leaf
    totals = eng.snapshot(max_age_s=0)["totals"]
    assert int(np.asarray(totals)[0]) == want

