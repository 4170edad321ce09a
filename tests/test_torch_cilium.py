"""The port's gob codec and Cilium monitor source against the reference's
(``sources/gobcodec.py``, ``sources/cilium_monitor.py``,
``plugins/ciliumeventobserver.py``).

Every case of the reference's ``tests/test_gobcodec.py`` is one parameter of
``test_gob_and_monitor_case``: the case runs its checks on both packages,
and the values it returns (decoded gob values, encoded bytes, parsed events,
records) must be equal across the two. The plugin test serves one gob
stream of drop and trace notifications on a Unix socket to both packages'
plugins and holds their records equal.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import types

import numpy as np
import pytest

import retina_tpu.events.schema as jschema
import retina_tpu.sources.cilium_monitor as jmon
import retina_tpu.sources.gobcodec as jgob
from retina_tpu.config import Config as JConfig
from retina_tpu.plugins.api import QueueSink as JQueueSink
from retina_tpu.plugins.ciliumeventobserver import CiliumEventObserverPlugin as JPlugin
from retina_tpu_torch.config import Config
from retina_tpu_torch.events import schema
from retina_tpu_torch.plugins.api import QueueSink
from retina_tpu_torch.plugins.ciliumeventobserver import CiliumEventObserverPlugin
from retina_tpu_torch.sources import cilium_monitor as mon
from retina_tpu_torch.sources import gobcodec as gob

IMPLS = {
    "reference": types.SimpleNamespace(gob=jgob, mon=jmon, schema=jschema, Config=JConfig,
                                       Plugin=JPlugin, QueueSink=JQueueSink),
    "port": types.SimpleNamespace(gob=gob, mon=mon, schema=schema, Config=Config,
                                  Plugin=CiliumEventObserverPlugin, QueueSink=QueueSink),
}
NOW_NS = 1_700_000_000_123_456_789  # stamped on every record, so both sides agree

# The gob documentation's worked example: type Point struct { X, Y int }
# with value Point{22, 33} encodes to exactly these two messages.
_GOB_DOC_POINT = bytes.fromhex(
    "1fff810301010550"  # len 31, def type 65, StructT, CommonType{
    "6f696e7401ff8200"  # "Point", Id 65 }
    "0102010158010400"  # Field [ {X, int}
    "0101590104000000"  #         {Y, int} ] end end
    "07ff82012c014200"  # len 7, type 65, X=22, Y=33
)


def _payload_encoder(g):
    """payload.Payload{Data []byte, CPU int, Lost uint64, Type int}."""
    return g.GobStructEncoder("Payload", [("Data", g.T_BYTES), ("CPU", g.T_INT),
                                          ("Lost", g.T_UINT), ("Type", g.T_INT)])


def _udp_frame(src="10.1.0.4", dst="10.1.0.9", sport=3333, dport=53, payload=b"x" * 8) -> bytes:
    """A minimal Ethernet + IPv4 + UDP frame."""
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + 8 + len(payload), 0, 0, 64, 17, 0,
                     socket.inet_aton(src), socket.inet_aton(dst))
    udp = struct.pack(">HHHH", sport, dport, 8 + len(payload), 0)
    return b"\x00" * 12 + b"\x08\x00" + ip + udp + payload


def _drop_data(m, frame: bytes, reason: int = 130, ifindex: int = 7) -> bytes:
    """A DropNotify header (36 bytes) and the captured frame."""
    hdr = bytearray(36)
    hdr[0] = m.mon.MSG_DROP
    hdr[1] = reason
    struct.pack_into("<I", hdr, 32, ifindex)
    return bytes(hdr) + frame


def _trace_data(m, frame: bytes, obs: int = 10, version: int = 0) -> bytes:
    hdr = bytearray(48 if version else 32)
    hdr[0] = m.mon.MSG_TRACE
    hdr[1] = obs
    struct.pack_into("<H", hdr, 14, version)
    struct.pack_into("<I", hdr, 28, 3)
    return bytes(hdr) + frame


def _records(m, events) -> np.ndarray:
    return m.mon.events_to_records(events, now_ns=NOW_NS)[0]


def _frames(g, *messages: bytes) -> bytes:
    """Length-prefixed gob messages."""
    out = b""
    for msg in messages:
        w = g._Writer()
        w.uint(len(msg))
        out += w.getvalue() + msg
    return out


# -- the reference's cases; each returns what both packages must agree on ------


def case_gob_doc_example_decodes(m):
    vals = m.gob.GobStreamDecoder().feed(_GOB_DOC_POINT)
    assert vals == [{"X": 22, "Y": 33}]
    return vals


def case_gob_doc_example_encodes(m):
    enc = m.gob.GobStructEncoder("Point", [("X", m.gob.T_INT), ("Y", m.gob.T_INT)])
    wire = enc.encode({"X": 22, "Y": 33})
    assert wire == _GOB_DOC_POINT
    return wire


def case_payload_roundtrip_with_zero_omission(m):
    msgs = [{"Data": b"\x01\x02\x03", "CPU": 2, "Lost": 0, "Type": 9},
            {"Data": b"", "CPU": 0, "Lost": 12, "Type": 2},  # RecordLost
            {"Data": b"\xff" * 300, "CPU": -1, "Type": 9}]  # a multi-byte length
    enc = _payload_encoder(m.gob)
    wire = b"".join(enc.encode(x) for x in msgs)
    got = m.gob.GobStreamDecoder().feed(wire)
    assert got[0] == {"Data": b"\x01\x02\x03", "CPU": 2, "Type": 9}
    assert got[1] == {"Lost": 12, "Type": 2}  # zero fields omitted
    assert got[2]["Data"] == b"\xff" * 300 and got[2]["CPU"] == -1
    return wire, got


def case_gob_incremental_feed_byte_at_a_time(m):
    wire = _payload_encoder(m.gob).encode({"Data": b"abc", "Type": 9})
    dec = m.gob.GobStreamDecoder()
    out = []
    for i in range(len(wire)):
        out += dec.feed(wire[i: i + 1])
    assert out == [{"Data": b"abc", "Type": 9}]
    return out


def case_gob_corrupt_length_prefix_raises_not_stalls(m):
    """A desynced stream raises (the caller reconnects); it is never taken
    as forever incomplete while the buffer grows."""
    errors = []
    for bad in (b"\xf0junk", bytes([0xFC]) + (2 << 30).to_bytes(4, "big")):
        with pytest.raises(m.gob.GobError) as info:
            m.gob.GobStreamDecoder().feed(bad)
        errors.append(str(info.value))
    return errors


def case_gob_decodes_floats_bools_strings_and_nested_types(m):
    g = m.gob
    enc = g.GobStructEncoder("Mixed", [("B", g.T_BOOL), ("F", g.T_FLOAT), ("S", g.T_STRING)])
    wire = enc.encode({"B": True, "F": 17.0, "S": "héllo"})
    mixed = g.GobStreamDecoder().feed(wire)
    assert mixed == [{"B": True, "F": 17.0, "S": "héllo"}]
    # A type descriptor for []int (SliceT), then the value [7, -3].
    w = g._Writer()
    w.int_(-65)
    w.uint(2)  # wireType field 1 = SliceT
    w.uint(1)  # SliceType field 0 = CommonType
    w.uint(1)
    w.uint(len(b"IntSlice"))
    w.bytes_(b"IntSlice")
    w.uint(1)
    w.int_(65)
    w.uint(0)  # end CommonType
    w.uint(1)
    w.int_(2)  # Elem = int
    w.uint(0)  # end SliceType
    w.uint(0)  # end wireType
    v = g._Writer()
    v.int_(65)
    v.uint(0)  # singleton delta
    v.uint(2)  # len
    v.int_(7)
    v.int_(-3)
    ints = g.GobStreamDecoder().feed(_frames(g, w.getvalue(), v.getvalue()))
    assert ints == [[7, -3]]
    # A type descriptor for map[string]uint (MapT), then {"a": 1, "b": 2}.
    w = g._Writer()
    w.int_(-66)
    w.uint(4)  # wireType field 3 = MapT
    w.uint(1)  # MapType field 0 = CommonType
    w.uint(1)
    w.uint(len(b"SUMap"))
    w.bytes_(b"SUMap")
    w.uint(1)
    w.int_(66)
    w.uint(0)  # end CommonType
    w.uint(1)
    w.int_(6)  # Key = string
    w.uint(1)
    w.int_(g.T_UINT)  # Elem = uint
    w.uint(0)  # end MapType
    w.uint(0)  # end wireType
    v = g._Writer()
    v.int_(66)
    v.uint(0)  # singleton delta
    v.uint(2)  # count
    for key, val in ((b"a", 1), (b"b", 2)):
        v.uint(1)
        v.bytes_(key)
        v.uint(val)
    maps = g.GobStreamDecoder().feed(_frames(g, w.getvalue(), v.getvalue()))
    assert maps == [{"a": 1, "b": 2}]
    return wire, mixed, ints, maps


def case_gob_rejects_oversized_counts(m):
    """A hostile slice count must not allocate unbounded memory."""
    dec = m.gob.GobStreamDecoder()
    dec.feed(_GOB_DOC_POINT)  # registers type 65
    with pytest.raises(m.gob.GobError) as info:
        dec.feed(bytes([6, 0xFF, 0x82, 0x01, 0xF8]) + b"\xff" * 2)
    return str(info.value)


def case_drop_notify_parses_to_drop_record(m):
    ev = m.mon.parse_perf_sample(_drop_data(m, _udp_frame(), reason=130, ifindex=7))
    assert ev is not None and ev.event_type == m.schema.EV_DROP
    # Cilium reason 130 (invalid source mac) folds into invalid_packet.
    assert ev.drop_reason == m.mon.REASON_INVALID_PACKET and ev.ifindex == 7
    rec = _records(m, [ev])
    F = m.schema.F
    assert len(rec) == 1
    assert rec[0, F.EVENT_TYPE] == m.schema.EV_DROP
    assert rec[0, F.VERDICT] == m.schema.VERDICT_DROPPED
    assert rec[0, F.DROP_REASON] == m.mon.REASON_INVALID_PACKET
    assert rec[0, F.SRC_IP] == m.schema.ip_to_u32("10.1.0.4")
    assert rec[0, F.DST_IP] == m.schema.ip_to_u32("10.1.0.9")
    assert rec[0, F.IFINDEX] == 7
    return rec


def case_trace_notify_v0_and_v1_header_lengths(m):
    out = []
    for version in (0, 1):
        ev = m.mon.parse_perf_sample(_trace_data(m, _udp_frame(), version=version))
        assert ev is not None
        rec = _records(m, [ev])
        assert len(rec) == 1, f"version {version} frame misaligned"
        assert rec[0, m.schema.F.EVENT_TYPE] == m.schema.EV_FORWARD
        out.append(rec)
    return out


def case_policy_verdict_negative_is_drop(m):
    hdr = bytearray(32)
    hdr[0] = m.mon.MSG_POLICY_VERDICT
    struct.pack_into("<i", hdr, 20, -133)  # policy denied
    ev = m.mon.parse_perf_sample(bytes(hdr) + _udp_frame())
    assert ev is not None and ev.event_type == m.schema.EV_DROP
    assert ev.drop_reason == m.mon.REASON_POLICY_DENIED
    return _records(m, [ev])


def case_non_packet_messages_skipped(m):
    got = [m.mon.parse_perf_sample(bytes([2]) + b"\x00" * 64),  # debug
           m.mon.parse_perf_sample(b""),
           # MSG_RECORD_CAPTURE (8) has its own layout: skipped, not misparsed.
           m.mon.parse_perf_sample(bytes([8]) + b"\x00" * 64)]
    assert got == [None, None, None]
    return got


def case_debug_capture_uses_24_byte_header(m):
    """MSG_CAPTURE (3) is DebugCapture: a 24-byte header with no version
    field, so the frame starts at offset 24."""
    hdr = bytearray(24)
    hdr[0] = 3
    ev = m.mon.parse_perf_sample(bytes(hdr) + _udp_frame(src="10.2.0.7"))
    assert ev is not None
    rec = _records(m, [ev])
    assert len(rec) == 1, "frame misaligned: header length wrong"
    assert rec[0, m.schema.F.SRC_IP] == m.schema.ip_to_u32("10.2.0.7")
    assert rec[0, m.schema.F.EVENT_TYPE] == m.schema.EV_FORWARD
    assert m.mon.parse_perf_sample(bytes([3]) + b"\x00" * 10) is None  # truncated
    return rec


def case_trace_obs_points_not_inverted(m):
    """to-lxc (0) is delivery into the endpoint (ingress); from-lxc (5) is
    the packet leaving it (egress)."""
    s = m.schema
    to_lxc = m.mon.parse_perf_sample(_trace_data(m, _udp_frame(), obs=0))
    from_lxc = m.mon.parse_perf_sample(_trace_data(m, _udp_frame(), obs=5))
    assert (to_lxc.obs_point, to_lxc.direction) == (s.OP_TO_ENDPOINT, s.DIR_INGRESS)
    assert (from_lxc.obs_point, from_lxc.direction) == (s.OP_TO_STACK, s.DIR_EGRESS)
    return _records(m, [to_lxc, from_lxc])


def case_event_index_survives_undecodable_frames(m):
    """Frame 1 is garbage (the packet decoder drops it); frame 2's metadata
    still lands on frame 2's record."""
    evs = [m.mon.parse_perf_sample(_drop_data(m, _udp_frame(src="10.1.0.1"), 1)),
           m.mon.parse_perf_sample(_drop_data(m, b"\xde\xad\xbe\xef", 2)),
           m.mon.parse_perf_sample(_drop_data(m, _udp_frame(src="10.1.0.3"), 3))]
    rec = _records(m, [e for e in evs if e is not None])
    F = m.schema.F
    assert len(rec) == 2
    assert rec[0, F.SRC_IP] == m.schema.ip_to_u32("10.1.0.1") and rec[0, F.DROP_REASON] == 1
    assert rec[1, F.SRC_IP] == m.schema.ip_to_u32("10.1.0.3") and rec[1, F.DROP_REASON] == 3
    return rec


def _monitor_payloads(m) -> list[dict]:
    return [{"Data": _drop_data(m, _udp_frame(src="10.9.0.1"), 133),
             "Type": m.mon.PAYLOAD_EVENT_SAMPLE},
            {"Data": _trace_data(m, _udp_frame(src="10.9.0.2")),
             "Type": m.mon.PAYLOAD_EVENT_SAMPLE},
            {"Lost": 5, "Type": m.mon.PAYLOAD_RECORD_LOST}]


def serve_monitor(sock_path: str, wire: bytes, chunk: int = 7) -> tuple[socket.socket,
                                                                          threading.Thread]:
    """A fake Cilium agent: one connection, ``wire`` dribbled in ``chunk``s."""
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(sock_path)
    server.listen(1)

    def serve() -> None:
        conn, _ = server.accept()
        for i in range(0, len(wire), chunk):
            conn.sendall(wire[i: i + chunk])
            time.sleep(0.001)
        time.sleep(0.5)
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return server, t


def run_monitor_plugin(m, sock_path: str, want: int, timeout_s: float = 10.0) -> np.ndarray:
    """The package's plugin against the monitor socket until ``want`` rows
    arrived (or the timeout): the rows, concatenated."""
    cfg = m.Config()
    cfg.monitor_sock_path = sock_path
    plugin = m.Plugin(cfg)
    sink = m.QueueSink(max_blocks=64)
    plugin.set_sink(sink)
    plugin.generate()
    stop = threading.Event()
    pt = threading.Thread(target=plugin.start, args=(stop,), daemon=True)
    pt.start()
    got: list[np.ndarray] = []
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and sum(len(r) for r in got) < want:
        got += [r for r, _ in sink.drain(max_blocks=16)]
        time.sleep(0.02)
    stop.set()
    pt.join(timeout=5)
    assert not pt.is_alive()
    return np.concatenate(got) if got else np.zeros((0, 16), np.uint32)


def case_plugin_ingests_from_monitor_socket(m, tmp_path):
    """A fake Cilium agent serves gob payloads over a Unix socket; the
    plugin decodes them into records that reach the sink."""
    sock_path = str(tmp_path / ("m-ref.sock" if m is IMPLS["reference"] else "m-port.sock"))
    wire = b"".join(_payload_encoder(m.gob).encode(p) for p in _monitor_payloads(m))
    server, t = serve_monitor(sock_path, wire)
    try:
        rec = run_monitor_plugin(m, sock_path, 2)
    finally:
        server.close()
        t.join(5)
    F = m.schema.F
    assert len(rec) == 2
    assert {int(x) for x in rec[:, F.SRC_IP]} == {m.schema.ip_to_u32("10.9.0.1"),
                                                   m.schema.ip_to_u32("10.9.0.2")}
    drop = rec[rec[:, F.EVENT_TYPE] == m.schema.EV_DROP]
    assert len(drop) == 1 and drop[0, F.DROP_REASON] == m.mon.REASON_POLICY_DENIED
    # The arrival stamps are the wall clock's: compare the rest.
    keep = [f for f in range(16) if f not in (F.TS_LO, F.TS_HI)]
    return rec[np.argsort(rec[:, F.SRC_IP])][:, keep]


CASES = [case_gob_doc_example_decodes, case_gob_doc_example_encodes,
         case_payload_roundtrip_with_zero_omission, case_gob_incremental_feed_byte_at_a_time,
         case_gob_corrupt_length_prefix_raises_not_stalls,
         case_gob_decodes_floats_bools_strings_and_nested_types,
         case_gob_rejects_oversized_counts, case_drop_notify_parses_to_drop_record,
         case_trace_notify_v0_and_v1_header_lengths, case_policy_verdict_negative_is_drop,
         case_non_packet_messages_skipped, case_debug_capture_uses_24_byte_header,
         case_trace_obs_points_not_inverted, case_event_index_survives_undecodable_frames,
         case_plugin_ingests_from_monitor_socket]


def _equal(a, b) -> None:
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_gob_and_monitor_case(case, tmp_path):
    kw = {"tmp_path": tmp_path} if "tmp_path" in case.__code__.co_varnames else {}
    got = {name: case(m, **kw) for name, m in IMPLS.items()}
    _equal(got["port"], got["reference"])


def test_port_encoder_stream_decodes_on_the_reference_and_back():
    """Gob bytes cross between the packages: the port's encoder's stream
    decodes to the same values on the reference's decoder, and the other
    way round, for a stream of payloads that reuses its type."""
    rng = np.random.default_rng(22)
    msgs = [{"Data": rng.integers(0, 256, int(rng.integers(0, 600)), dtype=np.uint8).tobytes(),
             "CPU": int(rng.integers(-4, 64)), "Lost": int(rng.integers(0, 1 << 40)),
             "Type": int(rng.choice([2, 9]))} for _ in range(64)]
    port_enc, ref_enc = _payload_encoder(gob), _payload_encoder(jgob)
    port_wire = b"".join(port_enc.encode(x) for x in msgs)
    ref_wire = b"".join(ref_enc.encode(x) for x in msgs)
    assert port_wire == ref_wire
    assert jgob.GobStreamDecoder().feed(port_wire) == gob.GobStreamDecoder().feed(ref_wire)
