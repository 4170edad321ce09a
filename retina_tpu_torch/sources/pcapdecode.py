"""Pcap decoding to event records, the packetparser.c analog (port of
retina_tpu/sources/pcapdecode.py).

Reference analog: pkg/plugin/packetparser/_cprog/packetparser.c:
``parse()`` (:118-227) extracts eth/IPv4/TCP/UDP headers plus the TCP
timestamp option (:42-115). Here the same extraction runs on the host over
pcap bytes: the C++ decoder (``native/decoder.cpp``, ``decode_pcap_native``)
first, as the reference does; the vectorized numpy decoder below
(``_decode_pcap_numpy``: one pass finds each packet's offset, then every
header field of all packets is gathered with numpy) when the caller asks
for it with ``prefer_native=False``. The two are bit-identical. Unlike the
reference, a native library that cannot be built raises: there is no quiet
fallback.

DNS payloads (UDP :53) get a second, sparse pass building qname hashes and
a host-side string table (strings never cross to the device).

Also provides :func:`synthesize_pcap` (build a real pcap from flow specs)
so tests and captures can round-trip: flows -> pcap bytes -> records.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from retina_tpu_torch.events.schema import (
    EV_DNS_REQ,
    EV_DNS_RESP,
    EV_FORWARD,
    F,
    NUM_FIELDS,
    OP_FROM_NETWORK,
    PROTO_TCP,
    PROTO_UDP,
    VERDICT_FORWARDED,
)

PCAP_MAGIC_US = 0xA1B2C3D4
PCAP_MAGIC_NS = 0xA1B23C4D


def dns_qname_hash(name: str | bytes) -> int:
    """Stable 32-bit hash for DNS query names (crc32 — host-side only).

    Hashes the raw label bytes with ASCII-only lowercasing so the value is
    bit-identical to the C++ decoder (decoder.cpp parse_dns), which never
    round-trips through unicode."""
    raw = name.encode("latin-1", "replace") if isinstance(name, str) else name
    lowered = bytes(c + 32 if 0x41 <= c <= 0x5A else c for c in raw)
    return zlib.crc32(lowered) & 0xFFFFFFFF


@dataclasses.dataclass
class PcapDecodeResult:
    records: np.ndarray  # (N, NUM_FIELDS) uint32
    dns_names: dict[int, str]  # qname hash -> name (host string table)
    n_packets_total: int  # all packets in the capture
    n_decoded: int  # IPv4 TCP/UDP packets decoded


def _find_offsets(data: bytes, ns: bool, swap: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sequential scan of pcap record headers → (ts_ns, pkt_off, caplen)."""
    fmt = "<IIII" if not swap else ">IIII"
    unpack = struct.Struct(fmt).unpack_from
    off = 24
    end = len(data)
    ts_list, off_list, len_list = [], [], []
    scale = 1 if ns else 1000
    while off + 16 <= end:
        ts_sec, ts_frac, incl, orig = unpack(data, off)
        if off + 16 + incl > end:
            break
        ts_list.append(ts_sec * 1_000_000_000 + ts_frac * scale)
        off_list.append(off + 16)
        len_list.append(incl)
        off += 16 + incl
    return (
        np.array(ts_list, np.uint64),
        np.array(off_list, np.int64),
        np.array(len_list, np.int64),
    )


def _gather_u8(buf: np.ndarray, offs: np.ndarray) -> np.ndarray:
    return buf[offs].astype(np.uint32)


def _gather_u16(buf: np.ndarray, offs: np.ndarray) -> np.ndarray:
    return (buf[offs].astype(np.uint32) << 8) | buf[offs + 1]


def _gather_u32(buf: np.ndarray, offs: np.ndarray) -> np.ndarray:
    return (
        (buf[offs].astype(np.uint32) << 24)
        | (buf[offs + 1].astype(np.uint32) << 16)
        | (buf[offs + 2].astype(np.uint32) << 8)
        | buf[offs + 3].astype(np.uint32)
    )


def decode_pcap_bytes(
    data: bytes,
    obs_point: int = OP_FROM_NETWORK,
    parse_dns: bool = True,
    prefer_native: bool = True,
) -> PcapDecodeResult:
    """Decode a pcap byte string into event records: the C++ decoder
    (``native.decode_pcap_native``, built at first use; a failed build
    raises), or the bit-identical numpy decoder with ``prefer_native=False``.
    DNS name strings always come from a sparse host pass (strings never
    enter the record tensor)."""
    if prefer_native:
        from retina_tpu_torch.native import decode_pcap_native

        records, n_total = decode_pcap_native(data, obs_point)
        names = _dns_name_pass(data) if parse_dns else {}
        return PcapDecodeResult(records, names, n_total, len(records))
    return _decode_pcap_numpy(data, obs_point, parse_dns)


def _dns_name_pass(data: bytes) -> dict[int, str]:
    """Sparse second pass: qname strings for UDP:53 packets only."""
    if len(data) < 24:
        return {}
    magic = struct.unpack_from("<I", data, 0)[0]
    if magic in (PCAP_MAGIC_US, PCAP_MAGIC_NS):
        swap, ns = False, magic == PCAP_MAGIC_NS
    else:
        magic_be = struct.unpack_from(">I", data, 0)[0]
        if magic_be not in (PCAP_MAGIC_US, PCAP_MAGIC_NS):
            return {}
        swap, ns = True, magic_be == PCAP_MAGIC_NS
    _, pkt_off, caplen = _find_offsets(data, ns, swap)
    names: dict[int, str] = {}
    for off, incl in zip(pkt_off, caplen):
        off, incl = int(off), int(incl)
        if incl < 14 + 20 + 8:
            continue
        if data[off + 12] != 0x08 or data[off + 13] != 0x00:
            continue
        ip_off = off + 14
        if (data[ip_off] >> 4) != 4 or data[ip_off + 9] != PROTO_UDP:
            continue
        ihl = (data[ip_off] & 0xF) * 4
        l4 = ip_off + ihl
        if incl < 14 + ihl + 8:
            continue
        sport = (data[l4] << 8) | data[l4 + 1]
        dport = (data[l4 + 2] << 8) | data[l4 + 3]
        if sport != 53 and dport != 53:
            continue
        parsed = _parse_dns(data, l4 + 8, off + incl)
        if parsed is not None:
            names[dns_qname_hash(parsed[0])] = parsed[0].decode(
                "ascii", "replace"
            )
    return names


def _decode_pcap_numpy(
    data: bytes,
    obs_point: int = OP_FROM_NETWORK,
    parse_dns: bool = True,
) -> PcapDecodeResult:
    """Pure numpy reference decoder (vectorized)."""
    if len(data) < 24:
        return PcapDecodeResult(
            np.zeros((0, NUM_FIELDS), np.uint32), {}, 0, 0
        )
    magic = struct.unpack_from("<I", data, 0)[0]
    if magic in (PCAP_MAGIC_US, PCAP_MAGIC_NS):
        swap = False
        ns = magic == PCAP_MAGIC_NS
    else:
        magic_be = struct.unpack_from(">I", data, 0)[0]
        if magic_be not in (PCAP_MAGIC_US, PCAP_MAGIC_NS):
            raise ValueError(f"not a pcap file (magic {magic:#x})")
        swap = True
        ns = magic_be == PCAP_MAGIC_NS

    ts_ns, pkt_off, caplen = _find_offsets(data, ns, swap)
    n_total = len(pkt_off)
    if n_total == 0:
        return PcapDecodeResult(
            np.zeros((0, NUM_FIELDS), np.uint32), {}, 0, 0
        )

    buf = np.frombuffer(data, np.uint8)

    # --- Ethernet: keep IPv4 with room for eth+ip headers ---
    # Every gather masks its offsets to 0 first: rows already rejected may
    # have offsets past the end of the capture buffer.
    ok = caplen >= 14 + 20
    safe = lambda offs: np.where(ok, offs, 0)
    ethertype = np.where(ok, _gather_u16(buf, safe(pkt_off + 12)), 0)
    ok &= ethertype == 0x0800

    # --- IPv4 header (packetparser.c parse() IPv4 block) ---
    ip_off = pkt_off + 14
    vihl = np.where(ok, _gather_u8(buf, safe(ip_off)), 0)
    ihl = (vihl & 0xF) * 4
    ok &= (vihl >> 4) == 4
    total_len = np.where(ok, _gather_u16(buf, safe(ip_off + 2)), 0)
    proto = np.where(ok, _gather_u8(buf, safe(ip_off + 9)), 0)
    ok &= (proto == PROTO_TCP) | (proto == PROTO_UDP)
    src_ip = np.where(ok, _gather_u32(buf, safe(ip_off + 12)), 0)
    dst_ip = np.where(ok, _gather_u32(buf, safe(ip_off + 16)), 0)

    l4_off = ip_off + ihl
    ok &= caplen >= (14 + ihl + np.where(proto == PROTO_TCP, 20, 8))

    safe_l4 = np.where(ok, l4_off, 0)
    sport = np.where(ok, _gather_u16(buf, safe_l4), 0)
    dport = np.where(ok, _gather_u16(buf, safe_l4 + 2), 0)

    is_tcp = ok & (proto == PROTO_TCP)
    tcp_at = np.where(is_tcp, safe_l4, 0)  # UDP rows may sit at buffer end
    tcp_flags = np.where(is_tcp, _gather_u8(buf, tcp_at + 13), 0)
    doff = np.where(is_tcp, (_gather_u8(buf, tcp_at + 12) >> 4) * 4, 8)

    # --- TCP timestamp option (packetparser.c:42-115): walk option
    # bytes for all TCP packets at once, at most 40 lock-step steps.
    tsval = np.zeros(n_total, np.uint32)
    tsecr = np.zeros(n_total, np.uint32)
    has_opts = is_tcp & (doff > 20) & (caplen >= 14 + ihl + doff)
    if has_opts.any():
        opt_start = safe_l4 + 20
        opt_len = np.where(has_opts, doff - 20, 0)
        pos = np.zeros(n_total, np.int64)
        active = has_opts.copy()
        for _ in range(40):
            if not active.any():
                break
            cur = opt_start + pos
            kind = np.where(active, _gather_u8(buf, np.where(active, cur, 0)), 0)
            # kind 0 = end, 1 = nop, 8 = timestamps (len 10)
            is_ts = active & (kind == 8) & (pos + 10 <= opt_len)
            ts_at = np.where(is_ts, cur, 0)
            tsval = np.where(is_ts, _gather_u32(buf, ts_at + 2), tsval)
            tsecr = np.where(is_ts, _gather_u32(buf, ts_at + 6), tsecr)
            active &= ~is_ts & (kind != 0)
            # A non-NOP option kind with no room left for its length byte
            # ends the walk (decoder.cpp: `if (p + 1 >= opt_len) break`) —
            # and keeps the length-byte gather below in bounds even when
            # the options region ends exactly at the capture buffer end.
            active &= (kind == 1) | (pos + 1 < opt_len)
            need_len = active & (kind != 1)
            length = np.where(
                kind == 1, 1, np.where(
                    need_len, np.maximum(
                        _gather_u8(buf, np.where(need_len, cur + 1, 0)), 2
                    ), 1
                )
            )
            pos = pos + np.where(kind == 1, 1, length)
            active &= pos < opt_len

    # --- assemble records ---
    idx = np.nonzero(ok)[0]
    n = len(idx)
    rec = np.zeros((n, NUM_FIELDS), np.uint32)
    ts_sel = ts_ns[idx]
    rec[:, F.TS_LO] = (ts_sel & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    rec[:, F.TS_HI] = (ts_sel >> np.uint64(32)).astype(np.uint32)
    rec[:, F.SRC_IP] = src_ip[idx]
    rec[:, F.DST_IP] = dst_ip[idx]
    rec[:, F.PORTS] = (sport[idx] << np.uint32(16)) | dport[idx]
    direction = 1 if obs_point in (OP_FROM_NETWORK, 1) else 2
    rec[:, F.META] = (
        (proto[idx] << np.uint32(24))
        | (tcp_flags[idx] << np.uint32(16))
        | (np.uint32(obs_point) << np.uint32(8))
        | np.uint32(direction << 4)
    )
    rec[:, F.BYTES] = total_len[idx]
    rec[:, F.PACKETS] = 1
    rec[:, F.VERDICT] = VERDICT_FORWARDED
    rec[:, F.TSVAL] = tsval[idx]
    rec[:, F.TSECR] = tsecr[idx]
    rec[:, F.EVENT_TYPE] = EV_FORWARD

    # --- DNS second pass (sparse; strings stay host-side) ---
    dns_names: dict[int, str] = {}
    if parse_dns:
        is_dns_sel = (proto[idx] == PROTO_UDP) & (
            (sport[idx] == 53) | (dport[idx] == 53)
        )
        for j in np.nonzero(is_dns_sel)[0]:
            i = idx[j]
            payload_off = int(l4_off[i]) + 8
            payload_end = int(pkt_off[i]) + int(caplen[i])
            parsed = _parse_dns(data, payload_off, payload_end)
            if parsed is None:
                continue
            qname, qtype, rcode, is_resp = parsed
            h = dns_qname_hash(qname)
            dns_names[h] = qname.decode("ascii", "replace")
            rec[j, F.DNS] = (
                ((qtype & 0xFFFF) << 16) | ((rcode & 0xFF) << 8)
                | (2 if is_resp else 1)
            )
            rec[j, F.DNS_QHASH] = h
            rec[j, F.EVENT_TYPE] = EV_DNS_RESP if is_resp else EV_DNS_REQ

    return PcapDecodeResult(rec, dns_names, n_total, n)


def _parse_dns(data: bytes, off: int, end: int):
    """Parse DNS header + first question. Returns (qname_raw: bytes, qtype,
    rcode, is_response) or None. The raw label bytes (not a unicode
    round-trip) are what gets hashed — decoder.cpp parse_dns parity,
    including its rejection of truncated labels and names > 255 bytes."""
    if end - off < 12:
        return None
    flags = struct.unpack_from(">H", data, off + 2)[0]
    qdcount = struct.unpack_from(">H", data, off + 4)[0]
    if qdcount < 1:
        return None
    is_resp = bool(flags & 0x8000)
    rcode = flags & 0xF
    labels: list[bytes] = []
    nlen = 0
    p = off + 12
    for _ in range(64):
        if p >= end:
            return None
        ln = data[p]
        if ln == 0:
            p += 1
            break
        if ln >= 0xC0:  # compression pointer — name done elsewhere
            p += 2
            break
        if p + 1 + ln > end or nlen + ln + 1 > 256:
            return None
        labels.append(data[p + 1 : p + 1 + ln])
        nlen += ln + (1 if nlen else 0)  # dot only between labels
        p += 1 + ln
    if p + 4 > end:
        return None
    qtype = struct.unpack_from(">H", data, p)[0]
    return b".".join(labels), qtype, rcode, is_resp


def dns_names_from_frames(blob: bytes) -> dict[int, str]:
    """qname strings from a [u16 caplen][eth frame] blob — the DNS
    sidecar the native TPACKET_V3 ring emits (afpacket.cpp): the C path
    fills record hash lanes, the host string table fills here."""
    names: dict[int, str] = {}
    off = 0
    total = len(blob)
    while off + 2 <= total:
        (cl,) = struct.unpack_from("<H", blob, off)
        off += 2
        end = off + cl
        if end > total:
            break
        frame = blob[off:off + cl]
        off = end
        if cl < 14 + 20 + 8 or frame[12] != 0x08 or frame[13] != 0x00:
            continue
        if (frame[14] >> 4) != 4 or frame[14 + 9] != PROTO_UDP:
            continue
        ihl = (frame[14] & 0xF) * 4
        pay = 14 + ihl + 8
        parsed = _parse_dns(frame, pay, cl)
        if parsed is not None:
            names[dns_qname_hash(parsed[0])] = parsed[0].decode(
                "ascii", "replace"
            )
    return names


def decode_pcap_file(path: str, **kw) -> PcapDecodeResult:
    with open(path, "rb") as fh:
        return decode_pcap_bytes(fh.read(), **kw)


# ---------------------------------------------------------------------------
# Pcap synthesis (tests / benches round-trip real packet bytes).


def _build_packet(
    src_ip: int,
    dst_ip: int,
    sport: int,
    dport: int,
    proto: int,
    payload: bytes = b"",
    tcp_flags: int = 0x10,
    tsval: int = 0,
    tsecr: int = 0,
) -> bytes:
    eth = b"\x02\x00\x00\x00\x00\x01\x02\x00\x00\x00\x00\x02\x08\x00"
    if proto == PROTO_TCP:
        opts = b""
        if tsval or tsecr:
            opts = b"\x01\x01" + struct.pack(">BBII", 8, 10, tsval, tsecr)
        doff = (20 + len(opts)) // 4
        l4 = struct.pack(
            ">HHIIBBHHH", sport, dport, 1000, 2000, doff << 4,
            tcp_flags, 65535, 0, 0,
        ) + opts + payload
    else:
        l4 = struct.pack(">HHHH", sport, dport, 8 + len(payload), 0) + payload
    total = 20 + len(l4)
    ip = struct.pack(
        ">BBHHHBBHII", 0x45, 0, total, 0, 0, 64, proto, 0, src_ip, dst_ip
    )
    return eth + ip + l4


def _build_dns_payload(qname: str, qtype: int = 1, response: bool = False,
                       rcode: int = 0) -> bytes:
    flags = (0x8000 | rcode) if response else 0x0100
    hdr = struct.pack(">HHHHHH", 0x1234, flags, 1, 0, 0, 0)
    q = b"".join(
        bytes([len(lbl)]) + lbl.encode() for lbl in qname.split(".")
    ) + b"\x00" + struct.pack(">HH", qtype, 1)
    return hdr + q


def synthesize_pcap(packets: list[dict], ns: bool = True) -> bytes:
    """Build pcap bytes from packet specs (keys: src_ip, dst_ip, sport,
    dport, proto, ts_ns, tcp_flags, tsval, tsecr, dns_qname, dns_response,
    dns_rcode, dns_qtype)."""
    magic = PCAP_MAGIC_NS if ns else PCAP_MAGIC_US
    out = [struct.pack("<IHHiIII", magic, 2, 4, 0, 0, 65535, 1)]
    for p in packets:
        payload = b""
        if p.get("dns_qname"):
            payload = _build_dns_payload(
                p["dns_qname"],
                p.get("dns_qtype", 1),
                p.get("dns_response", False),
                p.get("dns_rcode", 0),
            )
        raw = _build_packet(
            p["src_ip"], p["dst_ip"], p.get("sport", 40000),
            p.get("dport", 80), p.get("proto", PROTO_TCP), payload,
            p.get("tcp_flags", 0x10), p.get("tsval", 0), p.get("tsecr", 0),
        )
        ts = p.get("ts_ns", 0)
        frac = ts % 1_000_000_000 if ns else (ts % 1_000_000_000) // 1000
        out.append(
            struct.pack("<IIII", ts // 1_000_000_000, frac, len(raw), len(raw))
        )
        out.append(raw)
    return b"".join(out)
