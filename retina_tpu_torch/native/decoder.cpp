// Native event decoder — the kernel-parse analog, in C++.
//
// Reference analog: pkg/plugin/packetparser/_cprog/packetparser.c — the
// eBPF parse() path (:118-227) and its TCP timestamp-option walker
// (:42-115). This library is the hot host-side equivalent: pcap bytes →
// fixed-width (N, 16) uint32 event records (retina_tpu/events/schema.py),
// one linear pass, no allocation. Bit-identical output to the Python/numpy
// reference decoder (sources/pcapdecode.py), which remains the fallback
// when this library is not built.
//
// C ABI only (consumed via ctypes). Build: make -C retina_tpu/native
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

// Record field indices — must match retina_tpu/events/schema.py F.
enum Field {
  TS_LO = 0, TS_HI, SRC_IP, DST_IP, PORTS, META, BYTES, PACKETS,
  VERDICT, DROP_REASON, TSVAL, TSECR, DNS, DNS_QHASH, EVENT_TYPE, IFINDEX,
  NUM_FIELDS
};

constexpr uint32_t kVerdictForwarded = 1;
constexpr uint32_t kEvForward = 0, kEvDnsReq = 2, kEvDnsResp = 3;
constexpr uint32_t kProtoTcp = 6, kProtoUdp = 17;

inline uint16_t be16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) << 8 | p[1];
}
inline uint32_t be32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) << 24 | static_cast<uint32_t>(p[1]) << 16 |
         static_cast<uint32_t>(p[2]) << 8 | p[3];
}
inline uint32_t le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[3]) << 24 | static_cast<uint32_t>(p[2]) << 16 |
         static_cast<uint32_t>(p[1]) << 8 | p[0];
}

// CRC-32 (IEEE, zlib-compatible) for DNS qname hashes — must match
// zlib.crc32 so host string tables key identically across both decoders.
uint32_t crc32_ieee(const uint8_t* data, size_t len) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    crc = table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// Parse the first DNS question's lowercased name into qhash; returns true
// on success. Mirrors pcapdecode._parse_dns + dns_qname_hash.
bool parse_dns(const uint8_t* data, size_t off, size_t end, uint32_t* qhash,
               uint32_t* qtype, uint32_t* rcode, bool* is_resp) {
  if (end - off < 12) return false;
  uint16_t flags = be16(data + off + 2);
  uint16_t qdcount = be16(data + off + 4);
  if (qdcount < 1) return false;
  *is_resp = (flags & 0x8000u) != 0;
  *rcode = flags & 0xF;
  uint8_t name[256];
  size_t nlen = 0;
  size_t p = off + 12;
  for (int i = 0; i < 64; i++) {
    if (p >= end) return false;
    uint8_t ln = data[p];
    if (ln == 0) { p += 1; break; }
    if (ln >= 0xC0) { p += 2; break; }
    if (p + 1 + ln > end || nlen + ln + 1 > sizeof(name)) return false;
    if (nlen) name[nlen++] = '.';
    for (size_t j = 0; j < ln; j++) {
      uint8_t ch = data[p + 1 + j];
      if (ch >= 'A' && ch <= 'Z') ch += 32;  // lowercase, like Python
      name[nlen++] = ch;
    }
    p += 1 + static_cast<size_t>(ln);
  }
  if (p + 4 > end) return false;
  *qtype = be16(data + p);
  *qhash = crc32_ieee(name, nlen);
  return true;
}

}  // namespace

extern "C" {

// One Ethernet frame -> one 16-lane record (shared by the pcap decoder
// and the TPACKET_V3 live ring reader, afpacket.cpp). Returns false for
// frames outside the parse set (non-IPv4, non-TCP/UDP, truncated) —
// exactly the packetparser.c parse() admission rule.
bool rt_decode_eth_frame(const uint8_t* pkt, size_t caplen, uint64_t ts_ns,
                         uint32_t obs_point, uint32_t direction,
                         uint32_t* r) {
  // --- Ethernet + IPv4 (packetparser.c parse() IPv4 block) ---
  if (caplen < 14 + 20) return false;
  if (be16(pkt + 12) != 0x0800) return false;
  const uint8_t* ip = pkt + 14;
  if ((ip[0] >> 4) != 4) return false;
  size_t ihl = static_cast<size_t>(ip[0] & 0xF) * 4;
  uint32_t proto = ip[9];
  if (proto != kProtoTcp && proto != kProtoUdp) return false;
  size_t l4_need = (proto == kProtoTcp) ? 20 : 8;
  if (caplen < 14 + ihl + l4_need) return false;
  const uint8_t* l4 = ip + ihl;

  uint32_t sport = be16(l4), dport = be16(l4 + 2);
  uint32_t tcp_flags = 0, tsval = 0, tsecr = 0;
  if (proto == kProtoTcp) {
    tcp_flags = l4[13];
    size_t doff = static_cast<size_t>(l4[12] >> 4) * 4;
    // --- TCP timestamp option walk (packetparser.c:42-115) ---
    if (doff > 20 && caplen >= 14 + ihl + doff) {
      const uint8_t* opt = l4 + 20;
      size_t opt_len = doff - 20, p = 0;
      while (p < opt_len) {
        uint8_t kind = opt[p];
        if (kind == 0) break;
        if (kind == 1) { p += 1; continue; }
        if (p + 1 >= opt_len) break;
        uint8_t olen = opt[p + 1] < 2 ? 2 : opt[p + 1];
        if (kind == 8 && p + 10 <= opt_len) {
          tsval = be32(opt + p + 2);
          tsecr = be32(opt + p + 6);
          break;
        }
        p += olen;
      }
    }
  }

  std::memset(r, 0, NUM_FIELDS * sizeof(uint32_t));
  r[TS_LO] = static_cast<uint32_t>(ts_ns);
  r[TS_HI] = static_cast<uint32_t>(ts_ns >> 32);
  r[SRC_IP] = be32(ip + 12);
  r[DST_IP] = be32(ip + 16);
  r[PORTS] = sport << 16 | dport;
  r[META] = proto << 24 | tcp_flags << 16 | obs_point << 8 | direction << 4;
  r[BYTES] = be16(ip + 2);
  r[PACKETS] = 1;
  r[VERDICT] = kVerdictForwarded;
  r[TSVAL] = tsval;
  r[TSECR] = tsecr;
  r[EVENT_TYPE] = kEvForward;

  // --- DNS (UDP :53) ---
  if (proto == kProtoUdp && (sport == 53 || dport == 53)) {
    size_t pay = 14 + ihl + 8;
    uint32_t qhash, qtype, rcode;
    bool is_resp;
    if (caplen > pay &&
        parse_dns(pkt, pay, caplen, &qhash, &qtype, &rcode, &is_resp)) {
      r[DNS] = (qtype & 0xFFFFu) << 16 | (rcode & 0xFFu) << 8 |
               (is_resp ? 2u : 1u);
      r[DNS_QHASH] = qhash;
      r[EVENT_TYPE] = is_resp ? kEvDnsResp : kEvDnsReq;
    }
  }
  return true;
}

// Decode pcap bytes into out[max_records][NUM_FIELDS] (uint32).
// Returns the number of decoded records (>= 0), or:
//   -1  not a pcap; -2  out buffer too small (records written up to max).
// n_packets_total receives the total packet count in the capture.
long rt_decode_pcap(const uint8_t* data, size_t len, uint32_t obs_point,
                    uint32_t* out, size_t max_records,
                    size_t* n_packets_total) {
  *n_packets_total = 0;
  if (len < 24) return 0;
  uint32_t magic = le32(data);
  bool swap = false, ns = false;
  if (magic == 0xA1B2C3D4u) { ns = false; }
  else if (magic == 0xA1B23C4Du) { ns = true; }
  else {
    uint32_t magic_be = be32(data);
    if (magic_be == 0xA1B2C3D4u) { swap = true; ns = false; }
    else if (magic_be == 0xA1B23C4Du) { swap = true; ns = true; }
    else return -1;
  }
  const uint32_t direction = (obs_point == 1 || obs_point == 2) ? 1u : 2u;
  size_t off = 24;
  size_t n = 0;
  bool overflow = false;
  while (off + 16 <= len) {
    uint32_t ts_sec = swap ? be32(data + off) : le32(data + off);
    uint32_t ts_frac = swap ? be32(data + off + 4) : le32(data + off + 4);
    uint32_t incl = swap ? be32(data + off + 8) : le32(data + off + 8);
    if (off + 16 + incl > len) break;
    const uint8_t* pkt = data + off + 16;
    size_t caplen = incl;
    off += 16 + incl;
    (*n_packets_total)++;

    if (n >= max_records) { overflow = true; break; }
    uint64_t ts_ns = static_cast<uint64_t>(ts_sec) * 1000000000ull +
                     static_cast<uint64_t>(ts_frac) * (ns ? 1ull : 1000ull);
    if (rt_decode_eth_frame(pkt, caplen, ts_ns, obs_point, direction,
                            out + n * NUM_FIELDS)) {
      n++;
    }
  }
  if (overflow) return -2;
  return static_cast<long>(n);
}

// ABI version of libretina_native.so. Bump on ANY exported-signature or
// wire-layout change; the Python loader (native/__init__.py
// NATIVE_ABI_VERSION) refuses a mismatched binary and rebuilds from
// source, so a stale .so from another checkout can never silently
// misparse the wire.
//   v1: rt_combine/rt_combine_mt/rt_flowwire era
//   v2: + rt_combine_stripe (striped multi-consumer combine) and
//       rt_flowwire_dense (v4 dense known-row bitstream)
uint32_t rt_abi_version(void) { return 2; }

}  // extern "C"
