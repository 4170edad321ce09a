// Host-side wire packer: (n, 16) schema rows -> (n, 12) packed lanes.
//
// The C++ twin of retina_tpu/parallel/wire.py pack_records (see that
// module for the lane layout and saturation bounds). Packing runs on
// every flush quantum right before the host->device transfer, so its
// cost lands on the feed path's critical section; the numpy version
// spends ~19% of the host path in strided column copies + u64
// timestamp math, this single pass is memory-bound.
//
// Must stay semantically identical to pack_records' numpy math — the
// test suite cross-checks the two on random batches (including zero
// timestamps, values past every saturation bound, and ts < base
// wraparound).

#include <cstdint>
#include <cstring>

namespace {

constexpr int NUM_FIELDS = 16;
constexpr int PACKED_FIELDS = 12;
// Field indices (retina_tpu/events/schema.py).
constexpr int F_TS_LO = 0, F_TS_HI = 1, F_SRC_IP = 2, F_DST_IP = 3,
              F_PORTS = 4, F_META = 5, F_BYTES = 6, F_PACKETS = 7,
              F_VERDICT = 8, F_DROP_REASON = 9, F_TSVAL = 10,
              F_TSECR = 11, F_DNS = 12, F_DNS_QHASH = 13,
              F_EVENT_TYPE = 14, F_IFINDEX = 15;

inline uint32_t min_u32(uint32_t a, uint32_t b) { return a < b ? a : b; }

// One packed wire row (the body shared by rt_pack and rt_flowwire —
// must stay semantically identical to pack_records' numpy math).
inline void pack_row(const uint32_t* r, uint32_t* o, uint64_t base) {
  constexpr uint64_t U32 = 0xFFFFFFFFull;
  uint64_t ts = ((uint64_t)r[F_TS_HI] << 32) | r[F_TS_LO];
  uint64_t diff = ts - base;  // wraps when ts < base, like numpy u64
  o[0] = ts > 0 ? (uint32_t)((diff < U32 - 1 ? diff : U32 - 1) + 1) : 0;
  o[1] = r[F_SRC_IP];
  o[2] = r[F_DST_IP];
  o[3] = r[F_PORTS];
  o[4] = r[F_META];
  o[5] = r[F_BYTES];
  o[6] = r[F_PACKETS];
  o[7] = (min_u32(r[F_VERDICT], 7) << 29)
       | (min_u32(r[F_DROP_REASON], 255) << 21)
       | (min_u32(r[F_EVENT_TYPE], 15) << 17)
       | min_u32(r[F_IFINDEX], 0x1FFFF);
  o[8] = r[F_TSVAL];
  o[9] = r[F_TSECR];
  o[10] = r[F_DNS];
  o[11] = r[F_DNS_QHASH];
}

}  // namespace

extern "C" {

// Minimum nonzero 64-bit timestamp over rows (0 if none) — the TS_REL
// base shared by every wire array cut from one flush (wire.py
// batch_ts_base).
uint64_t rt_ts_base(const uint32_t* rows, size_t n) {
  uint64_t base = UINT64_MAX;
  for (size_t i = 0; i < n; i++) {
    const uint32_t* r = rows + i * NUM_FIELDS;
    uint64_t ts = ((uint64_t)r[F_TS_HI] << 32) | r[F_TS_LO];
    if (ts > 0 && ts < base) base = ts;
  }
  return base == UINT64_MAX ? 0 : base;
}

// rows: (n, 16) u32 row-major -> out: (n, 12) u32 row-major.
// Matches pack_records' numpy semantics exactly, including the
// unsigned wrap for ts < base (numpy u64 subtraction wraps, then the
// min() clamp saturates the relative timestamp).
void rt_pack(const uint32_t* rows, size_t n, uint64_t base,
             uint32_t* out) {
  for (size_t i = 0; i < n; i++)
    pack_row(rows + i * NUM_FIELDS, out + i * PACKED_FIELDS, base);
}

// v3 flow-dict wire build: ONE pass splits a device's rows into the
// new-descriptor wire ([table_id | 12 packed lanes], 13 u32/row) and
// the known wire ([id | packets << id_bits, bytes], 2 u32/row) by the
// caller-computed escalation mask (engine._dispatch_flowdict computes
// it in numpy: is_new | pk overflow | TSval/TSecr | unstamped). The
// numpy equivalent needed two fancy-indexed row copies + a pack pass +
// two bit-pack passes per flush — this is the dispatch worker's
// largest remaining cost at production quanta.
// new_out must hold at least (popcount(sel), 13); known_out at least
// (n - popcount, 2). Returns n_new.
long rt_flowwire(const uint32_t* rows, size_t n, const uint32_t* ids,
                 const uint8_t* sel_new, uint64_t base,
                 uint32_t id_bits, uint32_t* new_out,
                 uint32_t* known_out) {
  size_t n_new = 0, n_known = 0;
  for (size_t i = 0; i < n; i++) {
    const uint32_t* r = rows + i * NUM_FIELDS;
    if (sel_new[i]) {
      uint32_t* o = new_out + n_new * 13;
      o[0] = ids[i];
      pack_row(r, o + 1, base);
      n_new++;
    } else {
      uint32_t* o = known_out + n_known * 2;
      o[0] = ids[i] | (r[F_PACKETS] << id_bits);
      o[1] = r[F_BYTES];
      n_known++;
    }
  }
  return (long)n_new;
}

// v4 dense flow-dict wire build: like rt_flowwire, but known rows go
// into a CONTIGUOUS BITSTREAM of (id_bits + pk_bits + by_bits)-bit
// rows instead of two full u32 lanes — at the default 18-bit dict and
// 10/22-bit packet/byte lanes that is 6.25 B/row vs 8, and the row
// width shrinks further as deployments tune the dict smaller. The
// caller's escalation mask must already route rows whose PACKETS or
// BYTES overflow their lane to the new/full side (engine adds the
// `bytes >= 1 << by_bits` term for this path), so the stream stores
// every surviving row exactly.
//
// known_out must be ZEROED by the caller and hold at least
// ceil(n_known * row_bits / 32) + 1 u32 words (the +1 pad word keeps
// the device unpack's two-word gather in bounds for the last row).
// Rows are appended in input order through a 128-bit accumulator; bits
// beyond the last row stay zero, which the device side masks off via
// the per-device validity count. row_bits = id_bits + pk_bits +
// by_bits must be <= 64 (id_bits <= 32 always satisfies this at the
// shipped 10/22 lane widths). Returns n_new.
long rt_flowwire_dense(const uint32_t* rows, size_t n,
                       const uint32_t* ids, const uint8_t* sel_new,
                       uint64_t base, uint32_t id_bits, uint32_t pk_bits,
                       uint32_t by_bits, uint32_t* new_out,
                       uint32_t* known_out) {
  const unsigned row_bits = id_bits + pk_bits + by_bits;
  size_t n_new = 0, w = 0;
  unsigned __int128 acc = 0;
  unsigned acc_bits = 0;
  for (size_t i = 0; i < n; i++) {
    const uint32_t* r = rows + i * NUM_FIELDS;
    if (sel_new[i]) {
      uint32_t* o = new_out + n_new * 13;
      o[0] = ids[i];
      pack_row(r, o + 1, base);
      n_new++;
    } else {
      uint64_t v = (uint64_t)ids[i] |
                   ((uint64_t)r[F_PACKETS] << id_bits) |
                   ((uint64_t)r[F_BYTES] << (id_bits + pk_bits));
      acc |= (unsigned __int128)v << acc_bits;
      acc_bits += row_bits;
      while (acc_bits >= 32) {
        known_out[w++] = (uint32_t)acc;
        acc >>= 32;
        acc_bits -= 32;
      }
    }
  }
  if (acc_bits) known_out[w] = (uint32_t)acc;
  return (long)n_new;
}

}  // extern "C"
