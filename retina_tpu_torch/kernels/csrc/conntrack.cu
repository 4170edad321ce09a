// K5: connection tracking and report sampling over one batch.
//
// Replaces retina_tpu/ops/conntrack.py:123-270 ConntrackTable.process (the
// direction-free fingerprint, a two-key sort of the batch, a segmented scan,
// the report decision, two row scatters into the table and the scatter back
// to batch order). The plain version is ops/conntrack.py process_plain,
// whose module docstring states the rules both follow.
//
// Bound on the H100: bytes. Each event reads the first 32-byte sector of
// its record (src, dst, ports) and three u32 lanes (proto, bytes, mask,
// packets: 16 bytes), and writes four output lanes (16 bytes); the table
// (2^18 x 24 bytes, 6 MiB) stays in L2. Then atomics on a batch-local
// table: on Zipf traffic about 18% of a batch is one connection.
//
// Design: no sort. Phase A (ct_rows, one thread per row) fingerprints the
// row, reads the resident row of its slot for is_reply, and folds the row
// into a batch-local open-addressing table of connections (2x the batch,
// 64-bit keys by atomicCAS): u32 packet and byte sums by atomicAdd (they
// wrap mod 2^32 as the reference's scan does, in any order), the
// "interesting" bit by atomicOr, and (row << 1 | src_is_a) by atomicMax,
// which yields the connection's last row in batch order and that row's
// direction. The first inserter copies the resident row into the entry, so
// phase B never reads the table it writes. A warp first merges the lanes
// that carry one connection (__match_any_sync), so the hot connection costs
// one set of atomics per warp, not per row. Each connection also
// atomicMax-es its key into a per-slot winner word. Phase B (ct_entries, one
// thread per entry) decides the report from the copy, writes the report
// lanes at the last row, writes the table row where its key is the slot's
// winner (the largest (fp_lo, fp_hi) of the slot, unsigned), and clears its
// entry for the next batch. The winner words are cleared by
// cudaMemsetAsync before phase A.
#include "hash.cuh"

namespace {

constexpr unsigned long long kEmpty = ~0ull;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kTcpLifetime = 360u, kNonTcpLifetime = 60u;
constexpr uint32_t kInterval = 30u, kSkewSlack = 256u;
constexpr uint32_t kInteresting = 0x7u;  // TCP_FIN | TCP_SYN | TCP_RST

struct Col {
  const uint32_t* p;
  long long s;
  __device__ __forceinline__ uint32_t operator[](long long i) const { return p[i * s]; }
};

struct Ct {
  uint32_t* keys;  // (S, 2) [fp_lo, fp_hi]
  uint32_t* vals;  // (S, 4) [meta, packets, bytes, spare]
  uint32_t slot_mask;
  uint32_t seed;
  Col src, dst, ports, proto, flags, bytes, mask, pkts;  // pkts.p null: one per row
  long long B;
  uint32_t now;
  unsigned long long* ent_key;  // (E,) connection key fp_lo << 32 | fp_hi, kEmpty if free
  uint32_t* ent_acc;            // (E, 4) [packets, bytes, interesting, last_row << 1 | src_is_a]
  uint32_t* ent_res;            // (E, 6) resident [key lo, key hi, meta, packets, bytes] + is_tcp
  uint32_t ent_mask;
  unsigned long long* winner;   // (S,) largest key of each slot this batch
  uint32_t* out;                // (4, B) [report, is_reply, report_packets, report_bytes]
};

__global__ void ct_rows(Ct c) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // Warp-aligned loop: all 32 lanes run every iteration, for the warp
  // intrinsics; lanes past B carry no row.
  for (long long base = blockIdx.x * (long long)blockDim.x + (threadIdx.x - lane); base < c.B;
       base += stride) {
    const long long i = base + lane;
    const bool in = i < c.B;
    const bool m = in && c.mask[i] != 0u;
    uint32_t lo = 0u, hi = 0u, slot = 0u, pk = 0u, by = 0u, intr = 0u, fwd = 0u, tcp = 0u;
    uint32_t r_lo = 0u, r_hi = 0u, r_meta = 0u;
    bool reply = false;
    if (m) {
      const uint32_t src = c.src[i], dst = c.dst[i], ports = c.ports[i], proto = c.proto[i];
      const uint32_t sp = ports >> 16, dp = ports & 0xFFFFu;
      fwd = (src < dst || (src == dst && sp <= dp)) ? 1u : 0u;
      const uint32_t key[4] = {fwd ? src : dst, fwd ? dst : src,
                               fwd ? (sp << 16) | dp : (dp << 16) | sp, proto};
      lo = rt::hash_keys(key, 4, c.seed * 2u + 0xC7u);
      hi = rt::hash_keys(key, 4, c.seed * 2u + 0xC8u);
      slot = (lo ^ hi) & c.slot_mask;
      tcp = proto == 6u ? 1u : 0u;
      pk = c.pkts.p ? c.pkts[i] : 1u;
      by = c.bytes[i];
      intr = (c.flags[i] & kInteresting) ? 1u : 0u;
      r_lo = c.keys[2 * (size_t)slot];
      r_hi = c.keys[2 * (size_t)slot + 1];
      r_meta = c.vals[4 * (size_t)slot];
      const bool same = r_lo == lo && r_hi == hi;
      const uint32_t idle = ((c.now & 0xFFFFu) - (r_meta & 0xFFFFu)) & 0xFFFFu;
      const bool expired = idle > (tcp ? kTcpLifetime : kNonTcpLifetime) &&
                           idle <= 0xFFFFu - kSkewSlack;
      reply = same && !expired && ((r_meta >> 30) & 1u) != fwd;
    }
    if (in) {
      const long long B = c.B;
      c.out[i] = 0u;
      c.out[B + i] = reply ? 1u : 0u;
      c.out[2 * B + i] = 0u;
      c.out[3 * B + i] = 0u;
    }

    // Merge the lanes of one connection; the lowest lane leads.
    const unsigned long long k = m ? ((unsigned long long)lo << 32) | hi : kEmpty;
    const uint32_t peers = __match_any_sync(kFull, k);
    uint32_t s_pk = pk, s_by = by, s_int = intr;
    if (__any_sync(kFull, peers != (1u << lane))) {
      s_pk = s_by = s_int = 0u;
      for (int l = 0; l < 32; ++l) {
        const uint32_t vp = __shfl_sync(kFull, pk, l), vb = __shfl_sync(kFull, by, l),
                       vi = __shfl_sync(kFull, intr, l);
        if ((peers >> l) & 1u) {
          s_pk += vp;
          s_by += vb;
          s_int |= vi;
        }
      }
    }
    // Rows rise with the lane, so the connection's last row here is its
    // highest lane.
    const int hl = 31 - __clz(peers);
    const uint32_t last = ((uint32_t)(base + hl) << 1) | __shfl_sync(kFull, fwd, hl);
    if (!m || __ffs(peers) - 1 != lane) continue;

    uint32_t e = hi & c.ent_mask;
    for (;;) {
      unsigned long long cur = c.ent_key[e];
      if (cur == k) break;
      if (cur == kEmpty) {
        cur = atomicCAS(c.ent_key + e, kEmpty, k);
        if (cur == kEmpty) {
          uint32_t* r = c.ent_res + 6 * (size_t)e;
          r[0] = r_lo;
          r[1] = r_hi;
          r[2] = r_meta;
          r[3] = c.vals[4 * (size_t)slot + 1];
          r[4] = c.vals[4 * (size_t)slot + 2];
          r[5] = tcp;
          break;
        }
        if (cur == k) break;
      }
      e = (e + 1u) & c.ent_mask;
    }
    uint32_t* a = c.ent_acc + 4 * (size_t)e;
    if (s_pk) atomicAdd(a, s_pk);
    if (s_by) atomicAdd(a + 1, s_by);
    if (s_int) atomicOr(a + 2, 1u);
    atomicMax(a + 3, last);
    if (c.winner[slot] < k) atomicMax(c.winner + slot, k);
  }
}

__global__ void ct_entries(Ct c) {
  const long long n = (long long)c.ent_mask + 1;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const unsigned long long k = c.ent_key[e];
    if (k == kEmpty) continue;
    const uint32_t lo = (uint32_t)(k >> 32), hi = (uint32_t)k;
    const uint32_t slot = (lo ^ hi) & c.slot_mask;
    const uint4 acc = reinterpret_cast<const uint4*>(c.ent_acc)[e];
    const uint32_t* r = c.ent_res + 6 * (size_t)e;
    const uint32_t meta = r[2], tcp = r[5];
    const long long row = acc.w >> 1;
    const uint32_t fwd = acc.w & 1u;

    const bool same = r[0] == lo && r[1] == hi;
    const uint32_t now16 = c.now & 0xFFFFu, now14 = c.now & 0x3FFFu;
    const uint32_t rep14 = (meta >> 16) & 0x3FFFu, init_a = (meta >> 30) & 1u;
    const uint32_t idle = (now16 - (meta & 0xFFFFu)) & 0xFFFFu;
    const bool expired = idle > (tcp ? kTcpLifetime : kNonTcpLifetime) &&
                         idle <= 0xFFFFu - kSkewSlack;
    const bool is_new = !same || expired;
    const uint32_t rep_delta = (now14 - rep14) & 0x3FFFu;
    const bool interval_up = rep_delta >= kInterval && rep_delta <= 0x3FFFu - kSkewSlack;
    const bool report = acc.z != 0u || is_new || (same && interval_up);
    const uint32_t tot_pk = (is_new ? 0u : r[3]) + acc.x;
    const uint32_t tot_by = (is_new ? 0u : r[4]) + acc.y;
    if (report) {
      c.out[row] = 1u;
      c.out[2 * c.B + row] = tot_pk;
      c.out[3 * c.B + row] = tot_by;
    }
    if (c.winner[slot] == k) {
      c.keys[2 * (size_t)slot] = lo;
      c.keys[2 * (size_t)slot + 1] = hi;
      const uint4 v = make_uint4(
          now16 | ((report ? now14 : rep14) << 16) | ((is_new ? fwd : init_a) << 30) | (tcp << 31),
          report ? 0u : tot_pk, report ? 0u : tot_by, 0u);
      reinterpret_cast<uint4*>(c.vals)[slot] = v;
    }
    c.ent_key[e] = kEmpty;
    reinterpret_cast<uint4*>(c.ent_acc)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
}

inline Col col(const void* p, long long s) { return Col{static_cast<const uint32_t*>(p), s}; }

}  // namespace

extern "C" int conntrack(void* keys, void* vals, int n_slots, unsigned int seed,
                         const void* src, long long s_src, const void* dst, long long s_dst,
                         const void* ports, long long s_ports, const void* proto,
                         long long s_proto, const void* flags, long long s_flags,
                         const void* bytes, long long s_bytes, const void* mask,
                         long long s_mask, const void* pkts, long long s_pkts, long long B,
                         unsigned int now, void* ent_key, void* ent_acc, void* ent_res,
                         int ent_slots, void* winner, void* out, void* stream) {
  Ct c;
  c.keys = static_cast<uint32_t*>(keys);
  c.vals = static_cast<uint32_t*>(vals);
  c.slot_mask = (uint32_t)n_slots - 1u;
  c.seed = seed;
  c.src = col(src, s_src);
  c.dst = col(dst, s_dst);
  c.ports = col(ports, s_ports);
  c.proto = col(proto, s_proto);
  c.flags = col(flags, s_flags);
  c.bytes = col(bytes, s_bytes);
  c.mask = col(mask, s_mask);
  c.pkts = col(pkts, s_pkts);
  c.B = B;
  c.now = now;
  c.ent_key = static_cast<unsigned long long*>(ent_key);
  c.ent_acc = static_cast<uint32_t*>(ent_acc);
  c.ent_res = static_cast<uint32_t*>(ent_res);
  c.ent_mask = (uint32_t)ent_slots - 1u;
  c.winner = static_cast<unsigned long long*>(winner);
  c.out = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(winner, 0, sizeof(unsigned long long) * (size_t)n_slots, st);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  ct_rows<<<rt::grid_for(B, threads), threads, 0, st>>>(c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ct_entries<<<rt::grid_for(ent_slots, threads), threads, 0, st>>>(c);
  return (int)cudaGetLastError();
}
