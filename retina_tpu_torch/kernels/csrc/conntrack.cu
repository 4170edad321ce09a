// K5: connection tracking and report sampling over one batch.
//
// Replaces retina_tpu/ops/conntrack.py:123-270 ConntrackTable.process (the
// direction-free fingerprint, a two-key sort of the batch, a segmented scan,
// the report decision, two row scatters into the table and the scatter back
// to batch order). The plain version is ops/conntrack.py process_plain,
// whose module docstring states the rules both follow.
//
// Bound on the H100: bytes. Each event reads the first 32-byte sector of
// its record (src, dst, ports) and four u32 lanes (proto, bytes, mask,
// packets: 16 bytes), and writes four output lanes (16 bytes); the table
// (2^18 x 24 bytes, 6 MiB) stays in L2. What kept the first design (a
// warp merge, then one thread a warp-distinct key) at ~19x that bound is
// the traffic the batch's connections make: on Zipf traffic one connection
// carries ~19% of a batch and ~23 of a warp's 32 rows are distinct keys.
//
// Design: a connection's rows are summed on the SM before anything touches
// device memory, so device memory sees one insert per distinct connection
// of a 2048-row chunk (~680 of them on bench traffic), not one per row.
//   Phase A (ct_rows, persistent, 512 threads, a chunk at a time):
//     (1) each masked row fingerprints its connection and adds into an
//         open-addressed table of 2R entries in shared memory keyed by the
//         full 64-bit key: packets and bytes by atomicAdd (u32, wrapping as
//         the reference's scan does, in any order), "interesting" by
//         atomicOr, (row << 1 | src_is_a) by atomicMax, which yields the
//         connection's last row in the chunk and that row's direction;
//     (2) each distinct key of the chunk reads the resident row of its slot
//         (as it was before the batch: phase A writes no table), works out
//         which direction of it replies, and makes one insert into the
//         batch's connection table: 2B key slots of 32 bytes (the 64-bit
//         key, claimed by atomicCAS, beside four accumulators). The chunk
//         that claims a connection's key slot writes the connection's
//         32-byte record whole, in its chunk's region of R records (a
//         shared counter: a chunk has at most R connections): its sums with
//         the resident accumulators added unless the connection is new, its
//         flags, last row, key, resident meta word and key slot; it also
//         atomicMax-es the key into the table slot's winner word. Every
//         later chunk of the connection adds its sums into the key slot's
//         accumulators (3 atomics, one 32-byte sector with the key it just
//         read), so no chunk waits for another;
//     (3) each row writes its four output lanes (is_reply from (2)).
//   Phase B (ct_entries, a block a chunk) walks the records its chunk
//   created, ~133k in all on bench traffic, not the 2B key slots: it adds
//   the key slot's accumulators to the record, decides the report, writes
//   the report lanes at the last row, writes the table row where the key is
//   the slot's winner (the largest (fp_lo, fp_hi) of the slot, unsigned),
//   and frees the key slot for the next batch (a record is written whole
//   before it is read, so none is cleared). The winner words are cleared by
//   cudaMemsetAsync before phase A. Scratch: 2B x 32 bytes of key slots,
//   B x 32 bytes of records (B rounded up to R), 4 bytes of record count a
//   chunk, S x 8 bytes of winner words; a batch touches one sector of each
//   of the first two a connection.
// Measured on the H100 and left out: a dense record index handed out by a
// counter and published to later chunks, who waited for it and added into
// the record (15% slower: the wait and the release/acquire pair).
// The key ~0 (fp_lo = fp_hi = 0xFFFFFFFF) marks a free slot and cannot be
// tracked, as in the first design (one key in 2^64).
#include "hash.cuh"

namespace {

constexpr unsigned long long kEmpty = ~0ull;
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr uint32_t kTcpLifetime = 360u, kNonTcpLifetime = 60u;
constexpr uint32_t kInterval = 30u, kSkewSlack = 256u;
constexpr uint32_t kInteresting = 0x7u;  // TCP_FIN | TCP_SYN | TCP_RST

constexpr int kThreads = 512;
constexpr int kChunk = 2048;              // R, rows a chunk
constexpr int kRows = kChunk / kThreads;  // rows a thread takes a chunk
constexpr int kTable = 2 * kChunk;        // shared table entries
constexpr int kRecWords = 8;              // one record: 32 bytes
constexpr int kEntWords = 8;              // one key slot: 32 bytes
constexpr int kEntryThreads = 128;

// Record words: [packets, bytes, flags, last, fp_lo, fp_hi, resident meta,
// key slot]; the flags:
constexpr uint32_t kIntr = 1u, kNew = 2u, kSame = 4u, kTcp = 8u;
// Shared flag bits of a chunk's key: interesting, TCP.
constexpr uint32_t kSIntr = 1u, kSTcp = 2u;

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
  uint32_t* gent;  // (G, kEntWords) key slots: [packets, bytes, interesting, last, key, pad]
  uint32_t gmask;
  uint32_t* rec;               // (chunks * R, kRecWords) records, R a chunk
  uint32_t* count;             // (chunks,) records each chunk created
  unsigned long long* winner;  // (S,) largest key of each slot this batch
  uint32_t* out;               // (4, B) [report, is_reply, report_packets, report_bytes]
};

__host__ __device__ constexpr int rows_smem() {
  return kTable * 8 + 4 * kTable * 4 + kChunk * 4;  // 104 KiB
}

// The 64-bit key of key slot g (words 4 and 5 of its entry).
__device__ __forceinline__ unsigned long long* slot_key(const Ct& c, uint32_t g) {
  return reinterpret_cast<unsigned long long*>(c.gent + (size_t)kEntWords * g + 4);
}

__device__ __forceinline__ bool expired(uint32_t meta, uint32_t now, bool tcp) {
  const uint32_t idle = ((now & 0xFFFFu) - (meta & 0xFFFFu)) & 0xFFFFu;
  return idle > (tcp ? kTcpLifetime : kNonTcpLifetime) && idle <= 0xFFFFu - kSkewSlack;
}

__global__ void __launch_bounds__(kThreads, 2) ct_rows(const __grid_constant__ Ct c) {
  extern __shared__ unsigned long long smem[];
  __shared__ uint32_t n_distinct, n_first;
  unsigned long long* skey = smem;                         // kTable keys, kEmpty if free
  uint32_t* spk = reinterpret_cast<uint32_t*>(skey + kTable);  // kTable packet sums
  uint32_t* sby = spk + kTable;                            // kTable byte sums
  uint32_t* slast = sby + kTable;                          // kTable (row in chunk) << 1 | fwd
  uint32_t* sflag = slast + kTable;  // kTable kSIntr | kSTcp; then the reply bits
  uint32_t* distinct = sflag + kTable;                     // kChunk claimed entries
  const long long n_chunks = (c.B + kChunk - 1) / kChunk;

  for (int t = threadIdx.x; t < kTable; t += kThreads) {
    skey[t] = kEmpty;
    spk[t] = sby[t] = slast[t] = sflag[t] = 0u;
  }
  if (threadIdx.x == 0) n_distinct = n_first = 0u;
  __syncthreads();

  for (long long chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const long long base = chunk * kChunk;
    // (1) Each masked row adds into its connection's shared entry.
    uint32_t at[kRows], fw[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t j = threadIdx.x + r * kThreads;
      const long long i = base + j;
      at[r] = kNone;
      fw[r] = 0u;
      if (i >= c.B || c.mask[i] == 0u) continue;
      const uint32_t src = c.src[i], dst = c.dst[i], ports = c.ports[i], proto = c.proto[i];
      const uint32_t sp = ports >> 16, dp = ports & 0xFFFFu;
      const uint32_t fwd = (src < dst || (src == dst && sp <= dp)) ? 1u : 0u;
      const uint32_t key[4] = {fwd ? src : dst, fwd ? dst : src,
                               fwd ? (sp << 16) | dp : (dp << 16) | sp, proto};
      const uint32_t lo = rt::hash_keys(key, 4, c.seed * 2u + 0xC7u);
      const uint32_t hi = rt::hash_keys(key, 4, c.seed * 2u + 0xC8u);
      const unsigned long long k = ((unsigned long long)lo << 32) | hi;
      uint32_t t = lo & (kTable - 1);
      for (;;) {
        unsigned long long cur = *reinterpret_cast<volatile unsigned long long*>(skey + t);
        if (cur == kEmpty) {
          cur = atomicCAS(skey + t, kEmpty, k);
          if (cur == kEmpty) {
            distinct[atomicAdd(&n_distinct, 1u)] = t;
            if (proto == 6u) atomicOr(sflag + t, kSTcp);
            break;
          }
        }
        if (cur == k) break;
        t = (t + 1u) & (kTable - 1);
      }
      const uint32_t pk = c.pkts.p ? c.pkts[i] : 1u, by = c.bytes[i];
      if (pk) atomicAdd(spk + t, pk);
      if (by) atomicAdd(sby + t, by);
      if (c.flags[i] & kInteresting) atomicOr(sflag + t, kSIntr);
      atomicMax(slast + t, (j << 1) | fwd);
      at[r] = t;
      fw[r] = fwd;
    }
    __syncthreads();

    // (2) One insert per distinct key of the chunk.
    const uint32_t nd = n_distinct;
    for (uint32_t d = threadIdx.x; d < nd; d += kThreads) {
      const uint32_t t = distinct[d];
      const unsigned long long k = skey[t];
      const uint32_t lo = (uint32_t)(k >> 32), hi = (uint32_t)k;
      const uint32_t slot = (lo ^ hi) & c.slot_mask;
      // The resident row, read before the probe so that the two overlap.
      const uint2 rk = reinterpret_cast<const uint2*>(c.keys)[slot];
      const uint4 rv = reinterpret_cast<const uint4*>(c.vals)[slot];
      uint32_t g = hi & c.gmask;
      bool first = false;
      for (;;) {
        unsigned long long* sk = slot_key(c, g);
        unsigned long long cur = *reinterpret_cast<volatile unsigned long long*>(sk);
        if (cur == kEmpty) {
          cur = atomicCAS(sk, kEmpty, k);
          if (cur == kEmpty) {
            first = true;
            break;
          }
        }
        if (cur == k) break;
        g = (g + 1u) & c.gmask;
      }
      const uint32_t fl = sflag[t];
      const bool tcp = fl & kSTcp;
      const bool same = rk.x == lo && rk.y == hi;
      const bool exp = expired(rv.x, c.now, tcp);
      const bool is_new = !same || exp;
      const uint32_t pk = spk[t], by = sby[t], sl = slast[t];
      const uint32_t last = ((uint32_t)(base + (sl >> 1)) << 1) | (sl & 1u);
      if (first) {
        const uint32_t idx = (uint32_t)base + atomicAdd(&n_first, 1u);
        uint4* r = reinterpret_cast<uint4*>(c.rec + (size_t)kRecWords * idx);
        r[0] = make_uint4((is_new ? 0u : rv.y) + pk, (is_new ? 0u : rv.z) + by,
                          ((fl & kSIntr) ? kIntr : 0u) | (is_new ? kNew : 0u) |
                              (same ? kSame : 0u) | (tcp ? kTcp : 0u),
                          last);
        r[1] = make_uint4(lo, hi, rv.x, g);
        if (__ldcg(c.winner + slot) < k) atomicMax(c.winner + slot, k);
      } else {
        // Another chunk's rows: summed in the key slot, which phase B adds
        // to the record.
        uint32_t* e = c.gent + (size_t)kEntWords * g;
        if (pk) atomicAdd(e, pk);
        if (by) atomicAdd(e + 1, by);
        if (fl & kSIntr) atomicOr(e + 2, kIntr);
        atomicMax(e + 3, last);
      }
      // A row of this connection replies where the connection is resident
      // and live and the row's direction is not the one that opened it:
      // bit f is set where a row with src_is_a == f replies.
      sflag[t] = (same && !exp) ? (((rv.x >> 30) & 1u) ? 1u : 2u) : 0u;
    }
    __syncthreads();
    if (threadIdx.x == 0) c.count[chunk] = n_first;

    // (3) The rows' output lanes; phase B sets the report lanes.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = base + threadIdx.x + r * kThreads;
      if (i >= c.B) continue;
      c.out[i] = 0u;
      c.out[c.B + i] = at[r] == kNone ? 0u : (sflag[at[r]] >> fw[r]) & 1u;
      c.out[2 * c.B + i] = 0u;
      c.out[3 * c.B + i] = 0u;
    }
    __syncthreads();
    for (uint32_t d = threadIdx.x; d < nd; d += kThreads) {
      const uint32_t t = distinct[d];
      skey[t] = kEmpty;
      spk[t] = sby[t] = slast[t] = sflag[t] = 0u;
    }
    if (threadIdx.x == 0) n_distinct = n_first = 0u;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kEntryThreads) ct_entries(const __grid_constant__ Ct c) {
  const uint32_t n = c.count[blockIdx.x];
  const uint32_t now16 = c.now & 0xFFFFu, now14 = c.now & 0x3FFFu;
  for (uint32_t l = threadIdx.x; l < n; l += kEntryThreads) {
    const uint4* r =
        reinterpret_cast<const uint4*>(c.rec + (size_t)kRecWords * (blockIdx.x * kChunk + l));
    const uint4 b = r[1];
    uint4* e = reinterpret_cast<uint4*>(c.gent + (size_t)kEntWords * b.w);
    uint4 a = r[0];
    const uint4 more = e[0];  // the rows of later chunks
    a.x += more.x;
    a.y += more.y;
    a.z |= more.z;
    a.w = max(a.w, more.w);
    const uint32_t lo = b.x, hi = b.y, meta = b.z;
    const bool is_new = a.z & kNew, same = a.z & kSame;
    const uint32_t tcp = (a.z & kTcp) ? 1u : 0u;
    const uint32_t rep14 = (meta >> 16) & 0x3FFFu, init_a = (meta >> 30) & 1u;
    const uint32_t rep_delta = (now14 - rep14) & 0x3FFFu;
    const bool interval_up = rep_delta >= kInterval && rep_delta <= 0x3FFFu - kSkewSlack;
    const bool report = (a.z & kIntr) || is_new || (same && interval_up);
    const long long row = a.w >> 1;
    const uint32_t fwd = a.w & 1u;
    if (report) {
      c.out[row] = 1u;
      c.out[2 * c.B + row] = a.x;
      c.out[3 * c.B + row] = a.y;
    }
    const uint32_t slot = (lo ^ hi) & c.slot_mask;
    if (c.winner[slot] == (((unsigned long long)lo << 32) | hi)) {
      reinterpret_cast<uint2*>(c.keys)[slot] = make_uint2(lo, hi);
      reinterpret_cast<uint4*>(c.vals)[slot] = make_uint4(
          now16 | ((report ? now14 : rep14) << 16) | ((is_new ? fwd : init_a) << 30) | (tcp << 31),
          report ? 0u : a.x, report ? 0u : a.y, 0u);
    }
    e[0] = make_uint4(0u, 0u, 0u, 0u);
    e[1] = make_uint4(kNone, kNone, 0u, 0u);  // the key ~0: free
  }
}

inline Col col(const void* p, long long s) { return Col{static_cast<const uint32_t*>(p), s}; }

// Resident ct_rows blocks on the whole card, per device, found once.
int rows_grid() {
  static int cache[16];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 16) dev = 15;
  if (cache[dev] == 0) {
    int n = 0, p = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(ct_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, rows_smem());
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, ct_rows, kThreads, rows_smem());
    cache[dev] = (n > 0 ? n : 1) * (p > 0 ? p : 1);
  }
  return cache[dev];
}

}  // namespace

// One batch of B rows against a table of n_slots slots. Scratch: gent
// (key_slots >= 2B, 8) u32 key slots, free (zero accumulators, key ~0;
// phase B leaves them so), rec (ceil(B / R) * R, 8) u32, count
// (ceil(B / R),) u32, winner (n_slots,) u64 (cleared here).
extern "C" int conntrack(void* keys, void* vals, int n_slots, unsigned int seed,
                         const void* src, long long s_src, const void* dst, long long s_dst,
                         const void* ports, long long s_ports, const void* proto,
                         long long s_proto, const void* flags, long long s_flags,
                         const void* bytes, long long s_bytes, const void* mask,
                         long long s_mask, const void* pkts, long long s_pkts, long long B,
                         unsigned int now, void* gent, int key_slots, void* rec,
                         void* count, void* winner, void* out, void* stream) {
  if (B <= 0) return B == 0 ? 0 : (int)cudaErrorInvalidValue;
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
  c.gent = static_cast<uint32_t*>(gent);
  c.gmask = (uint32_t)key_slots - 1u;
  c.rec = static_cast<uint32_t*>(rec);
  c.count = static_cast<uint32_t*>(count);
  c.winner = static_cast<unsigned long long*>(winner);
  c.out = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(winner, 0, sizeof(unsigned long long) * (size_t)n_slots, st);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = rows_grid(), n_chunks = (B + kChunk - 1) / kChunk;
  ct_rows<<<(int)(blocks < n_chunks ? blocks : n_chunks), kThreads, rows_smem(), st>>>(c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ct_entries<<<(int)n_chunks, kEntryThreads, 0, st>>>(c);
  return (int)cudaGetLastError();
}
