// K1: the per-event body of the fused pipeline step, outside the sketches,
// and the probe scan of the step's apiserver latency match (K14).
//
// Replaces retina_tpu/models/pipeline.py:326-470 and :600-660 (column
// decode, Horvitz-Thompson rescale, event masks, IPs-of-interest filter,
// the dense counter rectangles, node counters and totals),
// models/identity.py:93 IdentityMap.lookup (the two-gather cuckoo IP ->
// pod join) and the row scan of the latency block, :565-596 (its finish is
// csrc/latency.cu). The plain versions are models/pipeline.py
// step_rows_plain and latency_update_plain.
//
// Bound on the H100: bytes. Each event reads its 64-byte record once and
// writes the 15 u32 lanes of per-event scratch that K2-K6 read (60 bytes);
// the identity table (S, 2) is 512 KiB and the rectangles (1.4 MiB at
// P = 4096) stay in L2. What held the first design (a thread a row, every
// rectangle count one global atomicAdd: up to 2 forward, 2 drop, 8 TCP
// flags, 2 DNS and 1 retrans a row) at ~6x that bound was where the
// atomics went: every count of a row goes to the words of its local pod,
// and on Zipf traffic one flow carries ~19% of a batch, so hundreds of
// thousands of atomics a batch queued on a few L2 addresses.
//
// Design: a row's counts are summed on the SM before anything touches the
// rectangles. A persistent grid of 256-thread blocks walks 512-row chunks
// (two rows a thread). Each row adds its 13 pod counts (forward packets
// and bytes of both directions, 8 TCP flags, retrans) into the slot of its
// local pod in an open-addressed table of kSlots slots in shared memory
// (a u32 key, 13 u32 accumulators: 56 KiB with the slot list), and its
// drop and DNS counts into slots keyed by (pod, reason) and (pod, qtype)
// (2 accumulators each), one key space: pod < P, then P + pod * R +
// reason, then P + P * R + pod * Q + qtype. A warp whose rows all add
// into one pod sums them by __reduce_add_sync and makes one set of shared
// atomics. At the chunk's end each distinct key makes one global atomicAdd
// per non-zero accumulator and frees its slot, so a hot pod's words take
// one atomic a chunk, not one a row. A key that finds no free slot within
// kMaxProbe probes (a chunk holds up to 3 keys a row) adds its row's
// counts to the rectangles directly, in this kernel: the overflow rule of
// K2. The counts are u32 sums that wrap mod 2^32, and wrapping addition
// does not depend on the order, so the result is bit-equal to the plain
// version's whatever the grouping. The ten masked sums (totals[0:6],
// node_counters) are reduced in registers, across the warp and the block,
// one atomicAdd a block each. The scratch lanes are written column-major,
// (15, B), so every later kernel reads them coalesced.
//
// The latency scan (with a probe list): each row whose final mask is set
// and that sends to the apiserver (TSval > 0) or is its reply (TSecr > 0)
// appends one 16-byte entry (row | flags, both fingerprints, send time) to
// the list through one atomic a warp (ballot, popc, shfl); finish_kernel
// in latency.cu applies the match's rules to the list. The row's lanes are
// in registers already, so the scan costs no read of its own.
#include "hash.cuh"

namespace {

// Scratch lanes; the order is SCRATCH in retina_tpu_torch/kernels/ops.py.
enum Lane {
  kSrcPod, kDstPod, kProto, kDport, kFlowW, kSvcW, kDnsW, kEntW,
  kMask, kIsDrop, kReason, kPodGrp, kPodMask, kBytes, kIsPrio, kLanes
};
constexpr int kSums = 10;  // totals[0:6], node_counters (ing pkts, ing bytes, eg pkts, eg bytes)

constexpr int kThreads = 256;
constexpr int kChunk = 512;               // rows a chunk (STEP_CHUNK in ops.py)
constexpr int kRows = kChunk / kThreads;  // rows a thread takes a chunk
constexpr int kSlotBits = 10;
constexpr int kSlots = 1 << kSlotBits;    // shared table slots (STEP_SLOTS in ops.py)
constexpr int kMaxProbe = 32;
// A pod slot's accumulators: forward [ingress pkts, bytes, egress pkts,
// bytes], the 8 TCP flag bits, retrans. A drop or DNS slot uses the first 2.
constexpr int kAcc = 13;
constexpr int kFlag0 = 4, kRetrans = 12;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kFull = 0xFFFFFFFFu;
// The latency list's entry flags and fingerprint seed (as latency.cu's).
constexpr uint32_t kLatSeed = 0x1A7u;
constexpr uint32_t kSend = 1u << 30;
constexpr uint32_t kReply = 1u << 31;

struct Step {
  const uint4* rec;        // (B, 16) u32 records as 4 x uint4 per row
  long long B;
  uint32_t n_valid;
  uint32_t sample_k;
  const uint2* ident;      // (S, 2) [ip, pod]
  uint32_t ident_mask;
  uint32_t ident_seed;
  const uint2* filt;       // (S', 2) or null
  uint32_t filt_mask;
  uint32_t filt_seed;
  uint32_t* pod_forward;   // (P, 2, 2)
  uint32_t* pod_drop;      // (P, R, 2)
  uint32_t* pod_tcpflags;  // (P, 8)
  uint32_t* pod_dns;       // (P, Q, 2)
  uint32_t* pod_retrans;   // (P,)
  uint32_t* node_counters; // (2, 2)
  uint32_t* totals;        // (8,)
  uint32_t* sums;          // (10,) this call's sums
  uint32_t* scratch;       // (kLanes, B)
  uint32_t P, R, Q;
  int bypass_filter;
  int identity_implies_interest;
  uint32_t exempt_packets;
  uint32_t prio_mask, prio_match;
  uint32_t api;            // the apiserver's IP
  uint32_t* lat_count;     // the latency list's length, or null: no scan
  uint4* lat_entries;      // (>= B) entries [row | flags, k_out, k_in, send time]
};

__host__ __device__ constexpr int smem_bytes() {
  return kSlots * 4 * (1 + kAcc) + kSlots * 2;  // keys, accumulators, slot list: 58 KiB
}

__device__ __forceinline__ uint32_t lookup(const uint2* t, uint32_t mask, uint32_t seed,
                                           uint32_t ip) {
  const uint2 a = t[rt::hash_step(rt::hash_init(0x1DE47u + seed), ip) & mask];
  const uint2 b = t[rt::hash_step(rt::hash_init(0xB0A711u + seed), ip) & mask];
  const uint32_t out = a.x == ip ? a.y : 0u;
  return b.x == ip ? b.y : out;
}

__device__ __forceinline__ void add_nz(uint32_t* p, uint32_t v) {
  if (v) atomicAdd(p, v);
}

// Global word w of a pod key (k < P) or of a drop or DNS key.
__device__ __forceinline__ uint32_t* word(const Step& s, uint32_t k, int w) {
  if (k < s.P) {
    if (w < kFlag0) return s.pod_forward + 4 * (size_t)k + w;
    if (w < kRetrans) return s.pod_tcpflags + 8 * (size_t)k + (w - kFlag0);
    return s.pod_retrans + k;
  }
  const uint32_t d = k - s.P;
  if (d < s.P * s.R) return s.pod_drop + 2 * (size_t)d + w;
  return s.pod_dns + 2 * (size_t)(d - s.P * s.R) + w;
}

struct Table {
  uint32_t* key;       // kSlots keys, kEmpty if free
  uint32_t* acc;       // kAcc x kSlots accumulators
  uint16_t* distinct;  // the slots this chunk claimed
  uint32_t* n_distinct;
};

// The slot of key k in the chunk's table, claimed if new; -1 when kMaxProbe
// slots in a row hold other keys.
__device__ __forceinline__ int claim(const Table& tb, uint32_t k) {
  uint32_t t = (k * 0x9E3779B1u) >> (32 - kSlotBits);
  for (int p = 0; p < kMaxProbe; ++p) {
    uint32_t cur = *reinterpret_cast<volatile uint32_t*>(tb.key + t);
    if (cur == kEmpty) {
      cur = atomicCAS(tb.key + t, kEmpty, k);
      if (cur == kEmpty) {
        tb.distinct[atomicAdd(tb.n_distinct, 1u)] = (uint16_t)t;
        return (int)t;
      }
    }
    if (cur == k) return (int)t;
    t = (t + 1u) & (kSlots - 1);
  }
  return -1;
}

// Add the first n of v into key k's slot, or into the rectangles (overflow).
template <int n>
__device__ __forceinline__ void add_key(const Step& s, const Table& tb, uint32_t k,
                                        const uint32_t (&v)[n]) {
  const int t = claim(tb, k);
  if (t >= 0) {
#pragma unroll
    for (int w = 0; w < n; ++w)
      if (v[w]) atomicAdd(tb.acc + w * kSlots + t, v[w]);
  } else {
#pragma unroll
    for (int w = 0; w < n; ++w) add_nz(word(s, k, w), v[w]);
  }
}

__global__ void __launch_bounds__(kThreads, 3) step_rows_kernel(const __grid_constant__ Step s) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t n_distinct[2];
  __shared__ uint32_t part[kSums][kThreads / 32];
  const int lane = threadIdx.x & 31;
  Table tb;
  tb.key = smem;
  tb.acc = smem + kSlots;
  tb.distinct = reinterpret_cast<uint16_t*>(smem + kSlots * (1 + kAcc));
  for (int t = threadIdx.x; t < kSlots * (1 + kAcc); t += kThreads)
    smem[t] = t < kSlots ? kEmpty : 0u;
  if (threadIdx.x < 2) n_distinct[threadIdx.x] = 0u;
  __syncthreads();

  uint32_t acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0u;

  const long long n_chunks = (s.B + kChunk - 1) / kChunk;
  int parity = 0;
  for (long long chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x, parity ^= 1) {
    tb.n_distinct = n_distinct + parity;
    for (int r = 0; r < kRows; ++r) {
      const long long i = chunk * kChunk + r * kThreads + threadIdx.x;
      const bool in = i < s.B;
      uint4 q0 = make_uint4(0u, 0u, 0u, 0u), q1 = q0, q2 = q0, q3 = q0;
      if (in) {
        q0 = s.rec[4 * i];
        q1 = s.rec[4 * i + 1];
        q2 = s.rec[4 * i + 2];
        q3 = s.rec[4 * i + 3];
      }
      // Lanes: q0 = TS_LO TS_HI SRC_IP DST_IP; q1 = PORTS META BYTES PACKETS;
      // q2 = VERDICT DROP_REASON TSVAL TSECR; q3 = DNS DNS_QHASH EVENT_TYPE IFINDEX.
      const uint32_t src_ip = q0.z, dst_ip = q0.w, ports = q1.x, meta = q1.y;
      uint32_t bytes = q1.z, pk = q1.w;
      const uint32_t verdict = q2.x, tsval = q2.z, tsecr = q2.w, dns = q3.x, ev = q3.z;
      const uint32_t proto = meta >> 24, flags = (meta >> 16) & 0xFFu;
      const bool ingress = ((meta >> 4) & 0xFu) == 1u;  // DIR_INGRESS
      bool m = in && (unsigned long long)i < s.n_valid;

      // Horvitz-Thompson rescale of sampled rows (u32 saturating multiply).
      const bool prio = s.prio_mask != 0u && (((src_ip & s.prio_mask) == s.prio_match) ||
                                              ((dst_ip & s.prio_mask) == s.prio_match));
      if (s.exempt_packets > 0u) {
        const bool exempt = pk >= s.exempt_packets || (tsval | tsecr) != 0u || prio;
        const uint32_t k = s.sample_k;
        if (k > 1u && !exempt) {
          const uint32_t lim = 0xFFFFFFFFu / k;
          pk = pk > lim ? 0xFFFFFFFFu : pk * k;
          bytes = bytes > lim ? 0xFFFFFFFFu : bytes * k;
        }
      }
      const uint32_t reason = q2.y < s.R - 1u ? q2.y : s.R - 1u;

      // Identity join (masked rows resolve to pod 0).
      const uint32_t sp = m ? lookup(s.ident, s.ident_mask, s.ident_seed, src_ip) : 0u;
      const uint32_t dp = m ? lookup(s.ident, s.ident_mask, s.ident_seed, dst_ip) : 0u;
      if (!s.bypass_filter) {
        bool interest = s.identity_implies_interest && (sp > 0u || dp > 0u);
        if (s.filt)
          interest = interest || lookup(s.filt, s.filt_mask, s.filt_seed, src_ip) > 0u ||
                     lookup(s.filt, s.filt_mask, s.filt_seed, dst_ip) > 0u;
        m = m && interest;
      }

      // The latency scan: every lane of the warp takes part in the ballot.
      if (s.lat_count) {
        uint32_t lf = 0u;
        if (m && dst_ip == s.api && tsval > 0u) lf |= kSend;
        if (m && src_ip == s.api && tsecr > 0u) lf |= kReply;
        const uint32_t act = __ballot_sync(kFull, lf != 0u);
        if (act) {
          const int leader = __ffs(act) - 1;
          uint32_t pos = 0u;
          if (lane == leader) pos = atomicAdd(s.lat_count, (uint32_t)__popc(act));
          pos = __shfl_sync(kFull, pos, leader) + __popc(act & ((1u << lane) - 1u));
          if (lf) {
            const uint32_t h = rt::hash_init(kLatSeed);
            s.lat_entries[pos] = make_uint4(
                (uint32_t)i | lf, rt::hash_step(rt::hash_step(h, dst_ip), tsval),
                rt::hash_step(rt::hash_step(h, src_ip), tsecr), (q0.y << 12) | (q0.x >> 20));
          }
        }
      }

      const bool is_fwd = m && verdict == 1u;   // VERDICT_FORWARDED
      const bool is_drop = m && verdict == 2u;  // VERDICT_DROPPED
      const bool is_req = m && ev == 2u;        // EV_DNS_REQ
      const bool is_resp = m && ev == 3u;       // EV_DNS_RESP
      const bool is_retrans = m && ev == 4u;    // EV_TCP_RETRANS

      const uint32_t local = ingress ? dp : sp;
      const uint32_t lc = local < s.P - 1u ? local : s.P - 1u;
      const uint32_t w_pk = is_fwd ? pk : 0u, w_by = is_fwd ? bytes : 0u;
      const uint32_t w_req = is_req ? pk : 0u, w_resp = is_resp ? pk : 0u;
      const uint32_t w_ret = is_retrans ? pk : 0u;

      // The row's pod counts; a warp of one pod sums them first.
      const uint32_t fl = (m && proto == 6u) ? flags : 0u;  // PROTO_TCP
      uint32_t v[kAcc];
      v[0] = ingress ? w_pk : 0u;
      v[1] = ingress ? w_by : 0u;
      v[2] = ingress ? 0u : w_pk;
      v[3] = ingress ? 0u : w_by;
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) v[kFlag0 + bit] = ((fl >> bit) & 1u) ? pk : 0u;
      v[kRetrans] = w_ret;
      uint32_t any = 0u;
#pragma unroll
      for (int w = 0; w < kAcc; ++w) any |= v[w];
      const uint32_t pod = any ? lc : kEmpty;
      const uint32_t lead = __shfl_sync(kFull, pod, 0);
      if (__all_sync(kFull, pod == lead)) {
        if (lead != kEmpty) {
#pragma unroll
          for (int w = 0; w < kAcc; ++w) v[w] = __reduce_add_sync(kFull, v[w]);
          if (lane == 0) add_key(s, tb, lead, v);
        }
      } else if (pod != kEmpty) {
        add_key(s, tb, pod, v);
      }
      if (is_drop && (pk | bytes)) {
        const uint32_t d[2] = {pk, bytes};
        add_key(s, tb, s.P + lc * s.R + reason, d);
      }
      if (w_req | w_resp) {
        const uint32_t qt = (dns >> 16) < s.Q - 1u ? (dns >> 16) : s.Q - 1u;
        const uint32_t d[2] = {w_req, w_resp};
        add_key(s, tb, s.P + s.P * s.R + lc * s.Q + qt, d);
      }

      acc[0] += m ? pk : 0u;
      acc[1] += w_pk;
      acc[2] += is_drop ? pk : 0u;
      acc[3] += w_req;
      acc[4] += w_resp;
      acc[5] += w_ret;
      acc[6] += ingress ? w_pk : 0u;
      acc[7] += ingress ? w_by : 0u;
      acc[8] += ingress ? 0u : w_pk;
      acc[9] += ingress ? 0u : w_by;

      if (in) {
        uint32_t* o = s.scratch + i;
        const long long B = s.B;
        o[kSrcPod * B] = sp;
        o[kDstPod * B] = dp;
        o[kProto * B] = proto;
        o[kDport * B] = ports & 0xFFFFu;
        o[kFlowW * B] = w_pk;
        o[kSvcW * B] = (sp > 0u && dp > 0u) ? w_pk : 0u;
        o[kDnsW * B] = w_req;
        o[kEntW * B] = m ? pk : 0u;
        o[kMask * B] = m ? 1u : 0u;
        o[kIsDrop * B] = is_drop ? 1u : 0u;
        o[kReason * B] = reason;
        o[kPodGrp * B] = dp < s.P - 1u ? dp : s.P - 1u;
        o[kPodMask * B] = (ingress && m) ? 1u : 0u;
        o[kBytes * B] = m ? bytes : 0u;
        o[kIsPrio * B] = prio ? 1u : 0u;
      }
    }
    __syncthreads();
    // One global atomicAdd per non-zero accumulator of each distinct key;
    // the slots are left free and zero for the next chunk.
    const uint32_t n = n_distinct[parity];
    if (threadIdx.x == 0) n_distinct[parity ^ 1] = 0u;
    for (uint32_t d = threadIdx.x; d < n; d += kThreads) {
      const uint32_t t = tb.distinct[d], k = tb.key[t];
      const int n_acc = k < s.P ? kAcc : 2;
      for (int w = 0; w < n_acc; ++w) {
        const uint32_t a = tb.acc[w * kSlots + t];
        if (a) {
          atomicAdd(word(s, k, w), a);
          tb.acc[w * kSlots + t] = 0u;
        }
      }
      tb.key[t] = kEmpty;
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    const uint32_t v = __reduce_add_sync(kFull, acc[j]);
    if (lane == 0) part[j][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    uint32_t v = 0u;
    for (int k = 0; k < kThreads / 32; ++k) v += part[threadIdx.x][k];
    if (v) {
      atomicAdd(s.sums + threadIdx.x, v);
      if (threadIdx.x < 6) atomicAdd(s.totals + threadIdx.x, v);
      else atomicAdd(s.node_counters + (threadIdx.x - 6), v);
    }
  }
}

// Resident blocks on the whole card, per device, found once.
int rows_grid() {
  static int cache[16];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 16) dev = 15;
  if (cache[dev] == 0) {
    int n = 0, p = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(step_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes());
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, step_rows_kernel, kThreads, smem_bytes());
    cache[dev] = (n > 0 ? n : 1) * (p > 0 ? p : 1);
  }
  return cache[dev];
}

}  // namespace

// lat_count null: no latency scan; else one u32 (the list's length, left
// for finish_kernel to clear) and lat_entries at least B uint4. The caller
// guarantees B > 0, P, R, Q >= 1 and P (1 + R + Q) < 2^32 - 1, and with a
// list B < 2^30.
extern "C" int step_rows(const void* rec, long long B, unsigned int n_valid, unsigned int sample_k,
                         const void* ident, int ident_slots, unsigned int ident_seed,
                         const void* filt, int filt_slots, unsigned int filt_seed,
                         void* pod_forward, void* pod_drop, void* pod_tcpflags, void* pod_dns,
                         void* pod_retrans, void* node_counters, void* totals, void* sums,
                         void* scratch, int P, int R, int Q, int bypass_filter,
                         int identity_implies_interest, unsigned int exempt_packets,
                         unsigned int prio_mask, unsigned int prio_match, unsigned int api,
                         void* lat_count, void* lat_entries, void* stream) {
  if (B <= 0) return B == 0 ? 0 : (int)cudaErrorInvalidValue;
  Step s;
  s.rec = static_cast<const uint4*>(rec);
  s.B = B;
  s.n_valid = n_valid;
  s.sample_k = sample_k;
  s.ident = static_cast<const uint2*>(ident);
  s.ident_mask = (uint32_t)ident_slots - 1u;
  s.ident_seed = ident_seed;
  s.filt = static_cast<const uint2*>(filt);
  s.filt_mask = (uint32_t)filt_slots - 1u;
  s.filt_seed = filt_seed;
  s.pod_forward = static_cast<uint32_t*>(pod_forward);
  s.pod_drop = static_cast<uint32_t*>(pod_drop);
  s.pod_tcpflags = static_cast<uint32_t*>(pod_tcpflags);
  s.pod_dns = static_cast<uint32_t*>(pod_dns);
  s.pod_retrans = static_cast<uint32_t*>(pod_retrans);
  s.node_counters = static_cast<uint32_t*>(node_counters);
  s.totals = static_cast<uint32_t*>(totals);
  s.sums = static_cast<uint32_t*>(sums);
  s.scratch = static_cast<uint32_t*>(scratch);
  s.P = (uint32_t)P;
  s.R = (uint32_t)R;
  s.Q = (uint32_t)Q;
  s.bypass_filter = bypass_filter;
  s.identity_implies_interest = identity_implies_interest;
  s.exempt_packets = exempt_packets;
  s.prio_mask = prio_mask;
  s.prio_match = prio_match;
  s.api = api;
  s.lat_count = static_cast<uint32_t*>(lat_count);
  s.lat_entries = static_cast<uint4*>(lat_entries);
  const long long blocks = rows_grid(), n_chunks = (B + kChunk - 1) / kChunk;
  step_rows_kernel<<<(int)(blocks < n_chunks ? blocks : n_chunks), kThreads, smem_bytes(),
                     static_cast<cudaStream_t>(stream)>>>(s);
  return (int)cudaGetLastError();
}
