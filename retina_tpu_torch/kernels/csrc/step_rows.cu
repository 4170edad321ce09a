// K1: the per-event body of the fused pipeline step, outside the sketches.
//
// Replaces retina_tpu/models/pipeline.py:326-470 and :600-660 (column
// decode, Horvitz-Thompson rescale, event masks, IPs-of-interest filter,
// the dense counter rectangles, node counters and totals) and
// models/identity.py:93 IdentityMap.lookup (the two-gather cuckoo IP ->
// pod join). The plain version is models/pipeline.py step_rows_plain.
//
// Bound on the H100: bytes. Each event reads its 64-byte record once and
// writes the 13 u32 lanes of per-event scratch that K2-K4 read (52 bytes);
// the identity table (S, 2) is 512 KiB and stays in L2. Then atomics: at
// most 2 + 2 + 8 + 2 + 1 u32 atomicAdds per event into the rectangles,
// spread over P pods.
//
// Design: one thread per event in a grid-stride loop; the record is read
// as four 16-byte vectors. Every rectangle row is one atomicAdd per
// non-zero counter (zero weights make no atomic). The ten masked sums
// (totals[0:6], node_counters) are reduced in registers across the
// thread's events, then across the warp by __reduce_add_sync and across
// the block in shared memory, so each block makes one atomicAdd per sum:
// a few thousand atomics on ten hot words instead of two million. u32
// sums wrap mod 2^32, as the reference's do, and wrapping addition does
// not depend on the order. The scratch lanes are written column-major,
// (13, B), so every later kernel reads them coalesced.
#include "hash.cuh"

namespace {

// Scratch lanes; the order is SCRATCH in retina_tpu_torch/models/pipeline.py.
enum Lane {
  kSrcPod, kDstPod, kProto, kDport, kFlowW, kSvcW, kDnsW, kEntW,
  kMask, kIsDrop, kReason, kPodGrp, kPodMask, kLanes
};
constexpr int kSums = 10;  // totals[0:6], node_counters (ing pkts, ing bytes, eg pkts, eg bytes)

struct Step {
  const uint4* rec;        // (B, 16) u32 records as 4 x uint4 per row
  long long B;
  uint32_t n_valid;
  uint32_t sample_k;
  const uint32_t* ident;   // (S, 2) [ip, pod]
  uint32_t ident_mask;
  uint32_t ident_seed;
  const uint32_t* filt;    // (S', 2) or null
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
};

__device__ __forceinline__ uint32_t lookup(const uint32_t* t, uint32_t mask, uint32_t seed,
                                           uint32_t ip) {
  const uint32_t h1 = rt::hash_step(rt::hash_init(0x1DE47u + seed), ip) & mask;
  const uint32_t h2 = rt::hash_step(rt::hash_init(0xB0A711u + seed), ip) & mask;
  const uint32_t out = t[2 * h1] == ip ? t[2 * h1 + 1] : 0u;
  return t[2 * h2] == ip ? t[2 * h2 + 1] : out;
}

__device__ __forceinline__ void add_nz(uint32_t* p, uint32_t v) {
  if (v) atomicAdd(p, v);
}

__global__ void step_rows_kernel(Step s) {
  uint32_t acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0u;

  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < s.B;
       i += (long long)gridDim.x * blockDim.x) {
    const uint4 q0 = s.rec[4 * i], q1 = s.rec[4 * i + 1], q2 = s.rec[4 * i + 2],
                q3 = s.rec[4 * i + 3];
    // Lanes: q0 = TS_LO TS_HI SRC_IP DST_IP; q1 = PORTS META BYTES PACKETS;
    // q2 = VERDICT DROP_REASON TSVAL TSECR; q3 = DNS DNS_QHASH EVENT_TYPE IFINDEX.
    const uint32_t src_ip = q0.z, dst_ip = q0.w, ports = q1.x, meta = q1.y;
    uint32_t bytes = q1.z, pk = q1.w;
    const uint32_t verdict = q2.x, tsval = q2.z, tsecr = q2.w, dns = q3.x, ev = q3.z;
    const uint32_t proto = meta >> 24, flags = (meta >> 16) & 0xFFu;
    const bool ingress = ((meta >> 4) & 0xFu) == 1u;  // DIR_INGRESS
    bool m = (unsigned long long)i < s.n_valid;

    // Horvitz-Thompson rescale of sampled rows (u32 saturating multiply).
    if (s.exempt_packets > 0u) {
      const bool prio = s.prio_mask != 0u && (((src_ip & s.prio_mask) == s.prio_match) ||
                                              ((dst_ip & s.prio_mask) == s.prio_match));
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
    const bool is_fwd = m && verdict == 1u;   // VERDICT_FORWARDED
    const bool is_drop = m && verdict == 2u;  // VERDICT_DROPPED
    const bool is_req = m && ev == 2u;        // EV_DNS_REQ
    const bool is_resp = m && ev == 3u;       // EV_DNS_RESP
    const bool is_retrans = m && ev == 4u;    // EV_TCP_RETRANS

    const uint32_t local = ingress ? dp : sp;
    const uint32_t lc = local < s.P - 1u ? local : s.P - 1u;
    const uint32_t w_pk = is_fwd ? pk : 0u, w_by = is_fwd ? bytes : 0u;

    const uint32_t fi = lc * 2u + (ingress ? 0u : 1u);
    add_nz(s.pod_forward + 2 * (size_t)fi, w_pk);
    add_nz(s.pod_forward + 2 * (size_t)fi + 1, w_by);
    if (is_drop) {
      const uint32_t di = lc * s.R + reason;
      if ((unsigned long long)di < (unsigned long long)s.P * s.R) {
        add_nz(s.pod_drop + 2 * (size_t)di, pk);
        add_nz(s.pod_drop + 2 * (size_t)di + 1, bytes);
      }
    }
    if (m && proto == 6u && pk) {  // PROTO_TCP
      for (int bit = 0; bit < 8; ++bit)
        if ((flags >> bit) & 1u) atomicAdd(s.pod_tcpflags + 8 * (size_t)lc + bit, pk);
    }
    const uint32_t w_req = is_req ? pk : 0u, w_resp = is_resp ? pk : 0u;
    if (is_req || is_resp) {
      const uint32_t qt = (dns >> 16) < s.Q - 1u ? (dns >> 16) : s.Q - 1u;
      const uint32_t qi = lc * s.Q + qt;
      if ((unsigned long long)qi < (unsigned long long)s.P * s.Q) {
        add_nz(s.pod_dns + 2 * (size_t)qi, w_req);
        add_nz(s.pod_dns + 2 * (size_t)qi + 1, w_resp);
      }
    }
    const uint32_t w_ret = is_retrans ? pk : 0u;
    add_nz(s.pod_retrans + lc, w_ret);

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
  }

  __shared__ uint32_t part[kSums][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    const uint32_t v = __reduce_add_sync(0xFFFFFFFFu, acc[j]);
    if (lane == 0) part[j][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    uint32_t v = 0u;
    for (int k = 0; k < n_warps; ++k) v += part[threadIdx.x][k];
    if (v) {
      atomicAdd(s.sums + threadIdx.x, v);
      if (threadIdx.x < 6) atomicAdd(s.totals + threadIdx.x, v);
      else atomicAdd(s.node_counters + (threadIdx.x - 6), v);
    }
  }
}

}  // namespace

extern "C" int step_rows(const void* rec, long long B, unsigned int n_valid, unsigned int sample_k,
                         const void* ident, int ident_slots, unsigned int ident_seed,
                         const void* filt, int filt_slots, unsigned int filt_seed,
                         void* pod_forward, void* pod_drop, void* pod_tcpflags, void* pod_dns,
                         void* pod_retrans, void* node_counters, void* totals, void* sums,
                         void* scratch, int P, int R, int Q, int bypass_filter,
                         int identity_implies_interest, unsigned int exempt_packets,
                         unsigned int prio_mask, unsigned int prio_match, void* stream) {
  Step s;
  s.rec = static_cast<const uint4*>(rec);
  s.B = B;
  s.n_valid = n_valid;
  s.sample_k = sample_k;
  s.ident = static_cast<const uint32_t*>(ident);
  s.ident_mask = (uint32_t)ident_slots - 1u;
  s.ident_seed = ident_seed;
  s.filt = static_cast<const uint32_t*>(filt);
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
  const int threads = 256;
  step_rows_kernel<<<rt::grid_for(B, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(s);
  return (int)cudaGetLastError();
}
