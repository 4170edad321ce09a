// K11-K13: the scoring programs of the detector bank.
//
// K11 portscan_kernel replaces retina_tpu/detect/programs.py:51
// detect.portscan; bank_close_kernel (below) replaces :78 detect.dnstunnel
// and :100 detect.synflood with the bank's EWMA step. Their inputs are small
// feature arrays the bank builds on the host at each window close (at most
// 2^16 flow keys, a 64-bin histogram, 9 lanes), so every kernel is one
// launch. The plain versions are retina_tpu_torch/detect/programs.py
// portscan_plain and bank_close_plain (dnstunnel_plain, synflood_plain).
//
// K11 portscan_score: per source hash-group g = (src * 2654435761) mod G
// (u32 arithmetic, so a product with the top bit set wraps as the
// reference's does), an HLL of precision p over the dst port of every key
// of weight > 0, hashed as K3 hashes (hll_update.cu, seed 0xC0FFEE + the
// program's seed); then the estimate of hyperloglog.py:108 in f32.
// Bound: bytes, P * 20 read (a 16-byte key row and a 4-byte weight) and
// G * 4 written. What holds it back is not the bytes but the updates: a
// window's 2^16 keys touch ~1,200 distinct registers, the hottest ~5,000
// times (a heavy dst port hashes to one register of each group), so
// atomics on one address serialize wherever they land.
// Design: one thread-block cluster of S blocks (S <= 16 and at most the
// largest cluster the card can schedule, on S SMs of one GPC). Every block keeps a private copy of all G * 2^p registers in its
// shared memory (32 KB at G = 32, p = 8) and walks 1/S of the rows, 4 rows
// a thread at P = 2^16 and S = 16, each row one 16-byte key load and one
// weight load, all issued before the hashes; it raises a register by a
// shared-memory atomicMax only where the register is below the rank (a
// repeated port reads its own earlier rank and skips). After
// cluster.sync(), block r owns groups [r * per_block, (r + 1) * per_block)
// and takes each of their registers' maximum over the S copies, read
// through distributed shared memory (cluster.map_shared_rank, 16-byte
// loads, every thread a (source, word) pair so the reads are in flight
// together): no atomic crosses an SM. A cluster of one block is an
// ordinary launch. Then it estimates its own groups as one block did
// before: a warp a group, lanes striding the 2^p registers, a shuffle sum
// of 2^-reg and of the zero registers, so the f32 sums add in the same
// order and the estimates do not depend on S. One launch, no global
// atomic, no memset. Two designs lost to it on the card (PERF.md):
// each block owning its groups' registers alone, raised by remote atomicMax
// (the hot registers serialize at their owner), and ordinary blocks raising
// a global bank at their non-zero registers, the last block by a ticket
// estimating (the ticket's round trip and the bank's L2 traffic).
//
// The bank's close (K12, K13 and the three detectors' EWMA):
// bank_close_kernel. Replaces retina_tpu/detect/programs.py:78
// detect.dnstunnel and :100 detect.synflood, with retina_tpu/detect/base.py:86
// Detector.judge's AnomalyEWMA.observe (ops/entropy.py:113) for each
// built-in detector. The plain version is retina_tpu_torch/detect/programs.py
// bank_close_plain. A window close of the bank scores every active built-in
// detector and steps its EWMA in one launch: a warp a slot of a
// __grid_constant__ table (kops._BankTable), each slot
//   dnstunnel: [bits, total] of a (nbins,) f32 qname-length histogram, the
//     plug-in entropy of entropy.py:71, summed in f64 as K16 sums it (n
//     exactly; p = c / max(n, 1), p * log2(p) IEEE-rounded, no fused
//     multiply-add) and rounded to f32 once, so the bits equal
//     dnstunnel_plain's but at a rounding tie;
//   synflood: [syn / max(ack, 1), syn / max(total, 1), syn] of the 9
//     tcpflag lanes, IEEE-rounded divisions, equal to the reference bit for
//     bit;
//   portscan: the maximum of K11's (G,) estimates, read where K11 wrote them
//     on the same stream;
// then, where the slot names a state, the EWMA of its score (ewma.cuh) on
// mean/var/n_obs[state] in place. A slot's row is [score vector (3), z,
// flag], written wherever the table points: the bank's page-locked buffer
// through its device address, or a tensor on the card (dnstunnel_score and
// synflood_score: one slot, no EWMA). The histograms and lanes travel in
// the table itself (a launch's parameter block), or are read from a tensor
// on the card. On the H100 this took 0.0032-0.0034 ms; reading them from a
// page-locked buffer through its device address took 0.0049-0.0050 (a read
// across PCIe) and one copy in and one out 0.0054-0.0058 (PERF.md). A bank
// with more slots than a table holds (kBankMaxSlots, kBankFeatures) takes a
// launch a table. Bound: bytes, ~0.6 KB a close (the features, the
// estimates and the state read once, the state and rows written once), so
// the launch floor. Design: one block of a warp a slot, every load of a
// slot issued before its first sum (a lane holds up to kBinsPerLane bins in
// registers), warp shuffles, and lane 0 of each warp steps its slot's EWMA
// and writes its row. No atomic, no memset; the wrapper waits on one
// event.
#include <cooperative_groups.h>

#include "ewma.cuh"
#include "hash.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPortscanThreads = 1024;
constexpr int kMaxCluster = 16;  // PORTSCAN_CLUSTER in kernels/ops.py
constexpr int kMaxBankBytes = 64 * 1024;  // SHARED_BYTES in kernels/ops.py
constexpr int kPortscanRows = 4;  // rows a thread loads before it hashes any
constexpr int kBankMaxSlots = 8;  // BANK_MAX_SLOTS in kernels/ops.py
constexpr int kBinsPerLane = 8;  // BANK_MAX_BINS = 32 * kBinsPerLane in kernels/ops.py
constexpr int kBankRow = 5;  // BANK_ROW in kernels/ops.py: score vector (3), z, flag
constexpr int kBankFeatures = 512;  // BANK_TABLE_FEATURES in kernels/ops.py
enum Kind { kDnsTunnel = 0, kSynFlood = 1, kPortScan = 2 };  // BANK_* in kernels/ops.py
constexpr uint32_t kGroupMul = 2654435761u;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

// The rank of every row of weight > 0 among this block's rows [first,
// n) at stride ``stride``, raised into ``bank`` (all G * 2^p registers) by
// shared-memory atomicMax where the register is below it.
__device__ __forceinline__ void walk_rows(const uint4* __restrict__ keys,
                                          const float* __restrict__ weights, long long n,
                                          long long first, long long stride, uint32_t groups,
                                          int p, uint32_t seed, uint32_t* bank) {
  const uint32_t m = 1u << p;
  for (long long base = first; base < n; base += kPortscanRows * stride) {
    uint4 k[kPortscanRows];
    float w[kPortscanRows];
#pragma unroll
    for (int j = 0; j < kPortscanRows; ++j) {
      const long long i = base + j * stride;
      k[j] = i < n ? keys[i] : make_uint4(0u, 0u, 0u, 0u);
      w[j] = i < n ? weights[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPortscanRows; ++j) {
      if (!(w[j] > 0.f)) continue;  // padding rows carry weight 0
      const uint32_t g = (k[j].x * kGroupMul) % groups;
      const uint32_t dport[1] = {k[j].w};
      const uint32_t h = rt::hash_keys(dport, 1, seed);
      const uint32_t rest = h >> p;
      const int hsb = rest ? 31 - __clz(rest) : -1;
      const uint32_t rank = (uint32_t)(32 - p - hsb);
      uint32_t* r = bank + g * m + (h & (m - 1u));
      if (*r < rank) atomicMax(r, rank);
    }
  }
}

// The estimate of ``count`` groups whose registers start at ``regs``, into
// out[0, count): a warp a group.
__device__ __forceinline__ void estimate_groups(const uint32_t* regs, uint32_t count, int p,
                                                float alpha_mm, float* __restrict__ out) {
  const uint32_t m = 1u << p;
  const uint32_t warp = threadIdx.x >> 5, lane = threadIdx.x & 31u;
  for (uint32_t gl = warp; gl < count; gl += blockDim.x >> 5) {
    float s = 0.f;
    int zeros = 0;
    for (uint32_t j = lane; j < m; j += 32) {
      const uint32_t r = regs[gl * m + j];
      s += exp2f(-(float)r);
      zeros += r == 0u;
    }
    s = warp_sum(s);
    zeros = warp_sum(zeros);
    if (lane == 0) {
      const float fm = (float)m, z = (float)zeros;
      const float raw = alpha_mm / s;
      const float lc = fm * logf(fm / fmaxf(z, 1e-9f));
      out[gl] = (raw <= 2.5f * fm && z > 0.f) ? lc : raw;
    }
  }
}

__device__ __forceinline__ void zero_bank(uint32_t* bank, uint32_t words) {
  uint4* b4 = reinterpret_cast<uint4*>(bank);  // words: a multiple of 2^p >= 16
  for (uint32_t i = threadIdx.x; i < (words >> 2); i += blockDim.x)
    b4[i] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ uint4 max4(uint4 a, uint4 b) {
  return make_uint4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
}

__global__ void __launch_bounds__(kPortscanThreads)
    portscan_kernel(const uint4* __restrict__ keys, const float* __restrict__ weights,
                    long long n, uint32_t groups, uint32_t per_block, int p, uint32_t seed,
                    float alpha_mm, float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t bank[];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t rank = cluster.block_rank(), S = cluster.num_blocks();
  const uint32_t m = 1u << p;
  zero_bank(bank, groups * m);
  __syncthreads();
  walk_rows(keys, weights, n, (long long)rank * blockDim.x + threadIdx.x,
            (long long)S * blockDim.x, groups, p, seed, bank);
  const uint32_t g0 = rank * per_block;
  const uint32_t own = groups > g0 ? min(per_block, groups - g0) : 0u;
  if (S > 1) {
    cluster.sync();  // every block's copy is complete and visible to the cluster
    // Every thread takes (source block, 16-byte word) pairs of this block's
    // own groups, so all the remote reads are in flight at once; the maxima
    // land by shared-memory atomicMax (a word takes at most S - 1). No other
    // block reads this block's own groups.
    uint4* mine = reinterpret_cast<uint4*>(bank + g0 * m);
    const uint32_t words = (own * m) >> 2;
    for (uint32_t k = threadIdx.x; k < words * S; k += blockDim.x) {
      const uint32_t q = k / words, i = k - q * words;
      if (q == rank) continue;
      const uint4 o = cluster.map_shared_rank(mine, q)[i];
      uint32_t* d = reinterpret_cast<uint32_t*>(mine + i);
      if (o.x > d[0]) atomicMax(d, o.x);
      if (o.y > d[1]) atomicMax(d + 1, o.y);
      if (o.z > d[2]) atomicMax(d + 2, o.z);
      if (o.w > d[3]) atomicMax(d + 3, o.w);
    }
    cluster.sync();  // no block reads another's copy after this
  } else {
    __syncthreads();
  }
  estimate_groups(bank + g0 * m, own, p, alpha_mm, out + g0);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

struct BankSlot {
  const float* x;  // the features (the (n,) histogram, the 9 lanes or the (n,) estimates),
                   // or null: they are feat[off, off + n) of the table
  float* out;  // kBankRow floats
  int kind;
  int n;  // bins, lanes or groups
  int state;  // the slot's EWMA state in mean/var/n_obs, or -1: no EWMA step
  int off;
  float z_thresh;
  float min_windows;
  float alpha;
  int pad;
};

struct BankTable {
  float* mean;
  float* var;
  float* n_obs;
  int n_slots;
  int pad;
  BankSlot slot[kBankMaxSlots];
  float feat[kBankFeatures];  // features that travel with the launch
};

static_assert(sizeof(BankSlot) == 48, "BankSlot must match kernels/ops.py _BankSlot");
static_assert(sizeof(BankTable) == 32 + kBankMaxSlots * 48 + kBankFeatures * 4,
              "BankTable must match _BankTable");

// Warp w scores slot w; its lane 0 steps the slot's EWMA and writes its row.
__global__ void __launch_bounds__(kBankMaxSlots * 32)
    bank_close_kernel(const __grid_constant__ BankTable t) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (w >= t.n_slots) return;
  const BankSlot& s = t.slot[w];
  const float* x = s.x ? s.x : t.feat + s.off;
  float m0 = 0.f, v0 = 0.f, k0 = 0.f;  // in flight while the features load
  if (lane == 0 && s.state >= 0) {
    m0 = t.mean[s.state];
    v0 = t.var[s.state];
    k0 = t.n_obs[s.state];
  }
  float v[3] = {0.f, 0.f, 0.f};
  if (s.kind == kDnsTunnel) {
    float c[kBinsPerLane];
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      const int i = lane + 32 * j;
      c[j] = i < s.n ? x[i] : 0.f;
    }
    double n = 0.0;
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) n += c[j];
    n = warp_sum(n);  // exact, in every lane
    const double denom = fmax(n, 1.0);
    double sum = 0.0;
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      if (c[j] > 0.f) {  // p > 0 exactly where c > 0
        const double p = __ddiv_rn(c[j], denom);
        sum = __dadd_rn(sum, __dmul_rn(p, log2(fmax(p, 1e-30))));
      }
    }
    sum = warp_sum(sum);
    v[0] = __double2float_rn(-sum);
    v[1] = __double2float_rn(n);
  } else if (s.kind == kSynFlood) {
    if (lane == 0) {
      const float syn = x[1];  // TCP_SYN = 1 << 1
      const float ack = x[4];  // TCP_ACK = 1 << 4
      const float total = x[8];
      v[0] = __fdiv_rn(syn, fmaxf(ack, 1.f));
      v[1] = __fdiv_rn(syn, fmaxf(total, 1.f));
      v[2] = syn;
    }
  } else {
    float m = __int_as_float(0xFF800000);  // -inf
    for (int i = lane; i < s.n; i += 32) m = fmaxf(m, x[i]);
#pragma unroll
    for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    v[0] = m;
  }
  if (lane != 0) return;
  float z = 0.f, flag = 0.f;
  if (s.state >= 0) {
    const rt::EwmaStep r =
        rt::ewma_step(v[0], true, m0, v0, k0, s.alpha, s.z_thresh, s.min_windows);
    t.mean[s.state] = r.mean;
    t.var[s.state] = r.var;
    t.n_obs[s.state] = r.n_obs;
    z = r.z;
    flag = r.flag ? 1.f : 0.f;
  }
  s.out[0] = v[0];
  s.out[1] = v[1];
  s.out[2] = v[2];
  s.out[3] = z;
  s.out[4] = flag;
}

// The largest cluster of portscan_kernel the current device can schedule
// with a whole bank of kMaxBankBytes in every block, per device, found once
// (a smaller bank fits any cluster that one does). The kernel's attributes
// are set then too: the bank's dynamic shared memory and the non-portable
// cluster sizes (above 8).
cudaError_t portscan_max_cluster(int* out) {
  static int cache[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16) dev = 15;
  if (cache[dev] == 0) {
    e = cudaFuncSetAttribute(portscan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxBankBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(portscan_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kMaxCluster);
    cfg.blockDim = dim3(kPortscanThreads);
    cfg.dynamicSmemBytes = kMaxBankBytes;
    int n = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxPotentialClusterSize(&n, portscan_kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;  // no cluster of these blocks fits
    cache[dev] = n < kMaxCluster ? n : kMaxCluster;
  }
  *out = cache[dev];
  return cudaSuccess;
}

}  // namespace

// ``blocks`` blocks (1 to 16) in one cluster, at most the largest cluster
// the device can schedule. Each block takes G * 2^p * 4 bytes of shared
// memory, at most kMaxBankBytes.
extern "C" int portscan_score(const void* keys, const void* weights, long long n, int groups,
                              int precision, unsigned int seed, float alpha_mm, int blocks,
                              void* out, void* stream) {
  const size_t smem = (size_t)groups * (1u << precision) * sizeof(uint32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int cap = 1;
  cudaError_t e = portscan_max_cluster(&cap);
  if (e != cudaSuccess) return (int)e;
  if (blocks > cap) blocks = cap;
  const uint32_t per_block = ((uint32_t)groups + blocks - 1) / blocks;
  if (blocks == 1) {  // a cluster of one: an ordinary launch
    portscan_kernel<<<1, kPortscanThreads, smem, st>>>(
        static_cast<const uint4*>(keys), static_cast<const float*>(weights), n,
        (uint32_t)groups, per_block, precision, (uint32_t)seed, alpha_mm,
        static_cast<float*>(out));
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kPortscanThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, portscan_kernel, static_cast<const uint4*>(keys),
                         static_cast<const float*>(weights), n, (uint32_t)groups, per_block,
                         precision, (uint32_t)seed, alpha_mm, static_cast<float*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One launch for the 1 to kBankMaxSlots slots of ``table`` (a BankTable),
// a warp a slot.
extern "C" int bank_close(const void* table, void* stream) {
  const BankTable& t = *static_cast<const BankTable*>(table);
  if (t.n_slots < 1 || t.n_slots > kBankMaxSlots) return (int)cudaErrorInvalidValue;
  bank_close_kernel<<<1, 32 * t.n_slots, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}

// The device address of page-locked host memory at ``host`` (the bank's
// rows, which the kernel writes).
extern "C" int host_device_pointer(void* host, void** device) {
  return (int)cudaHostGetDevicePointer(device, host, 0);
}
