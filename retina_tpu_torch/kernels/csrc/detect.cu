// K11-K13: the scoring programs of the detector bank.
//
// Replace retina_tpu/detect/programs.py:51 detect.portscan, :78
// detect.dnstunnel and :100 detect.synflood. Their inputs are small
// feature arrays the bank builds on the host at each window close (at most
// 2^16 flow keys, a 64-bin histogram, 9 lanes), so every kernel is one
// launch. The plain versions are retina_tpu_torch/detect/programs.py
// portscan_plain, dnstunnel_plain and synflood_plain.
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
// K12 dnstunnel_score: [entropy bits, total] of a (1, nbins) f32
// histogram, the plug-in entropy of entropy.py:71. One block of 64
// threads: shuffles and two shared words sum n, then p log2 p over the
// bins with p > 0. The sums group otherwise than XLA's: equal within a
// relative 1e-5.
//
// K13 synflood_score: [syn / max(ack, 1), syn / max(total, 1), syn] of the
// 9 tcpflag lanes. One thread; the divisions are IEEE-rounded (no
// fast-math), so the result equals the reference bit for bit.
#include <cooperative_groups.h>

#include "hash.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPortscanThreads = 1024;
constexpr int kMaxCluster = 16;  // PORTSCAN_CLUSTER in kernels/ops.py
constexpr int kMaxBankBytes = 64 * 1024;  // SHARED_BYTES in kernels/ops.py
constexpr int kPortscanRows = 4;  // rows a thread loads before it hashes any
constexpr int kDnsThreads = 64;
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

__global__ void __launch_bounds__(kDnsThreads)
    dnstunnel_kernel(const float* __restrict__ hist, int nbins, float* __restrict__ out) {
  __shared__ float part[kDnsThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float n = 0.f;
  for (int i = threadIdx.x; i < nbins; i += kDnsThreads) n += hist[i];
  n = warp_sum(n);
  if (lane == 0) part[warp] = n;
  __syncthreads();
  n = part[0] + part[1];
  __syncthreads();
  const float denom = fmaxf(n, 1.f);
  float t = 0.f;
  for (int i = threadIdx.x; i < nbins; i += kDnsThreads) {
    const float p = hist[i] / denom;
    if (p > 0.f) t += p * log2f(fmaxf(p, 1e-30f));
  }
  t = warp_sum(t);
  if (lane == 0) part[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    out[0] = -(part[0] + part[1]);
    out[1] = n;
  }
}

__global__ void synflood_kernel(const float* __restrict__ lanes, float* __restrict__ out) {
  const float syn = lanes[1];  // TCP_SYN = 1 << 1
  const float ack = lanes[4];  // TCP_ACK = 1 << 4
  const float total = lanes[8];
  out[0] = syn / fmaxf(ack, 1.f);
  out[1] = syn / fmaxf(total, 1.f);
  out[2] = syn;
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

extern "C" int dnstunnel_score(const void* hist, int nbins, void* out, void* stream) {
  dnstunnel_kernel<<<1, kDnsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), nbins, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int synflood_score(const void* lanes, void* out, void* stream) {
  synflood_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lanes), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
