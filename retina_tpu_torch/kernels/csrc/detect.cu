// K11-K13: the scoring programs of the detector bank.
//
// Replace retina_tpu/detect/programs.py:51 detect.portscan, :78
// detect.dnstunnel and :100 detect.synflood. Their inputs are small
// feature arrays the bank builds on the host at each window close (at most
// 2^16 flow keys, a 64-bin histogram, 9 lanes), so every kernel is one
// block and one launch. The plain versions are retina_tpu_torch/detect/
// programs.py portscan_plain, dnstunnel_plain and synflood_plain.
//
// K11 portscan_score: per source hash-group g = (src * 2654435761) mod G
// (u32 arithmetic, so a product with the top bit set wraps as the
// reference's does), an HLL of precision p over the dst port of every key
// of weight > 0, hashed as K3 hashes (hll_update.cu, seed 0xC0FFEE + the
// program's seed); then the estimate of hyperloglog.py:108 in f32.
// Bound: bytes, P * 20 read (the key rows' two lanes used sit in 16-byte
// rows, the weights 4 bytes) and G * 4 written. Design: the G * 2^p
// registers (32 KB at G = 32, p = 8) live in shared memory, the block walks
// the keys with a stride of its 1024 threads and raises registers by
// shared-memory atomicMax; then each warp takes a group, sums 2^-reg and
// counts the zero registers with shuffles, and its lane 0 writes the raw
// or the linear-counting estimate. One block suffices: at P = 2^16 the
// walk is 64 rows a thread.
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
#include "hash.cuh"

namespace {

constexpr int kPortscanThreads = 1024;
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

__global__ void __launch_bounds__(kPortscanThreads)
    portscan_kernel(const uint32_t* __restrict__ keys, const float* __restrict__ weights,
                    long long n, uint32_t groups, int p, uint32_t seed, float alpha_mm,
                    float* __restrict__ out) {
  extern __shared__ uint32_t regs[];
  const uint32_t m = 1u << p;
  const uint32_t total = groups * m;
  for (uint32_t i = threadIdx.x; i < total; i += blockDim.x) regs[i] = 0u;
  __syncthreads();
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    if (!(weights[i] > 0.f)) continue;  // padding rows carry weight 0
    const uint32_t src = keys[i * 4];
    const uint32_t dport[1] = {keys[i * 4 + 3]};
    const uint32_t g = (src * kGroupMul) % groups;
    const uint32_t h = rt::hash_keys(dport, 1, seed);
    const uint32_t rest = h >> p;
    const int hsb = rest ? 31 - __clz(rest) : -1;
    atomicMax(regs + g * m + (h & (m - 1u)), (uint32_t)(32 - p - hsb));
  }
  __syncthreads();
  const uint32_t warp = threadIdx.x >> 5, lane = threadIdx.x & 31u;
  for (uint32_t g = warp; g < groups; g += blockDim.x >> 5) {
    float s = 0.f;
    int zeros = 0;
    for (uint32_t j = lane; j < m; j += 32) {
      const uint32_t r = regs[g * m + j];
      s += exp2f(-(float)r);
      zeros += r == 0u;
    }
    s = warp_sum(s);
    zeros = warp_sum(zeros);
    if (lane == 0) {
      const float fm = (float)m, z = (float)zeros;
      const float raw = alpha_mm / s;
      const float lc = fm * logf(fm / fmaxf(z, 1e-9f));
      out[g] = (raw <= 2.5f * fm && z > 0.f) ? lc : raw;
    }
  }
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

}  // namespace

extern "C" int portscan_score(const void* keys, const void* weights, long long n, int groups,
                              int precision, unsigned int seed, float alpha_mm, void* out,
                              void* stream) {
  const size_t smem = (size_t)groups * (1u << precision) * sizeof(uint32_t);
  portscan_kernel<<<1, kPortscanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(weights), n,
      (uint32_t)groups, precision, seed, alpha_mm, static_cast<float*>(out));
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
