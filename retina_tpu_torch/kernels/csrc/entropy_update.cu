// K4: entropy window histograms, all groups in one pass.
//
// Replaces retina_tpu/ops/entropy.py:54 EntropyWindow.update as the
// pipeline calls it (models/pipeline.py: three updates, src IP, dst IP and
// dst port, each into its own group of a (3, K) float32 histogram): group
// g hashes its key column g and adds the row's weight, converted to f32,
// at column hash & (K - 1).
//
// Bound on the H100: bytes, B * 4 * (G + 1) of key and weight columns plus
// the (G, K) histogram read and written once. What kept a one-thread-a-row
// design with a global float atomicAdd per row and group at ~128x that
// bound is the atomics: the histogram is small (48 KiB at K = 4096) and a
// Zipf stream's hot keys and ports pile their adds onto a few words in L2.
//
// Design: a block's copy of the histogram lives in shared memory as exact
// 64-bit integer sums, two u32 words a bucket (96 KiB at the deployed
// bank; the wrapper refuses a bank a block cannot hold). A persistent grid
// of one 1024-thread block an SM: each block zeroes its copy, adds its
// rows' weights there, each converted to f32 as the plain version converts
// it and so an integer below 2^33, with u32 shared-memory atomics (the
// high word moves on a carry; four rows a thread in flight, so the loads
// of several rows overlap), then adds each nonzero bucket, rounded to f32
// once, to the global histogram with one atomicAdd: device memory sees at
// most G * K adds a block, whatever the skew. Integer atomics are native
// in shared memory and conflicting lanes serialise in hardware; float ones
// retry a compare-and-swap, which is what a hot port or address made slow.
// Measured on the H100 and so left out: merging a warp's equal buckets
// first (__match_any_sync), and summing a cluster's copies through
// distributed shared memory before the flush; each cost more than it
// saved.
//
// Results: a bucket below 2^24 is an exact integer sum, as the plain
// version's f32 adds of integer weights are, so the two are equal. Above
// 2^24 both add the same f32 weights; the plain version rounds at every
// add and this kernel once a block, so the sums depend on the order, as
// they do in the reference's scatter.
#include "hash.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads, 1)
entropy_kernel(float* counts, uint32_t kmask, uint32_t seed, const __grid_constant__ rt::Cols keys,
               const uint32_t* w, long long ws, long long n) {
  extern __shared__ uint32_t hist[];  // (G, K) low words, then (G, K) high words
  const int total = keys.n * (int)(kmask + 1u);
  uint32_t* lo = hist;
  uint32_t* hi = hist + total;
  for (int t = threadIdx.x; t < 2 * total; t += kThreads) hist[t] = 0u;
  __syncthreads();
  const uint32_t h0 = rt::hash_init(0xE17209u + seed);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i0 = blockIdx.x * (long long)kThreads + threadIdx.x; i0 < n;
       i0 += kUnroll * stride) {
    uint32_t wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      wv[u] = i < n ? w[i * ws] : 0u;
    }
    uint32_t idx[kUnroll][rt::kMaxCols];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
#pragma unroll
      for (int g = 0; g < rt::kMaxCols; ++g)
        idx[u][g] = (g < keys.n && wv[u] != 0u)
                        ? (uint32_t)g * (kmask + 1u) +
                              (rt::hash_step(h0, keys.p[g][i * keys.stride[g]]) & kmask)
                        : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (wv[u] == 0u) continue;
      // The weight as f32 (rounded, as the plain version converts it) is an
      // integer below 2^33: summed exactly, in two words a bucket.
      const unsigned long long f = __float2ull_rz(__uint2float_rn(wv[u]));
      const uint32_t f_lo = (uint32_t)f, f_hi = (uint32_t)(f >> 32);
#pragma unroll
      for (int g = 0; g < rt::kMaxCols; ++g) {
        if (g >= keys.n) break;
        const uint32_t old = atomicAdd(lo + idx[u][g], f_lo);
        const uint32_t carry = f_hi + (old + f_lo < old ? 1u : 0u);
        if (carry != 0u) atomicAdd(hi + idx[u][g], carry);
      }
    }
  }
  // Each nonzero bucket, rounded to f32 once, is one atomicAdd to the
  // global histogram.
  __syncthreads();
  for (int t = threadIdx.x; t < total; t += kThreads) {
    const unsigned long long v = ((unsigned long long)hi[t] << 32) | lo[t];
    if (v != 0ull) atomicAdd(counts + t, __ull2float_rn(v));
  }
}

// SMs of the current device, found once.
int sm_count() {
  static int cache[16];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 16) dev = 15;
  if (cache[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(entropy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         227 * 1024);
    cache[dev] = n > 0 ? n : 1;
  }
  return cache[dev];
}

}  // namespace

extern "C" int entropy_update(void* counts, int n_buckets, unsigned int seed,
                              const void* k0, long long s0, const void* k1, long long s1,
                              const void* k2, long long s2, const void* k3, long long s3,
                              int n_groups, const void* w, long long ws, long long n,
                              void* stream) {
  const long long need = (n + kThreads - 1) / kThreads;
  const int sms = sm_count();
  entropy_kernel<<<(int)(need < sms ? need : sms), kThreads,
                   2 * (size_t)n_groups * n_buckets * sizeof(uint32_t),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(counts), (uint32_t)n_buckets - 1u, seed,
      rt::make_cols(k0, s0, k1, s1, k2, s2, k3, s3, n_groups), static_cast<const uint32_t*>(w),
      ws, n);
  return (int)cudaGetLastError();
}
