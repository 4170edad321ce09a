// K4: entropy window histograms, all groups in one pass.
//
// Replaces retina_tpu/ops/entropy.py:54 EntropyWindow.update as the
// pipeline calls it (models/pipeline.py: three updates, src IP, dst IP and
// dst port, each into its own group of a (3, K) float32 histogram): group
// g hashes its key column g and adds the row's weight, converted to f32,
// at column hash & (K - 1).
//
// Bound on the H100: bytes, B * 4 * (G + 1) of key and weight columns plus
// the (G, K) histogram read and written once; then G float atomicAdds per
// weighted row. The histograms are small (48 KiB at K = 4096) and the keys
// of a Zipf stream are few, so the adds pile onto a few hot words.
//
// Design: one thread per row computes the G hashes and makes the G adds.
// Float atomics land in an order that changes from run to run; counts of
// integer weights stay exact while a bucket is below 2^24, and above that
// the sum depends on the order, as it does in the reference's scatter.
#include "hash.cuh"

namespace {

__global__ void entropy_kernel(float* counts, uint32_t kmask, uint32_t seed, rt::Cols keys,
                               const uint32_t* w, long long ws, long long n) {
  const uint32_t h0 = rt::hash_init(0xE17209u + seed);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t wi = w[i * ws];
    if (wi == 0u) continue;
    const float f = __uint2float_rn(wi);
    for (int g = 0; g < keys.n; ++g) {
      const uint32_t idx = rt::hash_step(h0, keys.p[g][i * keys.stride[g]]) & kmask;
      atomicAdd(counts + (size_t)g * (kmask + 1u) + idx, f);
    }
  }
}

}  // namespace

extern "C" int entropy_update(void* counts, int n_buckets, unsigned int seed,
                              const void* k0, long long s0, const void* k1, long long s1,
                              const void* k2, long long s2, const void* k3, long long s3,
                              int n_groups, const void* w, long long ws, long long n,
                              void* stream) {
  const int threads = 256;
  entropy_kernel<<<rt::grid_for(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(counts), (uint32_t)n_buckets - 1u, seed,
      rt::make_cols(k0, s0, k1, s1, k2, s2, k3, s3, n_groups), static_cast<const uint32_t*>(w),
      ws, n);
  return (int)cudaGetLastError();
}
