// Device hashing shared by every kernel of the port, inlined into each.
//
// Replaces retina_tpu/ops/hashing.py:29 fmix32, :40 hash_cols and :81
// reduce_range: murmur3's fmix32 finalizer over boost-style combined u32
// columns, bit-identical to the reference (u32 multiplies wrap mod 2^32,
// as XLA's do). reduce_range is a mask with (width - 1), width a power of
// two. The plain versions are retina_tpu_torch/ops/hashing.py.
//
// Bound: a handful of integer ALU operations per column; it launches
// nothing of its own.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr uint32_t kPhi32 = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// hash_cols starts from seed * PHI and folds in one column at a time.
__device__ __forceinline__ uint32_t hash_init(uint32_t seed) { return seed * kPhi32; }

__device__ __forceinline__ uint32_t hash_step(uint32_t h, uint32_t c) {
  return fmix32(h ^ (c + kPhi32 + (h << 6) + (h >> 2)));
}

__device__ __forceinline__ uint32_t hash_keys(const uint32_t* key, int n, uint32_t seed) {
  uint32_t h = hash_init(seed);
  for (int c = 0; c < n; ++c) h = hash_step(h, key[c]);
  return h;
}

// Up to four u32 key columns, each a pointer with an element stride, so a
// column of a row-major record block (stride 16) and a contiguous column
// are read alike.
constexpr int kMaxCols = 4;

struct Cols {
  const uint32_t* p[kMaxCols];
  long long stride[kMaxCols];
  int n;
};

__device__ __forceinline__ void load_keys(const Cols& k, long long i, uint32_t* key) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) key[c] = c < k.n ? k.p[c][i * k.stride[c]] : 0u;
}

inline Cols make_cols(const void* k0, long long s0, const void* k1, long long s1,
                      const void* k2, long long s2, const void* k3, long long s3, int n) {
  Cols k;
  k.p[0] = static_cast<const uint32_t*>(k0);
  k.p[1] = static_cast<const uint32_t*>(k1);
  k.p[2] = static_cast<const uint32_t*>(k2);
  k.p[3] = static_cast<const uint32_t*>(k3);
  k.stride[0] = s0;
  k.stride[1] = s1;
  k.stride[2] = s2;
  k.stride[3] = s3;
  k.n = n;
  return k;
}

// Blocks for a grid-stride loop over n items: enough to fill 132 SMs
// several times over, never more than the items need.
inline int grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

}  // namespace rt
