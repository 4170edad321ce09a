// K15: the invertible sketch's decode.
//
// Replaces retina_tpu/ops/invertible.py:167 InvertibleSketch.decode (under
// :229 decode_verified, as parallel/telemetry.py:646 sharded.inv_decode and
// timetravel/fold.py:241 range_decode run it). For each of the D * W
// buckets, of weight w and planes p[0 .. 32(C+1)): bit b of the decoded
// words is the majority p[b] > w - p[b], compared as u32 (span-summed
// planes pass 2^31); the first C words are the key, the last its checksum;
// ok = w != 0, the checksum equals hash_cols(key, CHECK_SEED + seed), and
// the key re-hashes to its own position in its own row d = bucket / W
// (hash_cols(key, d + 1 + seed) mod W). The plain version is
// ops/invertible.py decode_plain.
//
// Bound on the H100: bytes, the planes and weights read once (5.2 MB at
// INVERTIBLE_CONFIG's inv_flow) and the key words and flags written once.
//
// Design: one warp per bucket. For word g, lane i reads plane 32g + i (one
// coalesced 128-byte load) and __ballot_sync of the lanes' majorities is
// the word, bit i from lane i, as the reference's shifts order them. Lane
// 0 hashes the checksum and the key's index in its own row only, and
// writes the words and the flag.
#include "hash.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kCheckSeed = 0x1C3A9F71u;

__global__ void decode_kernel(const uint32_t* __restrict__ planes,
                              const uint32_t* __restrict__ weights, long long n_buckets,
                              uint32_t width, int n_cols, uint32_t seed,
                              uint32_t* __restrict__ cols, uint8_t* __restrict__ ok) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  const size_t n_planes = 32 * (size_t)(n_cols + 1);
  for (long long b = blockIdx.x * (long long)(blockDim.x >> 5) + (threadIdx.x >> 5);
       b < n_buckets; b += warps) {
    const uint32_t w = weights[b];
    const uint32_t* p = planes + (size_t)b * n_planes;
    uint32_t key[rt::kMaxCols] = {0u, 0u, 0u, 0u};
    uint32_t check = 0u;
#pragma unroll
    for (int g = 0; g <= rt::kMaxCols; ++g) {
      if (g > n_cols) break;
      const uint32_t v = p[32 * g + lane];
      const uint32_t word = __ballot_sync(kFull, v > w - v);
      if (g < n_cols) key[g] = word;
      else check = word;
    }
    if (lane == 0) {
      const uint32_t d = (uint32_t)(b / width);
      const uint32_t pos = (uint32_t)(b % width);
      const bool check_ok = check == rt::hash_keys(key, n_cols, kCheckSeed + seed);
      const bool own = (rt::hash_keys(key, n_cols, d + 1u + seed) & (width - 1u)) == pos;
      ok[b] = (w != 0u && check_ok && own) ? 1 : 0;
#pragma unroll
      for (int g = 0; g < rt::kMaxCols; ++g)
        if (g < n_cols) cols[g * n_buckets + b] = key[g];
    }
  }
}

}  // namespace

// cols: (n_cols, n_buckets) u32; ok: (n_buckets,) bytes of 0 or 1.
extern "C" int inv_decode(const void* planes, const void* weights, long long n_buckets,
                          int width, int n_cols, unsigned int seed, void* cols, void* ok,
                          void* stream) {
  const int threads = 256;
  decode_kernel<<<rt::grid_for(n_buckets, threads / 32), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<const uint32_t*>(weights), n_buckets,
      (uint32_t)width, n_cols, seed, static_cast<uint32_t*>(cols), static_cast<uint8_t*>(ok));
  return (int)cudaGetLastError();
}
