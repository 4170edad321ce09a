// K6: the invertible sketch's bit-plane scatter-add.
//
// Replaces retina_tpu/ops/invertible.py:136-165 InvertibleSketch.update:
// for every row of weight w and every depth d, the bucket
// idx_d = hash_cols(key, d + 1 + seed) mod W gets planes[d, idx_d, b] += w
// for each set bit b of the key's C u32 columns and of its 32-bit checksum
// hash_cols(key, CHECK_SEED + seed), and weights[d, idx_d] += w. The plain
// version is ops/invertible.py update_plain.
//
// Bound on the H100: bytes, at the main path's weights. Each row reads its
// weight and, where the weight is not 0, its key columns; the planes
// (D x W x 32(C+1) u32, 5 MiB at the deployed widths) are read and written
// once. At low aggregation only conntrack's report rows carry weight.
//
// Design: a warp takes 32 rows. Lanes read the 32 weights coalesced and a
// ballot finds the rows of weight != 0, so rows of weight 0 make no
// atomics and cost one load. Each such lane hashes its own key's checksum;
// then the warp walks the ballot: the row's key words and checksum are
// broadcast by shuffle, every lane recomputes the D bucket indices, and
// lane l adds w to plane 32j + l of the bucket for each word j whose bit l
// is set. A bucket's planes are contiguous, so the adds of one word are 32
// neighbouring u32 (one coalesced atomic instruction); lane 0 adds the
// bucket weight. u32 atomicAdd wraps mod 2^32 as the reference's scatter
// does, in any order.
#include "hash.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kCheckSeed = 0x1C3A9F71u;

struct Inv {
  uint32_t* planes;   // (D, W, 32 * (C + 1))
  uint32_t* weights;  // (D, W)
  int depth;
  uint32_t width;
  uint32_t seed;
  rt::Cols k;
  const uint32_t* w;
  long long w_stride;
  long long B;
};

__global__ void inv_kernel(Inv s) {
  const int lane = threadIdx.x & 31;
  const int n = s.k.n;
  const size_t n_planes = 32 * (size_t)(n + 1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = blockIdx.x * (long long)blockDim.x + (threadIdx.x - lane); base < s.B;
       base += stride) {
    const long long i = base + lane;
    const uint32_t w = i < s.B ? s.w[i * s.w_stride] : 0u;
    uint32_t act = __ballot_sync(kFull, w != 0u);
    uint32_t key[rt::kMaxCols] = {0u, 0u, 0u, 0u};
    uint32_t check = 0u;
    if (w) {
      rt::load_keys(s.k, i, key);
      check = rt::hash_keys(key, n, kCheckSeed + s.seed);
    }
    while (act) {
      const int src = __ffs(act) - 1;
      act &= act - 1u;
      uint32_t kw[rt::kMaxCols + 1];
#pragma unroll
      for (int c = 0; c < rt::kMaxCols; ++c) kw[c] = __shfl_sync(kFull, key[c], src);
      const uint32_t chk = __shfl_sync(kFull, check, src);
      const uint32_t wv = __shfl_sync(kFull, w, src);
      kw[n] = chk;
      for (int d = 0; d < s.depth; ++d) {
        const uint32_t idx = rt::hash_keys(kw, n, (uint32_t)d + 1u + s.seed) & (s.width - 1u);
        const size_t bucket = (size_t)d * s.width + idx;
        uint32_t* row = s.planes + bucket * n_planes;
        for (int j = 0; j <= n; ++j)
          if ((kw[j] >> lane) & 1u) atomicAdd(row + 32 * j + lane, wv);
        if (lane == 0) atomicAdd(s.weights + bucket, wv);
      }
    }
  }
}

}  // namespace

extern "C" int inv_update(void* planes, void* weights, int depth, int width, unsigned int seed,
                          const void* k0, long long s0, const void* k1, long long s1,
                          const void* k2, long long s2, const void* k3, long long s3, int n_cols,
                          const void* w, long long w_stride, long long B, void* stream) {
  Inv s;
  s.planes = static_cast<uint32_t*>(planes);
  s.weights = static_cast<uint32_t*>(weights);
  s.depth = depth;
  s.width = (uint32_t)width;
  s.seed = seed;
  s.k = rt::make_cols(k0, s0, k1, s1, k2, s2, k3, s3, n_cols);
  s.w = static_cast<const uint32_t*>(w);
  s.w_stride = w_stride;
  s.B = B;
  const int threads = 256;
  inv_kernel<<<rt::grid_for(B, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(s);
  return (int)cudaGetLastError();
}
