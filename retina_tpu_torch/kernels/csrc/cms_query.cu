// K10: the Count-Min point query at R key rows.
//
// Replaces retina_tpu/ops/countmin.py CountMinSketch.query as the query
// programs run it: retina_tpu/timetravel/fold.py:163 range_extract (the
// span CMS re-count of every candidate row), :241 range_decode and
// parallel/telemetry.py:646 inv_decode (ops/invertible.py decode_verified),
// and the cluster top-k of retina_tpu/fleet/aggregator.py (_cluster_topk).
// For each row: the column of its key in each of the depth rows
// (hash.cuh, seed d + 1 + cms_seed), the gather, and the u32 minimum.
//
// Bound on the H100: bytes, R * (C + depth) * 4 of key columns and
// gathered words read and R * 4 written; the hashes are depth * C folds
// of a few integer operations each.
//
// Design: one thread per row. The gathers are random reads into a table
// of depth * width words (512 KiB at 4 x 2^15), which stays in L2.
#include "hash.cuh"

namespace {

__global__ void query_kernel(const uint32_t* __restrict__ table, int depth, uint32_t wmask,
                             uint32_t seed, rt::Cols keys, long long n,
                             uint32_t* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t key[rt::kMaxCols];
    rt::load_keys(keys, i, key);
    uint32_t est = 0xFFFFFFFFu;
    for (int d = 0; d < depth; ++d) {
      const uint32_t col = rt::hash_keys(key, keys.n, (uint32_t)(d + 1) + seed) & wmask;
      const uint32_t v = table[(size_t)d * (wmask + 1u) + col];
      est = v < est ? v : est;
    }
    out[i] = est;
  }
}

}  // namespace

extern "C" int cms_query(const void* table, int depth, int width, unsigned int seed,
                         const void* k0, long long s0, const void* k1, long long s1,
                         const void* k2, long long s2, const void* k3, long long s3, int n_cols,
                         long long n, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  query_kernel<<<rt::grid_for(n, threads), threads, 0, st>>>(
      static_cast<const uint32_t*>(table), depth, (uint32_t)width - 1u, seed,
      rt::make_cols(k0, s0, k1, s1, k2, s2, k3, s3, n_cols), n, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
