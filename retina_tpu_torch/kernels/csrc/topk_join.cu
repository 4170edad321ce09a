// K9: the N-way join of heavy-hitter candidate tables.
//
// Replaces the candidate-table branch of retina_tpu/timetravel/fold.py:102
// timetravel.range_fold and retina_tpu/fleet/aggregator.py:328 fleet.merge:
// retina_tpu/ops/topk.py:107 TopKTable.merge chained over N tables. Per
// slot, the merge keeps the greater (count, key row) pair, comparing the
// count first and then the key columns in order, all as u32. That order
// is total, so the chained pairwise fold over N tables is the per-slot
// maximum over N, which one pass computes.
//
// Bound on the H100: bytes, N * S * (C + 1) * 4 read and S * (C + 1) * 4
// written; at S = 2048 slots a launch is a few blocks, so launch latency
// sets the time.
//
// Design: one thread per slot walks the N tables in order and keeps the
// index of the best entry so far; a later entry replaces it only when it
// is strictly greater, so among equal entries (equal count and key) the
// first stays, which has the same count and key. The winner's key row and
// count are written once.
#include "hash.cuh"

namespace {

__global__ void join_kernel(const uint32_t* __restrict__ keys,
                            const uint32_t* __restrict__ counts, long long n_tables,
                            long long n_slots, int n_cols, uint32_t* __restrict__ out_keys,
                            uint32_t* __restrict__ out_counts) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < n_slots;
       s += (long long)gridDim.x * blockDim.x) {
    long long best = 0;
    uint32_t best_count = counts[s];
    for (long long k = 1; k < n_tables; ++k) {
      const uint32_t c = counts[k * n_slots + s];
      bool take = c > best_count;
      if (c == best_count) {
        const uint32_t* a = keys + (best * n_slots + s) * n_cols;
        const uint32_t* b = keys + (k * n_slots + s) * n_cols;
        for (int j = 0; j < n_cols; ++j) {
          if (a[j] != b[j]) {
            take = b[j] > a[j];
            break;
          }
        }
      }
      if (take) {
        best = k;
        best_count = c;
      }
    }
    out_counts[s] = best_count;
    const uint32_t* row = keys + (best * n_slots + s) * n_cols;
    for (int j = 0; j < n_cols; ++j) out_keys[s * n_cols + j] = row[j];
  }
}

}  // namespace

extern "C" int topk_join(const void* keys, const void* counts, long long n_tables,
                         long long n_slots, int n_cols, void* out_keys, void* out_counts,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  join_kernel<<<rt::grid_for(n_slots, threads), threads, 0, st>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(counts), n_tables,
      n_slots, n_cols, static_cast<uint32_t*>(out_keys), static_cast<uint32_t*>(out_counts));
  return (int)cudaGetLastError();
}
