// K8: the N-way fold of one stacked catalog array.
//
// Replaces the sum and max branches of retina_tpu/timetravel/fold.py:102
// timetravel.range_fold and retina_tpu/fleet/aggregator.py:328 fleet.merge
// (the pairwise merges they chain are ops/countmin.py:109, entropy.py:78,
// invertible.py:208 and hyperloglog.py:119): N snapshots of one array,
// stacked as (N, n), reduce to (n,) by u32 sum (CM tables, totals,
// invertible planes and weights; wraps mod 2^32), f32 sum (entropy
// histograms) or u32 max (HLL register banks). The candidate tables are
// K9 (topk_join.cu).
//
// Bound on the H100: bytes, N * n * 4 read and n * 4 written; one add or
// max per element read.
//
// Design: one thread per element loops over the N slots in slot order,
// so a float sum adds in the same order as the plain version (slot 0,
// then 1, ...) and equals it bit for bit. Threads of a warp read
// consecutive words of one slot, so every load is coalesced; the loop over
// slots is unrolled so that several independent loads are in flight.
#include "hash.cuh"

namespace {

enum Op { kSumU32 = 0, kSumF32 = 1, kMaxU32 = 2 };

template <typename T, int OP>
__global__ void fold_kernel(const T* __restrict__ src, long long n_slots, long long n,
                            T* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    T acc = src[i];
#pragma unroll 8
    for (long long k = 1; k < n_slots; ++k) {
      const T v = src[k * n + i];
      if (OP == kMaxU32) {
        acc = v > acc ? v : acc;
      } else if (OP == kSumF32) {
        acc = __fadd_rn(acc, v);
      } else {
        acc += v;
      }
    }
    out[i] = acc;
  }
}

}  // namespace

extern "C" int fold(const void* src, long long n_slots, long long n, int op, void* out,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = rt::grid_for(n, threads);
  switch (op) {
    case kSumU32:
      fold_kernel<uint32_t, kSumU32><<<blocks, threads, 0, st>>>(
          static_cast<const uint32_t*>(src), n_slots, n, static_cast<uint32_t*>(out));
      break;
    case kSumF32:
      fold_kernel<float, kSumF32><<<blocks, threads, 0, st>>>(
          static_cast<const float*>(src), n_slots, n, static_cast<float*>(out));
      break;
    case kMaxU32:
      fold_kernel<uint32_t, kMaxU32><<<blocks, threads, 0, st>>>(
          static_cast<const uint32_t*>(src), n_slots, n, static_cast<uint32_t*>(out));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
