// K8: the N-way fold of the stacked catalog arrays, all arrays in one launch.
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
// Design: a range query or a fleet epoch folds about a dozen arrays of one
// N, from 4 KiB (the HLL banks, the totals) to megabytes (the CM tables).
// One launch a fold takes them all: a table of array records (source,
// length, op, output) passed by value, and a grid over the arrays' tiles laid
// end to end, so a small array is a few blocks of a full grid rather than a
// launch that leaves the card idle. A thread folds 4 consecutive elements:
// with one 16-byte load a slot where the array's base is 16-byte aligned and
// its length a multiple of 4 (then every slot is aligned), with 4 scalar
// loads otherwise and on the tail. The loop over the N slots loads 8 slots
// before it combines them, so 8 16-byte loads a thread are in flight. Each
// element is combined in slot order (slot 0, then 1, ...), so a float sum
// adds in the plain version's order and equals it bit for bit (__fadd_rn:
// never contracted into anything else).
#include "hash.cuh"

namespace {

enum Op { kSumU32 = 0, kSumF32 = 1, kMaxU32 = 2 };

constexpr int kThreads = 256;
constexpr int kPer = 4;                 // consecutive elements a thread folds
constexpr int kTile = kThreads * kPer;  // elements a block folds
constexpr int kBatch = 8;               // slots loaded before they are combined
constexpr int kMaxArrays = 32;          // arrays a launch folds
constexpr int kFields = 4;              // int64 fields of an array record

struct Arr {
  const uint32_t* src;  // (N, n)
  uint32_t* out;        // (n,)
  long long n;
  long long tile0;  // the array's first tile in the grid
  int op;
  int vec;  // 16-byte loads: base 16-byte aligned, n a multiple of 4
};

struct Fold {
  Arr a[kMaxArrays];
  long long n_slots;
  int n_arrays;
};

template <int OP>
__device__ __forceinline__ uint32_t combine(uint32_t acc, uint32_t v) {
  if (OP == kMaxU32) return v > acc ? v : acc;
  if (OP == kSumF32) return __float_as_uint(__fadd_rn(__uint_as_float(acc), __uint_as_float(v)));
  return acc + v;
}

template <int OP>
__device__ __forceinline__ uint4 combine(uint4 acc, uint4 v) {
  return make_uint4(combine<OP>(acc.x, v.x), combine<OP>(acc.y, v.y), combine<OP>(acc.z, v.z),
                    combine<OP>(acc.w, v.w));
}

// T is uint4 (one 16-byte load a slot) or uint32_t (one element): the
// fold of N slots of one T at p, slots `step` Ts apart.
template <int OP, typename T>
__device__ __forceinline__ T fold_slots(const T* __restrict__ p, long long step, long long n_slots) {
  T acc = __ldg(p);
  long long k = 1;
  for (; k + kBatch <= n_slots; k += kBatch) {
    T v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = __ldg(p + (k + j) * step);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc = combine<OP>(acc, v[j]);
  }
  for (; k < n_slots; ++k) acc = combine<OP>(acc, __ldg(p + k * step));
  return acc;
}

template <int OP>
__device__ __forceinline__ void fold_four(const Arr& a, long long n_slots, long long i) {
  if (a.vec) {
    const uint4 r = fold_slots<OP>(reinterpret_cast<const uint4*>(a.src + i), a.n / 4, n_slots);
    *reinterpret_cast<uint4*>(a.out + i) = r;
    return;
  }
  const int m = a.n - i < kPer ? (int)(a.n - i) : kPer;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (j < m) a.out[i + j] = fold_slots<OP>(a.src + i + j, a.n, n_slots);
}

__global__ void __launch_bounds__(kThreads) fold_kernel(const __grid_constant__ Fold f) {
  // This block's array: the last whose first tile is at or before the block.
  int k = 0;
  while (k + 1 < f.n_arrays && f.a[k + 1].tile0 <= (long long)blockIdx.x) ++k;
  const Arr& a = f.a[k];
  const long long i = ((long long)blockIdx.x - a.tile0) * kTile + (long long)threadIdx.x * kPer;
  if (i >= a.n) return;
  switch (a.op) {
    case kSumU32:
      fold_four<kSumU32>(a, f.n_slots, i);
      break;
    case kSumF32:
      fold_four<kSumF32>(a, f.n_slots, i);
      break;
    default:
      fold_four<kMaxU32>(a, f.n_slots, i);
      break;
  }
}

}  // namespace

// Folds n_arrays stacked arrays of n_slots slots each, kFields int64 fields
// an array (source, elements a slot, op, output), in one launch.
extern "C" int fold(const long long* fields, int n_arrays, long long n_slots, void* stream) {
  if (n_arrays < 1 || n_arrays > kMaxArrays || n_slots < 1) return (int)cudaErrorInvalidValue;
  Fold f = {};
  f.n_arrays = n_arrays;
  f.n_slots = n_slots;
  long long tiles = 0;
  for (int k = 0; k < n_arrays; ++k) {
    const long long* r = fields + (long long)k * kFields;
    Arr& a = f.a[k];
    a.src = reinterpret_cast<const uint32_t*>(r[0]);
    a.n = r[1];
    a.op = (int)r[2];
    a.out = reinterpret_cast<uint32_t*>(r[3]);
    if (a.n < 1 || a.op < kSumU32 || a.op > kMaxU32) return (int)cudaErrorInvalidValue;
    a.vec = (r[0] % 16 == 0) && (r[3] % 16 == 0) && (a.n % kPer == 0);
    a.tile0 = tiles;
    tiles += (a.n + kTile - 1) / kTile;
  }
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fold_kernel<<<(int)tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(f);
  return (int)cudaGetLastError();
}
