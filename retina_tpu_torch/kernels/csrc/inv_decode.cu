// K15: the invertible sketch's decode, for up to kMaxJobs regions in one
// launch.
//
// Replaces retina_tpu/ops/invertible.py:167 InvertibleSketch.decode (under
// :229 decode_verified, as parallel/telemetry.py:646 sharded.inv_decode and
// timetravel/fold.py:241 range_decode run it). For each of a region's D * W
// buckets, of weight w and planes p[0 .. 32(C+1)): bit b of the decoded
// words is the majority p[b] > w - p[b], compared as u32 (span-summed
// planes pass 2^31); the first C words are the key, the last its checksum;
// ok = w != 0, the checksum equals hash_cols(key, CHECK_SEED + seed), and
// the key re-hashes to its own position in its own row d = bucket / W
// (hash_cols(key, d + 1 + seed) mod W). The plain version is
// ops/invertible.py decode_many_plain.
//
// Bound on the H100: bytes, the planes and weights read once (5.9 MB for
// INVERTIBLE_CONFIG's two regions) and the key words, flags and tiers
// written once.
//
// Design: the regions (a window close's inv_flow and inv_hi, or a range
// query's) travel by value in one table, a __grid_constant__ parameter, so
// a close decodes in one launch; each region owns a run of blocks, found
// from its first block as K10 finds its jobs. The output is the layout the
// close returns: keys (M, C) row-major, ok (M,) and tier (M,), the regions
// end to end at each one's first row. One warp a bucket, C a template
// constant: lane i reads plane 32g + i of every word g (one coalesced
// 128-byte load a word), all C + 1 loads and the weight issued before the
// first __ballot_sync, whose word has bit i from lane i, as the reference's
// shifts order them. Every lane then holds the key; lane 0 hashes the
// checksum and lane 1 the key's own row at once, and a shuffle hands both
// to every lane. Lanes 0 .. C-1 store the C key words as one row-major
// store, and lane C writes ok and the tier. Two buckets a warp (their
// loads all issued together) at 4, 8 and 16 warps a block, and four at 8,
// were measured beside this and gained nothing (PERF.md).
#include "hash.cuh"

namespace {

constexpr int kMaxJobs = 2;  // INV_DECODE_MAX_JOBS in kernels/ops.py
constexpr int kWarps = 8;  // INV_DECODE_WARPS there: buckets a block, a warp each
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kCheckSeed = 0x1C3A9F71u;

struct Job {
  const uint32_t* planes;  // (n, 32(C+1)) u32
  const uint32_t* weights;  // (n,) u32
  long long n;  // buckets, D * W
  long long row0;  // the region's first output row
  uint32_t seed;
  int width_log2;  // W = 1 << width_log2
  int tier;
  int block0;  // the region's first block
};

struct Table {
  uint32_t* keys;  // (M, C) out
  uint8_t* ok;  // (M,) out
  int* tier;  // (M,) out
  int n_jobs;
  int n_cols;
  int n_blocks;
  int pad;
  Job jobs[kMaxJobs];
};

static_assert(sizeof(Job) == 48, "Job must match kernels/ops.py _DecodeJob");
static_assert(sizeof(Table) == 40 + kMaxJobs * 48, "Table must match _DecodeTable");

template <int C>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(const __grid_constant__ Table t) {
  int j = 0;
  while (j + 1 < t.n_jobs && (int)blockIdx.x >= t.jobs[j + 1].block0) ++j;
  const Job& job = t.jobs[j];
  // b is the same on every lane of a warp: a warp past the region leaves whole.
  const long long b = (long long)((int)blockIdx.x - job.block0) * kWarps + (threadIdx.x >> 5);
  if (b >= job.n) return;
  const int lane = threadIdx.x & 31;
  const uint32_t* p = job.planes + (size_t)b * (32 * (C + 1)) + lane;
  uint32_t v[C + 1];
  const uint32_t w = __ldg(job.weights + b);
#pragma unroll
  for (int g = 0; g <= C; ++g) v[g] = __ldg(p + 32 * g);
  uint32_t word[C + 1];
#pragma unroll
  for (int g = 0; g <= C; ++g) word[g] = __ballot_sync(kFull, v[g] > w - v[g]);
  const uint32_t wmask = (1u << job.width_log2) - 1u;
  const uint32_t d = (uint32_t)(b >> job.width_log2);
  uint32_t h = rt::hash_init(lane == 0 ? kCheckSeed + job.seed : d + 1u + job.seed);
#pragma unroll
  for (int g = 0; g < C; ++g) h = rt::hash_step(h, word[g]);
  const uint32_t check = __shfl_sync(kFull, h, 0);
  const uint32_t own = __shfl_sync(kFull, h, 1);
  const long long row = job.row0 + b;
  if (lane < C) {
    uint32_t mine = word[0];
#pragma unroll
    for (int g = 1; g < C; ++g)
      if (lane == g) mine = word[g];
    t.keys[row * C + lane] = mine;
  } else if (lane == C) {
    t.ok[row] = (w != 0u && word[C] == check && (own & wmask) == ((uint32_t)b & wmask)) ? 1 : 0;
    t.tier[row] = job.tier;
  }
}

}  // namespace

// One launch for the regions of ``table`` (a Table), at its n_cols (1 to 4).
extern "C" int inv_decode_many(const void* table, void* stream) {
  const Table& t = *static_cast<const Table*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = kWarps * 32;
  switch (t.n_cols) {
    case 1: decode_kernel<1><<<t.n_blocks, threads, 0, st>>>(t); break;
    case 2: decode_kernel<2><<<t.n_blocks, threads, 0, st>>>(t); break;
    case 3: decode_kernel<3><<<t.n_blocks, threads, 0, st>>>(t); break;
    case 4: decode_kernel<4><<<t.n_blocks, threads, 0, st>>>(t); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
