// K9: the N-way join of heavy-hitter candidate tables, for up to kMaxJobs
// families in one launch.
//
// Replaces the candidate-table branch of retina_tpu/timetravel/fold.py:102
// timetravel.range_fold and retina_tpu/fleet/aggregator.py:328 fleet.merge:
// retina_tpu/ops/topk.py:107 TopKTable.merge chained over N tables. Per
// slot, the merge keeps the greater (count, key row) pair, comparing the
// count first and then the key columns in order, all as u32. That order
// is total, and two entries equal under it are identical, so the chained
// pairwise fold over N tables is the per-slot maximum over N, whatever
// the shape of the reduction that computes it: the greatest count, and
// among the entries of that count the greatest key row.
//
// Bound on the H100: bytes, N * S * (C + 1) * 4 read and S * (C + 1) * 4
// written a family (5.3 MB for the three families of a 64-node epoch).
//
// Design: the families of a fold (flow, svc and dns) travel by value in
// one table, a __grid_constant__ parameter, so a range query or a fleet
// merge joins them in one launch; each family owns a run of blocks, found
// from its first block as K10 finds its jobs, and C (1 to 4) is a template
// constant of the block's code. A block takes kSlots consecutive slots (x)
// times kLanes table lanes (y); thread (x, y) takes the tables k = y,
// y + kLanes, ... of slot x, kBatch at a time, each table's count and key
// row loaded together (so each load instruction of a warp reads kSlots
// consecutive counts, or kSlots consecutive key rows), all of a batch's
// loads issued before the first compare: every byte is read once, and no
// load waits on a compare. Each thread keeps its greatest (count, key row)
// in registers, starting from (0, a row of zeros), the least entry there
// is, which leaves the maximum unchanged; the lanes' entries then reduce
// in shared memory in a tree of log2(kLanes) steps. Lanes y < C write the
// slot's C key words and lane kLanes - 1 its count. Measured beside it
// (PERF.md): a first design that found the greatest count first and then,
// in a second pass, read a key row only where its count tied (8-15%
// slower: two dependent rounds of loads), and 4 to 32 table lanes with
// batches of 2 to 16 tables (8 lanes of 4 the fastest at 32 and 64 tables).
#include "hash.cuh"

namespace {

constexpr int kMaxJobs = 3;  // TOPK_JOIN_MAX_JOBS in kernels/ops.py
constexpr int kSlots = 32;  // TOPK_JOIN_SLOTS there: slots a block, one a lane of a warp
constexpr int kLanes = 8;  // table lanes a block (threads kSlots x kLanes)
constexpr int kBatch = 4;  // tables a thread loads before it compares

struct Job {
  const uint32_t* keys;  // (N, S, C) u32
  const uint32_t* counts;  // (N, S) u32
  uint32_t* out_keys;  // (S, C) out
  uint32_t* out_counts;  // (S,) out
  long long n_tables;
  long long n_slots;
  int n_cols;
  int block0;  // the family's first block
};

struct Table {
  int n_jobs;
  int n_blocks;
  Job jobs[kMaxJobs];
};

static_assert(sizeof(Job) == 56, "Job must match kernels/ops.py _JoinJob");
static_assert(sizeof(Table) == 8 + kMaxJobs * 56, "Table must match _JoinTable");

// (ca, a) > (cb, b): the counts, then the key rows column by column, as u32.
template <int C>
__device__ __forceinline__ bool greater(uint32_t ca, const uint32_t (&a)[C], uint32_t cb,
                                        const uint32_t (&b)[C]) {
  if (ca != cb) return ca > cb;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (a[j] != b[j]) return a[j] > b[j];
  return false;
}

// The block's slots of one family, C its key columns; the kernel's shared
// arrays hold each lane's greatest count and key row of each slot.
template <int C>
__device__ __forceinline__ void join_slots(const Job& job, int tile,
                                           uint32_t (&sh_count)[kLanes][kSlots],
                                           uint32_t (&sh_key)[kLanes][rt::kMaxCols][kSlots]) {
  const int x = threadIdx.x, y = threadIdx.y;
  const long long n = job.n_tables, n_slots = job.n_slots;
  const long long s = (long long)tile * kSlots + x;
  const bool live = s < n_slots;
  uint32_t best = 0u, key[C] = {};
  if (live) {
    const uint32_t* counts = job.counts + s;
    const uint32_t* rows = job.keys + s * C;
    for (long long k0 = y; k0 < n; k0 += kLanes * kBatch) {
      uint32_t c[kBatch], row[kBatch][C];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const long long k = k0 + (long long)i * kLanes;
        const bool in = k < n;
        c[i] = in ? __ldg(counts + k * n_slots) : 0u;
#pragma unroll
        for (int j = 0; j < C; ++j) row[i][j] = in ? __ldg(rows + k * n_slots * C + j) : 0u;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (greater<C>(c[i], row[i], best, key)) {
          best = c[i];
#pragma unroll
          for (int j = 0; j < C; ++j) key[j] = row[i][j];
        }
    }
  }
  sh_count[y][x] = best;
#pragma unroll
  for (int j = 0; j < C; ++j) sh_key[y][j][x] = key[j];
  __syncthreads();
#pragma unroll
  for (int half = kLanes / 2; half > 0; half >>= 1) {
    if (y < half) {
      uint32_t other[C];
      const uint32_t c = sh_count[y + half][x];
#pragma unroll
      for (int j = 0; j < C; ++j) other[j] = sh_key[y + half][j][x];
      if (greater<C>(c, other, best, key)) {
        best = c;
        sh_count[y][x] = c;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          key[j] = other[j];
          sh_key[y][j][x] = other[j];
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  if (y < C) job.out_keys[s * C + y] = sh_key[0][y][x];
  if (y == kLanes - 1) job.out_counts[s] = sh_count[0][x];
}

__global__ void __launch_bounds__(kSlots * kLanes) join_kernel(const __grid_constant__ Table t) {
  int j = 0;
  while (j + 1 < t.n_jobs && (int)blockIdx.x >= t.jobs[j + 1].block0) ++j;
  const Job& job = t.jobs[j];
  const int tile = (int)blockIdx.x - job.block0;
  __shared__ uint32_t sh_count[kLanes][kSlots];
  __shared__ uint32_t sh_key[kLanes][rt::kMaxCols][kSlots];
  switch (job.n_cols) {  // the same for every thread of the block
    case 1: join_slots<1>(job, tile, sh_count, sh_key); break;
    case 2: join_slots<2>(job, tile, sh_count, sh_key); break;
    case 3: join_slots<3>(job, tile, sh_count, sh_key); break;
    default: join_slots<4>(job, tile, sh_count, sh_key); break;
  }
}

}  // namespace

// One launch for the families of ``table`` (a Table).
extern "C" int topk_join_many(const void* table, void* stream) {
  const Table& t = *static_cast<const Table*>(table);
  join_kernel<<<t.n_blocks, dim3(kSlots, kLanes), 0, static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}
