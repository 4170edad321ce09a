// K10: the Count-Min point query, for up to kMaxJobs queries in one launch.
//
// Replaces retina_tpu/ops/countmin.py CountMinSketch.query as the query
// programs run it: retina_tpu/timetravel/fold.py:163 range_extract (the
// span CMS re-count of every candidate row), :241 range_decode and
// parallel/telemetry.py:646 inv_decode (ops/invertible.py:229
// decode_verified), and the cluster top-k of retina_tpu/fleet/aggregator.py
// (_cluster_topk). For each row of a job: the column of its key in each of
// the depth rows (hash.cuh, seed d + 1 + cms_seed), the gather, and the u32
// minimum; then decode_verified's filter, ok' = ok & (est >=u32
// min_weight) and est' = ok' ? est : 0 (a job without a mask takes ok as
// all true, so at min_weight 0 it is the plain query).
//
// Bound on the H100: bytes, R * (C + depth) * 4 of key columns and
// gathered words read, R * 4 written (and R bytes of mask read and
// written); the hashes are depth * C folds of a few integer operations
// each.
//
// Design: the jobs (one a region of a window close's verify, one a query
// elsewhere) travel by value in one table, so a close's two regions cost one
// launch (the table, 904 bytes, is a __grid_constant__ parameter). Each job
// owns a run of blocks, a thread a row: the job's fields into registers,
// the key into registers (a word a column at its stride), its depth
// hashes and gathers, the minimum. Where every job has depth 4 and 4 key
// columns (every config's cms_depth and the flow key), both are template
// constants: the key's loads and the hash folds have no branch. How the
// depth rows' gathers issue then depends on the launch's size. A small one
// is bound by latency, so the depth rows' hash chains interleave and their
// gathers issue together, waiting once. From kIssueBlocksPerSm blocks a SM
// the hashes' integer issue bounds the kernel, and gathers issued together
// after every chain overlap no hashing: there the depth loop runs in order,
// each gather in flight while the next row of hashes computes (measured in
// PERF.md: the crossover lies between 65,536 and 131,072 rows). The table
// (512 KiB at 4 x 2^15) stays in L2. Two and four rows a thread, and a key
// row read as one 16-byte load, were measured and lost (PERF.md).
#include "hash.cuh"

namespace {

constexpr int kMaxJobs = 8;  // CMS_QUERY_MAX_JOBS in kernels/ops.py
constexpr int kThreads = 256;  // CMS_QUERY_THREADS in kernels/ops.py
constexpr int kIssueBlocksPerSm = 3;  // from here the depth loop runs in order

struct Job {
  const uint32_t* table;  // (depth, width) u32 counts
  const uint32_t* col[rt::kMaxCols];
  uint32_t* est;  // (n,) out
  const uint8_t* ok_in;  // (n,) bool mask, or null: all true
  uint8_t* ok_out;  // (n,) bool out
  long long n;  // rows
  int stride[rt::kMaxCols];  // element stride of each column
  uint32_t wmask;  // width - 1
  uint32_t seed;
  uint32_t min_weight;
  int depth;
  int n_cols;
  int block0;  // the job's first block
};

struct Table {
  int n_jobs;
  int n_blocks;
  Job jobs[kMaxJobs];
};

static_assert(sizeof(Job) == 112, "Job must match kernels/ops.py _QueryJob");
static_assert(sizeof(Table) == 8 + kMaxJobs * 112, "Table must match _QueryTable");

// hash_keys over a row's n columns with every index a constant, so the
// key stays in registers (a loop to a run-time n would index it).
__device__ __forceinline__ uint32_t hash_row(const uint32_t (&key)[rt::kMaxCols], int n,
                                             uint32_t seed) {
  uint32_t h = rt::hash_init(seed);
#pragma unroll
  for (int c = 0; c < rt::kMaxCols; ++c)
    if (c < n) h = rt::hash_step(h, key[c]);
  return h;
}

// kFixed: every job has depth 4 and 4 key columns, else both are read at
// run time. kUnroll: 4, the depth rows' chains interleaved and their
// gathers issued together, or 1, the depth rows in order.
template <bool kFixed, int kUnroll>
__global__ void __launch_bounds__(kThreads) query_kernel(const __grid_constant__ Table t) {
  int j = 0;
  while (j + 1 < t.n_jobs && (int)blockIdx.x >= t.jobs[j + 1].block0) ++j;
  const Job& job = t.jobs[j];
  const long long i = (long long)((int)blockIdx.x - job.block0) * kThreads + threadIdx.x;
  if (i >= job.n) return;
  // The job's fields once, into registers.
  const uint32_t* const table = job.table;
  const int n_cols = kFixed ? rt::kMaxCols : job.n_cols;
  const int depth = kFixed ? 4 : job.depth;
  const uint32_t wmask = job.wmask, seed = job.seed;
  uint32_t key[rt::kMaxCols] = {};
#pragma unroll
  for (int c = 0; c < rt::kMaxCols; ++c)
    if (c < n_cols) key[c] = job.col[c][i * job.stride[c]];
  uint32_t est = 0xFFFFFFFFu;
#pragma unroll kUnroll
  for (int d = 0; d < depth; ++d)
    est = min(est, __ldg(table + (size_t)d * (wmask + 1u) +
                         (hash_row(key, n_cols, (uint32_t)(d + 1) + seed) & wmask)));
  const bool ok = (job.ok_in == nullptr || job.ok_in[i]) && est >= job.min_weight;
  job.est[i] = ok ? est : 0u;
  job.ok_out[i] = ok;
}

// SMs of the current device, found once.
int sm_count() {
  static int cache[16];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 16) dev = 15;
  if (cache[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n > 0 ? n : 1;
  }
  return cache[dev];
}

}  // namespace

// One launch for the jobs of ``table`` (a Table): the fixed-shape instance
// when every job has depth 4 and 4 key columns (its depth rows in order from
// kIssueBlocksPerSm blocks a SM), else the instance that reads both.
extern "C" int cms_query(const void* table, void* stream) {
  const Table& t = *static_cast<const Table*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool fixed = true;
  for (int j = 0; j < t.n_jobs; ++j)
    fixed = fixed && t.jobs[j].depth == 4 && t.jobs[j].n_cols == rt::kMaxCols;
  if (!fixed)
    query_kernel<false, 1><<<t.n_blocks, kThreads, 0, st>>>(t);
  else if (t.n_blocks >= kIssueBlocksPerSm * sm_count())
    query_kernel<true, 1><<<t.n_blocks, kThreads, 0, st>>>(t);
  else
    query_kernel<true, 4><<<t.n_blocks, kThreads, 0, st>>>(t);
  return (int)cudaGetLastError();
}
