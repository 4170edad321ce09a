// K2: heavy-hitter update, Count-Min sketch plus candidate slot table.
//
// Replaces retina_tpu/ops/topk.py:177 HeavyHitterSketch.update, i.e.
// ops/countmin.py:81 update, :103 query and ops/topk.py:74 TopKTable.update:
// add each row's weight into all d CMS rows at its hashed columns; query
// the min over rows at every key of the batch once all adds have landed;
// scatter-max that estimate into the key's slot count; rows whose estimate
// equals the slot's new count write their key row into the slot.
//
// Bound on the H100: bytes, B * (4C + 4) of keys and weights (C key
// columns), plus the CMS (d, w) and table (S, C+1) read and written once.
// What kept a one-thread-a-row design at ~65x that bound is the atomics:
// d global atomicAdds and one 64-bit atomicMax per weighted row, and a
// Zipf stream puts its hot keys' rows (the top flow is about a fifth of
// them) on the same few words, where the atomics serialise in L2.
//
// Design: a key's rows are summed on the SM before anything touches
// device memory, so device memory sees one add per distinct key of a
// chunk, not one per row. Three launches serve up to three sketches of one
// batch (the step's flow, service and DNS instances, each with its own
// keys, weights, seeds and tables): a block takes (instance, chunk) pairs
// in turn, so the sketches share one persistent grid.
//   (a) hh_add: per chunk of R = 2048 rows, the weighted rows' keys and
//       weights are staged in shared memory, packed to the front (a warp
//       ballot and one shared atomic a warp), so the work below is that of
//       the weighted rows however few they are (~3% of rows on the deployed
//       path); a chunk's weights are loaded while the chunk before is
//       summed, hiding their latency. Each staged row then adds its weight
//       (u32, mod 2^32 as the CMS adds) and its row into an open-addressed
//       table of 2R entries in shared memory keyed by the full key (the
//       first claimer's staged row names the key; 2R entries never fill).
//       Each distinct key then makes its d global atomicAdds and writes its
//       d CMS columns, its slot and its last weighted row to its chunk's
//       list in scratch. Threads also seed packed[s] = counts[s] << 32.
//   (b) hh_offer: per entry of every chunk's list, once all adds have
//       landed: est = min over the d columns; est 0 offers nothing; one
//       atomicMax of (est << 32 | row + 1) into packed[slot], skipped where
//       the word (read from L2) already beats it: the word only grows, and
//       most keys of a Zipf stream lose to their slot's heavy hitter.
//   (c) hh_write: per slot, counts = high word; if the low word names a
//       row, that row's key columns are written (one thread a slot, so a
//       row is never torn between two tied keys).
// Phase (b) reads phase (a)'s lists rather than aggregate the chunk again:
// a list entry is d + 2 words written and read once, coalesced, where a
// second pass would read every row's keys and hash them again.
// R: large enough that a chunk holds many repeats of the hot keys, small
// enough that two blocks of 512 threads (104 KiB of shared memory at C = 4)
// fit on an SM. A block walks every sketch's chunks blockIdx.x, + gridDim.x,
// ... in turn (32-bit counters: no 64-bit division in the loop).
// Measured on the H100 and so left out: merging a warp's equal keys first
// (__match_any_sync on the key's hash) cost more than the shared-memory
// atomics it saved.
//
// Results are bit for bit the plain version's: u32 adds commute; once all
// adds have landed every row of a key has the same estimate, so the
// maximum of (est << 32 | row + 1) over a slot's rows equals the maximum
// over its keys of (est << 32 | last weighted row + 1), taken across
// chunks by the atomicMax: the largest estimate, and among equal estimates
// the last row in batch order. A slot whose old count equals the batch's
// best estimate is rewritten too, as in the reference (est == new count).
// Rows of weight 0 stage nothing and offer nothing.
//
// cms_update (row 12, retina_tpu/ops/countmin.py:122 cms.update_jit) is
// phase (a) alone, with no list and no candidate table.
#include "hash.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 2048;        // R, rows a chunk
constexpr int kTable = 2 * kChunk;  // shared table entries
constexpr int kRows = kChunk / kThreads;  // rows a thread stages a chunk
constexpr int kMaxInst = 3;
constexpr int kMaxDepth = 8;        // CMS rows a key hashes into
constexpr int kFields = 22;         // int64 fields of one instance record
constexpr unsigned kAll = 0xFFFFFFFFu;

struct HH {
  uint32_t* cms;               // (depth, width)
  uint32_t* key_rows;          // (S, C)
  uint32_t* counts;            // (S,)
  unsigned long long* packed;  // (S,) scratch
  uint32_t* list;              // (n_chunks, depth + 2, kChunk) scratch; null: add only
  uint32_t* list_n;            // (n_chunks,) distinct keys of each chunk
  rt::Cols keys;
  const uint32_t* w;
  long long ws;
  int depth;
  uint32_t wmask;
  uint32_t cms_seed;
  uint32_t n_slots;
  uint32_t table_seed;
};

struct Batch {
  HH inst[kMaxInst];
  int n_inst;
  int max_cols;
  long long n;
  long long n_chunks;
};

__host__ __device__ constexpr int add_smem(int max_cols) {
  return (3 * kTable + (3 + max_cols) * kChunk) * 4;
}

__device__ __forceinline__ void cms_cols(const HH& a, const uint32_t* key, uint32_t* col) {
#pragma unroll
  for (int d = 0; d < kMaxDepth; ++d)
    col[d] = d < a.depth ? (uint32_t)d * (a.wmask + 1u) +
                               (rt::hash_keys(key, a.keys.n, (uint32_t)(d + 1) + a.cms_seed) &
                                a.wmask)
                         : 0u;
}

// The next (sketch, chunk) pair of a block: chunks blockIdx.x, + gridDim.x,
// ... of each sketch in turn.
__device__ __forceinline__ void next_pair(int& k, int& chunk, int n_chunks) {
  chunk += gridDim.x;
  if (chunk >= n_chunks) {
    chunk = blockIdx.x;
    ++k;
  }
}

__global__ void __launch_bounds__(kThreads, 2) hh_add(const __grid_constant__ Batch b) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t n_staged, n_distinct;
  uint32_t* owner = smem;               // kTable: the claiming staged row + 1, 0 if free
  uint32_t* sum = owner + kTable;       // kTable: the key's summed weight
  uint32_t* last = sum + kTable;        // kTable: the key's last weighted row
  uint32_t* distinct = last + kTable;   // kChunk: claimed entries in claim order
  uint32_t* sw = distinct + kChunk;     // kChunk: staged weights
  uint32_t* sj = sw + kChunk;           // kChunk: staged rows' places in the chunk
  uint32_t* skey = sj + kChunk;         // (max_cols, kChunk): staged keys
  const int lane = threadIdx.x & 31;
  const int n_chunks = (int)b.n_chunks;

  for (int k = 0; k < b.n_inst; ++k) {
    const HH& a = b.inst[k];
    for (int s = blockIdx.x * kThreads + threadIdx.x; s < (int)a.n_slots; s += gridDim.x * kThreads)
      a.packed[s] = (unsigned long long)a.counts[s] << 32;
  }
  if ((int)blockIdx.x >= n_chunks) return;
  for (int t = threadIdx.x; t < kTable; t += kThreads) owner[t] = sum[t] = last[t] = 0u;
  if (threadIdx.x == 0) n_staged = n_distinct = 0u;
  __syncthreads();

  // A chunk's weights, kRows a thread, are loaded while the chunk before is
  // summed, so that their latency hides behind it.
  uint32_t wv[kRows];
  auto load_weights = [&](int k, int chunk) {
    const HH& a = b.inst[k < b.n_inst ? k : 0];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = (long long)chunk * kChunk + threadIdx.x + r * kThreads;
      wv[r] = (k < b.n_inst && i < b.n) ? a.w[i * a.ws] : 0u;
    }
  };
  int k = 0, chunk = blockIdx.x;
  load_weights(k, chunk);
  while (k < b.n_inst) {
    const HH& a = b.inst[k];
    const long long base = (long long)chunk * kChunk;
    const int nc = a.keys.n;

    // Stage the weighted rows, packed to the front: the work below costs
    // what the weighted rows cost, however few they are.
    uint32_t at[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned on = __ballot_sync(kAll, wv[r] != 0u);
      uint32_t first = 0u;
      if (lane == 0 && on != 0u) first = atomicAdd(&n_staged, (uint32_t)__popc(on));
      at[r] = __shfl_sync(kAll, first, 0) + (uint32_t)__popc(on & ((1u << lane) - 1u));
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (wv[r] == 0u) continue;
      const long long i = base + threadIdx.x + r * kThreads;
      sw[at[r]] = wv[r];
      sj[at[r]] = (uint32_t)(threadIdx.x + r * kThreads);
#pragma unroll
      for (int c = 0; c < rt::kMaxCols; ++c)
        if (c < nc) skey[c * kChunk + at[r]] = a.keys.p[c][i * a.keys.stride[c]];
    }
    int next_k = k, next_chunk = chunk;
    next_pair(next_k, next_chunk, n_chunks);
    load_weights(next_k, next_chunk);
    __syncthreads();

    // Each staged row adds its weight and row into its key's entry.
    const uint32_t ns = n_staged;
    for (uint32_t j = threadIdx.x; j < ns; j += kThreads) {
      uint32_t key[rt::kMaxCols];
#pragma unroll
      for (int c = 0; c < rt::kMaxCols; ++c) key[c] = c < nc ? skey[c * kChunk + j] : 0u;
      uint32_t t = rt::hash_keys(key, nc, 0x5EED5u) & (kTable - 1);
      for (;;) {
        const uint32_t prev = atomicCAS(owner + t, 0u, j + 1u);
        if (prev == 0u) {
          distinct[atomicAdd(&n_distinct, 1u)] = t;
          break;
        }
        bool eq = true;
#pragma unroll
        for (int c = 0; c < rt::kMaxCols; ++c)
          if (c < nc) eq &= skey[c * kChunk + prev - 1u] == key[c];
        if (eq) break;
        t = (t + 1u) & (kTable - 1);
      }
      atomicAdd(sum + t, sw[j]);
      atomicMax(last + t, sj[j]);
    }
    __syncthreads();

    const uint32_t nd = n_distinct;
    if (threadIdx.x == 0) n_staged = 0u;  // every thread has read it
    uint32_t* list = a.list ? a.list + (long long)chunk * (a.depth + 2) * kChunk : nullptr;
    for (uint32_t e = threadIdx.x; e < nd; e += kThreads) {
      const uint32_t t = distinct[e];
      const uint32_t r = owner[t] - 1u;
      const uint32_t s = sum[t];
      if (s != 0u || list) {
        uint32_t key[rt::kMaxCols];
#pragma unroll
        for (int c = 0; c < rt::kMaxCols; ++c) key[c] = c < nc ? skey[c * kChunk + r] : 0u;
        uint32_t col[kMaxDepth];
        cms_cols(a, key, col);
#pragma unroll
        for (int d = 0; d < kMaxDepth; ++d)
          if (d < a.depth && s != 0u) atomicAdd(a.cms + col[d], s);
        if (list) {
#pragma unroll
          for (int d = 0; d < kMaxDepth; ++d)
            if (d < a.depth) list[d * kChunk + e] = col[d];
          list[a.depth * kChunk + e] =
              rt::hash_keys(key, nc, 0x70CCu + a.table_seed) & (a.n_slots - 1u);
          list[(a.depth + 1) * kChunk + e] = (uint32_t)(base + last[t]);
        }
      }
      owner[t] = sum[t] = last[t] = 0u;
    }
    if (list && threadIdx.x == 0) a.list_n[chunk] = nd;
    __syncthreads();
    if (threadIdx.x == 0) n_distinct = 0u;
    k = next_k;
    chunk = next_chunk;
  }
}

__global__ void __launch_bounds__(kThreads) hh_offer(const __grid_constant__ Batch b) {
  const int n_chunks = (int)b.n_chunks;
  if ((int)blockIdx.x >= n_chunks) return;
  for (int k = 0, chunk = blockIdx.x; k < b.n_inst; next_pair(k, chunk, n_chunks)) {
    const HH& a = b.inst[k];
    const uint32_t nd = a.list_n[chunk];
    const uint32_t* list = a.list + (long long)chunk * (a.depth + 2) * kChunk;
    for (uint32_t e = threadIdx.x; e < nd; e += kThreads) {
      uint32_t est = 0xFFFFFFFFu;
      for (int d = 0; d < a.depth; ++d) est = min(est, a.cms[list[d * kChunk + e]]);
      if (est == 0u) continue;
      const uint32_t slot = list[a.depth * kChunk + e];
      const unsigned long long v =
          ((unsigned long long)est << 32) | (unsigned long long)(list[(a.depth + 1) * kChunk + e] + 1u);
      // The word only grows: an offer it already beats needs no atomic.
      if (v > __ldcg(a.packed + slot)) atomicMax(a.packed + slot, v);
    }
  }
}

__global__ void __launch_bounds__(kThreads) hh_write(const __grid_constant__ Batch b) {
  for (int k = 0; k < b.n_inst; ++k) {
    const HH& a = b.inst[k];
    for (int s = blockIdx.x * kThreads + threadIdx.x; s < (int)a.n_slots; s += gridDim.x * kThreads) {
      const unsigned long long p = a.packed[s];
      a.counts[s] = (uint32_t)(p >> 32);
      const uint32_t row1 = (uint32_t)p;
      if (row1 == 0u) continue;
      const long long row = (long long)row1 - 1;
      for (int c = 0; c < a.keys.n; ++c)
        a.key_rows[(long long)s * a.keys.n + c] = a.keys.p[c][row * a.keys.stride[c]];
    }
  }
}

// Instance record, kFields int64 each: cms, depth, width, cms_seed,
// key_rows, counts, n_slots, table_seed, packed, list, list_n, weights,
// weight stride, n_cols, four key pointers, four key strides.
HH record(const long long* f) {
  HH a;
  a.cms = reinterpret_cast<uint32_t*>(f[0]);
  a.depth = (int)f[1];
  a.wmask = (uint32_t)f[2] - 1u;
  a.cms_seed = (uint32_t)f[3];
  a.key_rows = reinterpret_cast<uint32_t*>(f[4]);
  a.counts = reinterpret_cast<uint32_t*>(f[5]);
  a.n_slots = (uint32_t)f[6];
  a.table_seed = (uint32_t)f[7];
  a.packed = reinterpret_cast<unsigned long long*>(f[8]);
  a.list = reinterpret_cast<uint32_t*>(f[9]);
  a.list_n = reinterpret_cast<uint32_t*>(f[10]);
  a.w = reinterpret_cast<const uint32_t*>(f[11]);
  a.ws = f[12];
  a.keys = rt::make_cols(reinterpret_cast<const void*>(f[14]), f[18],
                         reinterpret_cast<const void*>(f[15]), f[19],
                         reinterpret_cast<const void*>(f[16]), f[20],
                         reinterpret_cast<const void*>(f[17]), f[21], (int)f[13]);
  return a;
}

// SMs and resident hh_add blocks an SM, per device and max_cols, found once.
int add_grid(int max_cols, int* sms) {
  static int cache_sms[16], cache_per_sm[16][rt::kMaxCols + 1];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 16) dev = 15;
  if (cache_sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(hh_add, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         add_smem(rt::kMaxCols));
    cache_sms[dev] = n > 0 ? n : 1;
  }
  int& per_sm = cache_per_sm[dev][max_cols];
  if (per_sm == 0) {
    int p = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, hh_add, kThreads, add_smem(max_cols));
    per_sm = p > 0 ? p : 1;
  }
  *sms = cache_sms[dev];
  return cache_sms[dev] * per_sm;
}

int run(const long long* fields, int n_inst, long long n, bool add_only, cudaStream_t st) {
  if (n_inst < 1 || n_inst > kMaxInst || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Batch b = {};
  b.n_inst = n_inst;
  b.n = n;
  b.n_chunks = (n + kChunk - 1) / kChunk;
  long long max_slots = 0;
  for (int k = 0; k < n_inst; ++k) {
    b.inst[k] = record(fields + (long long)k * kFields);
    if (b.inst[k].keys.n > b.max_cols) b.max_cols = b.inst[k].keys.n;
    if ((long long)b.inst[k].n_slots > max_slots) max_slots = b.inst[k].n_slots;
  }
  int sms = 1;
  long long blocks = add_grid(b.max_cols, &sms);
  hh_add<<<(int)(blocks < b.n_chunks ? blocks : b.n_chunks), kThreads, add_smem(b.max_cols),
           st>>>(b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || add_only) return (int)err;
  blocks = 4LL * sms;
  hh_offer<<<(int)(blocks < b.n_chunks ? blocks : b.n_chunks), kThreads, 0, st>>>(b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hh_write<<<rt::grid_for(max_slots, kThreads), kThreads, 0, st>>>(b);
  return (int)cudaGetLastError();
}

}  // namespace

// Up to three sketches of one n-row batch, kFields int64 fields each (see
// record): three launches in all.
extern "C" int hh_update(const long long* fields, int n_inst, long long n, void* stream) {
  return run(fields, n_inst, n, false, static_cast<cudaStream_t>(stream));
}

// The Count-Min add alone, one record with list, list_n, packed, key_rows
// and counts null and n_slots 0: one launch.
extern "C" int cms_update(const long long* fields, long long n, void* stream) {
  return run(fields, 1, n, true, static_cast<cudaStream_t>(stream));
}
