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
// columns), plus the CMS (d, w) and table (S, C+1) read and written once;
// then atomics. Phase (a) makes d atomicAdds per weighted row, spread over
// d * w words; the hot keys of a Zipf stream land on the same words, so the
// adds of one heavy key serialise in L2.
//
// Design: three launches per instance, because the query must see every
// add of the batch, which a grid-wide barrier inside one launch would not
// give without a cooperative launch:
//   (a) hh_add:   CMS atomicAdds; threads < S also seed packed[s] with
//                 counts[s] << 32.
//   (b) hh_offer: per weighted row, est = min over rows; atomicMax of the
//                 64-bit word (est << 32 | row + 1) into packed[slot].
//   (c) hh_write: per slot, counts = high word; if the low word names a
//                 row, that row's key columns are written.
// Packing the estimate above the row index makes the slot's winner one
// deterministic row: the largest estimate, and among equal estimates the
// last row in batch order. A slot whose old count equals the batch's best
// estimate is rewritten too, as in the reference (est == new count). Only
// one thread writes a slot's key row, so a row is never torn between two
// tied keys.
#include "hash.cuh"

namespace {

struct HH {
  uint32_t* cms;          // (depth, width)
  uint32_t* key_rows;     // (S, C)
  uint32_t* counts;       // (S,)
  unsigned long long* packed;  // (S,) scratch
  rt::Cols keys;
  const uint32_t* w;
  long long ws;
  long long n;
  int depth;
  uint32_t wmask;
  uint32_t cms_seed;
  uint32_t n_slots;
  uint32_t table_seed;
};

__global__ void hh_add(HH a) {
  const long long span = a.n > a.n_slots ? a.n : a.n_slots;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < span;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < a.n_slots) a.packed[i] = (unsigned long long)a.counts[i] << 32;
    if (i >= a.n) continue;
    const uint32_t w = a.w[i * a.ws];
    if (w == 0u) continue;
    uint32_t key[rt::kMaxCols];
    rt::load_keys(a.keys, i, key);
    for (int d = 0; d < a.depth; ++d) {
      const uint32_t col = rt::hash_keys(key, a.keys.n, (uint32_t)(d + 1) + a.cms_seed) & a.wmask;
      atomicAdd(a.cms + (size_t)d * (a.wmask + 1u) + col, w);
    }
  }
}

__global__ void hh_offer(HH a) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < a.n;
       i += (long long)gridDim.x * blockDim.x) {
    if (a.w[i * a.ws] == 0u) continue;
    uint32_t key[rt::kMaxCols];
    rt::load_keys(a.keys, i, key);
    uint32_t est = 0xFFFFFFFFu;
    for (int d = 0; d < a.depth; ++d) {
      const uint32_t col = rt::hash_keys(key, a.keys.n, (uint32_t)(d + 1) + a.cms_seed) & a.wmask;
      const uint32_t v = a.cms[(size_t)d * (a.wmask + 1u) + col];
      est = v < est ? v : est;
    }
    if (est == 0u) continue;
    const uint32_t slot = rt::hash_keys(key, a.keys.n, 0x70CCu + a.table_seed) & (a.n_slots - 1u);
    atomicMax(a.packed + slot, ((unsigned long long)est << 32) | (unsigned long long)(i + 1));
  }
}

__global__ void hh_write(HH a) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < a.n_slots;
       s += (long long)gridDim.x * blockDim.x) {
    const unsigned long long p = a.packed[s];
    a.counts[s] = (uint32_t)(p >> 32);
    const uint32_t row1 = (uint32_t)p;
    if (row1 == 0u) continue;
    const long long row = (long long)row1 - 1;
    for (int c = 0; c < a.keys.n; ++c)
      a.key_rows[s * a.keys.n + c] = a.keys.p[c][row * a.keys.stride[c]];
  }
}

}  // namespace

extern "C" int hh_update(void* cms, int depth, int width, unsigned int cms_seed,
                         void* key_rows, void* counts, int n_slots, unsigned int table_seed,
                         void* packed,
                         const void* k0, long long s0, const void* k1, long long s1,
                         const void* k2, long long s2, const void* k3, long long s3, int n_cols,
                         const void* w, long long ws, long long n, void* stream) {
  HH a;
  a.cms = static_cast<uint32_t*>(cms);
  a.key_rows = static_cast<uint32_t*>(key_rows);
  a.counts = static_cast<uint32_t*>(counts);
  a.packed = static_cast<unsigned long long*>(packed);
  a.keys = rt::make_cols(k0, s0, k1, s1, k2, s2, k3, s3, n_cols);
  a.w = static_cast<const uint32_t*>(w);
  a.ws = ws;
  a.n = n;
  a.depth = depth;
  a.wmask = (uint32_t)width - 1u;
  a.cms_seed = cms_seed;
  a.n_slots = (uint32_t)n_slots;
  a.table_seed = table_seed;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long span = n > n_slots ? n : n_slots;
  hh_add<<<rt::grid_for(span, threads), threads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hh_offer<<<rt::grid_for(n, threads), threads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hh_write<<<rt::grid_for(n_slots, threads), threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
