// K6: the invertible sketch's bit-plane scatter-add, for one or two sketches
// of a batch (the step's inv_flow and inv_hi) in one pass.
//
// Replaces retina_tpu/ops/invertible.py:136-165 InvertibleSketch.update,
// which the step (retina_tpu/models/pipeline.py:527-534) calls twice, once
// with the rows of the priority class and once with the rest: for every
// row of weight w and every depth d, the bucket
// idx_d = hash_cols(key, d + 1 + seed) mod W gets planes[d, idx_d, b] += w
// for each set bit b of the key's C u32 columns and of its 32-bit checksum
// hash_cols(key, CHECK_SEED + seed), and weights[d, idx_d] += w. Here a
// row of weight w != 0 goes to region 1 where its selector lane is not 0
// and to region 0 otherwise. The plain version is ops/invertible.py
// update_pair_plain.
//
// Bound on the H100: bytes. Each row reads its weight and selector; a
// weighted row reads its key (the (B, 16) records' first 32-byte sector
// and the proto lane); the planes (D x W x 32(C+1) u32, 5 MiB for inv_flow
// at the deployed widths) are read and written once.
//
// Design: two launches, and no global atomic on the planes. bin_kernel
// takes a chunk of kChunk rows a block. Its threads read the weights and
// selectors with 16-byte loads and list the weighted rows in shared memory
// (a warp scan and one shared atomic a warp). The rows of one (key,
// region) are then summed into the first of them through a shared hash
// table (exact: every plane and weight is a u32 sum that wraps, so summing
// w before the bit is the same as after), so a hot key costs one entry a
// chunk. Each entry is written out with its checksum once, and its D
// buckets are binned by tile (kTile consecutive buckets of a region):
// counts in shared memory, a block scan, then the chunk's pair list in
// tile order and each tile's (start, count) in a tile-major table.
// apply_kernel gives each block one tile of both regions, which it owns,
// as a shared-memory tile of planes and weights: it gathers the tile's
// pairs of every chunk into shared memory, kRound at a time, binned by
// bucket; a warp takes a unit of up to kUnit pairs of one bucket (so a hot
// bucket is shared by every warp), sums their planes in registers, lane l
// on bit l of every word, and adds the sums into the tile with one shared
// atomic a word. The tile then goes into the global planes with 16-byte
// read-modify-writes where it changed.
#include "hash.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kCheckSeed = 0x1C3A9F71u;
constexpr int kThreads = 512;         // bin_kernel
constexpr int kChunk = 4 * kThreads;  // rows a bin block: 4 a thread
constexpr int kSlots = 2 * kChunk;    // the chunk's (key, region) table
constexpr int kStage = 6;             // words a listed row, below
constexpr uint32_t kIsEntry = 1u << 31;
constexpr int kTile = 32;             // buckets a tile
constexpr int kApplyThreads = 512;    // apply_kernel
constexpr int kRound = 1024;          // pairs an apply block stages at a time
constexpr int kUnit = 32;             // pairs of one bucket a warp sums at a time
constexpr int kMaxDepth = 4;
constexpr int kMaxTiles = 4096;
constexpr int kMaxChunks = 8192;

struct Region {
  uint32_t* planes;   // (D, W, 32 * (C + 1))
  uint32_t* weights;  // (D, W)
  int depth;
  uint32_t width;
  uint32_t seed;
  int tile0;          // the region's first tile
};

struct Inv {
  Region r[2];
  int n_regions;
  rt::Cols k;
  const uint32_t* w;
  long long ws;
  const uint32_t* sel;  // nullptr: every row goes to region 0
  long long ss;
  long long B;
  int vec;              // w (and sel) contiguous and 16-byte aligned
  int dmax;
  int n_tiles;
  int n_chunks;
  uint4* entries;       // (n_chunks * kChunk, 2): key words and checksum, weight in the last
  uint32_t* pairs;      // (n_chunks, kChunk * dmax): entry | bucket in tile << 16
  uint32_t* seg;        // (n_tiles, n_chunks): start << 16 | count
};

// In-place exclusive scan of a[0, n) by the whole block; returns the total.
__device__ uint32_t block_scan(uint32_t* a, int n, uint32_t* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  uint32_t own = 0;
  for (int i = lo; i < hi; ++i) own += a[i];
  uint32_t x = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < nw ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  uint32_t run = x - own + (warp ? warp_sums[warp - 1] : 0u);
  const uint32_t total = warp_sums[nw - 1];
  for (int i = lo; i < hi; ++i) {
    const uint32_t v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// The first of ``cnt`` consecutive slots of *counter for this lane; every
// lane of the warp calls it, and the warp makes one shared atomic.
__device__ __forceinline__ uint32_t warp_reserve(uint32_t cnt, uint32_t* counter) {
  const int lane = threadIdx.x & 31;
  uint32_t x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  uint32_t base = 0u;
  if (lane == 31 && x) base = atomicAdd(counter, x);
  return __shfl_sync(kFull, base, 31) + x - cnt;
}

// A listed row (kStage words): key words 0-3, then (once its entry is
// written) the entry's D packed (tile << 5 | bucket in tile); its weight,
// summed over the chunk's rows of its key in the first of them, then its
// entry's number; region | slot << 1, kIsEntry once it has an entry.
__device__ __forceinline__ bool same_key(const uint32_t* a, const uint32_t* b, int n) {
  for (int j = 0; j < n; ++j)
    if (a[j] != b[j]) return false;
  return (a[5] & 1u) == (b[5] & 1u);
}

__global__ void __launch_bounds__(kThreads) bin_kernel(const __grid_constant__ Inv a) {
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* stage = sm;                       // kChunk * kStage
  uint32_t* owner = stage + kChunk * kStage;  // kSlots
  uint32_t* tcount = owner + kSlots;          // n_tiles
  __shared__ uint32_t n_rows, n_ent;
  __shared__ uint32_t warp_sums[32];
  const int tid = threadIdx.x;
  const int n = a.k.n;
  const int c = blockIdx.x;

  // 1. The weighted rows of the chunk, listed with their keys.
  const long long r = (long long)c * kChunk + 4 * tid;
  uint32_t wv[4] = {0u, 0u, 0u, 0u}, sv[4] = {0u, 0u, 0u, 0u};
  if (a.vec && r + 3 < a.B) {
    const uint4 x = *reinterpret_cast<const uint4*>(a.w + r);
    wv[0] = x.x, wv[1] = x.y, wv[2] = x.z, wv[3] = x.w;
    if (a.sel) {
      const uint4 y = *reinterpret_cast<const uint4*>(a.sel + r);
      sv[0] = y.x, sv[1] = y.y, sv[2] = y.z, sv[3] = y.w;
    }
  } else {
    for (int q = 0; q < 4; ++q)
      if (r + q < a.B) {
        wv[q] = a.w[(r + q) * a.ws];
        if (a.sel) sv[q] = a.sel[(r + q) * a.ss];
      }
  }
  for (int i = tid; i < kSlots; i += kThreads) owner[i] = kEmpty;
  for (int i = tid; i < a.n_tiles; i += kThreads) tcount[i] = 0u;
  if (tid == 0) n_rows = n_ent = 0u;
  __syncthreads();
  uint32_t cnt = 0u;
  for (int q = 0; q < 4; ++q) cnt += wv[q] != 0u;
  uint32_t slot = warp_reserve(cnt, &n_rows);
  for (int q = 0; q < 4; ++q) {
    if (!wv[q]) continue;
    uint32_t key[rt::kMaxCols];
    rt::load_keys(a.k, r + q, key);
    uint32_t* st = stage + kStage * slot++;
    for (int j = 0; j < rt::kMaxCols; ++j) st[j] = key[j];
    st[4] = wv[q];
    st[5] = sv[q] ? 1u : 0u;
  }
  __syncthreads();
  const uint32_t nr = n_rows;
  if (nr == 0u) {  // no weighted row: every tile's segment is empty
    for (int t = tid; t < a.n_tiles; t += kThreads) a.seg[(size_t)t * a.n_chunks + c] = 0u;
    return;
  }

  // 2. The first row of each (key, region) owns its slot; the others add
  // their weights to it.
  for (uint32_t i = tid; i < nr; i += kThreads) {
    uint32_t* st = stage + kStage * i;
    const uint32_t reg = st[5];
    uint32_t h = rt::fmix32(rt::hash_keys(st, n, kCheckSeed + a.r[reg].seed) ^ reg) &
                 (kSlots - 1);
    for (;;) {
      const uint32_t old = atomicCAS(owner + h, kEmpty, i);
      if (old == kEmpty) break;
      if (same_key(stage + kStage * old, st, n)) {
        atomicAdd(stage + kStage * old + 4, st[4]);
        break;
      }
      h = (h + 1) & (kSlots - 1);
    }
    st[5] = reg | (h << 1);
  }
  __syncthreads();

  // 3. An entry an owner row of non-zero weight: written out, numbered, its
  // D buckets counted by tile and kept in the row.
  for (uint32_t base = 0; base < nr; base += kThreads) {
    const uint32_t i = base + tid;
    uint32_t* st = stage + kStage * i;
    const bool has = i < nr && owner[(st[5] >> 1) & (kSlots - 1)] == i && st[4] != 0u;
    const uint32_t e = warp_reserve(has ? 1u : 0u, &n_ent);
    if (!has) continue;
    const Region& R = a.r[st[5] & 1u];
    uint32_t ent[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, st[4]};
    for (int j = 0; j < n; ++j) ent[j] = st[j];
    ent[n] = rt::hash_keys(st, n, kCheckSeed + R.seed);
    uint4* dst = a.entries + ((size_t)c * kChunk + e) * 2;
    dst[0] = make_uint4(ent[0], ent[1], ent[2], ent[3]);
    dst[1] = make_uint4(ent[4], ent[5], ent[6], ent[7]);
    uint32_t packed[kMaxDepth];
    for (int d = 0; d < R.depth; ++d) {
      const uint32_t idx = rt::hash_keys(st, n, (uint32_t)d + 1u + R.seed) & (R.width - 1u);
      const uint32_t flat = (uint32_t)d * R.width + idx;
      const uint32_t tile = (uint32_t)R.tile0 + flat / kTile;
      packed[d] = (tile << 5) | (flat % kTile);
      atomicAdd(tcount + tile, 1u);
    }
    for (int d = 0; d < R.depth; ++d) st[d] = packed[d];
    st[4] = e;
    st[5] |= kIsEntry;
  }
  __syncthreads();

  // 4. Each tile's (start, count) in the chunk's pair list, then the pairs
  // in tile order.
  const uint32_t n_pairs = block_scan(tcount, a.n_tiles, warp_sums);
  for (int t = tid; t < a.n_tiles; t += kThreads) {
    const uint32_t start = tcount[t], end = t + 1 < a.n_tiles ? tcount[t + 1] : n_pairs;
    a.seg[(size_t)t * a.n_chunks + c] = (start << 16) | (end - start);
  }
  __syncthreads();
  uint32_t* out = a.pairs + (size_t)c * kChunk * a.dmax;
  for (uint32_t i = tid; i < nr; i += kThreads) {
    const uint32_t* st = stage + kStage * i;
    if (!(st[5] & kIsEntry)) continue;
    const int depth = a.r[st[5] & 1u].depth;
    for (int d = 0; d < depth; ++d)
      out[atomicAdd(tcount + (st[d] >> 5), 1u)] = st[4] | ((st[d] & (kTile - 1)) << 16);
  }
}

__global__ void __launch_bounds__(kApplyThreads) apply_kernel(const __grid_constant__ Inv a) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int n = a.k.n;
  const int np = 32 * (n + 1);
  uint32_t* tile = sm;                      // kTile * np planes, then kTile weights
  uint32_t* tw = tile + kTile * np;
  uint32_t* stage = tw + kTile;             // kRound * 8: words 0-4, weight, bucket, rank
  uint32_t* list = stage + kRound * 8;      // kRound: staged pairs by bucket
  uint32_t* pfx = list + kRound;            // n_chunks: segment counts, then their prefix
  uint32_t* start = pfx + a.n_chunks;       // n_chunks
  __shared__ uint32_t bcount[kTile], bstart[kTile], ustart[kTile + 1];
  __shared__ uint32_t warp_sums[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;
  const Region& R = a.r[(a.n_regions > 1 && t >= a.r[1].tile0) ? 1 : 0];
  const uint32_t first = (uint32_t)(t - R.tile0) * kTile;
  const uint32_t nb = min((uint32_t)kTile, (uint32_t)R.depth * R.width - first);
  for (int c = tid; c < a.n_chunks; c += kApplyThreads) {
    const uint32_t v = a.seg[(size_t)t * a.n_chunks + c];
    pfx[c] = v & 0xFFFFu;
    start[c] = v >> 16;
  }
  for (int i = tid; i < kTile * np + kTile; i += kApplyThreads) tile[i] = 0u;
  __syncthreads();
  const uint32_t total = block_scan(pfx, a.n_chunks, warp_sums);
  if (total == 0u) return;

  for (uint32_t r0 = 0; r0 < total; r0 += kRound) {
    const uint32_t m = min((uint32_t)kRound, total - r0);
    if (tid < kTile) bcount[tid] = 0u;
    __syncthreads();
    for (uint32_t p = tid; p < m; p += kApplyThreads) {
      const uint32_t q = r0 + p;
      int lo = 0, hi = a.n_chunks - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pfx[mid] <= q) lo = mid;
        else hi = mid - 1;
      }
      const uint32_t code = a.pairs[(size_t)lo * kChunk * a.dmax + start[lo] + (q - pfx[lo])];
      const uint4* e = a.entries + ((size_t)lo * kChunk + (code & 0xFFFFu)) * 2;
      const uint4 x = e[0], y = e[1];
      const uint32_t loc = code >> 16;
      uint4* st = reinterpret_cast<uint4*>(stage + 8 * p);
      st[0] = x;
      st[1] = make_uint4(y.x, y.w, loc, atomicAdd(bcount + loc, 1u));
    }
    __syncthreads();
    if (warp == 0) {  // bucket starts, and units of up to kUnit pairs a bucket
      const uint32_t v = bcount[lane], u = (v + kUnit - 1) / kUnit;
      uint32_t x = v, y = u;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t x1 = __shfl_up_sync(kFull, x, o), y1 = __shfl_up_sync(kFull, y, o);
        if (lane >= o) x += x1, y += y1;
      }
      bstart[lane] = x - v;
      ustart[lane] = y - u;
      if (lane == 31) ustart[kTile] = y;
    }
    __syncthreads();
    for (uint32_t p = tid; p < m; p += kApplyThreads)
      list[bstart[stage[8 * p + 6]] + stage[8 * p + 7]] = p;
    __syncthreads();
    for (uint32_t u = warp; u < ustart[kTile]; u += kApplyThreads / 32) {
      int L = 0;
      for (int step = kTile / 2; step; step >>= 1)
        if (ustart[L + step] <= u) L += step;
      const uint32_t b0 = bstart[L] + (u - ustart[L]) * kUnit;
      const uint32_t b1 = min(b0 + kUnit, bstart[L] + bcount[L]);
      uint32_t acc[rt::kMaxCols + 1] = {0u, 0u, 0u, 0u, 0u}, wsum = 0u;
#pragma unroll 2
      for (uint32_t i = b0; i < b1; ++i) {
        const uint32_t* st = stage + 8 * list[i];
        const uint32_t wv = st[5];
        wsum += wv;
#pragma unroll
        for (int j = 0; j <= rt::kMaxCols; ++j)
          if (j <= n) acc[j] += ((st[j] >> lane) & 1u) ? wv : 0u;
      }
      uint32_t* row = tile + L * np;
#pragma unroll
      for (int j = 0; j <= rt::kMaxCols; ++j)
        if (j <= n && acc[j]) atomicAdd(row + 32 * j + lane, acc[j]);
      if (lane == 0 && wsum) atomicAdd(tw + L, wsum);
    }
    __syncthreads();
  }

  // The tile into the planes: 16-byte read-modify-writes where it changed.
  uint4* g = reinterpret_cast<uint4*>(R.planes + (size_t)first * np);
  const uint4* s4 = reinterpret_cast<const uint4*>(tile);
  for (uint32_t i = tid; i < nb * np / 4; i += kApplyThreads) {
    const uint4 v = s4[i];
    if (!(v.x | v.y | v.z | v.w)) continue;
    uint4 x = g[i];
    x.x += v.x, x.y += v.y, x.z += v.z, x.w += v.w;
    g[i] = x;
  }
  for (uint32_t i = tid; i < nb; i += kApplyThreads)
    if (tw[i]) R.weights[first + i] += tw[i];
}

}  // namespace

// regions: per region planes, weights, depth, width, seed (int64 each).
// Scratch (see kops.inv_update_pair), with R = kChunk: entries ceil(B / R)
// * R * 32 bytes, pairs ceil(B / R) * R * max depth * 4 bytes, seg n_tiles *
// ceil(B / R) * 4 bytes; every word is written before it is read.
extern "C" int inv_update(const long long* regions, int n_regions, const void* k0, long long s0,
                          const void* k1, long long s1, const void* k2, long long s2,
                          const void* k3, long long s3, int n_cols, const void* w,
                          long long w_stride, const void* sel, long long sel_stride, long long B,
                          void* entries, void* pairs, void* seg, void* stream) {
  if (n_regions < 1 || n_regions > 2 || n_cols < 1 || n_cols > rt::kMaxCols || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Inv s;
  s.n_regions = n_regions;
  s.dmax = 0;
  int tiles = 0;
  for (int i = 0; i < 2; ++i) {
    const long long* f = regions + 5 * (i < n_regions ? i : 0);
    Region& R = s.r[i];
    R.planes = reinterpret_cast<uint32_t*>(f[0]);
    R.weights = reinterpret_cast<uint32_t*>(f[1]);
    R.depth = (int)f[2];
    R.width = (uint32_t)f[3];
    R.seed = (uint32_t)f[4];
    R.tile0 = tiles;
    if (i < n_regions) {
      if (R.depth < 1 || R.depth > kMaxDepth) return (int)cudaErrorInvalidValue;
      tiles += (int)((R.depth * (long long)R.width + kTile - 1) / kTile);
      if (R.depth > s.dmax) s.dmax = R.depth;
    }
  }
  s.n_tiles = tiles;
  s.n_chunks = (int)((B + kChunk - 1) / kChunk);
  if (s.n_tiles > kMaxTiles || s.n_chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  s.k = rt::make_cols(k0, s0, k1, s1, k2, s2, k3, s3, n_cols);
  s.w = static_cast<const uint32_t*>(w);
  s.ws = w_stride;
  s.sel = n_regions > 1 ? static_cast<const uint32_t*>(sel) : nullptr;
  s.ss = sel_stride;
  s.B = B;
  s.vec = w_stride == 1 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
          (!s.sel || (sel_stride == 1 && reinterpret_cast<uintptr_t>(sel) % 16 == 0));
  s.entries = static_cast<uint4*>(entries);
  s.pairs = static_cast<uint32_t*>(pairs);
  s.seg = static_cast<uint32_t*>(seg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bin_smem = 4 * (kChunk * kStage + kSlots + s.n_tiles);
  const int apply_smem = 4 * (kTile * 32 * (n_cols + 1) + kTile + kRound * 9 + 2 * s.n_chunks);
  cudaError_t err = cudaFuncSetAttribute(bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bin_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               apply_smem);
  if (err != cudaSuccess) return (int)err;
  bin_kernel<<<s.n_chunks, kThreads, bin_smem, st>>>(s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<<<s.n_tiles, kApplyThreads, apply_smem, st>>>(s);
  return (int)cudaGetLastError();
}
