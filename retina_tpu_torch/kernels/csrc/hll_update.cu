// K3: HyperLogLog register update for up to three banks of one batch, in
// one launch.
//
// Replaces retina_tpu/ops/hyperloglog.py:72 HyperLogLog.update, which the
// step (retina_tpu/models/pipeline.py:542-550) calls three times: hash the
// key columns; the low p bits pick the register, rho is the rank of the
// first set bit among the remaining 32 - p bits (32 - p + 1 when they are
// all zero); scatter-max rho into registers[group, index]. Masked rows are
// rho 0 in the reference, which never raises a register, so they are
// skipped here. Indices past G * 2^p are dropped (mode="drop"). A bank may
// name a second mask lane, ANDed bit by bit with the first (the step's
// pod bank at low aggregation: pod_mask & report).
//
// Bound on the H100: bytes. Each row reads the banks' mask lanes; a row
// with a mask set also reads its key, group and lane words. Key lanes of
// the (B, 16) records lie in the row's first 32-byte sector, which the
// card reads whole (the banks' later reads of the same lanes hit L1); the
// banks (16 KiB, 256 KiB and 1 MiB at the deployed widths) stay in L2.
// rho is exact integer math: floor(log2(rest)) = 31 - clz(rest).
//
// Design: every bank in one pass, so the records and the lanes the banks
// share are read once a row instead of once a bank, and a row with no mask
// set reads nothing more than its masks. A thread reads kRows rows' masks
// with 16-byte loads; each warp then lists its (row, bank) pairs with a
// mask set in shared memory (a warp scan), and its lanes take them 32 at a
// time, so the rows that count are spread over the whole warp whatever
// their place in the batch. A register is raised by an atomicMax only
// where a plain read found it below rho: registers only grow, so after the
// first batches of a stream almost every row makes no atomic, which keeps
// the hot registers of heavy keys out of the atomic units.
#include "hash.cuh"

namespace {

constexpr int kMaxBanks = 3;
constexpr int kRows = 4;  // rows a thread
constexpr int kThreads = 256;
constexpr int kFields = 19;  // int64 fields of one bank's record (see hll_update below)

struct Bank {
  uint32_t* regs;
  uint32_t n_groups;
  uint32_t m;
  int p;
  uint32_t seed;
  rt::Cols keys;
  const uint32_t* group;
  long long gs;
  const uint32_t* mask;
  long long ms;
  const uint32_t* mask2;  // nullptr: no second mask
  long long ms2;
};

struct Banks {
  Bank b[kMaxBanks];
  int n;
};

// kRows lane words from row r0 on: one 16-byte load where the lane is
// contiguous and aligned, else one load a row (0 past the batch).
__device__ __forceinline__ void load_rows(const uint32_t* p, long long stride, long long r0,
                                          long long n, uint32_t* out) {
  if (stride == 1 && r0 + kRows <= n && (reinterpret_cast<uintptr_t>(p + r0) & 15u) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + r0);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) out[q] = r0 + q < n ? p[(r0 + q) * stride] : 0u;
}

__global__ void __launch_bounds__(kThreads) hll_kernel(const __grid_constant__ Banks s,
                                                       long long n) {
  __shared__ uint32_t items[kThreads / 32][32 * kRows * kMaxBanks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * kThreads * kRows;
  const long long r0 = base + (long long)threadIdx.x * kRows;
  uint32_t act = 0u;  // bit b * kRows + q: row r0 + q counts in bank b
#pragma unroll
  for (int b = 0; b < kMaxBanks; ++b) {
    if (b >= s.n || r0 >= n) break;
    uint32_t m[kRows];
    load_rows(s.b[b].mask, s.b[b].ms, r0, n, m);
    if (s.b[b].mask2) {
      uint32_t m2[kRows];
      load_rows(s.b[b].mask2, s.b[b].ms2, r0, n, m2);
#pragma unroll
      for (int q = 0; q < kRows; ++q) m[q] &= m2[q];
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      if (m[q]) act |= 1u << (b * kRows + q);
  }

  // The warp's (row, bank) items: row in the block << 2 | bank.
  const uint32_t cnt = __popc(act);
  uint32_t x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  const uint32_t total = __shfl_sync(0xFFFFFFFFu, x, 31);
  uint32_t* list = items[warp];
  uint32_t pos = x - cnt;
  for (uint32_t bits = act; bits; bits &= bits - 1u) {
    const int bit = __ffs(bits) - 1;
    list[pos++] = ((threadIdx.x * kRows + bit % kRows) << 2) | (bit / kRows);
  }
  __syncwarp();

  for (uint32_t i = lane; i < total; i += 32) {
    const uint32_t it = list[i];
    const Bank& k = s.b[it & 3u];
    const long long row = base + (it >> 2);
    uint32_t key[rt::kMaxCols];
    rt::load_keys(k.keys, row, key);
    const uint32_t g = k.group ? k.group[row * k.gs] : 0u;
    const uint32_t h = rt::hash_keys(key, k.keys.n, 0xC0FFEEu + k.seed);
    const uint32_t rest = h >> k.p;
    const int hsb = rest ? 31 - __clz(rest) : -1;
    const uint32_t rho = (uint32_t)(32 - k.p - hsb);
    const uint32_t flat = g * k.m + (h & (k.m - 1u));  // u32 arithmetic, as the reference
    if ((unsigned long long)flat >= (unsigned long long)k.n_groups * k.m) continue;
    if (k.regs[flat] < rho) atomicMax(k.regs + flat, rho);
  }
}

}  // namespace

// fields: per bank, in this order: registers, n_groups, precision, seed,
// n_cols, key pointers 0-3, key strides 0-3, group, group stride, mask,
// mask stride, mask2, mask2 stride (a null pointer where there is none).
extern "C" int hll_update(const long long* fields, int n_banks, long long n, void* stream) {
  if (n_banks < 1 || n_banks > kMaxBanks || n < 0) return (int)cudaErrorInvalidValue;
  Banks s;
  s.n = n_banks;
  for (int b = 0; b < n_banks; ++b) {
    const long long* f = fields + b * kFields;
    Bank& k = s.b[b];
    k.regs = reinterpret_cast<uint32_t*>(f[0]);
    k.n_groups = (uint32_t)f[1];
    k.p = (int)f[2];
    k.m = 1u << k.p;
    k.seed = (uint32_t)f[3];
    k.keys = rt::make_cols(reinterpret_cast<const void*>(f[5]), f[9],
                           reinterpret_cast<const void*>(f[6]), f[10],
                           reinterpret_cast<const void*>(f[7]), f[11],
                           reinterpret_cast<const void*>(f[8]), f[12], (int)f[4]);
    k.group = reinterpret_cast<const uint32_t*>(f[13]);
    k.gs = f[14];
    k.mask = reinterpret_cast<const uint32_t*>(f[15]);
    k.ms = f[16];
    k.mask2 = reinterpret_cast<const uint32_t*>(f[17]);
    k.ms2 = f[18];
  }
  for (int b = n_banks; b < kMaxBanks; ++b) s.b[b] = s.b[0];
  if (n == 0) return 0;
  const long long per_block = (long long)kThreads * kRows;
  hll_kernel<<<(unsigned)((n + per_block - 1) / per_block), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(s, n);
  return (int)cudaGetLastError();
}
