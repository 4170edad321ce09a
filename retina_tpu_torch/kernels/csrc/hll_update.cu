// K3: HyperLogLog register update for a bank of G sketches.
//
// Replaces retina_tpu/ops/hyperloglog.py:72 HyperLogLog.update: hash the
// key columns; the low p bits pick the register, rho is the rank of the
// first set bit among the remaining 32 - p bits (32 - p + 1 when they are
// all zero); scatter-max rho into registers[group, index]. Masked rows are
// rho 0 in the reference, which never raises a register, so they are
// skipped here. Indices past G * 2^p are dropped (mode="drop").
//
// Bound on the H100: bytes, B * (4C + 8) of keys, group and mask, plus the
// (G, 2^p) registers read and written once. rho is exact integer math:
// floor(log2(rest)) = 31 - clz(rest), one instruction.
//
// Design: one thread per row and one atomicMax per unmasked row, preceded
// by a plain read of the register: registers only grow, so a row whose rho
// does not exceed the value already there makes no atomic. After the first
// batches of a stream almost every row is such a row, which keeps the hot
// registers of heavy keys out of the atomic units.
#include "hash.cuh"

namespace {

__global__ void hll_kernel(uint32_t* regs, uint32_t n_groups, uint32_t m, int p, uint32_t seed,
                           rt::Cols keys, const uint32_t* group, long long gs,
                           const uint32_t* mask, long long ms, long long n) {
  const unsigned long long limit = (unsigned long long)n_groups * m;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (mask[i * ms] == 0u) continue;
    uint32_t key[rt::kMaxCols];
    rt::load_keys(keys, i, key);
    const uint32_t h = rt::hash_keys(key, keys.n, 0xC0FFEEu + seed);
    const uint32_t rest = h >> p;
    const int hsb = rest ? 31 - __clz(rest) : -1;
    const uint32_t rho = (uint32_t)(32 - p - hsb);
    const uint32_t g = group ? group[i * gs] : 0u;
    const uint32_t flat = g * m + (h & (m - 1u));  // u32 arithmetic, as the reference
    if (flat >= limit) continue;
    if (regs[flat] < rho) atomicMax(regs + flat, rho);
  }
}

}  // namespace

extern "C" int hll_update(void* regs, int n_groups, int precision, unsigned int seed,
                          const void* k0, long long s0, const void* k1, long long s1,
                          const void* k2, long long s2, const void* k3, long long s3, int n_cols,
                          const void* group, long long gs, const void* mask, long long ms,
                          long long n, void* stream) {
  const int threads = 256;
  hll_kernel<<<rt::grid_for(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(regs), (uint32_t)n_groups, 1u << precision, precision, seed,
      rt::make_cols(k0, s0, k1, s1, k2, s2, k3, s3, n_cols), static_cast<const uint32_t*>(group),
      gs, static_cast<const uint32_t*>(mask), ms, n);
  return (int)cudaGetLastError();
}
