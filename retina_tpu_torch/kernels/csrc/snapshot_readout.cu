// K17: the snapshot readout: HLL estimates and live connections.
//
// Replaces the computing part of retina_tpu/parallel/telemetry.py:493
// sharded.snapshot (the rest of it is copies) and the HLL half of
// timetravel/fold.py:163 range_extract:
//
// hll_estimate: ops/hyperloglog.py:108 estimate of every group of a
//   (G, m) register bank: raw = alpha_m m^2 / sum(2^-reg), zeros = the
//   registers at 0, and the linear count m ln(m / zeros) where
//   raw <= 2.5 m and zeros > 0. f32, as the reference. The plain version is
//   retina_tpu_torch/ops/hyperloglog.py estimate_plain.
// ct_active: ops/conntrack.py:286 active_connections: the resident slots
//   (key words not both 0) whose 16-bit idle time (now - seen16) & 0xFFFF
//   is within the protocol's lifetime or past 0xFFFF - the clock-skew
//   slack, in u32 arithmetic, counted exactly as an int32. The plain
//   version is retina_tpu_torch/ops/conntrack.py active_connections_plain.
//
// Bound on the H100: bytes. The deployed banks are 16 KiB (hll_flows),
// 256 KiB (hll_src_per_reason) and 1 MiB (hll_src_per_pod) of registers;
// the conntrack table's keys and the meta word of its values are 2 MiB +
// 1 MiB of the 6 MiB it holds (meta is one word of each 16-byte row).
// Together ~4.3 MB, ~1.3 us at 3.35 TB/s.
//
// Design. hll_estimate has two shapes of one reduction: a block of 256
// threads per group where a group has >= 1024 registers (hll_flows,
// hll_src_per_reason: 4096), and a warp per group where it has fewer
// (hll_src_per_pod: 4096 groups of 64), so no lane idles on a short row.
// Each sums exp2f(-reg) (exact powers of two) and counts zeros with
// shuffles, and one lane writes the estimate with full-precision logf and
// division. ct_active is a grid-stride count over the slots, a warp sum
// and one partial a block, then a ticket: the last block to take it adds
// the partials in block order, writes the count and puts the ticket back
// to 0 for the next call (no memset, no read back).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockThreads = 256;
constexpr int kWarpsPerBlock = kBlockThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

__device__ __forceinline__ float hll_value(float s, int zeros, int m, float alpha_mm) {
  const float fm = (float)m, z = (float)zeros;
  const float raw = alpha_mm / s;
  const float lc = fm * logf(fm / fmaxf(z, 1e-9f));
  return (raw <= 2.5f * fm && z > 0.f) ? lc : raw;
}

// One block a group.
__global__ void __launch_bounds__(kBlockThreads)
    hll_block_kernel(const uint32_t* __restrict__ regs, int m, float alpha_mm,
                     float* __restrict__ out) {
  __shared__ float s_part[kWarpsPerBlock];
  __shared__ int z_part[kWarpsPerBlock];
  const uint32_t* row = regs + (long long)blockIdx.x * m;
  float s = 0.f;
  int zeros = 0;
  for (int j = threadIdx.x; j < m; j += kBlockThreads) {
    const uint32_t r = row[j];
    s += exp2f(-(float)r);
    zeros += r == 0u;
  }
  s = warp_sum(s);
  zeros = warp_sum(zeros);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_part[warp] = s;
    z_part[warp] = zeros;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float st = 0.f;
    int zt = 0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      st += s_part[w];
      zt += z_part[w];
    }
    out[blockIdx.x] = hll_value(st, zt, m, alpha_mm);
  }
}

// One warp a group.
__global__ void __launch_bounds__(kBlockThreads)
    hll_warp_kernel(const uint32_t* __restrict__ regs, int G, int m, float alpha_mm,
                    float* __restrict__ out) {
  const int g = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= G) return;  // a whole warp leaves together
  const uint32_t* row = regs + (long long)g * m;
  float s = 0.f;
  int zeros = 0;
  for (int j = lane; j < m; j += 32) {
    const uint32_t r = row[j];
    s += exp2f(-(float)r);
    zeros += r == 0u;
  }
  s = warp_sum(s);
  zeros = warp_sum(zeros);
  if (lane == 0) out[g] = hll_value(s, zeros, m, alpha_mm);
}

__global__ void __launch_bounds__(kBlockThreads)
    ct_active_kernel(const uint2* __restrict__ keys, const uint4* __restrict__ vals,
                     long long S, uint32_t now, uint32_t tcp_life, uint32_t other_life,
                     uint32_t wrap_floor, int* __restrict__ partials,
                     uint32_t* __restrict__ ticket, int* __restrict__ out) {
  __shared__ int part[kWarpsPerBlock];
  __shared__ bool last;
  int c = 0;
  for (long long i = blockIdx.x * (long long)kBlockThreads + threadIdx.x; i < S;
       i += (long long)gridDim.x * kBlockThreads) {
    const uint2 k = keys[i];
    const uint32_t meta = vals[i].x;
    const uint32_t life = (meta >> 31) ? tcp_life : other_life;
    const uint32_t idle = (now - (meta & 0xFFFFu)) & 0xFFFFu;
    c += ((k.x | k.y) != 0u) && (idle <= life || idle > wrap_floor);
  }
  c = warp_sum(c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int b = 0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) b += part[w];
    partials[blockIdx.x] = b;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int t = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kBlockThreads)
    t += *((volatile int*)partials + j);
  t = warp_sum(t);
  if (lane == 0) part[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) total += part[w];
    *out = total;
    *ticket = 0u;  // for the next call on this stream
  }
}

}  // namespace

// (G,) f32 estimates of a (G, m) bank of u32 registers.
extern "C" int hll_estimate(const void* regs, int G, int m, float alpha_mm, void* out,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* r = static_cast<const uint32_t*>(regs);
  float* o = static_cast<float*>(out);
  if (m >= 4 * kBlockThreads) {
    hll_block_kernel<<<G, kBlockThreads, 0, s>>>(r, m, alpha_mm, o);
  } else {
    hll_warp_kernel<<<(G + kWarpsPerBlock - 1) / kWarpsPerBlock, kBlockThreads, 0, s>>>(
        r, G, m, alpha_mm, o);
  }
  return (int)cudaGetLastError();
}

// The live connections of a table of S slots: keys (S, 2) and vals (S, 4)
// u32, 16-byte aligned. blocks: the grid; partials: `blocks` ints; ticket:
// one u32, 0 on entry and left 0; out: one int32.
extern "C" int ct_active(const void* keys, const void* vals, long long S, unsigned int now,
                         unsigned int tcp_life, unsigned int other_life,
                         unsigned int wrap_floor, int blocks, void* partials, void* ticket,
                         void* out, void* stream) {
  ct_active_kernel<<<blocks, kBlockThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(keys), static_cast<const uint4*>(vals), S, now, tcp_life,
      other_life, wrap_floor, static_cast<int*>(partials), static_cast<uint32_t*>(ticket),
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
