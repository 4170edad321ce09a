// K16: the window close and the entropy bits of a histogram bank.
//
// Replaces retina_tpu/models/pipeline.py:664 end_window (the
// pipeline.end_window program registered at :686), with ops/entropy.py:71
// entropy_bits and :113 AnomalyEWMA.observe, and the entropy half of
// timetravel/fold.py:163 range_extract. The plain versions are
// retina_tpu_torch/models/pipeline.py end_window_plain and
// retina_tpu_torch/ops/entropy.py entropy_bits_plain.
//
// For each of the G groups, over its (K,) f32 histogram row c:
//   n = sum(c); p = c / max(n, 1); bits = -sum_{p > 0} p * log2(max(p, 1e-30))
// and, in the close entry, the anomaly EWMA of that group in place:
//   active = n > 0; warm = n_obs >= min_windows
//   z = warm & active ? (bits - mean) / max(sqrt(max(var, 1e-12)), 1e-3) : 0
//   flag = warm & active & |z| > z_thresh
//   a = flag | !active ? 0 : (n_obs == 0 ? 1 : alpha)
//   mean += a * (bits - mean)
//   var = first & active ? 0 : (1 - a) * (var + a * delta * delta)
//   n_obs += active
// then the row is zeroed (the next window starts empty).
//
// Bound on the H100: bytes, and those are a few: G*K*4 read and, in the
// close, G*K*4 written (96 KiB each at the deployed (3, 4096)), ~0.03 us at
// 3.35 TB/s, under the launch floor. What the work costs is f64 arithmetic:
// a division and a log2 for every nonzero bucket, each tens of f64
// instructions, which an SM issues at 64 a clock.
//
// Design: S blocks of 256 threads a group (G * S blocks; the wrapper takes
// S = 16, the fastest at the deployed (3, 4096) of 1 to 48), so the f64
// work spreads over the card where one block a group ran it on G SMs, and
// the launch is a chain of few memory round trips. Every block of a group
// reads the whole row (from L2 after the first) and sums n in f64 in the
// same order, so all hold the same exact n; it then sums p log2 p over its
// own slice of the row, skipping the empty buckets (p = 0 exactly where
// c = 0), and writes one f64 partial, published by the acquire-release add
// that takes the group's ticket. The last block of the group (the others
// have read the row by then) reads the partials in one round trip, adds
// them in block order, so the bits do not depend on which block finished
// last, rounds them to f32 once, applies the EWMA (its state loaded at the
// kernel's start, beside the row; ewma.cuh, IEEE-rounded operations in the
// plain version's order), zeroes
// the row and puts the ticket back to 0 for the next call on the stream.
// The bits are summed in f64 (n exactly; p, log2 and their products
// IEEE-rounded, no fused multiply-add) and rounded to f32 once, as the
// plain version does: the two group their sums differently, which moves
// an f64 sum by ~1e-16 and, but at a rounding tie, not its f32 bits. So
// the bits, and the z-scores an EWMA makes of them, equal the plain
// version's. f32 sums grouped differently moved the bits by an ulp, which
// the z-score of a window whose baseline barely varies magnifies past any
// tolerance a float comparison could hold it to.
#include <cstdint>
#include <cuda_runtime.h>

#include "ewma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

// The sum of v over the block, in every thread. `part` holds kWarps words.
__device__ __forceinline__ double block_sum(double v, double* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr int kMaxSlices = 64;

// Block (g, s) of G x S: n of group g's row, then its slice's sum.
__global__ void __launch_bounds__(kThreads)
    window_close_kernel(float* __restrict__ counts, int K, int S, int close,
                        float* __restrict__ mean, float* __restrict__ var,
                        float* __restrict__ n_obs, float alpha, float z_thresh,
                        float min_windows, float* __restrict__ bits_out,
                        uint8_t* __restrict__ flag_out, float* __restrict__ z_out,
                        double* __restrict__ partials, uint32_t* __restrict__ tickets) {
  __shared__ double part[kWarps];
  __shared__ double parts[kMaxSlices];
  __shared__ bool last;
  const int g = blockIdx.x / S, s = blockIdx.x - g * S;
  float m0 = 0.f, v0 = 0.f, k0 = 0.f;  // in flight while the row loads
  if (close && threadIdx.x == 0) {
    m0 = mean[g];
    v0 = var[g];
    k0 = n_obs[g];
  }
  float* row = counts + (long long)g * K;
  const bool vec = (K & 3) == 0 && aligned16(row);
  double n = 0.0;
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int i = threadIdx.x; i < (K >> 2); i += kThreads) {
      const float4 v = r4[i];
      n += v.x;
      n += v.y;
      n += v.z;
      n += v.w;
    }
  } else {
    for (int i = threadIdx.x; i < K; i += kThreads) n += row[i];
  }
  n = block_sum(n, part);  // exact, and the same in every block of the group
  const double denom = fmax(n, 1.0);
  const int slice = (K + S - 1) / S;
  const int lo = s * slice, hi = min(K, lo + slice);
  double t = 0.0;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float c = row[i];
    if (c > 0.f) {  // p > 0 exactly where c > 0: no f64 quotient underflows
      const double p = __ddiv_rn(c, denom);
      t = __dadd_rn(t, __dmul_rn(p, log2(fmax(p, 1e-30))));
    }
  }
  t = block_sum(t, part);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = t;
    uint32_t old;  // release: the partial; acquire: the group's other partials
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(tickets + g) : "memory");
    last = old == (uint32_t)(S - 1);
  }
  __syncthreads();
  if (!last) return;  // the last block: every block of the group has read the row
  if (threadIdx.x < S) parts[threadIdx.x] = __ldcg(partials + (long long)g * S + threadIdx.x);
  if (close) {
    if (vec) {
      float4* r4 = reinterpret_cast<float4*>(row);
      for (int i = threadIdx.x; i < (K >> 2); i += kThreads) r4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int i = threadIdx.x; i < K; i += kThreads) row[i] = 0.f;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  double sum = 0.0;
  for (int j = 0; j < S; ++j) sum = __dadd_rn(sum, parts[j]);
  tickets[g] = 0u;  // for the next call on this stream
  const float h = __double2float_rn(-sum);
  bits_out[g] = h;
  if (close) {
    const rt::EwmaStep r = rt::ewma_step(h, n > 0.0, m0, v0, k0, alpha, z_thresh, min_windows);
    mean[g] = r.mean;
    var[g] = r.var;
    n_obs[g] = r.n_obs;
    flag_out[g] = r.flag;
    z_out[g] = r.z;
  }
}

int launch(int G, int K, int S, int close, float* counts, float* mean, float* var,
           float* n_obs, float alpha, float z_thresh, float min_windows, float* bits,
           uint8_t* flags, float* z, double* partials, uint32_t* tickets, cudaStream_t stream) {
  if (S < 1 || S > kMaxSlices) return (int)cudaErrorInvalidValue;
  window_close_kernel<<<G * S, kThreads, 0, stream>>>(counts, K, S, close, mean, var, n_obs,
                                                      alpha, z_thresh, min_windows, bits, flags,
                                                      z, partials, tickets);
  return (int)cudaGetLastError();
}

}  // namespace

// The close: bits, flags and z of every group; mean, var and n_obs updated
// and counts zeroed in place. counts (G, K) f32; S blocks a group, 1 <= S
// <= 64; partials: G * S doubles; tickets: G words, 0 on entry and left 0;
// the rest (G,).
extern "C" int window_close(void* counts, int G, int K, int S, void* mean, void* var,
                            void* n_obs, float alpha, float z_thresh, float min_windows,
                            void* bits, void* flags, void* z, void* partials, void* tickets,
                            void* stream) {
  return launch(G, K, S, 1, static_cast<float*>(counts), static_cast<float*>(mean),
                static_cast<float*>(var), static_cast<float*>(n_obs), alpha, z_thresh,
                min_windows, static_cast<float*>(bits), static_cast<uint8_t*>(flags),
                static_cast<float*>(z), static_cast<double*>(partials),
                static_cast<uint32_t*>(tickets), static_cast<cudaStream_t>(stream));
}

// The bits alone: counts are read, nothing else of the state is written.
extern "C" int entropy_bits(const void* counts, int G, int K, int S, void* bits,
                            void* partials, void* tickets, void* stream) {
  return launch(G, K, S, 0, const_cast<float*>(static_cast<const float*>(counts)),
                nullptr, nullptr, nullptr, 0.f, 0.f, 0.f, static_cast<float*>(bits), nullptr,
                nullptr, static_cast<double*>(partials), static_cast<uint32_t*>(tickets),
                static_cast<cudaStream_t>(stream));
}
