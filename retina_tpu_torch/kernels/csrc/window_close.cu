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
// close, G*K*4 written (96 KiB each at the deployed (3, 4096)), ~0.06 us at
// 3.35 TB/s. So the launch is the cost, and the design is one launch where
// the plain version takes ~30 small ones.
//
// Design: one block of 512 threads a group. Each thread loads its
// elements of the row into registers once (K <= 512 * kPer), the block sums
// n (warp shuffles, one shared word a warp), then p log2 p over the values
// it holds, and thread 0 applies the EWMA with IEEE-rounded operations in
// the plain version's order (__fmul_rn/__fadd_rn keep nvcc from fusing
// them), so the state follows the plain version's arithmetic exactly given
// the same bits. The close zeroes the row only after the sums' barrier,
// when every thread has read it.
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

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 32;  // elements a thread holds: K <= 16384
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

__global__ void __launch_bounds__(kThreads)
    window_close_kernel(float* __restrict__ counts, int K, int close, float* __restrict__ mean,
                        float* __restrict__ var, float* __restrict__ n_obs, float alpha,
                        float z_thresh, float min_windows, float* __restrict__ bits_out,
                        uint8_t* __restrict__ flag_out, float* __restrict__ z_out) {
  __shared__ double part[kWarps];
  const int g = blockIdx.x;
  float* row = counts + (long long)g * K;
  float v[kPer];
  double n = 0.0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    v[j] = i < K ? row[i] : 0.f;
    n += v[j];
  }
  n = block_sum(n, part);  // exact; its barriers: every thread has read the row
  const double denom = fmax(n, 1.0);
  double t = 0.0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const double p = __ddiv_rn(v[j], denom);
    if (p > 0.0) t = __dadd_rn(t, __dmul_rn(p, log2(fmax(p, 1e-30))));
  }
  if (close) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < K) row[i] = 0.f;
    }
  }
  t = block_sum(t, part);
  if (threadIdx.x != 0) return;
  const float h = __double2float_rn(-t);
  bits_out[g] = h;
  if (!close) return;
  const bool active = n > 0.0;
  const float m0 = mean[g], v0 = var[g], k0 = n_obs[g];
  const bool warm = k0 >= min_windows;
  const float sd = sqrtf(fmaxf(v0, 1e-12f));
  const float delta = __fadd_rn(h, -m0);
  const float z = warm && active ? delta / fmaxf(sd, 1e-3f) : 0.f;
  const bool flag = warm && active && fabsf(z) > z_thresh;
  const bool first = k0 == 0.f;
  const float a = (flag || !active) ? 0.f : (first ? 1.f : alpha);
  mean[g] = __fadd_rn(m0, __fmul_rn(a, delta));
  var[g] = (first && active)
               ? 0.f
               : __fmul_rn(__fadd_rn(1.f, -a),
                           __fadd_rn(v0, __fmul_rn(__fmul_rn(a, delta), delta)));
  n_obs[g] = __fadd_rn(k0, active ? 1.f : 0.f);
  flag_out[g] = flag;
  z_out[g] = z;
}

}  // namespace

// The close: bits, flags and z of every group; mean, var and n_obs updated
// and counts zeroed in place. counts (G, K) f32, K <= 16384; the rest (G,).
extern "C" int window_close(void* counts, int G, int K, void* mean, void* var, void* n_obs,
                            float alpha, float z_thresh, float min_windows, void* bits,
                            void* flags, void* z, void* stream) {
  window_close_kernel<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(counts), K, 1, static_cast<float*>(mean), static_cast<float*>(var),
      static_cast<float*>(n_obs), alpha, z_thresh, min_windows, static_cast<float*>(bits),
      static_cast<uint8_t*>(flags), static_cast<float*>(z));
  return (int)cudaGetLastError();
}

// The bits alone: counts are read, nothing else is written.
extern "C" int entropy_bits(const void* counts, int G, int K, void* bits, void* stream) {
  window_close_kernel<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      const_cast<float*>(static_cast<const float*>(counts)), K, 0, nullptr, nullptr, nullptr,
      0.f, 0.f, 0.f, static_cast<float*>(bits), nullptr, nullptr);
  return (int)cudaGetLastError();
}
