// The anomaly EWMA of one group, shared by K16 (window_close.cu: the
// entropy groups of a window close) and the detector bank's close
// (detect.cu: a detector's score a slot).
//
// Replaces retina_tpu/ops/entropy.py:113 AnomalyEWMA.observe for one
// group; its plain version is retina_tpu_torch/ops/entropy.py
// AnomalyEWMA.observe. Given the score h, whether the window saw traffic,
// and the state m0, v0, k0:
//   warm = k0 >= min_windows
//   z = warm & active ? (h - m0) / max(sqrt(max(v0, 1e-12)), 1e-3) : 0
//   flag = warm & active & |z| > z_thresh
//   a = flag | !active ? 0 : (k0 == 0 ? 1 : alpha)
//   mean = m0 + a * delta; var = first & active ? 0 : (1 - a) * (v0 + a * delta * delta)
//   n_obs = k0 + active
// in IEEE-rounded f32 in the plain version's order (__fmul_rn/__fadd_rn
// keep nvcc from fusing them into multiply-adds; the division and sqrtf
// are IEEE-rounded without fast-math), so the state, z and flag equal the
// plain version's bit for bit on the same h.
//
// Bound: a few f32 operations; it launches nothing of its own.
#pragma once

#include <cuda_runtime.h>

namespace rt {

struct EwmaStep {
  float mean, var, n_obs, z;
  bool flag;
};

__device__ __forceinline__ EwmaStep ewma_step(float h, bool active, float m0, float v0,
                                              float k0, float alpha, float z_thresh,
                                              float min_windows) {
  const bool warm = k0 >= min_windows;
  const float sd = sqrtf(fmaxf(v0, 1e-12f));
  const float delta = __fadd_rn(h, -m0);
  const float z = warm && active ? delta / fmaxf(sd, 1e-3f) : 0.f;
  const bool flag = warm && active && fabsf(z) > z_thresh;
  const bool first = k0 == 0.f;
  const float a = (flag || !active) ? 0.f : (first ? 1.f : alpha);
  EwmaStep r;
  r.mean = __fadd_rn(m0, __fmul_rn(a, delta));
  r.var = (first && active)
              ? 0.f
              : __fmul_rn(__fadd_rn(1.f, -a),
                          __fadd_rn(v0, __fmul_rn(__fmul_rn(a, delta), delta)));
  r.n_obs = __fadd_rn(k0, active ? 1.f : 0.f);
  r.z = z;
  r.flag = flag;
  return r;
}

}  // namespace rt
