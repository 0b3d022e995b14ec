// Shared pieces of the port's hand-written sm_90a kernels.
//
// Inputs arrive "prepped" as the Pallas kernels' _prep makes them
// (mfgp_tpu/ops/pallas_kernels.py:91-107): per fidelity m the
// lengthscale-scaled coordinates A[m, n, :] = X[n, :] / l_m (layout (F, N, D),
// row-major) and the folded AR1 weights w[m, n] = W[m, fid[n]] * sqrt(var_m)
// (layout (F, N)). All arithmetic is IEEE fp32 (no fast-math); TF32 appears
// only as the exact hi/lo split of tf32x3.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mfgp {

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr int kRbf = 0;
constexpr int kMatern32 = 1;
constexpr int kMaxD = 8;  // input dimensions a kernel accepts (wrappers check)

// Unit-variance base kernel of the squared scaled distance: rbf exp(-r2/2),
// matern32 (1 + sqrt3 r) exp(-sqrt3 r) with the 1e-36 guard inside the sqrt
// that ops/kernels.matern32 carries.
__device__ __forceinline__ float base_kernel(float r2, int kern) {
  if (kern == kRbf) return expf(-0.5f * r2);
  const float r = sqrtf(r2 + 1e-36f);
  return (1.0f + kSqrt3 * r) * expf(-kSqrt3 * r);
}

// Squared distance of two scaled points as the sum of squared differences.
// For D = 3 this is three FMAs; unlike the norm expansion |a|^2 + |b|^2 -
// 2 a.b it does not cancel, so it is exactly 0 on the diagonal and never
// negative.
__device__ __forceinline__ float sqdist(const float* a, const float* b,
                                        int D) {
  float r2 = 0.0f;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    if (d < D) {
      const float t = a[d] - b[d];
      r2 = fmaf(t, t, r2);
    }
  }
  return r2;
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, by integer operations on the fp32 pattern: the rounding of
// cvt.rna.tf32.f32, except that a finite value never rounds up to infinity
// (at the top of the range the low bits are cut instead), so that hi + lo
// reconstructs every finite x. Infinities and NaNs pass unchanged. The plain
// version is ops/cuda_kernels.tf32_round_plain, bit for bit.
__device__ __forceinline__ float tf32_round(float x) {
  const uint32_t b = __float_as_uint(x);
  if ((b & 0x7F800000u) == 0x7F800000u) return x;
  uint32_t r = (b + 0x1000u) & ~0x1FFFu;
  if ((r & 0x7F800000u) == 0x7F800000u) r = b & ~0x1FFFu;
  return __uint_as_float(r);
}

}  // namespace mfgp
