// B2: fused syrk + trace-identity gradient contractions
//
// For W = K^-1 - alpha alpha^T, K^-1 = Linv^T Linv, and each fidelity m:
//
//   sv[m, q, n]  = sum_n' (W o T_m)[n, n'] x_q[n']      x_0 = 1, x_q = X[:, q-1]
//   sv2[m, q, n] = same with W o (w w^T 3 e^{-sqrt3 r})  (matern32 only)
//   diagW[n]     = W[n, n]
//
// with T_m = (w_m w_m^T) o base_m. The caller assembles g_logvar, g_logls
// and g_lognoise from these sums. K^-1 never reaches device memory.
//
// Replaces syrk_grad_fused / _syrk_grad_kernel in
// mfgp_tpu/ops/pallas_kernels.py (pallas_call at :585).
//
// What bounds it on the H100: the K^-1 tiles, ~N^3/6 fp32 FMAs over the
// lower tile pairs (1.3e12 at N = 20,000); everything else is O(N^2). In
// IEEE fp32 (TF32 would cost the gradient its digits) that is the CUDA
// cores' FMA rate, fed from shared memory.
//
// Design: one block of 16 x 16 threads per lower 64 x 64 tile pair (i >= j),
// enumerated row-major so that the pairs with the longest contraction
// (small i) start first. The block walks k from 64 i to N in chunks of 16
// rows: both operand strips Linv[k, tile i] and Linv[k, tile j] are staged in
// shared memory and each thread accumulates a 4 x 4 register sub-tile
// (rows ty + 16 r, columns tx + 16 c). No cuBLAS. The epilogue forms W,
// rebuilds T_m from the scaled points (staged in shared memory per
// fidelity), and contracts with [1, x] on the row side and, on strictly
// lower tiles, on the mirrored column side. Row sums reduce across a
// half-warp with shuffles, column sums across warps with shared-memory
// atomics; each block then adds its (1 + D) x 64 sums into the (F, 1+D, N)
// outputs with global atomicAdd in float64. The caller's assembly
// (x^2 . s - x . (A x)) cancels by ~1e3, so float32 outputs made the rbf
// lengthscale gradient swing between 5e-4 and 1.3e-3 relative from run to
// run with the order of the atomics; float64 outputs hold it at ~6e-4 at
// no measurable cost (one H100 80GB HBM3 at 700 W). The O(N^3) and O(N^2)
// arithmetic stays float32. diag(W) is stored by the diagonal tiles, once
// per entry.
#include "common.cuh"

namespace {

constexpr int kT = 64;         // tile edge
constexpr int kBK = 16;        // contraction rows per shared-memory stage
constexpr int kNT = 16;        // threads per tile edge
constexpr int kR = kT / kNT;   // register sub-tile edge
constexpr int kThreads = kNT * kNT;
constexpr int kQ = mfgp::kMaxD + 1;

__global__ void __launch_bounds__(kThreads)
syrk_grad_kernel(const float* __restrict__ Linv,
                 const float* __restrict__ alpha,
                 const float* __restrict__ A, const float* __restrict__ w,
                 const float* __restrict__ X, int N, int F, int D, int kern,
                 double* __restrict__ sv, double* __restrict__ sv2,
                 float* __restrict__ diagW) {
  __shared__ float sa[kBK][kT];
  __shared__ float sb[kBK][kT];
  __shared__ float sAi[kT][kQ], sAj[kT][kQ];  // scaled points, fidelity m
  __shared__ float sXi[kT][kQ], sXj[kT][kQ];  // raw points
  __shared__ float swi[kT], swj[kT];
  __shared__ float red_r[2][kQ][kT], red_c[2][kQ][kT];

  // lower pair p -> (i, j) with p = i (i + 1) / 2 + j, 0 <= j <= i
  const long long p = blockIdx.x;
  int i = static_cast<int>((sqrt(8.0 * static_cast<double>(p) + 1.0) - 1.0) *
                           0.5);
  while (static_cast<long long>(i + 1) * (i + 2) / 2 <= p) ++i;
  while (static_cast<long long>(i) * (i + 1) / 2 > p) --i;
  const int j = static_cast<int>(p - static_cast<long long>(i) * (i + 1) / 2);
  const int i0 = i * kT, j0 = j * kT;
  const bool diag_tile = i == j;

  const int tid = threadIdx.x;
  const int tx = tid % kNT, ty = tid / kNT;

  // ---- K^-1 tile: acc[r][c] = sum_{k >= i0} Linv[k, i0+a_r] Linv[k, j0+b_c]
  // Two-level fp32 sum: each 16-row stage is summed into a fresh partial,
  // which is then added to acc. K^-1's entries cancel heavily, and one
  // sequential fp32 sum over up to 20,000 rows cost the rbf g_logvar 6e-2
  // normwise against a float64 reference at the unit's shape; the stage
  // partials bring that to 4e-5 for ~6% more time (one H100 80GB HBM3 at
  // 700 W).
  float acc[kR][kR] = {};
  for (int k0 = i0; k0 < N; k0 += kBK) {
    for (int e = tid; e < kBK * kT; e += kThreads) {
      const int kk = e / kT, c = e % kT, k = k0 + kk;
      const size_t rowoff = static_cast<size_t>(k) * N;
      sa[kk][c] = (k < N && i0 + c < N) ? Linv[rowoff + i0 + c] : 0.0f;
      sb[kk][c] = (k < N && j0 + c < N) ? Linv[rowoff + j0 + c] : 0.0f;
    }
    __syncthreads();
    float part[kR][kR] = {};
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kR], b[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) a[r] = sa[kk][ty + kNT * r];
#pragma unroll
      for (int c = 0; c < kR; ++c) b[c] = sb[kk][tx + kNT * c];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kR; ++c)
          part[r][c] = fmaf(a[r], b[c], part[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kR; ++c) acc[r][c] += part[r][c];
    __syncthreads();
  }

  // ---- W tile = K^-1 tile - alpha_a alpha_b; diag(W) on diagonal tiles
  float al_i[kR], al_j[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int ga = i0 + ty + kNT * r, gb = j0 + tx + kNT * r;
    al_i[r] = ga < N ? alpha[ga] : 0.0f;
    al_j[r] = gb < N ? alpha[gb] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kR; ++c) acc[r][c] -= al_i[r] * al_j[c];
  if (diag_tile && tx == ty) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int ga = i0 + ty + kNT * r;
      if (ga < N) diagW[ga] = acc[r][r];
    }
  }

  // raw points [1, x] of both tiles, for the contractions
  for (int e = tid; e < kT * kQ; e += kThreads) {
    const int a = e / kQ, q = e % kQ;
    const int ga = i0 + a, gb = j0 + a;
    float xi = 0.0f, xj = 0.0f;
    if (q == 0) {
      xi = ga < N ? 1.0f : 0.0f;
      xj = gb < N ? 1.0f : 0.0f;
    } else if (q <= D) {
      xi = ga < N ? X[static_cast<size_t>(ga) * D + q - 1] : 0.0f;
      xj = gb < N ? X[static_cast<size_t>(gb) * D + q - 1] : 0.0f;
    }
    sXi[a][q] = xi;
    sXj[a][q] = xj;
  }

  const bool matern = kern == mfgp::kMatern32;
  const int nq = 1 + D;
  const int nout = matern ? 2 : 1;
  for (int m = 0; m < F; ++m) {
    __syncthreads();  // previous fidelity's shared data consumed
    for (int e = tid; e < kT * D; e += kThreads) {
      const int a = e / D, d = e % D;
      const int ga = i0 + a, gb = j0 + a;
      sAi[a][d] = ga < N ? A[(static_cast<size_t>(m) * N + ga) * D + d] : 0.f;
      sAj[a][d] = gb < N ? A[(static_cast<size_t>(m) * N + gb) * D + d] : 0.f;
    }
    if (tid < kT) {
      swi[tid] = i0 + tid < N ? w[static_cast<size_t>(m) * N + i0 + tid] : 0.f;
      swj[tid] = j0 + tid < N ? w[static_cast<size_t>(m) * N + j0 + tid] : 0.f;
    }
    for (int e = tid; e < 2 * kQ * kT; e += kThreads)
      (&red_c[0][0][0])[e] = 0.0f;
    __syncthreads();

    // M1 = W o T_m (and M2 = W o (w w^T 3 e^{-sqrt3 r}) for matern32)
    float m1[kR][kR], m2[kR][kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int a = ty + kNT * r;
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        const int b = tx + kNT * c;
        const float r2 = mfgp::sqdist(sAi[a], sAj[b], D);
        const float wprod = swi[a] * swj[b];
        if (matern) {
          const float rr = sqrtf(r2 + 1e-36f);
          const float e = expf(-mfgp::kSqrt3 * rr);
          m1[r][c] = acc[r][c] * (wprod * ((1.0f + mfgp::kSqrt3 * rr) * e));
          m2[r][c] = acc[r][c] * (wprod * (3.0f * e));
        } else {
          m1[r][c] = acc[r][c] * (wprod * expf(-0.5f * r2));
          m2[r][c] = 0.0f;
        }
      }
    }

    for (int o = 0; o < nout; ++o) {
      for (int q = 0; q < nq; ++q) {
        // row side: rows a_r gather sum_c M[a_r, b_c] x_q[b_c]
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float v = 0.0f;
#pragma unroll
          for (int c = 0; c < kR; ++c)
            v = fmaf(o ? m2[r][c] : m1[r][c], sXj[tx + kNT * c][q], v);
#pragma unroll
          for (int off = kNT / 2; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (tx == 0) red_r[o][q][ty + kNT * r] = v;
        }
        // mirrored column side (strictly lower tiles): the upper tile
        // (j, i) gives rows b_c the sums sum_r M[a_r, b_c] x_q[a_r]
        if (!diag_tile) {
#pragma unroll
          for (int c = 0; c < kR; ++c) {
            float u = 0.0f;
#pragma unroll
            for (int r = 0; r < kR; ++r)
              u = fmaf(o ? m2[r][c] : m1[r][c], sXi[ty + kNT * r][q], u);
            u += __shfl_xor_sync(0xffffffffu, u, kNT);
            if ((ty & 1) == 0) atomicAdd(&red_c[o][q][tx + kNT * c], u);
          }
        }
      }
    }
    __syncthreads();

    for (int e = tid; e < nout * nq * kT; e += kThreads) {
      const int o = e / (nq * kT), q = (e / kT) % nq, t = e % kT;
      double* dst = o ? sv2 : sv;
      const size_t base = (static_cast<size_t>(m) * nq + q) * N;
      if (i0 + t < N)
        atomicAdd(&dst[base + i0 + t], static_cast<double>(red_r[o][q][t]));
      if (!diag_tile && j0 + t < N)
        atomicAdd(&dst[base + j0 + t],
                  static_cast<double>(red_c[o][q][t]));
    }
  }
}

}  // namespace

extern "C" int mfgp_syrk_grad_f32(const float* Linv, const float* alpha,
                                  const float* A, const float* w,
                                  const float* X, int N, int F, int D,
                                  int kern, double* sv, double* sv2,
                                  float* diagW, void* stream) {
  if (N <= 0) return 0;
  const long long nb = (N + kT - 1) / kT;
  const long long npairs = nb * (nb + 1) / 2;
  syrk_grad_kernel<<<static_cast<unsigned>(npairs), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      Linv, alpha, A, w, X, N, F, D, kern, sv, sv2, diagW);
  return static_cast<int>(cudaGetLastError());
}
