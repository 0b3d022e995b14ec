// B3: fused posterior mean / variance reduction
//
//   mu[s]   = sum_n alpha[n] S[n, s]
//   quad[s] = sum_i (sum_{k <= i} Linv[i, k] S[k, s])^2      (V = Linv S)
//
// where S = K(train, grid) is the cross-covariance of one band of grid
// columns. The caller forms var = kss - quad (+ noise).
//
// Replaces posterior_fused / _posterior_fused_kernel in
// mfgp_tpu/ops/pallas_kernels.py (pallas_call at :379).
//
// Design (the simplest correct one; choosing among the alternatives by
// measurement is later work). The TPU kernel parks a (N, 512) strip of S in
// 42 MB of VMEM and rebuilds each S tile once; no Hopper SM holds that. Here
// S is staged in device memory for one band of grid columns by the B1
// kernel (ar1_cov.cu, launched by the wrapper), and this kernel runs the
// triangular walk: one block of 16 x 16 threads per (64-row tile i of V,
// 64-column tile j of the band), accumulating V's tile over k < 64 (i + 1)
// only (Linv is lower triangular: the contraction FLOPs stay N^2 M / 2)
// from shared-memory stages of Linv[tile i, k] and S[k, tile j]. The
// epilogue squares and column-sums the V tile into quad and adds the tile's
// alpha-weighted rows of S into mu, both through shared memory and then
// global atomicAdd (so the last bits depend on block order). V never exists
// in device memory. Row tiles are scheduled longest-first.
//
// What bounds it on the H100: the N^2 M / 2 fp32 FMAs of V (2.1e12 at
// N = 20,000, M = 10,571) on the CUDA cores, fed from shared memory; S's
// staging adds N M floats written and read (0.85 GB at the unit's shape).
#include "common.cuh"

namespace {

constexpr int kT = 64;
constexpr int kBK = 16;
constexpr int kNT = 16;
constexpr int kR = kT / kNT;
constexpr int kThreads = kNT * kNT;

__global__ void __launch_bounds__(kThreads)
posterior_kernel(const float* __restrict__ Linv,
                 const float* __restrict__ alpha,
                 const float* __restrict__ S, int N, int Mb,
                 float* __restrict__ mu, float* __restrict__ quad) {
  __shared__ float sl[kBK][kT + 1];  // Linv[i0 + a, k0 + kk], stored [kk][a]
  __shared__ float ss[kBK][kT];      // S[k0 + kk, j0 + c]
  __shared__ float red_q[kT], red_mu[kT];

  const int nb = (N + kT - 1) / kT;
  const int i = nb - 1 - static_cast<int>(blockIdx.y);  // longest rows first
  const int i0 = i * kT, j0 = blockIdx.x * kT;
  const int kend = min(N, i0 + kT);
  const int tid = threadIdx.x;
  const int tx = tid % kNT, ty = tid / kNT;

  if (tid < kT) {
    red_q[tid] = 0.0f;
    red_mu[tid] = 0.0f;
  }

  float acc[kR][kR] = {};
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    for (int e = tid; e < kBK * kT; e += kThreads) {
      // Linv: consecutive threads read consecutive k of one row
      const int a = e / kBK, kk = e % kBK;
      const int gi = i0 + a, k = k0 + kk;
      sl[kk][a] = (gi < N && k < kend)
                      ? Linv[static_cast<size_t>(gi) * N + k] : 0.0f;
      // S: consecutive threads read consecutive columns of one row
      const int kk2 = e / kT, c = e % kT, k2 = k0 + kk2;
      ss[kk2][c] = (k2 < kend && j0 + c < Mb)
                       ? S[static_cast<size_t>(k2) * Mb + j0 + c] : 0.0f;
    }
    __syncthreads();
    // two-level fp32 sum (stage partial, then acc), as in syrk_grad.cu:
    // V's entries are sums of up to N signed terms that cancel
    float part[kR][kR] = {};
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kR], b[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) a[r] = sl[kk][ty + kNT * r];
#pragma unroll
      for (int c = 0; c < kR; ++c) b[c] = ss[kk][tx + kNT * c];
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

  // quad: column sums of the squared V tile; mu: alpha-weighted rows of
  // S in this tile (rows beyond N carry zeros)
#pragma unroll
  for (int c = 0; c < kR; ++c) {
    const int gc = j0 + tx + kNT * c;
    float q = 0.0f, u = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      q = fmaf(acc[r][c], acc[r][c], q);
      const int gi = i0 + ty + kNT * r;
      if (gi < N && gc < Mb)
        u = fmaf(alpha[gi], S[static_cast<size_t>(gi) * Mb + gc], u);
    }
    q += __shfl_xor_sync(0xffffffffu, q, kNT);
    u += __shfl_xor_sync(0xffffffffu, u, kNT);
    if ((ty & 1) == 0) {
      atomicAdd(&red_q[tx + kNT * c], q);
      atomicAdd(&red_mu[tx + kNT * c], u);
    }
  }
  __syncthreads();
  if (tid < kT && j0 + tid < Mb) {
    atomicAdd(&quad[j0 + tid], red_q[tid]);
    atomicAdd(&mu[j0 + tid], red_mu[tid]);
  }
}

}  // namespace

extern "C" int mfgp_posterior_f32(const float* Linv, const float* alpha,
                                  const float* S, int N, int Mb, float* mu,
                                  float* quad, void* stream) {
  if (N <= 0 || Mb <= 0) return 0;
  const dim3 grid((Mb + kT - 1) / kT, (N + kT - 1) / kT);
  posterior_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Linv, alpha, S, N, Mb, mu, quad);
  return static_cast<int>(cudaGetLastError());
}
