// B1: fused AR1 covariance
//
//   K[i, j] = sum_m wA[m, i] wB[m, j] base(|A[m, i] - B[m, j]|^2)
//             (+ noise[i] where i == j, when a noise vector is given)
//
// stored with row stride ldo; when a second output lo is given, out and lo
// get the TF32 split of K instead (out = tf32_round(K), lo =
// tf32_round(K - out), common.cuh), the operand planes of B3's tensor-core
// walk written in the same pass.
//
// Replaces ar1_cov_fused / _ar1_tile_kernel in
// mfgp_tpu/ops/pallas_kernels.py (pallas_call at :155), and with F = 1 its
// wrapper rbf_cov_fused.
//
// What bounds it on the H100: with D = 3 the distance is three FMAs per
// fidelity, so there is no product for tensor cores to take; each output
// costs F exponentials (plus F square roots for matern32) and one 4-byte
// store. At the unit's 20,000 x 20,000 Gram that is 1.6 GB written and
// 1.2e9 exponentials: the output write and the special-function units bound
// it, not the FMA pipes.
//
// Design: one 32 x 32 output tile per block of 32 x 8 threads; a thread owns
// one column and four rows, so each warp stores 32 consecutive floats of a
// row (coalesced 128-byte stores, each output written exactly once). Per
// fidelity the tile's 32 + 32 scaled points and weights are staged in shared
// memory. Ragged edges are masked in the kernel; nothing is padded or copied.
// The noise lands only on the global diagonal (i == j). The split costs one
// more 4-byte store per output and no extra read.
#include "common.cuh"

namespace {

constexpr int kTile = 32;   // rows and columns of an output tile
constexpr int kRows = 8;    // thread rows; each thread computes kTile/kRows
constexpr int kPer = kTile / kRows;

__global__ void __launch_bounds__(kTile * kRows)
ar1_cov_kernel(const float* __restrict__ A, const float* __restrict__ wA,
               const float* __restrict__ B, const float* __restrict__ wB,
               const float* __restrict__ noise, float* __restrict__ out,
               float* __restrict__ lo, int ldo, int N, int M, int F, int D,
               int kern) {
  __shared__ float sA[kTile][mfgp::kMaxD + 1];
  __shared__ float sB[kTile][mfgp::kMaxD + 1];
  __shared__ float swA[kTile];
  __shared__ float swB[kTile];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[kPer] = {};

  for (int m = 0; m < F; ++m) {
    __syncthreads();  // the previous fidelity's tiles are consumed
    for (int e = tid; e < kTile * D; e += kTile * kRows) {
      const int p = e / D, d = e % D;
      const int gi = row0 + p, gj = col0 + p;
      sA[p][d] = gi < N ? A[((size_t)m * N + gi) * D + d] : 0.0f;
      sB[p][d] = gj < M ? B[((size_t)m * M + gj) * D + d] : 0.0f;
    }
    if (tid < kTile) {
      swA[tid] = row0 + tid < N ? wA[(size_t)m * N + row0 + tid] : 0.0f;
      swB[tid] = col0 + tid < M ? wB[(size_t)m * M + col0 + tid] : 0.0f;
    }
    __syncthreads();
    float b[mfgp::kMaxD];
#pragma unroll
    for (int d = 0; d < mfgp::kMaxD; ++d) b[d] = d < D ? sB[tx][d] : 0.0f;
    const float wb = swB[tx];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int p = ty + kRows * r;
      const float r2 = mfgp::sqdist(sA[p], b, D);
      acc[r] = fmaf(swA[p] * wb, mfgp::base_kernel(r2, kern), acc[r]);
    }
  }

  const int gj = col0 + tx;
  if (gj >= M) return;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int gi = row0 + ty + kRows * r;
    if (gi >= N) continue;
    float v = acc[r];
    if (noise != nullptr && gi == gj) v += noise[gi];
    const size_t at = (size_t)gi * ldo + gj;
    if (lo == nullptr) {
      out[at] = v;
    } else {
      const float h = mfgp::tf32_round(v);
      out[at] = h;
      lo[at] = mfgp::tf32_round(v - h);
    }
  }
}

}  // namespace

extern "C" int mfgp_ar1_cov_f32(const float* A, const float* wA,
                                const float* B, const float* wB,
                                const float* noise, float* out, float* lo,
                                int ldo, int N, int M, int F, int D, int kern,
                                void* stream) {
  if (N <= 0 || M <= 0) return 0;
  if (ldo < M) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTile, kRows);
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  ar1_cov_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      A, wA, B, wB, noise, out, lo, ldo, N, M, F, D, kern);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mfgp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
