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
// What bounds it on the H100: V's N^2 M / 2 multiply-adds (2.1e12 at
// N = 20,000, M = 10,571). In 3xTF32 on the tensor cores that is three
// TF32 products each, 1.27e13 TF32 flop, 26 ms at the 495 TFLOP/s dense
// peak; IEEE fp32 on the CUDA cores (the earlier kernel, 202 ms) cannot go
// below ~63 ms at 67 TFLOP/s. Operand traffic is second: the grouped tile
// order below reads ~25 GB from HBM (~7.5 ms at 3.35 TB/s), the rest from
// L2 (estimated from the order; not measured, as ncu does not run on the
// card's host).
// Measured on one H100 80GB HBM3 at 700 W at N = 20,000, M = 10,571,
// staging and split included: 51.80 ms rbf, 52.51 ms matern32 (plain
// version 119.76 / 128.53 ms), 81.6 TFLOP/s float32-equivalent for rbf,
// 49 % of the 3xTF32 bound.
//
// Design: the wrapper stages S^T = K(grid band, train) as TF32 hi/lo planes
// (Mb, N) with the B1 kernel (ar1_cov.cu, with its arguments swapped, which
// is the K-major B operand the engine needs) and splits Linv (row-major,
// already K-major) into hi/lo planes. Each block computes one 128 x 128 tile
// of V = Linv S on the shared engine (tf32x3.cuh: TMA ring, two wgmma
// warpgroups, 3xTF32, a fresh partial per k-step of 8: of 1, 2 and 4 the
// fastest on the card, 52 against 58 ms), walking k < min(N, 128 (i + 1)):
// tri_inv_recursive gives exact zeros above the diagonal, so the diagonal
// k-tile needs no mask. V never reaches device memory. Epilogue: the tile's
// squared columns are summed within each warp by shuffles, across the eight
// consumer warps in shared memory, then one atomicAdd per column per block
// into quad; mu gets the tile's alpha-weighted rows of S (k in row tile i)
// from the hi + lo planes, one warp per column, one atomicAdd each.
//
// Tile order (posterior_tile, from blockIdx.x): row tiles from the longest
// walk down, in groups of 8; within a group, column by column. The 132
// blocks in flight then span ~8 row strips of Linv (2 x 10 MB each at
// N = 20,000, read by ~16 column tiles each) and ~16 column strips of S^T
// (read by 8 row tiles each), so each strip comes from HBM about once per
// group:
// ~8 GB of Linv and ~17 GB of S^T in all, against ~133 GB for S^T if every
// row tile re-read it.
#include "tf32x3.cuh"

namespace {

using namespace mfgp::tc;

constexpr int kStepsPerPart = 1;  // k-steps of 8 per partial sum (engine)
constexpr int kGroup = 8;         // row tiles per group of the tile order

// tile t of the order over nbi x nbj tiles: (row tile, column tile)
__device__ __forceinline__ int2 posterior_tile(int t, int nbi, int nbj) {
  const int full = nbi / kGroup, per = kGroup * nbj;
  const bool last = t >= full * per;  // the last group, of nbi % kGroup rows
  const int g = last ? full : t / per;
  const int r = last ? t - full * per : t % per;
  const int rows = last ? nbi - full * kGroup : kGroup;
  return make_int2(nbi - 1 - (g * kGroup + r % rows), r / rows);
}

__global__ void __launch_bounds__(kThreads, 1)
posterior_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ Shi, const float* __restrict__ Slo,
                 int lds, const float* __restrict__ alpha, int N, int Mb,
                 float* __restrict__ mu, float* __restrict__ quad) {
  extern __shared__ unsigned char smem[];
  Ring& ring = ring_at(smem);
  __shared__ float red[kConsumers / 32][kTile];

  const int2 tile = posterior_tile(blockIdx.x, (N + kTile - 1) / kTile,
                                   (Mb + kTile - 1) / kTile);
  const int i0 = tile.x * kTile, j0 = tile.y * kTile;
  const int kend = min(N, i0 + kTile);
  const int nk = (kend + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  if (tid == 0) ring_init(ring);
  __syncthreads();
  if (tid >= kConsumers) {
    if (tid == kConsumers) produce(maps, ring, i0, j0, 0, nk);
    return;
  }

  float acc[kAcc];
  consume<kStepsPerPart>(ring, nk, tid / 128, acc);

  // quad: per column, the sum of squares over the thread's two rows, then
  // over the warp's 16 rows (lanes with one l % 4), then over the 8 warps
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float v0 = acc[4 * n + c], v1 = acc[4 * n + 2 + c];
      float q = fmaf(v0, v0, v1 * v1);
      q += __shfl_xor_sync(0xffffffffu, q, 4);
      q += __shfl_xor_sync(0xffffffffu, q, 8);
      q += __shfl_xor_sync(0xffffffffu, q, 16);
      if (lane < 4) red[warp][8 * n + 2 * lane + c] = q;
    }
  }

  // mu: columns j0 + 16 warp + cc, rows k in [i0, kend) of this row tile
  float al[kTile / 32];
#pragma unroll
  for (int q = 0; q < kTile / 32; ++q) {
    const int k = i0 + lane + 32 * q;
    al[q] = k < kend ? alpha[k] : 0.0f;
  }
  for (int cc = 0; cc < kTile / 8; ++cc) {
    const int s = j0 + (kTile / 8) * warp + cc;
    if (s >= Mb) break;
    const size_t row = static_cast<size_t>(s) * lds;
    float u = 0.0f;
#pragma unroll
    for (int q = 0; q < kTile / 32; ++q) {
      const int k = i0 + lane + 32 * q;
      if (k < kend) u = fmaf(al[q], Shi[row + k] + Slo[row + k], u);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      u += __shfl_xor_sync(0xffffffffu, u, off);
    if (lane == 0) atomicAdd(&mu[s], u);
  }

  consumers_sync();
  if (tid < kTile && j0 + tid < Mb) {
    float q = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumers / 32; ++w) q += red[w][tid];
    atomicAdd(&quad[j0 + tid], q);
  }
}

}  // namespace

// Linv hi/lo: (N, N) planes, row stride ldl; S^T hi/lo: (Mb, N) planes, row
// stride lds (both multiples of 4).
extern "C" int mfgp_posterior_f32(const float* Lhi, const float* Llo, int ldl,
                                  const float* Shi, const float* Slo, int lds,
                                  const float* alpha, int N, int Mb, float* mu,
                                  float* quad, void* stream) {
  if (N <= 0 || Mb <= 0) return 0;
  Maps maps;
  cudaError_t e;
  if ((e = make_map(&maps.a_hi, Lhi, N, N, ldl)) != cudaSuccess ||
      (e = make_map(&maps.a_lo, Llo, N, N, ldl)) != cudaSuccess ||
      (e = make_map(&maps.b_hi, Shi, Mb, N, lds)) != cudaSuccess ||
      (e = make_map(&maps.b_lo, Slo, Mb, N, lds)) != cudaSuccess)
    return static_cast<int>(e);
  e = cudaFuncSetAttribute(posterior_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ntiles = ((N + kTile - 1) / kTile) * ((Mb + kTile - 1) / kTile);
  posterior_kernel<<<ntiles, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      maps, Shi, Slo, lds, alpha, N, Mb, mu, quad);
  return static_cast<int>(cudaGetLastError());
}
