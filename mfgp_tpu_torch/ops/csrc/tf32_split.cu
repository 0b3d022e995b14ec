// TF32 hi/lo split of an fp32 matrix, optionally transposed: the operand
// planes of the 3xTF32 engine (tf32x3.cuh).
//
//   hi[p, q] = tf32_round(x),  lo[p, q] = tf32_round(x - hi[p, q])
//   with x = src[p, q], or src[q, p] when transposing
//
// B3 splits Linv as it is (row-major is K-major for V = Linv S); B2 splits
// Linv^T, because wgmma .tf32 reads K-major operands only. Data movement
// only: one read and two writes of the matrix (1.6 GB + 3.2 GB at
// N = 20,000, ~1.5 ms at 3.35 TB/s). 32 x 32 tiles go through shared
// memory, so that both the read and the writes are coalesced when
// transposing. The plain version is ops/cuda_kernels.tf32_split_plain.
#include "common.cuh"

namespace {

constexpr int kT = 32;
constexpr int kRows = 8;

__global__ void __launch_bounds__(kT * kRows)
split_kernel(const float* __restrict__ src, int rows, int cols, int ld_src,
             int transpose, float* __restrict__ hi, float* __restrict__ lo,
             int ld_out) {
  __shared__ float tile[kT][kT + 1];
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < kT; r += kRows) {
    const int gr = r0 + r, gc = c0 + tx;
    tile[r][tx] = (gr < rows && gc < cols)
                      ? src[static_cast<size_t>(gr) * ld_src + gc] : 0.0f;
  }
  __syncthreads();
  for (int r = ty; r < kT; r += kRows) {
    // output row p, column q: src[r0 + r, c0 + tx], or src[c0 + r, r0 + tx]
    const int p = transpose ? c0 + r : r0 + r;
    const int q = transpose ? r0 + tx : c0 + tx;
    const float x = transpose ? tile[tx][r] : tile[r][tx];
    if ((transpose ? p < cols && q < rows : p < rows && q < cols)) {
      const float h = mfgp::tf32_round(x);
      const size_t at = static_cast<size_t>(p) * ld_out + q;
      hi[at] = h;
      lo[at] = mfgp::tf32_round(x - h);
    }
  }
}

}  // namespace

// src: (rows, cols), row stride ld_src; hi/lo: (rows, cols), or (cols, rows)
// when transposing, row stride ld_out.
extern "C" int mfgp_tf32_split_f32(const float* src, int rows, int cols,
                                   int ld_src, int transpose, float* hi,
                                   float* lo, int ld_out, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (ld_src < cols || ld_out < (transpose ? rows : cols))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kT, kRows);
  const dim3 grid((cols + kT - 1) / kT, (rows + kT - 1) / kT);
  split_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      src, rows, cols, ld_src, transpose, hi, lo, ld_out);
  return static_cast<int>(cudaGetLastError());
}
