// Linv's strip products: the two per-level products of the recursive
// lower-triangular inverse (ops/linalg.tri_inv_recursive),
//
//   inv([[A, 0], [B, C]]) = [[Ai, 0], [-Ci (B Ai), Ci]],
//
// as one triangular tile product on the 3xTF32 engine (tf32x3.cuh):
//
//   C[a, b] = alpha sum_{k in range(tile)} A[a, k] B[b, k]       (A B^T)
//
// where the k range of a 128 x 128 output tile (i, j) is what the
// triangular operand leaves nonzero:
//
//   left  (A lower triangular, Ci (B Ai)):  k < min(K, 128 (i + 1))
//   right (B^T lower triangular, B Ai):     k >= 128 j
//
// It replaces no Pallas kernel: the JAX package leaves these products to
// XLA (mfgp_tpu/ops/linalg.py tri_inv_recursive, at precision HIGHEST),
// and the port ran them as float32 SIMT SGEMM strips through cuBLAS.
//
// What bounds it on the H100: the multiply-adds. Both products of a level
// with halves h and m = n - h are ~m h^2 / 2 each; over the levels of an
// N = 20,000 inverse that is ~N^3 / 6 = 1.3e12, in 3xTF32 three TF32
// products each: 8e12 TF32 flop, 16.2 ms at the 495 TFLOP/s dense peak (the
// bound of B2, syrk_grad.cu, which does the same count). Operand and output
// bytes are O(N^2) per level.
// Measured on one H100 80GB HBM3 at 700 W at N = 20,000 (the unit's rbf
// factor): the products 28.4 ms of device time over all levels, 57 % of the
// bound (the top level's two launches 21.9 ms, 55 %); the whole inverse
// 32.6 ms with its splits (2.7 ms) and base cases, against 81.1 ms by the
// float32 SIMT strips, and 3x closer to the float64 inverse.
//
// Design. Operands are the engine's K-major TF32 hi/lo planes: the wrapper
// (ops/cuda_kernels.tri_gemm) splits B and Ci as they are and Ai
// transposed, and the first product (B Ai) writes its result straight into
// the TF32 planes of its transpose, which are the second product's K-major
// B operand: no float32 B Ai, no split of it. The second product writes
// alpha C (alpha = -1) into the strided view out[h:, :h] of the row-major
// result, so neither a negation pass nor a concatenation follows. The
// skipped k range leaves at most one partly zero 128-wide k tile per output
// tile; the recursion gives exact zeros above Ai's and Ci's diagonals, so
// that tile needs no mask, and TMA zero-fills the ragged row and k edges.
//
// Batching. The recursion's nodes of one level and one size are
// independent, so one launch takes all Z of them (grid.y = z, at most
// kMaxZ): their planes are stacked by rows, and product z writes out +
// off[z]. Levels of small nodes then fill the card: at N = 20,000 the 16
// nodes of 1,250 take one launch of 400 tiles per product, not 16 of 25.
//
// Order (tri_tile, from blockIdx.x): the longest k walks first (right: the
// smallest j; left: the largest i), in groups of 8 tiles along the walk's
// index; within a group column by column, so that the ~132 blocks in flight
// share ~8 operand strips of one side and ~16 of the other in L2. The
// tile's two-level fp32 sum is the engine's, a fresh partial per 32-wide
// stage (kStepsPerPart = 4, as B2). Linv's diagonal blocks come from
// float32 triangular solves, not from tensor-core sums of squares, so the
// same-sign bias of tf32x3.cuh does not enter here.
#include "tf32x3.cuh"

namespace {

using namespace mfgp::tc;

constexpr int kStepsPerPart = 4;  // k-steps of 8 per partial sum (engine)
constexpr int kGroup = 8;         // tiles per group along the walk's index
constexpr int kMaxZ = 64;         // products per launch (grid.y)

// tile t of the order over nbi x nbj tiles: (row tile, column tile)
__device__ __forceinline__ int2 tri_tile(int t, int nbi, int nbj, int left) {
  const int nu = left ? nbi : nbj, nv = left ? nbj : nbi;
  const int full = nu / kGroup, per = kGroup * nv;
  const bool last = t >= full * per;  // the last group, of nu % kGroup
  const int g = last ? full : t / per;
  const int r = last ? t - full * per : t % per;
  const int rows = last ? nu - full * kGroup : kGroup;
  const int u = g * kGroup + r % rows, v = r / rows;
  return left ? make_int2(nu - 1 - u, v) : make_int2(v, u);
}

// Z products of one shape in one launch (grid.y = z): product z reads A
// rows z M + (0 .. M), B rows z N + (0 .. N) of the stacked planes, and
// writes out + off[z], or rows z N + (0 .. N) of the stacked C^T planes
struct Args {
  int M, N, K, left;
  float alpha;
  float* out;
  long long ldo;
  long long off[kMaxZ];
  float* out_hi;
  float* out_lo;
  int ldp;
};

__global__ void __launch_bounds__(kThreads, 1)
tri_gemm_kernel(const __grid_constant__ Maps maps,
                const __grid_constant__ Args args) {
  extern __shared__ unsigned char smem[];
  Ring& ring = ring_at(smem);

  const int M = args.M, N = args.N, K = args.K, z = blockIdx.y;
  const int nbi = (M + kTile - 1) / kTile, nbj = (N + kTile - 1) / kTile;
  const int2 tile = tri_tile(blockIdx.x, nbi, nbj, args.left);
  const int i0 = tile.x * kTile, j0 = tile.y * kTile;
  const int k0 = args.left ? 0 : j0;
  const int k1 = args.left ? min(K, i0 + kTile) : K;
  const int nk = (k1 - k0 + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  if (tid == 0) ring_init(ring);
  __syncthreads();
  if (tid >= kConsumers) {
    // a tile's rows past M (or N) read the next product's rows: they only
    // reach output rows (columns) that the epilogue drops
    if (tid == kConsumers)
      produce(maps, ring, z * M + i0, z * N + j0, k0, nk);
    return;
  }

  float acc[kAcc];
  consume<kStepsPerPart>(ring, nk, tid / 128, acc);

  // epilogue: alpha C into the strided output, or into the TF32 planes of
  // C^T (row b, column a); each store of a warp covers 32-byte runs
  float* const out =
      args.out_hi != nullptr ? nullptr : args.out + args.off[z];
  const int wg = tid / 128, w4 = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = i0 + 64 * wg + 16 * w4 + lane / 4 + 8 * h;
    if (a >= M) continue;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int b = j0 + 8 * n + 2 * (lane % 4) + c;
        if (b >= N) continue;
        const float v = args.alpha * acc[4 * n + 2 * h + c];
        if (out == nullptr) {
          const float hi = mfgp::tf32_round(v);
          const size_t at = static_cast<size_t>(z * N + b) * args.ldp + a;
          args.out_hi[at] = hi;
          args.out_lo[at] = mfgp::tf32_round(v - hi);
        } else {
          out[static_cast<size_t>(a) * args.ldo + b] = v;
        }
      }
    }
  }
}

}  // namespace

// Z products of one shape. A hi/lo: Z stacked (M, K) planes, (Z M, K) of
// row stride lda; B hi/lo: (Z N, K) of row stride ldb (both multiples of
// 4). Output: product z into out + off[z] ((M, N), row stride ldo), or,
// when out_hi is given, the TF32 planes of C^T, (Z N, M) of row stride
// ldp. left: 1 for the left rule, 0 for the right (see the header).
extern "C" int mfgp_tri_gemm_f32(const float* a_hi, const float* a_lo,
                                 int lda, const float* b_hi,
                                 const float* b_lo, int ldb, int Z, int M,
                                 int N, int K, int left, float alpha,
                                 float* out, long long ldo,
                                 const long long* off, float* out_hi,
                                 float* out_lo, int ldp, void* stream) {
  if (M <= 0 || N <= 0 || Z <= 0) return 0;
  if (K <= 0 || Z > kMaxZ) return static_cast<int>(cudaErrorInvalidValue);
  if (out_hi == nullptr ? (out == nullptr || off == nullptr || ldo < N)
                        : (out_lo == nullptr || ldp < M))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  cudaError_t e;
  if ((e = make_map(&maps.a_hi, a_hi, Z * M, K, lda)) != cudaSuccess ||
      (e = make_map(&maps.a_lo, a_lo, Z * M, K, lda)) != cudaSuccess ||
      (e = make_map(&maps.b_hi, b_hi, Z * N, K, ldb)) != cudaSuccess ||
      (e = make_map(&maps.b_lo, b_lo, Z * N, K, ldb)) != cudaSuccess)
    return static_cast<int>(e);
  Args args{M, N, K, left, alpha, out, ldo, {}, out_hi, out_lo, ldp};
  for (int z = 0; z < Z && out_hi == nullptr; ++z) args.off[z] = off[z];
  e = cudaFuncSetAttribute(tri_gemm_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nbi = (M + kTile - 1) / kTile, nbj = (N + kTile - 1) / kTile;
  tri_gemm_kernel<<<dim3(nbi * nbj, Z), kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(maps, args);
  return static_cast<int>(cudaGetLastError());
}
