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
// What bounds it on the H100: the K^-1 tiles, ~N^3/6 multiply-adds over
// the lower tile pairs (1.3e12 at N = 20,000); everything else is O(N^2).
// In 3xTF32 on the tensor cores that is 8e12 TF32 flop, 16 ms at the
// 495 TFLOP/s dense peak (IEEE fp32 on the CUDA cores, the earlier
// kernel of this file: 136 ms). Operand strips come from L2 for the pairs
// of a group (below).
// Measured on one H100 80GB HBM3 at 700 W at N = 20,000, F = 3, D = 3,
// wrapper passes included: 28.03 ms rbf, 32.13 ms matern32 (plain version
// 120.28 / 187.90 ms), 95.1 TFLOP/s float32-equivalent for rbf, 58 % of
// the 3xTF32 bound.
//
// Design: K^-1[a, b] = sum_{k >= i0} Linv^T[a, k] Linv^T[b, k] is the
// engine's A B^T (tf32x3.cuh) with A = B = Linv^T, whose hi/lo planes the
// wrapper forms once (a transpose fused with the split: wgmma .tf32 reads
// K-major operands only). One block per lower 128 x 128 tile pair (i >= j),
// in the order of syrk_pair (from blockIdx.x): super-tiles of 8 x 8 pairs,
// the super-rows with the longest walk (small i) first, so that the pairs
// in flight share their operand strips in L2. The block walks k from 128 i
// to N, with a fresh partial per 32-row stage (kStepsPerPart = 4: of 4, 2 and 1 the
// fastest on the card, 28.8 against 29.3 and 33.9 ms, and off the diagonal
// more accurate than 1).
//
// diag(K^-1) = sum_k Linv[k, a]^2 sums squares, which the tensor cores'
// accumulation biases low by ~2.5e-7 relative (tf32x3.cuh); the trace
// identities add that bias N times, and it put the rbf g_logvar 3e-4 off
// normwise at N = 20,000. diag_kinv_kernel sums those squares in float64
// on the CUDA cores (O(N^2 / 2) reads, before the main kernel), and the
// diagonal tiles take it instead of the tensor-core value: 1.6e-5.
//
// The epilogue keeps the CUDA-core kernel's mathematics: the accumulator
// goes through shared memory (over the ring, which is idle by then) as the
// W tile; then per fidelity T_m is rebuilt from the scaled points,
// contracted with [1, x] on the row side and, on strictly lower tiles, on
// the mirrored column side. Row sums reduce across a half-warp with
// shuffles, column sums across warps with shared-memory atomics; each block
// then adds its (1 + D) x 128 sums into the (F, 1+D, N) outputs with global
// atomicAdd. The caller's assembly (x^2 . s - x . (A x)) cancels by ~1e3,
// so every sum past each thread's own 8 products is float64: the
// shuffles, the shared-memory atomics and the global atomics. With
// float32 global outputs the rbf lengthscale gradient swung between 5e-4
// and 1.3e-3 relative from run to run with the order of the atomics. With
// float32 shuffles and shared atomics, an rbf entry of 1.9 at N = 333,
// F = 3 was off by -3.2e-3 with a run-to-run std of 1.2e-3 (200 runs)
// against its 5.8e-3 bar, failing 2 to 5.5 % of runs; float64 from the
// shuffles on: -4.9e-4, the same in every run, at +0.3 to +0.6 ms at
// N = 20,000 (float64 from the first product: -1e-5, but 100 bytes of
// spills and +2.8 / +5.1 ms; all on one H100 80GB HBM3 at 700 W). The
// W o T entries and the 8-term sums stay float32. diag(W) is stored by
// the diagonal tiles, once per entry.
#include "tf32x3.cuh"

namespace {

using namespace mfgp::tc;

constexpr int kNT = 16;            // epilogue threads per tile edge
constexpr int kR = kTile / kNT;    // epilogue register sub-tile edge
constexpr int kQ = mfgp::kMaxD + 1;
constexpr int kStepsPerPart = 4;   // k-steps of 8 per partial sum (engine)
constexpr int kGroup = 8;          // tile rows per super-row of the order

// pair t of the order over the nb (nb + 1) / 2 lower tile pairs (i, j):
// super-row by super-row of kGroup tile rows; in each, the super-tiles left
// to right, and inside a super-tile row by row
__device__ __forceinline__ int2 syrk_pair(int t, int nb) {
  for (int i0 = 0;; i0 += kGroup) {
    const int rows = min(kGroup, nb - i0);
    const int below = i0 * rows;  // pairs left of the diagonal super-tile
    const int n = below + rows * (rows + 1) / 2;
    if (t >= n) {
      t -= n;
      continue;
    }
    if (t < below) {
      const int J = t / (kGroup * rows), r = t % (kGroup * rows);
      return make_int2(i0 + r / kGroup, J * kGroup + r % kGroup);
    }
    t -= below;
    for (int i = 0;; ++i) {
      if (t <= i) return make_int2(i0 + i, i0 + t);
      t -= i + 1;
    }
  }
}

// the epilogue's shared memory, laid over the ring
struct Epilogue {
  float W[kTile][kTile + 1];
  float Ai[kTile][kQ], Aj[kTile][kQ];  // scaled points, fidelity m
  float Xi[kTile][kQ], Xj[kTile][kQ];  // [1, x]
  float wi[kTile], wj[kTile];
  double red_r[2][kQ][kTile], red_c[2][kQ][kTile];
};
static_assert(sizeof(Epilogue) <= sizeof(Stage) * kStages,
              "the epilogue must fit over the ring");

// diag(K^-1)[a] = sum_{k >= a} Linv[k, a]^2 on the CUDA cores, summed in
// float64 and rounded once: one block per 32 columns, rows from the block's
// first column (Linv is zero above its diagonal). O(N^2 / 2) reads.
__global__ void __launch_bounds__(256)
diag_kinv_kernel(const float* __restrict__ Linv, int N,
                 float* __restrict__ kdiag) {
  __shared__ double red[8][32];
  const int c0 = blockIdx.x * 32, a = c0 + threadIdx.x;
  double s = 0.0;
  if (a < N) {
    for (int k = c0 + threadIdx.y; k < N; k += 8) {
      const double x = Linv[static_cast<size_t>(k) * N + a];
      s = fma(x, x, s);
    }
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && a < N) {
    for (int r = 1; r < 8; ++r) s += red[r][threadIdx.x];
    kdiag[a] = static_cast<float>(s);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
syrk_grad_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ alpha,
                 const float* __restrict__ A, const float* __restrict__ w,
                 const float* __restrict__ X, int N, int F, int D, int kern,
                 const float* __restrict__ kdiag, double* __restrict__ sv,
                 double* __restrict__ sv2, float* __restrict__ diagW) {
  extern __shared__ unsigned char smem[];
  Ring& ring = ring_at(smem);

  const int2 pair = syrk_pair(blockIdx.x, (N + kTile - 1) / kTile);
  const int i0 = pair.x * kTile, j0 = pair.y * kTile;
  const bool diag_tile = pair.x == pair.y;
  const int nk = (N - i0 + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  if (tid == 0) ring_init(ring);
  __syncthreads();
  if (tid >= kConsumers) {
    if (tid == kConsumers) produce(maps, ring, i0, j0, i0, nk);
    return;
  }

  // ---- K^-1 tile on the tensor cores
  float acc[kAcc];
  consume<kStepsPerPart>(ring, nk, tid / 128, acc);
  consumers_sync();  // every stage read: the ring becomes the epilogue's

  // ---- W tile = K^-1 tile - alpha_a alpha_b, into shared memory, with
  // diag(K^-1) from diag_kinv_kernel on the diagonal
  Epilogue& sh = *reinterpret_cast<Epilogue*>(&ring.st[0]);
  {
    const int wg = tid / 128, w4 = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = 64 * wg + 16 * w4 + lane / 4 + 8 * h;
      const float al_a = i0 + a < N ? alpha[i0 + a] : 0.0f;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int b = 8 * n + 2 * (lane % 4) + c;
          const float al_b = j0 + b < N ? alpha[j0 + b] : 0.0f;
          const float kinv = diag_tile && a == b && i0 + a < N
                                 ? kdiag[i0 + a] : acc[4 * n + 2 * h + c];
          sh.W[a][b] = kinv - al_a * al_b;
        }
      }
    }
  }
  // raw points [1, x] of both tiles, for the contractions
  for (int e = tid; e < kTile * kQ; e += kConsumers) {
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
    sh.Xi[a][q] = xi;
    sh.Xj[a][q] = xj;
  }
  consumers_sync();
  if (diag_tile && tid < kTile && i0 + tid < N)
    diagW[i0 + tid] = sh.W[tid][tid];

  const int tx = tid % kNT, ty = tid / kNT;
  const bool matern = kern == mfgp::kMatern32;
  const int nq = 1 + D;
  const int nout = matern ? 2 : 1;
  for (int m = 0; m < F; ++m) {
    if (m > 0) consumers_sync();  // previous fidelity's shared data consumed
    for (int e = tid; e < kTile * D; e += kConsumers) {
      const int a = e / D, d = e % D;
      const int ga = i0 + a, gb = j0 + a;
      sh.Ai[a][d] = ga < N ? A[(static_cast<size_t>(m) * N + ga) * D + d] : 0.f;
      sh.Aj[a][d] = gb < N ? A[(static_cast<size_t>(m) * N + gb) * D + d] : 0.f;
    }
    if (tid < kTile) {
      sh.wi[tid] = i0 + tid < N ? w[static_cast<size_t>(m) * N + i0 + tid] : 0.f;
      sh.wj[tid] = j0 + tid < N ? w[static_cast<size_t>(m) * N + j0 + tid] : 0.f;
    }
    for (int e = tid; e < 2 * kQ * kTile; e += kConsumers)
      (&sh.red_c[0][0][0])[e] = 0.0;
    consumers_sync();

    for (int o = 0; o < nout; ++o) {
      // o = 0: M = W o T_m; o = 1 (matern32): M = W o (w w^T 3 e^{-sqrt3 r});
      // one matrix at a time keeps the epilogue in registers
      float mm[kR][kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int a = ty + kNT * r;
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          const int b = tx + kNT * c;
          const float r2 = mfgp::sqdist(sh.Ai[a], sh.Aj[b], D);
          float base;
          if (matern) {
            const float rr = sqrtf(r2 + 1e-36f);
            const float e = expf(-mfgp::kSqrt3 * rr);
            base = o ? 3.0f * e : (1.0f + mfgp::kSqrt3 * rr) * e;
          } else {
            base = expf(-0.5f * r2);
          }
          mm[r][c] = sh.W[a][b] * (sh.wi[a] * sh.wj[b] * base);
        }
      }
      for (int q = 0; q < nq; ++q) {
        // row side: rows a_r gather sum_c M[a_r, b_c] x_q[b_c]
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float v32 = 0.0f;
#pragma unroll
          for (int c = 0; c < kR; ++c)
            v32 = fmaf(mm[r][c], sh.Xj[tx + kNT * c][q], v32);
          double v = v32;
#pragma unroll
          for (int off = kNT / 2; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (tx == 0) sh.red_r[o][q][ty + kNT * r] = v;
        }
        // mirrored column side (strictly lower tiles): the upper tile
        // (j, i) gives rows b_c the sums sum_r M[a_r, b_c] x_q[a_r]
        if (!diag_tile) {
#pragma unroll
          for (int c = 0; c < kR; ++c) {
            float u32 = 0.0f;
#pragma unroll
            for (int r = 0; r < kR; ++r)
              u32 = fmaf(mm[r][c], sh.Xi[ty + kNT * r][q], u32);
            double u = u32;
            u += __shfl_xor_sync(0xffffffffu, u, kNT);
            if ((ty & 1) == 0) atomicAdd(&sh.red_c[o][q][tx + kNT * c], u);
          }
        }
      }
    }
    consumers_sync();

    for (int e = tid; e < nout * nq * kTile; e += kConsumers) {
      const int o = e / (nq * kTile), q = (e / kTile) % nq, t = e % kTile;
      double* dst = o ? sv2 : sv;
      const size_t base = (static_cast<size_t>(m) * nq + q) * N;
      if (i0 + t < N)
        atomicAdd(&dst[base + i0 + t], sh.red_r[o][q][t]);
      if (!diag_tile && j0 + t < N)
        atomicAdd(&dst[base + j0 + t], sh.red_c[o][q][t]);
    }
  }
}

}  // namespace

// Linv: (N, N) row-major; Linv^T hi/lo: (N, N) planes with row stride ldt
// (a multiple of 4); kdiag: N floats of scratch.
extern "C" int mfgp_syrk_grad_f32(const float* Linv, const float* Thi,
                                  const float* Tlo, int ldt,
                                  const float* alpha, const float* A,
                                  const float* w, const float* X, int N, int F,
                                  int D, int kern, float* kdiag, double* sv,
                                  double* sv2, float* diagW, void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  diag_kinv_kernel<<<(N + 31) / 32, dim3(32, 8), 0, st>>>(Linv, N, kdiag);
  Maps maps;
  cudaError_t e;
  if ((e = make_map(&maps.a_hi, Thi, N, N, ldt)) != cudaSuccess ||
      (e = make_map(&maps.a_lo, Tlo, N, N, ldt)) != cudaSuccess)
    return static_cast<int>(e);
  maps.b_hi = maps.a_hi;
  maps.b_lo = maps.a_lo;
  e = cudaFuncSetAttribute(syrk_grad_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nb = (N + kTile - 1) / kTile;
  syrk_grad_kernel<<<nb * (nb + 1) / 2, kThreads, kSmemBytes, st>>>(
      maps, alpha, A, w, X, N, F, D, kern, kdiag, sv, sv2, diagW);
  return static_cast<int>(cudaGetLastError());
}
