// B1: fused AR1 covariance
//
//   K[i, j] = sum_m wA[m, i] wB[m, j] base(|(A[m, i] - B[m, j]) o il[m]|^2)
//             (+ noise[i] where i == j, when a noise vector is given)
//
// with A, B the points (unscaled) and il[m] fidelity m's inverse
// lengthscales. The difference is taken before the scaling: two close
// points subtract exactly in float32, where points scaled first lose the
// digits their difference needs once |x| / lengthscale is large (the
// Pallas kernel scales first: at lengthscale 0.002 and coordinates ~15,
// 2.6e-4 relative against 6e-8 this way, a refit's trial hyperparameters).
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
// What bounds it on the H100: with D = 3 the distance is three subtractions,
// three products and three FMAs per fidelity, so there is no product for the tensor cores
// to take. Each output costs F exponentials (plus F square roots for
// matern32) and one 4-byte store (two for the split). At the unit's
// 20,000 x 20,000 Gram (F = 3) that is 1.6 GB written, 0.48 ms at 3.35 TB/s,
// against ~1.2e9 exponentials and ~2e10 thread instructions on the FP32
// pipes and special-function units, of the same order (~0.3-0.6 ms). So the
// design keeps the instructions per output few and halves the arithmetic of a
// Gram, and lets the stores run at full width:
//
// - The special-function unit. The base kernels take 2^x and 1/sqrt(x)
//   as one MUFU instruction each (ex2/rsqrt.approx); IEEE expf and sqrtf
//   would cost 9 and ~20 instructions per term, with a branch, and the
//   inner loop would double for matern32. The approximations are good to
//   ~1e-7 relative, far inside B1's 1e-5 absolute bar.
// - Compile-time shape. The base and the padded D (3 for D <= 3, 8 for
//   4 <= D <= 8: zero coordinates add exactly 0 to the distance) are
//   template parameters, so the inner loop carries no predicate, division
//   or branch on the base. F stays a runtime loop.
// - 8 x 8 outputs per thread. A block of 256 threads owns a 128 x 128 tile;
//   each thread holds rows 4ty..4ty+3 and 64+4ty..64+4ty+3 and the same
//   columns in tx. Up to 4 fidelities' scaled points and weights for the
//   tile (4 D (128 + 128) + 2 x 4 x 128 floats) are staged at a time,
//   behind one barrier (F <= 4: all of them, once), and read as 16-byte
//   broadcasts from shared memory.
// - Stores. Each run of 4 outputs of a row is one 16-byte streaming store
//   (st.global.cs: the output is 32x the L2) where the row stride and base
//   allow it, scalar stores on the ragged edge. A warp is 8 threads across
//   by 4 down, so one store instruction writes 4 rows x 128 contiguous
//   bytes. The split writes both planes from the same registers.
// - The symmetric Gram (sym: the wrapper was handed the same points twice).
//   Only the tiles on and below the diagonal are computed, T(T+1)/2 blocks
//   for T row tiles; each off-diagonal tile is written twice, as itself and
//   as its mirror. The thread layout is the same in rows and columns, so a
//   thread's mirror is again 4-wide runs of rows (8 rows x 64 contiguous
//   bytes per store instruction) and needs no shared-memory transpose. The
//   result is bit for bit the general path's: (a - b)^2 = (b - a)^2,
//   wA_i wA_j = wA_j wA_i and the fidelity sum runs in the same order.
//
// The noise lands only on the global diagonal (i == j), tested only in the
// tiles that meet it. Ragged edges are masked in the kernel; nothing is
// padded or copied.
//
// The lane axis: L independent covariances, one per lane, in one launch,
// the counterpart of jax.vmap over the pallas_call (which gives its grid a
// batch dimension). grid.z is the lane; each block moves every pointer by
// its lane's strides and then runs as a single-lane block does, so a
// lane's result is bit for bit that of a single-lane launch on the same
// inputs (a single covariance is L = 1, and takes an instantiation
// without the pointer moves). The batched fits of the study
// run one launch for all datasets x restarts: at N ~ 700 a single-lane
// launch is a few microseconds of work behind ~30 small launches of its
// wrapper, and the lanes share those.
//
// What still bounds it: the time is about the sum of the arithmetic and
// the stores, not their maximum. A block computes, then stores, and this
// design does not overlap the two. The times against the bound are in
// PERF.md (chip_smoke.py --b1-times).
#include "common.cuh"

namespace {

constexpr int kBM = 128;       // rows and columns of a block's output tile
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kHalf = 64;      // a thread's two runs of 4 rows (columns)
constexpr int kStage = 4;      // fidelities staged per barrier

struct Args {
  const float* A;
  const float* wA;
  const float* B;
  const float* wB;
  const float* ils;  // (F, D) inverse lengthscales
  const float* noise;
  float* out;
  float* lo;
  long long ldo;
  int N, M, F, D;
  int sym;  // B is A: compute the tiles on and below the diagonal only
  int vec;  // 16-byte stores allowed (row stride and bases aligned)
  // per-lane strides, in floats, of A, wA, B, wB, ils, noise and out (and
  // lo)
  long long sA, swA, sB, swB, sIls, sNoise, sOut;
};

// 2^x and 1/sqrt(x) on the special-function unit, one instruction each
// (relative error ~2^-22; a result below 2^-126 flushes to 0), where the
// IEEE expf and sqrtf cost 9 and ~20 instructions with a branch
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Unit-variance base kernel of the squared scaled distance: rbf exp(-r2/2),
// matern32 (1 + sqrt3 r) exp(-sqrt3 r) with the 1e-36 guard inside the sqrt
// that ops/kernels.matern32 carries (so the reciprocal square root is
// finite: r = g / sqrt(g), g = r2 + 1e-36 > 0)
template <int KERN>
__device__ __forceinline__ float base_kernel(float r2) {
  if constexpr (KERN == mfgp::kRbf) {
    return exp2_approx(r2 * (-0.5f * kLog2e));
  } else {
    const float g = r2 + 1e-36f;
    const float r = g * rsqrt_approx(g);
    return (1.0f + mfgp::kSqrt3 * r) *
           exp2_approx(r * (-mfgp::kSqrt3 * kLog2e));
  }
}

// (row tile, column tile) of this block: the grid itself, or the lower
// triangle walked row by row (t = bi (bi + 1) / 2 + bj, bj <= bi)
__device__ __forceinline__ void tile_of(const Args& a, int& bi, int& bj) {
  if (!a.sym) {
    bi = blockIdx.y;
    bj = blockIdx.x;
    return;
  }
  const long long t = blockIdx.x;
  long long i = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  bi = (int)i;
  bj = (int)(t - i * (i + 1) / 2);
}

// the tile's scaled points (zero past the edge and past D) and weights for
// fidelities f0 .. f0 + nf - 1, as s[f][d][p] and sw[f][p]
template <int DS>
__device__ __forceinline__ void stage(float (*s)[DS][kBM], float (*sw)[kBM],
                                      const float* X, const float* w, int n,
                                      int p0, int f0, int nf, int D,
                                      int tid) {
  for (int e = tid; e < nf * kBM * DS; e += kThreads) {
    const int f = e / (kBM * DS), rem = e - f * (kBM * DS);
    const int p = rem / DS, d = rem - p * DS, g = p0 + p;
    s[f][d][p] = (g < n && d < D) ? X[((size_t)(f0 + f) * n + g) * D + d]
                                  : 0.0f;
  }
  for (int e = tid; e < nf * kBM; e += kThreads) {
    const int f = e / kBM, p = e - f * kBM, g = p0 + p;
    sw[f][p] = g < n ? w[(size_t)(f0 + f) * n + g] : 0.0f;
  }
}

// 4 consecutive points p .. p + 3 of one staged fidelity
// (s: one fidelity's [DS][kBM] block of staged points)
template <int DS>
__device__ __forceinline__ void load4(const float* s, const float* sw, int p,
                                      float (&x)[4][DS], float (&w)[4]) {
#pragma unroll
  for (int d = 0; d < DS; ++d) {
    const float4 t = *reinterpret_cast<const float4*>(&s[d * kBM + p]);
    x[0][d] = t.x;
    x[1][d] = t.y;
    x[2][d] = t.z;
    x[3][d] = t.w;
  }
  const float4 t = *reinterpret_cast<const float4*>(&sw[p]);
  w[0] = t.x;
  w[1] = t.y;
  w[2] = t.z;
  w[3] = t.w;
}

__device__ __forceinline__ float4 tf32_round4(float4 v) {
  return make_float4(mfgp::tf32_round(v.x), mfgp::tf32_round(v.y),
                     mfgp::tf32_round(v.z), mfgp::tf32_round(v.w));
}

__device__ __forceinline__ void store_run(float* p, float4 v, int n,
                                          bool vec) {
  if (n >= 4 && vec) {
    __stcs(reinterpret_cast<float4*>(p), v);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < n) __stcs(p + k, e[k]);
}

// one run of up to 4 outputs of a row at out[at ..], n of them inside
__device__ __forceinline__ void put(const Args& a, size_t at, float4 v,
                                    int n) {
  if (a.lo == nullptr) {
    store_run(a.out + at, v, n, a.vec);
  } else {
    const float4 h = tf32_round4(v);
    store_run(a.out + at, h, n, a.vec);
    store_run(a.lo + at,
              tf32_round4(make_float4(v.x - h.x, v.y - h.y, v.z - h.z,
                                      v.w - h.w)),
              n, a.vec);
  }
}

template <int KERN, int DS, bool LANES>
__global__ void __launch_bounds__(kThreads, DS < mfgp::kMaxD ? 2 : 1)
ar1_cov_kernel(Args a) {
  if constexpr (LANES) {
    // this block's lane: every pointer moves by the lane's strides
    const long long z = blockIdx.z;
    a.A += z * a.sA;
    a.wA += z * a.swA;
    a.B += z * a.sB;
    a.wB += z * a.swB;
    a.ils += z * a.sIls;
    if (a.noise != nullptr) a.noise += z * a.sNoise;
    a.out += z * a.sOut;
    if (a.lo != nullptr) a.lo += z * a.sOut;
  }

  __shared__ __align__(16) float sA[kStage][DS][kBM];
  __shared__ __align__(16) float sB[kStage][DS][kBM];
  __shared__ __align__(16) float swA[kStage][kBM];
  __shared__ __align__(16) float swB[kStage][kBM];

  int bi, bj;
  tile_of(a, bi, bj);
  const int row0 = bi * kBM, col0 = bj * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (lane & 7) | ((warp & 1) << 3);
  const int ty = (lane >> 3) | ((warp >> 1) << 2);

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  for (int f0 = 0; f0 < a.F; f0 += kStage) {
    const int nf = min(kStage, a.F - f0);
    if (f0 > 0) __syncthreads();  // the previous chunk is consumed
    stage<DS>(sA, swA, a.A, a.wA, a.N, row0, f0, nf, a.D, tid);
    stage<DS>(sB, swB, a.B, a.wB, a.M, col0, f0, nf, a.D, tid);
    __syncthreads();
    for (int f = 0; f < nf; ++f) {
      float il[DS];
#pragma unroll
      for (int d = 0; d < DS; ++d)
        il[d] = d < a.D ? __ldg(&a.ils[(f0 + f) * a.D + d]) : 0.0f;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float ax[4][DS], wa[4];
        load4<DS>(&sA[f][0][0], swA[f], kHalf * rh + 4 * ty, ax, wa);
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          float bx[4][DS], wb[4];
          load4<DS>(&sB[f][0][0], swB[f], kHalf * ch + 4 * tx, bx, wb);
#pragma unroll
          for (int rk = 0; rk < 4; ++rk) {
#pragma unroll
            for (int ck = 0; ck < 4; ++ck) {
              float r2 = 0.0f;
#pragma unroll
              for (int d = 0; d < DS; ++d) {
                const float t = (ax[rk][d] - bx[ck][d]) * il[d];
                r2 = fmaf(t, t, r2);
              }
              float& c = acc[4 * rh + rk][4 * ch + ck];
              c = fmaf(wa[rk] * wb[ck], base_kernel<KERN>(r2), c);
            }
          }
        }
      }
    }
  }

  // the tile itself; the noise only in a tile that meets the diagonal
  const bool diag = a.noise != nullptr && row0 == col0;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
#pragma unroll
    for (int rk = 0; rk < 4; ++rk) {
      const int gi = row0 + kHalf * rh + 4 * ty + rk;
      if (gi >= a.N) continue;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const int gj = col0 + kHalf * ch + 4 * tx;
        if (gj >= a.M) continue;
        const int c = 4 * ch;
        float4 v = make_float4(acc[4 * rh + rk][c], acc[4 * rh + rk][c + 1],
                               acc[4 * rh + rk][c + 2],
                               acc[4 * rh + rk][c + 3]);
        if (diag) {
          const int k = gi - gj;
          if (k == 0) v.x += a.noise[gi];
          if (k == 1) v.y += a.noise[gi];
          if (k == 2) v.z += a.noise[gi];
          if (k == 3) v.w += a.noise[gi];
        }
        put(a, (size_t)gi * a.ldo + gj, v, a.M - gj);
      }
    }
  }
  if (!a.sym || bi == bj) return;
  // its mirror above the diagonal: a thread's columns become rows
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
    for (int ck = 0; ck < 4; ++ck) {
      const int gi = col0 + kHalf * ch + 4 * tx + ck;
      if (gi >= a.N) continue;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int gj = row0 + kHalf * rh + 4 * ty;
        if (gj >= a.N) continue;
        const int c = 4 * ch + ck;
        put(a, (size_t)gi * a.ldo + gj,
            make_float4(acc[4 * rh][c], acc[4 * rh + 1][c],
                        acc[4 * rh + 2][c], acc[4 * rh + 3][c]),
            a.N - gj);
      }
    }
  }
}

template <int KERN, bool LANES>
void launch_d(const Args& a, dim3 grid, cudaStream_t s) {
  if (a.D <= 3) {
    ar1_cov_kernel<KERN, 3, LANES><<<grid, kThreads, 0, s>>>(a);
  } else {
    ar1_cov_kernel<KERN, mfgp::kMaxD, LANES><<<grid, kThreads, 0, s>>>(a);
  }
}

// a single covariance takes the instantiation without the lane offsets:
// moving the pointers costs the single-lane kernel registers and 3-11 % of
// its time at the unit's 20,000^2 Gram on the H100 (chip_smoke.py
// --b1-times)
template <int KERN>
void launch_k(const Args& a, dim3 grid, cudaStream_t s) {
  if (grid.z > 1) {
    launch_d<KERN, true>(a, grid, s);
  } else {
    launch_d<KERN, false>(a, grid, s);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// L lanes: A (L, F, N, D) and wA (L, F, N) at lane strides sA and swA (B,
// wB likewise), ils (L, F, D) at sIls, noise (L, N) at sNoise, out and lo
// (L, N, ldo) at sOut; lane l's block of each is one covariance. A single
// covariance is L = 1 with zero strides.
extern "C" int mfgp_ar1_cov_f32(const float* A, const float* wA,
                                const float* B, const float* wB,
                                const float* ils, const float* noise,
                                float* out, float* lo, long long ldo, int L,
                                int N, int M, int F, int D, int kern,
                                int sym, long long sA, long long swA,
                                long long sB, long long swB, long long sIls,
                                long long sNoise, long long sOut,
                                void* stream) {
  if (N <= 0 || M <= 0 || L <= 0) return 0;
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (ldo < M || F < 1 || D < 1 || D > mfgp::kMaxD || L > 65535) return bad;
  if (kern != mfgp::kRbf && kern != mfgp::kMatern32) return bad;
  if (sym && (A != B || wA != wB || N != M || sA != sB || swA != swB))
    return bad;
  const long long tn = (N + kBM - 1) / kBM, tm = (M + kBM - 1) / kBM;
  if (sym ? tn * (tn + 1) / 2 > 0x7FFFFFFF : tn > 65535) return bad;
  const Args a{A, wA, B, wB, ils, noise, out, lo, ldo, N, M, F, D, sym,
               ldo % 4 == 0 && sOut % 4 == 0 && aligned16(out) &&
                   (lo == nullptr || aligned16(lo)),
               sA, swA, sB, swB, sIls, sNoise, sOut};
  const dim3 grid = sym ? dim3((unsigned)(tn * (tn + 1) / 2), 1, L)
                        : dim3((unsigned)tm, (unsigned)tn, L);
  const auto s = static_cast<cudaStream_t>(stream);
  if (kern == mfgp::kRbf) {
    launch_k<mfgp::kRbf>(a, grid, s);
  } else {
    launch_k<mfgp::kMatern32>(a, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mfgp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
