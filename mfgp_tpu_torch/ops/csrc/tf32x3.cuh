// The tensor-core engine that B2 (syrk_grad.cu) and B3 (posterior.cu) share:
// one 128 x 128 fp32 tile C = A B^T over a range of k, in 3xTF32.
//
// Operands. A and B arrive pre-split in device memory as TF32 planes, each
// K-major (row-major with k contiguous) with a row stride that is a multiple
// of 4 floats: hi = tf32_round(x) and lo = tf32_round(x - hi) (common.cuh),
// so x = hi + lo to ~2^-22 relative. The product is
//
//   C = A_lo B_hi + A_hi B_lo + A_hi B_hi        (A_lo B_lo, ~2^-22, dropped)
//
// with the two small cross terms issued before hi*hi. wgmma's .tf32 form has
// no transpose flags (the PTX ISA gives them to f16/bf16 only), so both
// operands must be K-major in shared memory; that is why B3 stages S^T and
// B2 reads Linv^T. Pre-splitting costs one read and two writes of each
// operand (1.7-1.9 ms for a 20,000^2 Linv on one H100 80GB HBM3 at 700 W)
// and lets TMA load the planes as they are.
//
// Ring. One producer warp (one thread of it issues) carries the four
// operand boxes of a stage (A_hi, A_lo, B_hi, B_lo, each 128 rows x 32
// floats = 16 KB, one 128-byte swizzle row per tile row) into a
// kStages-deep ring of dynamic shared memory with TMA
// (cp.async.bulk.tensor, SWIZZLE_128B), completing on the stage's "full"
// mbarrier. TMA fills boxes that leave the tensor with zeros, which masks
// the ragged row and k edges without padding copies. Two consumer
// warpgroups each own 64 rows of C and issue wgmma.m64n128k8.f32.tf32.tf32
// from the stage (four k-steps of 8, three products each), then release it
// on the "empty" mbarrier. Three 64 KB stages (197,680 bytes with the
// barriers and alignment) leave one block per SM.
//
// Two-level sum. The wgmmas of every kSteps k-steps accumulate into a fresh
// fp32 partial fragment, which is then added to the fp32 accumulator on the
// CUDA cores. A single fp32 sum over up to N = 20,000 rows lost the rbf
// g_logvar to 6e-2 (PERF.md, B2). The tensor cores' own accumulation is
// not IEEE: on the card, sums of same-sign products came out biased low by
// 2.0e-7 to 3.1e-7 relative (the diagonal of Linv^T Linv at N = 20,000, all
// of whose terms are squares; kSteps 4 and 1; the dropped lo*lo term is
// 0.5e-7 of it), while mixed-sign sums showed no measurable bias. B2
// therefore takes its diagonal from a float64 pass instead (syrk_grad.cu).
#pragma once

#include <cuda.h>  // CUtensorMap (types only; the encoder comes from the runtime)

#include "common.cuh"

namespace mfgp {
namespace tc {

constexpr int kTile = 128;                      // C rows and columns
constexpr int kBK = 32;                         // k per stage (128 bytes)
constexpr int kStages = 3;
constexpr int kPlane = kTile * kBK;             // floats per operand box
constexpr int kStageBytes = 4 * kPlane * 4;     // 64 KB
constexpr int kConsumers = 256;                 // two warpgroups
constexpr int kThreads = kConsumers + 32;       // + the producer warp
constexpr int kAcc = 64;                        // C floats per consumer thread

struct Maps {
  CUtensorMap a_hi, a_lo, b_hi, b_lo;
};

struct Stage {
  float a_hi[kPlane], a_lo[kPlane], b_hi[kPlane], b_lo[kPlane];
};

struct Ring {
  Stage st[kStages];  // 1024-byte aligned (SWIZZLE_128B)
  uint64_t full[kStages], empty[kStages];
};

// dynamic shared memory a kernel on this engine asks for: the ring and the
// slack that aligns it to 1024 bytes
constexpr int kSmemBytes = static_cast<int>(sizeof(Ring)) + 1024;

// ---------------------------------------------------------------- host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A TMA map of a (rows, cols) fp32 plane with row stride ld (floats, a
// multiple of 4), cut in (kTile rows, kBK cols) boxes. cuTensorMapEncodeTiled
// is fetched through the runtime's entry-point query, so the library needs
// no -lcuda.
inline cudaError_t make_map(CUtensorMap* map, const float* base, int rows,
                            int cols, int ld) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (rows <= 0 || cols <= 0 || ld < cols || ld % 4 != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {kBK, kTile};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                            const_cast<float*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// -------------------------------------------------------------- device side
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ Ring& ring_at(unsigned char* smem) {
  const uint32_t a = smem_u32(smem);
  return *reinterpret_cast<Ring*>(smem + (((a + 1023u) & ~1023u) - a));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of this parity has completed; a ring
// that makes no progress for ~2^34 clocks (seconds) is a fault, and traps
// rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(k),
         "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// barrier of the two consumer warpgroups only (named barrier 1); the
// producer warp never joins it
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}

// wgmma shared-memory descriptor of a K-major SWIZZLE_128B tile: 8-row
// groups 1024 bytes apart (SBO), the leading offset unused (1), 1024-byte
// aligned base. A k-step of 8 floats moves the start address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const float* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// pins the fragment's registers at this point of the program, so that no
// access to them moves across a wgmma issue or wait
__device__ __forceinline__ void fence_fragment(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A[64 x 8] B[128 x 8]^T, both K-major in shared memory, TF32 inputs,
// fp32 accumulate; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Thread 0 only, before the block's first __syncthreads.
__device__ __forceinline__ void ring_init(Ring& r) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&r.full[s], 1);
    mbar_init(&r.empty[s], kConsumers);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The producer thread: nk stages of A rows [a_row, a_row + 128) and B rows
// [b_row, b_row + 128) over k = k0 + kBK t.
__device__ __forceinline__ void produce(const Maps& m, Ring& r, int a_row,
                                        int b_row, int k0, int nk) {
  for (int t = 0; t < nk; ++t) {
    const int s = t % kStages;
    if (t >= kStages) mbar_wait(&r.empty[s], ((t / kStages) - 1) & 1);
    mbar_expect_tx(&r.full[s], kStageBytes);
    const int k = k0 + t * kBK;
    Stage& st = r.st[s];
    tma_load(st.a_hi, &m.a_hi, &r.full[s], k, a_row);
    tma_load(st.a_lo, &m.a_lo, &r.full[s], k, a_row);
    tma_load(st.b_hi, &m.b_hi, &r.full[s], k, b_row);
    tma_load(st.b_lo, &m.b_lo, &r.full[s], k, b_row);
  }
}

// A consumer thread of warpgroup wg (rows 64 wg .. 64 wg + 63 of C): acc
// ends as this thread's fragment of C over all nk stages. Fragment layout
// (wgmma m64nN): with w = warp in the warpgroup and l = lane,
// acc[4 n + 2 h + c] is C[64 wg + 16 w + l / 4 + 8 h, 8 n + 2 (l % 4) + c].
//
// kSteps k-steps of 8 go into each fresh partial before it is added to acc
// (1, 2 or 4: a partial per stage); each kernel picks its own by measured
// error and time.
template <int kSteps>
__device__ __forceinline__ void consume(Ring& r, int nk, int wg,
                                        float (&acc)[kAcc]) {
  static_assert(kSteps == 1 || kSteps == 2 || kSteps == 4, "kSteps");
  float part[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = part[e] = 0.0f;
  for (int t = 0; t < nk; ++t) {
    const int s = t % kStages;
    mbar_wait(&r.full[s], (t / kStages) & 1);
    const Stage& st = r.st[s];
    const int arow = wg * 64 * kBK;
    const uint64_t ah = sw128_desc(st.a_hi + arow);
    const uint64_t al = sw128_desc(st.a_lo + arow);
    const uint64_t bh = sw128_desc(st.b_hi);
    const uint64_t bl = sw128_desc(st.b_lo);
#pragma unroll
    for (int g = 0; g < kBK / 8; g += kSteps) {
      fence_fragment(part);
      wgmma_fence();
#pragma unroll
      for (int kk = g; kk < g + kSteps; ++kk) {
        wgmma_tf32(part, al + 2 * kk, bh + 2 * kk, kk > g);
        wgmma_tf32(part, ah + 2 * kk, bl + 2 * kk, 1);
      }
#pragma unroll
      for (int kk = g; kk < g + kSteps; ++kk)
        wgmma_tf32(part, ah + 2 * kk, bh + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_fragment(part);
      if (g + kSteps == kBK / 8) mbar_arrive(&r.empty[s]);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] += part[e];
    }
  }
}

}  // namespace tc
}  // namespace mfgp
