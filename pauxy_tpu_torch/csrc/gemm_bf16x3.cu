// The 3-pass bf16 split GEMM of the 'bfloat16_3x' matmul tier:
//   D = alpha (A B) + beta C,  A [batch, M, K], B [batch, K, N],
// float32 or complex64, each float32 value x split into
// x_hi = bf16_rn(x) and x_lo = bf16_rn(x - x_hi), and each real product
// computed as a_hi b_lo + a_lo b_hi + a_hi b_hi with bf16 multiplicands and
// one float32 accumulator (a_lo b_lo dropped): XLA's BF16_BF16_F32_X3 dot
// algorithm, what JAX's 'bfloat16_3x' tier runs on the TPU's MXU. A
// complex64 product is the four real products on the planes,
// Re = Ar Br - Ai Bi and Im = Ar Bi + Ai Br, three passes each (no 3M:
// its cancellation would add error the tier does not have).
//
// It replaces no Pallas kernel: JAX's tier reaches XLA's dot through
// jax_default_matmul_precision (pauxy_tpu/config.py:set_matmul_precision,
// the "bfloat16_3x" chain), every float32 / complex64 product not pinned to
// HIGHEST. ops/gemm3_cuda routes the port's aten mm / bmm / addmm /
// baddbmm of those types here while the tier is in force on a card.
//
// What bounds it on the H100: at the Generic VHS shape [1024, 512] x
// [512, 16384] the three passes are 3 x 2 M N K = 5.15e10 FLOPs, 0.052 ms at
// the bf16 tensor cores' 989 TFLOP/s, against 102.8 MB read and written
// once (0.031 ms at 3.35 TB/s): bound by operations (complex64, four real
// products: 0.208 ms). Splitting each tile once in shared memory moves,
// for each 16-deep slab of a 128 x 256 float32 tile, 24 KB in by TMA, 24
// KB to the converter, 24 KB of bf16 back and 60 KB to wgmma (B is read by
// both warpgroups, three passes each): 132 KB at the SM's 128 bytes a
// cycle, ~1030 cycles, against 768 cycles of products. So shared memory,
// not the tensor cores, sets the pace of a float32 tile (at most ~3/4 of
// the bf16 rate); complex64 (twelve products a slab for the same bytes)
// comes near the tensor cores' pace. Every SM writes its tiles' D at the
// same moments, 64 MB at the VHS shape, and the loads of the next slabs
// queue behind those stores. Measured (tools/kernel_stamps.py, H100 80GB
// HBM3 at 700 W), a consumer warpgroup at the VHS shape in float32 spends
// 54% of its cycles converting (the shared-memory traffic above), 19%
// waiting for slabs, 14% storing D and 8% issuing products.
//
// The products it serves (tools/gemm3_shapes.py; the three largest groups
// a block): the thermal UEG's [512, 93, 93] x [512, 93, 93] complex64
// (67.7 ms a path), the "xla" Taylor series' [512, 257, 257] x
// [512, 257, 14] complex64 (22.4 ms a block) and the Generic block's
// [1024, 2048] x [2048, 512] float32 with A the real plane of a complex
// tensor (15.2 ms a block).
//
// Routes, picked by ops/gemm3_cuda.plan by shape before any launch:
// the skinny route (at most 8 rows, or columns of the transposed product;
// below) and the wgmma tiles: D in tiles of 128 rows x BN columns, BN = 16
// or 32 (the narrow tile: at most 32 columns after a transposition that
// puts the small side of a short product there) or 64, 128, 256 (complex64
// up to 128: two accumulator planes), halved while the product has tiles
// for fewer than half the SMs. One persistent block an SM walks the tiles.
// No mma.sync tile remains: every product goes to a wgmma tile or to the
// skinny route.
//
// A block: warpgroup 2, the producer (40 registers), stages 16-deep K slabs
// of A and B in their own types into a ring of up to 8 stages (as many as
// fit, at least 3; mbarriers full and empty), running ahead into the next
// tile while the consumers finish one. Warpgroups 0 and 1, the consumers
// (232 registers), split each arrived slab once into bf16 hi and lo tiles
// in shared memory (a ring of 3): K-major rows of 32 bytes in wgmma's
// 32-byte swizzle (chunk index XOR bit 2 of the row), written 16 bytes a
// thread without bank conflicts, whatever order the slab was staged in.
// Then each thread fences its writes for the async proxy, the consumers
// meet at one named barrier, and each warpgroup issues wgmma.mma_async
// m64nBNk16 bf16 -> float32 on its 64 rows with both operands read by
// descriptor from shared memory: a_hi b_lo, a_lo b_hi, a_hi b_hi for each
// real product (-Ai Bi by imm-scale-a = -1), commits them, and waits for
// the previous slab's group (its tiles, 3 back, are then free).
//
// Staging, per operand, by its strides (plan): one TMA box a slab
// (cp.async.bulk.tensor; a __grid_constant__ CUtensorMap encoded by
// libcuda's cuTensorMapEncodeTiled, reached through the runtime, cached by
// pointer, shape, strides and box) where the fast stride is 1, the base
// 16-byte aligned and the other strides nest in 16-byte multiples; [row][k]
// slabs in TMA's 64- or 128-byte swizzle, so the converter reads a chunk
// column without bank conflicts. A float32 .real / .imag view (stride 2 in
// a complex tensor) goes by its complex base at stride 1: both planes
// loaded, the converter keeping one (twice A's bytes, but one box instead
// of an element a copy). Rows that are no whole number of 16 bytes (93 or
// 257 complex values) go by TMA over groups of 2 or 4 rows, a group's
// stride a whole number of 16 bytes (the batch's rows flattened): one box
// a member, read from the 16 bytes that hold its rows' start, each row kept
// at a pitch of its values + 16 bytes and read from its offset, k past K
// zeroed by the converter. Otherwise at unit stride one bulk copy a row
// the same way (cp.async.bulk), and any other layout one cp.async an
// element. A conjugated operand (torch's lazy conj) is read in place, its
// imaginary plane negated at conversion. The batch is part of the tile
// index, with batch strides (0 broadcasts, permuted batches in the map).
// The epilogue writes alpha acc + beta C (C read only when beta != 0)
// through D's strides, CW columns at a time through the free converted
// buffer, so each lane stores 16 contiguous bytes where D allows.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <type_traits>

#include "async_copy.cuh"

namespace {

// ---- The tile routes (wgmma) ----------------------------------------------

constexpr int kBM = 128;         // rows of D a block: two warpgroups of 64
constexpr int kBK = 16;          // depth of a slab: one k16 step of wgmma
constexpr int kStages = 8;       // the float32 / complex64 ring, at most
constexpr int kCvt = 3;          // the bf16 hi / lo ring
constexpr int kConsumers = 256;  // two warpgroups: convert, then wgmma
constexpr int kProducers = 128;  // one warpgroup: TMA or cp.async
constexpr int kThreads = kConsumers + kProducers;
// Registers a thread: at launch (__launch_bounds__(kThreads, 1): 65536 /
// 384, rounded down to 8), then after setmaxnreg the producer's few and the
// consumers' what those free. The consumers' increase waits until the
// block's pool holds it, so it must not exceed what the producer releases.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs =
    (kLaunchRegs * kThreads - kProducers * kProducerRegs) / kConsumers / 8 *
    8;
constexpr int kRow = 2 * kBK;    // bytes of a converted row (16 bf16)
constexpr int kSmemMax = 232448; // shared memory a block may have (227 KB)

// Cycles by phase (tools/kernel_stamps.py builds with PAUXY_GEMM3_STAMPS):
// the first consumer thread and the first producer thread of every block
// add their phases' clock64() spans in registers, then once to a device
// array.
#ifdef PAUXY_GEMM3_STAMPS
__device__ unsigned long long g_gemm3_prof[32];
#define GEMM3_STAMP_INIT \
  long long _t0 = clock64();  \
  long long _acc[12] = {};
#define GEMM3_STAMP(i)              \
  do {                              \
    const long long _t = clock64(); \
    _acc[i] += _t - _t0;            \
    _t0 = _t;                       \
  } while (0)
#define GEMM3_STAMP_FLUSH(base)                                         \
  do {                                                                  \
    if ((threadIdx.x & 127) == 0) {                                     \
      for (int _q = 0; _q < 12; ++_q)                                   \
        atomicAdd(&g_gemm3_prof[base + _q], (unsigned long long)_acc[_q]); \
      atomicAdd(&g_gemm3_prof[base + 12], 1ull);                        \
    }                                                                   \
  } while (0)
#else
#define GEMM3_STAMP_INIT
#define GEMM3_STAMP(i)
#define GEMM3_STAMP_FLUSH(base)
#endif

// How an operand is staged (ops/gemm3_cuda.plan), bits of Operand::flags.
constexpr int kKmaj = 1;    // K's stride the smaller: [row][k], else [k][row]
constexpr int kTma = 2;     // one TMA box a slab, else a cp.async an element
constexpr int kPair = 4;    // float32 at stride 2, staged as complex pairs
constexpr int kPlane = 8;   // of a pair, the second (imaginary) plane
constexpr int kConj = 16;   // complex64: the imaginary plane negated
constexpr int kSwap = 32;   // the TMA map's dims (fast, batch, slow)
constexpr int kBcast = 64;  // one matrix for the batch (the map has one)
constexpr int kRows = 128;  // unit stride, rows not 16-byte aligned: a bulk
                            // copy a row (a line of the slab) from the 16
                            // bytes that hold its start
constexpr int kG2 = 256;    // TMA over groups of 2 lines (a line stride of 8
constexpr int kG4 = 512;    // mod 16 bytes), or of 4 (4 or 12 mod 16): one
                            // box a member, the batch's lines flattened

// Lines a group of an operand staged by TMA over groups of lines (1: none).
__host__ __device__ __forceinline__ int group_of(int flags) {
  return (flags & kG4) ? 4 : (flags & kG2) ? 2 : 1;
}

// Bytes of a line of a slab staged by bulk copies or by TMA over groups
// of lines: its kBK or R values and room for a start up to 15 bytes into
// its first 16.
__host__ __device__ constexpr int rows_pitch(int line_elems, int esz) {
  return line_elems * esz + 16;
}

// Lines a box of an operand staged over groups of lines: a slab's lines /
// G + 1 (a slab's first line may be any member of its group).
__host__ __device__ __forceinline__ int group_lines(int flags, int R) {
  return ((flags & kKmaj) ? R : kBK) / group_of(flags) + 1;
}

// Bytes of one such box in shared memory (lines at rows_pitch).
__host__ __device__ __forceinline__ int group_box_bytes(int flags, int R,
                                                        int esz) {
  const int pitch = rows_pitch((flags & kKmaj) ? kBK : R, esz);
  return (group_lines(flags, R) * pitch + 127) / 128 * 128;
}

struct Operand {
  const void* p;             // a pair's complex base
  long long s_b, s_r, s_k;   // strides in elements (a pair's in floats)
  int rows;                  // M for A, N for B
  int flags;
};

struct TileArgs {
  Operand a, b;
  const void* c;
  void* d;
  long long sc_b, sc_m, sc_n, sd_b, sd_m, sd_n;
  int m, n, k;
  float alpha_re, alpha_im, beta_re, beta_im;
  int a_bytes, stage_bytes, cvt_bytes;
  int stages;  // of the float32 / complex64 ring: as many as fit, <= 8
  int vec_d;   // D's rows at stride 1, 16-byte aligned at every 16 bytes
  int m_tiles, n_tiles, tiles;  // D's tiles: rows, columns, all matrices'
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival, and `bytes` more to come from TMA or bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory to shared
// memory, reported to `bar` on arrival.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int L>
__device__ __forceinline__ void fence_acc(float (&d)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Byte offset of the 16-byte chunk c (k = 8c .. 8c + 7) of row r in a
// converted tile: K-major rows of 32 bytes, the 32-byte swizzle (chunk
// index XOR bit 2 of the row; the pattern repeats every 8 rows, 256 bytes).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kRow + ((c ^ ((r >> 2) & 1)) << 4);
}

// wgmma's shared-memory matrix descriptor of a converted tile (K-major):
// start address >> 4; 8-row groups 256 bytes apart; 32-byte swizzle.
__device__ __forceinline__ uint64_t desc(const void* tile) {
  const uint64_t a = (smem_u32(tile) & 0x3FFFF) >> 4;
  return a | (1ull << 16) | ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

// d (64 x N float32, the warpgroup's) += SA A B: A 64 x 16 and B 16 x N
// bf16 from shared memory (descriptors), SA = +1 or -1.
template <int SA>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, %11, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(SA));
}

template <int SA>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, %19, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(SA));
}

template <int SA>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, %35, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(SA));
}

template <int SA>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, %67, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(SA));
}


template <int SA>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, %131, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(SA));
}

template <int N, int SA>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 16) wgmma_n16<SA>(d, da, db);
  if constexpr (N == 32) wgmma_n32<SA>(d, da, db);
  if constexpr (N == 64) wgmma_n64<SA>(d, da, db);
  if constexpr (N == 128) wgmma_n128<SA>(d, da, db);
  if constexpr (N == 256) wgmma_n256<SA>(d, da, db);
}

// hi = bf16_rn(x), lo = bf16_rn(x - hi) of a pair, x0 in the low half
// (x - hi is exact in float32).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Eight values split and stored as one 16-byte chunk of hi and one of lo.
__device__ __forceinline__ void split_store(const float (&v)[8],
                                            unsigned char* hi,
                                            unsigned char* lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) split2(v[2 * q], v[2 * q + 1], h[q], l[q]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Byte offset of the 16-byte chunk j of row r of a slab staged [row][k]
// with rows of rb bytes (64: float32; 128: a complex value or a pair two
// floats): TMA's 64- or 128-byte swizzle, so that the converter's reads of
// a chunk column fall in distinct banks.
__device__ __forceinline__ int raw_chunk(int r, int j, int rb) {
  return r * rb + ((j ^ (rb == 128 ? (r & 7) : ((r >> 1) & 3))) << 4);
}

// Where line i (a row of a [row][k] slab, a k of a [k][row] one) of an
// operand staged by bulk copies starts in global memory: the slab's rows
// row0 .., k0 .. of matrix z.
template <typename T>
__device__ __forceinline__ const T* line_start(const Operand& o, int row0,
                                               int k0, int z, int i) {
  const T* g = static_cast<const T*>(o.p) + z * o.s_b;
  return (o.flags & kKmaj) ? g + (row0 + i) * o.s_r + k0 * o.s_k
                           : g + row0 * o.s_r + (k0 + i) * o.s_k;
}

// Converts unit u (row r, k chunk c) of an operand's staged slab into its
// bf16 tiles: float32 hi, lo; complex64 re hi, re lo, im hi, im lo (R rows
// of kRow bytes each). The slab is [row][k] (swizzled) or [k][row] in
// floats, a complex value or a pair two floats; or, staged by bulk copies
// (kRows), lines of rows_pitch bytes each holding its elements from the
// line's start's offset in its 16 bytes on, zeros put in for k >= K.
template <bool CPLX>
__device__ __forceinline__ void convert(const unsigned char* raw,
                                        unsigned char* tile, int R,
                                        const Operand& o, int row0, int k0,
                                        int K, int z, int u) {
  using Elt = typename std::conditional<CPLX, float2, float>::type;
  const int flags = o.flags;
  const bool kmaj = flags & kKmaj;
  const int r = kmaj ? u >> 1 : u % R;
  const int c = kmaj ? u & 1 : u / R;
  const uint32_t off = swz(r, c);
  const int T = R * kRow;
  if (flags & (kRows | kG2 | kG4)) {
    // Lines at rows_pitch, each from its start's offset in its 16 bytes
    // on; over groups of G lines, line L0 + i of the operand's flattened
    // lines is member (L0 + i) % G of group (L0 + i) / G, in box
    // (L0 + i) % G, the slab's boxes starting at group L0 / G.
    Elt x[8];
    const int pitch = rows_pitch(kmaj ? kBK : R, sizeof(Elt));
    const int gs = (flags & kG4) ? 2 : (flags & kG2) ? 1 : 0;   // log2 G
    const int l0 = ((flags & kBcast) ? 0 : z) * (kmaj ? o.rows : K) +
                   (kmaj ? row0 : k0);
    const int box_bytes = gs ? group_box_bytes(flags, R, sizeof(Elt)) : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * c + j;
      const int line = kmaj ? r : k;
      const int shift = reinterpret_cast<uintptr_t>(
                            line_start<Elt>(o, row0, k0, z, line)) & 15;
      const int at_line =
          gs ? ((l0 + line) & ((1 << gs) - 1)) * box_bytes +
                   (((l0 + line) >> gs) - (l0 >> gs)) * pitch
             : line * pitch;
      const Elt* at = reinterpret_cast<const Elt*>(
          raw + at_line + shift + (kmaj ? k : r) * (int)sizeof(Elt));
      Elt zero;
      if constexpr (CPLX) {
        zero = make_float2(0.f, 0.f);
      } else {
        zero = 0.f;
      }
      x[j] = k0 + k < K ? *at : zero;
    }
    if constexpr (CPLX) {
      float re[8], im[8];
      const float sign = (flags & kConj) ? -1.f : 1.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        re[j] = x[j].x;
        im[j] = sign * x[j].y;
      }
      split_store(re, tile + off, tile + T + off);
      split_store(im, tile + 2 * T + off, tile + 3 * T + off);
    } else {
      split_store(x, tile + off, tile + T + off);
    }
    return;
  }
  const int pf = (CPLX || (flags & kPair)) ? 2 : 1;
  // [row][k]: the 16-byte chunk q of row r (rows of rb bytes, swizzled).
  auto chunk = [&](int q, int rb) { return raw + raw_chunk(r, q, rb); };
  // [k][row]: line k's values (R values of pf floats).
  auto line = [&](int k) {
    return reinterpret_cast<const float*>(raw) + k * R * pf;
  };
  if constexpr (!CPLX) {
    float v[8];
    if (!(flags & kPair)) {
      if (kmaj) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 x =
              *reinterpret_cast<const float4*>(chunk(2 * c + q, 64));
          v[4 * q] = x.x;
          v[4 * q + 1] = x.y;
          v[4 * q + 2] = x.z;
          v[4 * q + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = line(8 * c + j)[r];
      }
    } else {
      const bool im = flags & kPlane;
      if (kmaj) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 x =
              *reinterpret_cast<const float4*>(chunk(4 * c + q, 128));
          v[2 * q] = im ? x.y : x.x;
          v[2 * q + 1] = im ? x.w : x.z;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 x =
              *reinterpret_cast<const float2*>(line(8 * c + j) + 2 * r);
          v[j] = im ? x.y : x.x;
        }
      }
    }
    split_store(v, tile + off, tile + T + off);
  } else {
    float re[8], im[8];
    if (kmaj) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 x =
            *reinterpret_cast<const float4*>(chunk(4 * c + q, 128));
        re[2 * q] = x.x;
        im[2 * q] = x.y;
        re[2 * q + 1] = x.z;
        im[2 * q + 1] = x.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 x =
            *reinterpret_cast<const float2*>(line(8 * c + j) + 2 * r);
        re[j] = x.x;
        im[j] = x.y;
      }
    }
    if (flags & kConj) {
#pragma unroll
      for (int j = 0; j < 8; ++j) im[j] = -im[j];
    }
    split_store(re, tile + off, tile + T + off);
    split_store(im, tile + 2 * T + off, tile + 3 * T + off);
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_elem(void* s, const void* g, bool ok);
template <>
__device__ __forceinline__ void cp_elem<4>(void* s, const void* g, bool ok) {
  pauxy::cp_async4(s, g, ok);
}
template <>
__device__ __forceinline__ void cp_elem<8>(void* s, const void* g, bool ok) {
  pauxy::cp_async8(s, g, ok);
}

// Stages rows row0 .. row0 + R - 1, k0 .. k0 + kBK - 1 of an operand one
// element a copy (a layout TMA cannot read), zeros past its edges.
template <typename T, int R>
__device__ __forceinline__ void copy_slab(unsigned char* dst, const Operand& o,
                                          int row0, int k0, int K, int z,
                                          int pt) {
  constexpr int B = sizeof(T);
  const T* g = static_cast<const T*>(o.p) + z * o.s_b;
  const bool kmaj = o.flags & kKmaj;
#pragma unroll 2
  for (int e = pt; e < R * kBK; e += kProducers) {
    const int r = kmaj ? e / kBK : e % R;
    const int kk = kmaj ? e % kBK : e / R;
    const bool ok = row0 + r < o.rows && k0 + kk < K;
    const T* src = ok ? g + (row0 + r) * o.s_r + (k0 + kk) * o.s_k : g;
    // [row][k] as TMA would swizzle it, [k][row] as it is.
    const int at = kmaj ? raw_chunk(r, (kk * B) >> 4, kBK * B) + ((kk * B) & 15)
                        : (kk * R + r) * B;
    cp_elem<B>(dst + at, src, ok);
  }
}

// Stages the same slab (a layout TMA cannot read whose lines run at unit
// stride) one bulk copy a line: from the 16 bytes that hold the line's
// start to its last element in the operand. Returns the bytes the calling
// thread's copies bring (announced to the barrier by its warp). Rows past
// the operand are left as they are (they reach only results that are not
// stored); k past K is zeroed by the converter.
template <typename T, int R>
__device__ __forceinline__ uint32_t bulk_slab(unsigned char* dst,
                                              const Operand& o, int row0,
                                              int k0, int K, int z, int pt,
                                              uint64_t* bar) {
  constexpr int E = sizeof(T);
  const bool kmaj = o.flags & kKmaj;
  const int lines = kmaj ? R : kBK;
  const int pitch = rows_pitch(kmaj ? kBK : R, E);
  uint32_t total = 0;
  for (int i = pt; i < lines; i += kProducers) {
    if (kmaj ? row0 + i >= o.rows : k0 + i >= K) continue;
    const int valid = kmaj ? min(kBK, K - k0) : min(R, o.rows - row0);
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(line_start<T>(o, row0, k0, z, i));
    const uint32_t bytes = ((a & 15) + valid * E + 15) & ~15u;
    bulk_copy(dst + i * pitch, reinterpret_cast<const void*>(a & ~15ull),
              bytes, bar);
    total += bytes;
  }
  return total;
}

// Bytes a slab's TMA boxes bring (all of each box, zeros included).
__host__ __device__ __forceinline__ uint32_t tma_bytes(const Operand& o, int R,
                                                       int pf) {
  const int G = group_of(o.flags);
  if (G == 1) return R * kBK * 4 * pf;
  const bool kmaj = o.flags & kKmaj;
  return G * group_lines(o.flags, R) * rows_pitch(kmaj ? kBK : R, 4 * pf);
}

// Stages the same slab by one TMA box (zeros past the edges), or, over
// groups of G lines, by G boxes (one a member) of the flattened lines:
// member e's lines start (e line) values into their group, 16-byte aligned
// from (e line esz) mod 16 bytes before (TMA reads whole 16 bytes), so each
// box is a slab's lines at rows_pitch, every line from that offset on.
template <int R>
__device__ __forceinline__ void tma_slab(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, const Operand& o,
                                         int pf, int row0, int k0, int K,
                                         int z) {
  const bool kmaj = o.flags & kKmaj;
  const int c0 = pf * (kmaj ? k0 : row0);
  const int slow = kmaj ? row0 : k0;
  const int zb = (o.flags & kBcast) ? 0 : z;
  const int G = group_of(o.flags);
  if (G > 1) {
    const int l0 = zb * (kmaj ? o.rows : K) + slow;
    const int line = (int)(kmaj ? o.s_r : o.s_k);
    const int box = group_box_bytes(o.flags, R, 4 * pf);
    for (int e = 0; e < G; ++e) {
      const int at = (e * line * pf * 4) & ~15;   // bytes into the group
      tma_load(dst + e * box, map, bar, c0 + at / 4, l0 / G, 0);
    }
    return;
  }
  if (o.flags & kSwap) {
    tma_load(dst, map, bar, c0, zb, slow);
  } else {
    tma_load(dst, map, bar, c0, slow, zb);
  }
}

// A persistent block walks the tiles blockIdx.x, + gridDim.x, ... (tile t:
// D rows 128 (t % m_tiles) + [0, 128), columns BN (t / m_tiles % n_tiles) +
// [0, BN), matrix t / (m_tiles n_tiles)). Warpgroup 2 stages K slabs of A
// and B into a ring of p.stages, running ahead into the next tile while
// the consumers finish one; warpgroups 0 and 1 split each slab once into
// bf16 hi / lo tiles (a ring of kCvt) and run wgmma on their 64 rows.
// Slab g (counted over the block's tiles) uses stage g % p.stages and
// converted buffer g % kCvt.
template <bool CPLX, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_bf16x3_tile(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const TileArgs p) {
  using T = typename std::conditional<CPLX, float2, float>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((base + 1023) & ~1023u) - base);
  unsigned char* raw0 = smem;
  const int NS = p.stages;
  unsigned char* cvt0 = smem + NS * p.stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(cvt0 + kCvt * p.cvt_bytes);
  uint64_t* empty = full + kStages;
  const int kt = (p.k + kBK - 1) / kBK;
  const int mn_tiles = p.m_tiles * p.n_tiles;

  // A stage is full once each producer warp has arrived (with the bytes
  // of its TMA boxes and bulk copies to come) and, where an operand goes
  // by element copies, each producer thread's copies have landed.
  const bool elem_a = !(p.a.flags & (kTma | kRows));
  const bool elem_b = !(p.b.flags & (kTma | kRows));
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + i,
                kProducers / 32 + (elem_a || elem_b ? kProducers : 0));
      mbar_init(empty + i, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  GEMM3_STAMP_INIT

  if (threadIdx.x >= kConsumers) {
    // The producer warpgroup.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    const int pt = threadIdx.x - kConsumers;
    const bool tma_a = p.a.flags & kTma;
    const bool tma_b = p.b.flags & kTma;
    const int pf_a = (CPLX || (p.a.flags & kPair)) ? 2 : 1;
    const int pf_b = (CPLX || (p.b.flags & kPair)) ? 2 : 1;
    const uint32_t tx = (tma_a ? tma_bytes(p.a, kBM, pf_a) : 0) +
                        (tma_b ? tma_bytes(p.b, BN, pf_b) : 0);
    int g = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int z = tile / mn_tiles;
      const int row0 = tile % p.m_tiles * kBM;
      const int col0 = tile / p.m_tiles % p.n_tiles * BN;
      for (int s = 0; s < kt; ++s, ++g) {
        const int st = g % NS;
        if (g >= NS) mbar_wait(empty + st, ((g / NS) + 1) & 1);
        GEMM3_STAMP(0);
        unsigned char* raw = raw0 + st * p.stage_bytes;
        const int k0 = s * kBK;
        // The tx count may dip below zero where a copy lands before its
        // warp's arrival announces it; the stage completes only after all
        // four arrivals, with every byte counted.
        uint32_t bytes = 0;
        if (pt == 0) {
          if (tma_a)
            tma_slab<kBM>(raw, &map_a, full + st, p.a, pf_a, row0, k0, p.k,
                          z);
          if (tma_b)
            tma_slab<BN>(raw + p.a_bytes, &map_b, full + st, p.b, pf_b, col0,
                         k0, p.k, z);
          bytes = tx;
        }
        if (p.a.flags & kRows) {
          bytes += bulk_slab<T, kBM>(raw, p.a, row0, k0, p.k, z, pt,
                                     full + st);
        } else if (elem_a) {
          copy_slab<T, kBM>(raw, p.a, row0, k0, p.k, z, pt);
        }
        if (p.b.flags & kRows) {
          bytes += bulk_slab<T, BN>(raw + p.a_bytes, p.b, col0, k0, p.k, z,
                                    pt, full + st);
        } else if (elem_b) {
          copy_slab<T, BN>(raw + p.a_bytes, p.b, col0, k0, p.k, z, pt);
        }
        bytes = __reduce_add_sync(0xffffffffu, bytes);
        if ((pt & 31) == 0) mbar_expect_tx(full + st, bytes);
        if (elem_a || elem_b) mbar_arrive_cp_async(full + st);
        GEMM3_STAMP(1);
      }
    }
    GEMM3_STAMP_FLUSH(16);
    pauxy::cp_async_wait<0>();
    return;
  }

  // The consumer warpgroups.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");
  constexpr int NA = BN / 2;            // accumulators a thread a plane
  constexpr int TA = kBM * kRow;        // bytes of one A tile
  constexpr int TB = BN * kRow;         // bytes of one B tile
  constexpr int NPL = CPLX ? 2 : 1;
  const int t = threadIdx.x;
  const int wg = t >> 7;
  const int lane = t & 31;
  const int w = (t >> 5) & 3;
  const bool use_c = p.beta_re != 0.f || p.beta_im != 0.f;
  float acc[NA];
  float acc_im[CPLX ? NA : 1];
  int g = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int z = tile / mn_tiles;
    const int row0 = tile % p.m_tiles * kBM;
    const int col0 = tile / p.m_tiles % p.n_tiles * BN;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (CPLX ? NA : 1); ++i) acc_im[i] = 0.f;
    fence_acc(acc);
    fence_acc(acc_im);

    for (int s = 0; s < kt; ++s, ++g) {
      const int st = g % NS;
      mbar_wait(full + st, (g / NS) & 1);
      if (s == 0) {
        GEMM3_STAMP(8);
      } else {
        GEMM3_STAMP(0);
      }
      const unsigned char* raw = raw0 + st * p.stage_bytes;
      unsigned char* cvt = cvt0 + (g % kCvt) * p.cvt_bytes;
      unsigned char* tb = cvt + NPL * 2 * TA;
      convert<CPLX>(raw, cvt, kBM, p.a, row0, s * kBK, p.k, z, t);
#pragma unroll
      for (int u = t; u < 2 * BN; u += kConsumers)
        convert<CPLX>(raw + p.a_bytes, tb, BN, p.b, col0, s * kBK, p.k, z,
                      u);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
      GEMM3_STAMP(1);
      // The tiles, written through the generic proxy, are read by wgmma.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      GEMM3_STAMP(2);
      wgmma_fence();
      const unsigned char* ta = cvt + wg * 64 * kRow;
      if constexpr (!CPLX) {
        const uint64_t ah = desc(ta), al = desc(ta + TA);
        const uint64_t bh = desc(tb), bl = desc(tb + TB);
        // Cross terms first, then hi x hi.
        wgmma<BN, 1>(acc, ah, bl);
        wgmma<BN, 1>(acc, al, bh);
        wgmma<BN, 1>(acc, ah, bh);
      } else {
        const uint64_t arh = desc(ta), arl = desc(ta + TA);
        const uint64_t aih = desc(ta + 2 * TA), ail = desc(ta + 3 * TA);
        const uint64_t brh = desc(tb), brl = desc(tb + TB);
        const uint64_t bih = desc(tb + 2 * TB), bil = desc(tb + 3 * TB);
        // Re += Ar Br - Ai Bi: cross terms, then hi x hi.
        wgmma<BN, 1>(acc, arh, brl);
        wgmma<BN, 1>(acc, arl, brh);
        wgmma<BN, -1>(acc, aih, bil);
        wgmma<BN, -1>(acc, ail, bih);
        wgmma<BN, 1>(acc, arh, brh);
        wgmma<BN, -1>(acc, aih, bih);
        // Im += Ar Bi + Ai Br.
        wgmma<BN, 1>(acc_im, arh, bil);
        wgmma<BN, 1>(acc_im, arl, bih);
        wgmma<BN, 1>(acc_im, aih, brl);
        wgmma<BN, 1>(acc_im, ail, brh);
        wgmma<BN, 1>(acc_im, arh, bih);
        wgmma<BN, 1>(acc_im, aih, brh);
      }
      wgmma_commit();
      GEMM3_STAMP(3);
      // Slab g - 1's products are done: its tiles (kCvt = 3 back) are free
      // once every consumer has passed the next slab's barrier.
      wgmma_wait<1>();
      GEMM3_STAMP(4);
    }
    wgmma_wait<0>();
    GEMM3_STAMP(5);
    fence_acc(acc);
    fence_acc(acc_im);

    // Epilogue: alpha acc + beta C through D's strides, CW columns at a
    // time through the converted buffer no warpgroup reads now (the next
    // slab's, kCvt - 1 back): each warp writes its 16 rows (accumulators
    // 4 j + 2 h + e: row 16 w + lane / 4 + 8 h, column 8 j + 2 (lane % 4) +
    // e) to its share, rows of CW + PAD elements, then stores them a row
    // segment of 16 bytes a lane.
    {
      // CW + PAD = 8 or 24 (mod 32) words a row: a warp's writes miss no
      // bank; 8 warps' shares fit the buffer.
      constexpr int CW = BN <= 32 ? 8 : (!CPLX && BN == 256) ? 32 : 16;
      constexpr int PAD = CW == 8 ? 0 : 8;
      constexpr int V = 16 / sizeof(T);       // elements a 16-byte segment
      T* buf = reinterpret_cast<T*>(cvt0 + (g % kCvt) * p.cvt_bytes) +
               (wg * 4 + w) * 16 * (CW + PAD);
      T* d = static_cast<T*>(p.d) + z * p.sd_b;
      const T* c = use_c ? static_cast<const T*>(p.c) + z * p.sc_b : nullptr;
      const int r0 = row0 + wg * 64 + w * 16;
#pragma unroll
      for (int j0 = 0; j0 < BN; j0 += CW) {
#pragma unroll
        for (int j = j0 / 8; j < (j0 + CW) / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            T* o = buf + ((lane >> 2) + 8 * h) * (CW + PAD) + (j * 8 - j0) +
                   (lane & 3) * 2;
            const int q = 4 * j + 2 * h;
            if constexpr (CPLX) {
              *reinterpret_cast<float4*>(o) =
                  make_float4(acc[q], acc_im[q], acc[q + 1], acc_im[q + 1]);
            } else {
              *reinterpret_cast<float2*>(o) = make_float2(acc[q], acc[q + 1]);
            }
          }
        }
        __syncwarp();
        GEMM3_STAMP(6);
        // Lane: row i / (CW / V) of the warp's 16, segment i % (CW / V).
#pragma unroll
        for (int i = lane; i < 16 * CW / V; i += 32) {
          const int rr = i / (CW / V);
          const int cc = (i % (CW / V)) * V;
          const int r = r0 + rr;
          const int col = col0 + j0 + cc;
          if (r >= p.m || col >= p.n) continue;
          T v[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const T x = buf[rr * (CW + PAD) + cc + e];
            if constexpr (CPLX) {
              v[e] = make_float2(p.alpha_re * x.x - p.alpha_im * x.y,
                                 p.alpha_re * x.y + p.alpha_im * x.x);
              if (use_c && col + e < p.n) {
                const float2 cv = c[r * p.sc_m + (col + e) * p.sc_n];
                v[e].x += p.beta_re * cv.x - p.beta_im * cv.y;
                v[e].y += p.beta_re * cv.y + p.beta_im * cv.x;
              }
            } else {
              v[e] = p.alpha_re * x;
              if (use_c && col + e < p.n)
                v[e] += p.beta_re * c[r * p.sc_m + (col + e) * p.sc_n];
            }
          }
          T* o = d + r * p.sd_m + col * p.sd_n;
          if (p.vec_d && col + V <= p.n) {
            *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(v);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e)
              if (col + e < p.n) o[e * p.sd_n] = v[e];
          }
        }
        __syncwarp();
        GEMM3_STAMP(7);
      }
    }
    // The next tile's first slab converts into this buffer.
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    GEMM3_STAMP(9);
  }
  GEMM3_STAMP_FLUSH(0);
}

// ---- TMA maps --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

struct MapKey {
  const void* p;
  cuuint32_t rank;
  cuuint64_t dims[3];
  cuuint64_t strides[2];
  cuuint32_t box[3];
};

struct MapEntry {
  MapKey key;
  CUtensorMap map;
};

// Encoded maps by pointer, shape, strides and box: a host-bound path calls
// the same products again and again.
constexpr int kMapCache = 64;
MapEntry g_maps[kMapCache];
int g_maps_used = 0;
int g_maps_next = 0;
std::mutex g_maps_mu;

// The map of an operand staged by TMA: float32 elements (a complex value
// or a pair two), dims (fast, slow, batch) or, with kSwap, (fast, batch,
// slow); the box one slab of R rows.
int tensor_map(CUtensorMap* out, const Operand& o, int R, int k, int batch,
               bool cplx) {
  const int pf = (cplx || (o.flags & kPair)) ? 2 : 1;
  const cuuint64_t esz = cplx ? 8 : 4;
  const bool kmaj = o.flags & kKmaj;
  MapKey key;
  memset(&key, 0, sizeof key);
  key.p = o.p;
  const cuuint64_t fast = (cuuint64_t)(kmaj ? k : o.rows) * pf;
  const cuuint64_t slow = kmaj ? o.rows : k;
  const cuuint64_t s_slow = (cuuint64_t)(kmaj ? o.s_r : o.s_k) * esz;
  const cuuint64_t nb = (o.flags & kBcast) ? 1 : (cuuint64_t)batch;
  const cuuint64_t s_b = (cuuint64_t)o.s_b * esz;
  const cuuint32_t box0 = (kmaj ? kBK : R) * pf;
  const cuuint32_t box1 = kmaj ? R : kBK;
  const int G = group_of(o.flags);
  key.rank = 3;
  key.dims[0] = fast;
  if (G > 1) {
    // Groups of G lines of the flattened batch: a group's fast extent ends
    // at its last member's last value, so no box reads past the operand.
    const cuuint64_t line = (cuuint64_t)(kmaj ? o.s_r : o.s_k);
    key.dims[0] = ((G - 1) * line + (kmaj ? k : o.rows)) * pf;
    key.dims[1] = nb * slow / G;
    key.dims[2] = 1;
    key.strides[0] = G * line * esz;
    key.strides[1] = key.strides[0] * key.dims[1];
    key.box[0] = rows_pitch(kmaj ? kBK : R, (int)esz) / 4;
    key.box[1] = group_lines(o.flags, R);
    key.box[2] = 1;
  } else if (o.flags & kSwap) {
    key.dims[1] = nb;
    key.dims[2] = slow;
    key.strides[0] = s_b;
    key.strides[1] = s_slow;
    key.box[0] = box0;
    key.box[1] = 1;
    key.box[2] = box1;
  } else {
    key.dims[1] = slow;
    key.dims[2] = nb;
    key.strides[0] = s_slow;
    key.strides[1] = s_b;
    key.box[0] = box0;
    key.box[1] = box1;
    key.box[2] = 1;
  }
  std::lock_guard<std::mutex> lock(g_maps_mu);
  for (int i = 0; i < g_maps_used; ++i) {
    if (memcmp(&g_maps[i].key, &key, sizeof key) == 0) {
      *out = g_maps[i].map;
      return 0;
    }
  }
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t es[3] = {1, 1, 1};
  MapEntry& e = g_maps[g_maps_next];
  // [row][k] slabs swizzled as csrc raw_chunk reads them.
  const CUtensorMapSwizzle swizzle =
      (!kmaj || G > 1)
          ? CU_TENSOR_MAP_SWIZZLE_NONE
          : (pf == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  const CUresult r = fn(&e.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, key.rank,
                        const_cast<void*>(o.p), key.dims, key.strides,
                        key.box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    memset(&e, 0, sizeof e);
    return (int)cudaErrorInvalidValue;
  }
  e.key = key;
  *out = e.map;
  g_maps_next = (g_maps_next + 1) % kMapCache;
  if (g_maps_used < kMapCache) ++g_maps_used;
  return 0;
}

// Bytes of one operand's staged slab (R rows), a multiple of 1024.
template <bool CPLX>
int raw_bytes(const Operand& o, int R) {
  const int esz = CPLX ? 8 : 4;
  int bytes;
  if (o.flags & kRows) {
    bytes = (o.flags & kKmaj) ? R * rows_pitch(kBK, esz)
                              : kBK * rows_pitch(R, esz);
  } else if (group_of(o.flags) > 1) {
    bytes = group_of(o.flags) * group_box_bytes(o.flags, R, esz);
  } else {
    bytes = R * kBK * 4 * ((CPLX || (o.flags & kPair)) ? 2 : 1);
  }
  return (bytes + 1023) / 1024 * 1024;
}

template <bool CPLX, int BN>
int launch_tile(TileArgs p, int batch, cudaStream_t stream) {
  auto kern = gemm_bf16x3_tile<CPLX, BN>;
  p.a_bytes = raw_bytes<CPLX>(p.a, kBM);
  p.stage_bytes = (p.a_bytes + raw_bytes<CPLX>(p.b, BN) + 1023) / 1024 * 1024;
  p.cvt_bytes = (CPLX ? 4 : 2) * (kBM + BN) * kRow;
  // As many stages as fit (at least 3: float32 pairs on both sides at
  // BN = 256), at most kStages.
  const int fixed = kCvt * p.cvt_bytes + 2 * kStages * 8 + 1024;
  p.stages = (kSmemMax - fixed) / p.stage_bytes;
  if (p.stages > kStages) p.stages = kStages;
  if (p.stages < 3) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)p.stages * p.stage_bytes + fixed;
  p.vec_d = p.sd_n == 1 && p.sd_m % (CPLX ? 2 : 4) == 0 &&
            reinterpret_cast<uintptr_t>(p.d) % 16 == 0 &&
            (batch == 1 || p.sd_b % (CPLX ? 2 : 4) == 0);
  // The shared-memory opt-in once a device.
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof ma);
  memset(&mb, 0, sizeof mb);
  if (p.a.flags & kTma) {
    const int rc = tensor_map(&ma, p.a, kBM, p.k, batch, CPLX);
    if (rc) return rc;
  }
  if (p.b.flags & kTma) {
    const int rc = tensor_map(&mb, p.b, BN, p.k, batch, CPLX);
    if (rc) return rc;
  }
  // One persistent block an SM (the SM count read once a device).
  static int sms[64] = {};
  if (dev >= 64 || !sms[dev]) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) sms[0] = count;
    else sms[dev] = count;
  }
  p.m_tiles = (p.m + kBM - 1) / kBM;
  p.n_tiles = (p.n + BN - 1) / BN;
  const long long tiles = (long long)p.m_tiles * p.n_tiles * batch;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const int nsm = sms[dev < 64 ? dev : 0];
  const dim3 grid(p.tiles < nsm ? p.tiles : nsm);
  kern<<<grid, kThreads, smem, stream>>>(ma, mb, p);
  return (int)cudaGetLastError();
}

// ---- The skinny route -------------------------------------------------------

struct GemmArgs {
  const void* a;
  const void* b;
  const void* c;
  void* d;
  long long sa_b, sa_m, sa_k;
  long long sb_b, sb_k, sb_n;
  long long sc_b, sc_m, sc_n;
  long long sd_b, sd_m, sd_n;
  int m, n, k, batch;
  float alpha_re, alpha_im, beta_re, beta_im;
  int conj_a, conj_b;
};

// hi = bf16_rn(x), lo = bf16_rn(x - hi), as float32 values.
__device__ __forceinline__ void split1(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
}

// The skinny route, M <= kSkinny (a small N is a small M of the transposed
// product, ops/gemm3_cuda): a group of LANES threads a (batch, column)
// pair, the lanes splitting K, each lane's M partial sums in registers, a
// shuffle reduction, lane m % LANES writing row m. LANES = 32 (a warp a
// column) for long K; LANES = 1 (a thread a column) for K <= 32, where a
// warp's lanes would mostly idle. The pairs run with the batch or the
// columns fastest, whichever B's strides make contiguous (the UEG's
// einsum hands over [4913, 1, 7] x [4913, 7, 512] views with batch
// stride 1). The same products as the tiles (a_hi b_lo + a_lo b_hi +
// a_hi b_hi, each exact in float32) summed in float32 by FMAs: a tile of
// 128 rows would do 128 / M times the work here (the batched dot products
// [w, 1, K] x [w, K, 1] of the thermal force bias, the vector-matrix
// products of the energies).
constexpr int kSkinny = 8;
constexpr int kSkinnyThreads = 256;

template <bool CPLX, int LANES>
__global__ void __launch_bounds__(kSkinnyThreads)
    gemm_bf16x3_skinny(const GemmArgs p, bool batch_fast) {
  using T = typename std::conditional<CPLX, float2, float>::type;
  const long long pair =
      ((long long)blockIdx.x * kSkinnyThreads + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  if (pair >= (long long)p.batch * p.n) return;
  int z, col;
  if (batch_fast) {
    col = (int)(pair / p.batch);
    z = (int)(pair - (long long)col * p.batch);
  } else {
    z = (int)(pair / p.n);
    col = (int)(pair - (long long)z * p.n);
  }
  const T* a = static_cast<const T*>(p.a) + z * p.sa_b;
  const T* b = static_cast<const T*>(p.b) + z * p.sb_b + col * p.sb_n;
  float re[kSkinny], im[kSkinny];
#pragma unroll
  for (int m = 0; m < kSkinny; ++m) re[m] = im[m] = 0.f;
  const float sign_a = p.conj_a ? -1.f : 1.f;
  const float sign_b = p.conj_b ? -1.f : 1.f;
  for (int k = lane; k < p.k; k += LANES) {
    if constexpr (CPLX) {
      const float2 bv = b[k * p.sb_k];
      float brh, brl, bih, bil;
      split1(bv.x, brh, brl);
      split1(sign_b * bv.y, bih, bil);
#pragma unroll
      for (int m = 0; m < kSkinny; ++m) {
        if (m >= p.m) break;
        const float2 av = a[m * p.sa_m + k * p.sa_k];
        float arh, arl, aih, ail;
        split1(av.x, arh, arl);
        split1(sign_a * av.y, aih, ail);
        // Re += Ar Br - Ai Bi, Im += Ar Bi + Ai Br: cross terms first.
        re[m] = fmaf(arh, brl, re[m]);
        re[m] = fmaf(arl, brh, re[m]);
        re[m] = fmaf(-aih, bil, re[m]);
        re[m] = fmaf(-ail, bih, re[m]);
        re[m] = fmaf(arh, brh, re[m]);
        re[m] = fmaf(-aih, bih, re[m]);
        im[m] = fmaf(arh, bil, im[m]);
        im[m] = fmaf(arl, bih, im[m]);
        im[m] = fmaf(aih, brl, im[m]);
        im[m] = fmaf(ail, brh, im[m]);
        im[m] = fmaf(arh, bih, im[m]);
        im[m] = fmaf(aih, brh, im[m]);
      }
    } else {
      float bh, bl;
      split1(b[k * p.sb_k], bh, bl);
#pragma unroll
      for (int m = 0; m < kSkinny; ++m) {
        if (m >= p.m) break;
        float ah, al;
        split1(a[m * p.sa_m + k * p.sa_k], ah, al);
        re[m] = fmaf(ah, bl, re[m]);
        re[m] = fmaf(al, bh, re[m]);
        re[m] = fmaf(ah, bh, re[m]);
      }
    }
  }
  if (LANES > 1) {
#pragma unroll
    for (int m = 0; m < kSkinny; ++m) {
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        re[m] += __shfl_xor_sync(0xffffffffu, re[m], off);
        if (CPLX) im[m] += __shfl_xor_sync(0xffffffffu, im[m], off);
      }
    }
  }
  const bool use_c = p.beta_re != 0.f || p.beta_im != 0.f;
  T* d = static_cast<T*>(p.d) + z * p.sd_b + col * p.sd_n;
  const T* c = use_c ? static_cast<const T*>(p.c) + z * p.sc_b + col * p.sc_n
                     : nullptr;
#pragma unroll
  for (int m = 0; m < kSkinny; ++m) {
    if (m % LANES != lane || m >= p.m) continue;
    if constexpr (CPLX) {
      float2 v = make_float2(p.alpha_re * re[m] - p.alpha_im * im[m],
                             p.alpha_re * im[m] + p.alpha_im * re[m]);
      if (use_c) {
        const float2 cv = c[m * p.sc_m];
        v.x += p.beta_re * cv.x - p.beta_im * cv.y;
        v.y += p.beta_re * cv.y + p.beta_im * cv.x;
      }
      d[m * p.sd_m] = v;
    } else {
      float v = p.alpha_re * re[m];
      if (use_c) v += p.beta_re * c[m * p.sc_m];
      d[m * p.sd_m] = v;
    }
  }
}

// mode 1 + 2 (a thread a column, else a warp) + 1 (batch fastest).
template <bool CPLX>
int launch_skinny(const GemmArgs& p, int mode, cudaStream_t stream) {
  const bool thread = (mode - 1) & 2;
  const bool batch_fast = (mode - 1) & 1;
  const long long threads = (long long)p.batch * p.n * (thread ? 1 : 32);
  const dim3 grid((unsigned)((threads + kSkinnyThreads - 1) / kSkinnyThreads));
  if (thread) {
    gemm_bf16x3_skinny<CPLX, 1><<<grid, kSkinnyThreads, 0, stream>>>(
        p, batch_fast);
  } else {
    gemm_bf16x3_skinny<CPLX, 32><<<grid, kSkinnyThreads, 0, stream>>>(
        p, batch_fast);
  }
  return (int)cudaGetLastError();
}

template <bool CPLX>
int launch_gemm(const void* a, const void* b, const void* c, void* d,
                int batch, int m, int n, int k, long long sab, long long sam,
                long long sak, long long sbb, long long sbk, long long sbn,
                long long scb, long long scm, long long scn, long long sdb,
                long long sdm, long long sdn, float alpha_re, float alpha_im,
                float beta_re, float beta_im, int flags_a, int flags_b,
                int route, void* stream) {
  // route: 1 to 4 the skinny route's mode; 16, 32, 64 or 128 (float32)
  // the tile's columns.
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route >= 1 && route <= 4) {
    if (m > kSkinny) return (int)cudaErrorInvalidValue;
    const GemmArgs p{a,   b,   c,        d,        sab,     sam,
                     sak, sbb, sbk,      sbn,      scb,     scm,
                     scn, sdb, sdm,      sdn,      m,       n,
                     k,   batch, alpha_re, alpha_im, beta_re, beta_im,
                     (flags_a & kConj) != 0, (flags_b & kConj) != 0};
    return launch_skinny<CPLX>(p, route, st);
  }
  TileArgs p;
  memset(&p, 0, sizeof p);
  p.a = Operand{a, sab, sam, sak, m, flags_a};
  p.b = Operand{b, sbb, sbn, sbk, n, flags_b};
  p.c = c;
  p.d = d;
  p.sc_b = scb;
  p.sc_m = scm;
  p.sc_n = scn;
  p.sd_b = sdb;
  p.sd_m = sdm;
  p.sd_n = sdn;
  p.m = m;
  p.n = n;
  p.k = k;
  p.alpha_re = alpha_re;
  p.alpha_im = alpha_im;
  p.beta_re = beta_re;
  p.beta_im = beta_im;
  switch (route) {
    case 16: return launch_tile<CPLX, 16>(p, batch, st);
    case 32: return launch_tile<CPLX, 32>(p, batch, st);
    case 64: return launch_tile<CPLX, 64>(p, batch, st);
    case 128: return launch_tile<CPLX, 128>(p, batch, st);
    case 256:
      if (!CPLX) return launch_tile<false, 256>(p, batch, st);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define PAUXY_GEMM3_ARGS                                                     \
  const void *a, const void *b, const void *c, void *d, int batch, int m,    \
      int n, int k, long long sab, long long sam, long long sak,             \
      long long sbb, long long sbk, long long sbn, long long scb,            \
      long long scm, long long scn, long long sdb, long long sdm,            \
      long long sdn, float alpha_re, float alpha_im, float beta_re,          \
      float beta_im, int flags_a, int flags_b, int route, void *stream
#define PAUXY_GEMM3_PASS                                                    \
  a, b, c, d, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn, scb, scm, scn,  \
      sdb, sdm, sdn, alpha_re, alpha_im, beta_re, beta_im, flags_a,         \
      flags_b, route, stream

#ifdef PAUXY_GEMM3_STAMPS
extern "C" int prof_get(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_gemm3_prof, sizeof(g_gemm3_prof));
}
extern "C" int prof_zero() {
  unsigned long long z[32] = {};
  return (int)cudaMemcpyToSymbol(g_gemm3_prof, z, sizeof(z));
}
#endif

extern "C" int pauxy_gemm_bf16x3_f32(PAUXY_GEMM3_ARGS) {
  return launch_gemm<false>(PAUXY_GEMM3_PASS);
}

extern "C" int pauxy_gemm_bf16x3_c64(PAUXY_GEMM3_ARGS) {
  return launch_gemm<true>(PAUXY_GEMM3_PASS);
}
