// Fused Taylor exp(VHS)-apply, bf16 multiplicands with float32 sums:
// out_w = sum_{k <= order} VHS_w^k phi_w / k!.
//
// Replaces the bf16 branch (lowp=True) of the TPU kernel
// pauxy_tpu/ops/taylor_pallas.py:apply_taylor_pallas (kernel body
// _taylor_kernel, :56-66), the "pallas_bf16" tier of the plane-wave and
// Generic propagators. It computes what that branch computes: V's real and
// imaginary planes rounded once to bf16 (round to nearest even); at each
// order the term's float32 planes rounded to bf16, the four real products
// nr = Vr a - Vi b, ni = Vr b + Vi a accumulated in float32, scaled by 1/k
// in float32 and added to a float32 running sum; the sum written as
// complex64. Inputs vhs [w, M, M] and phi [w, M, C] complex64, walker-major
// and contiguous; output [w, M, C] complex64 (ops/taylor_cuda casts a
// complex128 caller's inputs and result, as JAX's pad0 does).
//
// What bounds it on the H100: at the UEG bench shape (M, C) = (257, 14),
// w = 512, the series is 6 x 8 M^2 C w = 2.3e10 FLOPs, 0.023 ms at the bf16
// tensor cores' 989 TFLOP/s, against 300 MB of V's planes and phi read once
// and the output written once: 0.090 ms at 3.35 TB/s. It is bound by
// bytes. V_w (257^2 x 8 bytes = 528 KB) does not fit a block's 227 KB of
// shared memory, so this design reads it once per order (6 x 270 MB at the
// bench shape, from L2 where it stays resident); keeping V on chip (a
// 2-CTA cluster holds it as bf16 pairs) is a later redesign.
//
// Design: one block per walker and column part (all C columns padded to
// 8, or an equal share where shared memory runs out: ops/taylor_cuda's
// plan_bf16). The products are warp-level tensor-core MMAs,
// mma.sync.m16n8k16 with bf16 operands and float32 accumulators, the
// arithmetic of this tier. M and the contraction are padded to 16, C to 8.
// The block's unit of work is a 16-row tile of the output and NT column
// tiles of 8; warps take units in turn, so each warp holds its units'
// accumulators in registers and no two warps share an output element.
// A warp reads its row tile of V straight from device memory in the A
// fragments' order (each value read by one warp only, so nothing is staged
// in shared memory), rounds it to bf16 in registers, and loads the next
// 16 columns while it multiplies the current ones. The term lives in
// shared memory as two bf16 planes, transposed ([column][row], a row of
// MP + 8 values so that the B fragments' 32-bit loads fall in 32 distinct
// banks), in two buffers: an order reads one and writes the other, one
// barrier an order. The running sum is two float32 planes in shared
// memory, each element updated only by the thread that computes it.
// -Vi is Vi with its sign bits flipped, exact in bf16.
//
// Budget: at most 16 warps a block; shared memory 8 cb (MP + 8) + 8 MP cb
// bytes (70.7 KB at (257, 14), three blocks an SM); the largest M is what
// one column tile fits in 227 KB (taylor_cuda.max_m_bf16: 1808).

#include <cuda_bf16.h>
#include <stdint.h>

#include "gauss_jordan.cuh"

namespace {

constexpr int kTile = 16;      // rows of a unit, and of a contraction step
constexpr int kCols = 8;       // columns of a column tile
constexpr int kSkew = 8;       // bf16 values after a term row's MP
constexpr int kMaxWarps = 16;

struct Bf16Layout {
  int mp, kp;
  __host__ __device__ Bf16Layout(int m) {
    mp = (m + kTile - 1) / kTile * kTile;
    kp = mp + kSkew;
  }
  // The term: [buffer][plane][cb][kp] bf16, then the sums [plane][mp][cb]
  // float32.
  __host__ __device__ size_t term_elems(int cb) const {
    return (size_t)4 * cb * kp;
  }
  __host__ __device__ size_t bytes(int cb) const {
    return term_elems(cb) * 2 + (size_t)2 * mp * cb * 4;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a b, a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The eight complex values of V a thread's A fragments take at contraction
// step k0: rows r0 and r0 + 8 (lane group g), columns k0 + 2t + {0, 1, 8,
// 9}; rows or columns past M read a clamped address and become zero.
__device__ __forceinline__ void load_a(float2 (&x)[8], const float2* v,
                                       int m, int r0, int k0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const float2* row = v + (size_t)min(r, m - 1) * m;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = k0 + 2 * t + (c & 1) + 8 * (c >> 1);
      const float2 z = __ldg(row + min(q, m - 1));
      const bool ok = r < m && q < m;
      x[h * 4 + c] = ok ? z : make_float2(0.f, 0.f);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    taylor_bf16_kernel(const float2* __restrict__ vhs,
                       const float2* __restrict__ phi,
                       float2* __restrict__ out, int m, int ncol, int order,
                       int cb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Bf16Layout lay(m);
  const int mp = lay.mp;
  const int kp = lay.kp;
  __nv_bfloat16* term = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* sums = reinterpret_cast<float*>(term + lay.term_elems(cb));
  const size_t plane = (size_t)cb * kp;          // one bf16 plane
  const size_t splane = (size_t)mp * cb;         // one float32 plane
  const size_t wk = blockIdx.x;
  const int c0 = blockIdx.y * cb;
  const float2* v = vhs + wk * m * (size_t)m;
  const float2* ph = phi + wk * m * (size_t)ncol;

  // The term (buffer 0) and the sum start as phi; padding is zero.
  for (int e = threadIdx.x; e < mp * cb; e += blockDim.x) {
    const int row = e / cb;
    const int col = e - row * cb;
    const int gc = c0 + col;
    const float2 z = (row < m && gc < ncol) ? ph[(size_t)row * ncol + gc]
                                            : make_float2(0.f, 0.f);
    sums[e] = z.x;
    sums[splane + e] = z.y;
    term[(size_t)col * kp + row] = __float2bfloat16_rn(z.x);
    term[plane + (size_t)col * kp + row] = __float2bfloat16_rn(z.y);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2;       // lane group: a fragment's row / column
  const int t = lane & 3;        // thread in group: its column pair
  const int groups = cb / kCols / NT;
  const int units = mp / kTile * groups;

  for (int k = 1; k <= order; ++k) {
    const __nv_bfloat16* tcur = term + (size_t)((k - 1) & 1) * 2 * plane;
    __nv_bfloat16* tnxt = term + (size_t)(k & 1) * 2 * plane;
    const float inv = 1.0f / (float)k;
    for (int u = warp; u < units; u += nwarps) {
      const int r0 = u / groups * kTile + g;
      const int ct0 = u % groups * NT;
      float accr[NT][4], acci[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) accr[j][i] = acci[j][i] = 0.f;
      }
      float2 cur[8], nxt[8];
      load_a(cur, v, m, r0, 0, t);
#pragma unroll 1
      for (int k0 = 0; k0 < mp; k0 += kTile) {
        if (k0 + kTile < mp) load_a(nxt, v, m, r0, k0 + kTile, t);
        // a0: row g, columns 2t, 2t+1; a1: row g+8; a2, a3: columns + 8.
        uint32_t ar[4], ai[4], an[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i & 1;
          const int c = (i >> 1) * 2;
          const float2 lo = cur[h * 4 + c];
          const float2 hi = cur[h * 4 + c + 1];
          ar[i] = pack_bf16(lo.x, hi.x);
          ai[i] = pack_bf16(lo.y, hi.y);
          an[i] = ai[i] ^ 0x80008000u;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = (ct0 + j) * kCols + g;
          const __nv_bfloat16* br = tcur + (size_t)n * kp + k0 + 2 * t;
          const __nv_bfloat16* bi = br + plane;
          const uint32_t br0 = *reinterpret_cast<const uint32_t*>(br);
          const uint32_t br1 = *reinterpret_cast<const uint32_t*>(br + 8);
          const uint32_t bi0 = *reinterpret_cast<const uint32_t*>(bi);
          const uint32_t bi1 = *reinterpret_cast<const uint32_t*>(bi + 8);
          mma_bf16(accr[j], ar, br0, br1);
          mma_bf16(accr[j], an, bi0, bi1);
          mma_bf16(acci[j], ai, br0, br1);
          mma_bf16(acci[j], ar, bi0, bi1);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) cur[i] = nxt[i];
      }
      // d0, d1: row g, columns 2t, 2t+1; d2, d3: row g + 8. Rows past M
      // are zero (their A rows were).
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + 8 * (i >> 1);
          const int col = (ct0 + j) * kCols + 2 * t + (i & 1);
          const float tr = accr[j][i] * inv;
          const float ti = acci[j][i] * inv;
          const size_t e = (size_t)row * cb + col;
          sums[e] += tr;
          sums[splane + e] += ti;
          tnxt[(size_t)col * kp + row] = __float2bfloat16_rn(tr);
          tnxt[plane + (size_t)col * kp + row] = __float2bfloat16_rn(ti);
        }
      }
    }
    // Every read of this order's term is done before the next order
    // writes it; this order's writes are visible to the next.
    __syncthreads();
  }

  for (int e = threadIdx.x; e < m * cb; e += blockDim.x) {
    const int row = e / cb;
    const int col = e - row * cb;
    const int gc = c0 + col;
    if (gc < ncol) {
      out[(wk * m + row) * (size_t)ncol + gc] =
          make_float2(sums[e], sums[splane + e]);
    }
  }
}

template <int NT>
int launch_bf16(const void* vhs, const void* phi, void* out, int w, int m,
                int ncol, int order, int cb, size_t bytes, int units,
                void* stream) {
  const int rounds = (units + kMaxWarps - 1) / kMaxWarps;
  const int warps = (units + rounds - 1) / rounds;
  cudaError_t err = pauxy::allow_smem(taylor_bf16_kernel<NT>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)w, (unsigned)((ncol + cb - 1) / cb));
  taylor_bf16_kernel<NT><<<grid, warps * 32, bytes, (cudaStream_t)stream>>>(
      static_cast<const float2*>(vhs), static_cast<const float2*>(phi),
      static_cast<float2*>(out), m, ncol, order, cb);
  return (int)cudaGetLastError();
}

}  // namespace

// cb: columns of a part (a multiple of 8), from ops/taylor_cuda.plan_bf16.
// NT, the column tiles of a unit, is the largest of 4, 3, 2, 1 that divides
// cb / 8.
extern "C" int pauxy_taylor_bf16(const void* vhs, const void* phi, void* out,
                                 int w, int m, int ncol, int order, int cb,
                                 void* stream) {
  if (w <= 0 || m <= 0 || ncol <= 0 || order < 0 || cb <= 0 ||
      cb % kCols != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Bf16Layout lay(m);
  const size_t bytes = lay.bytes(cb);
  const int parts = (ncol + cb - 1) / cb;
  if (bytes > pauxy::kSmemMax || parts > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int nct = cb / kCols;
  const int rows = lay.mp / kTile;
  if (nct % 4 == 0) {
    return launch_bf16<4>(vhs, phi, out, w, m, ncol, order, cb, bytes,
                          rows * (nct / 4), stream);
  }
  if (nct % 3 == 0) {
    return launch_bf16<3>(vhs, phi, out, w, m, ncol, order, cb, bytes,
                          rows * (nct / 3), stream);
  }
  if (nct % 2 == 0) {
    return launch_bf16<2>(vhs, phi, out, w, m, ncol, order, cb, bytes,
                          rows * (nct / 2), stream);
  }
  return launch_bf16<1>(vhs, phi, out, w, m, ncol, order, cb, bytes,
                        rows * nct, stream);
}
