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
// bytes, so V must cross from device memory once, as the TPU kernel's VMEM
// block does; V_w as bf16 planes (257^2 x 4 bytes = 264 KB) exceeds one
// block's 227 KB of shared memory, so a thread-block cluster holds it.
//
// Two routes, chosen by shape in ops/taylor_cuda.route_bf16 before any
// launch (the resident cap: M = 592 at C <= 8, 512 at C <= 16, 496 at
// C <= 24, 432 at C <= 32; C > 32 always streams):
//
// Resident (taylor_bf16_resident): a cluster of c CTAs a walker, c the
// smallest of 1, 2, 4, 8 whose share fits. CTA r of the cluster owns
// row tiles [r T, r T + T) of V (T = ceil(MP / 16 / c), a warp a tile,
// T <= 16) and reads them from device memory once: each warp reads its
// tile's rows as one contiguous span in 16-byte loads (a batch of eight a
// lane in flight while the previous batch is rounded and stored; a ragged
// 8-byte head and tail, since a row of M complex64 values starts on 16
// bytes only at even M or every other row), rounds each value to bf16
// once, and stores it in the CTA's slab, two bf16 planes [row][k] with
// rows of MP + 8 (ldmatrix.x4's eight row addresses fall in distinct
// 16-byte bank groups). Its first batch is in flight while the CTA stages
// phi, and each warp runs order 1 on its tile as soon as the tile has
// landed. Every CTA holds the whole term as two bf16 planes [column][row]
// (rows of MP + 8), double-buffered. At each order a warp computes its 16
// rows x all C columns with mma.sync m16n8k16 (bf16 operands, float32
// accumulators; A and B by ldmatrix from the slab and the term), scales
// them by 1/k, adds them to the running sum in its registers (a fixed
// tile-to-warp map, so the sum leaves the registers only at the end),
// rounds them to bf16, pairs rows through one shuffle so each store is 32
// bits, writes them into its own CTA's next buffer, and copies them to
// the other CTAs' in 16-byte stores through distributed shared memory
// (mapa + st.shared::cluster.v4). Then the CTA arrives at the cluster
// barrier (release) and passes its own barrier; the next order's products
// over the CTA's own rows of the term run before the cluster wait
// (acquire), the rest after it. The last order writes no term. -Vi is Vi
// with its sign bits flipped, exact in bf16. mma.sync rather than wgmma:
// wgmma's 64-row tiles would pad a CTA's 9 tiles of 16 rows to 3 x 64,
// past the shared memory a CTA has at M = 257.
//
// Budget (resident): shared memory 8 cb (MP + 8) + 64 T (MP + 8) bytes, cb
// = C padded to 8 (at most 32); at (257, 14): MP = 272, c = 2, T = 9:
// 35,840 + 161,280 = 197,120 of 232,448, so one CTA an SM and 1024 CTAs
// in 7.8 waves of 132; registers for 4 column tiles' accumulators and
// sums. What bounds it there (PERF.md, tools/kernel_stamps.py): a CTA's
// load runs at the card's memory rate while every SM loads, but its six
// orders of products (near mma.sync's rate), exchanges and barriers take
// about as long again, and no other CTA's load overlaps them on its SM.
//
// Streaming (taylor_bf16_kernel, past the resident cap up to M = 1808,
// ops/taylor_cuda.max_m_bf16, and for C > 32): one block per walker and
// column part (all C columns padded to 8, or an equal share where shared
// memory runs out: ops/taylor_cuda's plan_bf16). Units of a 16-row tile
// and NT column tiles of 8 go to warps in turn; a warp reads its row tile
// of V straight from device memory in the A fragments' order at every
// order (6 reads of V a call), rounds it to bf16 in registers, and loads
// the next 16 columns while it multiplies the current ones. The term lives
// in shared memory as two bf16 planes [column][row] (rows of MP + 8), in
// two buffers, one barrier an order; the running sum is two float32 planes
// in shared memory. At most 16 warps a block; shared memory 8 cb (MP + 8)
// + 8 MP cb bytes; the largest M is what one column tile fits (1808).

#include <cuda_bf16.h>
#include <stdint.h>

#include "gauss_jordan.cuh"

namespace {

constexpr int kTile = 16;      // rows of a unit, and of a contraction step
constexpr int kCols = 8;       // columns of a column tile
constexpr int kSkew = 8;       // bf16 values after a term row's MP
constexpr int kMaxWarps = 16;
constexpr int kMaxColTiles = 4;   // column tiles of the resident route
constexpr int kLoadUnroll = 8;    // 16-byte loads in flight a lane

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
  // The resident route: the term as above, then V's slab of `tiles` row
  // tiles, [plane][tiles * kTile][kp] bf16.
  __host__ __device__ size_t slab_elems(int tiles) const {
    return (size_t)tiles * kTile * kp;
  }
  __host__ __device__ size_t resident_bytes(int cb, int tiles) const {
    return (term_elems(cb) + 2 * slab_elems(tiles)) * 2;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a b, a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four (two) 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 give
// matrix i's row addresses (16 bytes each).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// The cluster: this CTA's rank, another CTA's address of a shared-memory
// location, a 32-bit store there, and the barrier's two halves.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(addr), "r"(rank));
  return d;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One complex value of V, element e of a span, rounded into the slab's
// planes (the span's ragged head and tail).
__device__ __forceinline__ void put_v(__nv_bfloat16* sr, __nv_bfloat16* si,
                                      int kp, int m, int e, float2 z) {
  const int row = e / m;
  const int col = e - row * m;
  sr[row * kp + col] = __float2bfloat16_rn(z.x);
  si[row * kp + col] = __float2bfloat16_rn(z.y);
}

// A warp's row tile of V: rows [r0, r0 + rows) of the walker's v (M x M
// complex64, row-major), one contiguous span of rows * M values, into
// slab rows [0, rows) of sr / si (rows of kp); the columns [M, MP) and the
// rows [rows, kTile) are zero. The span's 16-byte-aligned body goes in
// 16-byte loads, kLoadUnroll a lane a batch, the next batch issued before
// the current one is rounded and stored; an 8-byte head (a span starting
// at 8 mod 16) and tail are single loads. begin() issues the first batch
// (so the caller can overlap other loads with it), finish() the rest. A
// lane's chunks are 32 apart, so its slab position steps by 64 values.
struct TileLoader {
  const float4* body;
  int m, kp, nq, row, col;
  float4 x[kLoadUnroll];

  __device__ __forceinline__ void begin(const float2* __restrict__ v, int m_,
                                        int mp, int kp_, int r0, int rows,
                                        __nv_bfloat16* sr, __nv_bfloat16* si,
                                        int lane) {
    m = m_;
    kp = kp_;
    const float2* src = v + (size_t)r0 * m;
    const int n = rows * m;
    const int head = (reinterpret_cast<uintptr_t>(src) & 15) != 0 ? 1 : 0;
    nq = (n - head) / 2;
    body = reinterpret_cast<const float4*>(src + head);
    if (nq > 0) issue(x, 0, lane);
    row = (head + 2 * lane) / m;
    col = head + 2 * lane - row * m;
    if (lane == 0 && head) put_v(sr, si, kp, m, 0, __ldg(src));
    if (lane == 31 && head + 2 * nq < n) {
      put_v(sr, si, kp, m, n - 1, __ldg(src + n - 1));
    }
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int lr = 0; lr < kTile; ++lr) {
      for (int c = (lr < rows ? m : 0) + lane; c < mp; c += 32) {
        sr[lr * kp + c] = zero;
        si[lr * kp + c] = zero;
      }
    }
  }

  __device__ __forceinline__ void issue(float4 (&y)[kLoadUnroll], int q0,
                                        int lane) const {
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      y[u] = __ldg(body + min(q0 + u * 32 + lane, nq - 1));
    }
  }

  // One batch's values, rounded and stored; the lane's slab position
  // steps on past it.
  __device__ __forceinline__ void store(const float4 (&x)[kLoadUnroll],
                                        int q0, __nv_bfloat16* sr,
                                        __nv_bfloat16* si, int lane) {
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      if (q0 + u * 32 + lane < nq) {
        const int at = row * kp + col;
        // The chunk's second value: the next column, or the next row's
        // first.
        const int at1 = col + 1 < m ? at + 1 : at - col + kp;
        sr[at] = __float2bfloat16_rn(x[u].x);
        si[at] = __float2bfloat16_rn(x[u].y);
        sr[at1] = __float2bfloat16_rn(x[u].z);
        si[at1] = __float2bfloat16_rn(x[u].w);
      }
      col += 64;
      while (col >= m) {
        col -= m;
        ++row;
      }
    }
  }

  // The rest of the span: two batches take turns, one in flight while the
  // other is stored (a register copy of a batch would wait for it to land).
  __device__ __forceinline__ void finish(__nv_bfloat16* sr, __nv_bfloat16* si,
                                         int lane) {
    constexpr int kBatch = 32 * kLoadUnroll;
    float4 y[kLoadUnroll];
    for (int q0 = 0; q0 < nq; q0 += 2 * kBatch) {
      if (q0 + kBatch < nq) issue(y, q0 + kBatch, lane);
      store(x, q0, sr, si, lane);
      if (q0 + 2 * kBatch < nq) issue(x, q0 + 2 * kBatch, lane);
      if (q0 + kBatch < nq) store(y, q0 + kBatch, sr, si, lane);
    }
  }
};

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// A column tile's accumulator fragment (d0, d1: row g, columns 2t, 2t+1;
// d2, d3: row g + 8) as two bf16 pairs of rows of one column, through lane
// g ^ 1: an even g gets column 2t at rows g, g + 1 (lo) and g + 8, g + 9
// (hi), an odd g column 2t + 1 at rows g - 1, g and g + 7, g + 8.
__device__ __forceinline__ void pair_rows(const float (&d)[4], bool even,
                                          uint32_t& lo, uint32_t& hi) {
  const float q0 = __shfl_xor_sync(0xffffffffu, even ? d[1] : d[0], 4);
  const float q1 = __shfl_xor_sync(0xffffffffu, even ? d[3] : d[2], 4);
  lo = even ? pack_bf16(d[0], q0) : pack_bf16(q0, d[1]);
  hi = even ? pack_bf16(d[2], q1) : pack_bf16(q1, d[3]);
}

// A contraction step's fragments: A's two planes (a 16 x 16 tile each)
// and B's (the term's 16 x 8 column tiles, two to an ldmatrix.x4).
template <int NT>
struct StepFrags {
  uint32_t ar[4], ai[4];
  uint32_t br[(NT + 1) / 2][4], bi[(NT + 1) / 2][4];

  __device__ __forceinline__ void load(uint32_t a_r, uint32_t a_i,
                                       uint32_t b_r, uint32_t b_i, int kp,
                                       int k0) {
    ldsm_x4(ar, a_r + 2 * k0);
    ldsm_x4(ai, a_i + 2 * k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const uint32_t off = 2 * (j * kCols * kp + k0);
      if (j + 1 < NT) {
        ldsm_x4(br[j / 2], b_r + off);
        ldsm_x4(bi[j / 2], b_i + off);
      } else {
        ldsm_x2(br[j / 2], b_r + off);
        ldsm_x2(bi[j / 2], b_i + off);
      }
    }
  }

  // acc{r,i}[j] += (Vr + i Vi)(Br + i Bi) for column tile j; -Vi is Vi
  // with its sign bits flipped.
  __device__ __forceinline__ void mma(float (&accr)[NT][4],
                                      float (&acci)[NT][4]) const {
    uint32_t an[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) an[i] = ai[i] ^ 0x80008000u;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int h = j / 2;
      const int o = 2 * (j & 1);
      mma_bf16(accr[j], ar, br[h][o], br[h][o + 1]);
      mma_bf16(acci[j], ai, br[h][o], br[h][o + 1]);
      mma_bf16(accr[j], an, bi[h][o], bi[h][o + 1]);
      mma_bf16(acci[j], ar, bi[h][o], bi[h][o + 1]);
    }
  }
};

// Part of an order's products for a warp's unit: acc{r,i}[j] (16 rows x
// column tile j) += the slab's 16 rows times the current term, over the
// contraction's rows [kb, ke). a_r / a_i: this lane's ldmatrix address in
// the slab's planes at k = 0; b_r / b_i: in the term buffer's planes.
template <int NT>
__device__ __forceinline__ void resident_products(float (&accr)[NT][4],
                                                  float (&acci)[NT][4],
                                                  uint32_t a_r, uint32_t a_i,
                                                  uint32_t b_r, uint32_t b_i,
                                                  int kp, int kb, int ke) {
#pragma unroll 2
  for (int k0 = kb; k0 < ke; k0 += kTile) {
    StepFrags<NT> f;
    f.load(a_r, a_i, b_r, b_i, kp, k0);
    f.mma(accr, acci);
  }
}

// The resident route: grid w * c CTAs, clusters of c along x, T warps a
// CTA (one row tile each), NT = C padded to 8, over 8.
template <int NT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    taylor_bf16_resident(const float2* __restrict__ vhs,
                         const float2* __restrict__ phi,
                         float2* __restrict__ out, int m, int ncol, int order,
                         int c, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int cb = NT * kCols;
  const Bf16Layout lay(m);
  const int mp = lay.mp;
  const int kp = lay.kp;
  __nv_bfloat16* term = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* slab = term + lay.term_elems(cb);
  const size_t plane = (size_t)cb * kp;          // one term plane
  const size_t splane = lay.slab_elems(tiles);   // one slab plane
  const int rank = (int)cluster_rank();
  const size_t wk = blockIdx.x / c;
  const float2* v = vhs + wk * m * (size_t)m;
  const float2* ph = phi + wk * m * (size_t)ncol;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;       // lane group: a fragment's row / column
  const int t = lane & 3;        // thread in group: its column pair
  const int r0 = (rank * tiles + warp) * kTile;   // this warp's row tile
  const bool active = r0 < mp;

  // This CTA has started: the others may write its term once they have
  // passed the matching wait.
  cluster_arrive_relaxed();

  // V: this warp's row tile, read once, into the slab; its first batch of
  // loads is in flight while phi is read.
  __nv_bfloat16* sr = slab + (size_t)warp * kTile * kp;
  __nv_bfloat16* si = sr + splane;
  TileLoader vl;
  if (active) vl.begin(v, m, mp, kp, r0, min(kTile, m - r0), sr, si, lane);

  // The running sum starts as phi, in the accumulators' layout: d0, d1 row
  // g, columns 2t, 2t+1; d2, d3 row g + 8.
  float sumr[NT][4], sumi[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i >> 1);
      const int col = j * kCols + 2 * t + (i & 1);
      const float2 z = (active && row < m && col < ncol)
                           ? ph[(size_t)row * ncol + col]
                           : make_float2(0.f, 0.f);
      sumr[j][i] = z.x;
      sumi[j][i] = z.y;
    }
  }
  // The term (buffer 0) starts as phi, rounded; padding is zero. The loads
  // go in batches of kLoadUnroll a thread, all issued before any is used.
  for (int e0 = threadIdx.x; e0 < mp * cb; e0 += kLoadUnroll * blockDim.x) {
    float2 z[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int e = e0 + u * blockDim.x;
      const int row = e / cb;
      const int col = e - row * cb;
      const bool ok = row < m && col < ncol;
      const float2 y = __ldg(ph + (ok ? (size_t)row * ncol + col : 0));
      z[u] = ok ? y : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int e = e0 + u * blockDim.x;
      const int row = e / cb;
      const int col = e - row * cb;
      if (e < mp * cb) {
        term[(size_t)col * kp + row] = __float2bfloat16_rn(z[u].x);
        term[plane + (size_t)col * kp + row] = __float2bfloat16_rn(z[u].y);
      }
    }
  }
  __syncthreads();
  if (active) vl.finish(sr, si, lane);
  __syncwarp();

  const uint32_t a_r =
      smem_u32(sr + (lane & 15) * kp + (lane >> 4) * 8);
  const uint32_t a_i = a_r + 2 * (uint32_t)splane;
  const uint32_t b_lane = 2 * (uint32_t)(((lane & 7) + ((lane >> 4) << 3)) *
                                             kp + ((lane >> 3) & 1) * 8);
  const uint32_t term0 = smem_u32(term);
  // The contraction's rows this CTA's warps compute ([kb, ke), in its own
  // term buffers before any cluster barrier) and the others'.
  const int kb = min(rank * tiles * kTile, mp);
  const int ke = min((rank + 1) * tiles * kTile, mp);
  for (int k = 1; k <= order; ++k) {
    const uint32_t tcur = term0 + 2 * (uint32_t)(((k - 1) & 1) * 2 * plane);
    const uint32_t tnxt = term0 + 2 * (uint32_t)((k & 1) * 2 * plane);
    const uint32_t b_r = tcur + b_lane;
    const uint32_t b_i = b_r + 2 * (uint32_t)plane;
    float tr[NT][4], ti[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) tr[j][i] = ti[j][i] = 0.f;
    }
    // From the second order on, this CTA's own rows of the term are in
    // place after its own barrier, the others' after the cluster's: the
    // products over the own rows run while the cluster barrier completes.
    if (active) {
      if (k == 1 || c == 1) {
        resident_products<NT>(tr, ti, a_r, a_i, b_r, b_i, kp, 0, mp);
      } else {
        resident_products<NT>(tr, ti, a_r, a_i, b_r, b_i, kp, kb, ke);
      }
    }
    if (k > 1 && c > 1) {
      cluster_wait();
      if (active) {
        resident_products<NT>(tr, ti, a_r, a_i, b_r, b_i, kp, 0, kb);
        resident_products<NT>(tr, ti, a_r, a_i, b_r, b_i, kp, ke, mp);
      }
    }
    if (active) {
      const float inv = 1.0f / (float)k;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tr[j][i] *= inv;
          ti[j][i] *= inv;
          sumr[j][i] += tr[j][i];
          sumi[j][i] += ti[j][i];
        }
      }
    }
    // Every CTA of the cluster has started (the first order only).
    if (k == 1) cluster_wait();
    if (k == order) break;
    if (active) {
      // Each 32-bit store is two rows of one column (pair_rows), into this
      // CTA's next buffer; then the warp's rows go to the other CTAs in
      // 16-byte copies (a column's 16 rows are 32 contiguous bytes).
      const bool even = (g & 1) == 0;
      const int col0 = 2 * t + (g & 1);
      const int row0 = r0 + (g & ~1);
      const uint32_t pl = 2 * (uint32_t)plane;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t word[4];
        pair_rows(tr[j], even, word[0], word[1]);
        pair_rows(ti[j], even, word[2], word[3]);
        const uint32_t at =
            tnxt + 2 * (uint32_t)((j * kCols + col0) * kp + row0);
        st_shared(at, word[0]);
        st_shared(at + 16, word[1]);
        st_shared(at + pl, word[2]);
        st_shared(at + pl + 16, word[3]);
      }
      if (c > 1) {
        __syncwarp();
        // Chunk q: plane q / (2 cb), column (q / 2) % cb, half q % 2.
#pragma unroll
        for (int q = lane; q < 4 * cb; q += 32) {
          const uint32_t at = tnxt + (uint32_t)(q / (2 * cb)) * pl +
                              2 * (uint32_t)(((q / 2) % cb) * kp + r0) +
                              16 * (q & 1);
          const uint4 z = ld_shared_v4(at);
          for (int dst = 1; dst < c; ++dst) {
            st_cluster_v4(map_rank(at, (rank + dst) % c), z);
          }
        }
      }
    }
    // This order's term is in every CTA before any reads it, and every
    // read of the previous one is done before the next order overwrites it:
    // this CTA's arrival releases its writes (the wait is at the next
    // order's products), and its own barrier makes its own rows visible to
    // its warps.
    if (c > 1) cluster_arrive();
    __syncthreads();
  }
  if (order == 0) cluster_wait();

  if (active) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i >> 1);
        const int col = j * kCols + 2 * t + (i & 1);
        if (row < m && col < ncol) {
          out[(wk * m + row) * (size_t)ncol + col] =
              make_float2(sumr[j][i], sumi[j][i]);
        }
      }
    }
  }
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

template <int NT>
int launch_resident(const void* vhs, const void* phi, void* out, int w, int m,
                    int ncol, int order, int c, int tiles, size_t bytes,
                    void* stream) {
  cudaError_t err = pauxy::allow_smem(taylor_bf16_resident<NT>, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)w * (unsigned)c);
  cfg.blockDim = dim3((unsigned)tiles * 32);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, taylor_bf16_resident<NT>,
                           static_cast<const float2*>(vhs),
                           static_cast<const float2*>(phi),
                           static_cast<float2*>(out), m, ncol, order, c,
                           tiles);
  if (err != cudaSuccess) return (int)err;
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

// The resident route (ops/taylor_cuda.route_bf16): c CTAs a walker in a
// cluster (1, 2, 4 or 8), `tiles` row tiles of 16 a CTA (a warp each, at
// most 16, c * tiles covering M), C <= 32 columns in one part.
extern "C" int pauxy_taylor_bf16_resident(const void* vhs, const void* phi,
                                          void* out, int w, int m, int ncol,
                                          int order, int cluster, int tiles,
                                          void* stream) {
  const Bf16Layout lay(m);
  const int nct = (ncol + kCols - 1) / kCols;
  if (w <= 0 || m <= 0 || ncol <= 0 || order < 0 || nct > kMaxColTiles ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      tiles <= 0 || tiles > kMaxWarps ||
      (size_t)tiles * cluster * kTile < (size_t)lay.mp ||
      (size_t)w * cluster > 0x7fffffffu) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = lay.resident_bytes(nct * kCols, tiles);
  if (bytes > pauxy::kSmemMax) return (int)cudaErrorInvalidValue;
  switch (nct) {
    case 1:
      return launch_resident<1>(vhs, phi, out, w, m, ncol, order, cluster,
                                tiles, bytes, stream);
    case 2:
      return launch_resident<2>(vhs, phi, out, w, m, ncol, order, cluster,
                                tiles, bytes, stream);
    case 3:
      return launch_resident<3>(vhs, phi, out, w, m, ncol, order, cluster,
                                tiles, bytes, stream);
    default:
      return launch_resident<4>(vhs, phi, out, w, m, ncol, order, cluster,
                                tiles, bytes, stream);
  }
}
