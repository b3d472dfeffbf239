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
// products: 0.208 ms). Measured there (chip_smoke.py phase 35, H100 80GB
// HBM3 at 700 W): 0.306 ms of device float32 (cuBLAS's IEEE float32 0.363,
// its TF32 0.086) and 0.794 complex64 (1.327, 0.458), 5.9x and 3.8x the
// bound: each warp splitting what it reads, and mma.sync's rate, hold it.
//
// Design (simple first; wgmma, TMA and a persistent schedule are later
// work): a block of 4 warps owns a 64 x 64 tile of D, each warp 32 x 32
// (2 x 4 mma.sync m16n8k16 tiles, bf16 x bf16 -> float32). K runs in slabs
// of 32: A's and B's float32 (or complex64) slabs are staged in shared
// memory by cp.async in a ring (3 stages float32, 2 complex64), any strides
// (einsum hands over transposed and permuted views, so nothing is copied
// to contiguous first): the tile is stored with the operand's smaller
// stride along the threads, [row][k] (rows of 40) when that is K's, else
// [k][row] (rows of 68 floats or 66 complex; both paddings keep a warp's
// fragment reads on distinct banks), in 16-byte copies when that stride is
// 1 and the addresses allow, else one element a copy; a ragged edge is
// zero-filled. Fragments are read as float32 from shared memory and split
// into hi / lo bf16 pairs in registers; for each mma tile the two cross
// terms go in before hi x hi. Conjugated operands (torch's lazy conj) are
// read in place with the imaginary plane negated. The batch is
// blockIdx.z, with batch strides (0 broadcasts). The epilogue writes
// alpha acc + beta C (C read only when beta != 0) through D's strides.
// A product with at most 8 rows (or, transposed by the wrapper, columns)
// takes the skinny route below instead: a tile would spend 64 / M of its
// work on padding (on the H100 the thermal force bias's batched dot
// products [3840, 1, 8649] x [3840, 8649, 1] took 13.9 ms in tiles against
// cuBLAS's 0.25).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kTile = 64;     // rows and columns of D a block
constexpr int kSlab = 32;     // depth of a K slab
constexpr int kThreads = 128; // 4 warps, 2 x 2 over the tile
constexpr int kLdK = 40;      // [row][k] stage: row pitch in elements

template <bool CPLX>
struct Elem;
template <>
struct Elem<false> {
  using T = float;
  static constexpr int kLdR = 68;  // [k][row] stage: k pitch in elements
  static constexpr int kStages = 3;
};
template <>
struct Elem<true> {
  using T = float2;
  static constexpr int kLdR = 66;
  static constexpr int kStages = 2;
};

// Elements of one operand's stage: the larger of the two layouts.
constexpr int kStageElems = kTile * kLdK;
static_assert(kSlab * 68 <= kStageElems, "stage too small");

template <bool CPLX>
constexpr size_t smem_bytes() {
  return (size_t)Elem<CPLX>::kStages * 2 * kStageElems *
         sizeof(typename Elem<CPLX>::T);
}

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
  int conj_a, conj_b, vec_a, vec_b;
};

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

// Stage one operand's slab: rows row0 .. row0 + 63 of the operand (M for
// A, N for B; nrow valid), k0 .. k0 + 31 (nk valid). KMAJ: s[r kLdK + kk],
// K's stride along the threads; else s[kk LDR + r], the rows' stride along
// the threads. vec: that stride is 1 and every 16-byte piece is aligned.
template <typename T, bool KMAJ, int LDR>
__device__ __forceinline__ void load_slab(T* s, const T* g, long long s_row,
                                          long long s_k, int row0, int nrow,
                                          int k0, int nk, bool vec) {
  constexpr int F = KMAJ ? kSlab : kTile;  // extent along the threads
  constexpr int S = KMAJ ? kTile : kSlab;
  constexpr int LD = KMAJ ? kLdK : LDR;
  const long long s_fast = KMAJ ? s_k : s_row;
  const long long s_slow = KMAJ ? s_row : s_k;
  const int f0 = KMAJ ? k0 : row0;
  const int nf = KMAJ ? nk : nrow;
  const int sl0 = KMAJ ? row0 : k0;
  const int ns = KMAJ ? nrow : nk;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < F * S / V / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int f = (e % (F / V)) * V;
      const int sl = e / (F / V);
      int cnt = nf - (f0 + f);
      cnt = cnt < 0 ? 0 : (cnt > V ? V : cnt);
      if (sl0 + sl >= ns) cnt = 0;
      const T* src = cnt > 0 ? g + (sl0 + sl) * s_slow + (f0 + f) : g;
      pauxy::cp_async16_n(s + sl * LD + f, src, cnt * (int)sizeof(T));
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < F * S / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int f = e % F;
      const int sl = e / F;
      const bool ok = f0 + f < nf && sl0 + sl < ns;
      const T* src = ok ? g + (sl0 + sl) * s_slow + (f0 + f) * s_fast : g;
      cp_elem<sizeof(T)>(s + sl * LD + f, src, ok);
    }
  }
}

// The pair (k, k + 1) of row r of a staged slab.
template <bool KMAJ, int LDR>
__device__ __forceinline__ float2 pair_real(const float* s, int r, int k) {
  if (KMAJ) return *reinterpret_cast<const float2*>(s + r * kLdK + k);
  return make_float2(s[k * LDR + r], s[(k + 1) * LDR + r]);
}

// (re_k, im_k, re_k+1, im_k+1) of row r of a staged complex slab.
template <bool KMAJ, int LDR>
__device__ __forceinline__ float4 pair_cplx(const float2* s, int r, int k) {
  if (KMAJ) return *reinterpret_cast<const float4*>(s + r * kLdK + k);
  const float2 x0 = s[k * LDR + r];
  const float2 x1 = s[(k + 1) * LDR + r];
  return make_float4(x0.x, x0.y, x1.x, x1.y);
}

// hi = bf16_rn(x), lo = bf16_rn(x - hi) of a pair, x0 in the low half
// (x - hi is exact in float32).
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Both halves of a bf16 pair negated (sign bits flipped: exact).
__device__ __forceinline__ unsigned neg2(unsigned x) { return x ^ 0x80008000u; }

// d += a b, a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 float32.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void neg4(unsigned (&o)[4], const unsigned (&a)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = neg2(a[q]);
}

// One 16-deep step (k offset kk in the slab) of the warp's 32 x 32 tile,
// float32: acc[i][j] += A_i B_j in three passes.
template <bool AK, bool BK>
__device__ __forceinline__ void step_real(float (&acc)[2][4][4],
                                          const float* sa, const float* sb,
                                          int wr, int wc, int kk) {
  constexpr int LDR = Elem<false>::kLdR;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  unsigned ahi[2][4], alo[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 x = pair_real<AK, LDR>(sa, wr + i * 16 + g + (q & 1) * 8,
                                          kk + 2 * t + (q >> 1) * 8);
      split2(x.x, x.y, ahi[i][q], alo[i][q]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned bhi[2], blo[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float2 x = pair_real<BK, LDR>(sb, wc + j * 8 + g, kk + 2 * t + q * 8);
      split2(x.x, x.y, bhi[q], blo[q]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma(acc[i][j], ahi[i], blo[0], blo[1]);
      mma(acc[i][j], alo[i], bhi[0], bhi[1]);
      mma(acc[i][j], ahi[i], bhi[0], bhi[1]);
    }
  }
}

// The same for complex64: re / im accumulators, four real products of
// three passes each, conjugated operands negated in the imaginary plane.
template <bool AK, bool BK>
__device__ __forceinline__ void step_cplx(float (&re)[2][4][4],
                                          float (&im)[2][4][4],
                                          const float2* sa, const float2* sb,
                                          int wr, int wc, int kk,
                                          float sign_a, float sign_b) {
  constexpr int LDR = Elem<true>::kLdR;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  unsigned arh[2][4], arl[2][4], aih[2][4], ail[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x = pair_cplx<AK, LDR>(sa, wr + i * 16 + g + (q & 1) * 8,
                                          kk + 2 * t + (q >> 1) * 8);
      split2(x.x, x.z, arh[i][q], arl[i][q]);
      split2(sign_a * x.y, sign_a * x.w, aih[i][q], ail[i][q]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned brh[2], brl[2], bih[2], bil[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 x = pair_cplx<BK, LDR>(sb, wc + j * 8 + g, kk + 2 * t + q * 8);
      split2(x.x, x.z, brh[q], brl[q]);
      split2(sign_b * x.y, sign_b * x.w, bih[q], bil[q]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      unsigned nih[4], nil[4];
      neg4(nih, aih[i]);
      neg4(nil, ail[i]);
      // Re += Ar Br - Ai Bi: cross terms, then hi x hi.
      mma(re[i][j], arh[i], brl[0], brl[1]);
      mma(re[i][j], arl[i], brh[0], brh[1]);
      mma(re[i][j], nih, bil[0], bil[1]);
      mma(re[i][j], nil, bih[0], bih[1]);
      mma(re[i][j], arh[i], brh[0], brh[1]);
      mma(re[i][j], nih, bih[0], bih[1]);
      // Im += Ar Bi + Ai Br.
      mma(im[i][j], arh[i], bil[0], bil[1]);
      mma(im[i][j], arl[i], bih[0], bih[1]);
      mma(im[i][j], aih[i], brl[0], brl[1]);
      mma(im[i][j], ail[i], brh[0], brh[1]);
      mma(im[i][j], arh[i], bih[0], bih[1]);
      mma(im[i][j], aih[i], brh[0], brh[1]);
    }
  }
}

template <bool CPLX, bool AK, bool BK>
__global__ void __launch_bounds__(kThreads)
    gemm_bf16x3_kernel(const GemmArgs p) {
  using T = typename Elem<CPLX>::T;
  constexpr int NS = Elem<CPLX>::kStages;
  constexpr int LDR = Elem<CPLX>::kLdR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int z = blockIdx.z;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const T* a = static_cast<const T*>(p.a) + z * p.sa_b;
  const T* b = static_cast<const T*>(p.b) + z * p.sb_b;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32;
  const int wc = (warp & 1) * 32;
  const bool vec_a = p.vec_a != 0;
  const bool vec_b = p.vec_b != 0;
  const int nm = p.m - m0;
  const int nn = p.n - n0;
  const T* ga = a + m0 * p.sa_m;
  const T* gb = b + n0 * p.sb_n;
  const int kt = (p.k + kSlab - 1) / kSlab;

  auto stage_a = [&](int s) { return smem + (2 * s) * kStageElems; };
  auto stage_b = [&](int s) { return smem + (2 * s + 1) * kStageElems; };
  auto load = [&](int s, int slab) {
    const int k0 = slab * kSlab;
    load_slab<T, AK, LDR>(stage_a(s), ga, p.sa_m, p.sa_k, 0, nm, k0, p.k,
                          vec_a);
    load_slab<T, BK, LDR>(stage_b(s), gb, p.sb_n, p.sb_k, 0, nn, k0, p.k,
                          vec_b);
  };

  // acc: the real product, or the real plane; acc_im: the imaginary plane
  // (unused, and dropped by the compiler, for float32).
  float acc[2][4][4];
  float acc_im[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] = 0.f;
        acc_im[i][j][q] = 0.f;
      }
  const float sign_a = p.conj_a ? -1.f : 1.f;
  const float sign_b = p.conj_b ? -1.f : 1.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < kt) load(s, s);
    pauxy::cp_async_commit();
  }
  for (int slab = 0; slab < kt; ++slab) {
    pauxy::cp_async_wait<NS - 2>();
    __syncthreads();
    const int next = slab + NS - 1;
    if (next < kt) load(next % NS, next);
    pauxy::cp_async_commit();
    const int s = slab % NS;
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 16) {
      if constexpr (CPLX) {
        step_cplx<AK, BK>(acc, acc_im, stage_a(s), stage_b(s), wr, wc, kk,
                          sign_a, sign_b);
      } else {
        step_real<AK, BK>(acc, stage_a(s), stage_b(s), wr, wc, kk);
      }
    }
  }
  pauxy::cp_async_wait<0>();

  // Epilogue: alpha acc + beta C through D's strides.
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const bool use_c = p.beta_re != 0.f || p.beta_im != 0.f;
  T* d = static_cast<T*>(p.d) + z * p.sd_b;
  const T* c = use_c ? static_cast<const T*>(p.c) + z * p.sc_b : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + wr + i * 16 + g + (q >> 1) * 8;
        const int col = n0 + wc + j * 8 + 2 * t + (q & 1);
        if (r >= p.m || col >= p.n) continue;
        if constexpr (CPLX) {
          const float xr = acc[i][j][q];
          const float xi = acc_im[i][j][q];
          float2 v = make_float2(p.alpha_re * xr - p.alpha_im * xi,
                                 p.alpha_re * xi + p.alpha_im * xr);
          if (use_c) {
            const float2 cv = c[r * p.sc_m + col * p.sc_n];
            v.x += p.beta_re * cv.x - p.beta_im * cv.y;
            v.y += p.beta_re * cv.y + p.beta_im * cv.x;
          }
          d[r * p.sd_m + col * p.sd_n] = v;
        } else {
          float v = p.alpha_re * acc[i][j][q];
          if (use_c) v += p.beta_re * c[r * p.sc_m + col * p.sc_n];
          d[r * p.sd_m + col * p.sd_n] = v;
        }
      }
    }
  }
}

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
// stride 1). The same products as the tile kernel (a_hi b_lo + a_lo b_hi
// + a_hi b_hi, each exact in float32) summed in float32 by FMAs: a 64 x 64
// tile would do 64 / M times the work here (the batched dot products
// [w, 1, K] x [w, K, 1] of the thermal force bias, the vector-matrix
// products of the energies).
constexpr int kSkinny = 8;
constexpr int kSkinnyThreads = 256;

template <bool CPLX, int LANES>
__global__ void __launch_bounds__(kSkinnyThreads)
    gemm_bf16x3_skinny(const GemmArgs p, bool batch_fast) {
  using T = typename Elem<CPLX>::T;
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

template <bool CPLX, bool AK, bool BK>
int launch_one(const GemmArgs& p, int batch, cudaStream_t stream) {
  auto kern = gemm_bf16x3_kernel<CPLX, AK, BK>;
  const size_t smem = smem_bytes<CPLX>();
  // The shared-memory opt-in once a device (the host's share of a launch
  // matters on the host-bound lattice paths).
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  const dim3 grid((p.n + kTile - 1) / kTile, (p.m + kTile - 1) / kTile, batch);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool CPLX>
int launch_gemm(const void* a, const void* b, const void* c, void* d,
                int batch, int m, int n, int k, long long sab, long long sam,
                long long sak, long long sbb, long long sbk, long long sbn,
                long long scb, long long scm, long long scn, long long sdb,
                long long sdm, long long sdn, float alpha_re, float alpha_im,
                float beta_re, float beta_im, int conj_a, int conj_b,
                int a_kmaj, int b_kmaj, int vec_a, int vec_b, int skinny,
                void* stream) {
  // skinny: 0 the tiles, else launch_skinny's mode.
  const GemmArgs p{a,        b,       c,       d,       sab,    sam,
                   sak,      sbb,     sbk,     sbn,     scb,    scm,
                   scn,      sdb,     sdm,     sdn,     m,      n,
                   k,        batch,   alpha_re, alpha_im, beta_re, beta_im,
                   conj_a,   conj_b,  vec_a,   vec_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (skinny) {
    if (m > kSkinny || skinny > 4) return (int)cudaErrorInvalidValue;
    return launch_skinny<CPLX>(p, skinny, st);
  }
  if (a_kmaj && b_kmaj) return launch_one<CPLX, true, true>(p, batch, st);
  if (a_kmaj) return launch_one<CPLX, true, false>(p, batch, st);
  if (b_kmaj) return launch_one<CPLX, false, true>(p, batch, st);
  return launch_one<CPLX, false, false>(p, batch, st);
}

}  // namespace

#define PAUXY_GEMM3_ARGS                                                     \
  const void *a, const void *b, const void *c, void *d, int batch, int m,    \
      int n, int k, long long sab, long long sam, long long sak,             \
      long long sbb, long long sbk, long long sbn, long long scb,            \
      long long scm, long long scn, long long sdb, long long sdm,            \
      long long sdn, float alpha_re, float alpha_im, float beta_re,          \
      float beta_im, int conj_a, int conj_b, int a_kmaj, int b_kmaj,         \
      int vec_a, int vec_b, int skinny, void *stream
#define PAUXY_GEMM3_PASS                                                    \
  a, b, c, d, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn, scb, scm, scn,  \
      sdb, sdm, sdn, alpha_re, alpha_im, beta_re, beta_im, conj_a, conj_b,  \
      a_kmaj, b_kmaj, vec_a, vec_b, skinny, stream

extern "C" int pauxy_gemm_bf16x3_f32(PAUXY_GEMM3_ARGS) {
  return launch_gemm<false>(PAUXY_GEMM3_PASS);
}

extern "C" int pauxy_gemm_bf16x3_c64(PAUXY_GEMM3_ARGS) {
  return launch_gemm<true>(PAUXY_GEMM3_PASS);
}
