// Fused Taylor exp(VHS)-apply: out_w = sum_{k <= order} VHS_w^k phi_w / k!.
//
// Replaces the TPU kernel pauxy_tpu/ops/taylor_pallas.py:apply_taylor_pallas
// (kernel body _taylor_kernel), the Generic phaseless step's propagator
// (pauxy_tpu/propagation/generic.py:144-161). Inputs vhs [w, M, M] and
// phi [w, M, C] complex, walker-major and contiguous (C = na + nb, both spins'
// columns side by side); output [w, M, C]. Each order is a complex
// [M, M] x [M, C] product of the walker's VHS with the current term, the
// term scaled by 1/k.
//
// What bounds it on the H100: at the Generic bench shape (M, C) = (128, 32),
// w = 1024, the series is 6 x 8 M^2 C w = 2.6e10 FLOPs against 0.2 GB of
// HBM traffic: 0.38 ms at 67 TFLOP/s (float32 outside the tensor cores);
// past the supermatrix cap, (228, 84) w = 256, 5.4e10 FLOPs: 0.80 ms. Both
// are FLOP-bound, so the design is about keeping the FP32 pipes fed.
//
// Design: one block per walker and column part (a part is all C columns
// where the thread and shared-memory budgets allow, else an equal share,
// chosen by ops/taylor_cuda.plan). The block's term [MP, CB] and running
// sum stay in shared memory for the whole series, so VHS_w is streamed from
// L2 once per order and not once per column chunk, and no register holds
// the sum. VHS moves in slabs of KS columns ([MP][KSP] row-major, rows
// padded to KSP so that neighbouring rows fall in other banks) through a
// ring of two stages filled by cp.async: the next slab's copy overlaps
// this slab's multiply-adds; the ring runs on across the orders (VHS is
// the same matrix each order), one barrier per slab. Each thread owns a
// TM x TN = 4 x 4 register tile of the product: rows rg, rg + RG, ..., and
// columns in 16-byte pieces spread so that the threads of a warp read
// neighbouring words of the term's row and few distinct VHS rows; per
// pair of slab columns a complex64 thread issues TM 16-byte loads of VHS
// and 2 TN / 2 of the term for 2 TM TN complex multiply-adds, so every
// loaded value feeds at least 4 of them. After the order's last
// slab a barrier, then each thread scales its tile by 1/k, adds it to its
// sums and writes it as the new term. M is padded only to TM (rows) and KS
// (the contraction), C to TN. complex64 runs on the FP32 pipes (no TF32);
// complex128 in double on the FP64 pipes.
//
// What the tiles are sized for: an SM issues 128 FFMA a clock but moves
// 128 bytes a clock from shared memory to registers, and a block's barrier
// stalls every warp, so the kernel needs many warps spread evenly over the
// SM's four schedulers more than it needs large register tiles. At
// (228, 84) a part of 44 columns is 57 x 11 = 627 threads, 20 warps (five
// a scheduler); 8 x 4 tiles in 10 warps (three on two schedulers, two on
// the others) and 16 x 4 or 8 x 8 tiles in 6 warps were slower on the card.
//
// Budget: TM x TN = 4 x 4; float KS = 16, KSP = 18, at most 640 threads a
// block (at most 102 registers a thread); double KS = 8, KSP = 9, at most
// 320 threads (168 registers); ptxas's report sits beside the library as
// .log. Shared memory (TR + MP) CB + 2 MP KSP complex values,
// TR = max(MP, M padded to KS): (228, 84) is two parts of 44 columns,
// 225 KB, one block an SM; (128, 32) is one part of 256 threads, 100 KB,
// two blocks an SM. The largest M is what one column group and the ring
// fit in 227 KB (taylor_cuda.max_m: 656 complex64, 556 complex128); the
// Generic propagator sends larger M to the plain series by shape. The
// bf16 multiplicand option of the TPU kernel (lowp) is not ported.

#include "async_copy.cuh"
#include "gauss_jordan.cuh"

using pauxy::cplx;

constexpr int kTaylorStages = 2;

template <typename T>
struct TaylorTile;
template <>
struct TaylorTile<float> {
  static constexpr int TM = 4;          // rows a thread owns
  static constexpr int TN = 4;          // columns a thread owns
  static constexpr int KS = 16;         // VHS columns a slab holds
  static constexpr int KSP = 18;        // a slab row's stride
  static constexpr int THREADS = 640;   // at most, a block
};
template <>
struct TaylorTile<double> {
  static constexpr int TM = 4;
  static constexpr int TN = 4;
  static constexpr int KS = 8;
  static constexpr int KSP = 9;
  static constexpr int THREADS = 320;
};

// Sixteen bytes of complex values, the unit of a shared-memory load.
template <typename T>
struct alignas(16) Vec16 {
  static constexpr int N = 16 / sizeof(cplx<T>);
  cplx<T> v[N];
};

template <typename T>
__device__ __forceinline__ void cmac(cplx<T>& acc, const cplx<T>& a,
                                     const cplx<T>& b) {
  acc.re = fma(a.re, b.re, acc.re);
  acc.re = fma(-a.im, b.im, acc.re);
  acc.im = fma(a.re, b.im, acc.im);
  acc.im = fma(a.im, b.re, acc.im);
}

// Shared-memory layout of one block, in complex values: the term
// [TR][cb], the running sum [MP][cb], the VHS ring [NS][MP][KSP].
template <typename T>
struct TaylorLayout {
  int rg, mp, ns, tr;
  __host__ __device__ TaylorLayout(int m) {
    rg = (m + TaylorTile<T>::TM - 1) / TaylorTile<T>::TM;
    mp = rg * TaylorTile<T>::TM;
    ns = (m + TaylorTile<T>::KS - 1) / TaylorTile<T>::KS;
    tr = ns * TaylorTile<T>::KS > mp ? ns * TaylorTile<T>::KS : mp;
  }
  __host__ __device__ size_t sum_offset(int cb) const {
    return (size_t)tr * cb;
  }
  __host__ __device__ size_t ring_offset(int cb) const {
    return sum_offset(cb) + (size_t)mp * cb;
  }
  __host__ __device__ size_t elems(int cb) const {
    return ring_offset(cb) +
           (size_t)kTaylorStages * mp * TaylorTile<T>::KSP;
  }
};

// Copies slab s of VHS_w (columns s KS ... s KS + KS - 1, all MP rows) into
// a ring stage; out-of-range rows and columns become zeros. PER complex
// values a copy: 16 bytes, or one complex64 value where VHS rows do not
// start on 16 bytes (odd M).
template <typename T, int PER>
__device__ __forceinline__ void taylor_slab(cplx<T>* stage,
                                            const cplx<T>* v, int m, int mp,
                                            int s) {
  constexpr int KS = TaylorTile<T>::KS;
  constexpr int KSP = TaylorTile<T>::KSP;
  constexpr int CPR = KS / PER;
  const int q0 = s * KS;
  for (int e = threadIdx.x; e < mp * CPR; e += blockDim.x) {
    const int p = e / CPR;
    const int qo = (e - p * CPR) * PER;
    const bool ok = p < m && q0 + qo < m;
    const cplx<T>* src = ok ? v + (size_t)p * m + q0 + qo : v;
    cplx<T>* dst = stage + p * KSP + qo;
    if (PER * sizeof(cplx<T>) == 16) {
      pauxy::cp_async16(dst, src, ok);
    } else {
      pauxy::cp_async8(dst, src, ok);
    }
  }
}

template <typename T, int PER>
__global__ void __launch_bounds__(TaylorTile<T>::THREADS, 1)
    taylor_kernel(const cplx<T>* __restrict__ vhs,
                  const cplx<T>* __restrict__ phi, cplx<T>* __restrict__ out,
                  int m, int ncol, int order, int cb) {
  constexpr int TM = TaylorTile<T>::TM;
  constexpr int TN = TaylorTile<T>::TN;
  constexpr int KS = TaylorTile<T>::KS;
  constexpr int KSP = TaylorTile<T>::KSP;
  constexpr int NS = kTaylorStages;
  constexpr int VR = Vec16<T>::N;    // complex values a 16-byte load holds
  constexpr int NCH = TN / VR;       // 16-byte pieces of a thread's row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TaylorLayout<T> lay(m);
  const int RG = lay.rg;
  const int mp = lay.mp;
  const int ns = lay.ns;
  cplx<T>* term = reinterpret_cast<cplx<T>*>(smem_raw);
  cplx<T>* sums = term + lay.sum_offset(cb);
  cplx<T>* ring = term + lay.ring_offset(cb);
  const int t = threadIdx.x;
  const int ncg = cb / TN;
  const int cg = t % ncg;
  const int rg = t / ncg;
  const bool active = rg < RG;
  const size_t wk = blockIdx.x;
  const int c0 = blockIdx.y * cb;
  const cplx<T>* v = vhs + wk * m * (size_t)m;
  const cplx<T>* ph = phi + wk * m * (size_t)ncol;
  const int total = order * ns;

  // Start the ring before the term's load, so both are in flight at once.
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {
    if (g < total) {
      taylor_slab<T, PER>(ring + (size_t)g * mp * KSP, v, m, mp, g % ns);
    }
    pauxy::cp_async_commit();
  }
  cplx<T> zero;
  zero.re = T(0);
  zero.im = T(0);
  for (int e = t; e < lay.tr * cb; e += blockDim.x) {
    const int q = e / cb;
    const int col = c0 + e - q * cb;
    const cplx<T> z =
        (q < m && col < ncol) ? ph[(size_t)q * ncol + col] : zero;
    term[e] = z;
    if (q < mp) sums[e] = z;
  }

  // Column of piece u, value i of this thread; row of its j-th row.
  auto col_of = [&](int u, int i) { return (u * ncg + cg) * VR + i; };
  auto row_of = [&](int j) { return rg + j * RG; };
  cplx<T> acc[TM][TN];
#pragma unroll
  for (int j = 0; j < TM; ++j) {
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[j][c] = zero;
  }

  for (int g = 0; g < total; ++g) {
    pauxy::cp_async_wait<NS - 2>();
    // Slab g has arrived for every thread; every read of the stage that
    // the next copy overwrites (slab g - NS + 1's) is done; at g = 0 the
    // term is in place.
    __syncthreads();
    if (g + NS - 1 < total) {
      taylor_slab<T, PER>(ring + (size_t)((g + NS - 1) % NS) * mp * KSP, v,
                          m, mp, (g + NS - 1) % ns);
    }
    pauxy::cp_async_commit();
    const int s = g % ns;
    if (active) {
      const cplx<T>* stage = ring + (size_t)(g % NS) * mp * KSP;
      const cplx<T>* trow = term + (size_t)s * KS * cb;
#pragma unroll
      for (int qq = 0; qq < KS; qq += VR) {
        cplx<T> a[TM][VR];
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const Vec16<T> x = *reinterpret_cast<const Vec16<T>*>(
              stage + row_of(j) * KSP + qq);
#pragma unroll
          for (int i = 0; i < VR; ++i) a[j][i] = x.v[i];
        }
#pragma unroll
        for (int i = 0; i < VR; ++i) {
          cplx<T> b[TN];
#pragma unroll
          for (int u = 0; u < NCH; ++u) {
            const Vec16<T> y = *reinterpret_cast<const Vec16<T>*>(
                trow + (qq + i) * cb + col_of(u, 0));
#pragma unroll
            for (int r = 0; r < VR; ++r) b[u * VR + r] = y.v[r];
          }
#pragma unroll
          for (int j = 0; j < TM; ++j) {
#pragma unroll
            for (int c = 0; c < TN; ++c) cmac(acc[j][c], a[j][i], b[c]);
          }
        }
      }
    }
    if (s == ns - 1) {
      // The order is complete: every read of its term is done before the
      // new term replaces it; the next slab's barrier orders the writes
      // before their reads. Each thread updates only its own sums.
      __syncthreads();
      if (active) {
        const T inv = T(1) / T(g / ns + 1);
#pragma unroll
        for (int j = 0; j < TM; ++j) {
#pragma unroll
          for (int u = 0; u < NCH; ++u) {
#pragma unroll
            for (int i = 0; i < VR; ++i) {
              cplx<T>& z = acc[j][u * VR + i];
              const int e = row_of(j) * cb + col_of(u, i);
              z.re *= inv;
              z.im *= inv;
              sums[e].re += z.re;
              sums[e].im += z.im;
              term[e] = z;
              z = zero;
            }
          }
        }
      }
    }
  }
  pauxy::cp_async_wait<0>();
  // With order 0 the sums were written by other threads.
  __syncthreads();

  if (!active) return;
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int p = row_of(j);
    if (p >= m) continue;
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
#pragma unroll
      for (int i = 0; i < VR; ++i) {
        const int col = c0 + col_of(u, i);
        if (col < ncol) {
          out[(wk * m + p) * (size_t)ncol + col] =
              sums[p * cb + col_of(u, i)];
        }
      }
    }
  }
}

template <typename T, int PER>
static int launch_taylor_per(const void* vhs, const void* phi, void* out,
                             int w, int m, int ncol, int order, int cb,
                             void* stream) {
  constexpr int TN = TaylorTile<T>::TN;
  const TaylorLayout<T> lay(m);
  const int threads = (lay.rg * (cb / TN) + 31) / 32 * 32;
  const size_t bytes = lay.elems(cb) * sizeof(cplx<T>);
  const int parts = (ncol + cb - 1) / cb;
  if (threads > TaylorTile<T>::THREADS || bytes > pauxy::kSmemMax ||
      parts > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = pauxy::allow_smem(taylor_kernel<T, PER>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)w, (unsigned)parts);
  taylor_kernel<T, PER><<<grid, threads, bytes, (cudaStream_t)stream>>>(
      static_cast<const cplx<T>*>(vhs), static_cast<const cplx<T>*>(phi),
      static_cast<cplx<T>*>(out), m, ncol, order, cb);
  return (int)cudaGetLastError();
}

// cb: columns of a part (a multiple of TN), from ops/taylor_cuda.plan;
// vec: VHS rows start on 16 bytes (complex64 with even M, 16-byte aligned;
// complex128 always).
template <typename T>
static int launch_taylor(const void* vhs, const void* phi, void* out, int w,
                         int m, int ncol, int order, int cb, int vec,
                         void* stream) {
  constexpr int TN = TaylorTile<T>::TN;
  if (w <= 0 || m <= 0 || ncol <= 0 || order < 0 || cb <= 0 ||
      cb % TN != 0 || (vec && sizeof(cplx<T>) == 8 && m % 2 != 0) ||
      (!vec && sizeof(cplx<T>) == 16)) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec) {
    return launch_taylor_per<T, Vec16<T>::N>(vhs, phi, out, w, m, ncol,
                                             order, cb, stream);
  }
  return launch_taylor_per<T, 1>(vhs, phi, out, w, m, ncol, order, cb,
                                 stream);
}

extern "C" int pauxy_taylor_c64(const void* vhs, const void* phi, void* out,
                                int w, int m, int ncol, int order, int cb,
                                int vec, void* stream) {
  return launch_taylor<float>(vhs, phi, out, w, m, ncol, order, cb, vec,
                              stream);
}

extern "C" int pauxy_taylor_c128(const void* vhs, const void* phi, void* out,
                                 int w, int m, int ncol, int order, int cb,
                                 int vec, void* stream) {
  return launch_taylor<double>(vhs, phi, out, w, m, ncol, order, cb, vec,
                               stream);
}
