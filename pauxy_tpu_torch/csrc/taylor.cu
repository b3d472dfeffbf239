// Fused Taylor exp(VHS)-apply: out_w = sum_{k <= order} VHS_w^k phi_w / k!.
//
// Replaces the TPU kernel pauxy_tpu/ops/taylor_pallas.py:apply_taylor_pallas
// (kernel body _taylor_kernel), the Generic phaseless step's propagator
// (pauxy_tpu/propagation/generic.py:144-161). Inputs vhs [w, M, M] and
// phi [w, M, C] complex, walker-major and contiguous (C = na + nb, both spins'
// columns side by side); output [w, M, C]. The series is column-independent,
// so the work splits into (walker, column chunk) blocks.
//
// Design, per block (one walker, a chunk of CW columns): the current term
// T [MP, CW] lives in shared memory ([row][col], M padded with zero rows to
// MP, a multiple of K and of QT); thread (c, r) owns column c of the chunk
// and the K consecutive rows r K, ..., r K + K - 1. Each order streams
// VHS_w through shared memory in [MP, QT] column tiles, each loaded once by
// the whole block with coalesced reads (VHS_w stays in L2 across the
// orders); the threads of a warp share r and span the columns, so every
// VHS read from shared memory is a broadcast and every T read and write is
// conflict-free. The new term goes to registers, then a barrier, then
// shared memory; the running sum stays in registers. So VHS is read once
// per order from L2 and once from HBM per column chunk, not once per order
// from HBM as in the XLA loop (taylor_pallas.py:1-11). Zero padding keeps
// the inner loop free of bounds checks: padded rows and columns stay zero.
//
// What bounds it on the H100: at the Generic bench shape (M, C) = (128, 32),
// w = 1024, complex64, the series is 6 x 8 M^2 C w = 2.6e10 FLOPs against
// 0.2 GB of HBM traffic: 0.39 ms at 67 TFLOP/s (float32 outside the tensor
// cores), FLOP-bound. This kernel issues K + 1 shared loads per 4K FMAs, so
// shared-memory issue bounds it below that; wgmma tiles are later work.
//
// float and double are both instantiated (K = 8 rows by CW = 32 columns,
// and K = 4 by CW = 16, so a 1024-thread block stays within 64 registers
// and M <= 256); the TPU kernel always computed in float32, here complex128
// is computed in double. The bf16 multiplicand option of the TPU kernel
// (lowp) is not ported.

#include "gauss_jordan.cuh"

using pauxy::cplx;

constexpr int kTaylorThreads = 1024;

// Rows a thread owns, columns a chunk holds, and columns of a VHS tile.
template <typename T>
struct TaylorTile;
template <>
struct TaylorTile<float> {
  static constexpr int K = 8;
  static constexpr int CW = 32;
  static constexpr int QT = 32;
};
template <>
struct TaylorTile<double> {
  static constexpr int K = 4;
  static constexpr int CW = 16;
  static constexpr int QT = 16;
};

// M padded to a multiple of the row group and of the VHS tile width.
template <typename T>
__host__ __device__ inline int taylor_mp(int m) {
  constexpr int step = TaylorTile<T>::QT > TaylorTile<T>::K
                           ? TaylorTile<T>::QT
                           : TaylorTile<T>::K;
  return (m + step - 1) / step * step;
}

template <typename T, int K, int CW, int QT>
__global__ void __launch_bounds__(kTaylorThreads)
    taylor_kernel(const cplx<T>* __restrict__ vhs,
                  const cplx<T>* __restrict__ phi, cplx<T>* __restrict__ out,
                  int m, int ncol, int order) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mp = taylor_mp<T>(m);
  cplx<T>* term = reinterpret_cast<cplx<T>*>(smem_raw);  // [MP][CW]
  cplx<T>* vt = term + (size_t)mp * CW;                   // [MP][QT]
  const size_t wk = blockIdx.x;
  const int c0 = blockIdx.y * CW;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int c = t % CW;
  const int p0 = (t / CW) * K;
  const cplx<T>* v = vhs + wk * m * (size_t)m;
  const cplx<T>* ph = phi + wk * m * (size_t)ncol;
  cplx<T> zero;
  zero.re = T(0);
  zero.im = T(0);

  for (int e = t; e < mp * CW; e += nt) {
    const int q = e / CW;
    const int col = c0 + e % CW;
    term[e] = (q < m && col < ncol) ? ph[(size_t)q * ncol + col] : zero;
  }
  __syncthreads();

  T sr[K], si[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const cplx<T> z = term[(p0 + j) * CW + c];
    sr[j] = z.re;
    si[j] = z.im;
  }

  for (int k = 1; k <= order; ++k) {
    T ar[K], ai[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ar[j] = T(0);
      ai[j] = T(0);
    }
    for (int q0 = 0; q0 < mp; q0 += QT) {
      // Orders the last tile's reads (and, at q0 = 0, the last order's
      // term writes) before this tile's load.
      __syncthreads();
      for (int e = t; e < mp * QT; e += nt) {
        const int p = e / QT;
        const int q = q0 + e % QT;
        vt[e] = (p < m && q < m) ? v[(size_t)p * m + q] : zero;
      }
      __syncthreads();
      const cplx<T>* vrow = vt + p0 * QT;
      const cplx<T>* tcol = term + q0 * CW + c;
#pragma unroll 4
      for (int q = 0; q < QT; ++q) {
        const cplx<T> b = tcol[q * CW];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const cplx<T> a = vrow[j * QT + q];
          ar[j] += a.re * b.re - a.im * b.im;
          ai[j] += a.re * b.im + a.im * b.re;
        }
      }
    }
    __syncthreads();  // every read of the previous term is done
    const T inv = T(1) / T(k);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      cplx<T> z;
      z.re = ar[j] * inv;
      z.im = ai[j] * inv;
      sr[j] += z.re;
      si[j] += z.im;
      term[(p0 + j) * CW + c] = z;
    }
  }

  const int col = c0 + c;
  if (col < ncol) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (p0 + j < m) {
        cplx<T> z;
        z.re = sr[j];
        z.im = si[j];
        out[(wk * m + p0 + j) * (size_t)ncol + col] = z;
      }
    }
  }
}

template <typename T>
static int launch_taylor(const void* vhs, const void* phi, void* out, int w,
                         int m, int ncol, int order, void* stream) {
  constexpr int K = TaylorTile<T>::K;
  constexpr int CW = TaylorTile<T>::CW;
  constexpr int QT = TaylorTile<T>::QT;
  const int mp = taylor_mp<T>(m);
  const int threads = CW * (mp / K);
  if (w <= 0 || m <= 0 || ncol <= 0 || order < 0 ||
      threads > kTaylorThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int nchunk = (ncol + CW - 1) / CW;
  const size_t bytes = (size_t)mp * (CW + QT) * sizeof(cplx<T>);
  if (nchunk > 65535 || bytes > pauxy::kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = pauxy::allow_smem(taylor_kernel<T, K, CW, QT>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)w, (unsigned)nchunk);
  taylor_kernel<T, K, CW, QT>
      <<<grid, threads, bytes, (cudaStream_t)stream>>>(
          static_cast<const cplx<T>*>(vhs), static_cast<const cplx<T>*>(phi),
          static_cast<cplx<T>*>(out), m, ncol, order);
  return (int)cudaGetLastError();
}

extern "C" int pauxy_taylor_c64(const void* vhs, const void* phi, void* out,
                                int w, int m, int ncol, int order,
                                void* stream) {
  return launch_taylor<float>(vhs, phi, out, w, m, ncol, order, stream);
}

extern "C" int pauxy_taylor_c128(const void* vhs, const void* phi, void* out,
                                 int w, int m, int ncol, int order,
                                 void* stream) {
  return launch_taylor<double>(vhs, phi, out, w, m, ncol, order, stream);
}
