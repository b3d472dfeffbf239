// Exchange contraction of the Generic local energy:
//   exx[w] = sum_x tr(T_wx T_wx),  T_wx = rchol_x Ghalf_w^T  ([n, n]),
// i.e. sum_{x, i, j} T_wx[i, j] T_wx[j, i], without the [w, X, n, n]
// intermediate the einsum route builds.
//
// Replaces the TPU kernel pauxy_tpu/ops/exx_pallas.py:exx_pallas (kernel
// body _exx_kernel), reached from pauxy_tpu/estimators/local_energy._exx
// when the trial has no exchange supermatrix ((n M)^2 > 2^26) and rchol is
// real. Inputs rchol [X, n, M] real and ghalf [w, n, M] complex, contiguous;
// output exx [w] complex. Every (X, n, M) launches: shared memory holds
// column chunks of the inputs, never T.
//
// Design: one block per walker; the TPU kernel's sequential X-chunk grid
// axis becomes a loop over x inside the block, so the sum needs no second
// pass and no atomics: every run gives the same bits. The pairs (i, j) of
// T_x are covered by R x R tiles on and above the diagonal; a thread owns
// one tile and builds both T_x[i, j] and T_x[j, i] of its pairs in
// registers,
//   T_x[i, j] = sum_m rchol_x[i, m] Ghalf_w[j, m],
// so T_x[i, j] T_x[j, i] is a product of two of its own registers, weighted
// 2 off the diagonal (the pair (j, i) gives the same product) and 1 on it;
// every entry of T_x is built once, and T_x needs no shared memory and no
// barrier. Ghalf_w and rchol_x sit in shared memory transposed ([m][i], the
// threads of a warp read neighbouring words) in chunks of MC columns: the
// whole of Ghalf_w once for all x, and rchol_x once per x, when both fit in
// kExxSmemTarget (MC = M), else in equal chunks that do, chunk by chunk as
// the tiles' sums run over m (re-read from L2 for each x). The target lets
// two blocks share an SM: with one walker a block, one block an SM leaves
// the kernel latency-bound and runs 256 walkers in two waves. Threads take
// tiles in rounds when there are more tiles than threads. At the end a
// warp-shuffle tree and one thread per block sum the partials in a fixed
// order.
//
// What bounds it on the H100: at (X, n, M) = (1024, 42, 228), w = 256, the
// T builds are 4 X n^2 M w = 4.2e11 real FLOPs against 0.2 GB of inputs:
// 6.3 ms at 67 TFLOP/s (float32 outside the tensor cores), FLOP-bound. This
// kernel runs 2 R^2 real-times-complex multiply-adds per 2 R real and 2 R
// complex shared loads on the FP32 pipes, so it is load- and latency-bound
// below that; wgmma tiles of the T build are later work.
//
// float and double are both instantiated; the TPU kernel always computed in
// float32, here complex128 is computed in double. Complex rchol is not this
// kernel's contract: _exx routes it to the einsum route, as JAX does.

#include "gauss_jordan.cuh"

using pauxy::cplx;

constexpr int kExxMaxThreads = 512;
constexpr int kExxReduce = 2 * (kExxMaxThreads / 32);
// Shared memory a block aims at, so that two blocks fit an SM's 228 KB.
constexpr size_t kExxSmemTarget = 96 * 1024;
// Edge of the square register tile of pairs a thread owns.
constexpr int kR = 2;

// Tile k of the upper triangle, row-major by column: k = tj (tj + 1) / 2 + ti
// with ti <= tj.
__device__ inline void upper_tile(int k, int* ti, int* tj) {
  int j = (int)((sqrtf(8.0f * (float)k + 1.0f) - 1.0f) * 0.5f);
  while ((j + 1) * (j + 2) / 2 <= k) ++j;
  while (j * (j + 1) / 2 > k) --j;
  *tj = j;
  *ti = k - j * (j + 1) / 2;
}

template <typename T>
__global__ void __launch_bounds__(kExxMaxThreads)
    exx_kernel(const T* __restrict__ rchol, const cplx<T>* __restrict__ ghalf,
               cplx<T>* __restrict__ out, int nx, int n, int m, int mc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* gs = reinterpret_cast<cplx<T>*>(smem_raw);  // [mc][n]
  T* rs = reinterpret_cast<T*>(gs + (size_t)mc * n);   // [mc][n]
  T* red = rs + (size_t)mc * n;                        // [kExxReduce]
  const size_t wk = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int nb = (n + kR - 1) / kR;
  const int ntile = nb * (nb + 1) / 2;
  const int rounds = (ntile + nt - 1) / nt;
  const bool whole = mc >= m;
  const cplx<T>* gh = ghalf + wk * (size_t)n * m;

  if (whole) {
    for (int e = t; e < n * m; e += nt) gs[(e % m) * n + e / m] = gh[e];
  }
  T acc_re = T(0);
  T acc_im = T(0);
  for (int x = 0; x < nx; ++x) {
    const T* rc = rchol + (size_t)x * n * m;
    for (int r = 0; r < rounds; ++r) {
      const int k = t + r * nt;
      const bool active = k < ntile;
      int ti = 0, tj = 0;
      if (active) upper_tile(k, &ti, &tj);
      int ii[kR], jj[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        ii[a] = min(ti * kR + a, n - 1);
        jj[a] = min(tj * kR + a, n - 1);
      }
      // t1[a][b] = T_x[i_a, j_b], t2[a][b] = T_x[j_b, i_a].
      T t1r[kR][kR], t1i[kR][kR], t2r[kR][kR], t2i[kR][kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) {
#pragma unroll
        for (int b = 0; b < kR; ++b) {
          t1r[a][b] = T(0);
          t1i[a][b] = T(0);
          t2r[a][b] = T(0);
          t2i[a][b] = T(0);
        }
      }
      for (int c0 = 0; c0 < m; c0 += mc) {
        const int len = min(mc, m - c0);
        if (!whole || r == 0) {
          // Every read of the last chunk (or the last x) is done.
          __syncthreads();
          for (int e = t; e < n * len; e += nt) {
            const int i = e / len;
            const int q = e - i * len;
            rs[q * n + i] = rc[(size_t)i * m + c0 + q];
            if (!whole) gs[q * n + i] = gh[(size_t)i * m + c0 + q];
          }
          __syncthreads();
        }
        if (!active) continue;
#pragma unroll 4
        for (int q = 0; q < len; ++q) {
          T ri[kR], rj[kR];
          cplx<T> gi[kR], gj[kR];
#pragma unroll
          for (int a = 0; a < kR; ++a) {
            ri[a] = rs[q * n + ii[a]];
            rj[a] = rs[q * n + jj[a]];
            gi[a] = gs[q * n + ii[a]];
            gj[a] = gs[q * n + jj[a]];
          }
#pragma unroll
          for (int a = 0; a < kR; ++a) {
#pragma unroll
            for (int b = 0; b < kR; ++b) {
              t1r[a][b] += ri[a] * gj[b].re;
              t1i[a][b] += ri[a] * gj[b].im;
              t2r[a][b] += rj[b] * gi[a].re;
              t2i[a][b] += rj[b] * gi[a].im;
            }
          }
        }
      }
      if (!active) continue;
#pragma unroll
      for (int a = 0; a < kR; ++a) {
#pragma unroll
        for (int b = 0; b < kR; ++b) {
          const int i = ti * kR + a;
          const int j = tj * kR + b;
          if (i < n && j < n && i <= j) {
            const T wgt = i == j ? T(1) : T(2);
            acc_re += wgt * (t1r[a][b] * t2r[a][b] - t1i[a][b] * t2i[a][b]);
            acc_im += wgt * (t1r[a][b] * t2i[a][b] + t1i[a][b] * t2r[a][b]);
          }
        }
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    acc_re += __shfl_down_sync(0xffffffffu, acc_re, off);
    acc_im += __shfl_down_sync(0xffffffffu, acc_im, off);
  }
  // No thread reads the inputs' shared memory after this point; red is
  // its own region.
  if ((t & 31) == 0) {
    red[2 * (t >> 5)] = acc_re;
    red[2 * (t >> 5) + 1] = acc_im;
  }
  __syncthreads();
  if (t == 0) {
    cplx<T> z;
    z.re = T(0);
    z.im = T(0);
    for (int k = 0; k < nt / 32; ++k) {
      z.re += red[2 * k];
      z.im += red[2 * k + 1];
    }
    out[wk] = z;
  }
}

// Dynamic shared memory of one block that stages mc columns: Ghalf_w^T and
// rchol_x^T chunks and the reduction scratch.
template <typename T>
static size_t exx_smem(int n, int mc) {
  return (size_t)mc * n * (sizeof(cplx<T>) + sizeof(T)) +
         kExxReduce * sizeof(T);
}

template <typename T>
static int launch_exx(const void* rchol, const void* ghalf, void* out, int nx,
                      int n, int m, int w, void* stream) {
  if (w <= 0 || n <= 0 || m <= 0 || nx < 0) return (int)cudaErrorInvalidValue;
  // All of M when it fits the target, else equal chunks that do (or, when
  // one column alone exceeds the target, that fit the whole budget).
  const size_t per_col = (size_t)n * (sizeof(cplx<T>) + sizeof(T));
  const size_t red = kExxReduce * sizeof(T);
  size_t fit = (kExxSmemTarget - red) / per_col;
  if (fit < 1) fit = (pauxy::kSmemMax - red) / per_col;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const size_t nchunk = ((size_t)m + fit - 1) / fit;
  const int mc = (int)(((size_t)m + nchunk - 1) / nchunk);
  const size_t bytes = exx_smem<T>(n, mc);
  const int nb = (n + kR - 1) / kR;
  const int ntile = nb * (nb + 1) / 2;
  int threads = (ntile + 31) / 32 * 32;
  if (threads > kExxMaxThreads) threads = kExxMaxThreads;
  cudaError_t err = pauxy::allow_smem(exx_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  exx_kernel<T><<<w, threads, bytes, (cudaStream_t)stream>>>(
      static_cast<const T*>(rchol), static_cast<const cplx<T>*>(ghalf),
      static_cast<cplx<T>*>(out), nx, n, m, mc);
  return (int)cudaGetLastError();
}

extern "C" int pauxy_exx_c64(const void* rchol, const void* ghalf, void* out,
                             int nx, int n, int m, int w, void* stream) {
  return launch_exx<float>(rchol, ghalf, out, nx, n, m, w, stream);
}

extern "C" int pauxy_exx_c128(const void* rchol, const void* ghalf,
                              void* out, int nx, int n, int m, int w,
                              void* stream) {
  return launch_exx<double>(rchol, ghalf, out, nx, n, m, w, stream);
}
