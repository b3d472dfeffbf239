// Cholesky-inverse kernel: L^-1 and log det L of Hermitian positive-definite
// matrices, walker axis last.
//
// Replaces the TPU kernel pauxy_tpu/ops/batchla_pallas.py:chol_inv_lanes
// (kernel body _chol_inv_kernel). Input s [n, n, W] (the wrapper moves the
// batch axis last); per lane w, with S = L L^H and diag(L) real positive:
//   log_det_l[w]        = sum_k log L[k, k]                  (real)
//   linv[:, :, w]       = L^-1, lower triangular, zeros above
// CholeskyQR then forms Q = phi L^-H as one batched product outside the
// kernel (ops/clinalg.cholesky_qr).
//
// Algorithm, per thread (one walker): right-looking Cholesky of the lower
// triangle in place, with the TPU kernel's guard sqrt(max(a_kk, 1e-30)),
// then L^-1 in place, column by column (column j of L^-1 needs column j of
// L and the columns right of it, which are still L). The working matrix is
// n x n in shared memory in the [row][col][lane] layout of gauss_jordan.cuh.
//
// What bounds it on the H100: at n = 7 and W = 1024 (the discrete path, four
// launches per re-orthogonalisation) it reads 0.23 MB (the lower triangle)
// and writes 0.4 MB, and does ~n^3/2 = 170 dependent complex multiply-adds
// per thread. Like kernels
// A and B it is latency- and occupancy-bound: one thread per walker, 128
// walkers per block, 8 of 132 SMs busy at W = 1024.
//
// float and double are both instantiated; the TPU kernel always computed in
// float32, here complex128 is computed in double.

#include "gauss_jordan.cuh"

using pauxy::cplx;

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

template <typename T>
__global__ void chol_inv_lanes_kernel(const cplx<T>* __restrict__ s,
                                      T* __restrict__ log_det_l,
                                      cplx<T>* __restrict__ linv, int n,
                                      int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int stride = blockDim.x;
  const int wk = blockIdx.x * blockDim.x + lane;
  if (wk >= w) return;  // ragged edge of the walker axis
  cplx<T>* a = reinterpret_cast<cplx<T>*>(smem_raw) + lane;
  const size_t sw = (size_t)w;
#define A(i, j) a[((i) * n + (j)) * stride]

  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) A(i, j) = s[((size_t)i * n + j) * sw + wk];
  }

  // Right-looking Cholesky on the lower triangle: S = L L^H.
  T ld = T(0);
  for (int k = 0; k < n; ++k) {
    const T akk = A(k, k).re;
    const T d = dsqrt(akk > T(1e-30) ? akk : T(1e-30));
    ld += pauxy::dlog(d);
    const T id = T(1) / d;
    cplx<T> dk;
    dk.re = d;
    dk.im = T(0);
    A(k, k) = dk;
    for (int i = k + 1; i < n; ++i) {
      cplx<T> v = A(i, k);
      v.re *= id;
      v.im *= id;
      A(i, k) = v;
    }
    // A[i, j] -= L[i, k] conj(L[j, k]) for k < j <= i.
    for (int j = k + 1; j < n; ++j) {
      const cplx<T> lj = A(j, k);
      for (int i = j; i < n; ++i) {
        const cplx<T> li = A(i, k);
        cplx<T> v = A(i, j);
        v.re -= li.re * lj.re + li.im * lj.im;
        v.im -= li.im * lj.re - li.re * lj.im;
        A(i, j) = v;
      }
    }
  }
  log_det_l[wk] = ld;

  // L^-1 in place: X[j, j] = 1 / L[j, j];
  // X[i, j] = -(sum_{k=j}^{i-1} L[i, k] X[k, j]) / L[i, i] for i > j.
  for (int j = 0; j < n; ++j) {
    cplx<T> xjj;
    xjj.re = T(1) / A(j, j).re;
    xjj.im = T(0);
    A(j, j) = xjj;
    for (int i = j + 1; i < n; ++i) {
      T sr = T(0);
      T si = T(0);
      // L[i, j] (k = j) is still L until X[i, j] overwrites it below.
      for (int k = j; k < i; ++k) {
        const cplx<T> l = A(i, k);
        const cplx<T> x = A(k, j);
        sr += l.re * x.re - l.im * x.im;
        si += l.re * x.im + l.im * x.re;
      }
      const T r = T(-1) / A(i, i).re;
      cplx<T> out;
      out.re = sr * r;
      out.im = si * r;
      A(i, j) = out;
    }
  }

  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      cplx<T> v;
      if (j <= i) {
        v = A(i, j);
      } else {
        v.re = T(0);
        v.im = T(0);
      }
      linv[((size_t)i * n + j) * sw + wk] = v;
    }
  }
#undef A
}

template <typename T>
static int launch_chol_inv(const void* s, void* log_det_l, void* linv, int n,
                           int w, void* stream) {
  size_t bytes = 0;
  const int wpb =
      pauxy::walkers_per_block((size_t)n * n * sizeof(cplx<T>), &bytes);
  if (wpb == 0 || w <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = pauxy::allow_smem(chol_inv_lanes_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (w + wpb - 1) / wpb;
  chol_inv_lanes_kernel<T><<<grid, wpb, bytes, (cudaStream_t)stream>>>(
      static_cast<const cplx<T>*>(s), static_cast<T*>(log_det_l),
      static_cast<cplx<T>*>(linv), n, w);
  return (int)cudaGetLastError();
}

extern "C" int pauxy_chol_inv_lanes_c64(const void* s, void* log_det_l,
                                        void* linv, int n, int w,
                                        void* stream) {
  return launch_chol_inv<float>(s, log_det_l, linv, n, w, stream);
}

extern "C" int pauxy_chol_inv_lanes_c128(const void* s, void* log_det_l,
                                         void* linv, int n, int w,
                                         void* stream) {
  return launch_chol_inv<double>(s, log_det_l, linv, n, w, stream);
}
