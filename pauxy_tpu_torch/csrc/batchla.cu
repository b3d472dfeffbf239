// Kernel B: batched inverse and log-determinant, walker axis last.
//
// Replaces the TPU kernel pauxy_tpu/ops/batchla_pallas.py:inv_logdet_lanes /
// slogdet_lanes (kernel body _inv_logdet_kernel via gauss_jordan_lanes).
// Input s [n, n, W] (the wrapper moves the batch axis last); per lane w it
// returns log det s[:, :, w] as a complex number and, with want_inv, the
// inverse as [n, n, W] in the input's type. Complex input takes the complex
// elimination; real input (the discrete sweep's S = psi^T phi) the real
// one, whose log-det has an imaginary part of 0 or pi and whose inverse is
// real, the contract of the TPU kernel (batchla_pallas.py:181-207).
//
// What bounds it on the H100: at n = 7 and W = 1024 it reads 0.4 MB (log-det
// only) and does ~500 dependent multiply-adds per thread. Like kernel A it
// is latency- and occupancy-bound (one thread per walker, 128 walkers per
// block in 8 of the 132 SMs), and it reads and writes each matrix once,
// coalesced. A many-walkers-per-warp layout and wgmma-sized tiles for large
// n are work for later.
//
// float and double are both instantiated; the TPU kernel always computed in
// float32, here complex128 and float64 are computed in double.

#include "gauss_jordan.cuh"

using pauxy::cplx;

template <typename T>
__global__ void inv_logdet_lanes_kernel(const cplx<T>* __restrict__ s,
                                        cplx<T>* __restrict__ logdet,
                                        cplx<T>* __restrict__ inv,
                                        int n, int w, int want_inv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int stride = blockDim.x;
  const int wk = blockIdx.x * blockDim.x + lane;
  if (wk >= w) return;  // ragged edge of the walker axis
  const int ncol = want_inv ? 2 * n : n;
  cplx<T>* a = reinterpret_cast<cplx<T>*>(smem_raw) + lane;
  const size_t sw = (size_t)w;

  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      a[(i * ncol + j) * stride] = s[((size_t)i * n + j) * sw + wk];
    }
    for (int j = n; j < ncol; ++j) {
      cplx<T> e;
      e.re = (j - n == i) ? T(1) : T(0);
      e.im = T(0);
      a[(i * ncol + j) * stride] = e;
    }
  }

  T ldr, ph_re, ph_im;
  pauxy::gauss_jordan(a, n, ncol, stride, ldr, ph_re, ph_im);
  cplx<T> ld;
  ld.re = ldr;
  ld.im = pauxy::datan2(ph_im, ph_re);
  logdet[wk] = ld;
  if (!want_inv) return;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      inv[((size_t)i * n + j) * sw + wk] = a[(i * ncol + n + j) * stride];
    }
  }
}

template <typename T>
__global__ void inv_logdet_lanes_real_kernel(const T* __restrict__ s,
                                             cplx<T>* __restrict__ logdet,
                                             T* __restrict__ inv, int n,
                                             int w, int want_inv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int stride = blockDim.x;
  const int wk = blockIdx.x * blockDim.x + lane;
  if (wk >= w) return;
  const int ncol = want_inv ? 2 * n : n;
  T* a = reinterpret_cast<T*>(smem_raw) + lane;
  const size_t sw = (size_t)w;

  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      a[(i * ncol + j) * stride] = s[((size_t)i * n + j) * sw + wk];
    }
    for (int j = n; j < ncol; ++j) {
      a[(i * ncol + j) * stride] = (j - n == i) ? T(1) : T(0);
    }
  }

  T ldr, sgn;
  pauxy::gauss_jordan_real(a, n, ncol, stride, ldr, sgn);
  cplx<T> ld;
  ld.re = ldr;
  ld.im = sgn < T(0) ? T(3.14159265358979323846) : T(0);
  logdet[wk] = ld;
  if (!want_inv) return;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      inv[((size_t)i * n + j) * sw + wk] = a[(i * ncol + n + j) * stride];
    }
  }
}

// E is the element type: cplx<T> takes the complex kernel, T the real one.
template <typename T, typename E>
static int launch_inv_logdet(const void* s, void* logdet, void* inv, int n,
                             int w, int want_inv, void* stream) {
  const int ncol = want_inv ? 2 * n : n;
  size_t bytes = 0;
  const int wpb =
      pauxy::walkers_per_block((size_t)n * ncol * sizeof(E), &bytes);
  if (wpb == 0 || w <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (w + wpb - 1) / wpb;
  cudaError_t err;
  if constexpr (sizeof(E) == sizeof(cplx<T>)) {
    err = pauxy::allow_smem(inv_logdet_lanes_kernel<T>, bytes);
    if (err != cudaSuccess) return (int)err;
    inv_logdet_lanes_kernel<T><<<grid, wpb, bytes, (cudaStream_t)stream>>>(
        static_cast<const cplx<T>*>(s), static_cast<cplx<T>*>(logdet),
        static_cast<cplx<T>*>(inv), n, w, want_inv);
  } else {
    err = pauxy::allow_smem(inv_logdet_lanes_real_kernel<T>, bytes);
    if (err != cudaSuccess) return (int)err;
    inv_logdet_lanes_real_kernel<T>
        <<<grid, wpb, bytes, (cudaStream_t)stream>>>(
            static_cast<const T*>(s), static_cast<cplx<T>*>(logdet),
            static_cast<T*>(inv), n, w, want_inv);
  }
  return (int)cudaGetLastError();
}

extern "C" int pauxy_inv_logdet_lanes_c64(const void* s, void* logdet,
                                          void* inv, int n, int w,
                                          int want_inv, void* stream) {
  return launch_inv_logdet<float, cplx<float>>(s, logdet, inv, n, w,
                                               want_inv, stream);
}

extern "C" int pauxy_inv_logdet_lanes_c128(const void* s, void* logdet,
                                           void* inv, int n, int w,
                                           int want_inv, void* stream) {
  return launch_inv_logdet<double, cplx<double>>(s, logdet, inv, n, w,
                                                 want_inv, stream);
}

extern "C" int pauxy_inv_logdet_lanes_f32(const void* s, void* logdet,
                                          void* inv, int n, int w,
                                          int want_inv, void* stream) {
  return launch_inv_logdet<float, float>(s, logdet, inv, n, w, want_inv,
                                         stream);
}

extern "C" int pauxy_inv_logdet_lanes_f64(const void* s, void* logdet,
                                          void* inv, int n, int w,
                                          int want_inv, void* stream) {
  return launch_inv_logdet<double, double>(s, logdet, inv, n, w, want_inv,
                                           stream);
}
