// Kernel B: batched complex inverse and log-determinant, walker axis last.
//
// Replaces the TPU kernel pauxy_tpu/ops/batchla_pallas.py:inv_logdet_lanes /
// slogdet_lanes (kernel body _inv_logdet_kernel via gauss_jordan_lanes).
// Input s [n, n, W] (the wrapper moves the batch axis last); per lane w it
// returns log det s[:, :, w] and, with want_inv, the inverse as [n, n, W].
//
// What bounds it on the H100: on the main path it runs once per spin at
// setup, n = 7 and W = 1024. Like kernel A it is latency- and
// occupancy-bound (one thread per walker, 128 walkers per block in 8 of
// the 132 SMs), and it reads and writes each matrix once, coalesced. A
// many-walkers-per-warp layout and wgmma-sized tiles for large n are work
// for later.
//
// float and double are both instantiated; the TPU kernel always computed in
// float32, here complex128 is computed in double.

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
static int launch_inv_logdet(const void* s, void* logdet, void* inv, int n,
                             int w, int want_inv, void* stream) {
  const int ncol = want_inv ? 2 * n : n;
  size_t bytes = 0;
  const int wpb = pauxy::walkers_per_block<T>(n, ncol, &bytes);
  if (wpb == 0 || w <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = pauxy::allow_smem(inv_logdet_lanes_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (w + wpb - 1) / wpb;
  inv_logdet_lanes_kernel<T><<<grid, wpb, bytes, (cudaStream_t)stream>>>(
      static_cast<const cplx<T>*>(s), static_cast<cplx<T>*>(logdet),
      static_cast<cplx<T>*>(inv), n, w, want_inv);
  return (int)cudaGetLastError();
}

extern "C" int pauxy_inv_logdet_lanes_c64(const void* s, void* logdet,
                                          void* inv, int n, int w,
                                          int want_inv, void* stream) {
  return launch_inv_logdet<float>(s, logdet, inv, n, w, want_inv, stream);
}

extern "C" int pauxy_inv_logdet_lanes_c128(const void* s, void* logdet,
                                           void* inv, int n, int w,
                                           int want_inv, void* stream) {
  return launch_inv_logdet<double>(s, logdet, inv, n, w, want_inv, stream);
}
