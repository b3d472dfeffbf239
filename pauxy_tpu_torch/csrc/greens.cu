// Kernel A: walker Green's functions and log-overlaps, walker axis last.
//
// Replaces the TPU kernel pauxy_tpu/ops/greens_pallas.py:greens_lanes_pallas
// (kernel body _greens_kernel). Per walker w, for one spin sector with trial
// psi [M, n] and walker phi [M, n, W]:
//   S[i, j]     = sum_m phi[m, i, w] conj(psi[m, j])        (built here)
//   S^-1, log det S by partial-pivot Gauss-Jordan (gauss_jordan.cuh),
//                 the phase from atan2 of the accumulated unit phase
//   ghT[q, i, w] = sum_j S^-1[i, j] phi[q, j, w]            (want_gh only)
//
// What bounds it on the H100: at the main-path shape (M, n) = (16, 7) with
// W = 1024 the work is ~10^3 dependent complex multiply-adds per thread on
// an n x 2n matrix in shared memory. With 128 walkers per block (784 B
// each in complex64) the 1024 walkers fill only 8 of the 132 SMs, one warp
// per scheduler, so the kernel is latency- and occupancy-bound, not bound
// by bytes or FLOP/s. The design keeps every intermediate out of device
// memory: phi is read (coalesced, one thread per walker on consecutive
// interleaved complex words) and ghT written once. A layout with many
// walkers per warp lane group, wgmma for the overlap and ghT products, and
// TMA staging of phi are work for later.
//
// float and double are both instantiated. The TPU kernel always computed in
// float32; here complex128 inputs are computed in double, since the H100
// has native FP64.

#include "gauss_jordan.cuh"

using pauxy::cplx;

template <typename T>
__global__ void greens_lanes_kernel(const cplx<T>* __restrict__ psi,
                                    const cplx<T>* __restrict__ phi,
                                    cplx<T>* __restrict__ logdet,
                                    cplx<T>* __restrict__ ght,
                                    int m, int n, int w, int want_gh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int stride = blockDim.x;
  const int wk = blockIdx.x * blockDim.x + lane;
  if (wk >= w) return;  // ragged edge of the walker axis
  const int ncol = want_gh ? 2 * n : n;
  cplx<T>* a = reinterpret_cast<cplx<T>*>(smem_raw) + lane;
  const size_t sw = (size_t)w;

  // Overlap S = phi^T conj(psi), identity on the right when ghT is wanted.
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      T sr = T(0);
      T si = T(0);
      for (int mm = 0; mm < m; ++mm) {
        const cplx<T> f = phi[((size_t)mm * n + i) * sw + wk];
        const cplx<T> p = psi[mm * n + j];
        sr += f.re * p.re + f.im * p.im;
        si += f.im * p.re - f.re * p.im;
      }
      cplx<T> s;
      s.re = sr;
      s.im = si;
      a[(i * ncol + j) * stride] = s;
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
  if (!want_gh) return;

  // ghT[q, i] = sum_j S^-1[i, j] phi[q, j].
  for (int q = 0; q < m; ++q) {
    for (int i = 0; i < n; ++i) {
      T gr = T(0);
      T gi = T(0);
      for (int j = 0; j < n; ++j) {
        const cplx<T> v = a[(i * ncol + n + j) * stride];
        const cplx<T> f = phi[((size_t)q * n + j) * sw + wk];
        gr += v.re * f.re - v.im * f.im;
        gi += v.re * f.im + v.im * f.re;
      }
      cplx<T> g;
      g.re = gr;
      g.im = gi;
      ght[((size_t)q * n + i) * sw + wk] = g;
    }
  }
}

template <typename T>
static int launch_greens(const void* psi, const void* phi, void* logdet,
                         void* ght, int m, int n, int w, int want_gh,
                         void* stream) {
  const int ncol = want_gh ? 2 * n : n;
  size_t bytes = 0;
  const int wpb = pauxy::walkers_per_block<T>(n, ncol, &bytes);
  if (wpb == 0 || w <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = pauxy::allow_smem(greens_lanes_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (w + wpb - 1) / wpb;
  greens_lanes_kernel<T><<<grid, wpb, bytes, (cudaStream_t)stream>>>(
      static_cast<const cplx<T>*>(psi), static_cast<const cplx<T>*>(phi),
      static_cast<cplx<T>*>(logdet), static_cast<cplx<T>*>(ght), m, n, w,
      want_gh);
  return (int)cudaGetLastError();
}

extern "C" int pauxy_greens_lanes_c64(const void* psi, const void* phi,
                                      void* logdet, void* ght, int m, int n,
                                      int w, int want_gh, void* stream) {
  return launch_greens<float>(psi, phi, logdet, ght, m, n, w, want_gh,
                              stream);
}

extern "C" int pauxy_greens_lanes_c128(const void* psi, const void* phi,
                                       void* logdet, void* ght, int m, int n,
                                       int w, int want_gh, void* stream) {
  return launch_greens<double>(psi, phi, logdet, ght, m, n, w, want_gh,
                               stream);
}
