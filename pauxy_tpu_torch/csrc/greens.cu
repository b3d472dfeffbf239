// Kernel A: walker Green's functions and log-overlaps, walker axis last.
//
// Replaces the TPU kernel pauxy_tpu/ops/greens_pallas.py:greens_lanes_pallas
// (kernel body _greens_kernel). Per walker w, for one spin sector with trial
// psi [M, n] and walker phi [M, n, W]:
//   S[i, j]     = sum_m phi[m, i, w] conj(psi[m, j])        (built here)
//   S^-1, log det S by partial-pivot Gauss-Jordan on [S | I] (the pivot of
//                 column k: the lowest row i >= k with the largest |S_ik|^2,
//                 batchla_pallas.py:83-92), the phase from atan2 of the
//                 accumulated unit phase
//   ghT[q, i, w] = sum_j S^-1[i, j] phi[q, j, w]            (want_gh only)
// Without the Green's function the elimination runs on S alone and below
// the pivot only (LU): the same pivots and the same log-determinant.
//
// What bounds it on the H100. At the main-path shape (M, n) = (16, 7) with
// W = 1024 the function reads phi (and psi) and writes ghT and the
// log-determinants, 1.84 MB: 0.00055 ms at 3.35 TB/s; its ~5 MFLOP take
// less. What a walker costs is a chain: S (M n^2 multiply-adds), n
// elimination steps, each needing the previous one's pivot row, then ghT
// (M n^2). One thread per walker, as the first port had it, made that
// chain ~2500 dependent complex multiply-adds long, and put 1024 walkers
// on 8 of the 132 SMs.
//
// Design. A walker gets a group of G threads (the next power of two >= n,
// at most 32), and lane g owns the rows i = g (mod G) of [S | I] in shared
// memory (row stride ncol | 1 where it fits, so the lanes hit different
// banks):
//  * S: each lane builds its own rows, reading each phi[m, i] once and
//    kKc columns of S at a time in registers;
//  * elimination: the pivot search is a fixed-order butterfly over the
//    group (the lowest row on ties), the lanes swap and normalise the
//    pivot row column by column, each lane eliminates its own rows kEl
//    columns at a time, and __syncwarp orders the three: a step's chain
//    is one row of 2n entries a lane (n <= G) instead of n rows;
//  * ghT: each lane forms its own rows of S^-1 phi^T.
// 64 / G walkers share a block (fewer where one walker's matrix is large;
// the plan is ops/greens_cuda.py's, checked here),
// so the main path's 1024 walkers are 128 blocks of 64 threads. Where the
// block's phi slab, psi and matrices fit 48 KB, the block stages phi and
// psi in shared memory first, consecutive threads on consecutive walkers
// (coalesced), and S and ghT read them there (STAGED); otherwise (large n,
// near the caps) each lane reads its phi entries from device memory,
// where a warp's reads are whole 32-byte sectors. The intermediates never
// leave the chip: phi is read and ghT written once. Every load in the
// inner loops is unconditional (a column past n reads column n - 1 and is
// not kept), so none waits on a branch.
//
// float and double are both instantiated. The TPU kernel always computed in
// float32; here complex128 inputs are computed in double, since the H100
// has native FP64.

#include "gauss_jordan.cuh"

using pauxy::cplx;

namespace {

constexpr int kGreensThreads = 64;  // threads a block, G per walker
constexpr int kKc = 8;              // columns of S a lane holds at once
constexpr int kEl = 4;              // columns a lane eliminates at once
constexpr int kLoad = 8;            // device-memory loads in flight a thread
constexpr size_t kStageMax = 48 * 1024;

template <typename T>
__device__ __forceinline__ cplx<T> mk(T re, T im) {
  cplx<T> z;
  z.re = re;
  z.im = im;
  return z;
}

// Elements of one walker's matrix, rounded up to 16 bytes.
template <typename T>
__host__ __device__ size_t aug_elems(int n, int ld) {
  const size_t e = (size_t)n * ld;
  return sizeof(cplx<T>) == 8 ? (e + 1) / 2 * 2 : e;
}

// STAGED: phi (and psi) are read from shared memory, staged by the block;
// otherwise from device memory.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(kGreensThreads)
    greens_lanes_kernel(const cplx<T>* __restrict__ psi,
                        const cplx<T>* __restrict__ phi,
                        cplx<T>* __restrict__ logdet,
                        cplx<T>* __restrict__ ght, int m, int n, int w,
                        int want_gh, int G, int wpb, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* smem = reinterpret_cast<cplx<T>*>(smem_raw);
  const unsigned mask =
      blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
  const int tid = threadIdx.x;
  const int wl = tid / G;
  const int lane = tid % G;
  const int w0 = blockIdx.x * wpb;
  const int wk = w0 + wl;
  const bool valid = wk < w;  // a ragged walker computes on a copy
  const int ncol = want_gh ? 2 * n : n;
  cplx<T>* a = smem + wl * aug_elems<T>(n, ld);
  const cplx<T> one = mk(T(1), T(0));
  const cplx<T> zero = mk(T(0), T(0));

  // phi entry (mm, i) of this walker: fb[(mm * n + i) * fs].
  const cplx<T>* fb = phi + (valid ? wk : w - 1);
  const size_t fs = STAGED ? 1 : (size_t)w;
  const cplx<T>* ps = psi;
  if constexpr (STAGED) {
    const int mn = m * n;
    cplx<T>* slab = smem + wpb * aug_elems<T>(n, ld);
    cplx<T>* pstage = slab + (size_t)wpb * mn;
    for (int e = tid; e < mn; e += blockDim.x) pstage[e] = psi[e];
    ps = pstage;
    // kLoad loads in flight a thread, then their stores.
    for (int e0 = tid; e0 < mn * wpb; e0 += blockDim.x * kLoad) {
      cplx<T> x[kLoad];
#pragma unroll
      for (int u = 0; u < kLoad; ++u) {
        const int e = min(e0 + u * (int)blockDim.x, mn * wpb - 1);
        const int mi = e / wpb;
        x[u] = phi[(size_t)mi * w + min(w0 + e - mi * wpb, w - 1)];
      }
#pragma unroll
      for (int u = 0; u < kLoad; ++u) {
        const int e = e0 + u * (int)blockDim.x;
        const int mi = e / wpb;
        if (e < mn * wpb) slab[(e - mi * wpb) * mn + mi] = x[u];
      }
    }
    __syncthreads();
    fb = slab + wl * mn;
  }

  // ---- S = phi^T conj(psi), the identity on the right --------------------
  for (int i = lane; i < n; i += G) {
    for (int j0 = 0; j0 < n; j0 += kKc) {
      cplx<T> acc[kKc];
#pragma unroll
      for (int c = 0; c < kKc; ++c) acc[c] = zero;
      // A column past n reads column n - 1 and is not kept: no load
      // waits on a branch.
      for (int mm = 0; mm < m; ++mm) {
        const cplx<T> f = fb[((size_t)mm * n + i) * fs];
#pragma unroll
        for (int c = 0; c < kKc; ++c) {
          const cplx<T> p = ps[mm * n + min(j0 + c, n - 1)];
          acc[c].re += f.re * p.re + f.im * p.im;
          acc[c].im += f.im * p.re - f.re * p.im;
        }
      }
#pragma unroll
      for (int c = 0; c < kKc; ++c)
        if (j0 + c < n) a[i * ld + j0 + c] = acc[c];
    }
    for (int j = n; j < ncol; ++j) a[i * ld + j] = (j - n == i) ? one : zero;
  }
  __syncwarp(mask);

  // ---- elimination -------------------------------------------------------
  T ldr = T(0), ph_re = T(1), ph_im = T(0);
  for (int k = 0; k < n; ++k) {
    T best = T(-1);
    int piv = n;
    for (int i = lane; i < n; i += G) {
      if (i < k) continue;
      const cplx<T> v = a[i * ld + k];
      const T mag = v.re * v.re + v.im * v.im;
      if (mag > best) {
        best = mag;
        piv = i;
      }
    }
    for (int off = G / 2; off > 0; off >>= 1) {
      const T ob = __shfl_xor_sync(mask, best, off);
      const int oi = __shfl_xor_sync(mask, piv, off);
      if (ob > best || (ob == best && oi < piv)) {
        best = ob;
        piv = oi;
      }
    }
    if (piv >= n) piv = k;
    if (piv != k) {
      for (int j = k + lane; j < ncol; j += G) {
        const cplx<T> t = a[k * ld + j];
        a[k * ld + j] = a[piv * ld + j];
        a[piv * ld + j] = t;
      }
      ph_re = -ph_re;
      ph_im = -ph_im;
    }
    __syncwarp(mask);  // the walkers of a warp may differ in piv != k
    const cplx<T> p = a[k * ld + k];
    const T den = p.re * p.re + p.im * p.im;
    ldr += T(0.5) * pauxy::dlog(den);
    // A zero pivot leaves the phase as it is (log 0 = -inf in ldr): the
    // unit p rsqrt(|p|^2) would be 0 * inf = nan.
    T ur = T(1), ui = T(0);
    if (den != T(0)) {
      const T rn = pauxy::drsqrt(den);
      ur = p.re * rn;
      ui = p.im * rn;
    }
    const T nr = ph_re * ur - ph_im * ui;
    ph_im = ph_re * ui + ph_im * ur;
    ph_re = nr;
    // 1 / p, and 0 for a zero pivot: its column is zero from row k down,
    // so the step eliminates nothing (S is singular, log|det| -inf).
    const T ir = den != T(0) ? p.re / den : T(0);
    const T ii = den != T(0) ? -p.im / den : T(0);
    // Each lane eliminates column k from its own rows with the pivot row
    // as it stands (rows above k too when S^-1 is wanted).
    for (int i = lane; i < n; i += G) {
      if (i == k || (!want_gh && i < k)) continue;
      const cplx<T> x = a[i * ld + k];
      const T fr = x.re * ir - x.im * ii;
      const T fi = x.re * ii + x.im * ir;
      // kEl columns at once: their loads, then their stores; a column
      // past ncol repeats column ncol - 1 with the same value.
      for (int j0 = k; j0 < ncol; j0 += kEl) {
        cplx<T> v[kEl];
#pragma unroll
        for (int c = 0; c < kEl; ++c) {
          const int j = min(j0 + c, ncol - 1);
          const cplx<T> r = a[k * ld + j];
          v[c] = a[i * ld + j];
          v[c].re -= fr * r.re - fi * r.im;
          v[c].im -= fr * r.im + fi * r.re;
        }
#pragma unroll
        for (int c = 0; c < kEl; ++c) a[i * ld + min(j0 + c, ncol - 1)] = v[c];
      }
    }
    if (want_gh) {
      __syncwarp(mask);  // every lane has read the pivot row
      for (int j = k + lane; j < ncol; j += G) {
        const cplx<T> v = a[k * ld + j];
        a[k * ld + j] = mk(v.re * ir - v.im * ii, v.re * ii + v.im * ir);
      }
    }
    __syncwarp(mask);
  }
  if (valid && lane == 0) logdet[wk] = mk(ldr, pauxy::datan2(ph_im, ph_re));
  if (!want_gh) return;

  // ---- ghT[q, i] = sum_j S^-1[i, j] phi[q, j] ----------------------------
  for (int i = lane; i < n; i += G) {
    const cplx<T>* sinv = a + i * ld + n;
    for (int q = 0; q < m; ++q) {
      cplx<T> g = zero;
      const cplx<T>* fq = fb + (size_t)q * n * fs;
      for (int j0 = 0; j0 < n; j0 += kKc) {
#pragma unroll
        for (int c = 0; c < kKc; ++c) {
          const int j = min(j0 + c, n - 1);
          const cplx<T> f = fq[j * fs];
          cplx<T> v = sinv[j];
          if (j0 + c >= n) v = zero;
          g.re += v.re * f.re - v.im * f.im;
          g.im += v.re * f.im + v.im * f.re;
        }
      }
      if (valid) ght[((size_t)q * n + i) * w + wk] = g;
    }
  }
}

// The launch (lanes a walker, walkers a block, row stride, staging) is
// ops/greens_cuda.py's plan; this checks it against the kernel's limits.
template <typename T>
int launch_greens(const void* psi, const void* phi, void* logdet, void* ght,
                  int m, int n, int w, int want_gh, int lanes, int wpb, int ld,
                  int staged, void* stream) {
  const int ncol = want_gh ? 2 * n : n;
  if (w <= 0 || n <= 0 || m <= 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || wpb < 1 ||
      wpb * lanes > kGreensThreads || ld < ncol)
    return (int)cudaErrorInvalidValue;
  const size_t c = sizeof(cplx<T>);
  const size_t per = aug_elems<T>(n, ld) * c;
  const size_t slab = (size_t)m * n * c;
  const size_t bytes = wpb * per + (staged ? (wpb + 1) * slab : 0);
  if (bytes > (staged ? kStageMax : pauxy::kSmemMax))
    return (int)cudaErrorInvalidValue;
  auto kern = staged ? greens_lanes_kernel<T, true>
                     : greens_lanes_kernel<T, false>;
  cudaError_t err = pauxy::allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(w + wpb - 1) / wpb, wpb * lanes, bytes, (cudaStream_t)stream>>>(
      static_cast<const cplx<T>*>(psi), static_cast<const cplx<T>*>(phi),
      static_cast<cplx<T>*>(logdet), static_cast<cplx<T>*>(ght), m, n, w,
      want_gh, lanes, wpb, ld);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pauxy_greens_lanes_c64(const void* psi, const void* phi,
                                      void* logdet, void* ght, int m, int n,
                                      int w, int want_gh, int lanes, int wpb,
                                      int ld, int staged, void* stream) {
  return launch_greens<float>(psi, phi, logdet, ght, m, n, w, want_gh, lanes,
                              wpb, ld, staged, stream);
}

extern "C" int pauxy_greens_lanes_c128(const void* psi, const void* phi,
                                       void* logdet, void* ght, int m, int n,
                                       int w, int want_gh, int lanes, int wpb,
                                       int ld, int staged, void* stream) {
  return launch_greens<double>(psi, phi, logdet, ght, m, n, w, want_gh, lanes,
                               wpb, ld, staged, stream);
}
