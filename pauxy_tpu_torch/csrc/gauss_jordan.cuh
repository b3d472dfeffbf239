// Partial-pivot Gauss-Jordan on one walker's augmented matrix in shared
// memory, shared by greens.cu (kernel A) and batchla.cu (kernel B) just as
// pauxy_tpu/ops/batchla_pallas.py:gauss_jordan_lanes is shared by the two
// TPU kernels.
//
// Layout: one thread per walker. A block's shared memory holds the
// augmented matrices of its walkers as [row][col][lane], so element (i, j)
// of the walker at `lane` sits at smem[(i * ncol + j) * stride + lane] with
// stride = walkers per block: the 32 lanes of a warp touch 32 consecutive
// complex words, without bank conflicts. A thread touches only its own
// lane, so no __syncthreads is needed anywhere.
//
// Complex values are interleaved (re, im) pairs, PyTorch's layout for
// complex64/complex128, so a kernel reads torch tensors directly.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace pauxy {

template <typename T>
struct alignas(2 * sizeof(T)) cplx {
  T re;
  T im;
};

__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float drsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double drsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float datan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double datan2(double y, double x) { return atan2(y, x); }

// Gauss-Jordan with partial pivoting on the n x ncol matrix at `a`
// (element (i, j) at a[(i * ncol + j) * stride]). On return the first n
// columns are eliminated to the identity, columns n..ncol-1 hold
// S^-1 times what they held (the inverse when they held I), and
// log det S = ldr + i atan2(ph_im, ph_re).
//
// The pivot of column k is the lowest row index i >= k that attains the
// maximum |a_ik|^2 (batchla_pallas.py:83-92); every swap negates the phase.
template <typename T>
__device__ void gauss_jordan(cplx<T>* a, int n, int ncol, int stride,
                             T& ldr, T& ph_re, T& ph_im) {
  ldr = T(0);
  ph_re = T(1);
  ph_im = T(0);
  for (int k = 0; k < n; ++k) {
    int piv = k;
    T best = T(-1);
    for (int i = k; i < n; ++i) {
      const cplx<T> v = a[(i * ncol + k) * stride];
      const T mag = v.re * v.re + v.im * v.im;
      if (mag > best) {
        best = mag;
        piv = i;
      }
    }
    if (piv != k) {
      for (int j = k; j < ncol; ++j) {
        const cplx<T> t = a[(k * ncol + j) * stride];
        a[(k * ncol + j) * stride] = a[(piv * ncol + j) * stride];
        a[(piv * ncol + j) * stride] = t;
      }
      ph_re = -ph_re;
      ph_im = -ph_im;
    }
    const cplx<T> p = a[(k * ncol + k) * stride];
    const T den = p.re * p.re + p.im * p.im;
    ldr += T(0.5) * dlog(den);
    const T rn = drsqrt(den);
    const T ur = p.re * rn;
    const T ui = p.im * rn;
    const T nr = ph_re * ur - ph_im * ui;
    ph_im = ph_re * ui + ph_im * ur;
    ph_re = nr;
    // Row k /= p. Columns left of k are already zero in rows >= k.
    const T ir = p.re / den;
    const T ii = -p.im / den;
    for (int j = k; j < ncol; ++j) {
      const cplx<T> v = a[(k * ncol + j) * stride];
      cplx<T> out;
      out.re = v.re * ir - v.im * ii;
      out.im = v.re * ii + v.im * ir;
      a[(k * ncol + j) * stride] = out;
    }
    // Eliminate column k from every other row.
    for (int i = 0; i < n; ++i) {
      if (i == k) continue;
      const cplx<T> f = a[(i * ncol + k) * stride];
      for (int j = k; j < ncol; ++j) {
        const cplx<T> r = a[(k * ncol + j) * stride];
        cplx<T> v = a[(i * ncol + j) * stride];
        v.re -= f.re * r.re - f.im * r.im;
        v.im -= f.re * r.im + f.im * r.re;
        a[(i * ncol + j) * stride] = v;
      }
    }
  }
}

// Shared memory a block may use on sm_90 (227 KB, dynamic above 48 KB).
constexpr size_t kSmemMax = 232448;
constexpr size_t kSmemStatic = 48 * 1024;
constexpr int kMaxWalkersPerBlock = 128;

// Walkers per block for an n x ncol working matrix: the largest power of
// two up to 128 whose matrices fit in shared memory; 0 when not even one
// fits. `bytes` receives the dynamic shared memory of one block.
template <typename T>
inline int walkers_per_block(int n, int ncol, size_t* bytes) {
  const size_t per = (size_t)n * (size_t)ncol * sizeof(cplx<T>);
  int wpb = kMaxWalkersPerBlock;
  while (wpb > 1 && (size_t)wpb * per > kSmemMax) wpb /= 2;
  *bytes = (size_t)wpb * per;
  return *bytes <= kSmemMax ? wpb : 0;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kSmemStatic) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace pauxy
