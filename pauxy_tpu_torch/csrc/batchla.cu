// Kernel B: batched inverse and log-determinant.
//
// Replaces the TPU kernel pauxy_tpu/ops/batchla_pallas.py:inv_logdet_lanes /
// slogdet_lanes (kernel body _inv_logdet_kernel, :135, via
// gauss_jordan_lanes, :65). Per matrix S it returns log det S as a complex
// number (log|det S| + i arg det S) and, with want_inv, S^-1 in the input's
// type. Complex input takes the complex elimination; real input (the
// discrete sweep's S = psi^T phi) the real one, whose log-det has an
// imaginary part of 0 or pi and whose inverse is real, the contract of the
// TPU kernel (batchla_pallas.py:181-207). It keeps the TPU kernel's pivot
// rule: the pivot of column k is the lowest row index i >= k that attains
// the largest |a_ik|^2; every swap negates the phase. float and double are
// both instantiated; the TPU kernel always computed in float32, here
// complex128 and float64 are computed in double.
//
// One thread block of 256 threads per matrix, input [w, n, n] as it comes,
// for every n from 1 up to the cap. The matrix sits in shared memory with an
// odd row stride (n | 1), so a warp reading a column touches distinct
// banks; warp y owns the rows i = y (mod 8) and lane x the columns
// j = x (mod 32), so a row update is a conflict-free sweep and the pivot
// row is cached in registers for the whole step. The pivot search is one
// warp (strided scan, then a shuffle reduction that breaks ties toward the
// lower index explicitly, so it picks the row the sequential rule picks);
// the pivot row and value are broadcast through shared memory.
// - With the inverse: in-place Gauss-Jordan. At step k column k of the
//   working matrix takes column k of the inverse (no [S | I]; n x n
//   storage, ~n^3 complex multiply-adds instead of ~2 n^3). The row swaps
//   are undone as column swaps when the result is written: thread c
//   follows where column c travels under the swaps and reads it from
//   there.
// - Log-det only: LU, eliminating below the diagonal only (~n^3 / 3
//   multiply-adds). Rows above k never touch the rows below it, so the
//   pivots, and the log-det, are those of the Gauss-Jordan elimination.
// At n = 7, w = 1024 (log-det) the function moves 0.4 MB for 0.9 MFLOP:
// bytes bound it (0.12 us). At n = 93, w = 512 in complex64 it needs
// 8 n^3 w = 3.3 GFLOP against 71 MB: operations bound it (0.049 ms at
// 67 TFLOP/s; 0.016 ms for the log-det). Each step is two or three block
// barriers and one shared-memory read and write per entry, so shared
// memory, the barriers and the one-warp pivot search, not the FP32 units,
// set the pace.
// Complex64 runs on the FP32 CUDA cores: the tensor cores would take it
// only as TF32, which keeps ~3 decimal digits and could not meet the 1e-4
// agreement the port holds kernel B to (ROADMAP's rule forbids TF32
// without an end-to-end anchor). A blocked complex128 trailing update on
// the FP64 tensor cores (DMMA through mma.sync) is a later step.
//
// The same design serves small n: one thread per matrix on [S | I] in
// [row][col][lane] shared memory (the first port's layout) needs the
// batch axis moved last and back, two transposes a call, and on the H100
// its call was the longer at every n from 1 (PERF.md). The cap is the n
// whose n x (n | 1) matrix still fits one block's 227 KB: 120 in
// complex128, 169 in complex64 and float64, 241 in float32, in both modes
// (ops/batchla_cuda.inv_max_n).

#include "gauss_jordan.cuh"

using pauxy::cplx;

namespace {

constexpr int kBlockThreads = 256;
constexpr int kWarps = kBlockThreads / 32;
// Shared memory a block keeps beside the matrix (pivot index and
// value); ops/batchla_cuda.BLOCK_STATIC_BYTES holds the same number.
constexpr size_t kBlockStaticBytes = 64;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// |x|^2 rounded after each operation (no fused multiply-add), so that the
// pivot search compares the numbers the plain version compares.
template <typename T>
__device__ __forceinline__ T mag2(T x) {
  return mul_rn(x, x);
}
template <typename T>
__device__ __forceinline__ T mag2(cplx<T> x) {
  return add_rn(mul_rn(x.re, x.re), mul_rn(x.im, x.im));
}

template <typename T>
__device__ __forceinline__ T mul(T a, T b) {
  return a * b;
}
template <typename T>
__device__ __forceinline__ cplx<T> mul(cplx<T> a, cplx<T> b) {
  cplx<T> o;
  o.re = a.re * b.re - a.im * b.im;
  o.im = a.re * b.im + a.im * b.re;
  return o;
}

// a - f r
template <typename T>
__device__ __forceinline__ T msub(T a, T f, T r) {
  return a - f * r;
}
template <typename T>
__device__ __forceinline__ cplx<T> msub(cplx<T> a, cplx<T> f, cplx<T> r) {
  cplx<T> o;
  o.re = a.re - (f.re * r.re - f.im * r.im);
  o.im = a.im - (f.re * r.im + f.im * r.re);
  return o;
}

// 1 / p, and 0 for a zero pivot: its column is zero from row k down, so
// the step eliminates nothing and the later pivots stay finite (the matrix
// is singular; its log|det| is -inf whatever they are).
template <typename T>
__device__ __forceinline__ T recip(T p) {
  return p != T(0) ? T(1) / p : T(0);
}
template <typename T>
__device__ __forceinline__ cplx<T> recip(cplx<T> p) {
  const T den = mag2(p);
  cplx<T> o;
  o.re = den != T(0) ? p.re / den : T(0);
  o.im = den != T(0) ? -p.im / den : T(0);
  return o;
}

// Folds the pivot p into log|det| (ldr) and the phase (phr, phi), negating
// the phase when the step swapped rows. A zero pivot adds log 0 = -inf to
// log|det| and leaves the phase as it is (unit phase), as the JAX package's
// log of a complex zero does: p rsqrt(|p|^2) would be 0 * inf = nan.
template <typename T>
__device__ __forceinline__ void fold_pivot(T& ldr, T& phr, T& phi, T p,
                                           bool swapped) {
  (void)phi;
  ldr += T(0.5) * pauxy::dlog(mag2(p));
  if ((p < T(0)) != swapped) phr = -phr;
}
template <typename T>
__device__ __forceinline__ void fold_pivot(T& ldr, T& phr, T& phi,
                                           cplx<T> p, bool swapped) {
  const T den = mag2(p);
  ldr += T(0.5) * pauxy::dlog(den);
  T ur = T(1), ui = T(0);
  if (den != T(0)) {
    const T rn = pauxy::drsqrt(den);
    ur = p.re * rn;
    ui = p.im * rn;
  }
  if (swapped) {
    ur = -ur;
    ui = -ui;
  }
  const T nr = phr * ur - phi * ui;
  phi = phr * ui + phi * ur;
  phr = nr;
}

}  // namespace

// E is the element type (float, double, cplx<float>, cplx<double>), T its
// real type, NC the column slots of a lane: n <= 32 NC.
template <typename E, typename T, int NC>
__global__ void __launch_bounds__(kBlockThreads)
    inv_logdet_kernel(const E* __restrict__ s,
                            cplx<T>* __restrict__ logdet,
                            E* __restrict__ inv, int n, int want_inv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_piv;
  __shared__ E s_p;
  E* a = reinterpret_cast<E*>(smem_raw);
  const int ld = n | 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wy = tid >> 5;
  const size_t base = (size_t)blockIdx.x * n * n;

  for (int i = wy; i < n; i += kWarps) {
    for (int j = lane; j < n; j += 32) {
      a[i * ld + j] = s[base + (size_t)i * n + j];
    }
  }
  T ldr = T(0), phr = T(1), phi = T(0);  // thread 0's
  // Where column `tid` of the inverse sits in the working matrix: the row
  // swaps of the in-place elimination permute its columns.
  int pos = tid;
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    // Pivot: the lowest row i >= k with the largest |a_ik|^2.
    if (wy == 0) {
      T best = T(-1);
      int bi = n;
      for (int i = k + lane; i < n; i += 32) {
        const T m = mag2(a[i * ld + k]);
        if (m > best) {
          best = m;
          bi = i;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (lane == 0) {
        if (bi >= n) bi = k;  // a column of NaNs: no row compares larger
        s_piv = bi;
        s_p = a[bi * ld + k];
        fold_pivot(ldr, phr, phi, s_p, bi != k);
      }
    }
    __syncthreads();
    const int piv = s_piv;
    const E pinv = recip(s_p);
    E r[NC];

    if (want_inv) {
      // Row k <- pivot row / p with a_kk = 1 / p; row piv <- old row k.
      // Thread j owns column j, so the swap needs no other barrier.
      if (tid < n) {
        const E top = a[k * ld + tid];
        const E pr = a[piv * ld + tid];
        if (piv != k) a[piv * ld + tid] = top;
        a[k * ld + tid] = (tid == k) ? pinv : mul(pr, pinv);
        if (pos == k) {
          pos = piv;
        } else if (pos == piv) {
          pos = k;
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int j = lane + 32 * q;
        r[q] = (j < n) ? a[k * ld + j] : E{};
      }
      // Every other row: a_ij -= a_ik r_j, column k starting from 0 (it
      // becomes column k of the inverse, -a_ik / p).
      for (int i = wy; i < n; i += kWarps) {
        if (i == k) continue;
        E* row = a + i * ld;
        const E f = row[k];
        __syncwarp();  // every lane has f before lane k % 32 rewrites it
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int j = lane + 32 * q;
          if (j < n) row[j] = msub(j == k ? E{} : row[j], f, r[q]);
        }
      }
    } else {
      // LU: swap the trailing parts of rows k and piv, then eliminate
      // below the diagonal only.
      if (piv != k) {
        if (tid >= k && tid < n) {
          const E t = a[k * ld + tid];
          a[k * ld + tid] = a[piv * ld + tid];
          a[piv * ld + tid] = t;
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int j = lane + 32 * q;
        r[q] = (j > k && j < n) ? a[k * ld + j] : E{};
      }
      int i = wy;
      if (i <= k) i += ((k - i) / kWarps + 1) * kWarps;
      for (; i < n; i += kWarps) {
        E* row = a + i * ld;
        const E f = mul(row[k], pinv);
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int j = lane + 32 * q;
          if (j > k && j < n) row[j] = msub(row[j], f, r[q]);
        }
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    cplx<T> o;
    o.re = ldr;
    o.im = pauxy::datan2(phi, phr);
    logdet[blockIdx.x] = o;
  }
  if (!want_inv || tid >= n) return;
  // Column tid of S^-1 is column pos of the working matrix.
  for (int i = 0; i < n; ++i) {
    inv[base + (size_t)i * n + tid] = a[i * ld + pos];
  }
}

// ---- launchers -----------------------------------------------------------

template <typename E, typename T, int NC>
static int launch_nc(const void* s, void* logdet, void* inv, int n, int w,
                     int want_inv, size_t bytes, cudaStream_t stream) {
  auto kernel = inv_logdet_kernel<E, T, NC>;
  const cudaError_t err = pauxy::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<w, kBlockThreads, bytes, stream>>>(
      static_cast<const E*>(s), static_cast<cplx<T>*>(logdet),
      static_cast<E*>(inv), n, want_inv);
  return (int)cudaGetLastError();
}

template <typename E, typename T>
static int launch_inv_logdet(const void* s, void* logdet, void* inv, int n,
                             int w, int want_inv, void* stream) {
  const size_t bytes = (size_t)n * (size_t)(n | 1) * sizeof(E);
  if (w <= 0 || n <= 0 || n > 32 * 8 ||
      bytes + kBlockStaticBytes > pauxy::kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((n + 31) / 32) {
    case 1: return launch_nc<E, T, 1>(s, logdet, inv, n, w, want_inv, bytes, st);
    case 2: return launch_nc<E, T, 2>(s, logdet, inv, n, w, want_inv, bytes, st);
    case 3: return launch_nc<E, T, 3>(s, logdet, inv, n, w, want_inv, bytes, st);
    case 4: return launch_nc<E, T, 4>(s, logdet, inv, n, w, want_inv, bytes, st);
    case 5: return launch_nc<E, T, 5>(s, logdet, inv, n, w, want_inv, bytes, st);
    case 6: return launch_nc<E, T, 6>(s, logdet, inv, n, w, want_inv, bytes, st);
    case 7: return launch_nc<E, T, 7>(s, logdet, inv, n, w, want_inv, bytes, st);
    default: return launch_nc<E, T, 8>(s, logdet, inv, n, w, want_inv, bytes, st);
  }
}

// s and inv [w, n, n], logdet [w] complex of the real type; inv may be
// null without want_inv. Each returns the cudaError_t of its launch.

extern "C" int pauxy_inv_logdet_c64(const void* s, void* logdet, void* inv,
                                    int n, int w, int want_inv,
                                    void* stream) {
  return launch_inv_logdet<cplx<float>, float>(s, logdet, inv, n, w,
                                               want_inv, stream);
}

extern "C" int pauxy_inv_logdet_c128(const void* s, void* logdet, void* inv,
                                     int n, int w, int want_inv,
                                     void* stream) {
  return launch_inv_logdet<cplx<double>, double>(s, logdet, inv, n, w,
                                                 want_inv, stream);
}

extern "C" int pauxy_inv_logdet_f32(const void* s, void* logdet, void* inv,
                                    int n, int w, int want_inv,
                                    void* stream) {
  return launch_inv_logdet<float, float>(s, logdet, inv, n, w, want_inv,
                                         stream);
}

extern "C" int pauxy_inv_logdet_f64(const void* s, void* logdet, void* inv,
                                    int n, int w, int want_inv,
                                    void* stream) {
  return launch_inv_logdet<double, double>(s, logdet, inv, n, w, want_inv,
                                           stream);
}
