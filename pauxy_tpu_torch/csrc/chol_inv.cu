// Cholesky-inverse kernel: L^-1 and log det L of Hermitian positive-definite
// matrices, [w, n, n] as they come.
//
// Replaces the TPU kernel pauxy_tpu/ops/batchla_pallas.py:chol_inv_lanes
// (kernel body _chol_inv_kernel). Per matrix s[w] = L L^H with diag(L) real
// positive:
//   log_det_l[w] = sum_k log L[k, k]                          (real)
//   linv[w]      = L^-1, lower triangular, zeros above
// Only the lower triangle of s is used. CholeskyQR then forms Q = phi L^-H
// as one batched product outside the kernel (ops/clinalg.cholesky_qr).
//
// Algorithm: one chain of n steps. Step k of the right-looking Cholesky
// (d = sqrt(max(a_kk, 1e-30)), the TPU kernel's guard; L[i, k] = a_ik / d;
// a_ij -= L[i, k] conj(L[j, k]) for k < j <= i) finalises column k of L,
// and that column is all that step k of the forward substitution
// X = L^-1 (X[k] /= L[k, k]; X[i] -= L[i, k] X[k] for i > k) needs, so the
// two run as one step. Row i of the working matrix holds X[i, 0..k-1] where
// the consumed columns of L were, and the trailing row a_i,k.. after it:
// one n x n matrix in shared memory. A step is two phases:
//  A. every thread reads a_kk; the thread of row i > k forms L[i, k] and
//     writes conj(L[i, k]) into row k at column i (above the diagonal, free:
//     row k holds X[k, 0..k-1] and a_kk). Row k then reads, with
//     p_j = X[k, j] / d for j < k, p_k = 1 / d and p_j = conj(L[j, k]) for
//     j > k, as the pivot row of one elimination step;
//  B. every row i > k does row_i -= L[i, k] p, with X[i, k] = 0 before it:
//     the X part is the forward substitution, the part from k + 1 to i the
//     Cholesky update (right of i it updates entries that step i
//     overwrites).
// Row k is scaled at the end (X[k, j] / d_k), with 1 / d_k kept on the
// diagonal from step k + 1 on, where nothing reads it any more.
//
// What bounds it on the H100: at n = 42, w = 256 (the Generic path past
// the exchange cap) the function reads 1.8 MB and writes 3.6 MB, ~1.6 us of
// HBM, and needs ~8 n^3 w / 3 = 0.2 GFLOP. What a matrix costs is its chain
// of n dependent steps. With one thread a matrix that chain would be two
// loops of ~n^3 / 6 dependent multiply-adds, and 256 matrices would fill 16
// of the 132 SMs; here a step's row updates run in parallel:
//  * n <= 32 ("lanes"): a group of G threads a matrix (the next power of
//    two >= n, a template parameter: the row loops run to G unrolled, four
//    entries' loads before their stores), lane r owning row r; 64 / G
//    matrices a block; __syncwarp between the phases (a group never spans
//    two warps);
//  * n > 32 ("block"): one block a matrix; thread t owns row t mod n and
//    the columns j = t / n (mod P), P = threads / n, so every step keeps
//    P n threads busy; two block barriers a step. 256 threads and one
//    entry at a time measured best at n = 42 (PERF.md).
// Rows are padded to the odd stride n | 1 where it fits, so the threads of
// a warp, each on its own row, hit different banks; the pivot row is read
// as a broadcast. s is read and L^-1 written whole and coalesced; every
// load of a step is unconditional (selects, no guarded loads). The launch
// (threads, group, rows, stride) is ops/batchla_cuda.py's plan, checked by
// the launcher here.
//
// float and double are both instantiated; the TPU kernel always computed in
// float32, here complex128 is computed in double.

#include "gauss_jordan.cuh"

using pauxy::cplx;

namespace {

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ cplx<T> mk(T re, T im) {
  cplx<T> z;
  z.re = re;
  z.im = im;
  return z;
}

// Row entries a thread updates at once: a lane of the lanes route, a
// thread of the block route.
constexpr int kChunk = 4;
constexpr int kBlockChunk = 1;

template <int G>
__device__ __forceinline__ void sync_group() {
  if constexpr (G == 0) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// Phase B for C entries j = j0, j0 + step, ... of row i: their loads, then
// their stores (a store could alias the next entry's load otherwise). An
// entry past n reads column n - 1 and is not stored. p_j is X[k, j] / d
// left of k, 1 / d at k (where X[i, k] = 0 before) and conj(L[j, k]) right
// of it.
template <int C, typename T>
__device__ __forceinline__ void row_update(cplx<T>* a, int ld, int n, int k,
                                           int i, cplx<T> l, T id, int j0,
                                           int step) {
  cplx<T> v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int jr = j0 + c * step;
    const int j = jr < n ? jr : n - 1;
    const cplx<T> q0 = a[k * ld + j];
    v[c] = a[i * ld + j];
    const T sc = j < k ? id : T(1);
    cplx<T> q = mk(q0.re * sc, q0.im * sc);
    if (j == k) {
      q = mk(id, T(0));
      v[c] = mk(T(0), T(0));
    }
    v[c].re -= l.re * q.re - l.im * q.im;
    v[c].im -= l.re * q.im + l.im * q.re;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (j0 + c * step < n) a[i * ld + j0 + c * step] = v[c];
}

// G > 0: the lanes route, G lanes a matrix (a compile-time power of two up
// to 32, lane r owning row r; every row loop runs to G unrolled, an entry
// past n loaded from column n - 1 and not stored). G == 0: the block route,
// the whole block a matrix, the thread of row tg mod `rows` (rows == n) and
// columns j = tg / rows (mod group / rows). `ld` is the row stride.
template <typename T, int G>
__global__ void chol_inv_kernel(const cplx<T>* __restrict__ s,
                                T* __restrict__ log_det_l,
                                cplx<T>* __restrict__ linv, int n, int w,
                                int group, int rows, int ld) {
  constexpr bool BLOCK = G == 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (!BLOCK) group = rows = G;
  const int tg = threadIdx.x % group;
  const int slot = threadIdx.x / group;
  const int wk = blockIdx.x * (blockDim.x / group) + slot;
  const bool valid = wk < w;  // a ragged matrix computes on a copy
  const int P = BLOCK ? group / rows : 1;
  const int p = BLOCK ? tg / rows : 0;
  const int r = tg % rows;
  const bool own = r < n && p < P;
  const int i = own ? r : n - 1;  // a thread without a row reads row n - 1
  cplx<T>* a = reinterpret_cast<cplx<T>*>(smem_raw) + (size_t)slot * n * ld;
  const size_t nn = (size_t)n * n;
  const cplx<T>* src = s + (valid ? wk : w - 1) * nn;

  for (int e = tg; e < (int)nn; e += group) {
    const int ei = e / n;
    a[ei * ld + e - ei * n] = src[e];
  }
  sync_group<G>();

  T ldl = T(0);
  T id_prev = T(0);
  const cplx<T> zero = mk(T(0), T(0));
  for (int k = 0; k < n; ++k) {
    // ---- phase A: the pivot, column k of L, row k's upper part ----------
    const T akk = a[k * ld + k].re;
    const T d = dsqrt(akk > T(1e-30) ? akk : T(1e-30));
    ldl += pauxy::dlog(d);
    const T id = T(1) / d;
    const cplx<T> x = a[i * ld + k];
    const cplx<T> l = mk(x.re * id, x.im * id);
    const bool act = own && i > k;
    if (act && p == 0) a[k * ld + i] = mk(l.re, -l.im);
    if (k > 0 && tg == 0) a[(k - 1) * ld + k - 1] = mk(id_prev, T(0));
    id_prev = id;
    sync_group<G>();
    // ---- phase B: row_i -= L[i, k] p for the rows below k ---------------
    if (act) {
      if constexpr (BLOCK) {
        for (int j = p; j < n; j += P * kBlockChunk)
          row_update<kBlockChunk>(a, ld, n, k, i, l, id, j, P);
      } else {
#pragma unroll
        for (int j = 0; j < G; j += kChunk)
          row_update<kChunk>(a, ld, n, k, i, l, id, j, 1);
      }
    }
    sync_group<G>();
  }
  if (tg == 0) a[(n - 1) * ld + n - 1] = mk(id_prev, T(0));
  sync_group<G>();
  if (!valid) return;
  if (tg == 0) log_det_l[wk] = ldl;
  cplx<T>* out = linv + wk * nn;
  for (int e = tg; e < (int)nn; e += group) {
    const int ei = e / n;
    const int ej = e - ei * n;
    const cplx<T> dg = a[ei * ld + ei];
    const cplx<T> v = a[ei * ld + ej];
    cplx<T> o = mk(v.re * dg.re, v.im * dg.re);
    if (ej == ei) o = dg;
    if (ej > ei) o = zero;
    out[e] = o;
  }
}

// The plan's launch, checked: `threads` a block; `group` threads a matrix
// (a power of two up to 32 with rows == group, or the whole block with
// rows == n); row stride ld >= n.
template <typename T>
int launch_chol_inv(const void* s, void* log_det_l, void* linv, int n, int w,
                    int threads, int group, int rows, int ld, void* stream) {
  const bool block = group > 32;
  if (w <= 0 || n <= 0 || ld < n || threads < 1 || threads > 1024 ||
      group < 1 || threads % group != 0)
    return (int)cudaErrorInvalidValue;
  if (block ? (group != threads || rows != n || threads < n)
            : (rows != group || n > group || (group & (group - 1)) != 0 ||
               threads % 32 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      (size_t)(threads / group) * n * ld * sizeof(cplx<T>);
  if (bytes > pauxy::kSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = chol_inv_kernel<T, 0>;
  switch (block ? 0 : group) {
    case 1: kern = chol_inv_kernel<T, 1>; break;
    case 2: kern = chol_inv_kernel<T, 2>; break;
    case 4: kern = chol_inv_kernel<T, 4>; break;
    case 8: kern = chol_inv_kernel<T, 8>; break;
    case 16: kern = chol_inv_kernel<T, 16>; break;
    case 32: kern = chol_inv_kernel<T, 32>; break;
    default: break;
  }
  cudaError_t err = pauxy::allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  const int per = threads / group;
  kern<<<(w + per - 1) / per, threads, bytes, (cudaStream_t)stream>>>(
      static_cast<const cplx<T>*>(s), static_cast<T*>(log_det_l),
      static_cast<cplx<T>*>(linv), n, w, group, rows, ld);
  return (int)cudaGetLastError();
}

}  // namespace

// s and linv [w, n, n], log_det_l [w] real. Each returns the cudaError_t of
// its launch.

extern "C" int pauxy_chol_inv_c64(const void* s, void* log_det_l, void* linv,
                                  int n, int w, int threads, int group,
                                  int rows, int ld, void* stream) {
  return launch_chol_inv<float>(s, log_det_l, linv, n, w, threads, group,
                                rows, ld, stream);
}

extern "C" int pauxy_chol_inv_c128(const void* s, void* log_det_l,
                                   void* linv, int n, int w, int threads,
                                   int group, int rows, int ld,
                                   void* stream) {
  return launch_chol_inv<double>(s, log_det_l, linv, n, w, threads, group,
                                 rows, ld, stream);
}
