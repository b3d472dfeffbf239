// Batched column-pivoted complex Householder QR: a[:, perm] = q r.
//
// Replaces the TPU kernel pauxy_tpu/ops/cpqr_pallas.py:cpqr_lanes (factor
// pass _factor_kernel, form-Q pass _formq_kernel). Input a [B, m, m]
// complex (row-major, PyTorch's layout); outputs q [B, m, m] unitary, r
// [B, m, m] upper triangular with exact zeros below the diagonal, and perm
// [B, m] (int64) such that column j of a[:, perm] is column perm[j] of a.
// The diagonal follows the LAPACK phase choice beta = -(alpha/|alpha|)
// ||x|| (cpqr_pallas.py:129-135), so tau = 1 + |alpha|/||x|| is real and
// every reflector H = I - tau v v^H (v[k] = 1) is Hermitian and unitary; a
// zero trailing column gives tau = 0, beta = 0 and no update. The pivot is
// the largest trailing column norm, the lowest index on ties
// (cpqr_pallas.py:101-105); every sum runs in a fixed order, so the same
// input gives the same bits.
//
// What bounds it on the H100. At the thermal UEG shape (B, m) = (512, 93)
// the function needs 4.46 GFLOP (per matrix, the factor's trailing dot
// products and updates, 16 (m-k)^2 a step, and form-Q's 16 (m-k) per
// reflector and column: 2.23 + 2.23 GFLOP over the batch): 0.0666 ms at
// 67 TFLOP/s, against 0.0318 ms (complex64) and 0.0636 ms (complex128) for
// the bytes, a read once and q, r written once. But a matrix's m column
// steps are a chain: step k+1's pivot needs every norm of step k, so what
// bounds a block is the latency of its steps, each a few dependent
// shared-memory round trips and butterflies, and what bounds the card is
// how many blocks it holds at once: two an SM at m = 93 in complex64 (77 KB
// each), one in complex128 (153 KB), so 512 matrices are two and four
// waves. At (64, 9), the thermal Hubbard shape, the bound is 0.00004 ms
// (bytes) and the call is nine short steps: launch latency.
//
// Design. A team of threads owns one matrix in shared memory,
// column-major with an odd leading dimension (ld = m | 1, so a warp that
// walks a row across columns hits 32 different banks):
//  * the block route (m > 32): a 256-thread block per matrix, a column to
//    a group of 8 lanes, 3 columns a group's pass (one pass a step up to
//    m = 97), a lane's first 4 rows of them held in registers from the dot
//    product to the update; the pair of groups in a half-warp takes
//    columns 8 apart, so their reads of an odd-strided matrix use
//    disjoint banks;
//  * the warp route (m <= 32): a warp per matrix, four matrices a block
//    (the launcher masks the ragged last block), 4 lanes a column, and
//    __syncwarp in place of __syncthreads. (64, 9) is 16 blocks.
// The launcher picks the route from m alone. Factor, two barriers a
// column step:
//  1. the pivot: each warp left its largest new column norm and its
//     column at the end of the last step, so every warp reduces those
//     eight pairs itself (a fixed-order butterfly, the lowest column on
//     ties) and needs no barrier; every thread forms the step's
//     Householder scalars from the pivot's norm and its row-k entry; the
//     threads swap columns k and p row by row and write v below the
//     diagonal and into a vector of its own;
//  2. the trailing update: rows strided over a column's lanes, w_j = tau
//     v^H a_j by a fixed-order butterfly, a_j -= v w_j, and in the same
//     pass the exact norm of a_j below row k for the next pivot (the TPU
//     kernel's always-recompute rule, cpqr_pallas.py:36-40: no
//     downdating, so no cancellation and no refresh; it costs two FMAs an
//     updated entry, in registers, and the same pass folds the next
//     step's argmax over the warp's columns). Row k of the pivot column is
//     carried by the one lane that owns it, so step 1 never waits for it.
// Every load in these loops is unconditional (a row or column past the
// matrix reads a valid one and is not kept): a guarded load made the
// compiler branch around each one, and each then waited for its own
// result.
// Form-Q, in the same block right after the factor and in place: Q = H_0
// ... H_{m-1} I is accumulated backwards in panels of kNb = 8 reflectors,
// each applied as the compact-WY block I - V T V^H (T by LAPACK's xLARFT
// recurrence) to the trailing block Q[k0:, k0:], which is all that differs
// from I. The panel's own columns and rows of the array still hold V and R;
// they are read as the identity, so Q overwrites V panel by panel with no
// second m x m array and no round trip of V through device memory. One
// route serves every m up to the cap, so there is no two-pass form-Q. A
// panel is four barriers: X = V^H [V | Q] (the Gram matrix for T and W =
// V^H Q; up to 8 lanes a column, a butterfly at the end), T (a lane a row,
// in registers), W <- T W with each thread loading its row of V into
// registers, and Q -= V W, each output a thread's own.
//
// Types: complex64 computes in float, complex128 in double. Real input is
// passed in as complex with zero imaginary parts by the wrapper.

#include "gauss_jordan.cuh"

using pauxy::cplx;

namespace {

constexpr int kNb = 8;             // form-Q panel width
constexpr int kBlockThreads = 256;  // block route: one matrix a block
constexpr int kBlockGroup = 8;      // lanes per column, block route
constexpr int kBlockRc = 3;         // columns a group updates a pass
constexpr int kBlockRm = 4;         // rows a lane keeps in registers a pass
constexpr int kWarpTeams = 4;       // warp route: matrices a block
constexpr int kWarpGroup = 4;       // lanes per column, warp route
constexpr int kWarpRc = 2;          // columns a group updates a pass
constexpr int kWarpRm = 8;          // all of a lane's rows at m <= 32
constexpr int kWarpMaxM = 32;       // largest m of the warp route
constexpr int kLoad = 8;            // device-memory loads in flight a thread

template <typename T>
struct Tiny;
template <>
struct Tiny<float> {
  // The TPU kernel's degenerate-column threshold on ||x||.
  static __device__ __forceinline__ float v() { return 1e-30f; }
};
template <>
struct Tiny<double> {
  static __device__ __forceinline__ double v() { return 1e-150; }
};

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T abs2(cplx<T> z) {
  return z.re * z.re + z.im * z.im;
}

template <typename T>
__device__ __forceinline__ cplx<T> mk(T re, T im) {
  cplx<T> z;
  z.re = re;
  z.im = im;
  return z;
}

// acc += conj(x) y
template <typename T>
__device__ __forceinline__ void cmac_conj(cplx<T>& acc, cplx<T> x,
                                          cplx<T> y) {
  acc.re += x.re * y.re + x.im * y.im;
  acc.im += x.re * y.im - x.im * y.re;
}

// acc += x y
template <typename T>
__device__ __forceinline__ void cmac(cplx<T>& acc, cplx<T> x, cplx<T> y) {
  acc.re += x.re * y.re - x.im * y.im;
  acc.im += x.re * y.im + x.im * y.re;
}

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// One team's shared memory, byte offsets from its base (ops/cpqr_cuda.py
// smem_bytes mirrors it): the matrix a [m][ld] column-major; w [kNb][m]
// (form-Q's W; in the factor the vector v [m] and the warps' pivot
// pairs); the
// Gram matrix g and T [kNb][kNb]; tau [m]; perm [m].
struct Layout {
  int ld;
  size_t w, g, t, tau, perm, bytes;
};

template <typename T>
__host__ __device__ Layout layout(int m) {
  const size_t c = sizeof(cplx<T>);
  Layout L;
  L.ld = m | 1;
  L.w = round16((size_t)m * L.ld * c);
  L.g = L.w + round16((size_t)kNb * m * c);
  L.t = L.g + kNb * kNb * c;
  L.tau = L.t + kNb * kNb * c;
  L.perm = L.tau + round16((size_t)m * sizeof(T));
  L.bytes = L.perm + round16((size_t)m * sizeof(int));
  return L;
}

template <int NT>
__device__ __forceinline__ void team_sync() {
  if (NT == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Sum over the G aligned lanes of a group, a butterfly: every lane ends
// with the same bits (a + b == b + a).
template <int G, typename V>
__device__ __forceinline__ V group_sum(V x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Merge the (largest norm, its column) pairs of lanes off apart: the larger
// norm, the lower column on ties.
template <typename T>
__device__ __forceinline__ void argmax_merge(T& best, int& idx, int off) {
  const T ob = __shfl_xor_sync(0xffffffffu, best, off);
  const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
  if (ob > best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
}

// The factor. a holds the matrix, column-major with stride ld; on return
// R on and above the diagonal, v below it (v[k] = 1 implied), tau[k] and
// perm[k] the pivots' original columns.
template <typename T, int NT, int G, int kRc, int RM>
__device__ void factor(cplx<T>* a, int ld, cplx<T>* vb, T* wbv, int* wbi,
                       T* tau, int* perm, int m, int tid) {
  constexpr int NG = NT / G;
  constexpr int NW = NT / 32;
  const int lane = tid % G;
  const int wl = tid & 31;
  // The group's column offset. With 8 lanes a column in complex64, the two
  // groups of a half-warp take columns 8 apart: 16 ld words, so for any odd
  // ld their 8-byte reads fall in disjoint banks (adjacent columns would
  // collide; complex128's 16-byte reads never do).
  int grp = tid / G;
  if (G == 8 && NG == 32 && sizeof(T) == 4) {
    const int h = grp >> 1;
    grp = 16 * (h >> 3) + (h & 7) + 8 * (grp & 1);
  }
  // Each warp's largest column norm and its column (the lowest on ties),
  // from the groups' exact norms: the pivot search is then a reduction of
  // NW pairs, folded into the pass that computes the norms.
  T lbest = T(-1);
  int lidx = m;
  for (int j0 = 0; j0 < m; j0 += NG) {
    const int j = j0 + grp;
    T s = T(0);
    if (j < m)
      for (int i = lane; i < m; i += G) s += abs2(a[j * ld + i]);
    s = group_sum<G>(s);
    if (j < m && s > lbest) {
      lbest = s;
      lidx = j;
    }
  }
  for (int off = G; off < 32; off <<= 1) argmax_merge(lbest, lidx, off);
  if (wl == 0) {
    wbv[tid / 32] = lbest;
    wbi[tid / 32] = lidx;
  }
  for (int j = tid; j < m; j += NT) perm[j] = j;
  team_sync<NT>();

  for (int k = 0; k < m; ++k) {
    // ---- 1. pivot (each warp alike), scalars, swap and v ----------------
    T best = wbv[wl % NW];
    int idx = wbi[wl % NW];
#pragma unroll
    for (int off = NW / 2; off > 0; off >>= 1) argmax_merge(best, idx, off);
    const int p = idx < m ? idx : k;
    // m <= NT, so a thread has one row at most: its entries of columns k
    // and p are read first, and the scalars' chain overlaps the loads.
    const int i = tid < m ? tid : k;
    const cplx<T> xk = a[k * ld + i];
    const cplx<T> xp = a[p * ld + i];
    const cplx<T> alpha = a[p * ld + k];
    const T anorm = dsqrt(idx < m ? best : T(0));
    const T aabs = dsqrt(abs2(alpha));
    const bool degen = anorm <= Tiny<T>::v();
    const T raabs = T(1) / aabs;
    const bool unit = aabs > Tiny<T>::v();
    const T sgr = unit ? alpha.re * raabs : T(1);
    const T sgi = unit ? alpha.im * raabs : T(0);
    const T betr = degen ? T(0) : -sgr * anorm;
    const T beti = degen ? T(0) : -sgi * anorm;
    // v = x / (alpha - beta), v[k] = 1; tau = 1 + |alpha| / ||x||.
    const T dr = alpha.re - betr;
    const T di = alpha.im - beti;
    const T dden = dr * dr + di * di;
    const T rden = T(1) / dden;
    const T ir = degen ? T(0) : dr * rden;
    const T ii = degen ? T(0) : -di * rden;
    const T tk = degen ? T(0) : T(1) + aabs / anorm;
    // Row k stays as it is until step 2: its entry of column p is alpha,
    // which every thread reads above, and beta goes to a[k][k] only after
    // the barrier.
    if (tid < m && i != k) {
      if (i < k) {
        a[k * ld + i] = xp;
        a[p * ld + i] = xk;
      } else {
        const cplx<T> v = mk(xp.re * ir - xp.im * ii, xp.re * ii + xp.im * ir);
        a[k * ld + i] = v;
        vb[i] = v;
        if (p != k) a[p * ld + i] = xk;
      }
    }
    if (tid == NT - 1) {  // no row of its own on the block route
      vb[k] = mk(T(1), T(0));
      tau[k] = tk;
      const int t = perm[k];
      perm[k] = perm[p];
      perm[p] = t;
    }
    team_sync<NT>();
    if (p == k && tid == 0) a[k * ld + k] = mk(betr, beti);
    // ---- 2. trailing update and the next step's exact norms ------------
    // Column p's row k is still column k's old row k (a[k][k]): the lane
    // that owns row k of column p reads it there, writes the update to
    // a[k][p] and then beta to a[k][k]. A group takes kRc columns a pass,
    // their loads and reductions interleaved; a column past m reads
    // column k (any valid address) and stores nothing. A lane's first RM
    // rows stay in registers from the dot product to the update (a row
    // past m reads row k, with v = 0); rows past those are read again.
    const cplx<T> akk = a[k * ld + k];
    const cplx<T> zero = mk(T(0), T(0));
    lbest = T(-1);
    lidx = m;
    for (int j0 = k + 1 + grp; j0 < m + grp; j0 += NG * kRc) {
      int jc[kRc];
      bool act[kRc];
      cplx<T> w[kRc];
#pragma unroll
      for (int r = 0; r < kRc; ++r) {
        const int j = j0 + r * NG;
        act[r] = j < m;
        jc[r] = act[r] ? j : k;
        w[r] = mk(T(0), T(0));
      }
      cplx<T> xs[RM][kRc];
      cplx<T> vs[RM];
#pragma unroll
      for (int t = 0; t < RM; ++t) {
        const int i = k + lane + t * G;
        const int ic = i < m ? i : k;
        cplx<T> v = vb[ic];
        if (i >= m) v = zero;
        vs[t] = v;
#pragma unroll
        for (int r = 0; r < kRc; ++r) {
          cplx<T> x = a[jc[r] * ld + ic];
          if (ic == k && jc[r] == p) x = akk;
          xs[t][r] = x;
          cmac_conj(w[r], v, x);
        }
      }
      for (int i = k + lane + RM * G; i < m; i += G) {
        const cplx<T> v = vb[i];
#pragma unroll
        for (int r = 0; r < kRc; ++r) {
          const cplx<T> x = a[jc[r] * ld + i];
          cmac_conj(w[r], v, x);
        }
      }
      T s[kRc];
#pragma unroll
      for (int r = 0; r < kRc; ++r) {
        w[r].re = group_sum<G>(w[r].re) * tk;
        w[r].im = group_sum<G>(w[r].im) * tk;
        s[r] = T(0);
      }
#pragma unroll
      for (int t = 0; t < RM; ++t) {
        const int i = k + lane + t * G;
        const cplx<T> v = vs[t];
#pragma unroll
        for (int r = 0; r < kRc; ++r) {
          cplx<T> x = xs[t][r];
          x.re -= v.re * w[r].re - v.im * w[r].im;
          x.im -= v.re * w[r].im + v.im * w[r].re;
          if (i < m && act[r]) a[jc[r] * ld + i] = x;
          if (i < m && i > k) s[r] += abs2(x);
        }
      }
      for (int i = k + lane + RM * G; i < m; i += G) {
        const cplx<T> v = vb[i];
#pragma unroll
        for (int r = 0; r < kRc; ++r) {
          cplx<T> x = a[jc[r] * ld + i];
          x.re -= v.re * w[r].re - v.im * w[r].im;
          x.im -= v.re * w[r].im + v.im * w[r].re;
          if (act[r]) a[jc[r] * ld + i] = x;
          s[r] += abs2(x);
        }
      }
#pragma unroll
      for (int r = 0; r < kRc; ++r) {
        s[r] = group_sum<G>(s[r]);
        if (act[r] && s[r] > lbest) {
          lbest = s[r];
          lidx = jc[r];
        }
        if (lane == 0 && act[r] && jc[r] == p) a[k * ld + k] = mk(betr, beti);
      }
    }
    // Every warp read the previous pairs before the barrier after step 1.
    for (int off = G; off < 32; off <<= 1) argmax_merge(lbest, lidx, off);
    if (wl == 0) {
      wbv[tid / 32] = lbest;
      wbi[tid / 32] = lidx;
    }
    team_sync<NT>();
  }
}

// Form-Q in place from the packed reflectors in a (see the header): on
// return a holds Q, column-major.
template <typename T, int NT>
__device__ void form_q(cplx<T>* a, int ld, cplx<T>* wm, cplx<T>* gm,
                       cplx<T>* tm, const T* tau, int m, int tid) {
  const cplx<T> one = mk(T(1), T(0));
  const cplx<T> zero = mk(T(0), T(0));
  for (int pn = (m - 1) / kNb; pn >= 0; --pn) {
    const int k0 = pn * kNb;
    const int nbp = min(kNb, m - k0);
    const int n = m - k0;
    cplx<T>* A = a + (size_t)k0 * ld + k0;  // A(i, j) = A[j * ld + i]
    // ---- (a) g[r][c] = V_r^H V_c (r < c < nbp); W = V^H Q -------------
    // V(i, r): 0 above row r, 1 at row r, the stored v below; the panel
    // rows and columns of Q are the identity's. H lanes a column (rows
    // strided over them, a butterfly at the end), all kNb rows of W at
    // once; a row r >= nbp reads column nbp - 1 and is not kept, so no
    // load waits on a branch.
    {
      int H = 1;
      while (H < 8 && 2 * H * n <= NT) H *= 2;
      const int c = tid / H;
      const int h = tid % H;
      cplx<T> acc[kNb];
#pragma unroll
      for (int r = 0; r < kNb; ++r) acc[r] = zero;
      if (c < n) {
        // Two rows a trip, all their loads first.
        for (int i = (c < nbp ? c : nbp) + h; i < n; i += 2 * H) {
          const int i1 = i + H < n ? i + H : i;
          cplx<T> x0 = A[c * ld + i];
          cplx<T> x1 = A[c * ld + i1];
          if (c < nbp && i == c) x0 = one;
          if (c < nbp && i1 == c) x1 = one;
          if (i + H >= n) x1 = zero;
          cplx<T> v0[kNb], v1[kNb];
#pragma unroll
          for (int r = 0; r < kNb; ++r) {
            v0[r] = A[min(r, nbp - 1) * ld + i];
            v1[r] = A[min(r, nbp - 1) * ld + i1];
          }
#pragma unroll
          for (int r = 0; r < kNb; ++r) {
            cmac_conj(acc[r], v0[r], x0);
            cmac_conj(acc[r], v1[r], x1);
          }
        }
      }
      for (int off = H / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kNb; ++r) {
          acc[r].re += __shfl_xor_sync(0xffffffffu, acc[r].re, off);
          acc[r].im += __shfl_xor_sync(0xffffffffu, acc[r].im, off);
        }
      }
      if (c < n && h == 0) {
#pragma unroll
        for (int r = 0; r < kNb; ++r) {
          cplx<T> wv = (r < nbp) ? acc[r] : zero;
          if (c < nbp) {
            if (r < c) gm[r * kNb + c] = acc[r];
            // Q's column c is e_c: W[r][c] = conj(V(c, r)).
            const cplx<T> v = A[min(r, nbp - 1) * ld + c];
            wv = (c < r || r >= nbp) ? zero : (c == r) ? one : mk(v.re, -v.im);
          }
          wm[r * m + c] = wv;
        }
      }
    }
    team_sync<NT>();
    // ---- (b) T (xLARFT): T[l][l] = tau_l, T[l][c] = -tau_c sum_s
    // T[l][s] g[s][c]; lane l keeps its row in registers; the rest of T
    // (rows and columns past nbp, and below the diagonal) is zero --------
    if (tid < kNb) {
      const int l = tid;
      cplx<T> trow[kNb];
#pragma unroll
      for (int c = 0; c < kNb; ++c) {
        cplx<T> z = zero;
#pragma unroll
        for (int s = 0; s < c; ++s) {
          cplx<T> t = zero;
          cmac(t, trow[s], gm[s * kNb + c]);
          if (s >= l) {
            z.re += t.re;
            z.im += t.im;
          }
        }
        const T tc = tau[min(k0 + c, m - 1)];
        cplx<T> t = mk(-tc * z.re, -tc * z.im);
        if (c == l) t = mk(tc, T(0));
        if (c < l || c >= nbp) t = zero;
        trow[c] = t;
        tm[l * kNb + c] = t;
      }
    }
    team_sync<NT>();
    // ---- (c) W <- T W by columns; each thread's row of V to registers --
    if (tid < n) {
      cplx<T> y[kNb];
#pragma unroll
      for (int s = 0; s < kNb; ++s) y[s] = wm[s * m + tid];
#pragma unroll
      for (int r = 0; r < kNb; ++r) {
        cplx<T> z = zero;
#pragma unroll
        for (int s = r; s < kNb; ++s) cmac(z, tm[r * kNb + s], y[s]);
        wm[r * m + tid] = z;
      }
    }
    const int nch = NT / n;
    const int i = tid % n;
    const int ch = tid / n;
    cplx<T> vr[kNb];
#pragma unroll
    for (int s = 0; s < kNb; ++s) {
      const cplx<T> v = A[min(s, nbp - 1) * ld + i];
      vr[s] = (i < s || s >= nbp) ? zero : (i == s) ? one : v;
    }
    team_sync<NT>();
    // ---- (d) Q[k0:, k0:] -= V W -----------------------------------------
    if (ch < nch) {
      for (int c = ch; c < n; c += nch) {
        cplx<T> q = (i < nbp || c < nbp) ? ((i == c) ? one : zero)
                                         : A[c * ld + i];
#pragma unroll
        for (int s = 0; s < kNb; ++s) {
          const cplx<T> wv = wm[s * m + c];
          q.re -= vr[s].re * wv.re - vr[s].im * wv.im;
          q.im -= vr[s].re * wv.im + vr[s].im * wv.re;
        }
        A[c * ld + i] = q;
      }
    }
    team_sync<NT>();
  }
}

// TEAMS teams of NT threads a block, a matrix a team; G lanes a column,
// RC columns a group's pass, RM rows a lane held in registers.
template <typename T, int NT, int G, int RC, int RM, int TEAMS>
__global__ void __launch_bounds__(NT * TEAMS)
    cpqr_kernel(const cplx<T>* __restrict__ ain, cplx<T>* __restrict__ qout,
                cplx<T>* __restrict__ rout, long long* __restrict__ permout,
                int b, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int team = threadIdx.x / NT;
  const int tid = threadIdx.x % NT;
  const int mat = blockIdx.x * TEAMS + team;
  if (mat >= b) return;  // the ragged last block: a whole team idles
  const Layout L = layout<T>(m);
  unsigned char* base = smem_raw + (size_t)team * L.bytes;
  cplx<T>* a = reinterpret_cast<cplx<T>*>(base);
  cplx<T>* wm = reinterpret_cast<cplx<T>*>(base + L.w);
  cplx<T>* gm = reinterpret_cast<cplx<T>*>(base + L.g);
  cplx<T>* tm = reinterpret_cast<cplx<T>*>(base + L.t);
  T* tau = reinterpret_cast<T*>(base + L.tau);
  int* perm = reinterpret_cast<int*>(base + L.perm);
  const int ld = L.ld;
  const size_t off = (size_t)mat * m * m;

  // kLoad loads in flight a thread, then their stores.
  for (int e0 = tid; e0 < m * m; e0 += NT * kLoad) {
    cplx<T> x[kLoad];
#pragma unroll
    for (int u = 0; u < kLoad; ++u)
      x[u] = ain[off + min(e0 + u * NT, m * m - 1)];
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      const int e = e0 + u * NT;
      const int i = e / m;
      if (e < m * m) a[(e - i * m) * ld + i] = x[u];
    }
  }
  team_sync<NT>();
  // In the factor, W's space holds v [m] and the warps' pivot pairs.
  T* wbv = reinterpret_cast<T*>(wm + m);
  factor<T, NT, G, RC, RM>(a, ld, wm, wbv,
                           reinterpret_cast<int*>(wbv + NT / 32), tau, perm,
                           m, tid);
  for (int e = tid; e < m * m; e += NT) {
    const int i = e / m;
    const int j = e - i * m;
    rout[off + e] = i <= j ? a[j * ld + i] : mk(T(0), T(0));
  }
  for (int j = tid; j < m; j += NT) permout[(size_t)mat * m + j] = perm[j];
  // form_q's first write to a (its step d) follows two of its barriers.
  form_q<T, NT>(a, ld, wm, gm, tm, tau, m, tid);
  for (int e = tid; e < m * m; e += NT) {
    const int i = e / m;
    qout[off + e] = a[(e - i * m) * ld + i];
  }
}

template <typename T>
int launch_cpqr(const void* a, void* q, void* r, void* perm, int b, int m,
                void* stream) {
  // A thread has at most one row in the factor's row pass (m <= threads).
  if (b <= 0 || m <= 0 || m > kBlockThreads) return (int)cudaErrorInvalidValue;
  const size_t team = layout<T>(m).bytes;
  cudaStream_t s = (cudaStream_t)stream;
  const cplx<T>* ain = static_cast<const cplx<T>*>(a);
  cplx<T>* qo = static_cast<cplx<T>*>(q);
  cplx<T>* ro = static_cast<cplx<T>*>(r);
  long long* po = static_cast<long long*>(perm);
  cudaError_t err;
  if (m <= kWarpMaxM) {
    auto kern = cpqr_kernel<T, 32, kWarpGroup, kWarpRc, kWarpRm, kWarpTeams>;
    const size_t bytes = team * kWarpTeams;
    err = pauxy::allow_smem(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<(b + kWarpTeams - 1) / kWarpTeams, 32 * kWarpTeams, bytes, s>>>(
        ain, qo, ro, po, b, m);
  } else {
    if (team > pauxy::kSmemMax) return (int)cudaErrorInvalidValue;
    auto kern =
        cpqr_kernel<T, kBlockThreads, kBlockGroup, kBlockRc, kBlockRm, 1>;
    err = pauxy::allow_smem(kern, team);
    if (err != cudaSuccess) return (int)err;
    kern<<<b, kBlockThreads, team, s>>>(ain, qo, ro, po, b, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pauxy_cpqr_c64(const void* a, void* q, void* r, void* perm,
                              int b, int m, void* stream) {
  return launch_cpqr<float>(a, q, r, perm, b, m, stream);
}

extern "C" int pauxy_cpqr_c128(const void* a, void* q, void* r, void* perm,
                               int b, int m, void* stream) {
  return launch_cpqr<double>(a, q, r, perm, b, m, stream);
}
