// Hirsch site sweep: the discrete-HS CPMC two-body update, walker axis last.
//
// Replaces the TPU kernel pauxy_tpu/ops/sweep_pallas.py:hirsch_sweep_real
// (kernel body _sweep_kernel). The sweep is sequential over the M lattice
// sites (each site's heat-bath probability uses the Green's function
// updated by every earlier flip) and independent across walkers, so one
// thread owns one walker and runs the whole sweep. Per site i and spin s,
// with trial rows psi_s [M, n_s], walker rows phi_s [M, n_s, W] and the
// maintained inverse overlap S_s^-1 [n_s, n_s, W] (S_s = psi_s^T phi_s):
//   G_ii       = sum_ab psi[i, a] inv[b, a] phi[i, b]   (inv read transposed)
//   p_x        = 0.5 (1 + delta[x, 0] G^a_ii)(1 + delta[x, 1] G^b_ii) wfac[x]
//   x          = r >= max(p_0, 0) / norm, norm = max(p_0, 0) + max(p_1, 0)
//   weight    *= norm, dlog += log(2 p_x)    (alive walkers only)
//   phi[i, :] += delta[x, s] phi[i, :]                (row scaling)
//   inv       -= (inv psi[i])(vt^T inv) / (1 + vt^T inv psi[i]),
//                vt = delta[x, s] phi[i, :]            (Sherman-Morrison)
// A walker is dead when norm <= 0 or its weight is 0: its weight becomes 0,
// its rows and inverse stay, dlog does not move. Real arithmetic only: the
// caller (propagation/hirsch.py) takes this path only when the whole
// propagation is real (spin decomposition, real hopping, real trial).
//
// The TPU kernel keeps a second, transposed inverse so that every
// contraction slices the leading axis of a VMEM block; a GPU thread can
// read any element of its own inverse, so the port keeps one.
//
// What bounds it on the H100: at (M, na, nb) = (16, 7, 7), W = 1024, float,
// the sweep reads and writes 2.4 MB (phi both spins read and written once,
// the inverses and draws read once) and does ~14 kFLOP per walker, all of
// it a chain of dependent multiply-adds in one thread. It is latency- and
// occupancy-bound, not bound by bytes or FLOP/s: 1024 walkers in 8 blocks
// of 128 fill 8 of the 132 SMs. Each walker's two inverses, its two
// current rows and two n-vectors of scratch live in shared memory in the
// [row][col][lane] layout of gauss_jordan.cuh (conflict-free, no
// __syncthreads); phi stays in device memory, one row read and written per
// site and spin, coalesced along W.
//
// float and double are both instantiated; the TPU kernel computed in the
// input's real type, and so does this one.

#include "gauss_jordan.cuh"

namespace {

// G_ii = sum_a psi[a] sum_b inv[b, a] row[b]: the summation order of the
// TPU kernel (sweep_pallas.py:76-84).
template <typename T>
__device__ T gdiag(const T* inv, const T* row, const T* psi, int n,
                   int stride) {
  T g = T(0);
  for (int a = 0; a < n; ++a) {
    T q = T(0);
    for (int b = 0; b < n; ++b) {
      q += inv[(b * n + a) * stride] * row[b * stride];
    }
    g += psi[a] * q;
  }
  return g;
}

// (S + psi vt^T)^-1 by Sherman-Morrison, in the TPU kernel's order
// (sweep_pallas.py:86-98).
template <typename T>
__device__ void sherman_morrison(T* inv, const T* vt, const T* psi, T* t1,
                                 T* t2, int n, int stride) {
  for (int a = 0; a < n; ++a) {
    T acc = T(0);
    for (int b = 0; b < n; ++b) acc += psi[b] * inv[(a * n + b) * stride];
    t1[a * stride] = acc;
  }
  for (int b = 0; b < n; ++b) {
    T acc = T(0);
    for (int a = 0; a < n; ++a) {
      acc += vt[a * stride] * inv[(a * n + b) * stride];
    }
    t2[b * stride] = acc;
  }
  T denom = T(1);
  T dot = T(0);
  for (int a = 0; a < n; ++a) dot += vt[a * stride] * t1[a * stride];
  denom += dot;
  for (int a = 0; a < n; ++a) {
    const T ta = t1[a * stride];
    for (int b = 0; b < n; ++b) {
      inv[(a * n + b) * stride] -= ta * t2[b * stride] / denom;
    }
  }
}

}  // namespace

template <typename T>
__global__ void hirsch_sweep_kernel(
    const T* __restrict__ psia, const T* __restrict__ psib,
    const T* __restrict__ tab, T* __restrict__ phia, T* __restrict__ phib,
    const T* __restrict__ inva, const T* __restrict__ invb,
    const T* __restrict__ rs, T* __restrict__ weight, T* __restrict__ dlog,
    int* __restrict__ fields, int m, int na, int nb, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int stride = blockDim.x;
  const int wk = blockIdx.x * blockDim.x + lane;
  if (wk >= w) return;  // ragged edge of the walker axis
  const int nmax = na > nb ? na : nb;
  T* ia = reinterpret_cast<T*>(smem_raw) + lane;  // [na][na][lane]
  T* ib = ia + na * na * stride;                  // [nb][nb][lane]
  T* rowa = ib + nb * nb * stride;                // [na][lane], then vt
  T* rowb = rowa + na * stride;                   // [nb][lane], then vt
  T* t1 = rowb + nb * stride;                     // [nmax][lane]
  T* t2 = t1 + nmax * stride;                     // [nmax][lane]
  const size_t sw = (size_t)w;

  for (int e = 0; e < na * na; ++e) ia[e * stride] = inva[e * sw + wk];
  for (int e = 0; e < nb * nb; ++e) ib[e * stride] = invb[e * sw + wk];
  const T d00 = tab[0], d01 = tab[1], d10 = tab[2], d11 = tab[3];
  const T wf0 = tab[4], wf1 = tab[5];

  T wt = weight[wk];
  T dl = T(0);
  for (int i = 0; i < m; ++i) {
    T* pa = phia + (size_t)i * na * sw + wk;
    T* pb = phib + (size_t)i * nb * sw + wk;
    for (int a = 0; a < na; ++a) rowa[a * stride] = pa[a * sw];
    for (int b = 0; b < nb; ++b) rowb[b * stride] = pb[b * sw];
    const T ga = gdiag(ia, rowa, psia + i * na, na, stride);
    const T gb = gdiag(ib, rowb, psib + i * nb, nb, stride);
    // Heat-bath probabilities (sweep_pallas.py:106-119).
    const T p0 = T(0.5) * (T(1) + d00 * ga) * (T(1) + d01 * gb) * wf0;
    const T p1 = T(0.5) * (T(1) + d10 * ga) * (T(1) + d11 * gb) * wf1;
    const T pr0 = p0 > T(0) ? p0 : T(0);
    const T norm = pr0 + (p1 > T(0) ? p1 : T(0));
    const bool alive = norm > T(0) && (wt > T(0) || wt < T(0));
    const T safe = alive ? norm : T(1);
    const bool xi = rs[(size_t)i * sw + wk] >= pr0 / safe;
    wt = alive ? wt * norm : T(0);
    if (alive) dl += pauxy::dlog(T(2) * (xi ? p1 : p0));
    const T da = alive ? (xi ? d10 : d00) : T(0);
    const T db = alive ? (xi ? d11 : d01) : T(0);
    // Row scaling phi[i] += vt; the row buffers then hold vt.
    for (int a = 0; a < na; ++a) {
      const T r = rowa[a * stride];
      const T v = r * da;
      pa[a * sw] = r + v;
      rowa[a * stride] = v;
    }
    for (int b = 0; b < nb; ++b) {
      const T r = rowb[b * stride];
      const T v = r * db;
      pb[b * sw] = r + v;
      rowb[b * stride] = v;
    }
    sherman_morrison(ia, rowa, psia + i * na, t1, t2, na, stride);
    sherman_morrison(ib, rowb, psib + i * nb, t1, t2, nb, stride);
    fields[(size_t)i * sw + wk] = xi ? 1 : 0;
  }
  weight[wk] = wt;
  dlog[wk] = dl;
}

template <typename T>
static int launch_sweep(const void* psia, const void* psib, const void* tab,
                        void* phia, void* phib, const void* inva,
                        const void* invb, const void* rs, void* weight,
                        void* dlog, void* fields, int m, int na, int nb,
                        int w, void* stream) {
  if (w <= 0 || m <= 0 || na <= 0 || nb <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nmax = na > nb ? na : nb;
  const size_t per =
      (size_t)(na * na + nb * nb + na + nb + 2 * nmax) * sizeof(T);
  size_t bytes = 0;
  const int wpb = pauxy::walkers_per_block(per, &bytes);
  if (wpb == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = pauxy::allow_smem(hirsch_sweep_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (w + wpb - 1) / wpb;
  hirsch_sweep_kernel<T><<<grid, wpb, bytes, (cudaStream_t)stream>>>(
      static_cast<const T*>(psia), static_cast<const T*>(psib),
      static_cast<const T*>(tab), static_cast<T*>(phia),
      static_cast<T*>(phib), static_cast<const T*>(inva),
      static_cast<const T*>(invb), static_cast<const T*>(rs),
      static_cast<T*>(weight), static_cast<T*>(dlog),
      static_cast<int*>(fields), m, na, nb, w);
  return (int)cudaGetLastError();
}

extern "C" int pauxy_hirsch_sweep_f32(const void* psia, const void* psib,
                                      const void* tab, void* phia,
                                      void* phib, const void* inva,
                                      const void* invb, const void* rs,
                                      void* weight, void* dlog, void* fields,
                                      int m, int na, int nb, int w,
                                      void* stream) {
  return launch_sweep<float>(psia, psib, tab, phia, phib, inva, invb, rs,
                             weight, dlog, fields, m, na, nb, w, stream);
}

extern "C" int pauxy_hirsch_sweep_f64(const void* psia, const void* psib,
                                      const void* tab, void* phia,
                                      void* phib, const void* inva,
                                      const void* invb, const void* rs,
                                      void* weight, void* dlog, void* fields,
                                      int m, int na, int nb, int w,
                                      void* stream) {
  return launch_sweep<double>(psia, psib, tab, phia, phib, inva, invb, rs,
                              weight, dlog, fields, m, na, nb, w, stream);
}
