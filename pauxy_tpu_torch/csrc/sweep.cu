// Hirsch site sweep: the discrete-HS CPMC two-body update, walker-major.
//
// Replaces the TPU kernel pauxy_tpu/ops/sweep_pallas.py:hirsch_sweep_real
// (kernel body _sweep_kernel). The sweep is sequential over the M lattice
// sites (each site's heat-bath probability uses the Green's function
// updated by every earlier flip) and independent across walkers. Per site
// i and spin s, with trial rows psi_s [M, n_s], walker rows phi_s [w, M,
// n_s] and the maintained inverse overlap S_s^-1 [w, n_s, n_s]
// (S_s = psi_s^T phi_s):
//   q[a]       = sum_b inv[b, a] phi[i, b],  G_ii = sum_a psi[i, a] q[a]
//   p_x        = 0.5 (1 + delta[x, 0] G^a_ii)(1 + delta[x, 1] G^b_ii) wfac[x]
//   x          = r >= max(p_0, 0) / norm, norm = max(p_0, 0) + max(p_1, 0)
//   weight    *= norm, dlog += log(2 p_x)    (alive walkers only)
//   phi[i, :] += vt, vt = delta[x, s] phi[i, :]        (row scaling)
//   inv       -= t1 t2^T / (1 + vt . t1),  t1 = inv psi[i], t2 = inv^T vt
//                                                     (Sherman-Morrison)
// A walker is dead when norm <= 0 or its weight is 0: its weight becomes 0,
// its rows and inverse stay, dlog does not move. Real arithmetic only: the
// caller (propagation/hirsch.py) takes this path only when the whole
// propagation is real (spin decomposition, real hopping, real trial).
//
// What bounds it on the H100: at (M, na, nb) = (16, 7, 7), W = 1024, float,
// the sweep reads and writes 2.4 MB (0.7 us of HBM) and needs ~14 kFLOP a
// walker. What a walker costs is its chain: M sites, each two G_ii, a
// decision and two rank-1 updates, every step needing the last. In one
// thread per walker that chain is ~14k dependent operations, and 1024
// walkers fill 8 of the 132 SMs.
//
// Design. A walker gets a group of G lanes (the next power of two >= max(na,
// nb), at most 32; 64 / G walkers a block), and lane r owns row r of both
// spins' S^-1, kept in shared memory with the odd row stride n | 1 (the
// inverses are scratch: read once, never written back). Both contractions
// of Sherman-Morrison are then lane-local shared-memory reads, conflict-free
// across the group: t1 (and the update) read lane r's row, q and t2 read
// column r, so the TPU kernel's transposed copy (sweep_pallas.py:66-73) is
// not kept. Every vector lives one element a lane (phi[i, r], psi[i, r],
// q, vt, t1, t2); a lane gathers the others' by __shfl_sync. The sums that
// decide the field, G_ii and 1 + vt . t1, are gathered and added in the
// TPU kernel's sequential order (sweep_pallas.py:76-96) in every lane, so
// every lane holds the same bits and takes the same field without a
// broadcast. Two __syncwarp a site order the column reads before the row
// updates and those before the next site. G is a template parameter and
// every loop over a spin's electrons runs to G unrolled, so a phase issues
// its shuffles and shared loads together instead of one round trip at a
// time, and the update scales by one reciprocal of 1 + vt . t1 a spin:
// runtime-length loops and an IEEE divide an entry (a slow path on a dead
// walker's zero numerators) measured 3-6 times as long on the card
// (PERF.md). The walker-major inputs are read as they come, through their
// strides (phi may be the real part of a complex tensor); each site's row
// of phi, psi and the draw are loaded one site ahead; phi' and the fields
// are written walker-major.
//
// float and double are both instantiated; the TPU kernel computed in the
// input's real type, and so does this one.

#include "gauss_jordan.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 8;  // row entries a lane updates at once

// The ten inputs and their strides in elements.
template <typename T>
struct SweepIn {
  const T* psia;
  const T* psib;
  const T* delta;
  const T* wfac;
  const T* phia;
  const T* phib;
  const T* inva;
  const T* invb;
  const T* rs;
  const T* weight;
  long long psia_s[2], psib_s[2], delta_s[2], wfac_s, phia_s[3], phib_s[3],
      inva_s[3], invb_s[3], rs_s[2], weight_s;
};
constexpr int kStrides = 22;

template <typename T, int G>
__device__ __forceinline__ T gather(T v, int src) {
  return __shfl_sync(kFull, v, src, G);
}

// G lanes a walker (a compile-time power of two, so every loop over a
// spin's n runs to G unrolled: a term past n is multiplied by zero, which
// leaves the ordered sums' bits as they are, and a load past n reads
// entry n - 1).
template <typename T, int G>
__global__ void hirsch_sweep_kernel(const SweepIn<T> in,
                                    T* __restrict__ phia_out,
                                    T* __restrict__ phib_out,
                                    T* __restrict__ weight_out,
                                    T* __restrict__ dlog_out,
                                    int* __restrict__ fields, int m, int na,
                                    int nb, int w, int lda, int ldb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  const int wk = blockIdx.x * (blockDim.x / G) + slot;
  const bool valid = wk < w;  // a ragged walker computes on a copy
  const long long src = valid ? wk : w - 1;
  T* ia = reinterpret_cast<T*>(smem_raw) +
          (size_t)slot * (na * lda + nb * ldb);
  T* ib = ia + na * lda;

  for (int e = r; e < na * na; e += G) {
    const int ei = e / na;
    const int ej = e - ei * na;
    ia[ei * lda + ej] = in.inva[src * in.inva_s[0] + ei * in.inva_s[1] +
                                ej * in.inva_s[2]];
  }
  for (int e = r; e < nb * nb; e += G) {
    const int ei = e / nb;
    const int ej = e - ei * nb;
    ib[ei * ldb + ej] = in.invb[src * in.invb_s[0] + ei * in.invb_s[1] +
                                ej * in.invb_s[2]];
  }
  // Lanes past a spin's n read its last row and store nothing there.
  const int ra = r < na ? r : na - 1;
  const int rb = r < nb ? r : nb - 1;
  const T d00 = in.delta[0];
  const T d01 = in.delta[in.delta_s[1]];
  const T d10 = in.delta[in.delta_s[0]];
  const T d11 = in.delta[in.delta_s[0] + in.delta_s[1]];
  const T wf0 = in.wfac[0];
  const T wf1 = in.wfac[in.wfac_s];
  T wt = in.weight[src * in.weight_s];
  T dl = T(0);
  const T* pa = in.phia + src * in.phia_s[0] + ra * in.phia_s[2];
  const T* pb = in.phib + src * in.phib_s[0] + rb * in.phib_s[2];
  const T* sa = in.psia + ra * in.psia_s[1];
  const T* sb = in.psib + rb * in.psib_s[1];
  const T* ur = in.rs + src * in.rs_s[1];
  T xa = pa[0], xb = pb[0], ya = sa[0], yb = sb[0], u = ur[0];
  T* oa = phia_out + (size_t)wk * m * na + r;
  T* ob = phib_out + (size_t)wk * m * nb + r;
  __syncwarp();

  for (int i = 0; i < m; ++i) {
    const T fa = xa, fb = xb, psa = ya, psb = yb, ui = u;
    const long long i1 = i + 1 < m ? i + 1 : i;  // the next site's loads
    xa = pa[i1 * in.phia_s[1]];
    xb = pb[i1 * in.phib_s[1]];
    ya = sa[i1 * in.psia_s[0]];
    yb = sb[i1 * in.psib_s[0]];
    u = ur[i1 * in.rs_s[0]];

    // G_ii: lane r forms q[r] from column r, then every lane adds
    // psi[a] q[a] in order a = 0, 1, ... (sweep_pallas.py:76-84).
    T qa = T(0), qb = T(0);
#pragma unroll
    for (int b = 0; b < G; ++b) {
      const T xa_b = gather<T, G>(fa, b), xb_b = gather<T, G>(fb, b);
      const T ca = ia[(b < na ? b : na - 1) * lda + ra];
      const T cb = ib[(b < nb ? b : nb - 1) * ldb + rb];
      qa += (b < na ? ca : T(0)) * xa_b;
      qb += (b < nb ? cb : T(0)) * xb_b;
    }
    const T za = psa * qa, zb = psb * qb;
    T ga = T(0), gb = T(0);
#pragma unroll
    for (int a = 0; a < G; ++a) {
      const T ta = gather<T, G>(za, a), tb = gather<T, G>(zb, a);
      ga += a < na ? ta : T(0);
      gb += a < nb ? tb : T(0);
    }

    // Heat-bath probabilities (sweep_pallas.py:106-119).
    const T p0 = T(0.5) * (T(1) + d00 * ga) * (T(1) + d01 * gb) * wf0;
    const T p1 = T(0.5) * (T(1) + d10 * ga) * (T(1) + d11 * gb) * wf1;
    const T pr0 = p0 > T(0) ? p0 : T(0);
    const T norm = pr0 + (p1 > T(0) ? p1 : T(0));
    const bool alive = norm > T(0) && (wt > T(0) || wt < T(0));
    const T safe = alive ? norm : T(1);
    const bool xi = ui >= pr0 / safe;
    wt = alive ? wt * norm : T(0);
    if (alive) dl += pauxy::dlog(T(2) * (xi ? p1 : p0));
    const T da = alive ? (xi ? d10 : d00) : T(0);
    const T db = alive ? (xi ? d11 : d01) : T(0);
    if (valid && r == 0) fields[(size_t)wk * m + i] = xi ? 1 : 0;

    // Row scaling phi[i] += vt.
    const T vta = fa * da, vtb = fb * db;
    if (valid && r < na) oa[(size_t)i * na] = fa + vta;
    if (valid && r < nb) ob[(size_t)i * nb] = fb + vtb;

    // Sherman-Morrison (sweep_pallas.py:86-98): t1 = inv psi from row r,
    // t2 = inv^T vt from column r, both in order; then 1 + vt . t1 in
    // order in every lane.
    T t1a = T(0), t2a = T(0), t1b = T(0), t2b = T(0);
#pragma unroll
    for (int b = 0; b < G; ++b) {
      const int ba = b < na ? b : na - 1, bb = b < nb ? b : nb - 1;
      const T ka = b < na ? T(1) : T(0), kb = b < nb ? T(1) : T(0);
      t1a += ka * gather<T, G>(psa, b) * ia[ra * lda + ba];
      t2a += ka * gather<T, G>(vta, b) * ia[ba * lda + ra];
      t1b += kb * gather<T, G>(psb, b) * ib[rb * ldb + bb];
      t2b += kb * gather<T, G>(vtb, b) * ib[bb * ldb + rb];
    }
    const T ea = vta * t1a, eb = vtb * t1b;
    T dota = T(0), dotb = T(0);
#pragma unroll
    for (int a = 0; a < G; ++a) {
      const T ta = gather<T, G>(ea, a), tb = gather<T, G>(eb, a);
      dota += a < na ? ta : T(0);
      dotb += a < nb ? tb : T(0);
    }
    // One divide a spin: the update scales t1 t2^T by 1 / (1 + vt . t1).
    const T rda = T(1) / (T(1) + dota), rdb = T(1) / (T(1) + dotb);
    __syncwarp();  // every lane has read the columns
    // kChunk entries of each row at once: their loads, then their stores.
#pragma unroll
    for (int b0 = 0; b0 < G; b0 += kChunk) {
      T va[kChunk], vb[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int b = b0 + c < G ? b0 + c : G - 1;
        const int ba = b < na ? b : na - 1, bb = b < nb ? b : nb - 1;
        va[c] = ia[ra * lda + ba] - t1a * gather<T, G>(t2a, b) * rda;
        vb[c] = ib[rb * ldb + bb] - t1b * gather<T, G>(t2b, b) * rdb;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int b = b0 + c;
        if (r < na && b < na) ia[r * lda + b] = va[c];
        if (r < nb && b < nb) ib[r * ldb + b] = vb[c];
      }
    }
    __syncwarp();  // the rows are updated before the next site reads them
  }
  if (valid && r == 0) {
    weight_out[wk] = wt;
    dlog_out[wk] = dl;
  }
}

// The plan's launch (ops/sweep_cuda.py), checked: G lanes a walker (a power
// of two >= max(na, nb), at most 32), wpb walkers a block, row strides
// lda >= na and ldb >= nb.
template <typename T>
int launch_sweep(const void* const* ptrs, const long long* strides, int m,
                 int na, int nb, int w, int G, int wpb, int lda, int ldb,
                 void* stream) {
  if (w <= 0 || m <= 0 || na <= 0 || nb <= 0 || G < 1 || G > 32 ||
      (G & (G - 1)) != 0 || na > G || nb > G || wpb < 1 ||
      (wpb * G) % 32 != 0 || wpb * G > 1024 || lda < na || ldb < nb)
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      (size_t)wpb * (na * lda + nb * ldb) * sizeof(T);
  if (bytes > pauxy::kSmemMax) return (int)cudaErrorInvalidValue;
  SweepIn<T> in;
  const T** inputs[10] = {&in.psia, &in.psib, &in.delta, &in.wfac, &in.phia,
                          &in.phib, &in.inva, &in.invb, &in.rs, &in.weight};
  for (int k = 0; k < 10; ++k) *inputs[k] = static_cast<const T*>(ptrs[k]);
  long long* dst[kStrides] = {
      &in.psia_s[0],  &in.psia_s[1],  &in.psib_s[0],  &in.psib_s[1],
      &in.delta_s[0], &in.delta_s[1], &in.wfac_s,     &in.phia_s[0],
      &in.phia_s[1],  &in.phia_s[2],  &in.phib_s[0],  &in.phib_s[1],
      &in.phib_s[2],  &in.inva_s[0],  &in.inva_s[1],  &in.inva_s[2],
      &in.invb_s[0],  &in.invb_s[1],  &in.invb_s[2],  &in.rs_s[0],
      &in.rs_s[1],    &in.weight_s};
  for (int k = 0; k < kStrides; ++k) *dst[k] = strides[k];
  auto kern = hirsch_sweep_kernel<T, 32>;
  switch (G) {
    case 1: kern = hirsch_sweep_kernel<T, 1>; break;
    case 2: kern = hirsch_sweep_kernel<T, 2>; break;
    case 4: kern = hirsch_sweep_kernel<T, 4>; break;
    case 8: kern = hirsch_sweep_kernel<T, 8>; break;
    case 16: kern = hirsch_sweep_kernel<T, 16>; break;
    default: break;
  }
  cudaError_t err = pauxy::allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(w + wpb - 1) / wpb, wpb * G, bytes, (cudaStream_t)stream>>>(
      in, static_cast<T*>(const_cast<void*>(ptrs[10])),
      static_cast<T*>(const_cast<void*>(ptrs[11])),
      static_cast<T*>(const_cast<void*>(ptrs[12])),
      static_cast<T*>(const_cast<void*>(ptrs[13])),
      static_cast<int*>(const_cast<void*>(ptrs[14])), m, na, nb, w, lda,
      ldb);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs psia, psib [M, n], delta [2, 2], wfac [2], phia, phib [w, M, n],
// inva, invb [w, n, n], rs [M, w], weight [w], any strides (`strides`:
// kStrides element strides in that order, on the host); outputs phia',
// phib' [w, M, n], weight', dlog [w] and fields [w, M] int32, contiguous.
// Each returns the cudaError_t of its launch.

#define PAUXY_SWEEP_ENTRY(NAME, T)                                            \
  extern "C" int NAME(                                                        \
      const void* psia, const void* psib, const void* delta,                  \
      const void* wfac, const void* phia, const void* phib, const void* inva, \
      const void* invb, const void* rs, const void* weight, void* phia_out,   \
      void* phib_out, void* weight_out, void* dlog_out, void* fields,         \
      const void* strides, int m, int na, int nb, int w, int lanes, int wpb,  \
      int lda, int ldb, void* stream) {                                       \
    const void* ptrs[15] = {psia, psib,     delta,      wfac,     phia,       \
                            phib, inva,     invb,       rs,       weight,     \
                            phia_out, phib_out, weight_out, dlog_out,         \
                            fields};                                          \
    return launch_sweep<T>(ptrs, static_cast<const long long*>(strides), m,   \
                           na, nb, w, lanes, wpb, lda, ldb, stream);          \
  }

PAUXY_SWEEP_ENTRY(pauxy_hirsch_sweep_f32, float)
PAUXY_SWEEP_ENTRY(pauxy_hirsch_sweep_f64, double)
