// The plane-wave force bias: both spins' FFT Coulomb correlations of the
// half-rotated Green's function on one cube in shared memory, and the
// fields written in the epilogue.
//
// Replaces no TPU kernel: the JAX package forms these correlations as plain
// XLA (pauxy_tpu/estimators/local_energy.py:fft_coulomb_terms, matmul DFTs
// in pauxy_tpu/propagation/pw_fft.py:_dft3), with no pallas_call. It was
// added because the port's route (two torch.fft correlation chains, one a
// spin, and a dozen elementwise launches around them) was the largest layer
// of the plane-wave step on the card.
//
// What it computes, for each walker w (ops/pw_force_bias_cuda.py has the
// same function in plain PyTorch):
//
//   U_i(k)  = sum_x th_i(x) e^{+2 pi i k.x / N}    th_i: row i of Ghalf on
//                                                  the cube, both spins
//   Cu(Q)   = sum_k e^{+2 pi i k.Q / N} sum_i T_i(k) U_i(k)
//   out[q]      = f_q (Im s, -Re s),   s = Cu(Q_q) + Cu(-Q_q)
//   out[nq + q] = f_q (Cu(Q_q) - Cu(-Q_q))
//
// T_i the trial's orbital cubes transformed once (fft3 of conj(psi)^T on
// the cube, cached by the propagator), f_q = qfac_q sqrt(dt) / N^3. Cu / N^3
// at Q and -Q are Gkpq and Gpmq summed over both spins (the correlation is
// linear, so one final transform serves both), and the output is
// -sqrt(dt) [i (t1 + t2), -(t1 - t2)] with t = qfac G, the force bias
// before its unit-modulus clamp.
//
// What bounds it on the H100: at the UEG cells' shape (N = 17, M = 257,
// n = 7 + 7, nq = 2108, w = 1024) the data are Ghalf (2 x 14.7 MB) in and
// the fields (34.5 MB) out, 0.02 ms at 3.35 TB/s; the transforms, as direct
// DFTs pruned to the basis's support, are ~10 MFLOP a walker, 0.16 ms at
// 67 TFLOP/s in float32; paired as below, and with the final transform's
// full lines counted at an FFT's 5 N log2 N, 3.2 GFLOP at 1024 walkers,
// 0.048 ms (chip_smoke.pw_force_bias_work). So it is bound by operations
// and by the shared memory they stream through, and the design keeps both
// small:
//
// - One block a walker, the walker's cubes never in device memory: the
//   accumulated cube Acc [N][N][N] and one orbital's partial transform
//   W [S][N][N] (S = (N + 1) / 2, the support |n| <= (N - 1) / 4 of the
//   basis on each axis) in shared memory, 61.6 KB in complex64 at N = 17
//   (three blocks an SM).
// - Each 3-D transform is three passes of N-point DFTs along lines, a
//   thread a line, the line in registers. A DFT pairs inputs j and N - j
//   (y_k and y_{N-k} share the cosine and sine sums), about a third of the
//   operations of a direct DFT; its twiddles are kernel parameters
//   (constant bank operands, no loads). An orbital's transform is pruned:
//   pass 1 runs S^2 lines of S inputs, read straight from Ghalf through the
//   support map (no scatter, no zeroing), pass 2 S N lines of S inputs,
//   pass 3 N^2 lines of S inputs, whose outputs are multiplied by the
//   trial's cube (from L2) and added into Acc at once, so no transformed
//   orbital cube is stored. The final transform runs three full passes over
//   Acc in place, then the epilogue reads Acc at the q vectors' points.
// - Line strides are N (odd) complex values or 1, so the threads of a warp
//   fall in distinct banks in every pass.
//
// Arithmetic stays in the working type (float FMA for complex64, double for
// complex128); sums run in another order than torch.fft's, so the kernel
// agrees with its plain version to rounding (tests: 1e-4 / 1e-10 of
// max|out|). The mesh N is a template parameter (the DFTs unroll); the
// instantiated meshes are the UEG's 4 nmax + 1 cubes whose working set fits
// a block (ops/pw_force_bias_cuda.fits; N <= 25 complex64, N <= 21
// complex128); a larger cube takes the plain version (torch.fft) on the
// card.

#include <cmath>

#include "gauss_jordan.cuh"

using pauxy::cplx;

namespace {

// cos and sin of 2 pi m / N for m = 0 .. (N - 1) / 2.
template <typename T, int N>
struct Twiddles {
  T c[(N - 1) / 2 + 1];
  T s[(N - 1) / 2 + 1];
};

template <int N>
struct Mesh {
  static constexpr int H = (N - 1) / 2;  // pairs of a full line
  static constexpr int P = (N - 1) / 4;  // pairs of a line of the support
  static constexpr int S = 2 * P + 1;    // the support's width
  static constexpr int NN = N * N;
  static constexpr int NG = N * N * N;
  static constexpr int THREADS = (NN + 31) / 32 * 32;
};

template <typename T, int N>
constexpr size_t smem_bytes() {
  return (size_t)(Mesh<N>::NG + Mesh<N>::S * Mesh<N>::NN) * sizeof(cplx<T>) +
         (size_t)Mesh<N>::S * Mesh<N>::S * Mesh<N>::S * sizeof(int);
}

// Blocks an SM is meant to hold (the register budget's target): as many as
// the shared memory allows, at most 4 and at most 2048 threads.
template <typename T, int N>
struct Occupancy {
  static constexpr int by_smem = (int)(pauxy::kSmemMax / smem_bytes<T, N>());
  static constexpr int by_threads = 2048 / Mesh<N>::THREADS;
  static constexpr int b = by_smem < by_threads ? by_smem : by_threads;
  static constexpr int BLOCKS = b < 1 ? 1 : (b > 4 ? 4 : b);
};

// FFT index of the signed frequency j, |j| < N.
template <int N>
__device__ __forceinline__ int fidx(int j) {
  return j < 0 ? j + N : j;
}

// y_k = sum_{|j| <= Q} x_j e^{+2 pi i j k / N} for k = 0 .. N - 1, from the
// 2 Q + 1 inputs ld(j) (signed frequencies; every load is made before any
// store, so a line may be transformed in place), each output handed to
// st(k, y_k) in FFT order. With s_j = x_j + x_{-j}, d_j = x_j - x_{-j}:
// y_{+-k} = x_0 + sum_j s_j cos(2 pi jk / N) +- i sum_j d_j sin(2 pi jk / N).
template <typename T, int N, int Q, class Load, class Store>
__device__ __forceinline__ void dft_line(const Twiddles<T, N>& tw, Load ld,
                                         Store st) {
  constexpr int H = Mesh<N>::H;
  const cplx<T> x0 = ld(0);
  T sr[Q + 1], si[Q + 1], dr[Q + 1], di[Q + 1];
#pragma unroll
  for (int j = 1; j <= Q; ++j) {
    const cplx<T> a = ld(j);
    const cplx<T> b = ld(-j);
    sr[j] = a.re + b.re;
    si[j] = a.im + b.im;
    dr[j] = a.re - b.re;
    di[j] = a.im - b.im;
  }
  cplx<T> y0 = x0;
#pragma unroll
  for (int j = 1; j <= Q; ++j) {
    y0.re += sr[j];
    y0.im += si[j];
  }
  st(0, y0);
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    T ar = x0.re, ai = x0.im, br = 0, bi = 0;
#pragma unroll
    for (int j = 1; j <= Q; ++j) {
      const int m = (j * k) % N;
      const int mm = m <= H ? m : N - m;
      const T c = tw.c[mm];
      const T s = m <= H ? tw.s[mm] : -tw.s[mm];
      ar += sr[j] * c;
      ai += si[j] * c;
      br += dr[j] * s;
      bi += di[j] * s;
    }
    st(k, cplx<T>{ar - bi, ai + br});
    st(N - k, cplx<T>{ar + bi, ai - br});
  }
}

// One block a walker. gha [w, na, M] and ghb [w, nb, M] through their
// (walker, row) strides in elements, rows contiguous; ctf [na + nb, N^3]
// the trial's transformed cubes; box [S^3] the basis index at each point of
// the support (signed coordinates + P, x slowest), -1 off the basis; qidx
// [2, nq] the flat cube index of Q_q and of -Q_q; fac [nq]; out [w, 2 nq].
template <typename T, int N>
__global__ void __launch_bounds__(Mesh<N>::THREADS, Occupancy<T, N>::BLOCKS)
    pw_force_bias_kernel(const cplx<T>* __restrict__ gha,
                         const cplx<T>* __restrict__ ghb,
                         const cplx<T>* __restrict__ ctf,
                         const int* __restrict__ box,
                         const int* __restrict__ qidx,
                         const T* __restrict__ fac, cplx<T>* __restrict__ out,
                         int na, int nb, long long saw, long long sar,
                         long long sbw, long long sbr, int nq,
                         const __grid_constant__ Twiddles<T, N> tw) {
  using G = Mesh<N>;
  constexpr int P = G::P, S = G::S, NN = G::NN, NG = G::NG, H = G::H;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* acc = reinterpret_cast<cplx<T>*>(smem_raw);  // [N][N][N]
  cplx<T>* work = acc + NG;                             // [S][N][N]
  int* map = reinterpret_cast<int*>(work + S * NN);     // [S][S][S]
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long wk = blockIdx.x;
  for (int i = tid; i < S * S * S; i += nt) map[i] = box[i];
  for (int i = tid; i < NG; i += nt) acc[i] = cplx<T>{0, 0};
  __syncthreads();

  for (int i = 0; i < na + nb; ++i) {
    const cplx<T>* row =
        i < na ? gha + wk * saw + i * sar : ghb + wk * sbw + (i - na) * sbr;
    const cplx<T>* trial = ctf + (long long)i * NG;
    // Pass 1, along z: the S^2 lines (x, y) of the support, S inputs each
    // from the basis, all N outputs into W[x][y][:].
    for (int l = tid; l < S * S; l += nt) {
      const int sx = l / S, sy = l - sx * S;
      const int* mp = map + l * S + P;
      cplx<T>* dst = work + (sx * N + fidx<N>(sy - P)) * N;
      dft_line<T, N, P>(
          tw,
          [&](int j) {
            const int g = mp[j];
            return g >= 0 ? row[g] : cplx<T>{0, 0};
          },
          [&](int k, cplx<T> v) { dst[k] = v; });
    }
    __syncthreads();
    // Pass 2, along y: the S N lines (x, z), in place.
    for (int l = tid; l < S * N; l += nt) {
      const int sx = l / N, z = l - sx * N;
      cplx<T>* base = work + sx * NN + z;
      dft_line<T, N, P>(
          tw, [&](int j) { return base[fidx<N>(j) * N]; },
          [&](int k, cplx<T> v) { base[k * N] = v; });
    }
    __syncthreads();
    // Pass 3, along x: the N^2 lines (y, z); each output times the trial's
    // cube, added into Acc.
    for (int l = tid; l < NN; l += nt) {
      const cplx<T>* base = work + P * NN + l;
      dft_line<T, N, P>(
          tw, [&](int j) { return base[j * NN]; },
          [&](int k, cplx<T> v) {
            const cplx<T> t = trial[k * NN + l];
            cplx<T>& a = acc[k * NN + l];
            a.re += t.re * v.re - t.im * v.im;
            a.im += t.re * v.im + t.im * v.re;
          });
    }
    __syncthreads();
  }

  // The final transform of Acc, in place: along z, y, then x.
  for (int l = tid; l < NN; l += nt) {
    cplx<T>* base = acc + l * N;
    dft_line<T, N, H>(
        tw, [&](int j) { return base[fidx<N>(j)]; },
        [&](int k, cplx<T> v) { base[k] = v; });
  }
  __syncthreads();
  for (int l = tid; l < NN; l += nt) {
    const int x = l / N, z = l - x * N;
    cplx<T>* base = acc + x * NN + z;
    dft_line<T, N, H>(
        tw, [&](int j) { return base[fidx<N>(j) * N]; },
        [&](int k, cplx<T> v) { base[k * N] = v; });
  }
  __syncthreads();
  for (int l = tid; l < NN; l += nt) {
    cplx<T>* base = acc + l;
    dft_line<T, N, H>(
        tw, [&](int j) { return base[fidx<N>(j) * NN]; },
        [&](int k, cplx<T> v) { base[k * NN] = v; });
  }
  __syncthreads();

  // Epilogue: the fields at the q vectors.
  cplx<T>* o = out + wk * 2 * nq;
  for (int q = tid; q < nq; q += nt) {
    const cplx<T> a = acc[qidx[q]];
    const cplx<T> b = acc[qidx[nq + q]];
    const T f = fac[q];
    o[q] = cplx<T>{f * (a.im + b.im), -f * (a.re + b.re)};
    o[nq + q] = cplx<T>{f * (a.re - b.re), f * (a.im - b.im)};
  }
}

template <typename T, int N>
int launch_mesh(const void* gha, const void* ghb, const void* ctf,
                const void* box, const void* qidx, const void* fac, void* out,
                int w, int na, int nb, long long saw, long long sar,
                long long sbw, long long sbr, int nq, void* stream) {
  constexpr size_t bytes = smem_bytes<T, N>();
  if (bytes > pauxy::kSmemMax) return (int)cudaErrorInvalidValue;
  Twiddles<T, N> tw;
  const double two_pi = 6.283185307179586476925286766559;
  for (int m = 0; m <= Mesh<N>::H; ++m) {
    tw.c[m] = (T)std::cos(two_pi * m / N);
    tw.s[m] = (T)std::sin(two_pi * m / N);
  }
  cudaError_t err = pauxy::allow_smem(pw_force_bias_kernel<T, N>, bytes);
  if (err != cudaSuccess) return (int)err;
  pw_force_bias_kernel<T, N>
      <<<(unsigned)w, Mesh<N>::THREADS, bytes, (cudaStream_t)stream>>>(
          static_cast<const cplx<T>*>(gha), static_cast<const cplx<T>*>(ghb),
          static_cast<const cplx<T>*>(ctf), static_cast<const int*>(box),
          static_cast<const int*>(qidx), static_cast<const T*>(fac),
          static_cast<cplx<T>*>(out), na, nb, saw, sar, sbw, sbr, nq, tw);
  return (int)cudaGetLastError();
}

// ngrid: the cube's edge N, one of the instantiated meshes (5, 9, 13, 17,
// 21, and 25 in complex64 only); another N is refused without a launch.
template <typename T>
int launch(const void* gha, const void* ghb, const void* ctf, const void* box,
           const void* qidx, const void* fac, void* out, int w, int na,
           int nb, long long saw, long long sar, long long sbw, long long sbr,
           int nq, int ngrid, void* stream) {
  if (w <= 0 || na < 0 || nb < 0 || nq < 0) return (int)cudaErrorInvalidValue;
#define PAUXY_PW_MESH(NV)                                                   \
  case NV:                                                                  \
    return launch_mesh<T, NV>(gha, ghb, ctf, box, qidx, fac, out, w, na, nb, \
                              saw, sar, sbw, sbr, nq, stream);
  switch (ngrid) {
    PAUXY_PW_MESH(5)
    PAUXY_PW_MESH(9)
    PAUXY_PW_MESH(13)
    PAUXY_PW_MESH(17)
    PAUXY_PW_MESH(21)
    case 25:
      if constexpr (sizeof(T) == 4) {
        return launch_mesh<T, 25>(gha, ghb, ctf, box, qidx, fac, out, w, na,
                                  nb, saw, sar, sbw, sbr, nq, stream);
      }
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAUXY_PW_MESH
}

}  // namespace

extern "C" int pauxy_pw_force_bias_c64(const void* gha, const void* ghb,
                                       const void* ctf, const void* box,
                                       const void* qidx, const void* fac,
                                       void* out, int w, int na, int nb,
                                       long long saw, long long sar,
                                       long long sbw, long long sbr, int nq,
                                       int ngrid, void* stream) {
  return launch<float>(gha, ghb, ctf, box, qidx, fac, out, w, na, nb, saw,
                       sar, sbw, sbr, nq, ngrid, stream);
}

extern "C" int pauxy_pw_force_bias_c128(const void* gha, const void* ghb,
                                        const void* ctf, const void* box,
                                        const void* qidx, const void* fac,
                                        void* out, int w, int na, int nb,
                                        long long saw, long long sar,
                                        long long sbw, long long sbr, int nq,
                                        int ngrid, void* stream) {
  return launch<double>(gha, ghb, ctf, box, qidx, fac, out, w, na, nb, saw,
                        sar, sbw, sbr, nq, ngrid, stream);
}
