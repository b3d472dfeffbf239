// Exchange contraction of the Generic local energy:
//   exx[w] = sum_x tr(T_wx T_wx),  T_wx = rchol_x Ghalf_w^T  ([n, n]),
// i.e. sum_{x, i, j} T_wx[i, j] T_wx[j, i], without the [w, X, n, n]
// intermediate the einsum route builds.
//
// Replaces the TPU kernel pauxy_tpu/ops/exx_pallas.py:exx_pallas (kernel
// body _exx_kernel), reached from pauxy_tpu/estimators/local_energy._exx
// when the trial has no exchange supermatrix ((n M)^2 > 2^26) and rchol is
// real. Inputs rchol [X, n, M] real and ghalf [w, n, M] complex, contiguous;
// output exx [w] complex.
//
// What bounds it on the H100: at (X, n, M) = (1024, 42, 228), w = 256, the
// T builds are 4 X n^2 M w = 4.2e11 real FLOPs against 0.06 GB of inputs:
// 6.3 ms at 67 TFLOP/s (float32 outside the tensor cores), FLOP-bound.
//
// Design: the T builds of all walkers are one real GEMM, rows (x, i) of
// rchol viewed as [X n, M], columns (w, j) of Ghalf (each a complex pair),
// depth M, with the transpose-trace fused into its epilogue, so T never
// reaches device memory and each rchol_x is read once per group of walkers
// (the TPU kernel's batching of walkers into one wide dot), not once per
// walker. The index range 0..n-1 is cut into nb blocks of B <= 48 rows; a
// block of threads takes a group of XG Cholesky vectors, a group of WG
// walkers and a pair of index blocks I <= J, and builds T[I, J] and, for
// I < J, T[J, I] (off-diagonal pairs weigh 2, as the pair (j, i) gives the
// same product). Four launches per call:
//   1. pack rchol into panels [x-group][I][k][XG B] (k-major, zero-padded
//      to the tile and to M rounded up to KS), through a shared-memory
//      transpose;
//   2. pack Ghalf the same way into [w-group][J][k][WG B] complex;
//   3. the GEMM: each panel's k-slabs stream through a ring of NS stages
//      filled by cp.async (16-byte copies; the packing makes a slab one
//      contiguous run), one barrier per slab; each thread owns a TM x TN
//      register tile (rows and columns in 16-byte pieces spread so that the
//      threads of a warp read neighbouring words; per k-step 2 + 2 16-byte
//      shared loads for 2 TM TN real-by-complex multiply-adds); the tile is
//      staged in shared memory (T[I, J] in its own region, T[J, I] over the
//      ring), each warp forms sum_ij T_ij T_ji of one (x, w) block in
//      double, and the XG partials of a walker are summed in a fixed order
//      into a scratch [x-group, pair, w];
//   4. per walker, the scratch summed in a fixed order in double.
// No atomics: every run gives the same bits.
//
// Budget (ptxas's report sits beside the library as .log): float
// TM x TN = 8 x 4, KS = 16; double 4 x 4, KS = 8; NS = 3; at most 512
// threads a block (128 registers a thread; the accumulators take 64).
// ops/exx_cuda.plan chooses the tile (the used share of its rows and
// columns times how evenly its warps spread over the SM's four
// schedulers) and sizes the scratch; every (X, n, M) launches. At the
// main shape B = n = 42, XG = WG = 3: a 128 x 128 tile (126 x 126 used),
// 512 threads (16 warps, four a scheduler), 129 KB of shared memory (the
// staged tile; the 72 KB ring lies under it), one block an SM; at
// (X, n, M) = (512, 16, 128), XG = 8, WG = 4: 256 threads, two blocks an
// SM. Larger register tiles (16 x 4, 8 x 8 in 8 warps) were slower on the
// card: the kernel wants the warps.
//
// complex128 runs the same code in double. Complex rchol is not this
// kernel's contract: _exx routes it to the einsum route, as JAX does.

#include "async_copy.cuh"
#include "gauss_jordan.cuh"

using pauxy::cplx;

constexpr int kExxThreads = 512;
constexpr int kExxStages = 3;

template <typename T>
struct ExxTile;
template <>
struct ExxTile<float> {
  static constexpr int TM = 8;   // rows (x, i) a thread owns
  static constexpr int TN = 4;   // columns (w, j) a thread owns
  static constexpr int KS = 16;  // depth of a slab
};
template <>
struct ExxTile<double> {
  static constexpr int TM = 4;
  static constexpr int TN = 4;
  static constexpr int KS = 8;
};

// Sixteen bytes of E, the unit of a shared-memory load.
template <typename E>
struct alignas(16) Exx16 {
  static constexpr int N = 16 / sizeof(E);
  E v[N];
};

// Shared memory of the GEMM block, in bytes: [T[I, J] staged, when nb > 1]
// then max(ring, staged tile), then the XG x WG partials.
template <typename T>
struct ExxLayout {
  size_t stage, ring, red;
  int cts;
  __host__ __device__ ExxLayout(int rt, int ct, int xg, int wg) {
    cts = ct + 1;
    stage = (size_t)rt * cts * sizeof(cplx<T>);
    ring = (size_t)kExxStages * ExxTile<T>::KS *
           (rt * sizeof(T) + ct * sizeof(cplx<T>));
    red = (size_t)xg * wg * sizeof(cplx<double>);
  }
  __host__ __device__ size_t second(int nb) const {
    return nb > 1 ? (stage + 15) / 16 * 16 : 0;
  }
  __host__ __device__ size_t partials(int nb) const {
    const size_t big = ring > stage ? ring : stage;
    return (second(nb) + big + 15) / 16 * 16;
  }
  __host__ __device__ size_t bytes(int nb) const { return partials(nb) + red; }
};

// Pack: dst[(grp nb + blk) kp + k][l B + i] = src[grp G + l][blk B + i][k],
// zero outside (l B + i >= G B, grp G + l >= count, blk B + i >= n,
// k >= m); a 32 x 32 tile through shared memory, read along k and written
// along the tile's rows.
template <typename E>
__global__ void exx_pack(const E* __restrict__ src, E* __restrict__ dst,
                         int count, int n, int m, int bsz, int grp_size,
                         int nb, int kp, int rtot) {
  __shared__ E tile[32][33];
  const int panel = blockIdx.z;
  const int grp = panel / nb;
  const int blk = panel - grp * nb;
  const int r0 = blockIdx.x * 32;
  const int k0 = blockIdx.y * 32;
  const E zero{};
  for (int rr = threadIdx.y; rr < 32; rr += blockDim.y) {
    const int r = r0 + rr;
    const int k = k0 + threadIdx.x;
    const int l = r / bsz;
    const int i = r - l * bsz;
    const int idx = grp * grp_size + l;
    const int ii = blk * bsz + i;
    const bool ok = r < grp_size * bsz && idx < count && ii < n && k < m;
    tile[rr][threadIdx.x] = ok ? src[((size_t)idx * n + ii) * m + k] : zero;
  }
  __syncthreads();
  for (int kk = threadIdx.y; kk < 32; kk += blockDim.y) {
    const int k = k0 + kk;
    const int r = r0 + threadIdx.x;
    if (k < kp && r < rtot) {
      dst[((size_t)panel * kp + k) * rtot + r] = tile[threadIdx.x][kk];
    }
  }
}

// One k-slab of an A panel [kp][rt] and a B panel [kp][ct] into a stage.
template <typename T>
__device__ __forceinline__ void exx_slab(T* sa, cplx<T>* sb, const T* a,
                                         const cplx<T>* b, int s, int rt,
                                         int ct) {
  constexpr int KS = ExxTile<T>::KS;
  const int na = KS * rt * (int)sizeof(T) / 16;
  const int nbb = KS * ct * (int)sizeof(cplx<T>) / 16;
  const char* ga = reinterpret_cast<const char*>(a + (size_t)s * KS * rt);
  const char* gb = reinterpret_cast<const char*>(b + (size_t)s * KS * ct);
  char* da = reinterpret_cast<char*>(sa);
  char* db = reinterpret_cast<char*>(sb);
  for (int e = threadIdx.x; e < na + nbb; e += blockDim.x) {
    if (e < na) {
      pauxy::cp_async16(da + 16 * e, ga + 16 * e, true);
    } else {
      pauxy::cp_async16(db + 16 * (e - na), gb + 16 * (e - na), true);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kExxThreads, 1)
    exx_gemm(const T* __restrict__ apack, const cplx<T>* __restrict__ bpack,
             cplx<double>* __restrict__ part, int w, int nb, int kp, int rt,
             int ct, int bsz, int xg, int wg, int ng, int nh) {
  constexpr int TM = ExxTile<T>::TM;
  constexpr int TN = ExxTile<T>::TN;
  constexpr int KS = ExxTile<T>::KS;
  constexpr int NS = kExxStages;
  constexpr int VA = Exx16<T>::N;           // reals a 16-byte load holds
  constexpr int VB = Exx16<cplx<T>>::N;     // complex values one holds
  constexpr int NCA = TM / VA;              // 16-byte pieces of the rows
  constexpr int NCB = TN / VB;              // and of the columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ExxLayout<T> lay(rt, ct, xg, wg);
  const int npair = nb * (nb + 1) / 2;
  int bid = blockIdx.x;
  const int h = bid % nh;
  bid /= nh;
  const int g = bid % ng;
  int p = bid / ng;
  int bi = 0;
  while (p >= nb - bi) {
    p -= nb - bi;
    ++bi;
  }
  const int bj = bi + p;
  const int pair = blockIdx.x / (nh * ng);
  unsigned char* big = smem_raw + lay.second(nb);
  T* ring_a = reinterpret_cast<T*>(big);
  cplx<T>* ring_b =
      reinterpret_cast<cplx<T>*>(big + (size_t)NS * KS * rt * sizeof(T));
  cplx<T>* s1 = reinterpret_cast<cplx<T>*>(nb > 1 ? smem_raw : big);
  cplx<T>* s2 = reinterpret_cast<cplx<T>*>(big);
  cplx<double>* red =
      reinterpret_cast<cplx<double>*>(smem_raw + lay.partials(nb));
  const int t = threadIdx.x;
  const int ncg = ct / TN;
  const int cg = t % ncg;
  const int rg = t / ncg;
  const bool active = rg < rt / TM;
  const int nslab = kp / KS;
  const int passes = bi == bj ? 1 : 2;

  for (int pass = 0; pass < passes; ++pass) {
    const int ai = pass == 0 ? bi : bj;
    const int bk = pass == 0 ? bj : bi;
    const T* a = apack + (size_t)(g * nb + ai) * kp * rt;
    const cplx<T>* b = bpack + (size_t)(h * nb + bk) * kp * ct;
    cplx<T> acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        acc[r][c].re = T(0);
        acc[r][c].im = T(0);
      }
    }
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (s < nslab) {
        exx_slab<T>(ring_a + (size_t)s * KS * rt, ring_b + (size_t)s * KS * ct,
                    a, b, s, rt, ct);
      }
      pauxy::cp_async_commit();
    }
    for (int s = 0; s < nslab; ++s) {
      pauxy::cp_async_wait<NS - 2>();
      __syncthreads();
      const int nx = s + NS - 1;
      if (nx < nslab) {
        exx_slab<T>(ring_a + (size_t)(nx % NS) * KS * rt,
                    ring_b + (size_t)(nx % NS) * KS * ct, a, b, nx, rt, ct);
      }
      pauxy::cp_async_commit();
      if (!active) continue;
      const T* sa = ring_a + (size_t)(s % NS) * KS * rt;
      const cplx<T>* sb = ring_b + (size_t)(s % NS) * KS * ct;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        T av[TM];
        cplx<T> bv[TN];
#pragma unroll
        for (int u = 0; u < NCA; ++u) {
          const Exx16<T> x = *reinterpret_cast<const Exx16<T>*>(
              sa + k * rt + (u * (rt / TM) + rg) * VA);
#pragma unroll
          for (int i = 0; i < VA; ++i) av[u * VA + i] = x.v[i];
        }
#pragma unroll
        for (int u = 0; u < NCB; ++u) {
          const Exx16<cplx<T>> y = *reinterpret_cast<const Exx16<cplx<T>>*>(
              sb + k * ct + (u * ncg + cg) * VB);
#pragma unroll
          for (int i = 0; i < VB; ++i) bv[u * VB + i] = y.v[i];
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            acc[r][c].re = fma(av[r], bv[c].re, acc[r][c].re);
            acc[r][c].im = fma(av[r], bv[c].im, acc[r][c].im);
          }
        }
      }
    }
    pauxy::cp_async_wait<0>();
    // Every read of the ring is done before the tile is staged over it.
    __syncthreads();
    cplx<T>* st = pass == 0 ? s1 : s2;
    if (active) {
#pragma unroll
      for (int u = 0; u < NCA; ++u) {
#pragma unroll
        for (int i = 0; i < VA; ++i) {
          const int r = (u * (rt / TM) + rg) * VA + i;
#pragma unroll
          for (int v = 0; v < NCB; ++v) {
#pragma unroll
            for (int j = 0; j < VB; ++j) {
              st[(size_t)r * lay.cts + (v * ncg + cg) * VB + j] =
                  acc[u * VA + i][v * VB + j];
            }
          }
        }
      }
    }
    // The staged tile is complete (and, before a second pass, T[I, J] is
    // kept in its own region while the ring refills).
    __syncthreads();
  }
  if (passes == 1) s2 = s1;

  // sum_{i in I, j in J} T[i, j] T[j, i] of each (x, w) block, one warp a
  // block, in double; then the XG partials of each walker, in order.
  const int warp = t >> 5;
  const int lane = t & 31;
  const int nwarp = blockDim.x >> 5;
  const int b2 = bsz * bsz;
  for (int q = warp; q < xg * wg; q += nwarp) {
    const int xl = q / wg;
    const int wl = q - xl * wg;
    double re = 0.0, im = 0.0;
    for (int e = lane; e < b2; e += 32) {
      const int i = e / bsz;
      const int j = e - i * bsz;
      const cplx<T> x = s1[(size_t)(xl * bsz + i) * lay.cts + wl * bsz + j];
      const cplx<T> y = s2[(size_t)(xl * bsz + j) * lay.cts + wl * bsz + i];
      re += (double)x.re * (double)y.re - (double)x.im * (double)y.im;
      im += (double)x.re * (double)y.im + (double)x.im * (double)y.re;
    }
    for (int off = 16; off > 0; off >>= 1) {
      re += __shfl_down_sync(0xffffffffu, re, off);
      im += __shfl_down_sync(0xffffffffu, im, off);
    }
    if (lane == 0) {
      red[q].re = re;
      red[q].im = im;
    }
  }
  __syncthreads();
  const double wgt = bi == bj ? 1.0 : 2.0;
  for (int wl = t; wl < wg; wl += blockDim.x) {
    const int wi = h * wg + wl;
    if (wi >= w) continue;
    cplx<double> z;
    z.re = 0.0;
    z.im = 0.0;
    for (int xl = 0; xl < xg; ++xl) {
      z.re += red[xl * wg + wl].re;
      z.im += red[xl * wg + wl].im;
    }
    z.re *= wgt;
    z.im *= wgt;
    part[((size_t)g * npair + pair) * w + wi] = z;
  }
}

// out[w] = sum over the nq = x-groups x pairs partials, in order.
template <typename T>
__global__ void exx_sum(const cplx<double>* __restrict__ part,
                        cplx<T>* __restrict__ out, int w, int nq) {
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= w) return;
  double re = 0.0, im = 0.0;
  for (int q = 0; q < nq; ++q) {
    re += part[(size_t)q * w + wi].re;
    im += part[(size_t)q * w + wi].im;
  }
  cplx<T> z;
  z.re = (T)re;
  z.im = (T)im;
  out[wi] = z;
}

// The tile plan comes from ops/exx_cuda.plan: index blocks of bsz rows (nb
// of them), XG vectors and WG walkers a block, tile rt x ct (multiples of
// TM and TN), depth kp (M rounded up to KS); apack, bpack and part are
// scratch of the sizes it states.
template <typename T>
static int launch_exx(const void* rchol, const void* ghalf, void* apack,
                      void* bpack, void* part, void* out, int nx, int n,
                      int m, int w, int bsz, int nb, int xg, int wg, int rt,
                      int ct, int kp, void* stream) {
  constexpr int TM = ExxTile<T>::TM;
  constexpr int TN = ExxTile<T>::TN;
  constexpr int KS = ExxTile<T>::KS;
  if (nx <= 0 || n <= 0 || m <= 0 || w <= 0 || bsz <= 0 || nb <= 0 ||
      xg <= 0 || wg <= 0 || (size_t)bsz * nb < (size_t)n || rt % TM != 0 ||
      ct % TN != 0 || rt < xg * bsz || ct < wg * bsz || kp % KS != 0 ||
      kp < m) {
    return (int)cudaErrorInvalidValue;
  }
  const ExxLayout<T> lay(rt, ct, xg, wg);
  const size_t bytes = lay.bytes(nb);
  const int threads = ((rt / TM) * (ct / TN) + 31) / 32 * 32;
  const int ng = (nx + xg - 1) / xg;
  const int nh = (w + wg - 1) / wg;
  const int npair = nb * (nb + 1) / 2;
  const size_t blocks = (size_t)ng * nh * npair;
  if (threads > kExxThreads || bytes > pauxy::kSmemMax ||
      blocks > 0x7fffffff || (size_t)ng * nb > 65535 ||
      (size_t)nh * nb > 65535 || (kp + 31) / 32 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 pb(32, 8);
  exx_pack<T><<<dim3((rt + 31) / 32, (kp + 31) / 32, ng * nb), pb, 0, st>>>(
      static_cast<const T*>(rchol), static_cast<T*>(apack), nx, n, m, bsz, xg,
      nb, kp, rt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exx_pack<cplx<T>>
      <<<dim3((ct + 31) / 32, (kp + 31) / 32, nh * nb), pb, 0, st>>>(
          static_cast<const cplx<T>*>(ghalf), static_cast<cplx<T>*>(bpack),
          w, n, m, bsz, wg, nb, kp, ct);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = pauxy::allow_smem(exx_gemm<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  exx_gemm<T><<<(unsigned)blocks, threads, bytes, st>>>(
      static_cast<const T*>(apack), static_cast<const cplx<T>*>(bpack),
      static_cast<cplx<double>*>(part), w, nb, kp, rt, ct, bsz, xg, wg, ng,
      nh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exx_sum<T><<<(w + 127) / 128, 128, 0, st>>>(
      static_cast<const cplx<double>*>(part), static_cast<cplx<T>*>(out), w,
      ng * npair);
  return (int)cudaGetLastError();
}

extern "C" int pauxy_exx_c64(const void* rchol, const void* ghalf,
                             void* apack, void* bpack, void* part, void* out,
                             int nx, int n, int m, int w, int bsz, int nb,
                             int xg, int wg, int rt, int ct, int kp,
                             void* stream) {
  return launch_exx<float>(rchol, ghalf, apack, bpack, part, out, nx, n, m, w,
                           bsz, nb, xg, wg, rt, ct, kp, stream);
}

extern "C" int pauxy_exx_c128(const void* rchol, const void* ghalf,
                              void* apack, void* bpack, void* part, void* out,
                              int nx, int n, int m, int w, int bsz, int nb,
                              int xg, int wg, int rt, int ct, int kp,
                              void* stream) {
  return launch_exx<double>(rchol, ghalf, apack, bpack, part, out, nx, n, m,
                            w, bsz, nb, xg, wg, rt, ct, kp, stream);
}
