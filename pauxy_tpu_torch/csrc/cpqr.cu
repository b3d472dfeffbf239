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
// zero trailing column gives tau = 0, beta = 0 and no update.
//
// Design. The TPU kernel put 128 matrices on the lanes of one VMEM-resident
// [m, m, 128] pair. Here one thread block holds one matrix in shared
// memory (row-major, 69 KB at m = 93 in complex64, 138 KB in complex128):
//  * factor pass (cpqr_factor_kernel), m sequential column steps: a warp
//    takes the argmax of the trailing column norms (lowest index on ties,
//    cpqr_pallas.py:101-105), the columns are swapped in shared memory, a
//    warp builds the Householder vector of column k, and then one thread
//    per trailing column j computes w_j = v^H a_j, updates a_j -= tau v w_j
//    and, in the same pass, the exact norm of a_j over rows > k for the
//    next step's pivot (the TPU kernel's always-recompute rule,
//    cpqr_pallas.py:36-40: no downdating, no cancellation). v is packed
//    below the diagonal, the pivot choices are replayed into perm as they
//    are made, and R and the packed factor go out;
//  * form-Q pass (cpqr_formq_kernel), a second launch, one block per
//    (matrix, 16-column block of Q): the reflectors stay in shared memory
//    (transposed, so each v_k is contiguous) and are applied in reverse
//    order to identity columns (LAPACK xORGQR), starting at the first
//    reflector that touches the block. Eight threads share a column: each
//    owns the rows i = g (mod 8) of it for the whole pass, and the dot
//    product v^H q_c is summed over the eight with warp shuffles, so no
//    barrier is needed inside the loop (a thread never reads a row that
//    another wrote).
//
// What bounds it on the H100: at (B, m) = (512, 93) complex64 the two
// passes do ~4.9 GFLOP (16 (m-k)^2 for the factor update, 4 (m-k)^2 for
// the norms and 16 (m-k) per reflector and Q column), 0.074 ms at the
// 67 TFLOP/s FP32 rate, and move ~0.1 GB (a in, q and r out), 0.032 ms. A
// block's column steps are sequential and latency-bound (one thread per
// column, 2 (m-k) dependent shared-memory multiply-adds a step), which
// this simple design accepts: 2-3 matrices share an SM (69 KB each in
// complex64), so 512 matrices take about two waves. Several matrices per
// block, wgmma for the trailing update and blocked compact-WY panels are
// later work.
//
// Types: complex64 computes in float, complex128 in double. Real input is
// passed in as complex with zero imaginary parts by the wrapper.

#include "gauss_jordan.cuh"

using pauxy::cplx;

namespace {

constexpr int kFactorThreads = 128;
constexpr int kQcb = 16;                   // form-Q column block
constexpr int kGroup = 8;                  // threads per Q column
constexpr int kFormqThreads = kQcb * kGroup;

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
size_t factor_bytes(int m) {
  return (size_t)m * m * sizeof(cplx<T>) + (size_t)m * sizeof(T) +
         2 * sizeof(T) + 2 * sizeof(int);
}

template <typename T>
size_t formq_bytes(int m) {
  return (size_t)m * m * sizeof(cplx<T>) +
         (size_t)m * kQcb * sizeof(cplx<T>) + (size_t)m * sizeof(T);
}

// One block per matrix. Shared memory: a [m][m] row-major, nrm [m], the
// step's tau and its pivot.
template <typename T>
__global__ void __launch_bounds__(kFactorThreads)
    cpqr_factor_kernel(const cplx<T>* __restrict__ ain,
                       cplx<T>* __restrict__ rout,
                       cplx<T>* __restrict__ packed,
                       T* __restrict__ tauout,
                       long long* __restrict__ permout, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* a = reinterpret_cast<cplx<T>*>(smem_raw);
  T* nrm = reinterpret_cast<T*>(a + (size_t)m * m);
  T* scal = nrm + m;                        // the step's tau
  int* piv = reinterpret_cast<int*>(scal + 2);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const size_t base = (size_t)blockIdx.x * m * m;
  long long* perm = permout + (size_t)blockIdx.x * m;
  T* tau = tauout + (size_t)blockIdx.x * m;

  for (int e = tid; e < m * m; e += nt) a[e] = ain[base + e];
  for (int j = tid; j < m; j += nt) perm[j] = j;
  __syncthreads();
  for (int j = tid; j < m; j += nt) {
    T s = T(0);
    for (int i = 0; i < m; ++i) s += abs2(a[i * m + j]);
    nrm[j] = s;
  }
  __syncthreads();

  for (int k = 0; k < m; ++k) {
    // ---- pivot: largest trailing norm, lowest index on ties -------------
    if (tid < 32) {
      T best = T(-1);
      int idx = m;
      for (int j = k + lane; j < m; j += 32) {
        if (nrm[j] > best) {
          best = nrm[j];
          idx = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (ob > best || (ob == best && oi < idx)) {
          best = ob;
          idx = oi;
        }
      }
      if (lane == 0) {
        const int p = idx < m ? idx : k;
        piv[0] = p;
        if (p != k) {
          const long long t = perm[k];
          perm[k] = perm[p];
          perm[p] = t;
        }
      }
    }
    __syncthreads();
    // ---- swap columns k <-> p ------------------------------------------
    const int p = piv[0];
    if (p != k) {
      for (int i = tid; i < m; i += nt) {
        const cplx<T> t = a[i * m + k];
        a[i * m + k] = a[i * m + p];
        a[i * m + p] = t;
      }
    }
    __syncthreads();
    // ---- Householder vector of column k (one warp) ----------------------
    if (tid < 32) {
      T s = T(0);
      for (int i = k + lane; i < m; i += 32) s += abs2(a[i * m + k]);
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const T anorm = dsqrt(s);
      const cplx<T> alpha = a[k * m + k];
      const T aabs = dsqrt(abs2(alpha));
      const bool degen = anorm <= Tiny<T>::v();
      T sgr = T(1), sgi = T(0);
      if (aabs > Tiny<T>::v()) {
        sgr = alpha.re / aabs;
        sgi = alpha.im / aabs;
      }
      const T betr = degen ? T(0) : -sgr * anorm;
      const T beti = degen ? T(0) : -sgi * anorm;
      // v = x / (alpha - beta), v[k] = 1; tau = 1 + |alpha| / ||x||.
      const T dr = alpha.re - betr;
      const T di = alpha.im - beti;
      const T dden = dr * dr + di * di;
      const T ir = degen ? T(0) : dr / dden;
      const T ii = degen ? T(0) : -di / dden;
      for (int i = k + 1 + lane; i < m; i += 32) {
        const cplx<T> x = a[i * m + k];
        cplx<T> v;
        v.re = x.re * ir - x.im * ii;
        v.im = x.re * ii + x.im * ir;
        a[i * m + k] = v;
      }
      __syncwarp();  // every lane has read alpha before beta replaces it
      if (lane == 0) {
        const T tk = degen ? T(0) : T(1) + aabs / anorm;
        scal[0] = tk;
        tau[k] = tk;
        cplx<T> b;
        b.re = betr;
        b.im = beti;
        a[k * m + k] = b;
      }
    }
    __syncthreads();
    // ---- trailing update, and the next step's exact norms ---------------
    const T tk = scal[0];
    for (int j = k + 1 + tid; j < m; j += nt) {
      T wr = T(0), wi = T(0);
      {
        const cplx<T> x = a[k * m + j];      // v[k] = 1
        wr = x.re;
        wi = x.im;
      }
      for (int i = k + 1; i < m; ++i) {
        const cplx<T> v = a[i * m + k];
        const cplx<T> x = a[i * m + j];
        wr += v.re * x.re + v.im * x.im;     // conj(v) x
        wi += v.re * x.im - v.im * x.re;
      }
      wr *= tk;
      wi *= tk;
      {
        cplx<T> x = a[k * m + j];
        x.re -= wr;
        x.im -= wi;
        a[k * m + j] = x;
      }
      T s = T(0);
      for (int i = k + 1; i < m; ++i) {
        const cplx<T> v = a[i * m + k];
        cplx<T> x = a[i * m + j];
        x.re -= v.re * wr - v.im * wi;
        x.im -= v.re * wi + v.im * wr;
        a[i * m + j] = x;
        s += abs2(x);
      }
      nrm[j] = s;
    }
    __syncthreads();
  }

  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m;
    const int j = e - i * m;
    const cplx<T> x = a[e];
    packed[base + e] = x;
    cplx<T> z;
    z.re = T(0);
    z.im = T(0);
    rout[base + e] = i <= j ? x : z;
  }
}

// One block per (column block, matrix). Shared memory: vt [m][m] with
// vt[k * m + i] = v_k[i] (i > k), q [m][kQcb], tau [m].
template <typename T>
__global__ void __launch_bounds__(kFormqThreads)
    cpqr_formq_kernel(const cplx<T>* __restrict__ packed,
                      const T* __restrict__ tauin,
                      cplx<T>* __restrict__ qout, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* vt = reinterpret_cast<cplx<T>*>(smem_raw);
  cplx<T>* q = vt + (size_t)m * m;
  T* tau = reinterpret_cast<T*>(q + (size_t)m * kQcb);
  const int tid = threadIdx.x;
  const int c = tid / kGroup;                // column within the block
  const int g = tid % kGroup;                // row subset of that column
  const int c0 = blockIdx.x * kQcb;
  const int col = c0 + c;
  const size_t base = (size_t)blockIdx.y * m * m;

  for (int e = tid; e < m * m; e += kFormqThreads) {
    const int i = e / m;
    const int k = e - i * m;
    if (i > k) vt[k * m + i] = packed[base + e];
  }
  for (int k = tid; k < m; k += kFormqThreads)
    tau[k] = tauin[(size_t)blockIdx.y * m + k];
  for (int i = g; i < m; i += kGroup) {
    cplx<T> e;
    e.re = (i == col) ? T(1) : T(0);
    e.im = T(0);
    q[i * kQcb + c] = e;
  }
  __syncthreads();

  // Reflectors k > c0 + kQcb - 1 leave these identity columns unchanged.
  // Each thread owns the rows i = g (mod kGroup) of its column for the
  // whole loop (the identity fill above and the write-out below use the
  // same rows), so no thread reads a row another one wrote and only the
  // shuffles connect the eight.
  const int kstart = min(m, c0 + kQcb) - 1;
  for (int k = kstart; k >= 0; --k) {
    const cplx<T>* v = vt + (size_t)k * m;
    const int i0 = k + (g - k % kGroup + kGroup) % kGroup;
    T wr = T(0), wi = T(0);
    for (int i = i0; i < m; i += kGroup) {
      const cplx<T> x = q[i * kQcb + c];
      if (i == k) {
        wr += x.re;
        wi += x.im;
      } else {
        const cplx<T> vi = v[i];
        wr += vi.re * x.re + vi.im * x.im;
        wi += vi.re * x.im - vi.im * x.re;
      }
    }
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      wr += __shfl_xor_sync(0xffffffffu, wr, off, kGroup);
      wi += __shfl_xor_sync(0xffffffffu, wi, off, kGroup);
    }
    const T tk = tau[k];
    wr *= tk;
    wi *= tk;
    for (int i = i0; i < m; i += kGroup) {
      cplx<T> x = q[i * kQcb + c];
      if (i == k) {
        x.re -= wr;
        x.im -= wi;
      } else {
        const cplx<T> vi = v[i];
        x.re -= vi.re * wr - vi.im * wi;
        x.im -= vi.re * wi + vi.im * wr;
      }
      q[i * kQcb + c] = x;
    }
  }

  if (col < m) {
    for (int i = g; i < m; i += kGroup) qout[base + (size_t)i * m + col] =
        q[i * kQcb + c];
  }
}

template <typename T>
int launch_cpqr(const void* a, void* q, void* r, void* packed, void* tau,
                void* perm, int b, int m, void* stream) {
  if (b <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const size_t fb = factor_bytes<T>(m);
  const size_t qb = formq_bytes<T>(m);
  if (fb > pauxy::kSmemMax || qb > pauxy::kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = pauxy::allow_smem(cpqr_factor_kernel<T>, fb);
  if (err != cudaSuccess) return (int)err;
  cpqr_factor_kernel<T><<<b, kFactorThreads, fb, s>>>(
      static_cast<const cplx<T>*>(a), static_cast<cplx<T>*>(r),
      static_cast<cplx<T>*>(packed), static_cast<T*>(tau),
      static_cast<long long*>(perm), m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = pauxy::allow_smem(cpqr_formq_kernel<T>, qb);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + kQcb - 1) / kQcb, b);
  cpqr_formq_kernel<T><<<grid, kFormqThreads, qb, s>>>(
      static_cast<const cplx<T>*>(packed), static_cast<const T*>(tau),
      static_cast<cplx<T>*>(q), m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pauxy_cpqr_c64(const void* a, void* q, void* r, void* packed,
                              void* tau, void* perm, int b, int m,
                              void* stream) {
  return launch_cpqr<float>(a, q, r, packed, tau, perm, b, m, stream);
}

extern "C" int pauxy_cpqr_c128(const void* a, void* q, void* r, void* packed,
                               void* tau, void* perm, int b, int m,
                               void* stream) {
  return launch_cpqr<double>(a, q, r, packed, tau, perm, b, m, stream);
}
