// What the kernels share: the complex type and its math helpers, and the
// shared-memory limits. Kernel A (greens.cu) and kernel B (batchla.cu) each
// have their own elimination.
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

// Shared memory a block may use on sm_90 (227 KB, dynamic above 48 KB).
constexpr size_t kSmemMax = 232448;
constexpr size_t kSmemStatic = 48 * 1024;

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kSmemStatic) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace pauxy
