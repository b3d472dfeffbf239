// Asynchronous global-to-shared copies (cp.async, sm_80 and later), for the
// kernels that stream tiles through a ring of shared-memory stages while
// they compute on the previous stage (taylor.cu, exx.cu, gemm_bf16x3.cu).
//
// A copy with valid == false writes zeros to its shared-memory destination
// and reads nothing (the source operand's size is 0), so a tile's ragged
// edge is zero-filled without a branch around the copy. Copies are grouped
// by commit(); wait<N>() returns once at most N of the newest groups are
// still in flight, after which a __syncthreads() makes the arrived stage
// visible to the whole block.

#pragma once

#include <cuda_runtime.h>

namespace pauxy {

// 16 bytes; both addresses 16-byte aligned (L2 only: .cg).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// 16 bytes of which the first `bytes` (0 to 16) are read and the rest are
// zeros; both addresses 16-byte aligned (a ragged edge of a vector copy).
__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem,
                                             int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// 8 bytes; both addresses 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// 4 bytes; both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace pauxy
