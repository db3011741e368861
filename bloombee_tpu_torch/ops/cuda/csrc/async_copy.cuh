// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the kernels that stream tiles through a shared-memory ring
// (flash_attention.cu, paged_split.cuh).

#pragma once

#include <cuda_runtime.h>

namespace bbasync {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy 16 bytes from global src to shared dst; when !pred the 16 bytes are
// zero-filled and nothing is read (src must still be a valid address).
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// Copy N = 4 or 8 bytes (cp.async.ca: the L1-allocating form, the only one
// that takes fewer than 16 bytes); zero-filled and nothing read when !pred.
template <int N>
__device__ __forceinline__ void copy_small(void* dst, const void* src,
                                           bool pred) {
  static_assert(N == 4 || N == 8, "cp.async.ca takes 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(N), "r"(pred ? N : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace bbasync
