// Device code that every paged source uses: the dtype conversions and the
// dtype / head_dim dispatch of the C entry points.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace bbpaged {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Launch L<T, HD>::run(args...) for a runtime dtype (0 = float32,
// 1 = bfloat16) and head_dim (64, 128); -1 for a combination that is not
// compiled in or H not a multiple of HKV. Every kernel takes the group
// g = H / HKV at run time.
template <template <typename, int> class L, typename... A>
int dispatch(int dtype, int hd, int h, int hkv, A... a) {
  if (hkv <= 0 || h <= 0 || h % hkv) return -1;
  if (dtype == 0 && hd == 64) return L<float, 64>::run(a...);
  if (dtype == 0 && hd == 128) return L<float, 128>::run(a...);
  if (dtype == 1 && hd == 64) return L<__nv_bfloat16, 64>::run(a...);
  if (dtype == 1 && hd == 128) return L<__nv_bfloat16, 128>::run(a...);
  return -1;
}

}  // namespace bbpaged
