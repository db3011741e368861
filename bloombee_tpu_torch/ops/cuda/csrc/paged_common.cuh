// Device code that every paged source uses: the dtype conversions and the
// dtype / head_dim / group dispatch of the C entry points.

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

// Launch L<T, HD, G>::run(args...) for a runtime dtype (0 = float32,
// 1 = bfloat16), head_dim (64, 128) and group size G = H / HKV (1, 2, 4,
// 8); -1 for a combination that is not compiled in.
template <template <typename, int, int> class L, typename T, int HD,
          typename... A>
int by_group(int g, A... a) {
  switch (g) {
    case 1: return L<T, HD, 1>::run(a...);
    case 2: return L<T, HD, 2>::run(a...);
    case 4: return L<T, HD, 4>::run(a...);
    case 8: return L<T, HD, 8>::run(a...);
    default: return -1;
  }
}

template <template <typename, int, int> class L, typename... A>
int dispatch(int dtype, int hd, int g, A... a) {
  if (dtype == 0 && hd == 64) return by_group<L, float, 64>(g, a...);
  if (dtype == 0 && hd == 128) return by_group<L, float, 128>(g, a...);
  if (dtype == 1 && hd == 64) return by_group<L, __nv_bfloat16, 64>(g, a...);
  if (dtype == 1 && hd == 128)
    return by_group<L, __nv_bfloat16, 128>(g, a...);
  return -1;
}

}  // namespace bbpaged
