// Device code of the paged kernels: the dtype conversions and the dtype /
// head_dim / group dispatch that every paged source uses, and the
// per-key online-softmax body (`attend_rows`, with the dense K/V row
// reader) that now serves only paged_chunk_attention (paged_attention.cu);
// the decode, int4 decode and ragged kernels run on the split-over-keys
// body of paged_split.cuh.
//
// Design of the body: one CTA of 8 warps per (KV head, query row), covering
// the g query heads that share that KV head, so each K/V row is read once
// for all g. The warps split the visible key positions round-robin; each
// lane holds hd/32 dimensions of every query head, of the current K/V row
// and of the accumulators. A key's score is a warp-shuffle reduction,
// followed by a per-key online-softmax update. At the end the 8 warps'
// (max, sum, acc) states merge through shared memory. Keys outside
// [lo, hi) or refused by `visible` are never read (the page table steers
// every read). A row with no visible key outputs exact zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace bbpaged {

constexpr int NW = 8;  // warps per CTA
constexpr int NT = NW * 32;
constexpr float NEG = -1e30f;

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

// A dense slab [S_tot, HKV, HD]: lane holds dims lane + 32 i (coalesced).
template <typename T, int HD>
struct DenseKV {
  static constexpr int PER = HD / 32;
  const T* k;
  const T* v;
  int hkv;

  __device__ static int dim(int lane, int i) { return lane + 32 * i; }
  __device__ void load(int slot, int kvh, int lane, float* kr,
                       float* vr) const {
    const size_t off = ((size_t)slot * hkv + kvh) * HD + lane;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      kr[i] = to_f(k[off + 32 * i]);
      vr[i] = to_f(v[off + 32 * i]);
    }
  }
};

// Online-softmax attention of the G query heads qrow[G][HD] (already one
// KV head's group) over the key positions in [lo, hi) that visible(pos)
// admits, each read through the sequence's page table `pt`; writes
// orow[G][HD]. Called once per CTA by all NT threads.
template <typename T, int HD, int G, class KV, class Vis>
__device__ __forceinline__ void attend_rows(
    const T* __restrict__ qrow, T* __restrict__ orow, const KV& kv, int kvh,
    const int* __restrict__ pt, int page_size, int lo, int hi, Vis visible,
    float scale) {
  constexpr int PER = HD / 32;
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][HD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float qr[G][PER], acc[G][PER], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      qr[g][i] = to_f(qrow[g * HD + KV::dim(lane, i)]) * scale;
      acc[g][i] = 0.f;
    }
    m[g] = NEG;
    l[g] = 0.f;
  }

  for (int pos = lo + warp; pos < hi; pos += NW) {
    if (!visible(pos)) continue;  // uniform across the warp
    const int slot = pt[pos / page_size] * page_size + pos % page_size;
    float kr[PER], vr[PER];
    kv.load(slot, kvh, lane, kr, vr);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) s = fmaf(qr[g][i], kr[i], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      const float m_new = fmaxf(m[g], s);
      const float corr = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        acc[g][i] = fmaf(acc[g][i], corr, p * vr[i]);
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < PER; ++i) sm_acc[warp][g][KV::dim(lane, i)] = acc[g][i];
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(sm_m[w][g] - mx);
      sum = fmaf(sm_l[w][g], e, sum);
      o = fmaf(sm_acc[w][g][d], e, o);
    }
    orow[idx] = from_f<T>(o / fmaxf(sum, 1e-30f));
  }
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
