// Paged decode and paged chunk attention for Hopper (sm_90a): attention
// read straight off the paged KV arena, the page table steering each key
// read, online softmax in f32.
//
// Replaces, in bloombee_tpu/ops/pallas/paged_attention.py:
// - paged_decode_attention (body `_kernel` over `_online_softmax_body`):
//   q [B,H,hd], one decode token per sequence at position lens[b]-1; keys
//   visible at positions < lens[b], and >= lens[b]-window when window > 0.
// - paged_chunk_attention (body `_chunk_kernel`): q [B,T,H,hd], the step's
//   tokens at positions [lens[b]-t_real, lens[b]); causal with an optional
//   per-query window, or (tree mode) the committed prefix fully visible and
//   a [T,T] tree mask over the in-step keys. Query rows >= t_real are
//   padding (causal mode) and output zeros.
// Both: slabs [S_tot,Hkv,hd], page_table i32 [B,NP], lens i32 [B]; query
// head h reads KV head h / g (g = H / Hkv); keys exist only in the NP pages
// of the table; a row with no visible key outputs exact zeros.
//
// Design: one CTA of 8 warps per (KV head, query token, sequence), covering
// the g query heads that share that KV head, so each K/V row is read once
// for all g heads. The warps split the visible key positions round-robin;
// each lane holds hd/32 dimensions of every query head, of the current K/V
// row and of the accumulators. A key's score is a warp-shuffle reduction,
// followed by a per-key online-softmax update. At the end the 8 warps'
// (max, sum, acc) states merge through shared memory. Keys outside the
// visible range (past lens, below the window) are never read: the Pallas
// kernel's whole-page skips, at key granularity.
//
// Bound on H100: bytes. Decode reads each visible K/V row once per
// (sequence, KV head) and does 4*g*hd flops per row; the arena read
// dominates. The chunk variant re-reads the context once per query token
// (from L2 after the first), which a later query-tiled kernel removes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(NT)
    paged_kernel(const T* __restrict__ q,          // [B, TQ, H, HD]
                 const T* __restrict__ k_slab,     // [S_tot, HKV, HD]
                 const T* __restrict__ v_slab,     // [S_tot, HKV, HD]
                 const int* __restrict__ page_table,  // [B, NP]
                 const int* __restrict__ lens,        // [B]
                 const unsigned char* __restrict__ tree,  // [B,TQ,TQ]/null
                 T* __restrict__ out,              // [B, TQ, H, HD]
                 int TQ, int HKV, int NP, int page_size, int window,
                 int t_real, float scale) {
  constexpr int PER = HD / 32;
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][HD];

  const int kvh = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int H = HKV * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lens[b];
  const int start = len - t_real;  // position of the step's first token

  // visible key positions [lo, hi), before the tree test
  int lo = 0, hi = 0;
  if (tree != nullptr) {
    hi = len;
  } else if (qt < t_real) {
    const int qpos = start + qt;
    hi = min(len, qpos + 1);
    lo = window > 0 ? max(qpos + 1 - window, 0) : 0;
  }
  hi = min(hi, NP * page_size);

  float qr[G][PER], acc[G][PER], m[G], l[G];
  const T* qbase = q + (((size_t)b * TQ + qt) * H + kvh * G) * HD + lane;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      qr[g][i] = to_f(qbase[g * HD + 32 * i]) * scale;
      acc[g][i] = 0.f;
    }
    m[g] = NEG;
    l[g] = 0.f;
  }

  const unsigned char* trow =
      tree != nullptr ? tree + ((size_t)b * TQ + qt) * TQ : nullptr;
  const int* pt = page_table + (size_t)b * NP;
  for (int pos = lo + warp; pos < hi; pos += NW) {
    if (trow != nullptr && pos >= start) {
      const int rel = pos - start;  // in-step key: the tree decides
      if (rel >= TQ || !trow[rel]) continue;
    }
    const int slot = pt[pos / page_size] * page_size + pos % page_size;
    const size_t off = ((size_t)slot * HKV + kvh) * HD + lane;
    float kr[PER], vr[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      kr[i] = to_f(k_slab[off + 32 * i]);
      vr[i] = to_f(v_slab[off + 32 * i]);
    }
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
      for (int i = 0; i < PER; ++i) acc[g][i] = fmaf(acc[g][i], corr, p * vr[i]);
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < PER; ++i) sm_acc[warp][g][lane + 32 * i] = acc[g][i];
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  T* obase = out + (((size_t)b * TQ + qt) * H + kvh * G) * HD;
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
    obase[idx] = from_f<T>(o / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int HD, int G>
int launch(const void* q, const void* k, const void* v, const int* pt,
           const int* lens, const unsigned char* tree, void* out, int B,
           int TQ, int HKV, int NP, int page_size, int window, int t_real,
           float scale, cudaStream_t stream) {
  dim3 grid(HKV, TQ, B);
  paged_kernel<T, HD, G><<<grid, NT, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, pt, lens, tree, (T*)out, TQ,
      HKV, NP, page_size, window, t_real, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_g(int g, const void* q, const void* k, const void* v,
               const int* pt, const int* lens, const unsigned char* tree,
               void* out, int B, int TQ, int HKV, int NP, int page_size,
               int window, int t_real, float scale, cudaStream_t st) {
  switch (g) {
    case 1:
      return launch<T, HD, 1>(q, k, v, pt, lens, tree, out, B, TQ, HKV, NP,
                              page_size, window, t_real, scale, st);
    case 2:
      return launch<T, HD, 2>(q, k, v, pt, lens, tree, out, B, TQ, HKV, NP,
                              page_size, window, t_real, scale, st);
    case 4:
      return launch<T, HD, 4>(q, k, v, pt, lens, tree, out, B, TQ, HKV, NP,
                              page_size, window, t_real, scale, st);
    case 8:
      return launch<T, HD, 8>(q, k, v, pt, lens, tree, out, B, TQ, HKV, NP,
                              page_size, window, t_real, scale, st);
    default:
      return -1;
  }
}

int dispatch(int dtype, int hd, int g, const void* q, const void* k,
             const void* v, const int* pt, const int* lens,
             const unsigned char* tree, void* out, int B, int TQ, int HKV,
             int NP, int page_size, int window, int t_real, float scale,
             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64)
    return dispatch_g<float, 64>(g, q, k, v, pt, lens, tree, out, B, TQ,
                                 HKV, NP, page_size, window, t_real, scale,
                                 st);
  if (dtype == 0 && hd == 128)
    return dispatch_g<float, 128>(g, q, k, v, pt, lens, tree, out, B, TQ,
                                  HKV, NP, page_size, window, t_real, scale,
                                  st);
  if (dtype == 1 && hd == 64)
    return dispatch_g<__nv_bfloat16, 64>(g, q, k, v, pt, lens, tree, out, B,
                                         TQ, HKV, NP, page_size, window,
                                         t_real, scale, st);
  if (dtype == 1 && hd == 128)
    return dispatch_g<__nv_bfloat16, 128>(g, q, k, v, pt, lens, tree, out,
                                          B, TQ, HKV, NP, page_size, window,
                                          t_real, scale, st);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns 0, a cudaError_t code, or
// -1 for a dtype / head_dim / group size this library was not compiled for.
extern "C" int bb_paged_decode_attention(const void* q, const void* k_slab,
                                         const void* v_slab,
                                         const int* page_table,
                                         const int* lens, void* out, int B,
                                         int H, int HKV, int HD, int NP,
                                         int page_size, int window,
                                         float scale, int dtype,
                                         void* stream) {
  return dispatch(dtype, HD, H / HKV, q, k_slab, v_slab, page_table, lens,
                  nullptr, out, B, 1, HKV, NP, page_size, window, 1, scale,
                  stream);
}

extern "C" int bb_paged_chunk_attention(
    const void* q, const void* k_slab, const void* v_slab,
    const int* page_table, const int* lens, const unsigned char* tree,
    void* out, int B, int TQ, int H, int HKV, int HD, int NP, int page_size,
    int window, int t_real, float scale, int dtype, void* stream) {
  return dispatch(dtype, HD, H / HKV, q, k_slab, v_slab, page_table, lens,
                  tree, out, B, TQ, HKV, NP, page_size, window, t_real, scale,
                  stream);
}
