// Flash attention for Hopper (sm_90a): causal or full GQA attention of a
// prefill step over its gathered context, online softmax in f32.
//
// Replaces bloombee_tpu/ops/pallas/flash_attention.py::flash_attention
// (body `_kernel`). Contract: q [B,T,H,hd], k/v [B,S,Hkv,hd] (S >= T),
// starts/lens i32 [B]. Query i of row b sits at absolute position
// starts[b] + i; it sees keys at positions < lens[b] (and <= its own
// position when causal). Query head h reads KV head h / (H / Hkv). Logits,
// softmax and the P.V sum are f32; a row with no visible key outputs zeros.
// The output has q's dtype (f32 or bf16).
//
// Design: one CTA of 256 threads per (64-query tile, head, batch row). The
// tile's queries (pre-scaled) sit in shared memory as f32; K/V tiles of 32
// keys are staged through shared memory, converted to f32. Four threads own
// one query row: each computes 8 of the tile's 32 scores, the row's max and
// sum reduce over those four lanes with shuffles, and each thread keeps a
// quarter of the row's output accumulator in registers. Key tiles past the
// row block's last visible key are never loaded (the Pallas kernel's block
// skip). No tensor cores: the products run on the f32 pipes.
//
// Bound on H100: at prefill shapes the work is compute (4*T*S*H*hd flops
// against reading q, k, v once); this kernel is far from the tensor-core
// roofline by design. wgmma/TMA tiling is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // queries per CTA
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int NT = 256;  // threads per CTA: four per query row
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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ starts, const int* __restrict__ lens,
                 int TQ, int S, int H, int HKV, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][HD + 1]
  float* Ks = Qs + BQ * (HD + 1);    // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);    // [BK][HD]
  float* Ps = Vs + BK * HD;          // [BQ][BK + 1]

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / HKV);
  const int tid = threadIdx.x;
  const int row = tid >> 2, sub = tid & 3;
  const int q0 = tile * BQ;
  const int start = starts[b];
  const int len = lens[b];

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    Qs[r * (HD + 1) + d] =
        qi < TQ ? to_f(q[(((size_t)b * TQ + qi) * H + h) * HD + d]) * scale
                : 0.f;
  }

  // keys past this tile's last visible key are never loaded
  int kend = min(len, S);
  if (causal) kend = min(kend, start + min(q0 + BQ, TQ));

  const int qi = q0 + row;
  const int qpos = start + qi;
  const bool row_live = qi < TQ;
  constexpr int NC = HD / 4;  // output columns owned by this thread
  constexpr int NS = BK / 4;  // scores per thread per key tile
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  float m = NEG, l = 0.f;
  const float* qrow = Qs + row * (HD + 1);
  float* prow = Ps + row * (BK + 1);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // Q stored / previous tile consumed
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int r = idx / HD, d = idx % HD;
      const int kk = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kk < S) {
        const size_t off = (((size_t)b * S + kk) * HKV + kvh) * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Ks[r * (HD + 1) + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        s[j] = fmaf(qd, Ks[(sub + 4 * j) * (HD + 1) + d], s[j]);
    }

    unsigned vis = 0u;
    float tmax = NEG;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int kk = k0 + sub + 4 * j;
      if (row_live && kk < len && kk < S && (!causal || kk <= qpos)) {
        vis |= 1u << j;
        tmax = fmaxf(tmax, s[j]);
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = ((vis >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      prow[sub + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= corr;
    __syncwarp();  // the row's P entries come from its four lanes

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float p = prow[kk];
      const float* vrow = Vs + kk * HD + sub;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(p, vrow[4 * c], acc[c]);
    }
  }

  if (row_live) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + (((size_t)b * TQ + qi) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[sub + 4 * c] = from_f<T>(acc[c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* starts, const int* lens, int B, int TQ, int S, int H,
           int HKV, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((TQ + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, starts, lens, TQ, S, H,
      HKV, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0, a cudaError_t code, or -1
// for a dtype/head_dim this library was not compiled for.
extern "C" int bb_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, const int* starts,
                                  const int* lens, int B, int TQ, int S,
                                  int H, int HKV, int HD, float scale,
                                  int causal, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && HD == 64)
    return launch<float, 64>(q, k, v, o, starts, lens, B, TQ, S, H, HKV,
                             scale, causal, st);
  if (dtype == 0 && HD == 128)
    return launch<float, 128>(q, k, v, o, starts, lens, B, TQ, S, H, HKV,
                              scale, causal, st);
  if (dtype == 1 && HD == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, starts, lens, B, TQ, S, H,
                                     HKV, scale, causal, st);
  if (dtype == 1 && HD == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, starts, lens, B, TQ, S, H,
                                      HKV, scale, causal, st);
  return -1;
}
