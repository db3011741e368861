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
// Bound on H100: operations. At prefill shapes the work is 4*T*S*H*hd
// flops against reading q, k, v once, far above the card's ~295 flops per
// byte, so the tensor cores set the limit. Two kernels behind one entry
// point, by dtype:
//
// bf16 (flash_bf16_kernel, the serving path): FlashAttention-2's loop on
// Hopper's warpgroup tensor-core instructions (wgmma). One CTA of one
// warpgroup (4 warps) per (64-query tile, head, batch row); warp w owns
// query rows 16w..16w+15. The Q tile is copied to shared memory once; K/V
// tiles of 64 keys stream through a 2-stage shared-memory ring filled by
// cp.async, so tile j+1 loads while tile j is multiplied. All tiles sit in
// wgmma's 128-byte-swizzled layout (conflict-free for the tensor cores).
// S = Q K^T is one wgmma m64n64k16 per 16 dims, both operands read from
// shared memory by descriptor, the sums in registers. The online softmax
// runs there in f32 (exp2 with log2(e) folded into the scale), each row's
// max and sum reduced over the 4 lanes that share it. O += P V is wgmma
// m64n{hd}k16 with P from registers (the S accumulators are already in
// the A-operand layout) and V read MN-major from shared memory. P enters
// that product as two bf16 terms (hi + lo, two wgmma each): one bf16 term
// (as SDPA rounds it) errs by up to 2^-9 of each weight, which on rows
// with few visible keys breaks the port's per-element bf16 limit (1e-2
// |plain| + 1e-3); the second term costs a third more tensor-core work
// and keeps P to ~16 bits. The mask is computed only on tiles that cross
// some row's visible edge (causal edge, lens[b] or S, per batch row);
// tiles past the tile's last visible key are never loaded and rows past
// it are zero-filled. CTAs of the last query tiles (the most keys when
// causal) are launched first.
//
// f32 (flash_f32_kernel, the f32 reference path): the tensor cores have no
// f32 product (TF32 keeps ~3 digits), so this one runs on the f32 pipes.
// One CTA of 256 threads per (64-query tile, head, batch row). The tile's
// queries (pre-scaled) sit in shared memory; K/V tiles of 32 keys are
// staged through shared memory. Four threads own one query row: each
// computes 8 of the tile's 32 scores, the row's max and sum reduce over
// those four lanes with shuffles, and each thread keeps a quarter of the
// row's output accumulator in registers. Key tiles past the row block's
// last visible key are never loaded (the Pallas kernel's block skip).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace {

using namespace bbwgmma;

constexpr int BQ = 64;   // queries per CTA
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int NT = 256;  // threads per CTA: four per query row
constexpr float NEG = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     const int* __restrict__ starts,
                     const int* __restrict__ lens, int TQ, int S, int H,
                     int HKV, float scale, int causal) {
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
        qi < TQ ? q[(((size_t)b * TQ + qi) * H + h) * HD + d] * scale : 0.f;
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
        kx = k[off];
        vx = v[off];
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
    float* orow = o + (((size_t)b * TQ + qi) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[sub + 4 * c] = acc[c] / denom;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const int* starts, const int* lens, int B, int TQ, int S,
               int H, int HKV, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((TQ + BQ - 1) / BQ, H, B);
  flash_f32_kernel<HD><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, starts,
      lens, TQ, S, H, HKV, scale, causal);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16 on tensor cores
constexpr int TC_BQ = 64;   // queries per CTA: one warpgroup, 16 rows a warp
constexpr int TC_BK = 64;   // keys per K/V tile
constexpr int TC_NT = 128;  // threads per CTA
constexpr unsigned FULL = 0xffffffffu;

// Shared memory holds the Q tile and a 2-stage ring of K and V tiles in
// wgmma's 128-byte-swizzled layout: a tile of R rows x HD bf16 is HD/64
// column blocks of [R][64] (128-byte rows), and the 16-byte piece p of row
// r sits at piece p ^ (r % 8) of its row, so the 8 rows of every 1024-byte
// atom spread over all banks. 1024 bytes of slack align the atoms.
template <int HD>
constexpr size_t tc_smem_bytes() {
  return 1024 + sizeof(__nv_bfloat16) * (TC_BQ + 4 * TC_BK) * HD;
}

// Accumulator layout of wgmma m64nNk16 (lane = 4 * gq + tq of warp w):
// d[4j .. 4j+1] hold row 16w + gq, columns 8j + 2tq and 8j + 2tq + 1;
// d[4j+2 .. 4j+3] row 16w + gq + 8. So each thread holds two query rows,
// and a row's values are spread over the 4 lanes of a quad.
template <int HD>
__global__ void __launch_bounds__(TC_NT)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o,
                      const int* __restrict__ starts,
                      const int* __restrict__ lens, int TQ, int S, int H,
                      int HKV, float scale, int causal) {
  using bf16 = __nv_bfloat16;
  constexpr int CH = HD / 8;      // 16-byte pieces per row
  constexpr int NS = TC_BK / 2;   // S accumulators per thread
  constexpr int NO = HD / 2;      // O accumulators per thread
  constexpr int KQ = HD / 16;     // 16-deep steps of Q K^T
  constexpr int KP = TC_BK / 16;  // 16-deep steps of P V
  constexpr int QBYTES = TC_BQ * HD * 2, KVBYTES = TC_BK * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + QBYTES;        // [2] stages
  unsigned char* Vs = Ks + 2 * KVBYTES;   // [2] stages

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / HKV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = tile * TC_BQ;
  const int start = starts[b], len = lens[b];
  // keys [0, kend) are visible to some row of the tile; [0, kfull) to all
  int kend = min(len, S), kfull = kend;
  if (causal) {
    kend = min(kend, start + min(q0 + TC_BQ, TQ));
    kfull = min(kfull, start + q0 + 1);
  }
  const int ntiles = kend > 0 ? (kend + TC_BK - 1) / TC_BK : 0;

  const bf16* qb = q + ((size_t)b * TQ * H + h) * HD;
  const bf16* kb = k + ((size_t)b * S * HKV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * S * HKV + kvh) * HD;
  for (int i = tid; i < TC_BQ * CH; i += TC_NT) {
    const int r = i / CH, p = i % CH, qi = q0 + r;
    bbasync::copy16(Qs + swizzled(TC_BQ, r, p),
                    qb + (size_t)min(qi, TQ - 1) * H * HD + p * 8, qi < TQ);
  }
  auto load_kv = [&](int t) {
    unsigned char* kd = Ks + (t & 1) * KVBYTES;
    unsigned char* vd = Vs + (t & 1) * KVBYTES;
    for (int i = tid; i < TC_BK * CH; i += TC_NT) {
      const int r = i / CH, p = i % CH, kk = t * TC_BK + r;
      const size_t off = (size_t)min(kk, S - 1) * HKV * HD + p * 8;
      bbasync::copy16(kd + swizzled(TC_BK, r, p), kb + off, kk < kend);
      bbasync::copy16(vd + swizzled(TC_BK, r, p), vb + off, kk < kend);
    }
  };
  if (ntiles > 0) load_kv(0);
  bbasync::commit();  // the Q tile and K/V tile 0

  const int gq = lane >> 2, tq = lane & 3;
  const int qrow = q0 + warp * 16 + gq;  // this thread's rows: +0 and +8
  int lim[2];                            // each row's visible key limit
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lim[i] = min(len, S);
    if (causal) lim[i] = min(lim[i], start + qrow + 8 * i + 1);
  }
  const float scale2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2e)
  const float NEG_INF = __int_as_float(0xff800000);

  float s[NS], oacc[NO];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1);
    bbasync::commit();
    bbasync::wait<1>();  // tile t (and the Q tile)
    // the copies are generic-proxy writes; wgmma reads by the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const unsigned char* kt = Ks + (t & 1) * KVBYTES;
    const unsigned char* vt = Vs + (t & 1) * KVBYTES;

    // S = Q K^T: 16 dims a step, within 64-dim column blocks
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const int col = (kk & 3) * 32;  // bytes into the 128-byte rows
      wgmma_ss_n64(s, smem_desc(Qs + (kk >> 2) * TC_BQ * 128 + col, 16, 1024),
                   smem_desc(kt + (kk >> 2) * TC_BK * 128 + col, 16, 1024),
                   kk == 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // online softmax in the log2 domain; the mask only on edge tiles
    const int k0 = t * TC_BK;
    const bool edge = k0 + TC_BK > kfull;
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (edge && k0 + 8 * j + 2 * tq + e >= lim[i])
            s[4 * j + 2 * i + e] = NEG_INF;
          mx = fmaxf(mx, s[4 * j + 2 * i + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      // running max of the raw scores (scale > 0 keeps the order)
      const float m_new = fmaxf(mrow[i], mx);
      // a row with nothing visible yet keeps m = -inf: exp2 against 0
      // then gives exact zeros, never inf - inf
      const float base = m_new == NEG_INF ? 0.f : m_new * scale2;
      corr[i] = fast_exp2(fmaf(mrow[i], scale2, -base));
      mrow[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x = fast_exp2(fmaf(x, scale2, -base));
          sum += x;
        }
      lrow[i] = lrow[i] * corr[i] + sum;  // the lane's share; quad-summed
    }
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      oacc[4 * n] *= corr[0];
      oacc[4 * n + 1] *= corr[0];
      oacc[4 * n + 2] *= corr[1];
      oacc[4 * n + 3] *= corr[1];
    }

    // O += P V: P's A fragments are the S accumulators of 16 keys, as two
    // bf16 terms (hi + lo); V (keys x dims) is B, MN-major
    unsigned a[KP][4], a_lo[KP][4];
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(s[8 * kk + 4 * (r >> 1) + 2 * (r & 1)],
                   s[8 * kk + 4 * (r >> 1) + 2 * (r & 1) + 1], a[kk][r],
                   a_lo[kk][r]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      const uint64_t desc = smem_desc(vt + kk * 16 * 128, TC_BK * 128, 1024);
      wgmma_pv<HD>(oacc, a[kk], desc);
      wgmma_pv<HD>(oacc, a_lo[kk], desc);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(oacc);
    pin(a);
    pin(a_lo);
    __syncthreads();  // stage t & 1 is refilled at iteration t + 1
  }
  bbasync::wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lrow[i];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int qi = qrow + 8 * i;
    if (qi < TQ) {
      bf16* orow = o + (((size_t)b * TQ + qi) * H + h) * HD + 2 * tq;
#pragma unroll
      for (int n = 0; n < NO / 4; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(oacc[4 * n + 2 * i] * inv,
                                  oacc[4 * n + 2 * i + 1] * inv);
    }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const int* starts, const int* lens, int B, int TQ, int S,
                int H, int HKV, float scale, int causal, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((TQ + TC_BQ - 1) / TC_BQ, H, B);
  flash_bf16_kernel<HD><<<grid, TC_NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, starts, lens, TQ, S, H, HKV,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (flash_f32_kernel), 1 = bfloat16 (flash_bf16_kernel,
// which needs q, k and v 16-byte aligned). Returns 0, a cudaError_t code,
// or -1 for a dtype/head_dim this library was not compiled for or H not a
// multiple of HKV.
extern "C" int bb_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, const int* starts,
                                  const int* lens, int B, int TQ, int S,
                                  int H, int HKV, int HD, float scale,
                                  int causal, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (HKV <= 0 || H % HKV) return -1;  // any group g = H / HKV
  if (dtype == 0 && HD == 64)
    return launch_f32<64>(q, k, v, o, starts, lens, B, TQ, S, H, HKV,
                             scale, causal, st);
  if (dtype == 0 && HD == 128)
    return launch_f32<128>(q, k, v, o, starts, lens, B, TQ, S, H, HKV,
                              scale, causal, st);
  if (dtype == 1 && HD == 64)
    return launch_bf16<64>(q, k, v, o, starts, lens, B, TQ, S, H, HKV,
                             scale, causal, st);
  if (dtype == 1 && HD == 128)
    return launch_bf16<128>(q, k, v, o, starts, lens, B, TQ, S, H, HKV,
                              scale, causal, st);
  return -1;
}
