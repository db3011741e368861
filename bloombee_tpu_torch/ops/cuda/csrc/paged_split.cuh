// Device code of the split-over-keys paged kernels (paged_decode.cu: the
// bf16/f32 and the int4 decode kernels; paged_ragged.cu and the chunk
// kernel of paged_attention.cu, through paged_rows.cuh): the K/V tile
// stagers, the CUDA-core tile body and the same-launch merge.
//
// A CTA owns one chunk of a sequence's keys (page-aligned, planned on the
// host from the table's shape) and walks it in tiles of TK keys. A stager
// copies each key's K and V rows whole with cp.async into a 2-stage ring
// in shared memory, so the next tile is in flight while this one is used,
// and presents the tile as rows of E (the dense slab's own type, or f32
// for the int4 arena, dequantized once per tile). The tile body scores the
// tile for up to QM query rows (every lane whole keys, each K row read once
// for all rows), takes one max and one sum per query row and tile, and
// adds P.V with one output dimension per thread. Each CTA then stores its
// (m, l, acc) per query row in f32, and the last CTA of each unit (a
// sequence's or a row tile's KV head) to arrive, counted by an atomic
// counter that it resets to 0, merges the chunks in the same launch.
//
// The counters live per (device, stream) on the host side and are shared
// by every split kernel: that is safe only because launches on one stream
// run in order, so no two launches touch them at once.

#pragma once

#include <math_constants.h>

#include "async_copy.cuh"
#include "paged_common.cuh"

namespace bbsplit {

using bbpaged::from_f;
using bbpaged::to_f;

constexpr int SNT = 128;  // threads per CTA (4 warps)

// N floats of a shared-memory row as f32 (N a multiple of 4), and 16 bytes
// of a bf16 row as f32.
template <int N>
__device__ __forceinline__ void row16(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 u = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = u.x;
    x[4 * i + 1] = u.y;
    x[4 * i + 2] = u.z;
    x[4 * i + 3] = u.w;
  }
}
__device__ __forceinline__ void row16(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// A dense slab [S_tot, HKV, HD] of T: rows copied as they are (16-byte
// pieces, rows padded by 16 bytes so that lanes reading whole rows hit
// distinct banks). `slot(r)` gives the arena slot of the tile's row r.
template <typename T, int HD>
struct DenseStage {
  using E = T;
  static constexpr int TK = sizeof(T) == 2 ? 64 : 32;  // keys per tile
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int LD = HD + VEC;  // padded row, in elements
  static constexpr int CH = HD / VEC;  // 16-byte pieces per row
  static constexpr size_t BYTES = 4 * TK * LD * sizeof(T);  // K, V x 2

  const T* k;
  const T* v;
  int hkv;
  T* ks;  // [2][TK][LD]
  T* vs;

  __device__ void bind(unsigned char* smem) {
    ks = reinterpret_cast<T*>(smem);
    vs = ks + 2 * TK * LD;
  }
  // stage `st` <- rows [0, rows) of the tile (later rows zero-filled).
  // A thread's page-table lookups all go out before its first copy (each
  // cp.async is a compiler barrier: interleaved, every lookup would wait
  // for the one before).
  template <class Slot>
  __device__ void load(int st, int rows, int kvh, Slot slot) {
    constexpr int ITEMS = TK * CH / SNT;
    static_assert(TK * CH % SNT == 0, "whole pieces per thread");
    T* kd = ks + st * TK * LD;
    T* vd = vs + st * TK * LD;
    const int piece = threadIdx.x % CH, r0 = threadIdx.x / CH;
    int slots[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int r = r0 + j * (SNT / CH);
      slots[j] = slot(r < rows ? r : 0);
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int r = r0 + j * (SNT / CH);
      const size_t off = ((size_t)slots[j] * hkv + kvh) * HD + piece * VEC;
      bbasync::copy16(kd + r * LD + piece * VEC, k + off, r < rows);
      bbasync::copy16(vd + r * LD + piece * VEC, v + off, r < rows);
    }
  }
  __device__ void ready(int) {}  // the body reads the ring as it is
  __device__ const E* keys(int st) const { return ks + st * TK * LD; }
  __device__ const E* values(int st) const { return vs + st * TK * LD; }
};

// An int4 slab (kv/quant.py layout): codes [S_tot, HKV, HD/2] u8, the even
// head position in the low nibble; scale and zero [S_tot, HKV, HD/32] f16.
// Each row's codes (HD/2 bytes: 16-byte pieces), scale and zero (HD/16
// bytes each: one 8- or 4-byte copy) are copied whole into the ring; once
// the tile has arrived, `ready` dequantizes it into f32 K and V tiles as
// code * scale + zero, rounded twice as the plain version rounds (no fused
// multiply-add). Needs codes 16-byte and scale/zero HD/16-byte aligned.
template <int HD>
struct Int4Stage {
  using E = float;
  static constexpr int TK = 64;
  static constexpr int LD = HD + 4;       // f32 tile row, padded 16 bytes
  static constexpr int CB = HD / 2;       // code bytes per row
  static constexpr int SB = HD / 16;      // scale (or zero) bytes per row
  static constexpr int GR = HD / 32;      // groups per row
  static constexpr int PIECES = CB / 16 + 2;
  static constexpr int RING = TK * (CB + 2 * SB);  // one side, one stage
  static constexpr size_t BYTES = 4 * RING + 2 * TK * LD * sizeof(float);

  const unsigned char* kc;
  const __half* ksc;
  const __half* kz;
  const unsigned char* vc;
  const __half* vsc;
  const __half* vz;
  int hkv;
  unsigned char* ring;  // [2 stages][K, V][codes TK*CB | scale | zero]
  float* kf;            // [TK][LD]
  float* vf;

  __device__ void bind(unsigned char* smem) {
    ring = smem;
    kf = reinterpret_cast<float*>(smem + 4 * RING);
    vf = kf + TK * LD;
  }
  __device__ unsigned char* side(int st, int s) const {
    return ring + (2 * st + s) * RING;
  }
  template <class Slot>
  __device__ void load(int st, int rows, int kvh, Slot slot) {
    constexpr int ITEMS = TK * PIECES / SNT;
    static_assert(TK * PIECES % SNT == 0, "whole pieces per thread");
    int slots[ITEMS];  // every lookup before the first copy (see Dense)
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int r = (threadIdx.x + j * SNT) / PIECES;
      slots[j] = slot(r < rows ? r : 0);
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = threadIdx.x + j * SNT;
      const int r = i / PIECES, piece = i % PIECES;
      const bool ok = r < rows;
      const size_t row = (size_t)slots[j] * hkv + kvh;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        unsigned char* d = side(st, s);
        if (piece < CB / 16) {
          bbasync::copy16(d + r * CB + piece * 16,
                          (s ? vc : kc) + row * CB + piece * 16, ok);
        } else {
          const bool zero = piece == CB / 16 + 1;
          const __half* src = zero ? (s ? vz : kz) : (s ? vsc : ksc);
          bbasync::copy_small<SB>(d + TK * CB + zero * TK * SB + r * SB,
                                  src + row * GR, ok);
        }
      }
    }
  }
  // dequantize stage `st` into kf / vf (all threads; ends synchronized)
  __device__ void ready(int st) {
    for (int i = threadIdx.x; i < 2 * TK * (HD / 8); i += SNT) {
      const int s = i / (TK * (HD / 8));
      const int r = (i / (HD / 8)) % TK, p8 = i % (HD / 8);
      const unsigned char* d = side(st, s);
      const unsigned int c =
          *reinterpret_cast<const unsigned int*>(d + r * CB + 4 * p8);
      const __half* sc = reinterpret_cast<const __half*>(d + TK * CB);
      const __half* zr = reinterpret_cast<const __half*>(d + TK * CB +
                                                         TK * SB);
      const float scale = __half2float(sc[r * GR + p8 / 4]);
      const float zero = __half2float(zr[r * GR + p8 / 4]);
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float code = (float)((c >> (4 * j)) & 0xFu);  // dim 8 p8 + j
        x[j] = __fadd_rn(__fmul_rn(code, scale), zero);
      }
      float4* dst =
          reinterpret_cast<float4*>((s ? vf : kf) + r * LD + 8 * p8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();
  }
  __device__ const E* keys(int) const { return kf; }
  __device__ const E* values(int) const { return vf; }
};

// The CUDA-core tile body for up to QM query rows (run-local rows qr <
// nq). Scores: warp w takes query rows w + 4 hh, lane the keys lane + 32 i.
// P.V: thread takes dimension d = tid % HD of query rows tid / HD + HS hh.
// qs [QM][HD] f32 holds the query rows already scaled; ps [QM][TK] and
// cs [QM] are shared scratch.
template <typename E, int HD, int QM, int TK>
struct Core {
  static constexpr int VEC = 16 / sizeof(E);
  static constexpr int CH = HD / VEC;
  static constexpr int HPW = (QM + 3) / 4;
  static constexpr int KPL = TK / 32;
  static constexpr int HS = SNT / HD;
  static constexpr int HPT = (QM + HS - 1) / HS;
  float m[HPW], l[HPW], acc[HPT];

  __device__ void init() {
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      m[hh] = -CUDART_INF_F;
      l[hh] = 0.f;
    }
#pragma unroll
    for (int hh = 0; hh < HPT; ++hh) acc[hh] = 0.f;
  }

  // One tile of nk keys (rows of kt / vt, LD elements apart; rows past nk
  // zero-filled). vis(qr, key) admits a key for a query row. A query row
  // may see no key of the tile: its state is then only rescaled by 1.
  template <int LD, class Vis>
  __device__ void tile(const E* kt, const E* vt, const float* qs, float* ps,
                       float* cs, int nq, int nk, Vis vis) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const float NEG_INF = -CUDART_INF_F;
    float s[HPW][KPL];
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh)
#pragma unroll
      for (int i = 0; i < KPL; ++i) s[hh][i] = 0.f;
#pragma unroll  // whole: a partial unroll spills in the int4 kernel
    for (int piece = 0; piece < CH; ++piece) {
      float kx[KPL][VEC];
#pragma unroll
      for (int i = 0; i < KPL; ++i)
        row16(kt + (lane + 32 * i) * LD + piece * VEC, kx[i]);
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        const int qr = warp + 4 * hh;
        if (qr >= nq) continue;
        float qx[VEC];
        row16(qs + qr * HD + piece * VEC, qx);
#pragma unroll
        for (int i = 0; i < KPL; ++i) {  // a short chain per piece
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) t = fmaf(qx[e], kx[i][e], t);
          s[hh][i] += t;
        }
      }
    }

    // one max and one sum per query row and tile
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int qr = warp + 4 * hh;
      if (qr >= nq) continue;
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int key = lane + 32 * i;
        if (key >= nk || !vis(qr, key)) s[hh][i] = NEG_INF;
        mx = fmaxf(mx, s[hh][i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[hh], mx);
      const float base = m_new == NEG_INF ? 0.f : m_new;
      const float corr = expf(m[hh] - base);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const float p = expf(s[hh][i] - base);
        ps[qr * TK + lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[hh] = l[hh] * corr + sum;
      m[hh] = m_new;
      if (lane == 0) cs[qr] = corr;
    }
    __syncthreads();

    // P.V: keys past nk have p = 0 and zero-filled rows
    const int d = tid % HD, slot0 = tid / HD;
#pragma unroll
    for (int hh = 0; hh < HPT; ++hh) {
      const int qr = slot0 + HS * hh;
      if (qr < nq) acc[hh] *= cs[qr];
    }
    for (int j = 0; j < nk; j += 4) {
      float vx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vx[e] = to_f(vt[(j + e) * LD + d]);
#pragma unroll
      for (int hh = 0; hh < HPT; ++hh) {
        const int qr = slot0 + HS * hh;
        if (qr >= nq) continue;
        const float4 p = *reinterpret_cast<const float4*>(ps + qr * TK + j);
        float t = p.x * vx[0];
        t = fmaf(p.y, vx[1], t);
        t = fmaf(p.z, vx[2], t);
        acc[hh] += fmaf(p.w, vx[3], t);
      }
    }
  }

  // The state of query rows [0, nq) into part: acc at acc_out[qr * HD + d],
  // (m, l) at ml_out[qr].
  __device__ void store(float* acc_out, float2* ml_out, int nq) const {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int d = tid % HD, slot0 = tid / HD;
#pragma unroll
    for (int hh = 0; hh < HPT; ++hh) {
      const int qr = slot0 + HS * hh;
      if (qr < nq) acc_out[qr * HD + d] = acc[hh];
    }
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int qr = warp + 4 * hh;
      if (qr < nq && lane == 0) ml_out[qr] = make_float2(m[hh], l[hh]);
    }
  }
};

// True, in every thread, in the CTA that arrives last of `expect` at
// *counter (each CTA's stores are made visible before it is counted); that
// CTA resets the counter to 0 for the next launch.
__device__ __forceinline__ bool arrive_last(int* counter, int expect) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counter, 1) == expect - 1;
    if (is_last) atomicExch(counter, 0);
  }
  __syncthreads();
  const bool last = is_last;
  if (last) __threadfence();
  return last;
}

// The merge of a unit's C chunk states for query rows [0, nq <= NQ]: acc
// [C][QT][HD] and (m, l) [C][QT] in part. Each chunk's weight exp(m_c - m)
// per query row (0 for an empty chunk, whose acc is then never used), then
// out_row(qr)[d] = sum_c w_c acc_c[d] / sum_c w_c l_c, zeros for a row that
// saw no key. The loads are spread over all threads and issued in batches
// (all of a thread's float4s of one chunk at once), not one dependent load
// after another, over the chunks that any row saw keys in. `w` is shared
// scratch of 2 * nq * C floats, `total` of nq.
template <typename T, int HD, int NQ, class Out>
__device__ void merge_chunks(const float* acc, const float2* ml, int C,
                             int QT, int nq, float* w, float* total,
                             Out out_row) {
  const int tid = threadIdx.x;
  const float NEG_INF = -CUDART_INF_F;
  float* lw = w + nq * C;  // [nq][C] chunk sums
  __shared__ int live[64 + 1];  // chunks any row saw keys in, then count
  if (tid <= 64) live[tid] = 0;
  __syncthreads();
#pragma unroll 8
  for (int i = tid; i < nq * C; i += SNT) {
    const int qr = i / C, c = i % C;
    const float2 x = __ldcg(ml + c * QT + qr);
    w[i] = x.y > 0.f ? x.x : NEG_INF;
    lw[i] = x.y;
    if (x.y > 0.f && c < 64) live[c] = 1;
  }
  __syncthreads();
  for (int qr = tid; qr < nq; qr += SNT) {  // one thread per row
    float mx = NEG_INF;
    for (int c = 0; c < C; ++c) mx = fmaxf(mx, w[qr * C + c]);
    float sum = 0.f;
    for (int c = 0; c < C; ++c) {
      const float m = w[qr * C + c];
      const float e = m == NEG_INF ? 0.f : expf(m - mx);
      w[qr * C + c] = e;
      sum = fmaf(e, lw[qr * C + c], sum);
    }
    total[qr] = sum;
  }
  if (tid == 0) {  // the live chunks, in order, over the flags
    int n = 0;
    for (int c = 0; c < min(C, 64); ++c)
      if (live[c]) live[n++] = c;
    live[64] = C > 64 ? -1 : n;  // -1: more chunks than flags, walk all
  }
  __syncthreads();
  const int n_live = live[64] < 0 ? C : live[64];
  constexpr int V4 = HD / 4;  // float4s per row
  // a thread's float4s i = tid + k * SNT, PER at a time (rows past nq
  // clamped to the last one and weighted 0), loaded without a branch so
  // that all PER loads of a chunk are in flight at once; a dead row's acc
  // may be unwritten, so it is selected away, not multiplied by 0
  constexpr int PER = NQ * V4 / SNT < 8 ? (NQ * V4 + SNT - 1) / SNT : 8;
  for (int i0 = 0; i0 < nq * V4; i0 += PER * SNT) {
    float4 o[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < n_live; ++j) {
      const int c = live[64] < 0 ? j : live[j];
      float4 x[PER];
      float e[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = min(i0 + tid + k * SNT, nq * V4 - 1), qr = i / V4;
        e[k] = i0 + tid + k * SNT < nq * V4 ? w[qr * C + c] : 0.f;
        x[k] = __ldcg(reinterpret_cast<const float4*>(
            acc + ((size_t)c * QT + qr) * HD) + i % V4);
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        if (e[k] == 0.f) continue;
        o[k].x = fmaf(x[k].x, e[k], o[k].x);
        o[k].y = fmaf(x[k].y, e[k], o[k].y);
        o[k].z = fmaf(x[k].z, e[k], o[k].z);
        o[k].w = fmaf(x[k].w, e[k], o[k].w);
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = i0 + tid + k * SNT, qr = i / V4;
      if (i >= nq * V4) continue;
      const float t = total[qr];
      // the fast reciprocal (2 ulp): IEEE division calls a slow path
      const float inv = t > 0.f ? __fdividef(1.f, t) : 0.f;
      T* dst = out_row(qr) + 4 * (i % V4);
      dst[0] = from_f<T>(o[k].x * inv);
      dst[1] = from_f<T>(o[k].y * inv);
      dst[2] = from_f<T>(o[k].z * inv);
      dst[3] = from_f<T>(o[k].w * inv);
    }
  }
}

}  // namespace bbsplit
