// Paged decode attention for Hopper (sm_90a), split over keys
// ("flash-decoding"): one decode token per sequence attends its paged
// context straight off the KV arena, the page table steering every read.
//
// Replaces bloombee_tpu/ops/pallas/paged_attention.py::paged_decode_attention
// (body `_kernel` over `_online_softmax_body`). Contract: q [B,H,hd], slabs
// [S_tot,Hkv,hd], page_table i32 [B,NP], lens i32 [B]. The query sits at
// position lens[b]-1 and sees keys at positions < lens[b] (and >=
// lens[b]-window when window > 0), only in the table's NP pages. Query head
// h reads KV head h / g (g = H / Hkv). Softmax and P.V sum in f32; a row
// with no visible key outputs exact zeros. f32 or bf16; hd 64 or 128.
//
// Bound on H100: bytes. Each visible K/V row is read once per (sequence,
// KV head) for 4*g*hd flops. At serving batch sizes one CTA per (KV head,
// sequence) leaves most SMs idle and walks its keys one latency at a time,
// so the design spreads the key range instead:
//
// - Each sequence's key range [0, NP*page_size) is cut on the host into
//   `chunks` page-aligned chunks of `chunk` keys (chosen from the table's
//   shape alone, so the host never reads lens); one CTA of 4 warps per
//   (chunk, KV head, sequence). A chunk outside the visible keys
//   contributes an empty state (m = -inf, l = 0).
// - Inside a CTA, K/V rows are copied whole (16-byte cp.async, rows padded
//   16 bytes for conflict-free reads) into a 2-stage shared-memory ring of
//   64-key tiles (32 in f32), so the next tile's rows are in flight while
//   this tile is used. Every lane scores whole keys for the g query heads
//   that share the KV head (each K/V row read once for all g), then one max
//   and one sum per head and tile, not per key. P.V runs one output
//   dimension per thread.
// - The merge is in the same launch: each CTA stores (m, l, acc[g][hd]) in
//   f32 to a scratch buffer, and the last CTA of each (sequence, KV head)
//   to arrive (an atomic counter after __threadfence) merges the chunks,
//   weighting each by exp(m_c - m), skipping empty ones, and resets the
//   counter to 0 for the next launch. With one chunk the CTA writes its
//   output directly.

#include <math_constants.h>

#include "async_copy.cuh"
#include "paged_common.cuh"

namespace {

using namespace bbpaged;

constexpr int SNT = 128;  // threads per CTA (4 warps)

template <typename T>
struct Split {
  static constexpr int TK = sizeof(T) == 2 ? 64 : 32;  // keys per tile
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16 bytes
};

template <typename T, int HD, int G>
constexpr size_t split_smem_bytes() {
  return 4 * Split<T>::TK * (HD + Split<T>::VEC) * sizeof(T) +
         sizeof(float) * (G * HD + G * Split<T>::TK + 2 * G);
}

// N floats of a shared-memory row (16 bytes of a K row when N = 4; the
// query's N = VEC dims as f32), and 16 bytes of a bf16 K row as f32.
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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(SNT)
    split_decode_kernel(const T* __restrict__ q,  // [B, H, HD]
                        const T* __restrict__ k,  // [S_tot, HKV, HD]
                        const T* __restrict__ v,
                        const int* __restrict__ page_table,  // [B, NP]
                        const int* __restrict__ lens,        // [B]
                        T* __restrict__ out,                 // [B, H, HD]
                        float* __restrict__ part,  // chunk states (C > 1)
                        int* __restrict__ counter,  // [B * HKV], zero
                        int HKV, int NP, int page_size, int window,
                        int chunk, float scale) {
  constexpr int TK = Split<T>::TK, VEC = Split<T>::VEC;
  constexpr int LD = HD + VEC;        // padded row, in elements
  constexpr int CH = HD / VEC;        // 16-byte pieces per row
  constexpr int HPW = (G + 3) / 4;    // query heads per warp (scores)
  constexpr int KPL = TK / 32;        // keys per lane (scores)
  constexpr int HS = SNT / HD;        // head slots (P.V): 1 or 2
  constexpr int HPT = (G + HS - 1) / HS;  // query heads per thread (P.V)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [2][TK][LD]
  T* Vs = Ks + 2 * TK * LD;                // [2][TK][LD]
  float* qs = reinterpret_cast<float*>(Vs + 2 * TK * LD);  // [G][HD]
  float* ps = qs + G * HD;  // [G][TK] this tile's probabilities
  float* cs = ps + G * TK;  // [G] this tile's rescale of the sums
  float* ls = cs + G;       // [G] the CTA's softmax sums
  __shared__ int is_last;

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int C = gridDim.x, B = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float NEG_INF = -CUDART_INF_F;

  // this CTA's visible keys: [lo, lo + n)
  const int len = lens[b];
  const int hi = min(min(len, NP * page_size), (c + 1) * chunk);
  const int lo = max(window > 0 ? max(len - window, 0) : 0, c * chunk);
  const int n = max(hi - lo, 0);
  const int ntiles = (n + TK - 1) / TK;
  const int* pt = page_table + (size_t)b * NP;
  const T* kb = k + (size_t)kvh * HD;
  const T* vb = v + (size_t)kvh * HD;

  auto load = [&](int t) {
    T* kd = Ks + (t & 1) * TK * LD;
    T* vd = Vs + (t & 1) * TK * LD;
    for (int i = tid; i < TK * CH; i += SNT) {
      const int r = i / CH, piece = i % CH;
      const bool ok = t * TK + r < n;  // rows past the chunk: zero-filled
      const int pos = lo + (ok ? t * TK + r : 0);
      const size_t slot =
          (size_t)pt[pos / page_size] * page_size + pos % page_size;
      const size_t off = slot * HKV * HD + piece * VEC;
      bbasync::copy16(kd + r * LD + piece * VEC, kb + off, ok);
      bbasync::copy16(vd + r * LD + piece * VEC, vb + off, ok);
    }
  };
  if (ntiles > 0) load(0);
  bbasync::commit();

  const T* qb = q + ((size_t)b * HKV + kvh) * G * HD;
  for (int i = tid; i < G * HD; i += SNT) qs[i] = to_f(qb[i]) * scale;

  float m[HPW], l[HPW];  // warp w's heads w + 4 hh, same in every lane
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    m[hh] = NEG_INF;
    l[hh] = 0.f;
  }
  const int d = tid % HD, slot0 = tid / HD;  // P.V: heads slot0 + HS hh
  float acc[HPT];
#pragma unroll
  for (int hh = 0; hh < HPT; ++hh) acc[hh] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);
    bbasync::commit();
    bbasync::wait<1>();  // tile t
    __syncthreads();
    const T* kt = Ks + (t & 1) * TK * LD;
    const T* vt = Vs + (t & 1) * TK * LD;
    const int nk = min(TK, n - t * TK);

    // scores: lane takes keys lane + 32 i, for each of its warp's heads
    float s[HPW][KPL];
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh)
#pragma unroll
      for (int i = 0; i < KPL; ++i) s[hh][i] = 0.f;
#pragma unroll 4
    for (int piece = 0; piece < CH; ++piece) {
      float kx[KPL][VEC];
#pragma unroll
      for (int i = 0; i < KPL; ++i)
        row16(kt + (lane + 32 * i) * LD + piece * VEC, kx[i]);
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        const int g = warp + 4 * hh;
        if (g >= G) continue;
        float qx[VEC];
        row16(qs + g * HD + piece * VEC, qx);
#pragma unroll
        for (int i = 0; i < KPL; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            s[hh][i] = fmaf(qx[e], kx[i][e], s[hh][i]);
      }
    }

    // one max and one sum per head and tile (a tile has >= 1 visible key)
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int g = warp + 4 * hh;
      if (g >= G) continue;
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        if (lane + 32 * i >= nk) s[hh][i] = NEG_INF;
        mx = fmaxf(mx, s[hh][i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[hh], mx);
      const float corr = expf(m[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const float p = expf(s[hh][i] - m_new);
        ps[g * TK + lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[hh] = l[hh] * corr + sum;
      m[hh] = m_new;
      if (lane == 0) cs[g] = corr;
    }
    __syncthreads();

    // P.V: keys past nk have p = 0 and zero-filled rows
#pragma unroll
    for (int hh = 0; hh < HPT; ++hh) {
      const int g = slot0 + HS * hh;
      if (g < G) acc[hh] *= cs[g];
    }
    for (int j = 0; j < nk; j += 4) {
      float vx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vx[e] = to_f(vt[(j + e) * LD + d]);
#pragma unroll
      for (int hh = 0; hh < HPT; ++hh) {
        const int g = slot0 + HS * hh;
        if (g >= G) continue;
        const float4 p = *reinterpret_cast<const float4*>(ps + g * TK + j);
        acc[hh] = fmaf(p.x, vx[0], acc[hh]);
        acc[hh] = fmaf(p.y, vx[1], acc[hh]);
        acc[hh] = fmaf(p.z, vx[2], acc[hh]);
        acc[hh] = fmaf(p.w, vx[3], acc[hh]);
      }
    }
    __syncthreads();  // stage t & 1 and ps are refilled next
  }
  bbasync::wait<0>();

  T* ob = out + ((size_t)b * HKV + kvh) * G * HD;
  if (C == 1) {
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh)
      if (warp + 4 * hh < G && lane == 0) ls[warp + 4 * hh] = l[hh];
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < HPT; ++hh) {
      const int g = slot0 + HS * hh;
      if (g < G) {
        const float sum = ls[g];
        ob[g * HD + d] = from_f<T>(sum > 0.f ? acc[hh] / sum : 0.f);
      }
    }
    return;
  }

  // part: acc [B, HKV, C, G, HD] then (m, l) [B, HKV, C, G, 2]
  const size_t unit = ((size_t)b * HKV + kvh) * C;  // first chunk's index
  float* const part_ml = part + (size_t)B * HKV * C * G * HD;
#pragma unroll
  for (int hh = 0; hh < HPT; ++hh) {
    const int g = slot0 + HS * hh;
    if (g < G) part[((unit + c) * G + g) * HD + d] = acc[hh];
  }
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int g = warp + 4 * hh;
    if (g < G && lane == 0) {
      part_ml[((unit + c) * G + g) * 2] = m[hh];
      part_ml[((unit + c) * G + g) * 2 + 1] = l[hh];
    }
  }
  __threadfence();  // this CTA's state is visible before it is counted
  __syncthreads();
  if (tid == 0) {
    int* cnt = counter + (size_t)b * HKV + kvh;
    is_last = atomicAdd(cnt, 1) == C - 1;
    if (is_last) atomicExch(cnt, 0);  // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the merge: per query head, each chunk's weight exp(m_c - m) (0 for an
  // empty chunk) and the weighted sum of the l_c, one warp per head with
  // the chunks across its lanes; the ring's shared memory is free by now
  // (and holds G * C floats: C <= 264, the planner's CTA target)
  float* w = reinterpret_cast<float*>(smem_raw);  // [G][C] chunk weights
  float* total = qs;                               // [G]
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + unit * G;
  for (int g = warp; g < G; g += SNT / 32) {
    float mx = NEG_INF;
    for (int cc = lane; cc < C; cc += 32) {
      const float2 x = __ldcg(ml + cc * G + g);
      if (x.y > 0.f) mx = fmaxf(mx, x.x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int cc = lane; cc < C; cc += 32) {
      const float2 x = __ldcg(ml + cc * G + g);
      const float e = x.y > 0.f ? expf(x.x - mx) : 0.f;
      w[g * C + cc] = e;
      sum = fmaf(e, x.y, sum);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) total[g] = sum;
  }
  __syncthreads();
  const float* acc_all = part + unit * G * HD;
  for (int i = tid; i < G * HD; i += SNT) {
    const int g = i / HD;
    float o = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < C; ++cc)
      o = fmaf(__ldcg(acc_all + (size_t)cc * G * HD + i), w[g * C + cc], o);
    ob[i] = from_f<T>(total[g] > 0.f ? o / total[g] : 0.f);
  }
}

template <typename T, int HD, int G>
struct SplitLaunch {
  static int run(const void* q, const void* k, const void* v, const int* pt,
                 const int* lens, void* out, float* part, int* counter,
                 int B, int HKV, int NP, int page_size, int window,
                 int chunk, int chunks, float scale, cudaStream_t stream) {
    const size_t smem = split_smem_bytes<T, HD, G>();
    cudaError_t err = cudaFuncSetAttribute(
        split_decode_kernel<T, HD, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(chunks, HKV, B);
    split_decode_kernel<T, HD, G><<<grid, SNT, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, pt, lens, (T*)out, part,
        counter, HKV, NP, page_size, window, chunk, scale);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// dtype (of q, the slabs and out): 0 = float32, 1 = bfloat16. `chunk`
// (keys, a multiple of page_size) and `chunks` come from the host planner;
// `part` holds B*HKV*chunks*G*(HD+2) floats (unused when chunks == 1) and
// `counter` B*HKV ints that are 0 before the launch and 0 after it. The
// slabs must be 16-byte aligned. Returns 0, a cudaError_t code, or -1 for
// a dtype / head_dim / group size this library was not compiled for.
extern "C" int bb_paged_decode_attention(
    const void* q, const void* k_slab, const void* v_slab,
    const int* page_table, const int* lens, void* out, float* part,
    int* counter, int B, int H, int HKV, int HD, int NP, int page_size,
    int window, int chunk, int chunks, float scale, int dtype,
    void* stream) {
  return dispatch<SplitLaunch>(dtype, HD, H / HKV, q, k_slab, v_slab,
                               page_table, lens, out, part, counter, B, HKV,
                               NP, page_size, window, chunk, chunks, scale,
                               (cudaStream_t)stream);
}
