// Paged decode attention for Hopper (sm_90a), split over keys
// ("flash-decoding"), over a dense or an int4 KV arena: one decode token
// per sequence attends its paged context straight off the arena, the page
// table steering every read. One kernel body (paged_split.cuh) serves both
// arenas; they differ only in how a K/V tile is staged and read.
//
// Replaces, in bloombee_tpu/ops/pallas/paged_attention.py:
// - paged_decode_attention (body `_kernel` over `_online_softmax_body`):
//   slabs [S_tot,Hkv,hd] of q's dtype;
// - paged_decode_attention_int4 (body `_int4_kernel`): codes
//   [S_tot,Hkv,hd/2] u8 (even dim in the low nibble) + scale/zero
//   [S_tot,Hkv,hd/32] f16, dequantized as code*scale+zero per 32-dim group.
//   The Pallas kernel's evens-then-odds permutation of q works around a TPU
//   lane layout and is not carried over.
// Contract: q [B,H,hd], page_table i32 [B,NP], lens i32 [B]. The query
// sits at position lens[b]-1 and sees keys at positions < lens[b] (and >=
// lens[b]-window when window > 0), only in the table's NP pages. Query
// head h reads KV head h / g (g = H / Hkv). Softmax and P.V sum in f32; a row
// with no visible key outputs exact zeros. f32 or bf16; hd 64 or 128.
//
// Bound on H100: bytes. Each visible K/V row is read once per (sequence,
// KV head) for 4*g*hd flops (2*hd bytes per row and side in bf16, hd/2 +
// hd/8 in int4). At serving batch sizes one CTA per (KV head, sequence)
// leaves most SMs idle and walks its keys one latency at a time, so the
// design spreads the key range instead:
//
// - Each sequence's key range [0, NP*page_size) is cut on the host into
//   `chunks` page-aligned chunks of `chunk` keys (chosen from the table's
//   shape alone, so the host never reads lens); one CTA of 4 warps per
//   (chunk, head tile, sequence). A head tile is GT query heads of one
//   KV head, GT the least power of two >= g up to DECODE_TILE (compiled
//   for 1, 2, 4, 8 and 16), g taken at run time: a group of 1, 2, 4, 8 or
//   16 is one whole tile, a group of 3 one tile of 4 with one head masked,
//   Falcon-7B's 71 heads over one KV head five tiles of 16, the last
//   masked. A chunk outside the visible keys contributes an empty state
//   (m = -inf, l = 0).
// - Inside a CTA, K/V rows are copied whole with cp.async into a 2-stage
//   shared-memory ring of 64-key tiles (32 in f32), so the next tile's rows
//   are in flight while this tile is used: dense rows as they are (padded
//   16 bytes for conflict-free reads), int4 rows as their codes, scale and
//   zero, dequantized once per tile into f32 rows. Every lane scores whole
//   keys for the tile's query heads, which share the KV head (each K/V row
//   read once for all of them), then one max and one sum per head and
//   tile, not per key. P.V runs one output dimension per thread.
// - The merge is in the same launch: each CTA stores (m, l, acc[GT][hd])
//   in f32 to a scratch buffer, and the last CTA of each (sequence, head
//   tile) to arrive (an atomic counter after __threadfence) merges the chunks,
//   weighting each by exp(m_c - m), skipping empty ones, and resets the
//   counter to 0 for the next launch. With one chunk the CTA writes its
//   output directly.

#include "paged_split.cuh"

namespace {

using namespace bbsplit;

// The most query heads of a CTA: a group of g heads is cut into ceil(g /
// GT) head tiles of GT = decode_tile_width(g) heads on the grid's KV-head
// axis, the last one masked (`decode_tiles` in paged_attention.py).
constexpr int DECODE_TILE = 16;
inline int decode_tile_width(int g) {
  int w = 1;
  while (w < g && w < DECODE_TILE) w *= 2;
  return w;
}
// the planner's most CTAs (SPLIT_CTAS): the most chunks of a unit, whose
// merge weights and sums (2 * GT * C floats) the ring holds
constexpr int MAX_SPLIT = 264;

// Shared memory: the stager's ring, then qs [GT][HD], ps [GT][TK], cs [GT]
// and ls [GT] in f32.
template <class S, int HD, int GT>
constexpr size_t smem_bytes() {
  static_assert(2 * GT * MAX_SPLIT * sizeof(float) <= S::BYTES,
                "the merge's weights fit in the ring");
  return S::BYTES + sizeof(float) * (GT * HD + GT * S::TK + 2 * GT);
}

// One CTA per (chunk, KV head x head tile, sequence): tiles of GT heads,
// nt = gridDim.y / HKV of them per KV head.
template <typename T, int HD, int GT, class S>
__global__ void __launch_bounds__(SNT)
    split_decode_kernel(const T* __restrict__ q,  // [B, H, HD]
                        S st,                     // the arena's K/V
                        const int* __restrict__ page_table,  // [B, NP]
                        const int* __restrict__ lens,        // [B]
                        T* __restrict__ out,                 // [B, H, HD]
                        float* __restrict__ part,  // chunk states (C > 1)
                        int* __restrict__ counter,  // [B * HKV * nt], 0
                        int H, int HKV, int NP, int page_size, int window,
                        int chunk, float scale) {
  constexpr int TK = S::TK;
  using CoreG = Core<typename S::E, HD, GT, TK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  st.bind(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + S::BYTES);  // [GT][HD]
  float* ps = qs + GT * HD;  // [GT][TK] this tile's probabilities
  float* cs = ps + GT * TK;  // [GT] this tile's rescale of the sums
  float* ls = cs + GT;       // [GT] the CTA's softmax sums

  const int c = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int C = gridDim.x, Y = gridDim.y, B = gridDim.z;
  // one tile a KV head (Y == HKV) needs no division for its KV head
  const int nt = Y == HKV ? 1 : Y / HKV;
  const int kvh = Y == HKV ? y : y / nt, tile = Y == HKV ? 0 : y % nt;
  // this CTA's query heads: [h0, h0 + nq)
  const int g = H / HKV, h0 = kvh * g + tile * GT;
  const int nq = min(GT, g - tile * GT);
  const int tid = threadIdx.x;

  // this CTA's visible keys: [lo, lo + n)
  const int len = lens[b];
  const int hi = min(min(len, NP * page_size), (c + 1) * chunk);
  const int lo = max(window > 0 ? max(len - window, 0) : 0, c * chunk);
  const int n = max(hi - lo, 0);
  const int ntiles = (n + TK - 1) / TK;
  const int* pt = page_table + (size_t)b * NP;

  auto load = [&](int t) {
    st.load(t & 1, n - t * TK, kvh, [&](int r) {
      const int pos = lo + t * TK + r;
      return pt[pos / page_size] * page_size + pos % page_size;
    });
  };
  if (ntiles > 0) load(0);
  bbasync::commit();

  const T* qb = q + ((size_t)b * H + h0) * HD;
  for (int i = tid; i < nq * HD; i += SNT) qs[i] = to_f(qb[i]) * scale;

  CoreG core;
  core.init();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);
    bbasync::commit();
    bbasync::wait<1>();  // tile t
    __syncthreads();
    st.ready(t & 1);
    if (nq == GT)  // a whole tile: its row count known at compile time
      core.template tile<S::LD>(st.keys(t & 1), st.values(t & 1), qs, ps, cs,
                                GT, min(TK, n - t * TK),
                                [](int, int) { return true; });
    else
      core.template tile<S::LD>(st.keys(t & 1), st.values(t & 1), qs, ps, cs,
                                nq, min(TK, n - t * TK),
                                [](int, int) { return true; });
    __syncthreads();  // stage t & 1 and ps are refilled next
  }
  bbasync::wait<0>();

  T* ob = out + ((size_t)b * H + h0) * HD;
  if (C == 1) {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int hh = 0; hh < CoreG::HPW; ++hh)
      if (warp + 4 * hh < nq && lane == 0) ls[warp + 4 * hh] = core.l[hh];
    __syncthreads();
    const int d = tid % HD, slot0 = tid / HD;
#pragma unroll
    for (int hh = 0; hh < CoreG::HPT; ++hh) {
      const int qr = slot0 + CoreG::HS * hh;
      if (qr < nq) {
        const float sum = ls[qr];
        ob[qr * HD + d] =
            from_f<T>(sum > 0.f ? __fdividef(core.acc[hh], sum) : 0.f);
      }
    }
    return;
  }

  // part: acc [B, HKV * nt, C, GT, HD] then (m, l) [B, HKV * nt, C, GT, 2]
  const size_t unit = (size_t)b * Y + y;
  float* const acc_all = part + unit * C * GT * HD;
  float2* const ml_all = reinterpret_cast<float2*>(
      part + (size_t)B * Y * C * GT * HD) + unit * C * GT;
  core.store(acc_all + (size_t)c * GT * HD, ml_all + c * GT, nq);
  if (!arrive_last(counter + unit, C)) return;
  // the ring's shared memory is free by now and holds the 2 * nq * C chunk
  // weights and sums (C <= MAX_SPLIT)
  merge_chunks<T, HD, GT>(acc_all, ml_all, C, GT, nq,
                          reinterpret_cast<float*>(smem_raw), qs,
                          [&](int qr) { return ob + qr * HD; });
}

template <typename T, int HD, int GT, class S>
int launch_tiles(const void* q, const S& st, const int* pt, const int* lens,
                 void* out, float* part, int* counter, int B, int H,
                 int HKV, int NP, int page_size, int window, int chunk,
                 int chunks, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<S, HD, GT>();
  cudaError_t err = cudaFuncSetAttribute(
      split_decode_kernel<T, HD, GT, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (H / HKV + GT - 1) / GT;
  const dim3 grid(chunks, HKV * nt, B);
  split_decode_kernel<T, HD, GT, S><<<grid, SNT, smem, stream>>>(
      (const T*)q, st, pt, lens, (T*)out, part, counter, H, HKV, NP,
      page_size, window, chunk, scale);
  return (int)cudaGetLastError();
}

// The launch at the group's head tile width.
template <typename T, int HD, class S, typename... A>
int launch(int H, int HKV, int chunks, A... a) {
  if (chunks < 1 || chunks > MAX_SPLIT) return -1;
  switch (decode_tile_width(H / HKV)) {
    case 1: return launch_tiles<T, HD, 1, S>(a...);
    case 2: return launch_tiles<T, HD, 2, S>(a...);
    case 4: return launch_tiles<T, HD, 4, S>(a...);
    case 8: return launch_tiles<T, HD, 8, S>(a...);
    default: return launch_tiles<T, HD, DECODE_TILE, S>(a...);
  }
}

template <typename T, int HD>
struct DenseLaunch {
  static int run(const void* q, const void* k, const void* v, const int* pt,
                 const int* lens, void* out, float* part, int* counter,
                 int B, int H, int HKV, int NP, int page_size, int window,
                 int chunk, int chunks, float scale, cudaStream_t stream) {
    using S = DenseStage<T, HD>;
    S st{};
    st.k = (const T*)k;
    st.v = (const T*)v;
    st.hkv = HKV;
    return launch<T, HD, S>(H, HKV, chunks, q, st, pt, lens, out, part,
                            counter, B, H, HKV, NP, page_size, window,
                            chunk, chunks, scale, stream);
  }
};

template <typename T, int HD>
struct Int4Launch {
  static int run(const void* q, const void* kc, const void* ks,
                 const void* kz, const void* vc, const void* vs,
                 const void* vz, const int* pt, const int* lens, void* out,
                 float* part, int* counter, int B, int H, int HKV, int NP,
                 int page_size, int window, int chunk, int chunks,
                 float scale, cudaStream_t stream) {
    using S = Int4Stage<HD>;
    S st{};
    st.kc = (const unsigned char*)kc;
    st.ksc = (const __half*)ks;
    st.kz = (const __half*)kz;
    st.vc = (const unsigned char*)vc;
    st.vsc = (const __half*)vs;
    st.vz = (const __half*)vz;
    st.hkv = HKV;
    return launch<T, HD, S>(H, HKV, chunks, q, st, pt, lens, out, part,
                            counter, B, H, HKV, NP, page_size, window,
                            chunk, chunks, scale, stream);
  }
};

}  // namespace

// dtype (of q and out; of the slabs too for the dense kernel): 0 = float32,
// 1 = bfloat16. `chunk` (keys, a multiple of page_size) and `chunks` (1 to
// MAX_SPLIT) come from the host planner. With GT = decode_tile_width(g)
// and nt = ceil(g / GT) head tiles, `part` holds
// B*HKV*nt*chunks*GT*(HD+2) floats (unused when chunks == 1) and `counter`
// B*HKV*nt ints that are 0 before the launch and 0 after it. Dense slabs
// must be 16-byte aligned; int4 codes 16-byte and scale/zero HD/16-byte
// aligned. Each returns 0, a cudaError_t code, or -1 for a plan out of
// range, a dtype / head_dim this library was not compiled for, or H not a
// multiple of HKV.
extern "C" int bb_paged_decode_attention(
    const void* q, const void* k_slab, const void* v_slab,
    const int* page_table, const int* lens, void* out, float* part,
    int* counter, int B, int H, int HKV, int HD, int NP, int page_size,
    int window, int chunk, int chunks, float scale, int dtype,
    void* stream) {
  return bbpaged::dispatch<DenseLaunch>(
      dtype, HD, H, HKV, q, k_slab, v_slab, page_table, lens, out, part,
      counter, B, H, HKV, NP, page_size, window, chunk, chunks, scale,
      (cudaStream_t)stream);
}

extern "C" int bb_paged_decode_attention_int4(
    const void* q, const void* k_codes, const void* k_scale,
    const void* k_zero, const void* v_codes, const void* v_scale,
    const void* v_zero, const int* page_table, const int* lens, void* out,
    float* part, int* counter, int B, int H, int HKV, int HD, int NP,
    int page_size, int window, int chunk, int chunks, float scale,
    int dtype, void* stream) {
  return bbpaged::dispatch<Int4Launch>(
      dtype, HD, H, HKV, q, k_codes, k_scale, k_zero, v_codes, v_scale,
      v_zero, page_table, lens, out, part, counter, B, H, HKV, NP, page_size,
      window, chunk, chunks, scale, (cudaStream_t)stream);
}
