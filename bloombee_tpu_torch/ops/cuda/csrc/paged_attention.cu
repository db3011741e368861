// Paged chunk attention for Hopper (sm_90a): a step of T > 1 tokens per
// sequence (a follow-up turn's chunk, a tree verify) attends its context
// straight off the paged KV arena, split over keys like the decode and
// ragged kernels.
//
// Replaces, in bloombee_tpu/ops/pallas/paged_attention.py:
// - paged_chunk_attention (body `_chunk_kernel`): q [B,T,H,hd], the step's
//   tokens at positions [lens[b]-t_real, lens[b]); causal with an optional
//   per-query window, or (tree mode) the committed prefix fully visible and
//   a [T,T] tree mask over the in-step keys. Query rows >= t_real are
//   padding (causal mode) and output zeros.
// All: page_table i32 [B,NP], lens i32 [B]; query head h reads KV head
// h / g (g = H / Hkv); keys exist only in the NP pages of the table.
//
// Bound on H100: bytes. Each sequence's visible K/V rows need reading once
// for all of its T x g query rows of a KV head (4*hd flops per query head
// and visible key). The design reads them so and fills the card at B=1:
//
// - Row tiles: each (sequence, KV head) has T * g query rows, cut into
//   units of TR = 64 / g tokens (64 query rows: 16 tokens at g = 4; 21
//   tokens, 63 rows, at g = 3). A group wider than 64 is cut into head
//   tiles of at most 64 heads (paged_rows.cuh's `HeadTile`) with units of
//   one token. The layout is regular, so a CTA finds its (sequence, row
//   tile, head tile) from blockIdx by arithmetic.
// - Split over keys: each unit's keys (the union of its rows' visible
//   ranges) are cut into `chunks` runs of whole pages, as even as pages
//   allow, on the device from lens (`chunk_split` plans the count on the
//   host from the shapes alone). One CTA of 4 warps per (chunk, KV head,
//   unit) runs paged_rows.cuh's `attend_unit`: its chunk's K/V rows staged
//   whole with cp.async in a 2-stage ring shared by all of the unit's rows.
//   bf16 runs the unit's 64 query rows as one warpgroup tile on wgmma (the
//   flash kernel's loop over a page-steered ring of 128-byte-swizzled
//   tiles, P as hi + lo bf16 terms); f32 runs on the CUDA cores. A unit
//   whose rows see no key (row tiles wholly past t_real, a lens 0
//   sequence) reads nothing: exact zeros, no merge. Causal rows past
//   t_real are left out of their unit and written as zeros by chunk 0.
// - Merge: a unit's chunks are one thread block cluster, so they run at
//   once on neighbouring SMs. Each CTA keeps its chunk's (m, l, acc) in its
//   own shared memory, and after a cluster barrier each merges a share of
//   the unit's rows from all of them through distributed shared memory.
//   The chunk states never reach device memory, and the merge is spread
//   over the cluster's SMs: a merge in one last CTA, reading every chunk's
//   state back from L2, cost more than the rest of the kernel at B=1.
// - Tree mode: a CTA whose chunk holds in-step keys first packs its rows
//   of the [T,T] u8 mask into bits in shared memory (a warp's ballot per
//   32 keys), when they fit in MASK_WORDS; a wider tile reads the mask
//   from device memory per key instead.

#include <cooperative_groups.h>

#include "paged_rows.cuh"
#include "wgmma.cuh"

namespace {

using namespace bbsplit;
namespace cg = cooperative_groups;

// 32-bit words of tree mask a CTA keeps in shared memory (4 KB): the
// tile's rows whole for T <= 32 * MASK_WORDS / TR (512 at g = 1)
constexpr int MASK_WORDS = 1024;
// the most chunks of a unit: one cluster, at most the portable size
constexpr int MAX_CLUSTER = 8;

// The chunk c of C of a unit's keys [lo, hi): its pages [p0, p1) cut into
// C runs of whole pages, as even as pages allow (`chunk_range` in
// paged_attention.py is the same function).
__device__ __forceinline__ int2 chunk_range(int c, int C, int lo, int hi,
                                            int page_size) {
  const int p0 = lo / page_size, p1 = (hi + page_size - 1) / page_size;
  const int per = (p1 - p0 + C - 1) / C;
  return make_int2((p0 + c * per) * page_size,
                   (p0 + (c + 1) * per) * page_size);
}

// The merge of a unit's C chunk states over its cluster: CTA `rank` holds
// its chunk's acc [nq][HD] and (m, l) [nq] in shared memory at acc_s /
// ml_s. After a cluster barrier CTA rank reads every peer's state of its
// share of the rows through distributed shared memory, weights chunk c by
// exp(m_c - m) (0 for a chunk without a key, whose acc is never read) and
// writes out_row(qr)[d] = sum_c w_c acc_c[d] / sum_c w_c l_c, zeros for a
// row that saw no key. A second barrier keeps every CTA's shared memory
// alive until its peers have read it.
template <typename T, int HD, class Out>
__device__ void cluster_merge(const float* acc_s, const float2* ml_s,
                              int nq, Out out_row) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  __shared__ float wm[QROWS + MAX_CLUSTER];  // [rows][C]: m, then weights
  __shared__ float wl[QROWS + MAX_CLUSTER];  // [rows][C]: l
  __shared__ float total[QROWS];
  const int per = (nq + C - 1) / C;
  const int r0 = min(rank * per, nq), nr = min(per, nq - r0);
  const int tid = threadIdx.x;
  const float NEG_INF = -CUDART_INF_F;
  cluster.sync();  // every chunk's state is in its CTA's shared memory
  for (int i = tid; i < nr * C; i += SNT) {
    const int r = i / C, c = i % C;
    const float2 x = cluster.map_shared_rank(ml_s, c)[r0 + r];
    wm[i] = x.y > 0.f ? x.x : NEG_INF;
    wl[i] = x.y;
  }
  __syncthreads();
  for (int r = tid; r < nr; r += SNT) {
    float mx = NEG_INF;
    for (int c = 0; c < C; ++c) mx = fmaxf(mx, wm[r * C + c]);
    float sum = 0.f;
    for (int c = 0; c < C; ++c) {
      const float m = wm[r * C + c];
      const float e = m == NEG_INF ? 0.f : expf(m - mx);
      wm[r * C + c] = e;
      sum = fmaf(e, wl[r * C + c], sum);
    }
    total[r] = sum;
  }
  __syncthreads();
  constexpr int V4 = HD / 4;  // float4s per row
  for (int i = tid; i < nr * V4; i += SNT) {
    const int r = i / V4, d4 = i % V4;
    float4 x[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)  // all peers' loads in flight
      if (c < C && wm[r * C + c] != 0.f)
        x[c] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc_s, c) + (size_t)(r0 + r) * HD)[d4];
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c >= C) break;
      const float e = wm[r * C + c];
      if (e == 0.f) continue;
      o.x = fmaf(x[c].x, e, o.x);
      o.y = fmaf(x[c].y, e, o.y);
      o.z = fmaf(x[c].z, e, o.z);
      o.w = fmaf(x[c].w, e, o.w);
    }
    const float t = total[r];
    const float inv = t > 0.f ? __fdividef(1.f, t) : 0.f;
    T* dst = out_row(r0 + r) + 4 * d4;
    dst[0] = from_f<T>(o.x * inv);
    dst[1] = from_f<T>(o.y * inv);
    dst[2] = from_f<T>(o.z * inv);
    dst[3] = from_f<T>(o.w * inv);
  }
  cluster.sync();  // no CTA leaves while a peer may still read it
}

// bf16 K/V rows staged whole (page-table steered, as DenseStage) into
// wgmma's 128-byte-swizzled tiles, a 2-stage ring of 64-key K and V tiles
// followed by the unit's 64-row Q tile, all in 1024-byte-aligned atoms
// (BYTES holds the alignment slack), for the warpgroup tile body WgTile.
template <int HD>
struct SwizzleStage {
  using T = __nv_bfloat16;
  using E = T;
  static constexpr int TK = 64;          // keys per tile
  static constexpr int CH = HD / 8;      // 16-byte pieces per row
  static constexpr int TILE = TK * HD * 2;  // bytes of a K, V or Q tile
  static constexpr size_t BYTES = 1024 + 5 * TILE;

  const T* k;
  const T* v;
  int hkv;
  unsigned char* ring;  // [stage][K, V][TILE], then Q [TILE]

  __device__ void bind(unsigned char* smem) {
    ring = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  }
  template <class Slot>
  __device__ void load(int st, int rows, int kvh, Slot slot) {
    constexpr int ITEMS = TK * CH / SNT;
    static_assert(TK * CH % SNT == 0, "whole pieces per thread");
    unsigned char* kd = ring + st * 2 * TILE;
    const int piece = threadIdx.x % CH, r0 = threadIdx.x / CH;
    int slots[ITEMS];  // every lookup before the first copy (see Dense)
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int r = r0 + j * (SNT / CH);
      slots[j] = slot(r < rows ? r : 0);
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int r = r0 + j * (SNT / CH);
      const size_t off = ((size_t)slots[j] * hkv + kvh) * HD + piece * 8;
      const int at = bbwgmma::swizzled(TK, r, piece);
      bbasync::copy16(kd + at, k + off, r < rows);
      bbasync::copy16(kd + TILE + at, v + off, r < rows);
    }
  }
  __device__ const unsigned char* keys(int st) const {
    return ring + st * 2 * TILE;
  }
  __device__ const unsigned char* values(int st) const {
    return ring + st * 2 * TILE + TILE;
  }
  __device__ unsigned char* queries() const { return ring + 4 * TILE; }
};

// The bf16 tile body: the unit's 64 query rows as one warpgroup tile on
// wgmma (bbwgmma::WgTile) over SwizzleStage's tiles, the Q tile copied
// with the first K/V tile. Rows past nq hold zeros and are never stored.
template <int HD>
struct WgBody {
  using S = SwizzleStage<HD>;
  unsigned char* qt;
  float scale;
  int nq = 0;
  bbwgmma::WgTile<HD> wg;

  __device__ WgBody(const S& st, unsigned char*, float scale_)
      : qt(st.queries()), scale(scale_) {}
  template <class QRow>
  __device__ void load_q(QRow q_row, int nq_) {
    nq = nq_;
    constexpr int CH = HD / 8;
    for (int i = threadIdx.x; i < 64 * CH; i += SNT) {
      const int qr = i / CH, piece = i % CH;
      const __nv_bfloat16* src = q_row(qr < nq ? qr : 0) + piece * 8;
      bbasync::copy16(qt + bbwgmma::swizzled(64, qr, piece), src, qr < nq);
    }
    wg.init();
  }
  // the copies are generic-proxy writes; wgmma reads by the async proxy
  __device__ void staged() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // One staged tile of nk keys. Only a tile that not every row sees whole
  // (or a short one, whose zero-filled keys must not count) tests vis; the
  // rows past nq have no range or tree entries of the unit, so they see
  // nothing there.
  template <class Vis>
  __device__ void tile(const unsigned char* kt, const unsigned char* vt,
                       int nk, bool full, Vis vis) {
    wg.tile(kt, vt, qt, !full || nk < S::TK,
            [&](int qr, int key) {
              return qr < nq && key < nk && vis(qr, key);
            },
            scale * 1.4426950408889634f);  // log2(e)
  }
  __device__ void store(float* acc_out, float2* ml_out) {
    wg.store(acc_out, ml_out, nq, scale);
  }
};

// The K/V stager and body by dtype: bf16 on wgmma over swizzled tiles,
// f32 on the CUDA cores over padded rows; and their shared memory.
template <typename T, int HD>
struct StageOf {
  using type = DenseStage<T, HD>;
  using body = CoreBody<T, HD>;
  static constexpr size_t smem = rows_smem_bytes<T, HD>();
};
template <int HD>
struct StageOf<__nv_bfloat16, HD> {
  using type = SwizzleStage<HD>;
  using body = WgBody<HD>;
  static constexpr size_t smem = SwizzleStage<HD>::BYTES;
};

template <typename T, int HD>
__global__ void __launch_bounds__(SNT)
    chunk_kernel(const T* __restrict__ q,  // [B, TQ, H, HD]
                 typename StageOf<T, HD>::type st,
                 const int* __restrict__ page_table,  // [B, NP]
                 const int* __restrict__ lens,        // [B]
                 const unsigned char* __restrict__ tree,  // [B,TQ,TQ]/null
                 T* __restrict__ out,  // [B, TQ, H, HD]
                 GroupTiles gr, int TQ, int H, int NP, int page_size,
                 int window, int t_real, int tiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  st.bind(smem_raw);
  // per row of the tile: visible keys [lo, hi), in-step keys from ss on
  __shared__ int r_lo[QROWS], r_hi[QROWS], r_ss[QROWS];
  __shared__ unsigned tm[MASK_WORDS];  // tree mask bits [nrows][W]

  // the cluster is the unit's C chunks: blockIdx.x = c; blockIdx.y the
  // head tile, blockIdx.z the (sequence, row tile)
  const HeadTile ht(gr, blockIdx.y);
  const int TR = gr.tr, w = ht.width();  // tokens of a row tile
  const int c = blockIdx.x, C = gridDim.x;
  const int b = blockIdx.z / tiles, t0 = blockIdx.z % tiles * TR;
  const int tid = threadIdx.x;
  const size_t i0 = (size_t)b * TQ + t0;
  auto out_row = [&](int qr) {
    return out + ((i0 + ht.row(qr)) * H + ht.h0 + ht.head(qr)) * HD;
  };
  // causal mode: the tile's rows past t_real are padding, exact zeros
  // written by chunk 0 and left out of the unit
  const int nrows =
      max(min(TR, (tree != nullptr ? TQ : min(TQ, t_real)) - t0), 0);
  if (c == 0)
    for (int i = nrows * w * HD + tid; i < min(TR, TQ - t0) * w * HD;
         i += SNT)
      out_row(i / HD)[i % HD] = from_f<T>(0.f);
  const int len = lens[b], start = len - t_real;
  if (tid < nrows) {
    const int qt = t0 + tid;
    int lo = 0, hi = 0, ss = INT_MAX;
    if (tree != nullptr) {
      hi = len;
      ss = start;
    } else {
      const int qpos = start + qt;
      hi = min(len, qpos + 1);
      lo = window > 0 ? max(qpos + 1 - window, 0) : 0;
    }
    r_lo[tid] = lo;
    r_hi[tid] = min(hi, NP * page_size);
    r_ss[tid] = ss;
  }
  // tree mode: the tile's mask rows as bits (a warp's ballot per 32 keys),
  // when they fit; the rows' union is [0, min(len, NP * page_size))
  const int W = (TQ + 31) / 32;
  const unsigned char* trows =
      tree == nullptr ? nullptr : tree + ((size_t)b * TQ + t0) * TQ;
  const bool packed = trows != nullptr && nrows * W <= MASK_WORDS;
  if (packed) {
    const int2 kr = chunk_range(c, C, 0, min(len, NP * page_size),
                                page_size);
    if (kr.x < len && kr.y > start) {  // the chunk holds in-step keys
      const int warp = tid >> 5, lane = tid & 31;
      for (int i = warp; i < nrows * W; i += SNT / 32) {
        const int r = i / W, col = i % W * 32 + lane;
        const unsigned bits = __ballot_sync(
            0xffffffffu, col < TQ && trows[(size_t)r * TQ + col] != 0);
        if (lane == 0) tm[i] = bits;
      }
    }
  }
  __syncthreads();

  // this CTA's chunk state, in the ring once the walk is done with it
  float* acc_s = reinterpret_cast<float*>(smem_raw);
  float2* ml_s = reinterpret_cast<float2*>(acc_s + QROWS * HD);
  typename StageOf<T, HD>::body body(st, smem_raw, scale);
  if (!attend_unit<T, HD>(
          q + (i0 * H + ht.h0) * HD, H, ht, st, body,
          page_table + (size_t)b * NP, page_size, nrows, r_lo, r_hi, r_ss,
          [&](int r, int m) {  // the m-th in-step key: the tree row decides
            if (m >= TQ) return false;
            if (packed) return ((tm[r * W + m / 32] >> (m % 32)) & 1u) != 0;
            return trows[(size_t)r * TQ + m] != 0;
          },
          [&](int lo, int hi) {
            return chunk_range(c, C, lo, hi, page_size);
          },
          c == 0, acc_s, ml_s, out_row))
    return;  // the whole cluster: no row sees a key
  cluster_merge<T, HD>(acc_s, ml_s, nrows * w, out_row);
}

template <typename T, int HD>
struct ChunkLaunch {
  static int run(const void* q, const void* k, const void* v, const int* pt,
                 const int* lens, const unsigned char* tree, void* out, int B,
                 int TQ, int H, int HKV, int NP, int page_size, int window,
                 int t_real, int chunks, float scale, cudaStream_t stream) {
    using S = typename StageOf<T, HD>::type;
    static_assert(QROWS * (HD * sizeof(float) + sizeof(float2)) <=
                      S::BYTES,
                  "a chunk's state fits in the ring");
    auto kernel = chunk_kernel<T, HD>;
    const size_t smem = StageOf<T, HD>::smem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)  // all shared memory: two CTAs an SM
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    S st{};
    st.k = (const T*)k;
    st.v = (const T*)v;
    st.hkv = HKV;
    // row tiles of tr tokens for nt head tiles of gt heads per KV head
    const GroupTiles gr(H, HKV);
    const int tiles = (TQ + gr.tr - 1) / gr.tr;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(chunks, HKV * gr.nt, B * tiles);
    cfg.blockDim = dim3(SNT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = chunks;  // a unit's chunks: one cluster
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, (const T*)q, st, pt, lens, tree,
                             (T*)out, gr, TQ, H, NP, page_size, window,
                             t_real, tiles, scale);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
};

}  // namespace

// dtype (of q, the slabs and out): 0 = float32, 1 = bfloat16. tree is null
// (causal mode) or [B, TQ, TQ] u8. `chunks` (1 to MAX_CLUSTER, from the
// host planner `chunk_split`) is the CTAs per unit and the cluster size.
// The slabs and q must be 16-byte aligned. Returns 0, a cudaError_t code,
// or -1 for a plan out of range, a dtype / head_dim this library was not
// compiled for, or H not a multiple of HKV.
extern "C" int bb_paged_chunk_attention(
    const void* q, const void* k_slab, const void* v_slab,
    const int* page_table, const int* lens, const unsigned char* tree,
    void* out, int B, int TQ, int H, int HKV, int HD, int NP, int page_size,
    int window, int t_real, int chunks, float scale, int dtype,
    void* stream) {
  if (B == 0 || TQ == 0) return 0;
  if (chunks < 1 || chunks > MAX_CLUSTER) return -1;
  return bbpaged::dispatch<ChunkLaunch>(
      dtype, HD, H, HKV, q, k_slab, v_slab, page_table, lens, tree, out, B,
      TQ, H, HKV, NP, page_size, window, t_real, chunks, scale,
      (cudaStream_t)stream);
}
