// Paged ragged attention for Hopper (sm_90a): R query rows spread unevenly
// over B sequences (N decode rows, linearized tree-verify rows and at most
// one prefill chunk) in one launch, read straight off the paged KV arena,
// split over keys like the decode kernels (paged_split.cuh).
//
// Replaces bloombee_tpu/ops/pallas/paged_attention.py::paged_ragged_attention
// (body `_ragged_kernel`): q [R,H,hd], slabs [S_tot,Hkv,hd], page_table i32
// [B,NP], lens i32 [B], q_seq / q_pos i32 [R]. Row i is owned by sequence
// q_seq[i] (>= B: a padding row, output zeros) at position q_pos[i].
// Causal mode: keys at positions < lens[b] and <= q_pos, and > q_pos -
// window when window > 0. Tree mode (nt i32 [B], tree_rows i32 [R,t_max]):
// keys below lens[b] - nt[b] (the committed prefix) are visible, and the
// m-th in-step key iff tree_rows[i, m] != 0.
//
// Bound on H100: bytes. Each sequence's visible K/V rows need reading once
// for all of its rows (4*hd flops per query head and visible key). The
// Pallas kernel walks every sequence's pages for every row (a static block
// per grid step for Mosaic); none of that is carried over. The design:
//
// - The rows are cut into segments: a segment starts at every multiple of
//   TR = 64 / g rows (at most 64 query rows of one KV head) and wherever
//   the owning sequence changes, so it holds at most TR rows of one
//   sequence. A group wider than 64 is cut into head tiles
//   (paged_rows.cuh's `HeadTile`: Falcon-7B's 71 heads as 36 + 35) with
//   segments of one row. Each sequence's key range [0, NP*page_size) is
//   cut into `chunks` page-aligned chunks. One CTA of 4 warps per (chunk,
//   head tile, segment): the grid's
//   segment axis is sized on the host from the shapes alone (`ragged_split`:
//   ceil(R / TR) row tiles plus one per sequence, which bounds the segments
//   when each sequence's rows are contiguous and the padding rows come last,
//   as the executor packs them), and each CTA finds its own segment from
//   q_seq (a ballot over the rows). Any other layout is computed right too:
//   the grid's last CTA of each (chunk, KV head) walks every segment past
//   the grid, one after another. A CTA past the last segment leaves at once.
//   The rows of a segment share every K/V tile it reads: a tree step's 8
//   rows read their prefix once, not 8 times, and decode rows of different
//   sequences run in parallel CTAs, not one after another.
// - A segment is a unit of paged_rows.cuh's `attend_unit`, which the chunk
//   kernel (paged_attention.cu) runs too: its keys of a chunk staged whole
//   with cp.async, bf16 on the tensor cores (`MmaBody` below: mma.sync
//   m16n8k16, 1, 2 or 4 warps per 16 query rows, P as hi + lo bf16
//   terms), f32 on the CUDA cores (`CoreBody`), the chunks merged by the last
//   CTA of each (segment, head tile) in the same launch, counted by one
//   counter per first row of a segment and head tile. A segment of padding
//   rows or of a lens 0 sequence reads nothing: exact zeros, no merge.

#include <type_traits>

#include "paged_rows.cuh"

namespace {

using namespace bbsplit;

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p,
                                        bool trans) {
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(bbasync::smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(bbasync::smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&h);
}

// p (two probabilities) as hi + lo bf16 terms
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
  const float xh = __bfloat162float(__float2bfloat16_rn(x));
  const float yh = __bfloat162float(__float2bfloat16_rn(y));
  hi = pack(xh, yh);
  lo = pack(x - xh, y - yh);
}

// The tensor-core tile body for a segment's nq <= 64 query rows: row
// block rb (16 query rows of qm [QROWS][HD + 8] bf16; rows past nq are
// zeros) and key part kp (TK / KS keys of the tile) per warp, KS = 4 / NB
// warps sharing each of the NB = 4 / KS row blocks, so that all 4 warps
// work on a short segment too (one decode row: 4 key parts of 16 keys).
// The warps of a row block agree on one max per row and tile through
// shared memory (`red`), so their partial sums and P.V accumulators share
// one scale and add up at the end. Accumulators sit in mma's C layout
// (rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4) + {0, 1} of each
// 8-wide tile).
template <int HD>
struct Mma {
  static constexpr int LDQ = HD + 8;
  float o[HD / 8][4];
  float m[2], l[2];  // l: this lane's share of its rows' sums

  __device__ void init() {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -CUDART_INF_F;
      l[r] = 0.f;
    }
  }

  // red: shared [KS][QROWS] floats. All threads call this.
  template <int KS, int LD, int TK, class Vis>
  __device__ void tile(const __nv_bfloat16* kt, const __nv_bfloat16* vt,
                       const __nv_bfloat16* qm, int nq, int nk, float scale,
                       Vis vis, float* red) {
    constexpr int NB = 4 / KS, KW = TK / KS;  // row blocks, keys per warp
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rb = warp % NB, k0 = warp / NB * KW;
    const bool active = 16 * rb < nq;
    const int g = lane >> 2, t4 = lane & 3;
    const float NEG_INF = -CUDART_INF_F;

    float s[KW / 8][4];
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a,
                qm + (16 * rb + (lane & 7) + ((lane >> 3) & 1) * 8) * LDQ +
                    kk * 16 + (lane >> 4) * 8,
                false);
#pragma unroll
        for (int np = 0; np < KW / 16; ++np) {
          unsigned b[4];
          ldsm_x4(b,
                  kt + (k0 + 16 * np + (lane & 7) + (lane >> 4) * 8) * LD +
                      kk * 16 + ((lane >> 3) & 1) * 8,
                  false);
          mma16816(s[2 * np], a, b[0], b[1]);
          mma16816(s[2 * np + 1], a, b[2], b[3]);
        }
      }
    }

    // one max per query row and tile: over this warp's keys (4 lanes
    // share a row), then over the key parts
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = 16 * rb + g + 8 * r;
      mx[r] = NEG_INF;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t4 + e;
          float& x = s[j][2 * r + e];
          x = qr < nq && key < nk && vis(qr, key) ? x * scale : NEG_INF;
          mx[r] = fmaxf(mx[r], x);
        }
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if constexpr (KS > 1) {
      if (t4 == 0) {
        red[warp / NB * QROWS + 16 * rb + g] = mx[0];
        red[warp / NB * QROWS + 16 * rb + g + 8] = mx[1];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int p = 0; p < KS; ++p)
          mx[r] = fmaxf(mx[r], red[p * QROWS + 16 * rb + g + 8 * r]);
    }
    if (!active) return;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      const float base = m_new == NEG_INF ? 0.f : m_new;
      const float corr = __expf(m[r] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = __expf(x - base);
          sum += x;
        }
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }

    // P.V: the score accumulators of keys 16 kk .. 16 kk + 15 of this
    // warp's part are mma's A fragment of that k-step; keys past nk have
    // p = 0 and zeroed rows
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      unsigned ah[4], al[4];
      split2(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned b[4];
        ldsm_x4(b,
                vt + (k0 + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                         LD +
                    16 * dp + (lane >> 4) * 8,
                true);
        mma16816(o[2 * dp], ah, b[0], b[1]);
        mma16816(o[2 * dp], al, b[0], b[1]);
        mma16816(o[2 * dp + 1], ah, b[2], b[3]);
        mma16816(o[2 * dp + 1], al, b[2], b[3]);
      }
    }
  }

  // The state of query rows [0, nq) into part, the key parts' accumulators
  // and sums added up through `scratch` (shared, (KS - 1) * (64 / KS) *
  // (HD + 1) floats, free to overwrite). All threads call this.
  template <int KS>
  __device__ void store(float* acc_out, float2* ml_out, int nq,
                        float* scratch) {
    constexpr int NB = 4 / KS, QB = 16 * NB;  // query rows of the parts
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rb = warp % NB, kp = warp / NB;
    const int g = lane >> 2, t4 = lane & 3;
    float* ls = scratch + (KS - 1) * QB * HD;  // [KS - 1][QB] sums
    float sum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = l[r];
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    const bool active = 16 * rb < nq;
    if constexpr (KS > 1) {
      __syncthreads();  // every warp is done with the ring
      if (kp > 0 && active) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qr = 16 * rb + g + 8 * r;
          float* dst = scratch + ((kp - 1) * QB + qr) * HD;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j + 2 * t4) =
                make_float2(o[j][2 * r], o[j][2 * r + 1]);
          if (t4 == 0) ls[(kp - 1) * QB + qr] = sum[r];
        }
      }
      __syncthreads();
    }
    if (kp > 0 || !active) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = 16 * rb + g + 8 * r;
      if (qr >= nq) continue;
#pragma unroll
      for (int p = 1; p < KS; ++p) {
        const float* src = scratch + ((p - 1) * QB + qr) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const float2 x =
              *reinterpret_cast<const float2*>(src + 8 * j + 2 * t4);
          o[j][2 * r] += x.x;
          o[j][2 * r + 1] += x.y;
        }
        sum[r] += ls[(p - 1) * QB + qr];
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(acc_out + qr * HD + 8 * j + 2 * t4) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (t4 == 0) ml_out[qr] = make_float2(m[r], sum[r]);
    }
  }
};

// The bf16 tile body over DenseStage's padded rows: the unit's query rows
// in qm [QROWS][HD + 8] bf16 after the ring (rows past nq zeros, to a
// multiple of 16), 4, 2 or 1 warps per block of 16 query rows as nq asks,
// and the ring as the store's scratch.
template <int HD>
struct MmaBody {
  using T = __nv_bfloat16;
  using S = DenseStage<T, HD>;
  T* qm;
  float* scratch;
  float scale;
  int nq = 0, ks = 1;
  Mma<HD> mma;

  __device__ MmaBody(const S&, unsigned char* smem_raw, float scale_)
      : qm(reinterpret_cast<T*>(smem_raw + S::BYTES)),
        scratch(reinterpret_cast<float*>(smem_raw)),
        scale(scale_) {}
  __device__ static float* red() {  // [4][QROWS]: the warps' row maxima
    __shared__ float r[4 * QROWS];
    return r;
  }
  // The unit's nq query rows, row qr at q_row(qr), as cp.async copies
  // (committed with the first K/V tile). All threads call this.
  template <class QRow>
  __device__ void load_q(QRow q_row, int nq_) {
    nq = nq_;
    const int pad = (nq + 15) / 16 * 16;
    ks = pad == 16 ? 4 : pad == 32 ? 2 : 1;
    for (int i = threadIdx.x; i < pad * (HD / 8); i += SNT) {
      const int qr = i / (HD / 8), piece = i % (HD / 8);
      const T* src = q_row(qr < nq ? qr : 0) + piece * 8;  // past nq: zeros
      bbasync::copy16(qm + qr * (HD + 8) + piece * 8, src, qr < nq);
    }
    mma.init();
  }
  __device__ void staged() {}
  // One staged tile of nk keys; on a `full` tile every row sees every key.
  template <class Vis>
  __device__ void tile(const T* kt, const T* vt, int nk, bool full,
                       Vis vis) {
    auto v = [&](int qr, int key) { return full || vis(qr, key); };
    if (ks == 4)
      mma.template tile<4, S::LD, S::TK>(kt, vt, qm, nq, nk, scale, v, red());
    else if (ks == 2)
      mma.template tile<2, S::LD, S::TK>(kt, vt, qm, nq, nk, scale, v, red());
    else
      mma.template tile<1, S::LD, S::TK>(kt, vt, qm, nq, nk, scale, v, red());
  }
  __device__ void store(float* acc_out, float2* ml_out) {
    if (ks == 4)
      mma.template store<4>(acc_out, ml_out, nq, scratch);
    else if (ks == 2)
      mma.template store<2>(acc_out, ml_out, nq, scratch);
    else
      mma.template store<1>(acc_out, ml_out, nq, scratch);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(SNT)
    ragged_kernel(const T* __restrict__ q,  // [R, H, HD]
                  DenseStage<T, HD> st,
                  const int* __restrict__ page_table,  // [B, NP]
                  const int* __restrict__ lens,        // [B]
                  const int* __restrict__ q_seq,       // [R]
                  const int* __restrict__ q_pos,       // [R]
                  const int* __restrict__ nt,          // [B] or null
                  const int* __restrict__ tree_rows,   // [R, t_max] or null
                  T* __restrict__ out,                 // [R, H, HD]
                  float* __restrict__ part,            // chunk states
                  int* __restrict__ counter,  // [R * HKV * nt], zero
                  GroupTiles gr, int R, int B, int H, int HKV, int NP,
                  int page_size, int window, int t_max, int chunk,
                  float scale) {
  // bf16 on the tensor cores, f32 on the CUDA cores
  using Body =
      std::conditional_t<sizeof(T) == 2, MmaBody<HD>, CoreBody<T, HD>>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  st.bind(smem_raw);
  Body body(st, smem_raw, scale);
  // per row of the segment: visible keys [lo, hi), in-step keys from ss
  // on (tree mode)
  __shared__ int r_lo[QROWS], r_hi[QROWS], r_ss[QROWS];
  __shared__ int seg[2], counts[SNT / 32];
  __shared__ float total[QROWS];  // the merge's per-row sums

  // blockIdx.y: the head tile (HeadTile), w query heads of a row
  const HeadTile ht(gr, blockIdx.y);
  const int TR = gr.tr, w = ht.width(), g = gr.g;
  const int c = blockIdx.x, kvh = ht.kvh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cap = NP * page_size;

  // segment z = blockIdx.z; the grid's last z goes on to every segment
  // past the grid, one after another
  for (int z = blockIdx.z;; ++z) {
    if (z > (int)blockIdx.z) {
      if (blockIdx.z + 1 < gridDim.z) return;
      __syncthreads();  // the last segment's shared memory is free
    }
    // this CTA's segment of rows: a segment starts at every multiple of TR
    // and wherever the owning sequence changes (all padding rows, q_seq >=
    // B, count as one owner); segment z is [seg[0], seg[1])
    if (tid == 0) seg[0] = seg[1] = R;
    int before = 0;  // segment starts in earlier rounds
    for (int base = 0; base < R && before <= z + 1; base += SNT) {
      const int i = base + tid;
      bool start = false;
      if (i < R) {
        const int s = q_seq[i], p = i > 0 ? q_seq[i - 1] : 0;
        start = i % TR == 0 || (s < B ? s : -1) != (p < B ? p : -1);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, start);
      if (lane == 0) counts[warp] = __popc(mask);
      __syncthreads();
      int rank = before + __popc(mask & ((1u << lane) - 1));
      int n_starts = 0;
#pragma unroll
      for (int w = 0; w < SNT / 32; ++w) {
        rank += w < warp ? counts[w] : 0;
        n_starts += counts[w];
      }
      if (start && rank == z) seg[0] = i;
      if (start && rank == z + 1) seg[1] = i;
      before += n_starts;
      __syncthreads();
    }
    const int i0 = seg[0], i1 = seg[1];
    if (i0 >= R) return;  // no segment z: its unit has no CTA that counts
    const int nrows = i1 - i0;
    const int s0 = q_seq[i0];
    const int s = s0 < B ? s0 : -1;  // -1: padding rows, which see no key

    if (tid < nrows) {
      const int i = i0 + tid;
      int lo = 0, hi = 0, ss = INT_MAX;
      if (s >= 0) {
        const int len = lens[s];
        if (tree_rows != nullptr) {
          hi = len;
          ss = len - nt[s];
        } else {
          const int qpos = q_pos[i];
          hi = min(len, qpos + 1);
          lo = window > 0 ? max(qpos + 1 - window, 0) : 0;
        }
      }
      r_lo[tid] = lo;
      r_hi[tid] = min(hi, cap);
      r_ss[tid] = ss;
    }
    __syncthreads();

    // part: acc [HKV, C, R * g, HD] then (m, l) [HKV, C, R * g]; the
    // unit's query rows are contiguous there from row i0 * g + ht.off (a
    // head tile narrower than g has one-row segments)
    const int C = gridDim.x;
    const size_t RQ = (size_t)R * g, u0 = (size_t)i0 * g + ht.off;
    float* const acc_all = part + (size_t)kvh * C * RQ * HD + u0 * HD;
    float2* const ml_all = reinterpret_cast<float2*>(
        part + (size_t)HKV * C * RQ * HD) + (size_t)kvh * C * RQ + u0;
    auto out_row = [&](int qr) {
      return out +
             ((size_t)(i0 + ht.row(qr)) * H + ht.h0 + ht.head(qr)) * HD;
    };
    const bool stored = attend_unit<T, HD>(
        q + ((size_t)i0 * H + ht.h0) * HD, H, ht, st, body,
        page_table + (size_t)max(s, 0) * NP, page_size, nrows, r_lo, r_hi,
        r_ss,
        [&](int r, int m) {  // the m-th in-step key: the tree row decides
          return m < t_max && tree_rows[(size_t)(i0 + r) * t_max + m] != 0;
        },
        [&](int, int) { return make_int2(c * chunk, (c + 1) * chunk); },
        c == 0, acc_all + (size_t)c * RQ * HD, ml_all + (size_t)c * RQ,
        out_row);
    if (!stored ||
        !arrive_last(counter + (size_t)i0 * gridDim.y + blockIdx.y, C))
      continue;
    // the ring's shared memory holds the 2 * nq * C chunk weights and sums
    // (nq <= QROWS, C <= MAX_CHUNKS)
    merge_chunks<T, HD, QROWS>(acc_all, ml_all, C, (int)RQ, nrows * w,
                               reinterpret_cast<float*>(smem_raw), total,
                               out_row);
  }
}

template <typename T, int HD>
struct RaggedLaunch {
  static int run(const void* q, const void* k, const void* v, const int* pt,
                 const int* lens, const int* q_seq, const int* q_pos,
                 const int* nt, const int* tree_rows, void* out, float* part,
                 int* counter, int R, int B, int H, int HKV, int NP,
                 int page_size, int window, int t_max, int chunk, int chunks,
                 int segments, float scale, cudaStream_t stream) {
    const size_t smem = rows_smem_bytes<T, HD>();
    cudaError_t err = cudaFuncSetAttribute(
        ragged_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    DenseStage<T, HD> st{};
    st.k = (const T*)k;
    st.v = (const T*)v;
    st.hkv = HKV;
    const GroupTiles gr(H, HKV);
    const dim3 grid(chunks, HKV * gr.nt, segments);
    ragged_kernel<T, HD><<<grid, SNT, smem, stream>>>(
        (const T*)q, st, pt, lens, q_seq, q_pos, nt, tree_rows, (T*)out,
        part, counter, gr, R, B, H, HKV, NP, page_size, window, t_max, chunk,
        scale);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. nt and tree_rows are both null (causal
// mode) or both set (tree mode). The plan comes from the host planner
// (`ragged_split`): `chunk` keys (a multiple of page_size) in each of
// `chunks` <= MAX_CHUNKS chunks, and `segments` CTAs along the grid's
// segment axis (any number >= 1 is right; too few walks the rest one after
// another). `part` holds HKV*chunks*R*g*(HD+2) floats and `counter`
// R*HKV*nt ints (nt: the head tiles of a KV head, `head_tile_count`) that
// are 0 before the launch and 0 after it. The slabs and q must be 16-byte
// aligned. Returns 0, a cudaError_t code, or -1 for a plan out of range, a
// dtype / head_dim this library was not compiled for, or H not a multiple
// of HKV.
extern "C" int bb_paged_ragged_attention(
    const void* q, const void* k_slab, const void* v_slab,
    const int* page_table, const int* lens, const int* q_seq,
    const int* q_pos, const int* nt, const int* tree_rows, void* out,
    float* part, int* counter, int R, int B, int H, int HKV, int HD, int NP,
    int page_size, int window, int t_max, int chunk, int chunks,
    int segments, float scale, int dtype, void* stream) {
  if (R == 0) return 0;
  if (chunks < 1 || chunks > MAX_CHUNKS || segments < 1) return -1;
  return bbpaged::dispatch<RaggedLaunch>(
      dtype, HD, H, HKV, q, k_slab, v_slab, page_table, lens, q_seq, q_pos,
      nt, tree_rows, out, part, counter, R, B, H, HKV, NP, page_size, window,
      t_max, chunk, chunks, segments, scale, (cudaStream_t)stream);
}
