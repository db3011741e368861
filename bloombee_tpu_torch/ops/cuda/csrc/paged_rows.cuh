// Device code of the row-tile paged kernels, shared by paged_ragged.cu
// (rows of several sequences in one launch) and paged_attention.cu (a
// chunk's rows of one sequence): one CTA's share of a unit (`attend_unit`)
// on the split-over-keys pieces of paged_split.cuh, with the tile body
// as an argument, and the f32 body both kernels use (`CoreBody`).
//
// A unit is at most QROWS query rows (rows x w) of one sequence for one
// head tile: w of the g query heads that share a KV head (`HeadTile`: all
// g of them for g <= QROWS, so rows of QROWS / g tokens; for g > QROWS,
// ceil(g / QROWS) tiles of at most QROWS heads and rows of one token,
// Falcon-7B's 71 heads as 36 + 35). One CTA per (key chunk, unit) reads
// the keys of its page-aligned chunk that lie in the union of the unit's
// rows' visible ranges, staged whole with cp.async in the stager's
// 2-stage ring, so every row of the unit shares each staged K/V tile, and
// hands each tile to its body. The bodies: f32
// on the CUDA cores (`CoreBody` over `Core`: every lane whole keys, one
// max and one sum per row and tile); bf16 on the tensor cores, by kernel:
// the ragged kernel's `mma.sync` body (paged_ragged.cu), the chunk
// kernel's `wgmma` warpgroup body (paged_attention.cu). Each CTA stores
// (m, l, acc) per query row in f32; the kernels merge the chunks in the
// same launch, each its own way (the ragged kernel through device memory
// and a counter, the chunk kernel within a cluster). A unit none of whose
// rows sees a key (padding rows, a lens 0 sequence) reads nothing: one CTA
// writes exact zeros, and there is no merge.

#pragma once

#include <climits>

#include "paged_split.cuh"

namespace bbsplit {

constexpr int QROWS = 64;  // query rows (rows x heads) of one unit
// the ragged kernel's most chunks: its merge keeps 2 * QROWS * MAX_CHUNKS
// f32 weights and sums in the ring (`paged_attention.RAGGED_MAX_CHUNKS`
// plans no more)
constexpr int MAX_CHUNKS = 64;

// The head tiles of a group of g query heads: ceil(g / QROWS) tiles of
// ceil(g / tiles) heads, the last one short (`head_tiles` in
// paged_attention.py is the same function).
__host__ __device__ __forceinline__ int head_tile_count(int g) {
  return (g + QROWS - 1) / QROWS;
}
__host__ __device__ __forceinline__ int head_tile_width(int g) {
  const int n = head_tile_count(g);
  return (g + n - 1) / n;
}

// A group of g query heads a KV head cut into nt head tiles of at most gt
// heads (`head_tile_count`, `head_tile_width`), each with units of tr
// tokens; computed on the host for a launch, so that a CTA divides by
// nothing when nt == 1.
struct GroupTiles {
  int g, nt, gt, tr;
  unsigned inv;  // ceil(2^16 / gt)

  GroupTiles(int H, int HKV)
      : g(H / HKV),
        nt(head_tile_count(g)),
        gt(head_tile_width(g)),
        tr(QROWS / gt),
        inv((65536u + gt - 1) / gt) {}
};

// A unit's query heads: head tile y % nt of KV head y / nt (y =
// blockIdx.y), its w heads from query head h0 on. Query row qr of the unit
// is head h0 + head(qr) of its row row(qr); a row tile is gr.tr tokens.
// row and head divide by w as a multiply and a shift (qr * ceil(2^16 / w)
// >> 16, exact for qr < 1024 and w <= QROWS), not a division per query
// row in the masks and the merges.
struct HeadTile {
  int kvh, h0, w, off;  // off: h0's place in its KV head's group
  unsigned inv;         // ceil(2^16 / w)

  __device__ HeadTile(const GroupTiles& gr, int y) {
    if (gr.nt == 1) {
      kvh = y;
      w = gr.gt;
      off = 0;
      inv = gr.inv;
    } else {
      kvh = y / gr.nt;
      off = y % gr.nt * gr.gt;
      w = min(gr.gt, gr.g - off);
      inv = (65536u + w - 1) / w;
    }
    h0 = kvh * gr.g + off;
  }
  __device__ int width() const { return w; }
  __device__ int row(int qr) const { return (unsigned)qr * inv >> 16; }
  __device__ int head(int qr) const { return qr - row(qr) * w; }
};

// Shared memory: the ring, then the query rows: bf16 (tensor cores) qm
// [QROWS][HD + 8] bf16; f32 (CUDA cores) qs [QROWS][HD], ps [QROWS][TK],
// cs [QROWS] f32.
template <typename T, int HD>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  using S = DenseStage<T, HD>;
  static_assert(2 * QROWS * MAX_CHUNKS * sizeof(float) <= S::BYTES,
                "the merge's weights fit in the ring");
  return S::BYTES + (sizeof(T) == 2
                         ? 2 * QROWS * (HD + 8)
                         : sizeof(float) * QROWS * (HD + S::TK + 1));
}

// The f32 tile body on the CUDA cores over DenseStage's padded rows: the
// unit's query rows scaled in qs, scores and corrections in ps / cs, all
// after the ring (rows_smem_bytes).
template <typename T, int HD>
struct CoreBody {
  using S = DenseStage<T, HD>;
  float* qs;  // [QROWS][HD]
  float* ps;  // [QROWS][TK]
  float* cs;  // [QROWS]
  float scale;
  int nq = 0;
  Core<T, HD, QROWS, S::TK> core;

  __device__ CoreBody(const S&, unsigned char* smem_raw, float scale_)
      : qs(reinterpret_cast<float*>(smem_raw + S::BYTES)),
        ps(qs + QROWS * HD),
        cs(ps + QROWS * S::TK),
        scale(scale_) {}
  // The unit's nq query rows, row qr at q_row(qr). All threads call this.
  template <class QRow>
  __device__ void load_q(QRow q_row, int nq_) {
    nq = nq_;
    for (int i = threadIdx.x; i < nq * HD; i += SNT)
      qs[i] = to_f(q_row(i / HD)[i % HD]) * scale;
    core.init();
  }
  __device__ void staged() {}
  // One staged tile of nk keys; on a `full` tile every row sees every key.
  template <class Vis>
  __device__ void tile(const T* kt, const T* vt, int nk, bool full,
                       Vis vis) {
    core.template tile<S::LD>(kt, vt, qs, ps, cs, nq, nk,
                              [&](int qr, int key) {
                                return full || vis(qr, key);
                              });
  }
  __device__ void store(float* acc_out, float2* ml_out) {
    core.store(acc_out, ml_out, nq);
  }
};

// One CTA's share of a unit: its `nrows` rows (nrows * ht.width() query
// rows), row r seeing the keys in [r_lo[r], r_hi[r]) (clipped to the page
// table), of which the in-step keys, at m = pos - r_ss[r] >= 0, only where
// in_step(r, m). qb: the unit's first row at its head tile's first query
// head (rows H * HD elements apart); ht: the head tile; pt: the
// sequence's page-table row.
// range(lo, hi) gives this CTA's key chunk [klo, khi) (page-aligned) from
// the union [lo, hi) of the rows' ranges. The tile body `body` (CoreBody
// or a kernel's tensor-core body) takes the unit's query rows with the
// first K/V tile (load_q), each tile once its copies have landed (staged,
// before the CTA's barrier; then tile), and stores the CTA's state of each
// query row qr at acc_c[qr * HD ..] and ml_c[qr] (device or shared memory;
// (-inf, 0) for a chunk without a key). Returns false, and stores nothing,
// when no row of the unit sees a key: the unit's output is then exact
// zeros, which the CTA with `zero_writer` set writes through out_row(qr).
// The ring `st` is bound. All threads call this after r_lo, r_hi and r_ss
// are written and synchronized; the body may reuse the ring afterwards.
template <typename T, int HD, class S, class Body, class InStep, class Range,
          class OutRow>
__device__ __forceinline__ bool attend_unit(
    const T* __restrict__ qb, int H, const HeadTile& ht, S& st,
    Body& body, const int* __restrict__ pt, int page_size, int nrows,
    const int* r_lo, const int* r_hi, const int* r_ss, InStep in_step,
    Range range, bool zero_writer, float* acc_c, float2* ml_c,
    OutRow out_row) {
  constexpr int TK = S::TK;
  const int tid = threadIdx.x, nq = nrows * ht.width(), kvh = ht.kvh;

  // the unit's keys in this chunk: the union of its rows' ranges; keys in
  // [lo_all, hi_all) are visible to every row
  int lo = INT_MAX, hi = 0, lo_all = 0, hi_all = INT_MAX;
  for (int r = 0; r < nrows; ++r) {
    if (r_lo[r] < r_hi[r]) {
      lo = min(lo, r_lo[r]);
      hi = max(hi, r_hi[r]);
    }
    lo_all = max(lo_all, r_lo[r]);
    hi_all = min(hi_all, min(r_hi[r], r_ss[r]));
  }
  if (lo >= hi) {  // no row sees a key: exact zeros, written once, no merge
    if (zero_writer)
      for (int i = tid; i < nq * HD; i += SNT)
        out_row(i / HD)[i % HD] = from_f<T>(0.f);
    return false;
  }
  const int2 kr = range(lo, hi);
  lo = max(lo, kr.x);
  hi = min(hi, kr.y);
  const int n = max(hi - lo, 0);
  const int ntiles = (n + TK - 1) / TK;

  auto load = [&](int t) {
    st.load(t & 1, n - t * TK, kvh, [&](int r) {
      const int pos = lo + t * TK + r;
      return pt[pos / page_size] * page_size + pos % page_size;
    });
  };
  if (ntiles == 0) {  // no key of the chunk: an empty state per query row
    for (int i = tid; i < nq; i += SNT)
      ml_c[i] = make_float2(-CUDART_INF_F, 0.f);
    return true;
  }
  load(0);
  body.load_q(  // in flight with the first tile
      [&](int qr) {
        return qb + ((size_t)ht.row(qr) * H + ht.head(qr)) * HD;
      },
      nq);
  bbasync::commit();

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);
    bbasync::commit();
    bbasync::wait<1>();  // tile t
    body.staged();
    __syncthreads();
    const int kbase = lo + t * TK, nk = min(TK, n - t * TK);
    const bool full = kbase >= lo_all && kbase + nk <= hi_all;
    body.tile(st.keys(t & 1), st.values(t & 1), nk, full,
              [&](int qr, int key) {
                const int r = ht.row(qr), pos = kbase + key;
                if (pos < r_lo[r] || pos >= r_hi[r]) return false;
                const int m = pos - r_ss[r];  // in-step key: in_step decides
                return m < 0 || in_step(r, m);
              });
    __syncthreads();  // stage t & 1 and the body's scratch are refilled next
  }
  bbasync::wait<0>();
  body.store(acc_c, ml_c);
  return true;
}

}  // namespace bbsplit
