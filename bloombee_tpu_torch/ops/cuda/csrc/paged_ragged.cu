// Paged ragged attention for Hopper (sm_90a): R query rows spread unevenly
// over B sequences (N decode rows, linearized tree-verify rows and at most
// one prefill chunk) in one launch, read straight off the paged KV arena
// (body in paged_common.cuh).
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
// Design: one CTA per (KV head, row). The row looks up its sequence and
// position and walks only that sequence's visible keys through its page
// table; the tree row is a table lookup. The Pallas kernel walks every
// sequence's pages for every row (x B masked work, a one-hot matmul in
// place of the tree gather, rows repeated per head) because Mosaic needs a
// static block per grid step; none of that is carried over.
//
// Bound on H100: bytes, as for decode: each row reads its own sequence's
// visible K/V rows (rows of one sequence re-read them, from L2 after the
// first). A query-tiled kernel that reads each page once for all rows of
// a sequence is later work.

#include "paged_common.cuh"

namespace {

using namespace bbpaged;

template <typename T, int HD, int G>
__global__ void __launch_bounds__(NT)
    ragged_kernel(const T* __restrict__ q,  // [R, H, HD]
                  DenseKV<T, HD> kv,
                  const int* __restrict__ page_table,  // [B, NP]
                  const int* __restrict__ lens,        // [B]
                  const int* __restrict__ q_seq,       // [R]
                  const int* __restrict__ q_pos,       // [R]
                  const int* __restrict__ nt,          // [B] or null
                  const int* __restrict__ tree_rows,   // [R, t_max] or null
                  T* __restrict__ out,                 // [R, H, HD]
                  int B, int HKV, int NP, int page_size, int window,
                  int t_max, float scale) {
  const int kvh = blockIdx.x, i = blockIdx.y;
  const int s = q_seq[i];
  int lo = 0, hi = 0, ss = 0;
  const int* trow = nullptr;
  if (s < B) {  // a padding row sees no key
    const int len = lens[s];
    if (tree_rows != nullptr) {
      hi = len;
      ss = len - nt[s];  // first in-step position of the sequence
      trow = tree_rows + (size_t)i * t_max;
    } else {
      const int qpos = q_pos[i];
      hi = min(len, qpos + 1);
      lo = window > 0 ? max(qpos + 1 - window, 0) : 0;
    }
  }
  hi = min(hi, NP * page_size);

  auto visible = [=](int pos) {
    if (trow == nullptr || pos < ss) return true;
    const int m = pos - ss;  // in-step key: the tree row decides
    return m < t_max && trow[m] != 0;
  };
  const size_t row = ((size_t)i * HKV + kvh) * G;
  attend_rows<T, HD, G>(q + row * HD, out + row * HD, kv, kvh,
                        page_table + (size_t)(s < B ? s : 0) * NP, page_size,
                        lo, hi, visible, scale);
}

template <typename T, int HD, int G>
struct RaggedLaunch {
  static int run(const void* q, const void* k, const void* v, const int* pt,
                 const int* lens, const int* q_seq, const int* q_pos,
                 const int* nt, const int* tree_rows, void* out, int R,
                 int B, int HKV, int NP, int page_size, int window,
                 int t_max, float scale, cudaStream_t stream) {
    const DenseKV<T, HD> kv{(const T*)k, (const T*)v, HKV};
    ragged_kernel<T, HD, G><<<dim3(HKV, R), NT, 0, stream>>>(
        (const T*)q, kv, pt, lens, q_seq, q_pos, nt, tree_rows, (T*)out, B,
        HKV, NP, page_size, window, t_max, scale);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. nt and tree_rows are both null
// (causal mode) or both set (tree mode). Returns 0, a cudaError_t code, or
// -1 for a dtype / head_dim / group size this library was not compiled for.
extern "C" int bb_paged_ragged_attention(
    const void* q, const void* k_slab, const void* v_slab,
    const int* page_table, const int* lens, const int* q_seq,
    const int* q_pos, const int* nt, const int* tree_rows, void* out, int R,
    int B, int H, int HKV, int HD, int NP, int page_size, int window,
    int t_max, float scale, int dtype, void* stream) {
  if (R == 0) return 0;
  return dispatch<RaggedLaunch>(dtype, HD, H / HKV, q, k_slab, v_slab,
                                page_table, lens, q_seq, q_pos, nt,
                                tree_rows, out, R, B, HKV, NP, page_size,
                                window, t_max, scale, (cudaStream_t)stream);
}
