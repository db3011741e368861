// Paged chunk attention for Hopper (sm_90a): attention read straight off
// the paged KV arena, the page table steering each key read, online softmax
// in f32 (body and K/V row reader in paged_common.cuh). The decode kernels
// (bf16/f32 and int4) are split over keys in paged_decode.cu, the ragged
// kernel in paged_ragged.cu.
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
// One CTA per (KV head, query token, sequence). Bound on H100: bytes. The
// kernel re-reads the context once per query token (from L2 after the
// first), which a later query-tiled kernel removes.

#include "paged_common.cuh"

namespace {

using namespace bbpaged;

template <typename T, int HD, int G, class KV>
__global__ void __launch_bounds__(NT)
    paged_kernel(const T* __restrict__ q,  // [B, TQ, H, HD]
                 KV kv,
                 const int* __restrict__ page_table,  // [B, NP]
                 const int* __restrict__ lens,        // [B]
                 const unsigned char* __restrict__ tree,  // [B,TQ,TQ]/null
                 T* __restrict__ out,  // [B, TQ, H, HD]
                 int TQ, int HKV, int NP, int page_size, int window,
                 int t_real, float scale) {
  const int kvh = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
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

  const unsigned char* trow =
      tree != nullptr ? tree + ((size_t)b * TQ + qt) * TQ : nullptr;
  auto visible = [=](int pos) {
    if (trow == nullptr || pos < start) return true;
    const int rel = pos - start;  // in-step key: the tree decides
    return rel < TQ && trow[rel] != 0;
  };
  const size_t row = (((size_t)b * TQ + qt) * HKV + kvh) * G;
  attend_rows<T, HD, G>(q + row * HD, out + row * HD, kv, kvh,
                        page_table + (size_t)b * NP, page_size, lo, hi,
                        visible, scale);
}

template <typename T, int HD, int G>
struct DenseLaunch {
  static int run(const void* q, const void* k, const void* v, const int* pt,
                 const int* lens, const unsigned char* tree, void* out,
                 int B, int TQ, int HKV, int NP, int page_size, int window,
                 int t_real, float scale, cudaStream_t stream) {
    const DenseKV<T, HD> kv{(const T*)k, (const T*)v, HKV};
    paged_kernel<T, HD, G><<<dim3(HKV, TQ, B), NT, 0, stream>>>(
        (const T*)q, kv, pt, lens, tree, (T*)out, TQ, HKV, NP, page_size,
        window, t_real, scale);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// dtype (of q, the slabs and out): 0 = float32, 1 = bfloat16. Returns 0, a
// cudaError_t code, or -1 for a dtype / head_dim / group size this library
// was not compiled for.
extern "C" int bb_paged_chunk_attention(
    const void* q, const void* k_slab, const void* v_slab,
    const int* page_table, const int* lens, const unsigned char* tree,
    void* out, int B, int TQ, int H, int HKV, int HD, int NP, int page_size,
    int window, int t_real, float scale, int dtype, void* stream) {
  return dispatch<DenseLaunch>(dtype, HD, H / HKV, q, k_slab, v_slab,
                               page_table, lens, tree, out, B, TQ, HKV, NP,
                               page_size, window, t_real, scale,
                               (cudaStream_t)stream);
}
