// Hopper warpgroup tensor-core pieces (wgmma), shared by the bf16 flash
// kernel (flash_attention.cu) and the bf16 chunk kernel
// (paged_attention.cu): the 128-byte-swizzled shared-memory tile layout,
// wgmma's matrix descriptors and the m64n64k16 / m64n{64,128}k16 products
// with their fences, P's split into two bf16 terms; and the chunk kernel's
// tile body (`WgTile`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "async_copy.cuh"

namespace bbwgmma {

// Byte offset of the 16-byte piece p (elements 8p..8p+7) of row r in a
// swizzled tile of R rows.
__device__ __forceinline__ int swizzled(int R, int r, int p) {
  return (p >> 3) * R * 128 + r * 128 + (((p & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; lbo / sbo: the
// byte strides between column blocks and between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  const uint64_t a = bbasync::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers that an in-flight wgmma reads or writes: the compiler may
// not move their uses across this point.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(unsigned (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// D = A B (init) or D += A B for m64n64k16: A (64 x 16) and B (16 x 64),
// both K-major in shared memory, by descriptor.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int init) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(init));
}

// D += A B for m64n64k16: A (64 x 16) from registers (each warp's 16
// rows in the mma.m16n8k16 A layout), B (16 x 64) MN-major in shared
// memory, by descriptor.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const unsigned (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D += A B for m64n128k16: A (64 x 16) from registers (each warp's 16
// rows in the mma.m16n8k16 A layout), B (16 x 128) MN-major in shared
// memory, by descriptor.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const unsigned (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const unsigned (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (HD == 128) {
    wgmma_rs_n128(o, a, desc_b);
  } else {
    wgmma_rs_n64(o, a, desc_b);
  }
}

// 2^x by the SFU (ex2.approx, ~2^-22 relative error; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The pair (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16 of the
// remainder, so hi + lo carries ~16 bits of each value.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// One warpgroup's tile of FlashAttention-2's loop for 64 query rows (bf16
// in, f32 state), over 64-key K/V tiles in the swizzled layout: the chunk
// kernel's body. It takes the same steps as flash_bf16_kernel's loop,
// which keeps its own copy (run through this struct it measured 2-10%
// slower). S = Q K^T is wgmma m64n64k16 from the Q and K tiles, the online
// softmax runs on the accumulators in f32 (exp2, the scale folded in), and
// O += P V is wgmma m64n{HD}k16 with P from registers as two bf16 terms
// (hi + lo: one term errs by up to 2^-9 of each weight, which on rows with
// few visible keys breaks the port's per-element bf16 limit) and V
// MN-major. Thread (warp w, lane 4 gq + tq) holds query rows 16 w + gq and
// + 8, and of each row a quarter of the sum l (the quad's lanes add up to
// the row's).
template <int HD>
struct WgTile {
  static constexpr int TK = 64;
  static constexpr int NS = TK / 2;  // S accumulators per thread
  static constexpr int NO = HD / 2;  // O accumulators per thread
  float s[NS], o[NO], m[2], l[2];  // m: raw score max; l: lane's share

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = -CUDART_INF_F;
      l[i] = 0.f;
    }
  }

  // One staged tile; on an `edge` tile vis(qr, key) admits a key for a
  // query row, on any other every key is seen by every row.
  template <class Vis>
  __device__ void tile(const unsigned char* kt, const unsigned char* vt,
                       const unsigned char* qs, bool edge, Vis vis,
                       float scale2) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const float NEG_INF = -CUDART_INF_F;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int col = (kk & 3) * 32;  // bytes into the 128-byte rows
      wgmma_ss_n64(s, smem_desc(qs + (kk >> 2) * 64 * 128 + col, 16, 1024),
                   smem_desc(kt + (kk >> 2) * TK * 128 + col, 16, 1024),
                   kk == 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = 16 * warp + gq + 8 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          if (edge && !vis(qr, 8 * j + 2 * tq + e)) x = NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing visible yet keeps m = -inf: exp2 against 0
      // then gives exact zeros, never inf - inf
      const float base = m_new == NEG_INF ? 0.f : m_new * scale2;
      corr[i] = fast_exp2(fmaf(m[i], scale2, -base));
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x = fast_exp2(fmaf(x, scale2, -base));
          sum += x;
        }
      l[i] = l[i] * corr[i] + sum;
    }
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }

    constexpr int KP = TK / 16;  // 16-deep steps of P V
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
      const uint64_t desc = smem_desc(vt + kk * 16 * 128, TK * 128, 1024);
      wgmma_pv<HD>(o, a[kk], desc);
      wgmma_pv<HD>(o, a_lo[kk], desc);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    pin(a);
    pin(a_lo);
  }

  // The state of query rows [0, nq) into acc_out[qr * HD + d] and
  // ml_out[qr] = (m, l), m in the units of the scaled logits.
  __device__ void store(float* acc_out, float2* ml_out, int nq,
                        float scale) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int qr = 16 * warp + gq + 8 * i;
      if (qr >= nq) continue;
#pragma unroll
      for (int n = 0; n < NO / 4; ++n)
        *reinterpret_cast<float2*>(acc_out + qr * HD + 8 * n + 2 * tq) =
            make_float2(o[4 * n + 2 * i], o[4 * n + 2 * i + 1]);
      if (tq == 0)
        ml_out[qr] = make_float2(
            m[i] == -CUDART_INF_F ? m[i] : m[i] * scale, sum);
    }
  }
};

}  // namespace bbwgmma
