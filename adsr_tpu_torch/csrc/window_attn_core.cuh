// One 8x8-window attention core, shared by kernel (c) window_attention and
// kernel (g) swin_block: for one (window, head), a warp computes its 16
// query rows of
//
//   O = softmax(Q K^T * scale + bias (+ mask)) V
//
// with Q, K, V bf16 [64 tokens][head dim] planes in shared memory, the head
// dim zero-padded to HDP (a multiple of 16), and leaves O in registers for
// the caller's epilogue. The scores never touch shared memory:
//   - S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 accumulators), the
//     operands loaded with ldmatrix (K non-transposed is mma's "col" B);
//   - scale, the f32 relative-position bias [64][64] of the head and the f32
//     shift mask [64][64] of the window added in registers (8-byte loads);
//   - a stabilised f32 softmax: each row's 64 scores live in the 4 lanes of
//     a quad (16 each), so max and sum are two quad shuffles;
//   - P rounded to bf16 once and used straight as the A operand of P V (the
//     accumulator layout of S is the A layout of the next product, as in
//     FlashAttention-2), V read with ldmatrix.trans;
//   - O accumulated in f32.
// The numerics are those of the kernels it replaces: stabilised softmax,
// expf, P = e / sum rounded once to bf16, f32 accumulation. At 64 tokens a
// window the two products are ~64 flop per byte of q, k, v, below the bf16
// ridge, so mma.sync is enough; wgmma serves (g)'s dense products.
// The core is built from three pieces templated on the head tile (and
// add_bias on the keys a window): qk_tile (a 16 x 64 score tile), add_bias
// and pv_tile (P V over 64 keys). Kernel (g) at 16x16 windows (N = 256,
// swin_block16.cu) walks the window's keys in tiles of 64 with the same
// pieces and its online-softmax step, online_softmax_tile; kernels (c) and
// (f) at N = 256 run on wgmma (attn16.cuh).

#pragma once

#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kAttnTokens = 64;   // an 8x8 window

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16 x 8] (f32) += a[16 x 16] (bf16, row) b[16 x 8] (bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S[16 x 64] = A[r0, r0 + 16) B[0, 64)^T over HDP dims: ``a`` and ``b`` are
// shared-memory addresses of two bf16 planes of ``ldb`` bytes a row (an odd
// multiple of 16, so each ldmatrix phase hits 8 distinct bank groups). A's
// rows are the query rows (or, for a transposed score, key rows), B's the
// 64 columns; K non-transposed is mma's "col" B. s[j] holds mma's C layout
// of columns [8j, 8j + 8): s[j][0..1] row r0 + lane / 4, columns 8j + 2
// (lane % 4) + {0, 1}; s[j][2..3] the same columns of row r0 + lane / 4 + 8.
template <int HDP>
__device__ __forceinline__ void qk_tile(uint32_t a, uint32_t b, uint32_t ldb,
                                        int r0, float (&s)[8][4]) {
  static_assert(HDP % 16 == 0 && HDP <= 128, "head dim tile");
  const int lane = threadIdx.x & 31;
  // each lane's row address for the four 8x8 matrices of an ldmatrix.x4
  const uint32_t qa = a + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb
                      + (lane >> 4) * 16;
  const uint32_t ka = b + ((lane & 7) + (lane >> 4) * 8) * ldb
                      + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t x[4];
    ldsm_x4(qa + kk * 32, x);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {     // columns [16 jj, 16 jj + 16)
      uint32_t y[4];
      ldsm_x4(ka + jj * 16 * ldb + kk * 32, y);
      mma_16816(s[2 * jj], x, y[0], y[1]);
      mma_16816(s[2 * jj + 1], x, y[2], y[3]);
    }
  }
}

// x = s * scale + bias (+ mask) for the lane's two rows of a score tile:
// ``bias`` and ``mask`` (or null) point at the tile's element (row r0,
// column 0) of [NK][NK] f32 matrices (NK = keys a window), read in 8-byte
// loads.
template <int NK>
__device__ __forceinline__ void add_bias(float (&s)[8][4],
                                         const float* __restrict__ bias,
                                         const float* __restrict__ mask,
                                         float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* b0 = bias + g * NK + 2 * t;
  const float* m0 = mask != nullptr ? mask + g * NK + 2 * t : nullptr;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 u = *reinterpret_cast<const float2*>(b0 + 8 * j);
    const float2 w = *reinterpret_cast<const float2*>(b0 + 8 * NK + 8 * j);
    s[j][0] = s[j][0] * scale + u.x;
    s[j][1] = s[j][1] * scale + u.y;
    s[j][2] = s[j][2] * scale + w.x;
    s[j][3] = s[j][3] * scale + w.y;
    if (m0 != nullptr) {
      const float2 mu = *reinterpret_cast<const float2*>(m0 + 8 * j);
      const float2 mw = *reinterpret_cast<const float2*>(m0 + 8 * NK + 8 * j);
      s[j][0] += mu.x;
      s[j][1] += mu.y;
      s[j][2] += mw.x;
      s[j][3] += mw.y;
    }
  }
}

// o += P V[0, 64): ``p`` the bf16 P tile in the A layout (p[j][0] row r0 +
// lane / 4, p[j][1] row r0 + lane / 4 + 8, of columns 8j + 2 (lane % 4) +
// {0, 1}: the C layout of qk_tile, packed), ``v`` a plane of 64 rows read
// with ldmatrix.trans as the row-major B.
template <int HDP>
__device__ __forceinline__ void pv_tile(const uint32_t (&p)[8][2], uint32_t v,
                                        uint32_t ldb,
                                        float (&o)[HDP / 8][4]) {
  const int lane = threadIdx.x & 31;
  const uint32_t va = v + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb
                      + (lane >> 4) * 16;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {       // rows of V [16 kb, 16 kb + 16)
    const uint32_t a[4] = {p[2 * kb][0], p[2 * kb][1], p[2 * kb + 1][0],
                           p[2 * kb + 1][1]};
#pragma unroll
    for (int jd = 0; jd < HDP / 16; ++jd) {
      uint32_t b[4];
      ldsm_x4_trans(va + kb * 16 * ldb + jd * 32, b);
      mma_16816(o[2 * jd], a, b[0], b[1]);
      mma_16816(o[2 * jd + 1], a, b[2], b[3]);
    }
  }
}

// One key tile of FlashAttention-2's online softmax for the lane's two query
// rows (r0 + lane / 4: values 0, 1 of s; r0 + lane / 4 + 8: values 2, 3).
// ``s`` holds the tile's scaled and biased scores (qk_tile, add_bias). The
// running row max ``mx`` grows to the tile's; the running row sum ``sum``
// and the f32 context ``o`` are rescaled by exp(mx_old - mx) (0 at the
// first tile, whose mx_old is -inf); e = exp(s - mx) joins the sums and,
// rounded once to bf16, o += e V[0, 64) (``v``: the tile's V plane, ``ldb``
// bytes a row). The caller divides o by the sum after the last tile.
template <int HDP>
__device__ __forceinline__ void online_softmax_tile(float (&s)[8][4],
                                                    uint32_t v, uint32_t ldb,
                                                    float (&mx)[2],
                                                    float (&sum)[2],
                                                    float (&o)[HDP / 8][4]) {
  float t0 = mx[0], t1 = mx[1];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
    t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, sh));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, sh));
  }
  const float a0 = expf(mx[0] - t0), a1 = expf(mx[1] - t1);  // 0 at tile 0
  mx[0] = t0;
  mx[1] = t1;
  float e0 = 0.f, e1 = 0.f;
  uint32_t p[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = expf(s[j][0] - t0);
    s[j][1] = expf(s[j][1] - t0);
    s[j][2] = expf(s[j][2] - t1);
    s[j][3] = expf(s[j][3] - t1);
    e0 += s[j][0] + s[j][1];
    e1 += s[j][2] + s[j][3];
    p[j][0] = pack_bf16x2(s[j][0], s[j][1]);
    p[j][1] = pack_bf16x2(s[j][2], s[j][3]);
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    e0 += __shfl_xor_sync(0xffffffffu, e0, sh);
    e1 += __shfl_xor_sync(0xffffffffu, e1, sh);
  }
  sum[0] = sum[0] * a0 + e0;
  sum[1] = sum[1] * a1 + e1;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    o[j][0] *= a0;
    o[j][1] *= a0;
    o[j][2] *= a1;
    o[j][3] *= a1;
  }
  pv_tile<HDP>(p, v, ldb, o);
}

// Rows [r0, r0 + 16) of one 8x8 window and head. ``q``, ``k``, ``v``:
// shared-memory addresses of the three planes, ``ld`` elements a token row;
// dims [hd, HDP) of every plane are zero. ``bias``: the head's [64][64] f32
// term; ``mask``: the window's [64][64] f32 mask or null. On return o[j]
// holds mma's C layout of columns [8j, 8j + 8) (as qk_tile's s).
template <int HDP>
__device__ __forceinline__ void attn_core(uint32_t q, uint32_t k, uint32_t v,
                                          int ld, int r0,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ mask,
                                          float scale, float (&o)[HDP / 8][4]) {
  const uint32_t ldb = 2u * ld;
  float s[8][4];
  qk_tile<HDP>(q, k, ldb, r0, s);
  // x = s * scale + bias (+ mask), then the stabilised softmax of rows
  // r0 + g (values 0, 1) and r0 + g + 8 (values 2, 3)
  add_bias<kAttnTokens>(s, bias + r0 * kAttnTokens,
                        mask != nullptr ? mask + r0 * kAttnTokens : nullptr,
                        scale);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = expf(s[j][0] - mx0);
    s[j][1] = expf(s[j][1] - mx0);
    s[j][2] = expf(s[j][2] - mx1);
    s[j][3] = expf(s[j][3] - mx1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, sh);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, sh);
  }
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  uint32_t p[8][2];      // P in bf16: the A fragments of P V
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p[j][0] = pack_bf16x2(s[j][0] * inv0, s[j][1] * inv0);
    p[j][1] = pack_bf16x2(s[j][2] * inv1, s[j][3] * inv1);
  }
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  pv_tile<HDP>(p, v, ldb, o);
}

}  // namespace
