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
// The core is built from three pieces templated on the head tile and the
// keys of a tile (NK, 64 by default): qk_tile (a 16 x NK score tile),
// add_bias (its bias row stride also a template argument) and pv_tile (P V
// over NK keys). At 4x4 windows (N = 16, window_attention4.cu and
// swin_block4.cu) a warp holds a whole window: attn_core<HDP, 16> on its 16
// rows, S as two n8 tiles (each row's 16 scores 4 to a lane of the quad)
// and P V one k16 step. At 16x16 windows (N = 256) kernels (c), (f) and
// (g) run on wgmma (attn16.cuh).

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

// S[16 x NK] = A[r0, r0 + 16) B[0, NK)^T over HDP dims: ``a`` and ``b`` are
// shared-memory addresses of two bf16 planes of ``ldb`` bytes a row (an odd
// multiple of 16, so each ldmatrix phase hits 8 distinct bank groups). A's
// rows are the query rows (or, for a transposed score, key rows), B's the
// NK columns; K non-transposed is mma's "col" B. s[j] holds mma's C layout
// of columns [8j, 8j + 8): s[j][0..1] row r0 + lane / 4, columns 8j + 2
// (lane % 4) + {0, 1}; s[j][2..3] the same columns of row r0 + lane / 4 + 8.
template <int HDP, int NK = kAttnTokens>
__device__ __forceinline__ void qk_tile(uint32_t a, uint32_t b, uint32_t ldb,
                                        int r0, float (&s)[NK / 8][4]) {
  static_assert(HDP % 16 == 0 && HDP <= 128, "head dim tile");
  static_assert(NK % 16 == 0 && NK <= kAttnTokens, "keys a tile");
  const int lane = threadIdx.x & 31;
  // each lane's row address for the four 8x8 matrices of an ldmatrix.x4
  const uint32_t qa = a + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb
                      + (lane >> 4) * 16;
  const uint32_t ka = b + ((lane & 7) + (lane >> 4) * 8) * ldb
                      + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t x[4];
    ldsm_x4(qa + kk * 32, x);
#pragma unroll
    for (int jj = 0; jj < NK / 16; ++jj) {   // columns [16 jj, 16 jj + 16)
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
// loads; the tile is COLS columns wide.
template <int NK, int COLS = kAttnTokens>
__device__ __forceinline__ void add_bias(float (&s)[COLS / 8][4],
                                         const float* __restrict__ bias,
                                         const float* __restrict__ mask,
                                         float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* b0 = bias + g * NK + 2 * t;
  const float* m0 = mask != nullptr ? mask + g * NK + 2 * t : nullptr;
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j) {
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

// o += P V[0, NK): ``p`` the bf16 P tile in the A layout (p[j][0] row r0 +
// lane / 4, p[j][1] row r0 + lane / 4 + 8, of columns 8j + 2 (lane % 4) +
// {0, 1}: the C layout of qk_tile, packed), ``v`` a plane of NK rows read
// with ldmatrix.trans as the row-major B.
template <int HDP, int NK = kAttnTokens>
__device__ __forceinline__ void pv_tile(const uint32_t (&p)[NK / 8][2],
                                        uint32_t v,
                                        uint32_t ldb,
                                        float (&o)[HDP / 8][4]) {
  const int lane = threadIdx.x & 31;
  const uint32_t va = v + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb
                      + (lane >> 4) * 16;
#pragma unroll
  for (int kb = 0; kb < NK / 16; ++kb) { // rows of V [16 kb, 16 kb + 16)
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

// Rows [r0, r0 + 16) of one window and head, NK keys (64: an 8x8 window;
// 16: a 4x4 window, whose 16 rows a warp holds whole: the caller points
// ``q``, ``k`` and ``v`` at the window's first row and passes r0 = 0).
// ``q``, ``k``, ``v``: shared-memory addresses of the three planes, ``ld``
// elements a token row; dims [hd, HDP) of every plane are zero. ``bias``:
// the head's [NK][NK] f32 term; ``mask``: the window's [NK][NK] f32 mask or
// null. On return o[j] holds mma's C layout of columns [8j, 8j + 8) (as
// qk_tile's s).
template <int HDP, int NK = kAttnTokens>
__device__ __forceinline__ void attn_core(uint32_t q, uint32_t k, uint32_t v,
                                          int ld, int r0,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ mask,
                                          float scale, float (&o)[HDP / 8][4]) {
  const uint32_t ldb = 2u * ld;
  float s[NK / 8][4];
  qk_tile<HDP, NK>(q, k, ldb, r0, s);
  // x = s * scale + bias (+ mask), then the stabilised softmax of rows
  // r0 + g (values 0, 1) and r0 + g + 8 (values 2, 3)
  add_bias<NK, NK>(s, bias + r0 * NK, mask != nullptr ? mask + r0 * NK
                                                      : nullptr,
                   scale);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
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
  for (int j = 0; j < NK / 8; ++j) {
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
  uint32_t p[NK / 8][2];   // P in bf16: the A fragments of P V
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    p[j][0] = pack_bf16x2(s[j][0] * inv0, s[j][1] * inv0);
    p[j][1] = pack_bf16x2(s[j][2] * inv1, s[j][3] * inv1);
  }
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  pv_tile<HDP, NK>(p, v, ldb, o);
}

}  // namespace
