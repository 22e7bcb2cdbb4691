// The backward twin of window_attn_core.cuh's attention core, for kernel (f)
// window_attention_bwd: for one (window, head) with Q, K, V and dO as bf16
// [64 tokens][head dim] planes in shared memory (head dims zero-padded to
// HDP, a multiple of 16), a warp computes for its 16 query rows
//
//   S = Q K^T * scale + bias (+ mask),  P = softmax(S)   (recomputed)
//   dP = dO V^T,  D = rowsum(P o dP),  dS = P o (dP - D),  dQ = dS K
//
// with every score tile in registers (mma.sync m16n8k16, operands by
// ldmatrix):
//   - S and its stabilised f32 softmax exactly as attn_core computes them;
//   - dP with V non-transposed as mma's "col" B, as K is for S;
//   - D and dS in f32 by quad shuffles (a row's 64 scores live in the 4
//     lanes of a quad);
//   - dS added into the caller's f32 d(bias) fragment, which lives across
//     windows, so a block writes one d(bias) partial for all its windows;
//   - P and dS rounded once to bf16 and stored as [64][72] tiles (for the
//     key-row products below); dS is also the A operand of dQ = dS K
//     straight from registers, K read with ldmatrix.trans.
// dK = dS^T Q and dV = P^T dO reduce over query rows, which belong to other
// warps: after a barrier each warp computes its 16 key rows of either from
// the shared bf16 tiles (ldmatrix.trans gives the transposed A operand) and
// a plane (ldmatrix.trans gives the row-major B), one at a time, so one
// HDP-wide accumulator is live. The numerics are those of the kernel it
// replaced: f32 softmax and dS, P and dS rounded once to bf16 before the
// three output products, f32 accumulation.

#pragma once

#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "window_attn_core.cuh"

namespace {

constexpr int kBwdTileLd = kAttnTokens + 8;   // bf16 pitch of the P / dS tiles

__device__ __forceinline__ void sts_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// Rows [r0, r0 + 16) of one (window, head). ``q``, ``k``, ``v``, ``g`` (dO):
// shared-memory addresses of the four planes, ``ld`` elements a token row
// (ld * 2 bytes an odd multiple of 16); dims [hd, HDP) of every plane are
// zero. ``pt``, ``dst``: the P and dS tiles [64][kBwdTileLd] bf16, of which
// this warp writes rows [r0, r0 + 16). ``bias``: the head's [64][64] f32
// term; ``mask``: the window's [64][64] f32 mask or null. ``dbias`` (mma's
// C layout of keys [8j, 8j + 8), rows r0 + lane / 4 and r0 + lane / 4 + 8)
// accumulates dS. On return dq holds dS K (unscaled) in the C layout of
// attn_core's o.
template <int HDP>
__device__ __forceinline__ void attn_bwd_rows(
    uint32_t q, uint32_t k, uint32_t v, uint32_t g, int ld, uint32_t pt,
    uint32_t dst, int r0, const float* __restrict__ bias,
    const float* __restrict__ mask, float scale, float (&dbias)[8][4],
    float (&dq)[HDP / 8][4]) {
  static_assert(HDP % 16 == 0 && HDP <= 128, "head dim tile");
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const uint32_t ldb = 2u * ld;
  // A operands (Q, dO rows), "col" B operands (K, V rows as keys) and the
  // row-major B of dQ (K as [key][dim]), as attn_core addresses them
  const uint32_t arow = (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb
                        + (lane >> 4) * 16;
  const uint32_t brow = ((lane & 7) + (lane >> 4) * 8) * ldb
                        + ((lane >> 3) & 1) * 16;
  const uint32_t trow = ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb
                        + (lane >> 4) * 16;

  float s[8][4], dp[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t a[4], ag[4];
    ldsm_x4(q + arow + kk * 32, a);
    ldsm_x4(g + arow + kk * 32, ag);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {     // keys [16 jj, 16 jj + 16)
      uint32_t b[4], bv[4];
      ldsm_x4(k + brow + jj * 16 * ldb + kk * 32, b);
      mma_16816(s[2 * jj], a, b[0], b[1]);
      mma_16816(s[2 * jj + 1], a, b[2], b[3]);
      ldsm_x4(v + brow + jj * 16 * ldb + kk * 32, bv);
      mma_16816(dp[2 * jj], ag, bv[0], bv[1]);
      mma_16816(dp[2 * jj + 1], ag, bv[2], bv[3]);
    }
  }

  // the stabilised softmax of rows r0 + gr (values 0, 1) and r0 + gr + 8
  // (values 2, 3), as attn_core
  const float* b0 = bias + (r0 + gr) * kAttnTokens + 2 * t;
  const float* m0 = mask != nullptr ? mask + (r0 + gr) * kAttnTokens + 2 * t
                                    : nullptr;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 u = *reinterpret_cast<const float2*>(b0 + 8 * j);
    const float2 w = *reinterpret_cast<const float2*>(b0 + 8 * kAttnTokens
                                                      + 8 * j);
    s[j][0] = s[j][0] * scale + u.x;
    s[j][1] = s[j][1] * scale + u.y;
    s[j][2] = s[j][2] * scale + w.x;
    s[j][3] = s[j][3] * scale + w.y;
    if (m0 != nullptr) {
      const float2 mu = *reinterpret_cast<const float2*>(m0 + 8 * j);
      const float2 mw = *reinterpret_cast<const float2*>(m0 + 8 * kAttnTokens
                                                         + 8 * j);
      s[j][0] += mu.x;
      s[j][1] += mu.y;
      s[j][2] += mw.x;
      s[j][3] += mw.y;
    }
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

  // P in f32, D = rowsum(P o dP)
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] *= inv0;
    s[j][1] *= inv0;
    s[j][2] *= inv1;
    s[j][3] *= inv1;
    d0 += s[j][0] * dp[j][0] + s[j][1] * dp[j][1];
    d1 += s[j][2] * dp[j][2] + s[j][3] * dp[j][3];
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, sh);
    d1 += __shfl_xor_sync(0xffffffffu, d1, sh);
  }

  // dS = P o (dP - D) in f32 into d(bias); P and dS once to bf16, into the
  // tiles (rows r0 + gr and r0 + gr + 8, keys 8j + 2t, + 1) and, for dS, as
  // the A fragments of dS K
  const uint32_t tl0 = ((r0 + gr) * kBwdTileLd + 2 * t) * 2u;
  const uint32_t tl1 = tl0 + 8u * kBwdTileLd * 2u;
  uint32_t ds[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dp[j][0] = s[j][0] * (dp[j][0] - d0);
    dp[j][1] = s[j][1] * (dp[j][1] - d0);
    dp[j][2] = s[j][2] * (dp[j][2] - d1);
    dp[j][3] = s[j][3] * (dp[j][3] - d1);
#pragma unroll
    for (int i = 0; i < 4; ++i) dbias[j][i] += dp[j][i];
    sts_b32(pt + tl0 + 16u * j, pack_bf16x2(s[j][0], s[j][1]));
    sts_b32(pt + tl1 + 16u * j, pack_bf16x2(s[j][2], s[j][3]));
    ds[j][0] = pack_bf16x2(dp[j][0], dp[j][1]);
    ds[j][1] = pack_bf16x2(dp[j][2], dp[j][3]);
    sts_b32(dst + tl0 + 16u * j, ds[j][0]);
    sts_b32(dst + tl1 + 16u * j, ds[j][1]);
  }

#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[j][i] = 0.f;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {       // keys [16 kb, 16 kb + 16)
    const uint32_t a[4] = {ds[2 * kb][0], ds[2 * kb][1], ds[2 * kb + 1][0],
                           ds[2 * kb + 1][1]};
#pragma unroll
    for (int jd = 0; jd < HDP / 16; ++jd) {
      uint32_t b[4];
      ldsm_x4_trans(k + trow + kb * 16 * ldb + jd * 32, b);
      mma_16816(dq[2 * jd], a, b[0], b[1]);
      mma_16816(dq[2 * jd + 1], a, b[2], b[3]);
    }
  }
}

// Key rows [j0, j0 + 16) of Y = T^T X: ``tile`` a [64][kBwdTileLd] bf16 tile
// T[query][key] (P or dS), ``x`` a [64][ld] plane X[query][dim] (dO or Q).
// The A operand (T^T, rows = keys) and the row-major B (X) both come by
// ldmatrix.trans. y: mma's C layout, rows j0 + lane / 4 (+ 8), dims
// [8j, 8j + 8).
template <int HDP>
__device__ __forceinline__ void tile_t_times(uint32_t tile, uint32_t x, int ld,
                                             int j0, float (&y)[HDP / 8][4]) {
  const int lane = threadIdx.x & 31;
  const uint32_t ldb = 2u * ld, ldt = 2u * kBwdTileLd;
  // A: matrix m of the x4 holds T rows [16 kk + 8 (m / 2), + 8) at key
  // columns j0 + 8 (m % 2), transposed on delivery
  const uint32_t ta = tile + ((lane & 7) + (lane >> 4) * 8) * ldt
                      + (j0 + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t xa = x + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb
                      + (lane >> 4) * 16;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) y[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {        // queries [16 kk, 16 kk + 16)
    uint32_t a[4];
    ldsm_x4_trans(ta + kk * 16 * ldt, a);
#pragma unroll
    for (int jd = 0; jd < HDP / 16; ++jd) {
      uint32_t b[4];
      ldsm_x4_trans(xa + kk * 16 * ldb + jd * 32, b);
      mma_16816(y[2 * jd], a, b[0], b[1]);
      mma_16816(y[2 * jd + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace
