// tf32_mma.cuh: f32-accurate products on the tensor cores as 3xTF32 with
// mma.sync m16n8k8, shared by the f32 kernels that run their products so:
// (c) f32 (window_attention_tc_f32.cuh), (d) f32 (rdg_gemm_bwd_f32.cu), (f)
// f32 (window_attention_bwd_f32.cuh) and (g) f32 (swin_block_f32.cuh).
//
// Each f32 operand is split as x = hi + lo, hi = tf32(x) and lo = tf32(x -
// hi), both rounded to nearest with ties away from zero (or, kTrunc, hi
// truncated and lo = x - hi exact, which the tensor cores truncate), and a
// product sums
// a_lo b_hi + a_hi b_lo + a_hi b_hi into f32 accumulators (a_lo b_lo, ~2^-22
// of a product, is dropped). Fragments follow PTX's m16n8k8 .tf32 layout
// with g = lane / 4, t = lane % 4: A (16 x 8, row-major) a0 (g, t), a1 (g +
// 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, column-major) b0 (t, g),
// b1 (t + 4, g); C c0, c1 (g, 2t and 2t + 1), c2, c3 (g + 8, 2t and 2t + 1).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// ablation switch of scripts/torch_attention_bwd16_f32_sweep.py (timing
// only: a variant without it computes something else)
#ifndef ATTN16_F32_X3
#define ATTN16_F32_X3 1           // 0: one TF32 product, no lo parts
#endif

namespace {

// hi = tf32(x), lo = tf32(x - hi): the nearest TF32 values, ties away from
// zero (the rounding of cvt.rna.tf32.f32), in integer operations: the
// conversion runs at a lower rate
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
#if ATTN16_F32_X3
  lo = tf32_rna(x - __uint_as_float(hi));
#else
  lo = 0u;
#endif
}

// the cheaper split: hi = x with its low 13 bits cleared, lo = x - hi
// (exact), passed whole (the tensor cores read its top 19 bits); each part
// within 2^-10 of its own size, against 2^-11 for the nearest values
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <bool kTrunc>
__device__ __forceinline__ void split_as(float x, uint32_t& hi,
                                         uint32_t& lo) {
  if constexpr (kTrunc)
    split_tf32_trunc(x, hi, lo);
  else
    split_tf32(x, hi, lo);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, f32-accurate: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
#if ATTN16_F32_X3
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
#endif
  mma_tf32(d, ah, bh);
}

// two independent 3xTF32 products, their mma interleaved so neither waits
// on its own accumulator
__device__ __forceinline__ void mma3x2(
    float (&d0)[4], const uint32_t (&a0h)[4], const uint32_t (&a0l)[4],
    const uint32_t (&b0h)[2], const uint32_t (&b0l)[2], float (&d1)[4],
    const uint32_t (&a1h)[4], const uint32_t (&a1l)[4],
    const uint32_t (&b1h)[2], const uint32_t (&b1l)[2]) {
#if ATTN16_F32_X3
  mma_tf32(d0, a0l, b0h);
  mma_tf32(d1, a1l, b1h);
  mma_tf32(d0, a0h, b0l);
  mma_tf32(d1, a1h, b1l);
#endif
  mma_tf32(d0, a0h, b0h);
  mma_tf32(d1, a1h, b1h);
}

// A (16 x 8) of plane X: rows r0 + g (+ 8), columns k0 + t (+ 4)
template <int P, bool kTrunc = false>
__device__ __forceinline__ void frag_a(const float* X, int r0, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* x = X + (r0 + g) * P + k0 + t;
  split_as<kTrunc>(x[0], hi[0], lo[0]);
  split_as<kTrunc>(x[8 * P], hi[1], lo[1]);
  split_as<kTrunc>(x[4], hi[2], lo[2]);
  split_as<kTrunc>(x[8 * P + 4], hi[3], lo[3]);
}

// B (8 x 8), element (k, n) at X[n0 + n][k0 + k]: a product over the
// planes' head dims (S = Q K^T)
template <int P, bool kTrunc = false>
__device__ __forceinline__ void frag_b_rows(const float* X, int n0, int k0,
                                            uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* x = X + (n0 + g) * P + k0 + t;
  split_as<kTrunc>(x[0], hi[0], lo[0]);
  split_as<kTrunc>(x[4], hi[1], lo[1]);
}

// B (8 x 8), element (k, n) at X[k0 + k][n0 + n] in the paired order: k = t
// reads row k0 + 2t, k = t + 4 row k0 + 2t + 1 (a product over the planes'
// rows, A from frag_a_of_c)
template <int P, bool kTrunc = false>
__device__ __forceinline__ void frag_b_cols(const float* X, int k0, int n0,
                                            uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* x = X + (k0 + 2 * t) * P + n0 + g;
  split_as<kTrunc>(x[0], hi[0], lo[0]);
  split_as<kTrunc>(x[P], hi[1], lo[1]);
}

// an accumulator tile (c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g +
// 8) as the A of a product over its columns, in the paired order
template <bool kTrunc = false>
__device__ __forceinline__ void frag_a_of_c(float c0, float c1, float c2,
                                            float c3, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_as<kTrunc>(c0, hi[0], lo[0]);
  split_as<kTrunc>(c2, hi[1], lo[1]);
  split_as<kTrunc>(c1, hi[2], lo[2]);
  split_as<kTrunc>(c3, hi[3], lo[3]);
}

__device__ __forceinline__ void cp_async_piece(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

}  // namespace
