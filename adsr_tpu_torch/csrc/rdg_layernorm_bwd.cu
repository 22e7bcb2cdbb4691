// rdg_layernorm_bwd: backward of the row LayerNorm over the first C columns
// of a row-strided bf16 buffer (eps 1e-6, affine unfolded).
//
//   x^ = (x - mean) * inv,  dy^ = gamma * dy
//   dx += inv * (dy^ - mean(dy^) - x^ * mean(dy^ * x^))  [+ dres]
//   dgamma = sum_rows dy * x^,  dbeta = sum_rows dy
//
// Replaces: the LayerNorm backward phases of the Pallas kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770), which fold the affine into
// the next matmul and so need no dgamma/dbeta; the port keeps the affine
// unfolded and emits them.
// Bound on H100: bytes (x in bf16, dy, dres and dx in f32, a few f32 ops
// an element).
// Design: one warp per row with the row in registers (C <= 320, ten values
// a lane), statistics recomputed from x in f32 exactly as the forward
// kernel computes them (two passes), so nothing of the forward is saved.
// dx is ADDED into a strided f32 buffer (the concat gradient's prefix
// dcat[:, :c_k], or the residual-stream gradient), with an optional second
// gradient dres added in the same pass. dgamma/dbeta: each block sums its
// 64 rows per column in a fixed order (lanes, then warps through shared
// memory) into one partial row; partials.cuh sums the rows in order, so
// the result is bitwise reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "partials.cuh"

namespace {

constexpr int kMaxPerLane = 10;     // C <= 32 * 10
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxC = 32 * kMaxPerLane;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * kWarps)
rdg_layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                         const float* __restrict__ dy, long long ldy,
                         const float* __restrict__ w,
                         const float* __restrict__ dres, long long ldr,
                         float* dx, long long ldo, float* __restrict__ part,
                         int M, int C, float eps) {
  __shared__ float red[kWarps][2][kMaxC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float pg[kMaxPerLane], pb[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) pg[i] = pb[i] = 0.f;

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const long long row =
        (long long)blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + rr;
    if (row >= M) break;
    const __nv_bfloat16* xr = x + row * ldx;
    const float* gr = dy + row * ldy;
    float v[kMaxPerLane], g[kMaxPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? __bfloat162float(xr[c]) : 0.f;
      g[i] = c < C ? gr[c] : 0.f;
      s += v[i];
    }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      const float d = v[i] - mu;
      q += c < C ? d * d : 0.f;
    }
    const float inv = rsqrtf(warp_sum(q) / C + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = (v[i] - mu) * inv;                 // x^
      const float gh = c < C ? g[i] * w[c] : 0.f;
      s1 += gh;
      s2 += gh * v[i];
      pg[i] += g[i] * v[i];
      pb[i] += g[i];
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    float* dr = dx + row * ldo;
    const float* rr_ = dres != nullptr ? dres + row * ldr : nullptr;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c >= C) continue;
      float d = inv * (g[i] * w[c] - m1 - v[i] * m2);
      if (rr_ != nullptr) d += rr_[c];
      dr[c] += d;
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      red[warp][0][c] = pg[i];
      red[warp][1][c] = pb[i];
    }
  }
  __syncthreads();
  float* p = part + (long long)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += 32 * kWarps) {
    const int which = c / C, col = c % C;
    float acc = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) acc += red[wi][which][col];
    p[c] = acc;
  }
}

}  // namespace

extern "C" int adsr_rdg_layernorm_bwd(const void* x, long long ldx,
                                      const void* dy, long long ldy,
                                      const void* w, const void* dres,
                                      long long ldr, void* dx, long long ldo,
                                      void* part, void* dgamma, void* dbeta,
                                      int M, int C, float eps, void* stream) {
  if (C <= 0 || C > kMaxC || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  rdg_layernorm_bwd_kernel<<<blocks, 32 * kWarps, 0, s>>>(
      (const __nv_bfloat16*)x, ldx, (const float*)dy, ldy, (const float*)w,
      (const float*)dres, ldr, (float*)dx, ldo, (float*)part, M, C, eps);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return sum_partials((const float*)part, blocks, 2ll * C, (float*)dgamma, C,
                      (float*)dbeta, s);
}
