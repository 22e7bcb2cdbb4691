// rdg_layernorm: row LayerNorm over the first C columns of a row-strided
// bf16 buffer (the RDG concat buffer), f32 statistics, affine applied,
// contiguous bf16 out.
//
// Replaces: the LayerNorm phases of the Pallas kernel _rdg_kernel_impl
// (adsr_tpu/ops/fused_rdg.py:708-714, 860), which fold the affine into the
// next matmul; here the affine is applied in place, unfolded.
// Bound on H100: bytes (2 B in + 2 B out per element, a few f32 ops each).
// Design: one warp per row, the row held in registers (C <= 320, ten values a
// lane), two-pass mean/variance in f32, so the concat prefix is read once
// in place at its row stride and no copy of it is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPerLane = 10;     // C <= 32 * 10
constexpr int kRowsPerBlock = 8;    // one warp per row, 256 threads

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
rdg_layernorm_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                     const float* __restrict__ w, const float* __restrict__ b,
                     __nv_bfloat16* __restrict__ y, long long ldy, int M,
                     int C, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + row * ldx;
  float v[kMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? __bfloat162float(xr[c]) : 0.f;
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
  __nv_bfloat16* yr = y + row * ldy;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < C) yr[c] = __float2bfloat16((v[i] - mu) * inv * w[c] + b[c]);
  }
}

}  // namespace

extern "C" int adsr_rdg_layernorm(const void* x, long long ldx, const void* w,
                                  const void* b, void* y, long long ldy, int M,
                                  int C, float eps, void* stream) {
  if (C <= 0 || C > 32 * kMaxPerLane || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const unsigned grid = (unsigned)((M + kRowsPerBlock - 1) / kRowsPerBlock);
  rdg_layernorm_kernel<<<grid, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, ldx, (const float*)w, (const float*)b,
      (__nv_bfloat16*)y, ldy, M, C, eps);
  return (int)cudaGetLastError();
}
