// Deterministic second pass of the backward kernels' reductions.
//
// A CUDA grid runs its blocks in no order, so a sum over blocks (weight
// gradients over M = B*L token rows, LayerNorm affine gradients, the
// attention-bias gradient over every window) is written as f32 partials
// [S, total] by the first kernel, one row per block or split, and summed
// here over S in a fixed order: the same inputs give bitwise the same sums,
// which f32 atomics would not.
//
// out_a[i] = sum_s part[s * total + i] for i < n_a, out_b[i - n_a] for the
// rest (the weight and bias gradients of one product in one pass).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kPartialThreads = 256;

__global__ void __launch_bounds__(kPartialThreads)
sum_partials_kernel(const float* __restrict__ part, int S, long long total,
                    float* __restrict__ out_a, long long n_a,
                    float* __restrict__ out_b) {
  const long long i = (long long)blockIdx.x * kPartialThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(long long)s * total + i];
  if (i < n_a)
    out_a[i] = acc;
  else
    out_b[i - n_a] = acc;
}

inline int sum_partials(const float* part, int S, long long total,
                        float* out_a, long long n_a, float* out_b,
                        cudaStream_t stream) {
  if (total <= 0) return 0;
  const long long blocks = (total + kPartialThreads - 1) / kPartialThreads;
  sum_partials_kernel<<<(unsigned)blocks, kPartialThreads, 0, stream>>>(
      part, S, total, out_a, n_a, out_b);
  return (int)cudaGetLastError();
}

}  // namespace
