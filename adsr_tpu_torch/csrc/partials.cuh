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
// rest (a LayerNorm's dgamma and dbeta in one pass). The same launch may also
// sum a second set of partials by columns: cols_out[j] = sum_c cols[c *
// n_cols + j] over its C rows (rdg_gemm_bwd's bias gradient, one row per 32
// token rows, beside its split weight gradient); a block of those takes 32
// columns, its eight warps sum every eighth row (coalesced across the
// columns, several rows' loads in flight), then the eight sums are added in
// order. Column j >= n_cols_a goes to cols_out_b[j - n_cols_a] when that is
// given (a LayerNorm's dgamma and dbeta from one set of partial rows).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kPartialThreads = 256;

__global__ void __launch_bounds__(kPartialThreads)
sum_partials_kernel(const float* __restrict__ part, int S, long long total,
                    float* __restrict__ out_a, long long n_a,
                    float* __restrict__ out_b, int part_blocks,
                    const float* __restrict__ cols, int C, int n_cols,
                    float* __restrict__ cols_out, int n_cols_a,
                    float* __restrict__ cols_out_b) {
  if ((int)blockIdx.x < part_blocks) {
    const long long i = (long long)blockIdx.x * kPartialThreads + threadIdx.x;
    if (i >= total) return;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[(long long)s * total + i];
    if (i < n_a)
      out_a[i] = acc;
    else
      out_b[i - n_a] = acc;
    return;
  }
  __shared__ float sums[kPartialThreads / 32][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int j = ((int)blockIdx.x - part_blocks) * 32 + lane;
  float acc = 0.f;
  if (j < n_cols) {
#pragma unroll 8
    for (int c = w; c < C; c += kPartialThreads / 32)
      acc += cols[(long long)c * n_cols + j];
  }
  sums[w][lane] = acc;
  __syncthreads();
  if (w == 0 && j < n_cols) {
    for (int r = 1; r < kPartialThreads / 32; ++r) acc += sums[r][lane];
    if (cols_out_b != nullptr && j >= n_cols_a)
      cols_out_b[j - n_cols_a] = acc;
    else
      cols_out[j] = acc;
  }
}

inline int sum_partials(const float* part, int S, long long total,
                        float* out_a, long long n_a, float* out_b,
                        cudaStream_t stream, const float* cols = nullptr,
                        int C = 0, int n_cols = 0, float* cols_out = nullptr,
                        int n_cols_a = 0, float* cols_out_b = nullptr) {
  const long long part_blocks =
      total > 0 ? (total + kPartialThreads - 1) / kPartialThreads : 0;
  const long long blocks = part_blocks + (n_cols + 31) / 32;
  if (blocks == 0) return 0;
  sum_partials_kernel<<<(unsigned)blocks, kPartialThreads, 0, stream>>>(
      part, S, total, out_a, n_a, out_b, (int)part_blocks, cols, C, n_cols,
      cols_out, n_cols_a, cols_out_b);
  return (int)cudaGetLastError();
}

}  // namespace
