// The pieces of kernel (g) swin_block that its two window sizes share
// (swin_block.cu: 8x8 windows, one thread block a window; swin_block16.cu:
// 16x16 windows, a cluster of four thread blocks a window): every thread
// block holds 64 token rows (the M of every product) in an f32 residual
// stream in shared memory, a producer warp streams the packed weights by TMA
// into a ring of 64 x 64 tiles, and two consumer warpgroups run the products
// on wgmma with their epilogues from the accumulators; the LayerNorm over
// the 64 rows; the launch arguments and the weights' TMA maps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper_gemm.cuh"        // mbarrier, TMA, wgmma and tensor-map wrappers
#include "window_attn_core.cuh"   // the attention core shared with (c)

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockRows = 64;                 // token rows a block holds (M)
constexpr int kMathGroups = 2;                 // consumer warpgroups
constexpr int kMathThreads = 128 * kMathGroups;
constexpr int kThreads = kMathThreads + 32;    // + the producer warp
constexpr int kStageRows = 64;                 // weight rows a stage holds
constexpr int kBoxRows = 16;                   // rows of one TMA box
constexpr int kStageBytes = kStageRows * 128;  // 64 rows x 64 bf16
constexpr int kHalf = kStageRows / kMathGroups;  // a warpgroup's rows
                                                 // of a tile
constexpr int kMaxStages = 16;
constexpr int kMaxC = 320;                     // LayerNorm: <= 10 values a lane
constexpr int kMaxPerLane = kMaxC / 32;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
// weight rows of a tile of the ``n`` rows left of a product
__host__ __device__ inline int tile_rows(int n) {
  return n < kStageRows ? round16(n) : kStageRows;
}

// element (t, c) of a swizzled K-major A operand: 64-column atoms of 64 rows
// x 128 bytes, the 16-byte chunk of column c in row t at chunk ^ (t % 8)
__device__ __forceinline__ int swz(int t, int c) {
  return (c >> 6) * (kAtomBytes / 2) + t * 64
         + ((((c >> 3) & 7) ^ (t & 7)) << 3) + (c & 7);
}

struct Args {
  const bf16* x; long long ldx;
  bf16* out; long long ldo;
  const float* ln1_w; const float* ln1_b; const float* bqkv;
  const float* bias; const float* mask; const float* bproj;
  const float* ln2_w; const float* ln2_b; const float* b1; const float* b2;
  int H, W, C, F, nh, hd, shift, stages;
  float eps, scale;
};

// the four weight matrices' TMA maps (torch Linear [N, K], 16-byte rows)
struct alignas(64) Maps {
  CUtensorMap qkv, proj, fc1, fc2;
};

__device__ __forceinline__ void math_barrier() {   // the consumer warpgroups
  asm volatile("bar.sync 1, %0;\n" :: "n"(kMathThreads) : "memory");
}

// generic-proxy writes of this thread visible to later wgmma reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

struct RingState {
  uint32_t base, bars;
  int stages, stage;
  uint32_t phase;
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
  __device__ void advance() {
    if (++stage == stages) { stage = 0; phase ^= 1; }
  }
};

// acc = A[64 x 64 ksteps] @ (the next ksteps ring tiles of weight rows)^T:
// the consumer side of one output tile. A is a run of swizzled atoms at
// shared address ``a``. Every tile runs as m64n64: a ragged tile (16, 32 or
// 48 rows) leaves its last accumulator columns with products of stale ring
// rows, which no epilogue reads; the wgmma sequence has no branch, so ptxas
// keeps it asynchronous (a data-dependent choice of shape made it serialize
// every wgmma). One group stays in flight while the next stage is awaited,
// and each stage goes back to the producer once the group that read it has
// retired.
__device__ __forceinline__ void mma_tile(RingState& r, uint32_t a, int ksteps,
                                         float (&acc)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  const int lane = threadIdx.x & 31;
  const uint32_t half = (threadIdx.x >> 7) * kHalf * 128;   // its 32 rows
  int prev = -1;
  for (int s = 0; s < ksteps; ++s) {
    mbar_wait(r.full(r.stage), r.phase);
    const uint32_t sb = r.base + r.stage * kStageBytes;
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n32<0, 0>(acc, smem_desc(a + s * kAtomBytes + kk * 32, 16, 1024),
                      smem_desc(sb + half + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();                   // the previous stage's group
    fence_operand(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(r.empty(prev));
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  fence_operand(acc);
  if (lane == 0) mbar_arrive(r.empty(prev));
}

// Y (swizzled) = LayerNorm(X) over the true C (f32 two-pass statistics),
// zero in columns [C, kp); each consumer warp takes 8 rows, four at a time
// so that their shuffle reductions overlap.
__device__ void layer_norm(const float* X, int ldx, bf16* Y, int C, int kp,
                           const float* __restrict__ w,
                           const float* __restrict__ b, float eps) {
  constexpr int R = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float wv[kMaxPerLane], bv[kMaxPerLane];   // the lane's columns, once
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    wv[i] = c < C ? w[c] : 0.f;
    bv[i] = c < C ? b[c] : 0.f;
  }
  constexpr int kRows = kBlockRows / (kMathThreads / 32);
  for (int t0 = kRows * warp; t0 < kRows * warp + kRows; t0 += R) {
    float v[R][kMaxPerLane], mu[R], q[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const float* xr = X + (t0 + u) * ldx;
      mu[u] = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int c = lane + 32 * i;
        v[u][i] = c < C ? xr[c] : 0.f;
        mu[u] += v[u][i];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < R; ++u)
        mu[u] += __shfl_xor_sync(0xffffffffu, mu[u], o);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      mu[u] /= C;
      q[u] = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const float d = v[u][i] - mu[u];
        q[u] += lane + 32 * i < C ? d * d : 0.f;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < R; ++u)
        q[u] += __shfl_xor_sync(0xffffffffu, q[u], o);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const float inv = rsqrtf(q[u] / C + eps);
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < kp)
          Y[swz(t0 + u, c)] = __float2bfloat16(
              c < C ? (v[u][i] - mu[u]) * inv * wv[i] + bv[i] : 0.f);
      }
    }
  }
}

// v[j] = vec[n0 + 8 j + 2 (lane % 4) + {0, 1}] where the column is below
// ``lim`` and the tile has it (else 0; all 0 for a null ``vec``): an
// epilogue's per-column vector, loaded before its product so that the
// loads land while the tiles arrive.
__device__ __forceinline__ void load_cols(float2 (&v)[4], const float* vec,
                                          int n0, int rows, int lim) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 8 * j + 2 * tq;
    const bool in = vec != nullptr && 8 * j < rows;
    v[j] = make_float2(in && n < lim ? vec[n] : 0.f,
                       in && n + 1 < lim ? vec[n + 1] : 0.f);
  }
}

// X[row, n0 + cols] += acc + v for the columns below C: the epilogue of
// proj and fc2, from the accumulator layout (rows 16 w + lane / 4 and + 8,
// column pairs 8 j + 2 (lane % 4))
__device__ __forceinline__ void add_into_stream(float* X, int ldx, int n0,
                                                int rows, int C,
                                                const float (&acc)[16],
                                                const float2 (&v)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 8 * j + 2 * (lane & 3);
    if (8 * j < rows && n < C) {     // C % 4 == 0: n + 1 < C too
      float2* x0 = reinterpret_cast<float2*>(X + t * ldx + n);
      float2* x1 = reinterpret_cast<float2*>(X + (t + 8) * ldx + n);
      float2 u = *x0, w = *x1;
      u.x += acc[4 * j] + v[j].x;
      u.y += acc[4 * j + 1] + v[j].y;
      w.x += acc[4 * j + 2] + v[j].x;
      w.y += acc[4 * j + 3] + v[j].y;
      *x0 = u;
      *x1 = w;
    }
  }
}

// a weight matrix [rows, cols] in 16-byte rows: its TMA map in 16-row boxes
int weight_map(CUtensorMap* map, const void* w, long long ld, int rows,
               int cols) {
  const Operand op = operand(w, ld);
  if (!op.vec16) return (int)cudaErrorInvalidValue;
  return encode_map(map, op, cols, rows, kBoxRows);
}

}  // namespace
