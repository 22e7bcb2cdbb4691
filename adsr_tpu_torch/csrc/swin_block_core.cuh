// The pieces of kernel (g) swin_block that its three window sizes share
// (swin_block.cu: 8x8 windows, one thread block a window; swin_block4.cu:
// 4x4 windows, four windows a block or a cluster of two; swin_block16.cu:
// 16x16 windows, a cluster of four thread blocks a window): every thread
// block holds 64 token rows (the M of every product) in an f32 residual
// stream in shared memory, a producer warp streams the packed weights by TMA
// into a ring of 64 x 64 tiles, and two consumer warpgroups run the products
// on wgmma with their epilogues from the accumulators; the LayerNorm over
// the 64 rows; the launch arguments and the weights' TMA maps.
//
// Two product paths. The 8x8 kernel splits every 64-column output tile
// between the warpgroups (mma_tile: m64n32k16 each, the tile drained before
// its epilogue); on the ping-pong path it measured 3% slower on the H100
// (PERF.md). The 4x4 and 16x16 kernels run the ping-pong path (mma_tile64,
// Turn, split_ring): each output tile belongs to one warpgroup
// (m64n64k16), and the tiles of the block's products alternate between the
// two in the order the producer streams them, each warpgroup's through a
// ring of its own, so that one warpgroup's epilogue runs while the other's
// mainloop keeps the tensor core busy (the pattern of CUTLASS's ping-pong
// kernels); a stage is released by the four warps of its tile's owner.

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

// The sweep's profile build (scripts/torch_swin_block16_sweep.py compiles
// the 4x4 and 16x16 sources with -DSWIN_PROFILE): the first thread of each
// consumer warpgroup adds the SM clocks it spends in each kind of step into
// adsr_swin_profile[slot] (the producer's leader its waits for empty
// stages, slot kProfEmpty); without the macro a step is only the step.
enum ProfileSlot {
  kProfFull, kProfBarrier, kProfCluster, kProfExchange, kProfAttention,
  kProfMainloop, kProfEpilogue, kProfNorm, kProfMerge, kProfSpan,
  kProfEmpty, kProfRecords, kProfSlots
};
#ifdef SWIN_PROFILE
__device__ unsigned long long adsr_swin_profile[kProfSlots];
#define SWIN_TIMED(slot, ...)                                              \
  do {                                                                     \
    const long long t0_ = clock64();                                       \
    __VA_ARGS__;                                                           \
    if ((threadIdx.x & 127) == 0 &&                                        \
        (threadIdx.x < kMathThreads) != ((slot) == kProfEmpty))            \
      atomicAdd(&adsr_swin_profile[slot],                                  \
                (unsigned long long)(clock64() - t0_));                    \
  } while (0)
// around a block (which may hold pragmas): a clock at its start, added
// into the slot at its end
#define SWIN_CLOCK_BEGIN(t) const long long t = clock64()
#define SWIN_CLOCK_END(slot, t)                                            \
  do {                                                                     \
    if ((threadIdx.x & 127) == 0 && threadIdx.x < kMathThreads)            \
      atomicAdd(&adsr_swin_profile[slot],                                  \
                (unsigned long long)(clock64() - (t)));                    \
  } while (0)
// the consumer's whole span, and one record a warpgroup
#define SWIN_SPAN_END(t)                                                   \
  do {                                                                     \
    SWIN_CLOCK_END(kProfSpan, t);                                          \
    if ((threadIdx.x & 127) == 0)                                          \
      atomicAdd(&adsr_swin_profile[kProfRecords], 1ull);                   \
  } while (0)
#else
#define SWIN_TIMED(slot, ...) __VA_ARGS__
#define SWIN_CLOCK_BEGIN(t)
#define SWIN_CLOCK_END(slot, t)
#define SWIN_SPAN_END(t)
#endif

__device__ __forceinline__ void math_barrier() {   // the consumer warpgroups
  SWIN_TIMED(kProfBarrier,
             asm volatile("bar.sync 1, %0;\n" :: "n"(kMathThreads)
                          : "memory"));
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

// ---- the ping-pong path ----

constexpr int kOwnerWarps = 4;   // a stage's empty arrivals: its owner's warps
constexpr int kMinRing = 2;      // stages a warpgroup's ring needs at least
                                 // (mma_tile64 holds one, awaits the next)
#ifndef SWIN_PRODUCTS
#define SWIN_PRODUCTS 1          // the ping-pong products' wgmma (0: the
#endif                           // stages awaited and released only)

// Whose the block's next output tile is: tile i of the producer's order
// belongs to warpgroup i % 2. Both warpgroups ask for every tile.
struct Turn {
  int n = 0;
  __device__ bool mine() { return (n++ & 1) == (int)(threadIdx.x >> 7); }
};

// The ring of warpgroup ``w`` on the ping-pong path: the block's ``stages``
// split in two (ceil and floor of a half), each half with its own full and
// empty barriers; the producer streams tile i into ring i % 2. Each
// warpgroup so waits on its own stages strictly in order: a wait on a
// stage's full barrier never runs two fills ahead of it (one shared ring
// would let a warpgroup that skips the other's tiles wait for a fill whose
// predecessor, the other's, had not landed, and the phase parity would
// pass).
__device__ __forceinline__ RingState split_ring(uint32_t base, uint32_t bars,
                                                int stages, int w) {
  const int s0 = (stages + 1) / 2;
  return w == 0 ? RingState{base, bars, s0, 0, 0u}
                : RingState{base + (uint32_t)(s0 * kStageBytes),
                            bars + 16u * s0, stages - s0, 0, 0u};
}

// the full (one arrival: the producer's) and empty (the owner's four
// warps) barriers of both rings
__device__ __forceinline__ void init_split_rings(uint32_t base, uint32_t bars,
                                                 int stages) {
  for (int w = 0; w < 2; ++w) {
    const RingState r = split_ring(base, bars, stages, w);
    for (int s = 0; s < r.stages; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), kOwnerWarps);
    }
  }
}

// a stage released: one arrival a warp of the tile's owner
__device__ __forceinline__ void release_stage(uint32_t bar) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// acc = A[64 x 64 ksteps] @ (the next ksteps tiles of weight rows of the
// owner's ring)^T by the tile's owner: m64n64k16, A a run of swizzled
// K-major atoms at shared address ``a``, one group in flight while the next
// stage is awaited, each stage released once the group that read it has
// retired. A ragged tile leaves its last columns with products of stale
// ring rows, which no epilogue reads (as mma_tile).
__device__ __forceinline__ void mma_tile64(RingState& r, uint32_t a,
                                           int ksteps, float (&acc)[32]) {
  SWIN_CLOCK_BEGIN(t_main);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int s = 0; s < ksteps; ++s) {
    SWIN_TIMED(kProfFull, mbar_wait(r.full(r.stage), r.phase));
    const uint32_t sb = r.base + r.stage * kStageBytes;
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (SWIN_PRODUCTS)
        wgmma_n64<0, 0>(acc,
                        smem_desc(a + s * kAtomBytes + kk * 32, 16, 1024),
                        smem_desc(sb + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_operand(acc);
    if (prev >= 0) release_stage(r.empty(prev));
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  fence_operand(acc);
  release_stage(r.empty(prev));
  SWIN_CLOCK_END(kProfMainloop, t_main);
}

// The same with A MN-major: ``KK`` k-steps of 16 rows (the reduction) x 64
// token columns at shared address ``a`` (128-byte rows, swizzled), read
// from (KK + 3) / 4 ring stages, the last one's k-steps past KK left out
// (KK is a constant: the sequence has no branch). Kernel (g) at 16x16
// windows multiplies its transposed context this way.
template <int KK>
__device__ __forceinline__ void mma_tile64_mn(RingState& r, uint32_t a,
                                              float (&acc)[32]) {
  SWIN_CLOCK_BEGIN(t_main);
  constexpr int kStages = (KK + 3) / 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  int prev = -1;
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    SWIN_TIMED(kProfFull, mbar_wait(r.full(r.stage), r.phase));
    const uint32_t sb = r.base + r.stage * kStageBytes;
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (SWIN_PRODUCTS && 4 * s + kk < KK)
        wgmma_n64<1, 0>(acc,
                        smem_desc(a + (4 * s + kk) * 2048, kAtomBytes, 1024),
                        smem_desc(sb + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_operand(acc);
    if (prev >= 0) release_stage(r.empty(prev));
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  fence_operand(acc);
  release_stage(r.empty(prev));
  SWIN_CLOCK_END(kProfMainloop, t_main);
}

// v[j] = vec[n0 + 8 j + 2 (lane % 4) + {0, 1}] for the owner's 64 columns,
// as load_cols
__device__ __forceinline__ void load_cols64(float2 (&v)[8], const float* vec,
                                            int n0, int rows, int lim) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + 8 * j + 2 * tq;
    const bool in = vec != nullptr && 8 * j < rows;
    v[j] = make_float2(in && n < lim ? vec[n] : 0.f,
                       in && n + 1 < lim ? vec[n + 1] : 0.f);
  }
}

// X[row, n0 + cols] += acc + v for the columns below C: the epilogue of
// proj and fc2 on the ping-pong path (one warpgroup's m64n64 accumulators:
// rows 16 (warp % 4) + lane / 4 and + 8)
__device__ __forceinline__ void add_into_stream64(float* X, int ldx, int n0,
                                                  int rows, int C,
                                                  const float (&acc)[32],
                                                  const float2 (&v)[8]) {
  SWIN_CLOCK_BEGIN(t_epi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
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
  SWIN_CLOCK_END(kProfEpilogue, t_epi);
}

// Columns [c0, c0 + 64) of a 128-wide hidden chunk ``Hb`` (two swizzled
// atoms) = GELU(acc + b1) (exact erf) where hidden column f0 + c is below
// F, else 0: fc1's epilogue on the ping-pong path (``rows`` the tile's
// weight rows)
__device__ __forceinline__ void gelu_into_chunk(bf16* Hb, int c0, int rows,
                                                int f0, int F,
                                                const float (&acc)[32],
                                                const float2 (&v)[8]) {
  SWIN_CLOCK_BEGIN(t_epi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = 16 * (warp & 3) + (lane >> 2), tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int c = c0 + 8 * j + 2 * tq + x;
      float u = 0.f, w = 0.f;
      if (8 * j < rows && f0 + c < F) {
        const float bb = x ? v[j].y : v[j].x;
        u = acc[4 * j + x] + bb;
        w = acc[4 * j + 2 + x] + bb;
        u = 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
        w = 0.5f * w * (1.f + erff(w * 0.70710678118654752f));
      }
      Hb[swz(t, c)] = __float2bfloat16(u);
      Hb[swz(t + 8, c)] = __float2bfloat16(w);
    }
  }
  SWIN_CLOCK_END(kProfEpilogue, t_epi);
}

// ---- thread-block clusters (swin_block4.cu, swin_block16.cu) ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier, split. Arrive has release and wait acquire
// semantics, so the shared-memory writes before an arrive are visible to
// every block of the cluster after its wait. Every thread of the cluster
// takes part; a warp arrives and waits as a whole (.aligned).
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  SWIN_TIMED(kProfCluster,
             asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"));
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the shared address ``a`` of this block in cluster block ``rank``
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ uint4 ld_cluster16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a)
               : "memory");
  return v;
}

// Y (swizzled) = LayerNorm(X) over the true C (f32 two-pass statistics),
// zero in columns [C, kp), for the ROWS rows from ``row0``; each consumer
// warp takes ROWS / 8 of them, four at a time so that their shuffle
// reductions overlap.
template <int ROWS = kBlockRows>
__device__ void layer_norm(const float* X, int ldx, bf16* Y, int C, int kp,
                           const float* __restrict__ w,
                           const float* __restrict__ b, float eps,
                           int row0 = 0) {
  SWIN_CLOCK_BEGIN(t_norm);
  constexpr int R = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float wv[kMaxPerLane], bv[kMaxPerLane];   // the lane's columns, once
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    wv[i] = c < C ? w[c] : 0.f;
    bv[i] = c < C ? b[c] : 0.f;
  }
  constexpr int kRows = ROWS / (kMathThreads / 32);
  static_assert(kRows % R == 0, "whole groups of R rows a warp");
  for (int t0 = row0 + kRows * warp; t0 < row0 + kRows * warp + kRows;
       t0 += R) {
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
  SWIN_CLOCK_END(kProfNorm, t_norm);
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
