// swin_block: one whole Swin Transformer block in one launch, one thread
// block per (image, 8x8 window): LN1 -> qkv -> shifted-window multi-head
// attention (relative-position bias + shift mask, stabilised softmax) ->
// proj + residual -> LN2 -> fc1 + exact-erf GELU -> fc2 + residual.
//
// Replaces: the Pallas kernel fused_swin_block
// (adsr_tpu/ops/fused_swin_block.py:297, body _kernel :215, pallas_call
// :337), the per-block program of the "block" serving mode
// (adsr_tpu/ops/fused_drct.py:168-189).
// Bound on H100: operations. A block of the flagship RDG does ~1.2k flop per
// byte of its activations (the weights are read from L2 by every window),
// far above the bf16 ridge, so the bound is the tensor-core rate.
// Design: the TPU kernel keeps one image's tokens in VMEM; on Hopper the
// unit that fits in shared memory is one window. Attention is local to the
// window and everything else is row-local, so a thread block gathers the
// window's 64 token rows (the cyclic shift is index arithmetic: token (r, s)
// of shifted window (wi, wj) is raster row ((wi*8+r+shift) mod H)*W +
// (wj*8+s+shift) mod W, the map window_attention uses), keeps the residual
// stream in f32 in shared memory through the whole block, and writes the 64
// rows back once through the same map.
//   - Weights: a producer warp streams 64-row x 64-column tiles of the packed
//     weights (16-byte rows, kernels/fused_rdg.py) by TMA (16-row boxes,
//     128-byte swizzle, zeros past every edge) into a ring of 8 KB stages
//     with full/empty mbarriers, in the order the products consume them,
//     so the L2 latency of the weight stream hides behind the ring.
//   - Products: two consumer warpgroups run every product on wgmma
//     m64n32k16, each on 32 of a tile's 64 weight rows (M = the window's
//     64 rows), A (LayerNorm output, context, hidden chunk) from
//     128-byte-swizzled shared memory, B from the ring; each product's
//     epilogue runs from the accumulator registers (bias, GELU, residual
//     add into the f32 stream), with no f32 staging tile.
//   - Attention, per head: the qkv product writes the head's q, k, v
//     planes (head dim zero-padded to a multiple of 16: 30/53/122/46/77 at
//     the flagship), then each warp runs the register-resident core of
//     window_attn_core.cuh (shared with kernel (c)) on its 16 query rows
//     (the first warpgroup's 4 warps: the planes hold one head) and
//     writes its context straight into a swizzled A tile, and the head's
//     share of proj (its hd columns of Wproj) accumulates into the stream:
//     one head's context in shared memory instead of all of them leaves
//     room for a deeper ring.
//   - MLP in chunks of 64 hidden columns: fc1 + GELU into one swizzled
//     tile, then fc2 accumulates it into the f32 stream.
// A tile waits about an L2 round trip, so the ring is as deep as shared
// memory allows (up to 16 stages). One window a block: the f32 residual of
// one window (up to 64 x 312 x 4 = 80 KB) stays in shared memory, so a
// block runs alone on its SM (two waves of 128 blocks at batch 16), and two
// consumer warpgroups share the window's work, so that its gather,
// LayerNorms and epilogues run on 8 warps. Two windows a block would need
// the residual in registers: left for later. Numerics are the eager model's:
// stabilised f32 softmax, exact erf, no weight folds (the TPU kernel's A&S
// erf polynomial was a Mosaic workaround).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper_gemm.cuh"        // mbarrier, TMA, wgmma and tensor-map wrappers
#include "window_attn_core.cuh"   // the attention core shared with (c)

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWin = 8;
constexpr int kTok = kWin * kWin;              // tokens per window (M)
constexpr int kMathGroups = 2;                 // consumer warpgroups
constexpr int kMathThreads = 128 * kMathGroups;
constexpr int kThreads = kMathThreads + 32;    // + the producer warp
constexpr int kTileRows = 64;                  // weight rows a stage holds
constexpr int kBoxRows = 16;                   // rows of one TMA box
constexpr int kStageBytes = kTileRows * 128;   // 64 rows x 64 bf16
constexpr int kHalf = kTileRows / kMathGroups; // a warpgroup's rows of a tile
constexpr int kMaxStages = 16;
constexpr int kMaxC = 320;                     // LayerNorm: <= 10 values a lane
constexpr int kMaxPerLane = kMaxC / 32;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
// weight rows of a tile of the ``n`` rows left of a product
__host__ __device__ inline int tile_rows(int n) {
  return n < kTileRows ? round16(n) : kTileRows;
}

// Shared memory (byte offsets from the 1024-aligned base), for width C, head
// dim hd (its tile HDP = hd rounded up to 16) and ``stages`` ring stages:
//   ring   stages x 8 KB of weight tiles
//   y      the LayerNorm output as swizzled A atoms [kp / 64][64 x 64] bf16
//   ctx    one head's context, the same way (hk = ceil((hd + 7) / 64)
//          atoms: the context starts at column (h hd) % 8, so that its
//          share of Wproj starts 16-byte aligned for TMA); in the MLP, the
//          hidden chunk
//   x      the f32 residual stream [64][ldx] (ldx = 8 mod 16: the
//          accumulator layout's float2 stores hit 32 distinct banks)
//   qkv    one head's q, k, v planes [3][64][hdp + 8] bf16
//   bars   a full and an empty mbarrier a stage
struct Layout {
  int kp, hk, ldx, ldq;
  size_t y, ctx, x, qkv, bars, bytes;
};

__host__ __device__ inline Layout make_layout(int C, int hd, int stages) {
  const int HDP = round16(hd);
  Layout L;
  L.kp = (C + 63) / 64 * 64;
  L.hk = (hd + 7 + 63) / 64;
  L.ldx = C + (24 - C % 16) % 16;
  L.ldq = HDP + 8;
  size_t off = (size_t)stages * kStageBytes;
  L.y = off;   off += (size_t)L.kp / 64 * kAtomBytes;
  L.ctx = off; off += (size_t)L.hk * kAtomBytes;
  L.x = off;   off += (size_t)kTok * L.ldx * 4;
  L.qkv = off; off += (size_t)3 * kTok * L.ldq * 2;
  L.bars = off; off += (size_t)16 * stages;
  L.bytes = 1024 + off;          // room to align the base to 1024 bytes
  return L;
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
  constexpr int kRows = kTok / (kMathThreads / 32);
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

__device__ __forceinline__ long long token_row(int b, int wi, int wj, int t,
                                               int H, int W, int shift) {
  const int r = t / kWin, s = t % kWin;
  const int row = (wi * kWin + r + shift) % H;
  const int col = (wj * kWin + s + shift) % W;
  return (long long)b * H * W + (long long)row * W + col;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swin_block_kernel(const __grid_constant__ Maps maps, const Args a) {
  const int C = a.C, F = a.F, hd = a.hd;
  const Layout L = make_layout(C, hd, a.stages);
  extern __shared__ __align__(1024) unsigned char swin_smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(swin_smem);
  unsigned char* smem = swin_smem + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  RingState ring{sbase, sbase + (uint32_t)L.bars, a.stages, 0, 0u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(ring.full(s), 1);                  // the producer's arrival
      mbar_init(ring.empty(s), kMathThreads / 32); // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nww = a.W / kWin;
  const int nw = (a.H / kWin) * nww;
  const int win = blockIdx.x % nw;
  const int b = blockIdx.x / nw;
  const int wi = win / nww, wj = win % nww;
  const int ks = (C + 63) / 64;                    // 64-wide K steps over c
  const int hk = L.hk;                             // ... over a head's dims

  if (threadIdx.x >= kMathThreads) {
    // ---- producer: every weight tile, in the consumers' order ----
    if (threadIdx.x == kMathThreads) {
      auto load = [&](const CUtensorMap* map, int row0, int rows, int k0) {
        mbar_wait(ring.empty(ring.stage), ring.phase ^ 1);
        mbar_arrive_expect_tx(ring.full(ring.stage), rows * 128);
        const uint32_t dst = sbase + ring.stage * kStageBytes;
        for (int i = 0; i < rows; i += kBoxRows)
          tma_2d(dst + i * 128, map, k0, row0 + i, ring.full(ring.stage));
        ring.advance();
      };
      for (int h = 0; h < a.nh; ++h) {
        for (int p = 0; p < 3; ++p)
          for (int n0 = 0; n0 < HDP; n0 += kTileRows)
            for (int s = 0; s < ks; ++s)
              load(&maps.qkv, p * C + h * hd + n0, min(kTileRows, HDP - n0),
                   64 * s);
        for (int n0 = 0; n0 < C; n0 += kTileRows)     // the head's proj share
          for (int s = 0; s < hk; ++s)
            load(&maps.proj, n0, tile_rows(C - n0), (h * hd & ~7) + 64 * s);
      }
      for (int f0 = 0; f0 < F; f0 += kTileRows) {
        for (int s = 0; s < ks; ++s)
          load(&maps.fc1, f0, tile_rows(F - f0), 64 * s);
        for (int n0 = 0; n0 < C; n0 += kTileRows)
          load(&maps.fc2, n0, tile_rows(C - n0), f0);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * (warp & 3), g = lane >> 2, tq = lane & 3;
  const int wg = tid >> 7;              // consumer warpgroup
  const int cb = kHalf * wg;            // its columns of every output tile
  const int ldx = L.ldx, ldq = L.ldq, kp = L.kp;
  float* X = reinterpret_cast<float*>(smem + L.x);
  bf16* Y = reinterpret_cast<bf16*>(smem + L.y);
  bf16* Cx = reinterpret_cast<bf16*>(smem + L.ctx);
  bf16* Hb = Cx;                        // the MLP's hidden chunk, after proj
  bf16* planes = reinterpret_cast<bf16*>(smem + L.qkv);
  const uint32_t s_y = sbase + (uint32_t)L.y, s_ctx = sbase + (uint32_t)L.ctx;
  const uint32_t s_q = sbase + (uint32_t)L.qkv;
  const uint32_t plane_bytes = 2u * kTok * ldq;
  float acc[16];

  // gather the window's rows into the f32 residual: every 8-byte copy in
  // flight at once, by cp.async into the Y region (LN1 overwrites it), then
  // widened; the context tile is zero past the head dim (proj reduces over
  // hk atoms)
  const int q4 = C / 4;
  for (int i = tid; i < kTok * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    cp_async<8>(s_y + 2u * (t * C + c),
                a.x + token_row(b, wi, wj, t, a.H, a.W, a.shift) * a.ldx + c,
                8);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  math_barrier();
  for (int i = tid; i < kTok * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    *reinterpret_cast<float4*>(X + t * ldx + c) =
        unpack4(*reinterpret_cast<const uint2*>(Y + t * C + c));
  }
  for (int i = tid; i < kTok * 64 * hk; i += kMathThreads)
    Cx[i] = __float2bfloat16(0.f);
  math_barrier();
  layer_norm(X, ldx, Y, C, kp, a.ln1_w, a.ln1_b, a.eps);
  fence_async_shared();
  math_barrier();

  // ---- attention and proj, one head at a time: X += ctx_h Wproj_h^T ----
  const float* mw = a.mask != nullptr ? a.mask + (size_t)win * kTok * kTok
                                      : nullptr;
  float2 vec[4];
  for (int h = 0; h < a.nh; ++h) {
    for (int p = 0; p < 3; ++p) {      // q, k, v of head h into its plane
      bf16* plane = planes + p * kTok * ldq;
      for (int n0 = 0; n0 < HDP; n0 += kTileRows) {
        const int rows = min(kTileRows, HDP - n0);
        load_cols(vec, a.bqkv + p * C + h * hd, n0 + cb, rows - cb, hd);
        mma_tile(ring, s_y, ks, acc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = n0 + cb + 8 * j + 2 * tq;
          if (cb + 8 * j < rows) {     // zeros past the head dim
            const bool in0 = d < hd, in1 = d + 1 < hd;
            *reinterpret_cast<__nv_bfloat162*>(plane + (r0 + g) * ldq + d) =
                __floats2bfloat162_rn(in0 ? acc[4 * j] + vec[j].x : 0.f,
                                      in1 ? acc[4 * j + 1] + vec[j].y : 0.f);
            *reinterpret_cast<__nv_bfloat162*>(plane + (r0 + g + 8) * ldq
                                               + d) =
                __floats2bfloat162_rn(in0 ? acc[4 * j + 2] + vec[j].x : 0.f,
                                      in1 ? acc[4 * j + 3] + vec[j].y : 0.f);
          }
        }
      }
    }
    math_barrier();                    // the head's planes are whole
    // the context at columns oc + d of its tile, oc = (h hd) % 8: the
    // tile's column 0 is Wproj's column h hd - oc, 16-byte aligned
    const int oc = (h * hd) & 7;
    if (wg == 0) {                     // the core on the first warpgroup
      float o[HDP / 8][4];
      attn_core<HDP>(s_q, s_q + plane_bytes, s_q + 2 * plane_bytes, ldq, r0,
                     a.bias + (size_t)h * kTok * kTok, mw, a.scale, o);
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int d = 8 * j + 2 * tq + x;
          if (d < hd) {
            Cx[swz(r0 + g, oc + d)] = __float2bfloat16(o[j][x]);
            Cx[swz(r0 + g + 8, oc + d)] = __float2bfloat16(o[j][2 + x]);
          }
        }
      }
    }
    fence_async_shared();
    math_barrier();                    // the context is whole; the planes free
    for (int n0 = 0; n0 < C; n0 += kTileRows) {
      const int rows = tile_rows(C - n0);
      load_cols(vec, h == 0 ? a.bproj : nullptr, n0 + cb, rows - cb, C);
      mma_tile(ring, s_ctx, hk, acc);
      add_into_stream(X, ldx, n0 + cb, rows - cb, C, acc, vec);
    }
    math_barrier();                    // the context is read before it changes
    // back to zeros, so the next head's tile is zero off its own columns
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int d = 8 * j + 2 * tq + x;
          if (d < hd) {
            Cx[swz(r0 + g, oc + d)] = __float2bfloat16(0.f);
            Cx[swz(r0 + g + 8, oc + d)] = __float2bfloat16(0.f);
          }
        }
      }
    }
  }

  // ---- MLP: X += GELU(LN2(X) W1^T + b1) W2^T + b2, 64 hidden at a time ----
  layer_norm(X, ldx, Y, C, kp, a.ln2_w, a.ln2_b, a.eps);
  fence_async_shared();
  math_barrier();
  for (int f0 = 0; f0 < F; f0 += kTileRows) {
    const int rows = tile_rows(F - f0);
    load_cols(vec, a.b1 + f0, cb, rows - cb, F - f0);
    mma_tile(ring, s_y, ks, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {      // every column of the chunk, zeros
#pragma unroll                          // past F
      for (int x = 0; x < 2; ++x) {
        const int c = cb + 8 * j + 2 * tq + x;
        float u = 0.f, v = 0.f;
        if (cb + 8 * j < rows && f0 + c < F) {
          const float bb = x ? vec[j].y : vec[j].x;
          u = acc[4 * j + x] + bb;
          v = acc[4 * j + 2 + x] + bb;
          u = 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
          v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
        }
        Hb[swz(r0 + g, c)] = __float2bfloat16(u);
        Hb[swz(r0 + g + 8, c)] = __float2bfloat16(v);
      }
    }
    fence_async_shared();
    math_barrier();
    for (int n0 = 0; n0 < C; n0 += kTileRows) {
      const int rows2 = tile_rows(C - n0);
      load_cols(vec, f0 == 0 ? a.b2 : nullptr, n0 + cb, rows2 - cb, C);
      mma_tile(ring, s_ctx, 1, acc);
      add_into_stream(X, ldx, n0 + cb, rows2 - cb, C, acc, vec);
    }
    math_barrier();                    // the chunk is read before it changes
  }

  // ---- scatter the window's rows back ----
  for (int i = tid; i < kTok * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    *reinterpret_cast<uint2*>(
        a.out + token_row(b, wi, wj, t, a.H, a.W, a.shift) * a.ldo + c) =
        pack4(*reinterpret_cast<const float4*>(X + t * ldx + c));
  }
}

template <int HDP>
int launch(const Args& a, const Maps& maps, int B, long long smem,
           cudaStream_t stream) {
  const Layout L = make_layout(a.C, a.hd, a.stages);
  if (a.stages < 2 || a.stages > kMaxStages || (long long)L.bytes != smem ||
      L.bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static size_t configured = 0;   // per template instance
  if (L.bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        swin_block_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L.bytes);
    if (e != cudaSuccess) return (int)e;
    configured = L.bytes;
  }
  const long long blocks = (long long)B * (a.H / kWin) * (a.W / kWin);
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  swin_block_kernel<HDP><<<(unsigned)blocks, kThreads, L.bytes, stream>>>(
      maps, a);
  return (int)cudaGetLastError();
}

// a weight matrix [rows, cols] in 16-byte rows: its TMA map in 16-row boxes
int weight_map(CUtensorMap* map, const void* w, long long ld, int rows,
               int cols) {
  const Operand op = operand(w, ld);
  if (!op.vec16) return (int)cudaErrorInvalidValue;
  return encode_map(map, op, cols, rows, kBoxRows);
}

}  // namespace

// ``stages`` and ``smem`` are the ring depth and shared-memory size the
// caller planned (kernels/fused_swin_block.py ``swin_block_plan``); a launch
// whose plan differs from this file's layout is refused. The weights are
// torch Linear matrices with 16-byte rows (row strides ld*, multiples of 8).
extern "C" int adsr_swin_block(
    const void* x, long long ldx, void* out, long long ldo, const void* ln1_w,
    const void* ln1_b, const void* wqkv, long long ld_qkv, const void* bqkv,
    const void* bias, const void* mask, const void* wproj, long long ld_proj,
    const void* bproj, const void* ln2_w, const void* ln2_b, const void* w1,
    long long ld1, const void* b1, const void* w2, long long ld2,
    const void* b2, int B, int H, int W, int C, int F, int nh, int win,
    int shift, int stages, float eps, long long smem, void* stream) {
  if (win != kWin || H % kWin || W % kWin || B < 0 || C <= 0 || C > kMaxC ||
      C % 4 || F <= 0 || F % 4 || nh <= 0 || C % nh || ldx % 4 || ldo % 4 ||
      ldx < C || ldo < C || shift < 0 || shift >= kWin ||
      (shift > 0) != (mask != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.x = (const bf16*)x; a.ldx = ldx; a.out = (bf16*)out; a.ldo = ldo;
  a.ln1_w = (const float*)ln1_w; a.ln1_b = (const float*)ln1_b;
  a.bqkv = (const float*)bqkv; a.bias = (const float*)bias;
  a.mask = (const float*)mask; a.bproj = (const float*)bproj;
  a.ln2_w = (const float*)ln2_w; a.ln2_b = (const float*)ln2_b;
  a.b1 = (const float*)b1; a.b2 = (const float*)b2;
  a.H = H; a.W = W; a.C = C; a.F = F; a.nh = nh; a.hd = C / nh;
  a.shift = shift; a.stages = stages; a.eps = eps;
  a.scale = (float)(1.0 / std::sqrt((double)a.hd));
  Maps maps;
  int rc = weight_map(&maps.qkv, wqkv, ld_qkv, 3 * C, C);
  if (!rc) rc = weight_map(&maps.proj, wproj, ld_proj, C, C);
  if (!rc) rc = weight_map(&maps.fc1, w1, ld1, F, C);
  if (!rc) rc = weight_map(&maps.fc2, w2, ld2, C, F);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((a.hd + 15) / 16) {
    case 1: return launch<16>(a, maps, B, smem, s);
    case 2: return launch<32>(a, maps, B, smem, s);
    case 3: return launch<48>(a, maps, B, smem, s);
    case 4: return launch<64>(a, maps, B, smem, s);
    case 5: return launch<80>(a, maps, B, smem, s);
    case 6: return launch<96>(a, maps, B, smem, s);
    case 7: return launch<112>(a, maps, B, smem, s);
    case 8: return launch<128>(a, maps, B, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
