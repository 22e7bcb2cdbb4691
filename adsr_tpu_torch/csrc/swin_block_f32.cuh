// swin_block_f32.cuh: kernel (g) in full f32, one whole Swin Transformer
// block in one launch: LN1 -> qkv -> shifted-window multi-head attention
// (relative-position bias + shift mask, stabilised softmax) -> proj +
// residual -> LN2 -> fc1 + exact-erf GELU -> fc2 + residual, every product
// on f32 operands summed in f32 (FFMA on the CUDA cores: no TF32, no bf16).
//
// Replaces: the Pallas kernel fused_swin_block
// (adsr_tpu/ops/fused_swin_block.py:297, body _kernel :215, pallas_call
// :337) at dtype f32, where the TPU kernel's matmul dtype is its input's
// (:221) and its scratches take x.dtype (:345-350): the per-block program
// of the JAX "block" serving mode in fp32 (ADSR_TPU_RDG=0,
// adsr_tpu/ops/fused_drct.py:168-189).
// Bound on H100: operations. A flagship block does ~1.2k flop per byte of
// its activations (the weights are read from L2 by every window), far
// above the f32 ridge (67 TFLOP/s of FFMA against 3.35 TB/s: 20 flop a
// byte).
// Design: a block of 256 threads holds 64 token rows of one window (8x8
// windows: a block a window), of four consecutive windows over the flat
// (image, window) index (4x4: the last group possibly short), or one
// 64-row query tile of a 16x16 window (a cluster of four blocks a window,
// the peers' K and V read in their shared memory through distributed
// shared memory). The bf16 kernel's layout doubled to f32 does not fit
// an SM (an LN output, the residual and one head's q/k/v planes of 64 rows
// are ~260 KB at the flagship), so this one keeps neither the LN1 output
// nor the pre-attention stream: the input rows stay in device memory
// (L2), which the block reads three times (LN1's statistics, the qkv
// products' A operand, the proj residual).
//   - LN1 on load: the per-row mean and 1/std (two-pass f32 statistics, as
//     rdg_layernorm.cu) are computed once; every qkv product stages its A
//     tile of raw rows by cp.async and each thread normalises the piece it
//     staged before the block reads it.
//   - Per head: the qkv product writes the head's q, k and v planes
//     [64][hdp + 4] (head dim zero-padded to a multiple of 16: 30/53/122/
//     46/77 at the flagship), then the SIMT online-softmax core
//     (window_attention_f32.cuh attend_scores / attend_pv) runs over the
//     window's key tiles and writes the head's context into its columns
//     of the context buffer ``act`` [64][ldc] (all heads before proj). At
//     16x16 windows each peer's K, then V, tile is pulled whole into the
//     product ring (idle between products) before the core reads it.
//   - proj from ``act`` into the f32 stream ``y`` (over the dead planes),
//     with the bias and the input rows' residual; LN2 of ``y`` into
//     ``act``; the MLP in chunks of 128 hidden columns: fc1 + GELU into
//     ``hid`` [64][132], fc2 accumulated into ``y``; ``y`` written back to
//     the rows once.
//   - Products: a 64 x 64 output tile a pass, each thread 4 x 4 outputs
//     (rows tm + 16 i, columns tn + 16 j); K in steps of 16 through a
//     3-stage cp.async ring of W tiles (rows past N and columns past K
//     zero-filled), A read in place from shared memory (or from the ring,
//     for qkv), one barrier a step. Each output is one f32 sum over k in
//     increasing order (fc2's over each 128-column chunk, the chunks added
//     in order): bitwise repeatable, graph-capturable, no atomics. Left
//     out, their arithmetic saves under a third of the block's time at
//     8x8 windows (scripts/torch_swin_block_f32_sweep.py): the FFMA rate
//     is not what bounds them.
// Each window's rows follow the raster-row map of window_attention (the
// cyclic shift is index arithmetic). The bias and mask come in the forms
// of kernels/window_attention.py ``attn_operands``: [nh, N, N] and [nW, N,
// N] at N = 16 and 64, the relative-position table and region labels at
// N = 256. Shared memory from kernels/fused_swin_block.py
// ``swin_block_f32_plan``; a launch whose plan differs is refused.
//
// The kernel and its launch live here; one source a window includes it
// (swin_block4_f32.cu, swin_block_f32.cu, swin_block16_f32.cu), so nvcc
// builds the three windows' instances in parallel.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "window_attention_f32.cuh"   // attend_*, attn_term, token_row

// Ablations for scripts/torch_swin_block_f32_sweep.py (timing only: the
// results are then not the block's): SWIN_F32_ATTEND 0 leaves out the
// attention (the context stays 0), SWIN_F32_FMA 0 the products' arithmetic
// (one add in four; the loads, barriers and epilogues stay),
// SWIN_F32_LN_LOAD 0 the normalisation of the qkv products' A tiles.
#ifndef SWIN_F32_ATTEND
#define SWIN_F32_ATTEND 1
#endif
#ifndef SWIN_F32_FMA
#define SWIN_F32_FMA 1
#endif
#ifndef SWIN_F32_LN_LOAD
#define SWIN_F32_LN_LOAD 1
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kBlockRows = 64;         // token rows a block holds
constexpr int kStepK = 16;             // K a ring stage
constexpr int kTileN = 64;             // output columns a product pass
constexpr int kRingPitch = kStepK + 4; // floats a staged row: 80 bytes
constexpr int kRingStages = 3;
constexpr int kChunk = 128;            // hidden columns of an MLP chunk
constexpr int kHidPitch = kChunk + 4;
constexpr int kGroup4 = 4;             // windows a block at 4x4 windows
constexpr int kCluster16 = 4;          // blocks a 16x16 window
constexpr int kMaxC = 320;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The block's shared memory, in bytes from the base, in this order: the
// rows' token offsets (``rows``, int64, -1 past the last window), LN1's
// per-row mean and 1/std (``ln``), the context / LN2 buffer ``act``
// [64][ldc], a union of the attention's q, k, v planes [3][64][hdp + 4],
// scores [R][R + 4] and row statistics [3][R] (R = min(N, 64)) or the
// MLP's stream ``y`` [64][ldc] and hidden chunk ``hid`` [64][132], and the
// product ring (``ring``: A and W tiles [3][64][20] each), which at N =
// 256 also holds, between products, the peer K or V plane being read
// (``stage`` [64][hdp + 4]). kernels/fused_swin_block.py
// ``swin_block_f32_plan`` mirrors it.
struct LayoutF32 {
  int ldc;                    // floats a row of act and y
  size_t rows, ln, ring, act, uni, bytes;   // offsets, and the total
};

__host__ __device__ inline LayoutF32 make_layout_f32(int C, int hdp, int N) {
  LayoutF32 L;
  const int kp = (C + kStepK - 1) / kStepK * kStepK;
  const int R = N < 64 ? N : 64;
  L.ldc = kp + 4;             // two rows 16 or 80 bytes apart in the banks
  const size_t rows_b = 8ull * kBlockRows, ln_b = 2ull * 4 * kBlockRows;
  const size_t ring_b = 2ull * kRingStages * kBlockRows * kRingPitch * 4;
  const size_t act_b = 4ull * kBlockRows * L.ldc;
  // the union: planes, scores and row statistics, or y and hid
  const size_t attn = 4ull * 3 * kBlockRows * (hdp + 4) + 4ull * R * (R + 4)
                      + 4ull * 3 * R;
  const size_t mlp = act_b + 4ull * kBlockRows * kHidPitch;
  const size_t stage_b = N == 256 ? 4ull * kBlockRows * (hdp + 4) : 0;
  L.rows = 0;
  L.ln = L.rows + rows_b;
  L.act = L.ln + ln_b;
  L.uni = L.act + act_b;
  L.ring = L.uni + (attn > mlp ? attn : mlp);
  L.bytes = L.ring + (ring_b > stage_b ? ring_b : stage_b);
  return L;
}

struct ArgsF32 {
  const float* x; long long ldx;
  float* out; long long ldo;
  const float *ln1_w, *ln1_b;
  const float* wqkv; long long ld_qkv;
  const float* bqkv;
  const float* bias; const void* mask;
  const float* wproj; long long ld_proj;
  const float* bproj;
  const float *ln2_w, *ln2_b;
  const float* w1; long long ld1;
  const float* b1;
  const float* w2; long long ld2;
  const float* b2;
  int B, H, W, C, F, nh, hd, shift, windows;
  float eps, scale;
};

// The W rows of a product: output o reads row (o / hd) * c + col + o % hd
// when ``hd`` (the qkv product of one head: its q, k and v rows), else row
// o; K runs from ``w``'s column (fc2's chunk: ``w`` starts at the chunk).
struct WeightRows {
  const float* w;
  long long ldw;
  int n, k, hd, c, col;
  __device__ __forceinline__ const float* row(int o) const {
    const long long r = hd ? (long long)(o / hd) * c + col + o % hd : o;
    return w + r * ldw;
  }
};

// The A operand of a product: [64][k] in shared memory at ``a`` (pitch
// ``lda``), or, with ``x`` set, the block's raw input rows staged through
// the ring and normalised on arrival (LN1).
struct Operand {
  const float* a;
  int lda;
  const float* x;             // the input, rows at ``rows``; null: a
  long long ldx;
  const long long* rows;
  const float *mu, *rstd, *g, *b;
};

// out tile [64][64] at output columns n0.. of A @ W^T: each thread's
// 4 x 4 sums (rows tm + 16 i, columns tn + 16 j) go to ``epi(r, n, v)``,
// past the product's N too (the epilogue decides). Every thread of the
// block takes part; the ring is free again on return.
template <typename Epi>
__device__ void product_tile(const Operand& A, const WeightRows& Wr, int n0,
                             float* ring, Epi&& epi) {
  float* ring_a = ring;
  float* ring_w = ring + kRingStages * kBlockRows * kRingPitch;
  constexpr int kStage = kBlockRows * kRingPitch;
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  // one 16-byte piece a thread a stage, of the W tile and (LN1) of A
  const int pr = tid / (kStepK / 4), pk = 4 * (tid % (kStepK / 4));
  const int o = n0 + pr;
  const float* wsrc = o < Wr.n ? Wr.row(o) : Wr.w;
  const long long xrow = A.x != nullptr ? A.rows[pr] : -1;
  const int steps = (Wr.k + kStepK - 1) / kStepK;

  auto stage = [&](int slot, int step) {
    const int k = step * kStepK + pk;
    const bool w_in = o < Wr.n && k < Wr.k;
    cp_async16((uint32_t)__cvta_generic_to_shared(
                   ring_w + slot * kStage + pr * kRingPitch + pk),
               w_in ? wsrc + k : Wr.w, w_in ? 16 : 0);
    if (A.x != nullptr) {
      const bool ain = xrow >= 0 && k < Wr.k;
      cp_async16((uint32_t)__cvta_generic_to_shared(
                     ring_a + slot * kStage + pr * kRingPitch + pk),
                 ain ? A.x + xrow * A.ldx + k : A.x, ain ? 16 : 0);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) {
    if (s < steps) stage(s, s);
    cp_async_commit();                    // one group a step, empty or not
  }
  for (int step = 0; step < steps; ++step) {
    const int slot = step % kRingStages;
    cp_async_wait<kRingStages - 2>();     // this thread's piece has landed
    if (SWIN_F32_LN_LOAD && A.x != nullptr) {   // LN1 of its own piece
      const int k = step * kStepK + pk;
      if (xrow >= 0 && k < Wr.k) {
        float* v = ring_a + slot * kStage + pr * kRingPitch + pk;
        const float mu = A.mu[pr], rs = A.rstd[pr];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          v[x] = (v[x] - mu) * rs * __ldg(A.g + k + x) + __ldg(A.b + k + x);
      }
    }
    __syncthreads();                      // the step's tiles for all, and
    const int next = step + kRingStages - 1;  // the last step's reads done
    if (next < steps) stage(next % kRingStages, next);
    cp_async_commit();
    const float* ta;
    int pa;
    if (A.x != nullptr) {
      ta = ring_a + slot * kStage;
      pa = kRingPitch;
    } else {
      ta = A.a + step * kStepK;
      pa = A.lda;
    }
    const float* tw = ring_w + slot * kStage;
#pragma unroll
    for (int kk = 0; kk < kStepK; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(ta + (tm + 16 * i) * pa + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(tw + (tn + 16 * j)
                                                * kRingPitch + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#if SWIN_F32_FMA
          float v = acc[i][j];
          v = fmaf(a[i].x, b[j].x, v);
          v = fmaf(a[i].y, b[j].y, v);
          v = fmaf(a[i].z, b[j].z, v);
          acc[i][j] = fmaf(a[i].w, b[j].w, v);
#else
          acc[i][j] += a[i].x + b[j].w;
#endif
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // the ring free for the next pass
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) epi(tm + 16 * i, n0 + tn + 16 * j, acc[i][j]);
}

template <typename Epi>
__device__ __forceinline__ void product(const Operand& A,
                                        const WeightRows& Wr, int n_tiles,
                                        float* ring, Epi&& epi) {
  for (int t = 0; t < n_tiles; ++t) product_tile(A, Wr, t * kTileN, ring, epi);
}

// mean and 1/std (two-pass f32 statistics over the true C) of the 64 rows
// ``row(r)`` (a pointer, null for a row past the last window: 0 and
// 1/sqrt(eps)); a warp a row at a time
template <typename RowOf>
__device__ __forceinline__ void row_stats(RowOf&& row, int C, float eps,
                                          float* mu, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBlockRows; r += kThreads / 32) {
    const float* x = row(r);
    float s = 0.f;
    if (x != nullptr)
      for (int k = lane; k < C; k += 32) s += x[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const float m = s / C;
    float q = 0.f;
    if (x != nullptr)
      for (int k = lane; k < C; k += 32) {
        const float d = x[k] - m;
        q = fmaf(d, d, q);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      q += __shfl_xor_sync(0xffffffffu, q, off);
    if (lane == 0) {
      mu[r] = m;
      rstd[r] = rsqrtf(q / C + eps);
    }
  }
}

// a peer block's q, k or v plane [64][HDP + 4] (``src``, a generic address
// in its shared memory) into ``dst``, 16 bytes a load
template <int HDP>
__device__ __forceinline__ void pull_plane(float* dst, const float* src) {
  constexpr int kVec = kBlockRows * (HDP + 4) / 4;
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < kVec; i += kThreads) d[i] = s[i];
}

// the block (cluster at N = 256) barrier between a head's planes and their
// readers
template <int N>
__device__ __forceinline__ void plane_sync() {
  if constexpr (N == 256) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <int N, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swin_block_f32_kernel(const ArgsF32 a) {
  using G = Geo<N>;
  using At = Attend<N, HDP>;
  constexpr int R = G::R, P = At::P;
  constexpr int G4 = At::G4, RS = At::RS, RPT = At::RPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LayoutF32 L = make_layout_f32(a.C, HDP, N);
  long long* rows = reinterpret_cast<long long*>(smem_raw + L.rows);
  float* mu = reinterpret_cast<float*>(smem_raw + L.ln);
  float* rstd = mu + kBlockRows;
  float* ring = reinterpret_cast<float*>(smem_raw + L.ring);
  float* act = reinterpret_cast<float*>(smem_raw + L.act);
  float* uni = reinterpret_cast<float*>(smem_raw + L.uni);
  float* qs = uni;
  float* ks = qs + kBlockRows * P;
  float* vs = ks + kBlockRows * P;
  float* ss = vs + kBlockRows * P;
  float* row_max = ss + R * G::kSP;
  float* row_sum = row_max + R;
  float* row_alpha = row_sum + R;
  float* y = uni;
  float* hid = uni + kBlockRows * L.ldc;
  const int tid = threadIdx.x, ldc = L.ldc, C = a.C, hd = a.hd;

  // the block's windows: (image, window) of each of its rows
  const int nww = a.W / G::kWin, nw = (a.H / G::kWin) * nww;
  int first, rank = 0;                    // first flat window; query tile
  if constexpr (N == 256) {
    first = blockIdx.x / kCluster16;
    rank = (int)cg::this_cluster().block_rank();
  } else if constexpr (N == 16) {
    first = blockIdx.x * kGroup4;
  } else {
    first = blockIdx.x;
  }
  for (int r = tid; r < kBlockRows; r += kThreads) {
    const int fw = first + (N == 16 ? r / 16 : 0);
    const int t = N == 16 ? r % 16 : rank * kBlockRows + r;
    long long row = -1;
    if (fw < a.windows) {
      const int b = fw / nw, win = fw % nw;
      row = token_row<N>(b, win / nww, win % nww, t, a.H, a.W, a.shift);
    }
    rows[r] = row;
  }
  // act starts at 0: its columns past C stay 0 (a product's K runs to a
  // multiple of 16), and rows past the last window stay finite
  for (int i = tid; i < kBlockRows * ldc; i += kThreads) act[i] = 0.f;
  __syncthreads();

  row_stats([&](int r) {
    return rows[r] >= 0 ? a.x + rows[r] * a.ldx : nullptr;
  }, C, a.eps, mu, rstd);
  // the planes' head dims past hd are 0 for every head
  if (HDP > hd) {
    const int pad = HDP - hd;
    for (int i = tid; i < 3 * kBlockRows * pad; i += kThreads) {
      const int row = i / pad;
      qs[row * P + hd + (i - row * pad)] = 0.f;
    }
  }
  __syncthreads();

  const Operand ln1{nullptr, 0, a.x, a.ldx, rows, mu, rstd, a.ln1_w,
                    a.ln1_b};
  const int windows_here = N == 16 ? min(kGroup4, a.windows - first) : 1;
  const int dg = tid % G4, r0 = tid / G4;
  const bool pv = tid < RS * G4;
  for (int h = 0; h < a.nh; ++h) {
    // q, k and v of head h for the block's rows, each into its plane
    const WeightRows wq{a.wqkv, a.ld_qkv, 3 * hd, C, hd, C, h * hd};
    product(ln1, wq, (3 * hd + kTileN - 1) / kTileN, ring,
            [&](int r, int o, float v) {
              if (o < 3 * hd) {
                const int part = o / hd, j = o - part * hd;
                qs[part * kBlockRows * P + r * P + j] =
                    v + __ldg(a.bqkv + part * C + h * hd + j);
              }
            });
    plane_sync<N>();
    for (int wdx = 0; wdx < (SWIN_F32_ATTEND ? windows_here : 0); ++wdx) {
      const int base = N == 16 ? wdx * 16 : 0;   // the window's rows
      const int fw = first + (N == 16 ? wdx : 0);
      const int win = fw % nw;
      for (int r = tid; r < R; r += kThreads) {
        row_max[r] = -INFINITY;
        row_sum[r] = 0.f;
      }
      float o[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) o[i][x] = 0.f;
      __syncthreads();
      for (int kt = 0; kt < G::kTiles; ++kt) {
        // the key tile of block kt: a peer's K, then its V, pulled into
        // the stage (the ring, idle between products) in 16-byte loads,
        // each byte once, before the core reads it
        const bool peer = N == 256 && kt != rank;
        if (peer) {
          pull_plane<HDP>(ring, cg::this_cluster().map_shared_rank(ks, kt));
          __syncthreads();
        }
        attend_scores<N, HDP>(qs + base * P, peer ? ring : ks + base * P, ss,
                              row_max, row_sum, row_alpha, a.bias, a.mask, h,
                              win, rank * R, kt * R, a.scale);
        if (peer) {
          pull_plane<HDP>(ring, cg::this_cluster().map_shared_rank(vs, kt));
          __syncthreads();
        }
        attend_pv<N, HDP>(peer ? ring : vs + base * P, ss, row_alpha, o);
      }
      // the head's context into its columns of act
      if (pv) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = r0 + RS * i;
          if (r >= R) continue;
          const float inv = 1.f / row_sum[r];
          float* dst = act + (base + r) * ldc + h * hd;
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (4 * dg + x < hd) dst[4 * dg + x] = o[i][x] * inv;
        }
      }
      __syncthreads();
    }
    plane_sync<N>();                      // no peer reads these planes now
  }

  // y = x + act @ Wproj^T + bproj over the dead planes
  const Operand ctx{act, ldc, nullptr, 0, nullptr, nullptr, nullptr,
                    nullptr, nullptr};
  const WeightRows wp{a.wproj, a.ld_proj, C, C, 0, 0, 0};
  product(ctx, wp, (C + kTileN - 1) / kTileN, ring,
          [&](int r, int n, float v) {
            if (n < C)
              y[r * ldc + n] = rows[r] >= 0
                  ? v + __ldg(a.bproj + n) + a.x[rows[r] * a.ldx + n]
                  : 0.f;
          });
  __syncthreads();

  // act = LN2(y)
  row_stats([&](int r) { return y + r * ldc; }, C, a.eps, mu, rstd);
  __syncthreads();
  for (int i = tid; i < kBlockRows * C; i += kThreads) {
    const int r = i / C, k = i - r * C;
    act[r * ldc + k] = (y[r * ldc + k] - mu[r]) * rstd[r]
                       * __ldg(a.ln2_w + k) + __ldg(a.ln2_b + k);
  }
  __syncthreads();

  // the MLP in chunks of kChunk hidden columns: fc1 + GELU into hid, then
  // fc2 accumulated into y (with fc2's bias in the first chunk)
  const Operand ln2{act, ldc, nullptr, 0, nullptr, nullptr, nullptr,
                    nullptr, nullptr};
  const Operand hmid{hid, kHidPitch, nullptr, 0, nullptr, nullptr, nullptr,
                     nullptr, nullptr};
  for (int f0 = 0; f0 < a.F; f0 += kChunk) {
    const int cw = min(kChunk, a.F - f0);
    const WeightRows w1{a.w1 + (long long)f0 * a.ld1, a.ld1, cw, C, 0, 0, 0};
    product(ln2, w1, (cw + kTileN - 1) / kTileN, ring,
            [&](int r, int n, float v) {
              hid[r * kHidPitch + n] =
                  n < cw ? gelu_erf(v + __ldg(a.b1 + f0 + n)) : 0.f;
            });
    __syncthreads();
    const WeightRows w2{a.w2 + f0, a.ld2, C, cw, 0, 0, 0};
    product(hmid, w2, (C + kTileN - 1) / kTileN, ring,
            [&](int r, int n, float v) {
              if (n < C)
                y[r * ldc + n] += f0 == 0 ? v + __ldg(a.b2 + n) : v;
            });
    __syncthreads();
  }

  // the rows back, through the same map
  for (int i = tid; i < kBlockRows * (C / 4); i += kThreads) {
    const int r = i / (C / 4), k = 4 * (i - r * (C / 4));
    if (rows[r] < 0) continue;
    const float* src = y + r * ldc + k;
    float* dst = a.out + rows[r] * a.ldo + k;
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  }
}

template <int N, int HDP>
int configure_f32(size_t bytes) {
  static size_t configured = 0;           // per template instance
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        swin_block_f32_kernel<N, HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  return 0;
}

template <int N, int HDP>
int launch_f32(const ArgsF32& a, long long smem, cudaStream_t stream) {
  const LayoutF32 L = make_layout_f32(a.C, HDP, N);
  if ((long long)L.bytes != smem || L.bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int rc = configure_f32<N, HDP>(L.bytes);
  if (rc) return rc;
  const long long blocks = N == 256 ? (long long)a.windows * kCluster16
                           : N == 16 ? (a.windows + kGroup4 - 1) / kGroup4
                                     : a.windows;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = N == 256 ? kCluster16 : 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, swin_block_f32_kernel<N, HDP>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The checks and launch of the C entry of window ``kWin`` (N = kWin^2):
// adsr_swin_block16's arguments (swin_block16.cu) on f32 x, out and
// weights. ``stages`` must be the ring's 3 and ``cluster`` 4 at 16x16
// windows, else 1; ``smem`` the plan's bytes.
template <int kWin>
int swin_entry_f32(const void* x, long long ldx, void* out, long long ldo,
                   const void* ln1_w, const void* ln1_b, const void* wqkv,
                   long long ld_qkv, const void* bqkv, const void* bias,
                   const void* mask, const void* wproj, long long ld_proj,
                   const void* bproj, const void* ln2_w, const void* ln2_b,
                   const void* w1, long long ld1, const void* b1,
                   const void* w2, long long ld2, const void* b2, int B,
                   int H, int W, int C, int F, int nh, int win, int shift,
                   int stages, int cluster, float eps, long long smem,
                   void* stream) {
  constexpr int N = kWin * kWin;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(wqkv) | reinterpret_cast<uintptr_t>(wproj) |
      reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2);
  if (win != kWin || H % kWin || W % kWin || B < 0 || C <= 0 || C > kMaxC ||
      C % 4 || F <= 0 || F % 4 || nh <= 0 || C % nh || C / nh > 128 ||
      ldx % 4 || ldo % 4 || ld_qkv % 4 || ld_proj % 4 || ld1 % 4 ||
      ld2 % 4 || ldx < C || ldo < C || ld_qkv < C || ld_proj < C ||
      ld1 < C || ld2 < F || align % 16 || shift < 0 || shift >= kWin ||
      (shift > 0) != (mask != nullptr) || stages != kRingStages ||
      cluster != (kWin == 16 ? kCluster16 : 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  ArgsF32 a;
  a.x = (const float*)x; a.ldx = ldx; a.out = (float*)out; a.ldo = ldo;
  a.ln1_w = (const float*)ln1_w; a.ln1_b = (const float*)ln1_b;
  a.wqkv = (const float*)wqkv; a.ld_qkv = ld_qkv;
  a.bqkv = (const float*)bqkv; a.bias = (const float*)bias; a.mask = mask;
  a.wproj = (const float*)wproj; a.ld_proj = ld_proj;
  a.bproj = (const float*)bproj;
  a.ln2_w = (const float*)ln2_w; a.ln2_b = (const float*)ln2_b;
  a.w1 = (const float*)w1; a.ld1 = ld1; a.b1 = (const float*)b1;
  a.w2 = (const float*)w2; a.ld2 = ld2; a.b2 = (const float*)b2;
  a.B = B; a.H = H; a.W = W; a.C = C; a.F = F; a.nh = nh; a.hd = C / nh;
  a.shift = shift; a.eps = eps;
  a.windows = B * (H / kWin) * (W / kWin);
  a.scale = (float)(1.0 / std::sqrt((double)a.hd));
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((a.hd + 15) / 16) {
#define ADSR_HDP(K) \
    case K: return launch_f32<N, 16 * K>(a, smem, s);
    ADSR_HDP(1) ADSR_HDP(2) ADSR_HDP(3) ADSR_HDP(4)
    ADSR_HDP(5) ADSR_HDP(6) ADSR_HDP(7) ADSR_HDP(8)
#undef ADSR_HDP
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
