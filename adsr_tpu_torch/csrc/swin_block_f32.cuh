// swin_block_f32.cuh: kernel (g) in full f32, one whole Swin Transformer
// block in one launch: LN1 -> qkv -> shifted-window multi-head attention
// (relative-position bias + shift mask, stabilised softmax) -> proj +
// residual -> LN2 -> fc1 + exact-erf GELU -> fc2 + residual, every product
// f32-accurate as 3xTF32 on the tensor cores (mma.sync m16n8k8,
// tf32_mma.cuh): each f32 value split as its fragment loads into hi = x
// with its low 13 bits cleared and lo = x - hi (exact; the tensor cores
// read its top 19 bits), a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32.
//
// Replaces: the Pallas kernel fused_swin_block
// (adsr_tpu/ops/fused_swin_block.py:297, body _kernel :215, pallas_call
// :337) at dtype f32, where the TPU kernel's matmul dtype is its input's
// (:221) and its scratches take x.dtype (:345-350): the per-block program
// of the JAX "block" serving mode in fp32 (ADSR_TPU_RDG=0,
// adsr_tpu/ops/fused_drct.py:168-189).
// Bound on H100: operations. A flagship block does ~1.2k flop per byte of
// its activations (the weights are read from L2 by every window): as three
// TF32 products at 495 TFLOP/s, ~0.5 ms an RDG at 8x8 windows.
// Design: a block of eight warps holds 64 token rows of one window (8x8
// windows: a block a window), of four consecutive windows over the flat
// (image, window) index (4x4: the last group possibly short), or one
// 64-row query tile of a 16x16 window (a cluster of four blocks a window,
// the peers' K and V planes pulled whole through distributed shared
// memory). Shared memory holds the context ``act`` [64][ldc] (later the
// MLP's hidden chunk), a union of the attention's q, k, v planes
// [3][64][hdp + 4] and ``y`` [64][ldc] (LN2 of the stream), and a ring of
// three 32-deep K steps (a W tile [128][40], or an A tile and a W tile
// [64][40] each).
//   - Products: warp (wr, wc) owns rows 16 wr .. 16 wr + 15 and half of a
//     pass's output columns (TN = 64 or 128 a pass: 4 or 8 n8 tiles); a
//     product's passes are one stream of 32-deep K steps through the
//     cp.async ring (the next pass's steps land while a pass ends), one
//     barrier a step; fragments load in the paired k order, 8 bytes a
//     load, free of bank conflicts. The sums run in two levels: every 128
//     of K the accumulators are added into an f32 total (fc2's 128-wide
//     chunks into the output rows), all in a fixed order: bitwise
//     repeatable, no atomics, graph-capturable.
//   - LN1 on load: each qkv pass stages the block's raw input rows through
//     the ring by cp.async and normalises them as its fragments load, with
//     the rows' mean and 1/std computed once (two-pass f32 statistics).
//   - Per head: qkv writes the head's q, k and v planes (head dim
//     zero-padded to a multiple of 16: 30/53/122/46/77 at the flagship),
//     then FlashAttention-2 on the same fragments: each warp its 16 query
//     rows and half of every key tile (32 keys; 8 at 4x4 windows), S in
//     registers, the online softmax in f32, P V with S's accumulator tiles
//     as A in the paired order; the two halves' (max, sum, context) merge
//     through the dead q plane into the head's columns of ``act``.
//   - proj + residual into the output rows and ``y``, LN2 of ``y`` in
//     place, then the MLP in 128-wide hidden chunks: fc1 + GELU (one pass
//     a chunk) into the act region, fc2 of each chunk added into the
//     output rows (which hold the stream after proj; they may be x's).
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

#include "tf32_mma.cuh"               // split, mma.sync, fragments
#include "window_attention_f32.cuh"   // Geo, kPitch, token_row, attn_term

// Ablations for scripts/torch_swin_block_f32_sweep.py (timing only: the
// results are then not the block's): SWIN_F32_ATTEND 0 leaves out the
// attention (the context stays 0), SWIN_F32_MMA 0 the products' mma (the
// loads, splits, barriers and epilogues stay), SWIN_F32_LN_LOAD 0 the
// normalisation of qkv's A fragments, SWIN_F32_STAGE 0 the products'
// cp.async staging (the ring's tiles are whatever it holds); the shared
// ATTN16_F32_X3 0 runs one TF32 product of three.
#ifndef SWIN_F32_ATTEND
#define SWIN_F32_ATTEND 1
#endif
#ifndef SWIN_F32_MMA
#define SWIN_F32_MMA 1
#endif
#ifndef SWIN_F32_LN_LOAD
#define SWIN_F32_LN_LOAD 1
#endif
#ifndef SWIN_F32_STAGE
#define SWIN_F32_STAGE 1
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kBlockRows = 64;         // token rows a block holds
constexpr int kStepK = 32;             // K a ring stage
constexpr int kRingPitch = kStepK + 8; // floats a staged row: 8 banks apart
constexpr int kStageRows = 128;        // W [128], or A [64] + W [64]
constexpr int kRingStages = 3;
constexpr int kFlushSteps = 128 / kStepK;  // K steps a partial sum
constexpr int kChunk = 128;            // hidden columns of an MLP chunk
constexpr int kHidPitch = kChunk + 8;
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
// rows' token offsets (``rows``, int64, -1 past the last window), the LN
// per-row mean and 1/std (``ln``), the second key half's row max and sum
// (``mrg``, the attention's merge), the context ``act`` [64][ldc] (the MLP's
// hidden chunk [64][136] later: the larger of the two), a union of the
// attention's q, k, v planes [3][64][hdp + 4] and the stream ``y``
// [64][ldc], and the product ring (``ring``: three stages of [128][40]),
// which at N = 256 also holds, between products, the peer K or V plane
// being read ([64][hdp + 4]).
// kernels/fused_swin_block.py ``swin_block_f32_plan`` mirrors it.
struct LayoutF32 {
  int kp, ldc;                // K padded to a ring step; floats a row of act
  size_t rows, ln, mrg, act, uni, ring, bytes;   // offsets, and the total
};

__host__ __device__ inline LayoutF32 make_layout_f32(int C, int hdp, int N) {
  LayoutF32 L;
  L.kp = (C + kStepK - 1) / kStepK * kStepK;
  L.ldc = L.kp + 8;           // a half-warp's 8-byte pairs in 32 banks
  // act holds the context [64][ldc], then the hidden chunk [64][136]
  const size_t act_b = 4ull * kBlockRows
                       * (L.ldc > kHidPitch ? L.ldc : kHidPitch);
  const size_t y_b = 4ull * kBlockRows * L.ldc;
  const size_t planes = 4ull * 3 * kBlockRows * (hdp + 4);
  const size_t ring_b = 4ull * kRingStages * kStageRows * kRingPitch;
  const size_t stage_b = N == 256 ? 4ull * kBlockRows * (hdp + 4) : 0;
  L.rows = 0;
  L.ln = L.rows + 8ull * kBlockRows;
  L.mrg = L.ln + 2ull * 4 * kBlockRows;
  L.act = L.mrg + 2ull * 4 * kBlockRows;
  L.uni = L.act + act_b;
  L.ring = L.uni + (planes > y_b ? planes : y_b);
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
// ``lda``), or, with ``x`` set, rows of ``x`` (token offsets ``rows``)
// staged raw through the ring and layer-normed as the fragments load
// (mean ``mu``, 1/std ``rstd``, scale ``g``, shift ``b``).
struct Operand {
  const float* a;
  int lda;
  const float* x;             // the rows' source; null: a
  long long ldx;
  const long long* rows;
  const float *mu, *rstd, *g, *b;
};

// x -> (hi, lo) of a product's operand (tf32_mma.cuh split_tf32_trunc)
__device__ __forceinline__ void split2(float2 v, uint32_t& h0, uint32_t& l0,
                                       uint32_t& h1, uint32_t& l1) {
  split_as<true>(v.x, h0, l0);
  split_as<true>(v.y, h1, l1);
}

// A @ W^T over all of W's rows in passes of TN output columns, every pass's
// K steps one continuous stream through the ring (the next pass's first
// steps land while a pass ends). Warp (wr, wc) owns rows r0 = 16 wr .. and
// columns TN / 2 wc .. of a pass: NT = TN / 16 n8 tiles. Fragments load in
// the paired k order (a0 a2 and b0 b1 from columns k + 2t, k + 2t + 1: one
// 8-byte load each; ring and A pitches put a half-warp's pairs in 32
// banks). Each pass's sums (rows r0 + g (+ 8), columns n0 + TN / 2 wc + 8
// j + 2 t (+ 1)) go to ``epi(r, n, v)``, past the product's N too (the
// epilogue decides). With ``A.x`` set TN is 64 (a stage holds the A and
// the W tile). Every thread of the block takes part; the ring is free
// again on return.
template <int TN, typename Epi>
__device__ __forceinline__ void product(const Operand& A,
                                        const WeightRows& Wr, float* ring,
                                        Epi&& epi) {
  constexpr int NT = TN / 16;                 // a warp's n8 tiles
  constexpr int kStage = kStageRows * kRingPitch;
  constexpr int kPieces = kStepK / 4;         // 16-byte pieces a row a step
  constexpr int kRowsPer = kThreads / kPieces;  // rows staged a round (32)
  constexpr int kWRows = TN / kRowsPer;       // W rows a thread stages
  constexpr int kARows = kBlockRows / kRowsPer;
  const bool ln = A.x != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = (TN / 2) * (warp >> 2);
  const int steps = (Wr.k + kStepK - 1) / kStepK;
  const int total = (Wr.n + TN - 1) / TN * steps;
  const int w_off = ln ? kBlockRows * kRingPitch : 0;   // W within a stage
  const int pr = tid / kPieces, pc = 4 * (tid % kPieces);  // staging map

  // the rows this thread stages: x's (fixed) and W's (a pass's)
  const float* arow[kARows];
#pragma unroll
  for (int q = 0; q < kARows; ++q) {
    const long long xr = ln ? A.rows[pr + kRowsPer * q] : -1;
    arow[q] = xr >= 0 ? A.x + xr * A.ldx : nullptr;
  }
  const float* wrow[kWRows];
  int staged_pass = -1;
  auto stage = [&](int slot, int gs) {
    const int pass = gs / steps, k = (gs - pass * steps) * kStepK + pc;
    if (pass != staged_pass) {
      staged_pass = pass;
#pragma unroll
      for (int q = 0; q < kWRows; ++q) {
        const int o = pass * TN + pr + kRowsPer * q;
        wrow[q] = o < Wr.n ? Wr.row(o) : nullptr;
      }
    }
    float* base = ring + slot * kStage;
    const bool kin = k < Wr.k;
    if (!SWIN_F32_STAGE) return;
#pragma unroll
    for (int q = 0; q < kWRows; ++q) {
      const bool in = kin && wrow[q] != nullptr;
      cp_async16((uint32_t)__cvta_generic_to_shared(
                     base + w_off + (pr + kRowsPer * q) * kRingPitch + pc),
                 in ? wrow[q] + k : Wr.w, in ? 16 : 0);
    }
    if (ln) {
#pragma unroll
      for (int q = 0; q < kARows; ++q) {
        const bool in = kin && arow[q] != nullptr;
        cp_async16((uint32_t)__cvta_generic_to_shared(
                       base + (pr + kRowsPer * q) * kRingPitch + pc),
                   in ? arow[q] + k : A.x, in ? 16 : 0);
      }
    }
  };

  // LN on load: the mean and 1/std of the warp's rows r0 + g, r0 + g + 8
  float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  if (ln) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mu[x] = A.mu[r0 + g + 8 * x];
      rs[x] = A.rstd[r0 + g + 8 * x];
    }
  }

  float acc[NT][4], tot[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = tot[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) {
    if (s < total) stage(s, s);
    cp_async_commit();                    // one group a step, empty or not
  }
  for (int gs = 0; gs < total; ++gs) {
    const int pass = gs / steps, step = gs - pass * steps;
    const float* sa = ring + (gs % kRingStages) * kStage;
    cp_async_wait<kRingStages - 2>();     // this thread's pieces landed
    __syncthreads();                      // the step's tiles for all, and
    const int next = gs + kRingStages - 1;  // the last step's reads done
    if (next < total) stage(next % kRingStages, next);
    cp_async_commit();
    const float* tw = sa + w_off;
#pragma unroll
    for (int kk = 0; kk < kStepK; kk += 8) {
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
      float2 a0, a1;
      if (ln) {
        a0 = *reinterpret_cast<const float2*>(sa + (r0 + g) * kRingPitch
                                              + kk + 2 * t);
        a1 = *reinterpret_cast<const float2*>(sa + (r0 + g + 8) * kRingPitch
                                              + kk + 2 * t);
        const int k = step * kStepK + kk + 2 * t;
        if (SWIN_F32_LN_LOAD && k < Wr.k) {
          const float g0 = __ldg(A.g + k), g1 = __ldg(A.g + k + 1);
          const float b0 = __ldg(A.b + k), b1 = __ldg(A.b + k + 1);
          a0.x = (a0.x - mu[0]) * rs[0] * g0 + b0;
          a0.y = (a0.y - mu[0]) * rs[0] * g1 + b1;
          a1.x = (a1.x - mu[1]) * rs[1] * g0 + b0;
          a1.y = (a1.y - mu[1]) * rs[1] * g1 + b1;
        }
      } else {
        const float* xa = A.a + (r0 + g) * A.lda + step * kStepK + kk
                          + 2 * t;
        a0 = *reinterpret_cast<const float2*>(xa);
        a1 = *reinterpret_cast<const float2*>(xa + 8 * A.lda);
      }
      split2(a0, ah[0], al[0], ah[2], al[2]);
      split2(a1, ah[1], al[1], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        split2(*reinterpret_cast<const float2*>(
                   tw + (c0 + 8 * j + g) * kRingPitch + kk + 2 * t),
               bh[j][0], bl[j][0], bh[j][1], bl[j][1]);
#if SWIN_F32_MMA
#if ATTN16_F32_X3
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bl[j]);
#endif
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bh[j]);
#else
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[j][0] += __uint_as_float(ah[0] ^ al[3] ^ bh[j][0] ^ bl[j][1]);
#endif
    }
    if ((step + 1) % kFlushSteps == 0 || step + 1 == steps) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[j][e] += acc[j][e];
          acc[j][e] = 0.f;
        }
    }
    if (step + 1 == steps) {              // the pass's sums out
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          epi(r0 + g + 8 * (e >> 1),
              pass * TN + c0 + 8 * j + 2 * t + (e & 1), tot[j][e]);
          tot[j][e] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // the ring free for what follows
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

// a peer block's k or v plane [64][HDP + 4] (``src``, a generic address in
// its shared memory) into ``dst``, 16 bytes a load
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One head's attention over the block's rows, FlashAttention-2 on the
// planes: warp (wr, wc) takes query rows r0 = 16 wr .. (at N = 16 window
// wr of the block) and keys (R / 2) wc .. of every key tile of R (R =
// min(N, 64)): S on m16n8k8, scaled, plus the bias (and mask), the online
// softmax in f32, O += P V with P from S's accumulators (paired order).
// Then wc = 1 hands its (max, sum, O) to wc = 0 through the q plane and
// ``mrg``, and wc = 0 writes the merged context of its rows (where its
// window exists) into columns h hd .. of ``act``. At N = 256 each peer's K
// and then V plane is pulled into the ring before it is read.
template <int N, int HDP>
__device__ __forceinline__ void attend_head(float* qs, const float* ks,
                                            const float* vs, float* ring,
                                            float* act, int ldc, float* mrg,
                                            const ArgsF32& a, int h, int win,
                                            int rank, bool valid) {
  constexpr int R = Geo<N>::R, KN = R / 16, KT = HDP / 8, P = kPitch<HDP>;
  constexpr int kTiles = Geo<N>::kTiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp & 3, wc = warp >> 2;
  const int r0 = 16 * wr;
  const int wb = N == 16 ? r0 : 0;        // the window's first plane row
  const int kh = (R / 2) * wc;            // the warp's keys in a tile
  const int qb = N == 16 ? 0 : (N == 64 ? r0 : kBlockRows * rank + r0);

  float o[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < kTiles; ++kt) {
    const bool peer = N == 256 && kt != rank;
    const float* kp = ks;
    if (peer) {
      __syncthreads();                    // the ring's last readers done
      pull_plane<HDP>(ring, cg::this_cluster().map_shared_rank(ks, kt));
      __syncthreads();
      kp = ring;
    }
    float s[KN][4];
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ah[4], al[4], bh[KN][2], bl[KN][2];
      frag_a<P, true>(qs, r0, 8 * kk, ah, al);
#pragma unroll
      for (int j = 0; j < KN; ++j)
        frag_b_rows<P, true>(kp, wb + kh + 8 * j, 8 * kk, bh[j], bl[j]);
#if ATTN16_F32_X3
#pragma unroll
      for (int j = 0; j < KN; ++j) mma_tf32(s[j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < KN; ++j) mma_tf32(s[j], ah, bl[j]);
#endif
#pragma unroll
      for (int j = 0; j < KN; ++j) mma_tf32(s[j], ah, bh[j]);
    }
    // scale, bias (+ mask), the online softmax of each row over the tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qb + g + 8 * (e >> 1);
        const int kj = kt * R + kh + 8 * j + 2 * t + (e & 1);
        s[j][e] = s[j][e] * a.scale
                  + attn_term<N>(a.bias, a.mask, h, win, qi, kj);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float m_new = fmaxf(m_run[x], quad_max(mx[x]));
      alpha[x] = expf(m_run[x] - m_new);  // 0 on the first tile
      m_run[x] = m_new;
      l_run[x] *= alpha[x];
    }
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    const float* vp = vs;
    if (peer) {
      __syncthreads();                    // every warp done with K
      pull_plane<HDP>(ring, cg::this_cluster().map_shared_rank(vs, kt));
      __syncthreads();
      vp = ring;
    }
    // O += P V over the warp's keys of the tile, four n8 head-dim tiles a
    // round
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      uint32_t ah[4], al[4];
      frag_a_of_c<true>(s[j][0], s[j][1], s[j][2], s[j][3], ah, al);
#pragma unroll
      for (int n0 = 0; n0 < KT; n0 += 4) {
        uint32_t bh[4][2], bl[4][2];      // (KT is even: n0 + 1 < KT)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n0 + n < KT)
            frag_b_cols<P, true>(vp, wb + kh + 8 * j, 8 * (n0 + n), bh[n],
                                 bl[n]);
#if ATTN16_F32_X3
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n0 + n < KT) mma_tf32(o[n0 + n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n0 + n < KT) mma_tf32(o[n0 + n], ah, bl[n]);
#endif
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n0 + n < KT) mma_tf32(o[n0 + n], ah, bh[n]);
      }
    }
  }

  // the two key halves merged: wc = 1's sum over its quad, max and O
  // through ``mrg`` and the q plane (every warp is done with q) to wc = 0
#pragma unroll
  for (int x = 0; x < 2; ++x) l_run[x] = quad_sum(l_run[x]);
  __syncthreads();
  if (wc == 1) {
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qs[(r0 + g + 8 * (e >> 1)) * P + 8 * n + 2 * t + (e & 1)] = o[n][e];
    if (t == 0) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        mrg[r0 + g + 8 * x] = m_run[x];
        mrg[kBlockRows + r0 + g + 8 * x] = l_run[x];
      }
    }
  }
  __syncthreads();
  if (wc == 0 && valid) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r0 + g + 8 * x;
      const float m1 = mrg[r], l1 = mrg[kBlockRows + r];
      const float m = fmaxf(m_run[x], m1);
      const float a0 = expf(m_run[x] - m), a1 = expf(m1 - m);
      const float inv = 1.f / (l_run[x] * a0 + l1 * a1);
      float* dst = act + r * ldc + h * a.hd;
#pragma unroll
      for (int n = 0; n < KT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = 8 * n + 2 * t + c;
          if (d < a.hd)
            dst[d] = (o[n][2 * x + c] * a0 + qs[r * P + d] * a1) * inv;
        }
    }
  }
}

template <int N, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swin_block_f32_kernel(const ArgsF32 a) {
  using G = Geo<N>;
  constexpr int P = kPitch<HDP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LayoutF32 L = make_layout_f32(a.C, HDP, N);
  long long* rows = reinterpret_cast<long long*>(smem_raw + L.rows);
  float* mu = reinterpret_cast<float*>(smem_raw + L.ln);
  float* rstd = mu + kBlockRows;
  float* mrg = reinterpret_cast<float*>(smem_raw + L.mrg);
  float* ring = reinterpret_cast<float*>(smem_raw + L.ring);
  float* act = reinterpret_cast<float*>(smem_raw + L.act);
  float* uni = reinterpret_cast<float*>(smem_raw + L.uni);
  float* qs = uni;
  float* ks = qs + kBlockRows * P;
  float* vs = ks + kBlockRows * P;
  float* y = uni;
  float* hid = act;
  const int tid = threadIdx.x, ldc = L.ldc, kp = L.kp, C = a.C, hd = a.hd;

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
  // multiple of 32), and rows past the last window stay finite
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
  const int wr = (tid >> 5) & 3;
  const bool valid = N != 16 || wr < windows_here;
  const int win = (first + (N == 16 && valid ? wr : 0)) % nw;
  for (int h = 0; h < a.nh; ++h) {
    // q, k and v of head h for the block's rows, each into its plane
    const WeightRows wq{a.wqkv, a.ld_qkv, 3 * hd, C, hd, C, h * hd};
    product<64>(ln1, wq, ring, [&](int r, int o, float v) {
      if (o < 3 * hd) {
        const int part = o / hd, j = o - part * hd;
        qs[part * kBlockRows * P + r * P + j] =
            v + __ldg(a.bqkv + part * C + h * hd + j);
      }
    });
    plane_sync<N>();
    if (SWIN_F32_ATTEND)
      attend_head<N, HDP>(qs, ks, vs, ring, act, ldc, mrg, a, h, win, rank,
                          valid);
    plane_sync<N>();                      // no peer reads these planes now
  }

  // y = x + act @ Wproj^T + bproj over the dead planes, also into the
  // output rows (fc2 adds into them); 0 past C
  const Operand ctx{act, ldc, nullptr, 0, nullptr, nullptr, nullptr,
                    nullptr, nullptr};
  const WeightRows wp{a.wproj, a.ld_proj, C, C, 0, 0, 0};
  product<128>(ctx, wp, ring, [&](int r, int n, float v) {
    if (n < kp) {
      float s = 0.f;
      if (n < C && rows[r] >= 0) {
        s = v + __ldg(a.bproj + n) + a.x[rows[r] * a.ldx + n];
        a.out[rows[r] * a.ldo + n] = s;
      }
      y[r * ldc + n] = s;
    }
  });
  __syncthreads();
  // y = LN2(y) in place (columns past C stay 0)
  row_stats([&](int r) { return y + r * ldc; }, C, a.eps, mu, rstd);
  __syncthreads();
  for (int i = tid; i < kBlockRows * C; i += kThreads) {
    const int r = i / C, k = i - r * C;
    y[r * ldc + k] = (y[r * ldc + k] - mu[r]) * rstd[r] * __ldg(a.ln2_w + k)
                     + __ldg(a.ln2_b + k);
  }
  __syncthreads();

  // the MLP in chunks of kChunk hidden columns: fc1 + GELU into hid, then
  // fc2 added into the output rows (with fc2's bias in the first chunk)
  const Operand ln2{y, ldc, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                    nullptr};
  const Operand hmid{hid, kHidPitch, nullptr, 0, nullptr, nullptr, nullptr,
                     nullptr, nullptr};
  for (int f0 = 0; f0 < a.F; f0 += kChunk) {
    const int cw = min(kChunk, a.F - f0);
    const WeightRows w1{a.w1 + (long long)f0 * a.ld1, a.ld1, cw, C, 0, 0, 0};
    product<128>(ln2, w1, ring, [&](int r, int n, float v) {
      hid[r * kHidPitch + n] = n < cw ? gelu_erf(v + __ldg(a.b1 + f0 + n))
                                      : 0.f;
    });
    const WeightRows w2{a.w2 + f0, a.ld2, C, cw, 0, 0, 0};
    product<128>(hmid, w2, ring, [&](int r, int n, float v) {
      if (n < C && rows[r] >= 0)
        a.out[rows[r] * a.ldo + n] += f0 == 0 ? v + __ldg(a.b2 + n) : v;
    });
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
