// window_attention_bwd_f32.cuh: the backward of the shifted-window
// multi-head self-attention in full f32 (fp32 training) over 4x4, 8x8 and
// 16x16 windows (N = 16, 64 and 256 tokens).
//
//   S = scale q k^T + bias (+ mask),  P = softmax(S),  D = rowsum(dO o O)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q,  d(bias) = sum over windows of dS
//
// Replaces: the attention backward phases of the Pallas kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770, called from _rdg_train_bwd
// :968) at dtype f32, where the TPU kernel stages in f32 with f32
// accumulators (fused_rdg_train.py:442, 961-967). The bf16 instances are
// window_attention_bwd{4,,16}.cu.
// Bound on H100: bytes at N = 16 and 64 (qkv, dO and dqkv once; the
// products of 64 x 64 a head are cheap), operations at N = 256 (seven
// 256 x 256 x hd products a head: 208 GFLOP an RDG at 256px/x4, 3.11 ms at
// the 67 TFLOP/s of f32 FFMA, 1.26 ms as three TF32 products each at 495
// TFLOP/s).
// Design: operand planes in shared memory as the forward's
// (window_attention_f32.cuh, whose staging, row map and bias / mask lookups
// this file reuses): a head's rows of q, k, v and dO staged from the
// 16-byte pieces that hold its columns (head dims 30, 53, 122, 46 and 77 at
// the flagship start on any 4-byte column) and sliced out in registers into
// planes [R][hdp + 4], zero-padded.
// - N = 16 and 64 (R = N, the whole window in one tile; hdp a multiple of
//   16): one launch, every product in f32 FFMA on the CUDA cores, a block
//   per (group of ``group`` consecutive windows, head): for each window it
//   recomputes the stabilised softmax from q, k, the bias and the mask, D =
//   rowsum(P o dP), dS, then dQ, dK and dV, written into the head's columns
//   of the raster-order dqkv; dS is summed over the group's windows in
//   registers into one d(bias) partial [N][N] a (group, head). Scores and
//   dP tiles are a 16 x 16 grid of threads, a row's sums half-warp
//   shuffles; the three output products take a thread's rows and four head
//   dims, reading P and dS from shared tiles [R][R + 4].
// - N = 256 (R = 64; hdp a multiple of 8): FlashAttention-2's
//   deterministic backward in two launches, as the bf16 kernels
//   (window_attention_bwd16.cu), every product f32-accurate as 3xTF32 on
//   the tensor cores (mma.sync, below): P from the forward's softmax
//   statistics (kernel (c) writes (max, 1 / sum) a query row) and D =
//   rowsum(dO o O) from the forward's context. ``dq``: a block per (window,
//   head, query tile) computes D of its rows (written to ``dsum`` for the
//   second launch), sweeps the four key tiles and writes dQ. ``dkv``: a
//   block per (group of windows, head, key tile) walks its group's windows
//   and each window's four query tiles, accumulates dK and dV of its keys
//   in registers and the [256][64] d(bias) columns of its keys in shared
//   memory over the group, and writes one partial a (group, head). The bias
//   comes from the relative-position table and the mask from the region
//   labels, so a 16x16 window's f32 bias (256 KB) is never staged.
// partials.cuh's sum_partials adds the d(bias) partials in a fixed order:
// no atomics, bitwise repeatable; nothing survives a launch.
//
// One source a window includes this file (window_attention_bwd4_f32.cu,
// window_attention_bwd_f32.cu, window_attention_bwd16_f32.cu, and at N =
// 256 head tiles past 64 window_attention_bwd16_f32_wide.cu), so nvcc
// builds the windows' instances in parallel.

#pragma once

#include "partials.cuh"
#include "tf32_mma.cuh"            // 3xTF32 mma.sync, fragments, cp.async
#include "window_attention_f32.cuh"

#ifndef ADSR_BWD16_WIDE
#define ADSR_BWD16_WIDE 0         // 1: the N = 256 head tiles past 64
#endif

namespace {

constexpr int kMaxPartialBlocks = 1 << 20;

// the thread layouts of a 256-thread block for R rows and a head tile HDP
template <int N, int HDP>
struct BwdGeo {
  static constexpr int R = Geo<N>::R;
  static constexpr int SR = R / 16;       // scores a thread a dim
  static constexpr int SP = Geo<N>::kSP;  // floats a row of a P / dS tile
  static constexpr int P = kPitch<HDP>;   // floats a row of a plane
  static constexpr int G4 = HDP / 4;      // head-dim quads
  static constexpr int RS = kThreads / G4;  // product rows a pass
  static constexpr int RPT = (R + RS - 1) / RS;
  static constexpr size_t kPlanes = 4ull * R * P;   // q, k, v, dO
  static constexpr size_t kTile = (size_t)R * SP;
};

// shared memory of the N = 16 and 64 kernel, in bytes
// (kernels/window_attention_bwd.py ``window_attention_bwd_f32_plan``): the
// four planes, then the P and dS tiles
template <int N, int HDP>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  using G = BwdGeo<N, HDP>;
  return 4 * (G::kPlanes + 2 * G::kTile);
}

// zero the padded head dims of the four planes (the staged rows write head
// dims below hd only, so they stay zero)
template <int N, int HDP>
__device__ __forceinline__ void zero_pads(float* planes, int hd) {
  using G = BwdGeo<N, HDP>;
  if (HDP > hd) {
    const int pad = HDP - hd;
    for (int i = threadIdx.x; i < 4 * G::R * pad; i += kThreads) {
      const int row = i / pad;
      planes[row * G::P + hd + (i - row * pad)] = 0.f;
    }
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over the head dims
template <int N, int HDP>
__device__ __forceinline__ void dot_tile(
    const float* a, const float* b, int ty, int tx,
    float (&s)[BwdGeo<N, HDP>::SR][BwdGeo<N, HDP>::SR]) {
  using G = BwdGeo<N, HDP>;
  constexpr int SR = G::SR;
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SR; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; d += 4) {
    float4 a4[SR], b4[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i)
      a4[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * G::P + d);
#pragma unroll
    for (int j = 0; j < SR; ++j)
      b4[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * G::P + d);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        float v = s[i][j];
        v = fmaf(a4[i].x, b4[j].x, v);
        v = fmaf(a4[i].y, b4[j].y, v);
        v = fmaf(a4[i].z, b4[j].z, v);
        s[i][j] = fmaf(a4[i].w, b4[j].w, v);
      }
    }
  }
}

// the sum and the max over the 16 lanes of a half-warp (one score row)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[i] += sum over k < R of T(row r_i, k) X[k] (kT false: T[r][k], as
// dQ = dS K; kT true: T[k][r], as dK = dS^T Q and dV = P^T dO), the thread's
// rows r_i = r0 + RS i and head dims 4 dg .. 4 dg + 3
template <int N, int HDP, bool kT>
__device__ __forceinline__ void tile_product(
    const float* T, const float* X, int r0, int dg,
    float (&acc)[BwdGeo<N, HDP>::RPT][4]) {
  using G = BwdGeo<N, HDP>;
#pragma unroll 4
  for (int k = 0; k < G::R; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(X + k * G::P + 4 * dg);
#pragma unroll
    for (int i = 0; i < G::RPT; ++i) {
      const int r = r0 + G::RS * i;
      if (r < G::R) {
        const float t = kT ? T[k * G::SP + r] : T[r * G::SP + k];
        acc[i][0] = fmaf(t, x.x, acc[i][0]);
        acc[i][1] = fmaf(t, x.y, acc[i][1]);
        acc[i][2] = fmaf(t, x.z, acc[i][2]);
        acc[i][3] = fmaf(t, x.w, acc[i][3]);
      }
    }
  }
}

template <int N, int HDP>
__device__ __forceinline__ void zero_acc(float (&acc)[BwdGeo<N, HDP>::RPT][4]) {
#pragma unroll
  for (int i = 0; i < BwdGeo<N, HDP>::RPT; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[i][x] = 0.f;
}

// mul * acc into the head's columns ``col`` of dqkv at the window's tokens
// t0 + r_i
template <int N, int HDP>
__device__ __forceinline__ void store_rows(
    const float (&acc)[BwdGeo<N, HDP>::RPT][4], float mul,
    float* __restrict__ dqkv, long long ldd, int b, int wi, int wj, int t0,
    int H, int W, int shift, int col, int hd, int r0, int dg) {
  using G = BwdGeo<N, HDP>;
#pragma unroll
  for (int i = 0; i < G::RPT; ++i) {
    const int r = r0 + G::RS * i;
    if (r >= G::R) continue;
    float* dst = dqkv + token_row<N>(b, wi, wj, t0 + r, H, W, shift) * ldd
                 + col;
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (4 * dg + x < hd) dst[4 * dg + x] = acc[i][x] * mul;
  }
}

// ---- N = 16 and 64: one launch, a block per (group of windows, head) -------

template <int N, int HDP>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_f32_kernel(const float* __restrict__ qkv, long long ldq,
                    const float* __restrict__ dout, long long ldg,
                    const float* __restrict__ bias,
                    const void* __restrict__ mask, float* __restrict__ dqkv,
                    long long ldd, float* __restrict__ part, int H, int W,
                    int C, int nh, int hd, int shift, int group, int windows,
                    float scale) {
  using G = BwdGeo<N, HDP>;
  constexpr int R = G::R, SR = G::SR, SP = G::SP, P = G::P;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + R * P;
  float* vs = ks + R * P;
  float* dos = vs + R * P;
  float* ps = dos + R * P;
  float* dss = ps + R * SP;

  const int h = blockIdx.x % nh, grp = blockIdx.x / nh;
  const int nww = W / Geo<N>::kWin;
  const int nw = (H / Geo<N>::kWin) * nww;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int dg = tid % G::G4, r0 = tid / G::G4;
  const bool pv = tid < G::RS * G::G4;
  const int col = h * hd;
  zero_pads<N, HDP>(smem, hd);

  float db[SR][SR];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SR; ++j) db[i][j] = 0.f;

  const int w_end = min(windows, (grp + 1) * group);
  for (int gw = grp * group; gw < w_end; ++gw) {
    const int b = gw / nw, win = gw % nw;
    const int wi = win / nww, wj = win % nww;
    stage_rows<N, HDP>(qs, qkv, ldq, b, wi, wj, 0, H, W, shift, col, hd);
    stage_rows<N, HDP>(ks, qkv, ldq, b, wi, wj, 0, H, W, shift, C + col, hd);
    stage_rows<N, HDP>(vs, qkv, ldq, b, wi, wj, 0, H, W, shift, 2 * C + col,
                       hd);
    stage_rows<N, HDP>(dos, dout, ldg, b, wi, wj, 0, H, W, shift, col, hd);
    __syncthreads();

    float s[SR][SR], dp[SR][SR];
    dot_tile<N, HDP>(qs, ks, ty, tx, s);
    dot_tile<N, HDP>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        s[i][j] = s[i][j] * scale
                  + attn_term<N>(bias, mask, h, win, r, tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
      const float inv = 1.f / row_sum16(sum);
      float dsum = 0.f;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        s[i][j] *= inv;                   // P
        dsum += s[i][j] * dp[i][j];
      }
      const float d = row_sum16(dsum);    // D = rowsum(P o dP)
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        const float ds = s[i][j] * (dp[i][j] - d);
        db[i][j] += ds;
        ps[r * SP + tx + 16 * j] = s[i][j];
        dss[r * SP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    if (pv) {
      float acc[G::RPT][4];
      zero_acc<N, HDP>(acc);
      tile_product<N, HDP, false>(dss, ks, r0, dg, acc);      // dQ
      store_rows<N, HDP>(acc, scale, dqkv, ldd, b, wi, wj, 0, H, W, shift,
                         col, hd, r0, dg);
      zero_acc<N, HDP>(acc);
      tile_product<N, HDP, true>(dss, qs, r0, dg, acc);       // dK
      store_rows<N, HDP>(acc, scale, dqkv, ldd, b, wi, wj, 0, H, W, shift,
                         C + col, hd, r0, dg);
      zero_acc<N, HDP>(acc);
      tile_product<N, HDP, true>(ps, dos, r0, dg, acc);       // dV
      store_rows<N, HDP>(acc, 1.f, dqkv, ldd, b, wi, wj, 0, H, W, shift,
                         2 * C + col, hd, r0, dg);
    }
    __syncthreads();                      // before the next window's rows
  }
  float* out = part + (size_t)blockIdx.x * N * N;   // (group, head)
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SR; ++j)
      out[(ty + 16 * i) * N + tx + 16 * j] = db[i][j];
}

// ---- N = 256 on the tensor cores: 3xTF32 mma.sync --------------------------
//
// Every product is m16n8k8 TF32 mma.sync a warp, each operand split as x =
// hi + lo (hi = tf32(x), lo = tf32(x - hi), to nearest) and the f32
// accumulators summing a_lo b_hi + a_hi b_lo + a_hi b_hi (mma3). Operands
// are split as their fragments are loaded from the f32 planes (pitch HDP +
// 4, HDP the head dim rounded up to 8: the fragments' row and paired-row
// reads are free of bank conflicts). A product's accumulator tile becomes
// the A operand of the next product over its columns without leaving the
// registers: its lane holds columns 2t and 2t + 1, so the reduction takes
// its keys (or queries) in the paired order (a0, a1, a2, a3) = (c0, c2, c1,
// c3) and the B operand reads rows k0 + 2t and k0 + 2t + 1 (frag_b_cols).
// Eight warps a block: warp (wr, wc) takes rows 16 wr .. of the block's
// 64 and columns 32 wc .. of each 64-wide tile of the other side; the two
// warps of a row trade the half of a tile the other needs through an
// exchange buffer of C fragments ([writer][wr][n8 tile][lane] float4s,
// free of conflicts), so each output has one owner and no sum crosses warps.
// A tile's rows are staged by cp.async in the 16-byte pieces that hold the
// head's columns, as they lie: head dim j of a row sits at column j + (col
// & 3) of the plane (every plane of a head shares that offset: C % 4 == 0),
// and each row's last piece has the columns past the head dim zeroed once it
// lands (the planes start zeroed, so the columns past a row's last piece
// stay zero).

// ablation switches of scripts/torch_attention_bwd16_f32_sweep.py (timing
// only: a variant without them computes something else)
#ifndef ATTN16_F32_STAGE
#define ATTN16_F32_STAGE 1        // 0: the tiles' rows are not loaded
#endif
#ifndef ATTN16_F32_TERM
#define ATTN16_F32_TERM 1         // 0: no bias / mask lookups and no exp
#endif

constexpr int kDbPitch = 64 + 4;          // floats a row of dkv's d(bias)
constexpr int kExchange = 2 * 4 * 4 * 32;   // float4s of the exchange
constexpr int kStatFloats = 3 * 64;       // (max, 1 / sum) pairs, then D

template <int HDP>
struct Tc16 {
  static_assert(HDP % 8 == 0 && HDP <= 128, "head tile");
  static constexpr int R = 64, P = kPitch<HDP>, KT = HDP / 8;
  static constexpr size_t kPlane = (size_t)R * P;
  // dkv double-buffers its q and dO tiles (and their rows' statistics)
  // where six planes fit beside its d(bias) tile; dq always does its k and
  // v tiles
  static constexpr bool kDkvDouble =
      4 * (6 * kPlane + 4 * kExchange + 2 * kStatFloats + 256 * kDbPitch)
      <= kMaxSmem;
  static constexpr int kDkvBuffers = kDkvDouble ? 2 : 1;
  // blocks an SM asked of the registers (kernels/window_attention_bwd.py
  // ``bwd16_f32_min_blocks``): dq two where 128 registers hold a thread
  // without spills and its shared memory lets two in
  static constexpr int kDqMinBlocks = HDP >= 32 && HDP <= 64 ? 2 : 1;
  static constexpr int kDkvMinBlocks = 1;
};

// shared memory of the two launches (kernels/window_attention_bwd.py
// ``window_attention_bwd_f32_plan``): dq holds q, dO, two k and two v
// planes, the exchange and its rows' statistics; dkv k, v, one or two q and
// dO planes, the exchange, their rows' statistics and the d(bias) tile
// [256][kDbPitch] of its keys
template <int HDP>
__host__ __device__ constexpr size_t dq16_smem_bytes() {
  return 4 * (6 * Tc16<HDP>::kPlane + 4 * kExchange + kStatFloats);
}

template <int HDP>
__host__ __device__ constexpr size_t dkv16_smem_bytes() {
  constexpr int nb = Tc16<HDP>::kDkvBuffers;
  return 4 * ((2 + 2 * nb) * Tc16<HDP>::kPlane + 4 * kExchange
              + nb * kStatFloats + 256 * kDbPitch);
}

// rows [t0, t0 + 64) of a window's part of ``src`` (the head's hd columns
// from ``col``) into ``plane`` by cp.async, each row's 16-byte pieces as
// they lie (head dim j at column j + (col & 3)): thread tid takes row
// tid / 4 and its pieces tid % 4, + 4, ..; nothing waits
template <int HDP>
__device__ __forceinline__ void stage_async(float* plane,
                                            const float* __restrict__ src,
                                            long long ld, int col, int b,
                                            int wi, int wj, int t0, int H,
                                            int W, int shift, int hd) {
#if ATTN16_F32_STAGE
  constexpr int N = 256, P = kPitch<HDP>;
  const int r = threadIdx.x >> 2;
  const int pieces = ((col & 3) + hd + 3) / 4;
  const float* g = src + token_row<N>(b, wi, wj, t0 + r, H, W, shift) * ld
                   + (col & ~3);
  for (int k = threadIdx.x & 3; k < pieces; k += 4)
    cp_async_piece(plane + r * P + 4 * k, g + 4 * k);
#endif
}

// rows [row0, row0 + 64)'s (max, 1 / sum) from ``stats`` and, where
// given, D from ``dsum`` into ``st`` ([64] float2, then [64] float) by
// cp.async
__device__ __forceinline__ void stage_stats(float* st,
                                            const float* __restrict__ stats,
                                            const float* __restrict__ dsum,
                                            size_t row0) {
  const int tid = threadIdx.x;
  if (tid < 32)
    cp_async_piece(st + 4 * tid, stats + 2 * row0 + 4 * tid);
  else if (dsum != nullptr && tid < 48)
    cp_async_piece(st + 128 + 4 * (tid - 32), dsum + row0 + 4 * (tid - 32));
}

// waits for this thread's copies, then zeroes the columns past the head dim
// that its row's last piece brought into ``count`` planes, ``stride``
// floats apart from ``first`` (the caller synchronises the block before the
// planes are read)
template <int HDP>
__device__ __forceinline__ void land_async(float* first, int stride,
                                           int count, int col, int hd) {
  constexpr int P = kPitch<HDP>;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const int end = (col & 3) + hd, pieces = (end + 3) / 4;
  if (4 * pieces == end || (threadIdx.x & 3) != ((pieces - 1) & 3)) return;
  const int r = threadIdx.x >> 2;
  for (int p = 0; p < count; ++p)
    for (int x = end; x < 4 * pieces; ++x)
      first[p * stride + r * P + x] = 0.f;
}

// the relative-position table's index of (query qi, key kj) at 16x16
// windows (attn_term<256>'s) is rel16(qi) - rel16(kj) + 480
__device__ __forceinline__ int rel16(int t) { return 31 * (t >> 4) + (t & 15); }

// P = exp(scale s + term - max) / sum of (query qi, key kj), the additive
// term from the head's table centred at index 480 (``tab``: table + h * 961
// + 480) and the window's region labels (``lab``, null at shift 0), the
// row's and the column's parts given: ``rel`` = rel16(qi) - rel16(kj),
// ``same`` = whether qi and kj share a region
__device__ __forceinline__ float probability(float s, float scale,
                                             const float* __restrict__ tab,
                                             int rel, bool same, float mx,
                                             float inv) {
#if ATTN16_F32_TERM
  const float term = __ldg(tab + rel) + (same ? 0.f : kMaskOff);
  return expf(s * scale + term - mx) * inv;
#else
  return s * scale * inv - mx + (float)rel + (same ? 0.f : 1.f);
#endif
}

// S and dP of a warp's 16 rows of planes (a, a2) against 32 rows of
// planes (b, b2) from row n0, over the head dims: s += a b^T, dp += a2 b2^T
template <int HDP>
__device__ __forceinline__ void scores_pair(const float* a, const float* a2,
                                            const float* b, const float* b2,
                                            int r0, int n0,
                                            float (&s)[4][4],
                                            float (&dp)[4][4]) {
  constexpr int P = kPitch<HDP>, KT = HDP / 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  auto step = [&](int kk) {
    uint32_t ah[4], al[4], ch[4], cl[4];
    frag_a<P>(a, r0, 8 * kk, ah, al);
    frag_a<P>(a2, r0, 8 * kk, ch, cl);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bh[2], bl[2], b2h[2], b2l[2];
      frag_b_rows<P>(b, n0 + 8 * j, 8 * kk, bh, bl);
      frag_b_rows<P>(b2, n0 + 8 * j, 8 * kk, b2h, b2l);
      mma3x2(s[j], ah, al, bh, bl, dp[j], ch, cl, b2h, b2l);
    }
  };
#pragma unroll 1
  for (int kk = 0; kk + 1 < KT; kk += 2) {    // two head-dim steps a pass
    step(kk);
    step(kk + 1);
  }
  if (KT & 1) step(KT - 1);
}

// ---- N = 256: dq launch, a block per (window, head, query tile) -------------
//
// Warp (wr, wc) keeps S, dP (then dS) of its 16 query rows x 32 keys of
// each key tile in registers, trades its dS half with its row's other warp
// and accumulates dQ of its rows over the tile's 64 keys in the head dims'
// n8 tiles wc, wc + 2, .. The next key tile's k and v land in the other
// pair of planes while a tile is computed.

template <int HDP>
__global__ void __launch_bounds__(kThreads, Tc16<HDP>::kDqMinBlocks)
attn_bwd16_dq_f32_kernel(const float* __restrict__ qkv, long long ldq,
                         const float* __restrict__ dout, long long ldg,
                         const float* __restrict__ ctx, long long ldc,
                         const float* __restrict__ table,
                         const void* __restrict__ labels,
                         const float* __restrict__ stats,
                         float* __restrict__ dqkv, long long ldd,
                         float* __restrict__ dsum, int H, int W, int C,
                         int nh, int hd, int shift, float scale) {
  constexpr int N = 256;
  using T = Tc16<HDP>;
  constexpr int R = T::R, P = T::P, KT = T::KT, NQ = (KT + 1) / 2;
  constexpr int kTiles = Geo<N>::kTiles;
  extern __shared__ __align__(16) float smem[];
  constexpr int PL = T::kPlane;
  float* qs = smem;                       // planes: q, dO, k0, k1, v0, v1
  float* dos = qs + PL;
  float* ks = dos + PL;                   // key tile kt in ks + (kt & 1) PL
  float* vs = ks + 2 * PL;
  float4* exch = reinterpret_cast<float4*>(vs + 2 * PL);
  float* st = reinterpret_cast<float*>(exch + kExchange);
  float* rd = st + 128;

  const int nww = W / Geo<N>::kWin;
  const int nw = (H / Geo<N>::kWin) * nww;
  int bid = blockIdx.x;
  const int qt = bid % kTiles;
  bid /= kTiles;
  const int h = bid % nh;
  const int gw = bid / nh;                // image * nW + window
  const int b = gw / nw, win = gw % nw;
  const int wi = win / nww, wj = win % nww;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid / 32, t = tid & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int col = h * hd, t0 = qt * R, sc = col & 3;
  const size_t row0 = ((size_t)gw * nh + h) * N + t0;   // stats / dsum row
  for (int i = tid; i < 6 * R * P; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  // q, dO, O (into the second k plane) and key tile 0
  stage_async<HDP>(qs, qkv, ldq, col, b, wi, wj, t0, H, W, shift, hd);
  stage_async<HDP>(dos, dout, ldg, col, b, wi, wj, t0, H, W, shift, hd);
  stage_async<HDP>(ks + PL, ctx, ldc, col, b, wi, wj, t0, H, W, shift, hd);
  stage_async<HDP>(ks, qkv, ldq, C + col, b, wi, wj, 0, H, W, shift, hd);
  stage_async<HDP>(vs, qkv, ldq, 2 * C + col, b, wi, wj, 0, H, W, shift,
                   hd);
  stage_stats(st, stats, nullptr, row0);
  land_async<HDP>(qs, PL, 5, col, hd);    // q, dO, k0, O, v0
  __syncthreads();
  {
    // D = rowsum(dO o O): four lanes a row, a quarter of the head dims each
    const int r = tid / 4, part = tid % 4;
    float d = 0.f;
    for (int x = part; x < HDP; x += 4)
      d += dos[r * P + sc + x] * ks[PL + r * P + sc + x];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      rd[r] = d;
      dsum[row0 + r] = d;
    }
  }
  __syncthreads();                        // O's plane is free for tile 1

  const int ra = 16 * wr + ((tid & 31) >> 2);   // rows ra, ra + 8
  const float* tab = table + h * 961 + 480;
  const int* lab = static_cast<const int*>(labels);
  if (lab != nullptr) lab += (size_t)win * N;
  const int rel_q[2] = {rel16(t0 + ra), rel16(t0 + ra + 8)};
  const int lab_q[2] = {lab ? __ldg(lab + t0 + ra) : 0,
                        lab ? __ldg(lab + t0 + ra + 8) : 0};
  float dq[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = 0; kt < kTiles; ++kt) {
    const int cur = (kt & 1) * PL, nxt = PL - cur;
    if (kt + 1 < kTiles) {                // the next key tile, meanwhile
      stage_async<HDP>(ks + nxt, qkv, ldq, C + col, b, wi, wj, (kt + 1) * R,
                       H, W, shift, hd);
      stage_async<HDP>(vs + nxt, qkv, ldq, 2 * C + col, b, wi, wj,
                       (kt + 1) * R, H, W, shift, hd);
    }
    const float* kp = ks + cur + sc;
    float s[4][4], dp[4][4];              // S = Q K^T, dP = dO V^T
    scores_pair<HDP>(qs + sc, dos + sc, kp, vs + cur + sc, 16 * wr, 32 * wc,
                     s, dp);
    // dS = P o (dP - D), P from the forward's statistics, in place of S,
    // and the half the row's other warp needs into the exchange
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, r = ra + 8 * hh;
        const int kj = kt * R + 32 * wc + 8 * j + 2 * t + (e & 1);
        const bool same = lab == nullptr || __ldg(lab + kj) == lab_q[hh];
        const float p = probability(s[j][e], scale, tab,
                                    rel_q[hh] - rel16(kj), same, st[2 * r],
                                    st[2 * r + 1]);
        s[j][e] = p * (dp[j][e] - rd[r]);
      }
      exch[((wc * 4 + wr) * 4 + j) * 32 + lane] =
          make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
    __syncthreads();
    // dQ += dS K over the tile's 64 keys, the warp's head-dim n8 tiles
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 o = exch[(((1 - wc) * 4 + wr) * 4 + j) * 32 + lane];
        const bool own = hf == wc;
        uint32_t ah[4], al[4];
        frag_a_of_c(own ? s[j][0] : o.x, own ? s[j][1] : o.y,
                    own ? s[j][2] : o.z, own ? s[j][3] : o.w, ah, al);
#pragma unroll
        for (int n = 0; n < NQ; n += 2) {   // two n8 tiles at a time
          const int nt = 2 * n + wc;
          uint32_t bh[2], bl[2], b2h[2], b2l[2];
          if (n + 1 < NQ && nt + 2 < KT) {
            frag_b_cols<P>(kp, 32 * hf + 8 * j, 8 * nt, bh, bl);
            frag_b_cols<P>(kp, 32 * hf + 8 * j, 8 * (nt + 2), b2h, b2l);
            mma3x2(dq[n], ah, al, bh, bl, dq[n + 1], ah, al, b2h, b2l);
          } else if (nt < KT) {
            frag_b_cols<P>(kp, 32 * hf + 8 * j, 8 * nt, bh, bl);
            mma3(dq[n], ah, al, bh, bl);
          }
        }
      }
    }
    if (kt + 1 < kTiles) land_async<HDP>(ks + nxt, 2 * PL, 2, col, hd);
    __syncthreads();                      // this tile's reads are done
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = ra + 8 * hh;
    float* dst = dqkv + token_row<N>(b, wi, wj, t0 + r, H, W, shift) * ldd
                 + col;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (2 * n + wc) + 2 * t + e;
        if (c < hd) dst[c] = dq[n][2 * hh + e] * scale;
      }
  }
}

// ---- N = 256: dkv launch, a block per (group of windows, head, key tile) ----
//
// Warp (wr, wc) computes S^T = K Q^T and dP^T = V dO^T of its 16 keys x 32
// queries of each query tile in registers, P^T and dS^T in their place, and
// adds dS^T into the block's d(bias) tile in shared memory (each element
// always by the same thread: a fixed order over the group's windows). Warp
// wc = 0 accumulates dV = P^T dO of its keys over the tile's 64 queries,
// wc = 1 dK = dS^T Q: each trades the half the other needs (its dS, its P)
// through the exchange. Where two q and dO planes fit (kDkvDouble), the
// next query tile (of this window or the next one) lands while a tile is
// computed.

template <int HDP>
__global__ void __launch_bounds__(kThreads, Tc16<HDP>::kDkvMinBlocks)
attn_bwd16_dkv_f32_kernel(const float* __restrict__ qkv, long long ldq,
                          const float* __restrict__ dout, long long ldg,
                          const float* __restrict__ table,
                          const void* __restrict__ labels,
                          const float* __restrict__ stats,
                          const float* __restrict__ dsum,
                          float* __restrict__ dqkv, long long ldd,
                          float* __restrict__ part, int H, int W, int C,
                          int nh, int hd, int shift, int group, int windows,
                          float scale) {
  constexpr int N = 256;
  using T = Tc16<HDP>;
  constexpr int R = T::R, P = T::P, KT = T::KT, NB = T::kDkvBuffers;
  constexpr int kQT = Geo<N>::kTiles;
  extern __shared__ __align__(16) float smem[];
  constexpr int PL = T::kPlane;
  float* ks = smem;                       // planes: k, v, then q and dO a
  float* vs = ks + PL;                    // buffer: buffer u's q at qs + 2u
  float* qs = vs + PL;                    // PL, its dO PL after it
  float4* exch = reinterpret_cast<float4*>(qs + 2 * NB * PL);
  float* st = reinterpret_cast<float*>(exch + kExchange);   // a buffer's
  float* dbs = st + NB * kStatFloats;     // statistics, then d(bias)

  const int nww = W / Geo<N>::kWin;
  const int nw = (H / Geo<N>::kWin) * nww;
  int bid = blockIdx.x;
  const int kt = bid % kQT;
  bid /= kQT;
  const int h = bid % nh, grp = bid / nh;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid / 32, t = tid & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int col = h * hd, k0 = kt * R, sc = col & 3;
  const int ka = 16 * wr + ((tid & 31) >> 2);   // keys ka, ka + 8
  const float* tab = table + h * 961 + 480;
  const int rel_k[2] = {rel16(k0 + ka), rel16(k0 + ka + 8)};
  for (int i = tid; i < (2 + 2 * NB) * R * P; i += kThreads) smem[i] = 0.f;
  for (int i = tid; i < N * kDbPitch; i += kThreads) dbs[i] = 0.f;
  __syncthreads();

  // a query tile's q and dO rows and their statistics into buffer ``buf``
  auto stage_q = [&](int gw_, int qt_, int buf) {
    const int b_ = gw_ / nw, win_ = gw_ % nw;
    stage_async<HDP>(qs + 2 * buf * PL, qkv, ldq, col, b_, win_ / nww,
                     win_ % nww, qt_ * R, H, W, shift, hd);
    stage_async<HDP>(qs + (2 * buf + 1) * PL, dout, ldg, col, b_, win_ / nww,
                     win_ % nww, qt_ * R, H, W, shift, hd);
    stage_stats(st + buf * kStatFloats, stats, dsum,
                ((size_t)gw_ * nh + h) * N + qt_ * R);
  };
  const int w_begin = grp * group, w_end = min(windows, (grp + 1) * group);
  int buf = 0;
  if (NB == 2) stage_q(w_begin, 0, 0);
  for (int gw = w_begin; gw < w_end; ++gw) {
    const int b = gw / nw, win = gw % nw;
    const int wi = win / nww, wj = win % nww;
    const int* lab = static_cast<const int*>(labels);
    if (lab != nullptr) lab += (size_t)win * N;
    const int lab_k[2] = {lab ? __ldg(lab + k0 + ka) : 0,
                          lab ? __ldg(lab + k0 + ka + 8) : 0};
    // k and v of the window: the last window's reads ended at its last
    // tile's barrier
    stage_async<HDP>(ks, qkv, ldq, C + col, b, wi, wj, k0, H, W, shift, hd);
    stage_async<HDP>(vs, qkv, ldq, 2 * C + col, b, wi, wj, k0, H, W, shift,
                     hd);
    float acc[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int qt = 0; qt < kQT; ++qt) {
      const int t0 = qt * R;
      if (NB == 1) stage_q(gw, qt, 0);
      land_async<HDP>(qs + 2 * buf * PL, PL, 2, col, hd);
      if (qt == 0) land_async<HDP>(ks, PL, 2, col, hd);
      __syncthreads();
      if (NB == 2) {                      // the next tile, meanwhile
        if (qt + 1 < kQT)
          stage_q(gw, qt + 1, buf ^ 1);
        else if (gw + 1 < w_end)
          stage_q(gw + 1, 0, buf ^ 1);
      }
      const float* qp = qs + 2 * buf * PL + sc;
      const float* op = qp + PL;
      const float* rs = st + buf * kStatFloats;
      float s[4][4], dp[4][4];            // S^T, dP^T: keys ka (+ 8),
      scores_pair<HDP>(ks + sc, vs + sc, qp, op, 16 * wr, 32 * wc, s, dp);
#pragma unroll                            // queries 32 wc + 8 j + 2 t (+ 1)
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, key = ka + 8 * hh;
          const int q = 32 * wc + 8 * j + 2 * t + (e & 1);
          const bool same = lab == nullptr || __ldg(lab + t0 + q) == lab_k[hh];
          const float p = probability(s[j][e], scale, tab,
                                      rel16(t0 + q) - rel_k[hh], same,
                                      rs[2 * q], rs[2 * q + 1]);
          const float ds = p * (dp[j][e] - rs[128 + q]);
          dbs[(t0 + q) * kDbPitch + key] += ds;
          s[j][e] = p;
          dp[j][e] = ds;
        }
        // wc = 0 hands its dS to the dK warp, wc = 1 its P to the dV warp
        exch[((wc * 4 + wr) * 4 + j) * 32 + lane] = wc == 0
            ? make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3])
            : make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      }
      __syncthreads();
      // wc = 0: dV from P^T and dO; wc = 1: dK from dS^T and Q
      const float* bplane = wc == 0 ? op : qp;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {    // the tile's 64 queries
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 o = exch[(((1 - wc) * 4 + wr) * 4 + j) * 32 + lane];
          const float4 m = wc == 0
              ? make_float4(s[j][0], s[j][1], s[j][2], s[j][3])
              : make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
          const float4 a = hf == wc ? m : o;
          uint32_t ah[4], al[4];
          frag_a_of_c(a.x, a.y, a.z, a.w, ah, al);
#pragma unroll
          for (int n = 0; n < KT; n += 2) {   // two n8 tiles at a time
            uint32_t bh[2], bl[2], b2h[2], b2l[2];
            frag_b_cols<P>(bplane, 32 * hf + 8 * j, 8 * n, bh, bl);
            if (n + 1 < KT) {
              frag_b_cols<P>(bplane, 32 * hf + 8 * j, 8 * (n + 1), b2h, b2l);
              mma3x2(acc[n], ah, al, bh, bl, acc[n + 1], ah, al, b2h, b2l);
            } else {
              mma3(acc[n], ah, al, bh, bl);
            }
          }
        }
      }
      __syncthreads();                    // this tile's reads are done
      buf ^= NB - 1;
    }
    // wc = 0 writes dV, wc = 1 dK (scaled) of its keys
    const float mul = wc == 0 ? 1.f : scale;
    const int part_col = (wc == 0 ? 2 * C : C) + col;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = ka + 8 * hh;
      float* dst = dqkv + token_row<N>(b, wi, wj, k0 + key, H, W, shift) * ldd
                   + part_col;
#pragma unroll
      for (int n = 0; n < KT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < hd) dst[c] = acc[n][2 * hh + e] * mul;
        }
    }
  }
  float* out = part + ((size_t)grp * nh + h) * N * N + k0;
  for (int i = tid; i < N * R; i += kThreads)
    out[(size_t)(i / R) * N + i % R] = dbs[(i / R) * kDbPitch + i % R];
}

// ---- launches ---------------------------------------------------------------

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  configured = true;
  return 0;
}

struct BwdArgs {
  const float* qkv;
  long long ldq;
  const float* dout;
  long long ldg;
  const float* ctx;             // N = 256 only
  long long ldc;
  const float* bias;
  const void* mask;
  const float* stats;           // N = 256 only
  float* dqkv;
  long long ldd;
  float* dsum;                  // N = 256 only
  float* part;
  float* dbias;
  int B, H, W, C, nh, shift, group;
  long long smem, smem_dq;
};

template <int N, int HDP>
int bwd_launch(const BwdArgs& a, cudaStream_t s) {
  constexpr int kWin = Geo<N>::kWin;
  const int hd = a.C / a.nh;
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  const long long windows = (long long)a.B * (a.H / kWin) * (a.W / kWin);
  const long long groups = (windows + a.group - 1) / a.group;
  if (groups * a.nh > kMaxPartialBlocks) return (int)cudaErrorInvalidValue;
  int rc;
  if constexpr (N < 256) {
    constexpr size_t bytes = bwd_smem_bytes<N, HDP>();
    static_assert(bytes <= kMaxSmem,
                  "window_attention_bwd_f32: shared memory");
    if ((long long)bytes != a.smem) return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if ((rc = allow_smem(attn_bwd_f32_kernel<N, HDP>, bytes, configured)))
      return rc;
    attn_bwd_f32_kernel<N, HDP><<<(unsigned)(groups * a.nh), kThreads, bytes,
                                  s>>>(
        a.qkv, a.ldq, a.dout, a.ldg, a.bias, a.mask, a.dqkv, a.ldd, a.part,
        a.H, a.W, a.C, a.nh, hd, a.shift, a.group, (int)windows, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
  } else {
    constexpr size_t bytes = dkv16_smem_bytes<HDP>();
    constexpr size_t dq_bytes = dq16_smem_bytes<HDP>();
    static_assert(bytes <= kMaxSmem && dq_bytes <= kMaxSmem,
                  "window_attention_bwd_f32: shared memory");
    if ((long long)bytes != a.smem || (long long)dq_bytes != a.smem_dq)
      return (int)cudaErrorInvalidValue;
    static bool dq_configured = false, dkv_configured = false;
    if ((rc = allow_smem(attn_bwd16_dq_f32_kernel<HDP>, dq_bytes,
                         dq_configured)) ||
        (rc = allow_smem(attn_bwd16_dkv_f32_kernel<HDP>, bytes,
                         dkv_configured)))
      return rc;
    constexpr int kQT = Geo<N>::kTiles;
    attn_bwd16_dq_f32_kernel<HDP>
        <<<(unsigned)(windows * a.nh * kQT), kThreads, dq_bytes, s>>>(
            a.qkv, a.ldq, a.dout, a.ldg, a.ctx, a.ldc, a.bias, a.mask,
            a.stats, a.dqkv, a.ldd, a.dsum, a.H, a.W, a.C, a.nh, hd, a.shift,
            scale);
    if ((rc = (int)cudaGetLastError())) return rc;
    attn_bwd16_dkv_f32_kernel<HDP>
        <<<(unsigned)(groups * a.nh * kQT), kThreads, bytes, s>>>(
            a.qkv, a.ldq, a.dout, a.ldg, a.bias, a.mask, a.stats, a.dsum,
            a.dqkv, a.ldd, a.part, a.H, a.W, a.C, a.nh, hd, a.shift, a.group,
            (int)windows, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  const long long total = (long long)a.nh * N * N;
  return sum_partials(a.part, (int)groups, total, a.dbias, total, nullptr, s);
}

// head dims padded to 16 at N = 16 and 64 (the SIMT kernel's float4
// quads), to 8 at N = 256 (the mma k8 steps and n8 tiles)
template <int N>
int bwd_by_head(const BwdArgs& a, cudaStream_t s) {
  const int hd = a.C / a.nh;
  if constexpr (N == 256) {
    // the head tiles of this source: up to 64 in
    // window_attention_bwd16_f32.cu, 72-128 in
    // window_attention_bwd16_f32_wide.cu (ADSR_BWD16_WIDE), so nvcc builds
    // the two halves of the 32 instances in parallel
    switch ((hd + 7) / 8) {
#define ADSR_HDP(K) \
      case K: return bwd_launch<N, 8 * K>(a, s);
#if ADSR_BWD16_WIDE
      ADSR_HDP(9) ADSR_HDP(10) ADSR_HDP(11) ADSR_HDP(12)
      ADSR_HDP(13) ADSR_HDP(14) ADSR_HDP(15) ADSR_HDP(16)
#else
      ADSR_HDP(1) ADSR_HDP(2) ADSR_HDP(3) ADSR_HDP(4)
      ADSR_HDP(5) ADSR_HDP(6) ADSR_HDP(7) ADSR_HDP(8)
#endif
#undef ADSR_HDP
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch ((hd + 15) / 16) {
#define ADSR_HDP(K) \
      case K: return bwd_launch<N, 16 * K>(a, s);
      ADSR_HDP(1) ADSR_HDP(2) ADSR_HDP(3) ADSR_HDP(4)
      ADSR_HDP(5) ADSR_HDP(6) ADSR_HDP(7) ADSR_HDP(8)
#undef ADSR_HDP
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

// The checks of the C entry of window ``kWin`` (N = kWin^2): qkv, dout,
// dqkv (and at N = 256 ctx) with 16-byte aligned bases and row strides
// that are multiples of 4 floats; ``bias`` and ``mask`` in the forward's
// forms; ``group`` windows a (d(bias) partial, head); ``smem`` (and at N
// = 256 ``smem_dq``) as kernels/window_attention_bwd.py
// ``window_attention_bwd_f32_plan`` planned: a launch whose plan differs
// from this file's layout is refused.
template <int kWin>
int bwd_entry(const BwdArgs& a, void* stream) {
  const auto odd = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (a.H % kWin || a.W % kWin || a.nh <= 0 || a.C % a.nh || a.C % 4 ||
      a.B < 0 || a.shift < 0 || a.shift >= kWin ||
      (a.shift > 0) != (a.mask != nullptr) || a.group < 1 || a.ldq % 4 ||
      a.ldg % 4 || a.ldd % 4 || a.ldq < 3ll * a.C || a.ldg < a.C ||
      a.ldd < 3ll * a.C || a.C / a.nh > 128 || odd(a.qkv) || odd(a.dout) ||
      odd(a.dqkv) || a.part == nullptr || a.dbias == nullptr ||
      (kWin == 16 && (a.ctx == nullptr || a.stats == nullptr ||
                      a.dsum == nullptr || a.ldc % 4 || a.ldc < a.C ||
                      odd(a.ctx))))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  return bwd_by_head<kWin * kWin>(a, (cudaStream_t)stream);
}

}  // namespace
