// window_attention_bwd4: backward of the shifted-window multi-head
// self-attention over 4x4 windows (N = 16, window_attention4.cu), from the
// raster qkv and the context's gradient (8x8 windows:
// window_attention_bwd.cu; 16x16: window_attention_bwd16.cu).
//
//   S  = q k^T * scale + bias + mask,  P = softmax(S)   (recomputed)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(P o dP)),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  d(bias) = sum of dS
//
// Replaces: the attention backward phases of the Pallas kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770) at window 4.
// Bound on H100: bytes. Each token row's qkv (3C) and dO (C) are read once
// and its dqkv (3C) written once; the five 16-token products are ~25 flop
// per byte.
// Design: the forward's (window_attention4.cu, attn4.cuh): a block takes
// every head of its windows and moves whole token rows, on a persistent
// grid (kernels/window_attention_bwd.py ``window_attention_bwd_plan``) with
// a ring of ``stages`` staged windows (mask, 16 rows of qkv, 16 of dO,
// cp.async'd while the warps compute and store the window before):
//   - 8 warps (all of them stage and store rows); they take a head slot
//     each (heads slot, slot + 8, ... of each window), two warps a slot for
//     four heads or fewer, else one (attn4.cuh ``warps_a_head``). Every
//     operand is read straight from the staged rows, with no re-lay into
//     planes: a pair of consecutive columns (4-byte loads) as the row
//     operand of S = q k^T and dP = dO v^T, a pair of rows (two 2-byte
//     loads) as the row-major operand of dQ = dS k, dK = dS^T q and dV =
//     P^T dO;
//   - the head's first warp computes S, dP, the stabilised f32 softmax (P
//     recomputed), D = rowsum(P o dP) and dS = P o (dP - D) as
//     window_attn_bwd_core.cuh's attn_bwd_rows<HDP, 16> does (the same
//     products in the same order, P and dS rounded once to bf16 before the
//     three output products, f32 accumulation), keeps the bf16 P and dS as
//     tiles [16][24] of its slot and computes dQ = dS k from its dS
//     registers, then dK = dS^T q while the head's second warp (or the
//     first, where it is alone) computes dV = P^T dO, both from the tiles
//     by ldmatrix.trans (tile_t_times<HDP, 16>'s products): a window's
//     gradients need no cross-warp sum;
//   - dq, dk and dv go into an output row buffer [16][3C] of the block, and
//     after a block barrier whole rows of 3C go out to dqkv in 16-byte
//     stores;
//   - d(bias): a head's first warp adds each window's dS into the head's
//     f32 [16][16] accumulator in shared memory (one warp a head, windows
//     in the block's order); at the end the block writes one partial [nh][16 x
//     16], and partials.cuh's column pass sums the blocks' partials in a
//     fixed order: two calls are bitwise equal (no atomics).
// No state survives a launch and nothing is allocated here, so a CUDA graph
// can replay it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn4.cuh"
#include "partials.cuh"
#include "window_attn_bwd_core.cuh"

namespace {

constexpr int kMaxStages = 3;
constexpr int kTileLd = bwd_tile_ld(kTok4);
constexpr size_t kMaxSmem = 232448;
// what scripts/torch_attention4_sweep.py turns off (timing only)
constexpr bool kLoad = true;
constexpr bool kCompute = true;
constexpr bool kCore = true;
constexpr bool kStore = true;

typedef __nv_bfloat16 bf16;

// Bytes of one head slot's bf16 P and dS tiles
constexpr int kSlotBytes = 2 * kTok4 * kTileLd * 2;

// Shared memory of one block: the heads' bias and d(bias) accumulators,
// ``stages`` staged windows (mask, 16 rows of qkv, 16 of dO), the output
// rows [16][3C] and each head slot's tiles
__host__ __device__ inline size_t smem_bytes(int hdp, int C, int nh,
                                             int stages) {
  return (size_t)2 * nh * kBiasBytes4
         + (size_t)stages * stage_bytes4(3 * C, C)
         + (size_t)kTok4 * 2 * raw_pitch(3 * C)
         + (size_t)head_slots(nh) * kSlotBytes;
}

// Y = T^T X for a [16][kTileLd] bf16 tile T (P or dS) at ``tile``: the A
// fragment of T^T by ldmatrix.trans, as tile_t_times<HDP, 16> takes it
__device__ __forceinline__ void tile_t_frag(uint32_t tile, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(tile + ((lane & 7) + (lane >> 4) * 8) * (2u * kTileLd)
                    + ((lane >> 3) & 1) * 16, a);
}

// S = q k^T and dP = dO v^T [16 x 16] over HDP dims of one head of one
// window, as attn_bwd_rows<HDP, 16> computes them (the same products in
// the same order): q, k, v from elements sq, sq + C, sq + 2C of the staged
// qkv rows ``raw`` (``pitch`` bytes a row), dO from sg of ``graw``
// (``gpitch``), read in pairs of columns with dims [hd, HDP) zero. s[j] and
// dp[j] hold mma's C layout of keys [8j, 8j + 8).
template <int HDP>
__device__ __forceinline__ void s_dp_staged(const unsigned char* raw,
                                            uint32_t pitch,
                                            const unsigned char* graw,
                                            uint32_t gpitch, int sq, int C,
                                            int sg, int hd, float (&s)[2][4],
                                            float (&dp)[2][4]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const bool odd = sq & 1, godd = sg & 1;
  const int sk = sq + C, sv = sq + 2 * C;
  const unsigned char* r0 = raw + gr * pitch;      // token gr
  const unsigned char* r1 = r0 + 8 * pitch;        // token gr + 8
  const unsigned char* g0 = graw + gr * gpitch;
  const unsigned char* g1 = g0 + 8 * gpitch;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int d = 16 * kk + 2 * t;
    // only the last step holds dims past the head
    const bool last = kk + 1 == HDP / 16;
    const int d0 = last ? d : 0, d8 = last ? d + 8 : 0, lim = last ? hd : 16;
    const uint32_t a[4] = {row_pair(r0, sq + d, odd, d0, lim),
                           row_pair(r1, sq + d, odd, d0, lim),
                           row_pair(r0, sq + d + 8, odd, d8, lim),
                           row_pair(r1, sq + d + 8, odd, d8, lim)};
    const uint32_t ag[4] = {row_pair(g0, sg + d, godd, d0, lim),
                            row_pair(g1, sg + d, godd, d0, lim),
                            row_pair(g0, sg + d + 8, godd, d8, lim),
                            row_pair(g1, sg + d + 8, godd, d8, lim)};
    // keys gr (tile 0) and gr + 8 (tile 1) as mma's "col" B
    mma_16816(s[0], a, row_pair(r0, sk + d, odd, d0, lim),
              row_pair(r0, sk + d + 8, odd, d8, lim));
    mma_16816(s[1], a, row_pair(r1, sk + d, odd, d0, lim),
              row_pair(r1, sk + d + 8, odd, d8, lim));
    mma_16816(dp[0], ag, row_pair(r0, sv + d, odd, d0, lim),
              row_pair(r0, sv + d + 8, odd, d8, lim));
    mma_16816(dp[1], ag, row_pair(r1, sv + d, odd, d0, lim),
              row_pair(r1, sv + d + 8, odd, d8, lim));
  }
}

// From S and dP of one head of one window on, as attn_bwd_rows<HDP, 16>
// computes it (rows r0 = 0): the softmax (bias and mask f32 [16][16] from
// shared memory), D and dS; dS added into ``dbias``; P and dS into the
// tiles ``pt`` and ``dst`` (bf16 [16][24]) and dS as the A fragment ``ds``
// of dQ = dS K
__device__ __forceinline__ void softmax_ds(float (&s)[2][4],
                                           float (&dp)[2][4],
                                           const float* bias,
                                           const float* mask, float scale,
                                           uint32_t pt, uint32_t dst,
                                           float (&dbias)[2][4],
                                           uint32_t (&ds)[4]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  // the stabilised softmax of rows gr (values 0, 1) and gr + 8 (2, 3)
  const float* b0 = bias + gr * kTok4 + 2 * t;
  const float* m0 = mask != nullptr ? mask + gr * kTok4 + 2 * t : nullptr;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float2 u = *reinterpret_cast<const float2*>(b0 + 8 * j);
    const float2 w = *reinterpret_cast<const float2*>(b0 + 8 * kTok4 + 8 * j);
    s[j][0] = s[j][0] * scale + u.x;
    s[j][1] = s[j][1] * scale + u.y;
    s[j][2] = s[j][2] * scale + w.x;
    s[j][3] = s[j][3] * scale + w.y;
    if (m0 != nullptr) {
      const float2 mu = *reinterpret_cast<const float2*>(m0 + 8 * j);
      const float2 mw = *reinterpret_cast<const float2*>(m0 + 8 * kTok4
                                                         + 8 * j);
      s[j][0] += mu.x;
      s[j][1] += mu.y;
      s[j][2] += mw.x;
      s[j][3] += mw.y;
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s[j][0] = expf(s[j][0] - mx0);
    s[j][1] = expf(s[j][1] - mx0);
    s[j][2] = expf(s[j][2] - mx1);
    s[j][3] = expf(s[j][3] - mx1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, sh);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, sh);
  }
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;

  // P in f32, D = rowsum(P o dP)
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s[j][0] *= inv0;
    s[j][1] *= inv0;
    s[j][2] *= inv1;
    s[j][3] *= inv1;
    d0 += s[j][0] * dp[j][0] + s[j][1] * dp[j][1];
    d1 += s[j][2] * dp[j][2] + s[j][3] * dp[j][3];
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, sh);
    d1 += __shfl_xor_sync(0xffffffffu, d1, sh);
  }

  // dS = P o (dP - D) in f32 into d(bias); P and dS once to bf16, into the
  // tiles and, for dS, as the A fragment of dS K
  const uint32_t tl0 = (gr * kTileLd + 2 * t) * 2u;
  const uint32_t tl1 = tl0 + 8u * kTileLd * 2u;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    dp[j][0] = s[j][0] * (dp[j][0] - d0);
    dp[j][1] = s[j][1] * (dp[j][1] - d0);
    dp[j][2] = s[j][2] * (dp[j][2] - d1);
    dp[j][3] = s[j][3] * (dp[j][3] - d1);
#pragma unroll
    for (int i = 0; i < 4; ++i) dbias[j][i] += dp[j][i];
    sts_b32(pt + tl0 + 16u * j, pack_bf16x2(s[j][0], s[j][1]));
    sts_b32(pt + tl1 + 16u * j, pack_bf16x2(s[j][2], s[j][3]));
    ds[2 * j] = pack_bf16x2(dp[j][0], dp[j][1]);
    ds[2 * j + 1] = pack_bf16x2(dp[j][2], dp[j][3]);
    sts_b32(dst + tl0 + 16u * j, ds[2 * j]);
    sts_b32(dst + tl1 + 16u * j, ds[2 * j + 1]);
  }
}

template <int HDP>
__global__ void __launch_bounds__(32 * kWarps4, 2)
window_attention_bwd4_kernel(const bf16* __restrict__ qkv, long long ldq,
                             const bf16* __restrict__ dctx, long long ldg,
                             const float* __restrict__ bias,
                             const float* __restrict__ mask,
                             bf16* __restrict__ dqkv, long long ldd,
                             float* __restrict__ part, int windows, int H,
                             int W, int C, int nh, int hd, int shift,
                             int stages, float scale) {
  constexpr uint32_t kTile = 2u * kTok4 * kTileLd;      // bytes of a tile
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int wph = warps_a_head(nh), slot = warp / wph;   // head slot
  const int role = warp - slot * wph;                     // 0: its leader
  const int width = 3 * C;
  const uint32_t pitch = 2u * raw_pitch(width), gpitch = 2u * raw_pitch(C);
  const uint32_t base = smem_addr(smem);
  const float* sbias = reinterpret_cast<const float*>(smem);
  float* acc = reinterpret_cast<float*>(smem) + nh * kTok4 * kTok4;
  const uint32_t stage0 = base + 2 * nh * kBiasBytes4;
  const uint32_t sbytes = stage_bytes4(width, C);
  const uint32_t graw_at = kMaskBytes4 + kTok4 * pitch;   // dO in a slot
  const uint32_t out = stage0 + stages * sbytes;   // the output rows
  const uint32_t tiles0 = out + kTok4 * pitch;      // slot w's tiles

  // stage window fw in slot s: its mask, qkv rows and dO rows
  auto stage = [&](int fw, int s) {
    const uint32_t st = stage0 + s * sbytes;
    const Win4 rows(fw, H, W, shift);
    if (mask != nullptr)
      for (int i = threadIdx.x; i < kMaskBytes4 / 16; i += blockDim.x)
        cp_async16(st + 16u * i, mask + (size_t)rows.win * 256 + 4 * i, 16);
    if (kLoad) {
      stage_rows(st + kMaskBytes4, qkv, ldq, width, rows, warp, warps,
                 lane);
      stage_rows(st + graw_at, dctx, ldg, C, rows, warp, warps, lane);
    }
  };

  ATTN4_MARK(0, true);
  ATTN4_MARK(1, true);
  for (int i = threadIdx.x; i < nh * kBiasBytes4 / 16; i += blockDim.x)
    cp_async16(base + 16u * i, bias + 4 * i, 16);
  for (int i = threadIdx.x; i < nh * kTok4 * kTok4; i += blockDim.x)
    acc[i] = 0.f;
  for (int s = 0; s < stages; ++s) {
    const int fw = blockIdx.x + s * gridDim.x;
    if (fw < windows) stage(fw, s);
    cp_commit();
  }

  int s = 0;
  for (int fw = blockIdx.x; fw < windows; fw += gridDim.x) {
    cp_wait(stages - 1);
    __syncthreads();
    ATTN4_MARK(2, fw == (int)blockIdx.x);
    const uint32_t st = stage0 + s * sbytes, raw = st + kMaskBytes4;
    const float* smask = mask != nullptr
        ? reinterpret_cast<const float*>(smem + (st - base)) : nullptr;
    if (kCompute) {
      const uint32_t tp = tiles0 + slot * kSlotBytes, tds = tp + kTile;
      const unsigned char* rw = smem + (raw - base);
      const unsigned char* gw = smem + (st - base) + graw_at;
      unsigned char* ow = smem + (out - base);
      // the head's first warp: S, dP, the softmax, dS, dQ, then dK; its
      // second (or the first where it is alone): dV
      const int dv_role = wph > 1 ? 1 : 0;
      for (int h = slot; h < nh; h += head_slots(nh)) {
        const bool first = fw == (int)blockIdx.x && h == slot;
        const int sq = h * hd, sg = h * hd;
        float res[HDP / 8][4];
        uint32_t a[4];
        if (role == 0) {
          float sc[2][4], dp[2][4];
          if (kCore) s_dp_staged<HDP>(rw, pitch, gw, gpitch, sq, C, sg, hd,
                                      sc, dp);
          ATTN4_MARK(8, first);
          // the head's d(bias) accumulator, in mma's C layout
          float* ah = acc + h * kTok4 * kTok4 + g * kTok4 + 2 * tq;
          float db[kTok4 / 8][4];
#pragma unroll
          for (int j = 0; j < kTok4 / 8; ++j) {
            const float2 lo = *reinterpret_cast<const float2*>(ah + 8 * j);
            const float2 hi = *reinterpret_cast<const float2*>(
                ah + 8 * kTok4 + 8 * j);
            db[j][0] = lo.x;
            db[j][1] = lo.y;
            db[j][2] = hi.x;
            db[j][3] = hi.y;
          }
          if (kCore) {
            softmax_ds(sc, dp, sbias + h * kTok4 * kTok4, smask, scale, tp,
                       tds, db, a);
            times_rows<HDP>(a, rw, pitch, C + sq, res);   // dQ = dS K
          }
#pragma unroll
          for (int j = 0; j < kTok4 / 8; ++j) {
            *reinterpret_cast<float2*>(ah + 8 * j) = make_float2(db[j][0],
                                                                 db[j][1]);
            *reinterpret_cast<float2*>(ah + 8 * kTok4 + 8 * j) =
                make_float2(db[j][2], db[j][3]);
          }
          ATTN4_MARK(9, first);
          put_frag<HDP>(ow, pitch, sq, hd, res, scale);
        }
        head_sync(slot, wph);   // the head's P and dS tiles are whole
        ATTN4_MARK(10, first);
        if (role == 0) {        // dK = dS^T Q * scale
          tile_t_frag(tds, a);
          if (kCore) times_rows<HDP>(a, rw, pitch, sq, res);
          put_frag<HDP>(ow, pitch, C + sq, hd, res, scale);
        }
        if (role == dv_role) {  // dV = P^T dO
          tile_t_frag(tp, a);
          if (kCore) times_rows<HDP>(a, gw, gpitch, sg, res);
          put_frag<HDP>(ow, pitch, 2 * C + sq, hd, res, 1.f);
        }
        head_sync(slot, wph);   // every read of the tiles is done
        ATTN4_MARK(11, first);
      }
    }
    __syncthreads();
    ATTN4_MARK(3, fw == (int)blockIdx.x);
    if (kStore)
      store_rows(dqkv, ldd, width, out, pitch, Win4(fw, H, W, shift), warp,
                 warps, lane);
    __syncthreads();    // slot s is free
    ATTN4_MARK(4, fw == (int)blockIdx.x);
    const int next = fw + stages * gridDim.x;
    if (next < windows) stage(next, s);
    cp_commit();
    s = s + 1 == stages ? 0 : s + 1;
  }
  cp_wait(0);
  __syncthreads();

  // this block's d(bias) partial, row blockIdx.x of [grid][nh * 16 * 16]
  float* pr = part + (size_t)blockIdx.x * nh * kTok4 * kTok4;
  for (int i = threadIdx.x; i < nh * kTok4 * kTok4; i += blockDim.x)
    pr[i] = acc[i];
  ATTN4_MARK(5, true);
  ATTN4_MARK(6, true);
}

template <int HDP>
int launch(const void* qkv, long long ldq, const void* dctx, long long ldg,
           const void* bias, const void* mask, void* dqkv, long long ldd,
           void* part, void* dbias, long long windows, int H, int W, int C,
           int nh, int hd, int shift, int stages, int grid, long long smem,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(HDP, C, nh, stages);
  if ((long long)bytes != smem || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static size_t configured = 0;   // per template instance
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attention_bwd4_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  window_attention_bwd4_kernel<HDP>
      <<<(unsigned)grid, 32 * kWarps4, bytes, stream>>>(
          (const bf16*)qkv, ldq, (const bf16*)dctx, ldg, (const float*)bias,
          (const float*)mask, (bf16*)dqkv, ldd, (float*)part, (int)windows,
          H, W, C, nh, hd, shift, stages,
          (float)(1.0 / std::sqrt((double)hd)));
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  // d(bias)[j] = sum over the blocks of part[block][j], j < nh * 16 * 16,
  // by partials.cuh's column pass (eight warps a 32 columns, in order)
  return sum_partials(nullptr, 0, 0, nullptr, 0, nullptr, stream,
                      (const float*)part, grid, nh * kTok4 * kTok4,
                      (float*)dbias);
}

}  // namespace

// ``stages``, ``grid`` and ``smem`` are what the caller planned
// (kernels/window_attention_bwd.py ``window_attention_bwd_plan``); a launch
// whose shared memory differs from this file's layout is refused. ``part``
// holds grid * nh * 16 * 16 f32.
extern "C" int adsr_window_attention_bwd4(const void* qkv, long long ldq,
                                          const void* dctx, long long ldg,
                                          const void* bias, const void* mask,
                                          void* dqkv, long long ldd,
                                          void* part, void* dbias, int B,
                                          int H, int W, int C, int nh,
                                          int shift, int stages, int grid,
                                          long long smem, void* stream) {
  const long long windows = (long long)B * (H / 4) * (W / 4);
  if (H % 4 || W % 4 || nh <= 0 || C % nh || C % 4 || B < 0 ||
      shift < 0 || shift >= 4 || (shift > 0) != (mask != nullptr) ||
      stages < 1 || stages > kMaxStages || grid < 1 ||
      windows > 0x7fffffffll || ldq % 8 || ldg % 8 || ldd % 8 ||
      ldq < 3ll * C || ldg < C || ldd < 3ll * C ||
      reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(dctx) % 16 ||
      reinterpret_cast<uintptr_t>(dqkv) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int hd = C / nh;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return launch<16>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 2: return launch<32>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 3: return launch<48>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 4: return launch<64>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 5: return launch<80>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 6: return launch<96>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 7: return launch<112>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 8: return launch<128>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
