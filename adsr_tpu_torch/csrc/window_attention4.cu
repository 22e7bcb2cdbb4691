// window_attention4: shifted-window multi-head self-attention over 4x4
// windows (N = 16 tokens), reading q, k, v straight from the raster-order
// qkv buffer (8x8 windows: window_attention.cu; 16x16: window_attention16.cu).
//
// Replaces: the attention phases of the Pallas kernel _rdg_kernel_impl
// (adsr_tpu/ops/fused_rdg.py:734-855) at window 4 (the 64/x4, 128/x8 and
// 32/x2 models: LR 16 x 16 or 8 x 8 tokens, drct_experiment's window
// img_size / 4).
// Bound on H100: bytes. Each token row of qkv (3C) is read once and each row
// of the context (C) written once; at 16 tokens a window the two products
// are ~16 flop per byte of qkv.
// Design: a block takes every head of its windows, so it moves whole token
// rows and no 16-byte piece is shared with another block (attn4.cuh):
//   - a persistent grid (kernels/window_attention.py
//     ``window_attention_plan``: one window a block where the card holds a
//     block for every window, as at batch 16; else as many blocks as it
//     holds, each walking windows blockIdx.x, + gridDim.x, ...) with a ring
//     of ``stages`` staged windows: the window's 16 qkv rows (3C wide) and
//     its f32 mask [16][16] cp.async'd while the warps compute and store
//     the window before it;
//   - the heads' f32 bias [nh][16][16] staged once a block;
//   - 8 warps (all of them stage and store rows); warp w takes heads w,
//     w + 8, ... of each window and computes each as attn_core<HDP, 16> of
//     window_attn_core.cuh
//     does (a window is one 16-row mma.sync tile: S as two n8 tiles, the
//     stabilised f32 softmax with expf, P rounded once to bf16, P V one k16
//     step, f32 accumulation: the numerics of the N = 64 core, the same
//     products in the same order), with every operand read in place from
//     the staged rows: q and k in pairs of columns (4-byte loads,
//     qk_staged), v in pairs of rows (two 2-byte loads, attn4.cuh
//     times_rows), no re-lay into planes; the bias and mask come from
//     shared memory;
//   - the context goes over the head's q columns of the staged rows, and
//     after a block barrier whole rows of C go out in 16-byte stores.
// The cyclic shift is index arithmetic, once a row: token (r, s) of shifted
// window (wi, wj) is raster row ((wi*4 + r + shift) mod H) * W + (wj*4 + s
// + shift) mod W, and the context goes back to the same rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn4.cuh"
#include "window_attn_core.cuh"

namespace {

constexpr int kMaxStages = 3;
constexpr size_t kMaxSmem = 232448;
// what scripts/torch_attention4_sweep.py turns off (timing only)
constexpr bool kLoad = true;
constexpr bool kCompute = true;
constexpr bool kCore = true;
constexpr bool kStore = true;

typedef __nv_bfloat16 bf16;

// Shared memory of one block: the heads' bias and ``stages`` staged
// windows (mask, 16 rows of 3C)
__host__ __device__ inline size_t smem_bytes(int C, int nh, int stages) {
  return (size_t)nh * kBiasBytes4 + (size_t)stages * stage_bytes4(3 * C, 0);
}

// S [16 x 16] = Q K^T over HDP dims (qk_tile<HDP, 16>'s products in its
// order), the operands read in pairs straight from the staged rows (``raw``,
// ``pitch`` bytes a row): q from element sq, k from sk (the same parity), Q's
// dims [hd, HDP) zero. s[j] holds mma's C layout of keys [8j, 8j + 8).
template <int HDP>
__device__ __forceinline__ void qk_staged(const unsigned char* raw,
                                          uint32_t pitch, int sq, int sk,
                                          int hd, float (&s)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool odd = sq & 1;
  const unsigned char* r0 = raw + g * pitch;       // query and key g
  const unsigned char* r1 = r0 + 8 * pitch;        // query and key g + 8
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
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
    // k's dims past the head meet q's zeros: read unmasked
    mma_16816(s[0], a, row_pair(r0, sk + d, odd, 0, 16),
              row_pair(r0, sk + d + 8, odd, 0, 16));
    mma_16816(s[1], a, row_pair(r1, sk + d, odd, 0, 16),
              row_pair(r1, sk + d + 8, odd, 0, 16));
  }
}

// P = softmax(S * scale + bias (+ mask)) for one window and head, as
// attn_core<HDP, 16> computes it from S on: the f32 bias and mask [16][16]
// (shared memory), the stabilised f32 softmax with expf, P rounded once to
// bf16 as the A fragment of P V
__device__ __forceinline__ void softmax_p(float (&s)[2][4], const float* bias,
                                          const float* mask, float scale,
                                          uint32_t (&a)[4]) {
  add_bias<kTok4, kTok4>(s, bias, mask, scale);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
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
  // P's keys [0, 8) and [8, 16) of rows lane / 4 and + 8
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a[2 * j] = pack_bf16x2(s[j][0] * inv0, s[j][1] * inv0);
    a[2 * j + 1] = pack_bf16x2(s[j][2] * inv1, s[j][3] * inv1);
  }
}

template <int HDP>
__global__ void __launch_bounds__(32 * kWarps4, 2)
window_attention4_kernel(const bf16* __restrict__ qkv, long long ldq,
                         bf16* __restrict__ ctx, long long ldc,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask, int windows, int H,
                         int W, int C, int nh, int hd, int shift,
                         int stages, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int width = 3 * C;
  const uint32_t pitch = 2u * raw_pitch(width);
  const uint32_t base = smem_addr(smem);
  const uint32_t stage0 = base + nh * kBiasBytes4;
  const uint32_t sbytes = stage_bytes4(width, 0);
  const float* sbias = reinterpret_cast<const float*>(smem);

  // stage window fw in slot s: its mask, then its rows
  auto stage = [&](int fw, int s) {
    const uint32_t st = stage0 + s * sbytes;
    const Win4 rows(fw, H, W, shift);
    if (mask != nullptr)
      for (int i = threadIdx.x; i < kMaskBytes4 / 16; i += blockDim.x)
        cp_async16(st + 16u * i, mask + (size_t)rows.win * 256 + 4 * i, 16);
    if (kLoad)
      stage_rows(st + kMaskBytes4, qkv, ldq, width, rows, warp, warps, lane);
  };

  ATTN4_MARK(0, true);
  ATTN4_MARK(1, true);
  for (int i = threadIdx.x; i < nh * kBiasBytes4 / 16; i += blockDim.x)
    cp_async16(base + 16u * i, bias + 4 * i, 16);
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
      unsigned char* rw = smem + (raw - base);
      for (int h = warp; h < nh; h += warps) {
        const bool first = fw == (int)blockIdx.x && h == warp;
        float o[HDP / 8][4];
        if (kCore) {
          float sc[2][4];
          uint32_t p[4];
          qk_staged<HDP>(rw, pitch, h * hd, C + h * hd, hd, sc);
          ATTN4_MARK(8, first);
          softmax_p(sc, sbias + h * kTok4 * kTok4, smask, scale, p);
          ATTN4_MARK(9, first);
          times_rows<HDP>(p, rw, pitch, 2 * C + h * hd, o);   // P V
          ATTN4_MARK(10, first);
        } else {
#pragma unroll
          for (int j = 0; j < HDP / 8; ++j)
            o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
        }
        __syncwarp();   // every lane's reads of the head's q columns are done
        // the context over the head's q columns, which this warp alone
        // reads
        put_frag<HDP>(rw, pitch, h * hd, hd, o, 1.f);
        ATTN4_MARK(11, first);
      }
    }
    __syncthreads();
    ATTN4_MARK(3, fw == (int)blockIdx.x);
    if (kStore)
      store_rows(ctx, ldc, C, raw, pitch, Win4(fw, H, W, shift), warp,
                 warps, lane);
    __syncthreads();    // slot s is free
    ATTN4_MARK(4, fw == (int)blockIdx.x);
    const int next = fw + stages * gridDim.x;
    if (next < windows) stage(next, s);
    cp_commit();
    s = s + 1 == stages ? 0 : s + 1;
  }
  cp_wait(0);
  ATTN4_MARK(5, true);
  ATTN4_MARK(6, true);
}

template <int HDP>
int launch(const void* qkv, long long ldq, void* ctx, long long ldc,
           const void* bias, const void* mask, long long windows, int H,
           int W, int C, int nh, int hd, int shift, int stages, int grid,
           long long smem, cudaStream_t stream) {
  const size_t bytes = smem_bytes(C, nh, stages);
  if ((long long)bytes != smem || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static size_t configured = 0;   // per template instance
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attention4_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  window_attention4_kernel<HDP>
      <<<(unsigned)grid, 32 * kWarps4, bytes, stream>>>(
          (const bf16*)qkv, ldq, (bf16*)ctx, ldc, (const float*)bias,
          (const float*)mask, (int)windows, H, W, C, nh, hd, shift, stages,
          (float)(1.0 / std::sqrt((double)hd)));
  return (int)cudaGetLastError();
}

}  // namespace

// ``stages``, ``grid`` and ``smem`` are what the caller planned
// (kernels/window_attention.py ``window_attention_plan``); a launch whose
// shared memory differs from this file's layout is refused.
extern "C" int adsr_window_attention4(const void* qkv, long long ldq,
                                      void* ctx, long long ldc,
                                      const void* bias, const void* mask,
                                      int B, int H, int W, int C, int nh,
                                      int shift, int stages, int grid,
                                      long long smem, void* stream) {
  const long long windows = (long long)B * (H / 4) * (W / 4);
  if (H % 4 || W % 4 || nh <= 0 || C % nh || C % 4 || B < 0 ||
      shift < 0 || shift >= 4 || (shift > 0) != (mask != nullptr) ||
      stages < 1 || stages > kMaxStages || grid < 1 ||
      windows > 0x7fffffffll || ldq % 8 || ldc % 8 || ldq < 3ll * C ||
      ldc < C || reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(ctx) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int hd = C / nh;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return launch<16>(qkv, ldq, ctx, ldc, bias, mask, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 2: return launch<32>(qkv, ldq, ctx, ldc, bias, mask, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 3: return launch<48>(qkv, ldq, ctx, ldc, bias, mask, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 4: return launch<64>(qkv, ldq, ctx, ldc, bias, mask, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 5: return launch<80>(qkv, ldq, ctx, ldc, bias, mask, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 6: return launch<96>(qkv, ldq, ctx, ldc, bias, mask, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 7: return launch<112>(qkv, ldq, ctx, ldc, bias, mask, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    case 8: return launch<128>(qkv, ldq, ctx, ldc, bias, mask, windows, H, W, C, nh, hd, shift, stages, grid, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
