// window_attention4: shifted-window multi-head self-attention over 4x4
// windows (N = 16 tokens), reading q, k, v straight from the raster-order
// qkv buffer (8x8 windows: window_attention.cu; 16x16: window_attention16.cu).
//
// Replaces: the attention phases of the Pallas kernel _rdg_kernel_impl
// (adsr_tpu/ops/fused_rdg.py:734-855) at window 4 (the 64/x4, 128/x8 and
// 32/x2 models: LR 16 x 16 or 8 x 8 tokens, drct_experiment's window
// img_size / 4).
// Bound on H100: bytes. Each token row of qkv (3c) is read once and each row
// of the context (c) written once; at 16 tokens a window the two products
// are ~16 flop per byte of qkv.
// Design: a window is exactly one 16-row mma.sync m16n8k16 tile, so one
// warp holds a whole window: its 16 query rows against its 16 keys, S as
// two n8 tiles, each row's 16 scores 4 to a lane of the quad (max and sum
// two quad shuffles), P V one k16 step: attn_core<HDP, 16> of
// window_attn_core.cuh, the numerics of the N = 64 core (stabilised f32
// softmax, expf, P rounded once to bf16, f32 accumulation). A block of 4
// warps takes one head and a group of four consecutive windows over the
// flat (image, window) index, so it still fills 64 rows of q/k/v planes
// [3][64][hdp + 8] in shared memory, in the 16-byte piece gather of the
// N = 64 kernel; the last group may be short (batch 5 at 20 x 20 tokens has
// 125 windows): rows of windows past the last are neither read nor
// written, and their warp idles. The cyclic shift is index arithmetic:
// token (r, s) of shifted window (wi, wj) is raster row ((wi*4 + r + shift)
// mod H) * W + (wj*4 + s + shift) mod W, and the context goes back to the
// same rows. Bias [nh][16][16] and mask [nW][16][16] are f32, read in
// registers as at N = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "window_attn_core.cuh"

namespace {

constexpr int kWin = 4;
constexpr int N = kWin * kWin;     // tokens per window
constexpr int kGroup = 4;          // windows a block: one a warp
constexpr int kRows = kGroup * N;  // token rows a block
constexpr int kThreads = 32 * kGroup;
constexpr int kBatch = 8;          // 16-byte loads in flight a thread
constexpr size_t kMaxSmem = 232448;

typedef __nv_bfloat16 bf16;

// Shared memory of one block: the head's q, k, v planes of its 64 rows
__host__ __device__ inline size_t smem_bytes(int hdp) {
  return (size_t)3 * kRows * (hdp + 8) * 2;
}

// The raster row of row t of group ``grp`` (window 4 grp + t / 16, token
// t % 16), or -1 past the last window
__device__ __forceinline__ long long token_row(int grp, int t, int windows,
                                               int nw, int nww, int H, int W,
                                               int shift) {
  const int fw = grp * kGroup + t / N;
  if (fw >= windows) return -1;
  const int b = fw / nw, win = fw - b * nw;
  const int wi = win / nww, wj = win - wi * nww;
  const int tt = t % N;
  const int row = (wi * kWin + tt / kWin + shift) % H;
  const int col = (wj * kWin + tt % kWin + shift) % W;
  return (long long)b * H * W + (long long)row * W + col;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
window_attention4_kernel(const bf16* __restrict__ qkv, long long ldq,
                         bf16* __restrict__ ctx, long long ldc,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask, int windows, int H,
                         int W, int C, int nh, int hd, int shift,
                         float scale) {
  constexpr int LD = HDP + 8;
  constexpr int kPlane = kRows * LD;      // elements of one plane
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* planes = reinterpret_cast<bf16*>(smem);

  const int nww = W / kWin;
  const int nw = (H / kWin) * nww;
  const int h = blockIdx.x % nh;
  const int grp = blockIdx.x / nh;
  const int C3 = 3 * C;

  if (HDP > hd) {                         // the padded head dims are zero
    const int pad = HDP - hd;
    for (int i = threadIdx.x; i < 3 * kRows * pad; i += kThreads) {
      const int row = i / pad;            // (part, token)
      planes[row * LD + hd + (i - row * pad)] = __float2bfloat16(0.f);
    }
  }

  // the 16-byte pieces of each row that hold the head's columns [s_p, s_p
  // + hd) of part p = q, k, v, as window_attention.cu reads them
  const int s0 = h * hd, s1 = s0 + C, s2 = s1 + C;
  const int lo0 = s0 & ~7, lo1 = s1 & ~7, lo2 = s2 & ~7;
  const int n0 = (s0 + hd - lo0 + 7) / 8, n1 = (s1 + hd - lo1 + 7) / 8;
  const int chunks = n0 + n1 + (s2 + hd - lo2 + 7) / 8;
  const int total = kRows * chunks;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    uint4 v[kBatch];
    long long src_row[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      src_row[j] = -1;
      if (i < total) {
        const int t = i / chunks, k = i - t * chunks;
        src_row[j] = token_row(grp, t, windows, nw, nww, H, W, shift);
        if (src_row[j] >= 0) {
          const int c0 = k < n0 ? lo0 + 8 * k
                                : (k < n0 + n1 ? lo1 + 8 * (k - n0)
                                               : lo2 + 8 * (k - n0 - n1));
          const bf16* src = qkv + src_row[j] * ldq + c0;
          if (c0 + 8 <= C3) {
            v[j] = __ldg(reinterpret_cast<const uint4*>(src));
          } else {
            const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
            v[j] = make_uint4(u.x, u.y, 0u, 0u);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      if (i < total && src_row[j] >= 0) {
        const int t = i / chunks, k = i - t * chunks;
        const int p = k < n0 ? 0 : (k < n0 + n1 ? 1 : 2);
        const int c0 = p == 0 ? lo0 + 8 * k
                              : (p == 1 ? lo1 + 8 * (k - n0)
                                        : lo2 + 8 * (k - n0 - n1));
        // element x is head dim j0 + x of part p, kept where in [0, hd)
        const int j0 = c0 - (p == 0 ? s0 : (p == 1 ? s1 : s2));
        const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
        bf16* dst = planes + p * kPlane + t * LD + j0;
#pragma unroll
        for (int x = 0; x < 8; ++x)
          if (j0 + x >= 0 && j0 + x < hd) dst[x] = e[x];
      }
    }
  }
  __syncthreads();

  // each warp: its window's 16 rows against its 16 keys
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = N * warp, g = lane >> 2, tq = lane & 3;
  const int fw = grp * kGroup + warp;
  if (fw < windows) {
    const int win = fw % nw;
    const uint32_t sp = (uint32_t)__cvta_generic_to_shared(planes)
                        + 2u * r0 * LD;
    float o[HDP / 8][4];
    attn_core<HDP, N>(sp, sp + 2u * kPlane, sp + 4u * kPlane, LD, 0,
                      bias + (size_t)h * N * N,
                      mask != nullptr ? mask + (size_t)win * N * N : nullptr,
                      scale, o);
    // the context over this warp's own 16 rows of the q plane
    bf16* q = planes + (r0 + g) * LD;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = 8 * j + 2 * tq;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (d + x < hd) {
          q[d + x] = __float2bfloat16(o[j][x]);
          q[8 * LD + d + x] = __float2bfloat16(o[j][2 + x]);
        }
      }
    }
  }
  __syncthreads();

  // the context, columns [s0, s0 + hd) of each live row
  const int oc = (s0 + hd - lo0 + 7) / 8;
  for (int i = threadIdx.x; i < kRows * oc; i += kThreads) {
    const int t = i / oc, c0 = lo0 + (i - t * oc) * 8;
    const long long row = token_row(grp, t, windows, nw, nww, H, W, shift);
    if (row < 0) continue;
    const int n = min(8, C - c0);         // 4 at the end of a row 4 past 8
    const bf16* src = planes + t * LD + c0 - s0;
    bf16* dst = ctx + row * ldc + c0;
    if (c0 >= s0 && c0 + n <= s0 + hd) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int x = 0; x < 8; ++x)
        if (x < n) e[x] = src[x];
      if (n == 8)
        *reinterpret_cast<uint4*>(dst) = v;
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y);
    } else {                              // a piece shared with a neighbour
#pragma unroll
      for (int x = 0; x < 8; ++x)
        if (x < n && c0 + x >= s0 && c0 + x < s0 + hd) dst[x] = src[x];
    }
  }
}

template <int HDP>
int launch(const void* qkv, long long ldq, void* ctx, long long ldc,
           const void* bias, const void* mask, int B, int H, int W, int C,
           int nh, int hd, int shift, long long smem, cudaStream_t stream) {
  const size_t bytes = smem_bytes(HDP);
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
  const long long windows = (long long)B * (H / kWin) * (W / kWin);
  const long long blocks = (windows + kGroup - 1) / kGroup * nh;
  if (windows > 0x7fffffffll || blocks > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  window_attention4_kernel<HDP><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const bf16*)qkv, ldq, (bf16*)ctx, ldc, (const float*)bias,
      (const float*)mask, (int)windows, H, W, C, nh, hd, shift,
      (float)(1.0 / std::sqrt((double)hd)));
  return (int)cudaGetLastError();
}

}  // namespace

// ``smem`` is the shared memory the caller planned
// (kernels/window_attention.py ``window_attention_plan``); a launch whose
// plan differs from this file's layout is refused.
extern "C" int adsr_window_attention4(const void* qkv, long long ldq,
                                      void* ctx, long long ldc,
                                      const void* bias, const void* mask,
                                      int B, int H, int W, int C, int nh,
                                      int shift, long long smem,
                                      void* stream) {
  if (H % kWin || W % kWin || nh <= 0 || C % nh || C % 4 || B < 0 ||
      shift < 0 || shift >= kWin || (shift > 0) != (mask != nullptr) ||
      ldq % 8 || ldc % 8 || ldq < 3ll * C || ldc < C ||
      reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(ctx) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int hd = C / nh;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return launch<16>(qkv, ldq, ctx, ldc, bias, mask, B, H, W, C, nh, hd, shift, smem, s);
    case 2: return launch<32>(qkv, ldq, ctx, ldc, bias, mask, B, H, W, C, nh, hd, shift, smem, s);
    case 3: return launch<48>(qkv, ldq, ctx, ldc, bias, mask, B, H, W, C, nh, hd, shift, smem, s);
    case 4: return launch<64>(qkv, ldq, ctx, ldc, bias, mask, B, H, W, C, nh, hd, shift, smem, s);
    case 5: return launch<80>(qkv, ldq, ctx, ldc, bias, mask, B, H, W, C, nh, hd, shift, smem, s);
    case 6: return launch<96>(qkv, ldq, ctx, ldc, bias, mask, B, H, W, C, nh, hd, shift, smem, s);
    case 7: return launch<112>(qkv, ldq, ctx, ldc, bias, mask, B, H, W, C, nh, hd, shift, smem, s);
    case 8: return launch<128>(qkv, ldq, ctx, ldc, bias, mask, B, H, W, C, nh, hd, shift, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
