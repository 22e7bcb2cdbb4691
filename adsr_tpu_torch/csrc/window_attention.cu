// window_attention: shifted-window multi-head self-attention over 8x8
// windows, reading q, k, v straight from the raster-order qkv buffer (16x16
// windows: window_attention16.cu).
//
// Replaces: the attention phases of the Pallas kernel _rdg_kernel_impl
// (adsr_tpu/ops/fused_rdg.py:734-855): per (window, head) scores with the
// relative-position bias and the shift mask, softmax, context.
// Bound on H100: bytes. Each token row of qkv (3c) is read once and each row
// of the context (c) written once; at 64 tokens a window the two products
// are ~64 flop per byte of qkv, far below the bf16 ridge.
// Design: one block (4 warps, 16 query rows each) per (image, window,
// head): small blocks, several to an SM, so that one block's loads overlap
// another's attention (a sweep of larger head groups a block on the card
// found none faster at the flagship's blocks 3-5 and no large gain at
// blocks 1-2). The cyclic shift is index arithmetic: token (r, s) of
// shifted window (wi, wj) is raster row ((wi*8+r+shift) mod H)*W +
// (wj*8+s+shift) mod W, and the context goes back to the same rows (the
// inverse roll is the same map), so no rolled or gathered copy is ever
// made. qkv and ctx have 16-byte rows (row strides a multiple of 8
// elements): the block reads the 16-byte pieces of the window's 64 qkv rows
// that hold its head's q, k and v, eight loads in flight a thread, and
// unpacks them into q/k/v planes [3][64][hdp + 8] in shared memory (head
// dims 30/53/122/46/77 at the flagship zero-padded to a multiple of 16).
// Each warp runs the register-resident core of window_attn_core.cuh on its
// 16 query rows and writes the context over its own rows of the q plane,
// which no other warp reads. After one barrier the block writes the context
// back in 16-byte stores (element stores where a piece is shared with a
// neighbouring head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "window_attn_core.cuh"

namespace {

constexpr int kWin = 8;
constexpr int N = kWin * kWin;     // tokens per window
constexpr int kThreads = 128;      // 4 warps x 16 query rows
constexpr int kBatch = 8;          // 16-byte loads in flight a thread
constexpr size_t kMaxSmem = 232448;

typedef __nv_bfloat16 bf16;

// Shared memory of one block: the head's q, k, v planes
__host__ __device__ inline size_t smem_bytes(int hdp) {
  return (size_t)3 * N * (hdp + 8) * 2;
}

__device__ __forceinline__ long long token_row(int b, int wi, int wj, int t,
                                               int H, int W, int shift) {
  const int r = t / kWin, s = t % kWin;
  const int row = (wi * kWin + r + shift) % H;
  const int col = (wj * kWin + s + shift) % W;
  return (long long)b * H * W + (long long)row * W + col;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const bf16* __restrict__ qkv, long long ldq,
                        bf16* __restrict__ ctx, long long ldc,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, int H, int W, int C,
                        int nh, int hd, int shift, float scale) {
  constexpr int LD = HDP + 8;
  constexpr int kPlane = N * LD;          // elements of one plane
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* planes = reinterpret_cast<bf16*>(smem);

  const int nww = W / kWin;
  const int nw = (H / kWin) * nww;
  const int h = blockIdx.x % nh;
  const int win = (blockIdx.x / nh) % nw;
  const int b = blockIdx.x / (nh * nw);
  const int wi = win / nww, wj = win % nww;
  const int C3 = 3 * C;

  if (HDP > hd) {                         // the padded head dims are zero
    const int pad = HDP - hd;
    for (int i = threadIdx.x; i < 3 * N * pad; i += kThreads) {
      const int row = i / pad;            // (part, token)
      planes[row * LD + hd + (i - row * pad)] = __float2bfloat16(0.f);
    }
  }

  // the 16-byte pieces of each row that hold the head's columns [s_p, s_p
  // + hd) of part p = q, k, v; the pieces of a part start at lo_p (a piece
  // is 4 columns wide at the end of a row whose 3c is 4 past a multiple of
  // 8)
  const int s0 = h * hd, s1 = s0 + C, s2 = s1 + C;
  const int lo0 = s0 & ~7, lo1 = s1 & ~7, lo2 = s2 & ~7;
  const int n0 = (s0 + hd - lo0 + 7) / 8, n1 = (s1 + hd - lo1 + 7) / 8;
  const int chunks = n0 + n1 + (s2 + hd - lo2 + 7) / 8;
  const int total = N * chunks;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      if (i < total) {
        const int t = i / chunks, k = i - t * chunks;
        const int c0 = k < n0 ? lo0 + 8 * k
                              : (k < n0 + n1 ? lo1 + 8 * (k - n0)
                                             : lo2 + 8 * (k - n0 - n1));
        const bf16* src =
            qkv + token_row(b, wi, wj, t, H, W, shift) * ldq + c0;
        if (c0 + 8 <= C3) {
          v[j] = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
          v[j] = make_uint4(u.x, u.y, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      if (i < total) {
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

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp, g = lane >> 2, tq = lane & 3;
  const uint32_t sp = (uint32_t)__cvta_generic_to_shared(planes);
  float o[HDP / 8][4];
  attn_core<HDP>(sp, sp + 2u * kPlane, sp + 4u * kPlane, LD, r0,
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
  __syncthreads();

  // the context, columns [s0, s0 + hd) of each row
  const int oc = (s0 + hd - lo0 + 7) / 8;
  for (int i = threadIdx.x; i < N * oc; i += kThreads) {
    const int t = i / oc, c0 = lo0 + (i - t * oc) * 8;
    const int n = min(8, C - c0);         // 4 at the end of a row 4 past 8
    const bf16* src = planes + t * LD + c0 - s0;
    bf16* dst = ctx + token_row(b, wi, wj, t, H, W, shift) * ldc + c0;
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
        window_attention_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  const long long blocks = (long long)B * (H / kWin) * (W / kWin) * nh;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  window_attention_kernel<HDP><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const bf16*)qkv, ldq, (bf16*)ctx, ldc, (const float*)bias,
      (const float*)mask, H, W, C, nh, hd, shift,
      (float)(1.0 / std::sqrt((double)hd)));
  return (int)cudaGetLastError();
}

}  // namespace

// ``smem`` is the shared memory the caller planned
// (kernels/window_attention.py ``window_attention_plan``); a launch whose
// plan differs from this file's layout is refused.
extern "C" int adsr_window_attention(const void* qkv, long long ldq, void* ctx,
                                     long long ldc, const void* bias,
                                     const void* mask, int B, int H, int W,
                                     int C, int nh, int win, int shift,
                                     long long smem, void* stream) {
  if (win != kWin || H % win || W % win || nh <= 0 ||
      C % nh || C % 4 || B < 0 || shift < 0 || shift >= win ||
      (shift > 0) != (mask != nullptr) || ldq % 8 || ldc % 8 ||
      ldq < 3ll * C || ldc < C || reinterpret_cast<uintptr_t>(qkv) % 16 ||
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
