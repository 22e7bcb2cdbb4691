// window_attention_bwd: backward of the shifted-window multi-head
// self-attention over 8x8 windows (window_attention.cu), from the raster
// qkv and the context's gradient.
//
//   S  = q k^T * scale + bias + mask,  P = softmax(S)   (recomputed)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dO o O)),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  d(bias) = sum of dS
//
// Replaces: the attention backward phases of the Pallas kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770): the per-(window, head)
// recompute of the probabilities and the gradient of q, k, v and of the
// additive attention term.
// Bound on H100: bytes. A block reads 64 tokens x hd of q, k, v and dO once
// and writes 64 x hd of dq, dk, dv plus its 64 x 64 f32 d(bias) partial;
// the five 64-token products are ~100 flop per byte, below the bf16 ridge.
// Design: one block (4 warps, 16 query rows each) per (image, window,
// head), the cyclic shift as the same raster-row arithmetic as the forward
// (qkv at any row stride: the forward's 16-byte rows, read in place),
// so the gradient is scattered back through the very row map the forward
// gathered with and no rolled copy exists. The softmax is the stabilised
// f32 one, as in the forward. rowsum(dO o O) is computed as
// rowsum(P o dP), which needs no O. Head dims are zero-padded to a multiple
// of 16 in shared memory (WMMA); dK and dV read dS and P column-major, so
// no transpose is stored. d(bias) sums dS over every window of every image:
// each block writes its dS as an f32 partial and partials.cuh sums them in
// a fixed order (bitwise reproducible, no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>

#include "partials.cuh"

namespace {

using namespace nvcuda;

constexpr int kWin = 8;
constexpr int N = kWin * kWin;     // tokens per window
constexpr int kThreads = 128;      // 4 warps, 16 rows each
constexpr int LDSS = N + 4;        // f32 pitch of the score tiles
constexpr int LDP = N + 8;         // bf16 pitch of the P and dS tiles

template <int HDP>
struct Smem {
  static constexpr int LDQ = HDP + 8;   // bf16 pitch of q / k / v / dO
  static constexpr int LDO = HDP + 4;   // f32 pitch of the output staging
  static constexpr size_t tile_bytes = (size_t)N * LDQ * 2;
  static constexpr size_t score_bytes = 2ull * N * LDSS * 4;  // P, dP in f32
  static constexpr size_t bytes =
      4 * tile_bytes + score_bytes + 2ull * N * LDP * 2;
  // the f32 output staging reuses the P / dP region once dS exists
  static_assert((size_t)N * LDO * 4 <= score_bytes, "staging must fit");
};

__device__ __forceinline__ long long token_row(int b, int wi, int wj, int t,
                                               int H, int W, int shift) {
  const int r = t / kWin, s = t % kWin;
  const int row = (wi * kWin + r + shift) % H;
  const int col = (wj * kWin + s + shift) % W;
  return (long long)b * H * W + (long long)row * W + col;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragBR = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::row_major>;
using FragBC = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// rows [16w, 16w+16) of X[64 x 64] = A[64 x HDP] @ B[64 x HDP]^T, f32 out
template <int HDP>
__device__ __forceinline__ void rows_abt(const __nv_bfloat16* A,
                                         const __nv_bfloat16* B, int ld,
                                         float* out, int warp) {
  FragC c[N / 16];
#pragma unroll
  for (int j = 0; j < N / 16; ++j) wmma::fill_fragment(c[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < HDP; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + warp * 16 * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      FragBC b;
      wmma::load_matrix_sync(b, B + j * 16 * ld + kk, ld);
      wmma::mma_sync(c[j], a, b, c[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
    wmma::store_matrix_sync(out + warp * 16 * LDSS + j * 16, c[j], LDSS,
                            wmma::mem_row_major);
}

// rows [16w, 16w+16) of Y[64 x HDP] = op(G)[64 x 64] @ X[64 x HDP], where
// op(G) = G (G_T false) or G^T (G_T true), G a [64 x 64] bf16 tile at pitch
// LDP; written to the warp's own 16 rows of the f32 staging tile
template <int HDP, bool G_T>
__device__ __forceinline__ void rows_gx(const __nv_bfloat16* G,
                                        const __nv_bfloat16* X, float* stage,
                                        int warp) {
  constexpr int LDQ = Smem<HDP>::LDQ, LDO = Smem<HDP>::LDO;
  FragC c[HDP / 16];
#pragma unroll
  for (int j = 0; j < HDP / 16; ++j) wmma::fill_fragment(c[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < N; kk += 16) {
    if constexpr (G_T) {
      FragAT a;   // element (r, c) of G^T is G[c][r]: column-major G
      wmma::load_matrix_sync(a, G + kk * LDP + warp * 16, LDP);
#pragma unroll
      for (int j = 0; j < HDP / 16; ++j) {
        FragBR b;
        wmma::load_matrix_sync(b, X + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    } else {
      FragA a;
      wmma::load_matrix_sync(a, G + warp * 16 * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < HDP / 16; ++j) {
        FragBR b;
        wmma::load_matrix_sync(b, X + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < HDP / 16; ++j)
    wmma::store_matrix_sync(stage + warp * 16 * LDO + j * 16, c[j], LDO,
                            wmma::mem_row_major);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                            long long ldq,
                            const __nv_bfloat16* __restrict__ dctx,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            __nv_bfloat16* __restrict__ dqkv,
                            float* __restrict__ dbias_part, int H, int W,
                            int C, int nh, int hd, int shift, float scale) {
  using S = Smem<HDP>;
  constexpr int LDQ = S::LDQ, LDO = S::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + N * LDQ;
  __nv_bfloat16* Vs = Ks + N * LDQ;
  __nv_bfloat16* Gs = Vs + N * LDQ;                       // dO
  float* Ps32 = reinterpret_cast<float*>(smem + 4 * S::tile_bytes);
  float* dPs = Ps32 + N * LDSS;
  float* stage = Ps32;                                    // after dS
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(
      smem + 4 * S::tile_bytes + S::score_bytes);
  __nv_bfloat16* dSs = Ps + N * LDP;

  const int nww = W / kWin;
  const int nw = (H / kWin) * nww;
  const int h = blockIdx.x % nh;
  const int win = (blockIdx.x / nh) % nw;
  const int b = blockIdx.x / (nh * nw);
  const int wi = win / nww, wj = win % nww;
  const long long C3 = 3ll * C;

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < N * HDP; i += kThreads) {
    const int t = i / HDP, d = i % HDP;
    __nv_bfloat16 q = zero, k = zero, v = zero, g = zero;
    if (d < hd) {
      const long long row = token_row(b, wi, wj, t, H, W, shift);
      const __nv_bfloat16* p = qkv + row * ldq + h * hd + d;
      q = p[0];
      k = p[C];
      v = p[2 * C];
      g = dctx[row * C + h * hd + d];
    }
    Qs[t * LDQ + d] = q;
    Ks[t * LDQ + d] = k;
    Vs[t * LDQ + d] = v;
    Gs[t * LDQ + d] = g;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  rows_abt<HDP>(Qs, Ks, LDQ, Ps32, warp);    // raw scores q k^T
  rows_abt<HDP>(Gs, Vs, LDQ, dPs, warp);     // dP = dO V^T
  __syncwarp();

  // the warp's own 16 rows: stabilised softmax, then dS; lane owns 2 keys
  const float* bh = bias + (size_t)h * N * N;
  const float* mw = mask != nullptr ? mask + (size_t)win * N * N : nullptr;
  float* part = dbias_part + ((size_t)(b * nw + win) * nh + h) * N * N;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float x0 = Ps32[r * LDSS + lane] * scale + bh[r * N + lane];
    float x1 = Ps32[r * LDSS + lane + 32] * scale + bh[r * N + lane + 32];
    if (mw != nullptr) {
      x0 += mw[r * N + lane];
      x1 += mw[r * N + lane + 32];
    }
    float mx = fmaxf(x0, x1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float e0 = expf(x0 - mx), e1 = expf(x1 - mx);
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / sum;
    const float p0 = e0 * inv, p1 = e1 * inv;
    const float g0 = dPs[r * LDSS + lane], g1 = dPs[r * LDSS + lane + 32];
    float dsum = p0 * g0 + p1 * g1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    const float s0 = p0 * (g0 - dsum), s1 = p1 * (g1 - dsum);
    Ps[r * LDP + lane] = __float2bfloat16(p0);
    Ps[r * LDP + lane + 32] = __float2bfloat16(p1);
    dSs[r * LDP + lane] = __float2bfloat16(s0);
    dSs[r * LDP + lane + 32] = __float2bfloat16(s1);
    part[r * N + lane] = s0;
    part[r * N + lane + 32] = s1;
  }
  __syncthreads();   // dK, dV read every row of dS and P; P/dP f32 are free

  // each warp: its 16 rows of dQ (query rows), then of dK and dV (key rows)
  for (int which = 0; which < 3; ++which) {
    if (which == 0)
      rows_gx<HDP, false>(dSs, Ks, stage, warp);   // dQ = dS K
    else if (which == 1)
      rows_gx<HDP, true>(dSs, Qs, stage, warp);    // dK = dS^T Q
    else
      rows_gx<HDP, true>(Ps, Gs, stage, warp);     // dV = P^T dO
    __syncwarp();
    const float mul = which < 2 ? scale : 1.f;
    for (int i = lane; i < 16 * hd; i += 32) {
      const int t = warp * 16 + i / hd, d = i % hd;
      dqkv[token_row(b, wi, wj, t, H, W, shift) * C3 + which * C + h * hd + d] =
          __float2bfloat16(stage[t * LDO + d] * mul);
    }
    __syncwarp();
  }
}

template <int HDP>
int launch(const void* qkv, long long ldq, const void* dctx,
           const void* bias,
           const void* mask, void* dqkv, void* part, void* dbias, int B,
           int H, int W, int C, int nh, int hd, int shift,
           cudaStream_t stream) {
  constexpr size_t bytes = Smem<HDP>::bytes;
  static bool configured = false;   // per template instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attention_bwd_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long windows = (long long)B * (H / kWin) * (W / kWin);
  if (windows * nh > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  window_attention_bwd_kernel<HDP>
      <<<(unsigned)(windows * nh), kThreads, bytes, stream>>>(
          (const __nv_bfloat16*)qkv, ldq, (const __nv_bfloat16*)dctx,
          (const float*)bias, (const float*)mask, (__nv_bfloat16*)dqkv,
          (float*)part, H, W, C, nh, hd, shift,
          (float)(1.0 / std::sqrt((double)hd)));
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return sum_partials((const float*)part, (int)windows, (long long)nh * N * N,
                      (float*)dbias, (long long)nh * N * N, nullptr, stream);
}

}  // namespace

extern "C" int adsr_window_attention_bwd(const void* qkv, long long ldq,
                                         const void* dctx,
                                         const void* bias, const void* mask,
                                         void* dqkv, void* part, void* dbias,
                                         int B, int H, int W, int C, int nh,
                                         int win, int shift, void* stream) {
  if (win != kWin || H % kWin || W % kWin || nh <= 0 || C % nh || B < 0 ||
      shift < 0 || shift >= kWin || (shift > 0) != (mask != nullptr) ||
      ldq < 3ll * C)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int hd = C / nh;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return launch<16>(qkv, ldq, dctx, bias, mask, dqkv, part, dbias, B, H, W, C, nh, hd, shift, s);
    case 2: return launch<32>(qkv, ldq, dctx, bias, mask, dqkv, part, dbias, B, H, W, C, nh, hd, shift, s);
    case 3: return launch<48>(qkv, ldq, dctx, bias, mask, dqkv, part, dbias, B, H, W, C, nh, hd, shift, s);
    case 4: return launch<64>(qkv, ldq, dctx, bias, mask, dqkv, part, dbias, B, H, W, C, nh, hd, shift, s);
    case 5: return launch<80>(qkv, ldq, dctx, bias, mask, dqkv, part, dbias, B, H, W, C, nh, hd, shift, s);
    case 6: return launch<96>(qkv, ldq, dctx, bias, mask, dqkv, part, dbias, B, H, W, C, nh, hd, shift, s);
    case 7: return launch<112>(qkv, ldq, dctx, bias, mask, dqkv, part, dbias, B, H, W, C, nh, hd, shift, s);
    case 8: return launch<128>(qkv, ldq, dctx, bias, mask, dqkv, part, dbias, B, H, W, C, nh, hd, shift, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
