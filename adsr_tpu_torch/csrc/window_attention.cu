// window_attention: shifted-window multi-head self-attention over 8x8
// windows, reading q, k, v straight from the raster-order qkv buffer.
//
// Replaces: the attention phases of the Pallas kernel _rdg_kernel_impl
// (adsr_tpu/ops/fused_rdg.py:734-855): per (window, head) scores with the
// relative-position bias and the shift mask, softmax, context.
// Bound on H100: bytes. The block reads 64 tokens x hd of each of q, k, v
// once and writes 64 x hd of context; at 64 tokens per window the two
// products are ~64 flop per byte of qkv, far below the bf16 ridge.
// Design: one block (4 warps) per (image, window, head). The cyclic shift is
// index arithmetic: token (r, s) of shifted window (wi, wj) is raster row
// ((wi*8+r+shift) mod H)*W + (wj*8+s+shift) mod W, and the context goes back
// to the same rows (the inverse roll is the same map), so no rolled or
// gathered copy is ever made. Head dims (30/53/122/46/77 at the flagship)
// are zero-padded to a multiple of 16 in shared memory for WMMA. The
// softmax is the stabilised one, in f32 (the TPU's unstabilised exp2 form
// and its score-bound guard are not carried over).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>

namespace {

using namespace nvcuda;

constexpr int kWin = 8;
constexpr int N = kWin * kWin;     // tokens per window
constexpr int kThreads = 128;      // 4 warps, 16 query rows each
constexpr int LDSS = N + 4;        // f32 pitch of the score tile
constexpr int LDP = N + 8;         // bf16 pitch of the probability tile

template <int HDP>
struct Smem {
  static constexpr int LDQ = HDP + 8;   // bf16 pitch of q / k / v
  static constexpr int LDO = HDP + 4;   // f32 pitch of the context tile
  static constexpr size_t qkv_bytes = 3ull * N * LDQ * 2;
  static constexpr size_t bytes = qkv_bytes + N * LDSS * 4 + N * LDP * 2;
  // the f32 context tile reuses the q and k region once the scores exist
  static_assert(N * LDO * 4 <= 2 * N * LDQ * 2, "context tile must fit q+k");
};

__device__ __forceinline__ long long token_row(int b, int wi, int wj, int t,
                                               int H, int W, int shift) {
  const int r = t / kWin, s = t % kWin;
  const int row = (wi * kWin + r + shift) % H;
  const int col = (wj * kWin + s + shift) % W;
  return (long long)b * H * W + (long long)row * W + col;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                        __nv_bfloat16* __restrict__ ctx,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, int H, int W, int C,
                        int nh, int hd, int shift, float scale) {
  using S = Smem<HDP>;
  constexpr int LDQ = S::LDQ, LDO = S::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + N * LDQ;
  __nv_bfloat16* Vs = Ks + N * LDQ;
  float* Ss = reinterpret_cast<float*>(smem + S::qkv_bytes);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + N * LDSS);
  float* Os = reinterpret_cast<float*>(smem);

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
    __nv_bfloat16 q = zero, k = zero, v = zero;
    if (d < hd) {
      const __nv_bfloat16* p =
          qkv + token_row(b, wi, wj, t, H, W, shift) * C3 + h * hd + d;
      q = p[0];
      k = p[C];
      v = p[2 * C];
    }
    Qs[t * LDQ + d] = q;
    Ks[t * LDQ + d] = k;
    Vs[t * LDQ + d] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  {  // scores: warp rows [16*warp, 16*warp + 16) x all 64 keys
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[N / 16];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) wmma::fill_fragment(s[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < HDP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * LDQ + kk, LDQ);
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(s[j], a, kf, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < N / 16; ++j)
      wmma::store_matrix_sync(Ss + warp * 16 * LDSS + j * 16, s[j], LDSS,
                              wmma::mem_row_major);
  }
  __syncwarp();

  // stabilised softmax in f32 over the warp's own 16 rows; lane owns 2 keys
  const float* bh = bias + (size_t)h * N * N;
  const float* mw = mask != nullptr ? mask + (size_t)win * N * N : nullptr;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float x0 = Ss[r * LDSS + lane] * scale + bh[r * N + lane];
    float x1 = Ss[r * LDSS + lane + 32] * scale + bh[r * N + lane + 32];
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
    Ps[r * LDP + lane] = __float2bfloat16(e0 * inv);
    Ps[r * LDP + lane + 32] = __float2bfloat16(e1 * inv);
  }
  __syncthreads();   // every warp is done with q and k: Os may overwrite them

  {  // context: warp rows x HDP = P[16 x 64] @ V[64 x HDP]
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HDP / 16];
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) wmma::fill_fragment(o[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < N; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, Ps + warp * 16 * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < HDP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(o[j], a, vf, o[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j)
      wmma::store_matrix_sync(Os + warp * 16 * LDO + j * 16, o[j], LDO,
                              wmma::mem_row_major);
  }
  __syncwarp();

  for (int i = lane; i < 16 * hd; i += 32) {
    const int t = warp * 16 + i / hd, d = i % hd;
    ctx[token_row(b, wi, wj, t, H, W, shift) * C + h * hd + d] =
        __float2bfloat16(Os[t * LDO + d]);
  }
}

template <int HDP>
int launch(const void* qkv, void* ctx, const void* bias, const void* mask,
           int B, int H, int W, int C, int nh, int hd, int shift,
           cudaStream_t stream) {
  constexpr size_t bytes = Smem<HDP>::bytes;
  static bool configured = false;   // per template instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attention_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long blocks = (long long)B * (H / kWin) * (W / kWin) * nh;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  window_attention_kernel<HDP><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const __nv_bfloat16*)qkv, (__nv_bfloat16*)ctx, (const float*)bias,
      (const float*)mask, H, W, C, nh, hd, shift,
      (float)(1.0 / std::sqrt((double)hd)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int adsr_window_attention(const void* qkv, void* ctx,
                                     const void* bias, const void* mask, int B,
                                     int H, int W, int C, int nh, int win,
                                     int shift, void* stream) {
  if (win != kWin || H % kWin || W % kWin || nh <= 0 || C % nh || B < 0 ||
      shift < 0 || shift >= kWin || (shift > 0) != (mask != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int hd = C / nh;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return launch<16>(qkv, ctx, bias, mask, B, H, W, C, nh, hd, shift, s);
    case 2: return launch<32>(qkv, ctx, bias, mask, B, H, W, C, nh, hd, shift, s);
    case 3: return launch<48>(qkv, ctx, bias, mask, B, H, W, C, nh, hd, shift, s);
    case 4: return launch<64>(qkv, ctx, bias, mask, B, H, W, C, nh, hd, shift, s);
    case 5: return launch<80>(qkv, ctx, bias, mask, B, H, W, C, nh, hd, shift, s);
    case 6: return launch<96>(qkv, ctx, bias, mask, B, H, W, C, nh, hd, shift, s);
    case 7: return launch<112>(qkv, ctx, bias, mask, B, H, W, C, nh, hd, shift, s);
    case 8: return launch<128>(qkv, ctx, bias, mask, B, H, W, C, nh, hd, shift, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
