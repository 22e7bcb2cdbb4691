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
// Bound on H100: bytes. Each window reads 16 tokens x hd of q, k, v and dO
// once and writes 16 x hd of dq, dk, dv; the five 16-token products are
// ~25 flop per byte.
// Design: as the forward, a window is one 16-row mma tile and one warp
// holds it whole, so a window's dQ, dK and dV lie inside one warp with no
// cross-warp sum. A block (4 warps) takes one head and a group of ``group``
// consecutive windows over the flat (image, window) index
// (kernels/window_attention_bwd.py ``window_attention_bwd_plan``: a
// multiple of 4, the last group possibly short), four at a time:
//   - gather: the 16-byte pieces of the four windows' 64 qkv rows that hold
//     the head's q, k and v, and of their dO rows, eight loads in flight a
//     thread, into bf16 planes [4][64][HDP + 8] (rows of windows past the
//     last are neither read nor written);
//   - each warp runs window_attn_bwd_core.cuh's attn_bwd_rows<HDP, 16> on
//     its window (N = 64's numerics: P recomputed from S by the stabilised
//     f32 softmax, D = rowsum(P o dP), P and dS rounded once to bf16 before
//     the three output products), keeping its P and dS as [16][24] bf16
//     tiles of its own, then dK = dS^T Q and dV = P^T dO from them
//     (tile_t_times<HDP, 16>), each result over a plane row of its own
//     window that it no longer reads;
//   - the three results go back to dqkv in 16-byte stores (element stores
//     where a piece is shared with a neighbouring head);
//   - d(bias): each warp adds its windows' dS into a register fragment; at
//     the end the four warps' fragments are summed in warp order through
//     shared memory into one f32 [16 x 16] partial per (group, head), and
//     partials.cuh sums the groups' partials in a fixed order: two calls
//     are bitwise equal (no atomics).
// No state survives a launch and nothing is allocated here, so a CUDA graph
// can replay it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "partials.cuh"
#include "window_attn_bwd_core.cuh"
#include "window_tiles.cuh"   // Parts, put8, get8

namespace {

constexpr int kWin = 4;
constexpr int N = kWin * kWin;     // tokens per window
constexpr int kQuad = 4;           // windows a step: one a warp
constexpr int kRows = kQuad * N;   // token rows a step
constexpr int kThreads = 32 * kQuad;
constexpr int kTileLd = bwd_tile_ld(N);
constexpr int kBatch = 8;          // 16-byte loads in flight a thread
constexpr size_t kMaxSmem = 232448;

// Blocks an SM must hold by registers (128 a thread up to a head tile of
// 80, else 168); the plan sizes the grid to one wave of them.
constexpr int min_blocks(int hdp) { return hdp <= 80 ? 4 : 3; }

typedef __nv_bfloat16 bf16;

// Shared memory of one block: q, k, v, dO planes of 64 rows and the P, dS
// tiles of 64 rows (each warp its window's 16); at the end the warps'
// d(bias) fragments [4][16][16] f32 over the tiles
__host__ __device__ inline size_t smem_bytes(int hdp) {
  return (size_t)4 * kRows * (hdp + 8) * 2 + (size_t)2 * kRows * kTileLd * 2;
}
static_assert(2 * kRows * kTileLd * 2 >= kQuad * N * N * 4,
              "the d(bias) fragments fit over the tiles");

// The raster row of row t of the step whose first window is ``fw0`` (window
// fw0 + t / 16, token t % 16), or -1 past the last window
__device__ __forceinline__ long long token_row(int fw0, int t, int windows,
                                               int nw, int nww, int H, int W,
                                               int shift) {
  const int fw = fw0 + t / N;
  if (fw >= windows) return -1;
  const int b = fw / nw, win = fw - b * nw;
  const int wi = win / nww, wj = win - wi * nww;
  const int tt = t % N;
  const int row = (wi * kWin + tt / kWin + shift) % H;
  const int col = (wj * kWin + tt % kWin + shift) % W;
  return (long long)b * H * W + (long long)row * W + col;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, min_blocks(HDP))
window_attention_bwd4_kernel(const bf16* __restrict__ qkv, long long ldq,
                             const bf16* __restrict__ dctx, long long ldg,
                             const float* __restrict__ bias,
                             const float* __restrict__ mask,
                             bf16* __restrict__ dqkv, long long ldd,
                             float* __restrict__ part, int windows,
                             int group, int H, int W, int C, int nh, int hd,
                             int shift, float scale) {
  constexpr int LD = HDP + 8;
  constexpr int kPlane = kRows * LD;      // elements of one plane
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* planes = reinterpret_cast<bf16*>(smem);   // q, k, v, dO
  const uint32_t sp = (uint32_t)__cvta_generic_to_shared(planes);
  const uint32_t tp = sp + 8u * kPlane;                  // P tiles
  const uint32_t tds = tp + 2u * kRows * kTileLd;        // dS tiles

  const int h = blockIdx.x % nh;
  const int grp = blockIdx.x / nh;
  const int w_end = min(windows, (grp + 1) * group);
  const int nww = W / kWin;
  const int nw = (H / kWin) * nww;
  const int C3 = 3 * C;
  const Parts pc(h, hd, C);
  const int chunks = pc.begin[4];
  const int total = kRows * chunks;

  if (HDP > hd) {                         // the padded head dims are zero
    const int pad = HDP - hd;
    for (int i = threadIdx.x; i < 4 * kRows * pad; i += kThreads) {
      const int row = i / pad;            // (plane, token)
      planes[row * LD + hd + (i - row * pad)] = __float2bfloat16(0.f);
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = N * warp, g = lane >> 2, tq = lane & 3;
  // this warp's window rows in the planes and the tiles (byte offsets)
  const uint32_t prow = 2u * r0 * LD, trow = 2u * r0 * kTileLd;
  float dbias[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dbias[j][i] = 0.f;

  for (int fw0 = grp * group; fw0 < w_end; fw0 += kQuad) {
    // gather the head's q, k, v and dO of the four windows' 64 tokens
    for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
      uint4 v[kBatch];
      int dst[kBatch], j0[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads;
        dst[j] = -1;
        if (i < total) {
          const int t = i / chunks, k = i - t * chunks;
          const long long row = token_row(fw0, t, w_end, nw, nww, H, W,
                                          shift);
          if (row >= 0) {
            const int p = pc.part(k);
            const int c0 = pc.first(k, p);
            const bf16* src = p < 3 ? qkv + row * ldq + c0
                                    : dctx + row * ldg + c0;
            if (c0 + 8 <= (p < 3 ? C3 : C)) {
              v[j] = __ldg(reinterpret_cast<const uint4*>(src));
            } else {                      // 4 columns at the end of a row
              const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
              v[j] = make_uint4(u.x, u.y, 0u, 0u);
            }
            dst[j] = p * kPlane + t * LD;
            j0[j] = c0 - Parts::pick(pc.start, p);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (dst[j] >= 0) put8(planes + dst[j], j0[j], hd, v[j]);
    }
    __syncthreads();

    const int fw = fw0 + warp;
    if (fw < w_end) {
      const int win = fw % nw;
      const uint32_t sq = sp + prow, sk = sq + 2u * kPlane,
                     sv = sq + 4u * kPlane, sg = sq + 6u * kPlane;
      float acc[HDP / 8][4];
      attn_bwd_rows<HDP, N>(sq, sk, sv, sg, LD, tp + trow, tds + trow, 0,
                            bias + (size_t)h * N * N,
                            mask != nullptr ? mask + (size_t)win * N * N
                                            : nullptr,
                            scale, dbias, acc);
      __syncwarp();   // the warp's P and dS tiles are whole
      // the results of part p go over plane (p + 1) % 3 of the warp's own
      // rows, each free when it is written: dQ * scale over k (read last
      // by dQ), dK * scale over v (read last by dP), dV over q (read last
      // by dK)
#pragma unroll
      for (int which = 0; which < 3; ++which) {
        if (which > 0) {
          tile_t_times<HDP, N>(which == 1 ? tds + trow : tp + trow,
                               which == 1 ? sq : sg, LD, 0, acc);
          __syncwarp();   // every lane's reads of q are done (dV over q)
        }
        const float mul = which < 2 ? scale : 1.f;
        bf16* o = planes + (which + 1) % 3 * kPlane + (r0 + g) * LD;
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          const int d = 8 * j + 2 * tq;
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            if (d + x < hd) {
              o[d + x] = __float2bfloat16(acc[j][x] * mul);
              o[8 * LD + d + x] = __float2bfloat16(acc[j][2 + x] * mul);
            }
          }
        }
      }
    }
    __syncthreads();

    // dq, dk, dv: columns [start_p, start_p + hd) of part p of each live row
    const int pieces = pc.begin[3];
    for (int i = threadIdx.x; i < kRows * pieces; i += kThreads) {
      const int t = i / pieces, k = i - t * pieces;
      const long long row = token_row(fw0, t, w_end, nw, nww, H, W, shift);
      if (row < 0) continue;
      const int p = pc.part(k);
      const int c0 = pc.first(k, p);
      const int s0 = Parts::pick(pc.start, p);
      const int n = min(8, C3 - c0);      // 4 at the end of a row 4 past 8
      const bf16* src = planes + (p + 1) % 3 * kPlane + t * LD;
      bf16* dst = dqkv + row * ldd + c0;
      if (c0 >= s0 && c0 + n <= s0 + hd) {
        const uint4 v = get8(src, c0 - s0, n);
        if (n == 8)
          *reinterpret_cast<uint4*>(dst) = v;
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y);
      } else {                            // a piece shared with a neighbour
#pragma unroll
        for (int x = 0; x < 8; ++x)
          if (x < n && c0 + x >= s0 && c0 + x < s0 + hd)
            dst[x] = src[c0 - s0 + x];
      }
    }
    __syncthreads();   // the next step's gather overwrites the planes
  }

  // this block's d(bias) partial, row (group, head) of [groups * nh][16 x
  // 16]: the four warps' fragments over the tiles, summed in warp order
  float* frag = reinterpret_cast<float*>(smem + 2u * 4u * kPlane);
  float* mine = frag + warp * N * N + g * N + 2 * tq;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    *reinterpret_cast<float2*>(mine + 8 * j) =
        make_float2(dbias[j][0], dbias[j][1]);
    *reinterpret_cast<float2*>(mine + 8 * N + 8 * j) =
        make_float2(dbias[j][2], dbias[j][3]);
  }
  __syncthreads();
  float* pr = part + ((size_t)grp * nh + h) * N * N;
  for (int i = threadIdx.x; i < N * N; i += kThreads) {
    float sum = frag[i];
#pragma unroll
    for (int w = 1; w < kQuad; ++w) sum += frag[w * N * N + i];
    pr[i] = sum;
  }
}

template <int HDP>
int launch(const void* qkv, long long ldq, const void* dctx, long long ldg,
           const void* bias, const void* mask, void* dqkv, long long ldd,
           void* part, void* dbias, int B, int H, int W, int C, int nh,
           int hd, int shift, int group, long long smem,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(HDP);
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
  const long long windows = (long long)B * (H / kWin) * (W / kWin);
  const long long groups = (windows + group - 1) / group;
  if (windows > 0x7fffffffll || groups * nh > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  window_attention_bwd4_kernel<HDP>
      <<<(unsigned)(groups * nh), kThreads, bytes, stream>>>(
          (const bf16*)qkv, ldq, (const bf16*)dctx, ldg, (const float*)bias,
          (const float*)mask, (bf16*)dqkv, ldd, (float*)part, (int)windows,
          group, H, W, C, nh, hd, shift,
          (float)(1.0 / std::sqrt((double)hd)));
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  // d(bias)[i] = sum over the groups of part[group][i], i < nh * 16 * 16
  return sum_partials(nullptr, 0, 0, nullptr, 0, nullptr, stream,
                      (const float*)part, (int)groups, nh * N * N,
                      (float*)dbias);
}

}  // namespace

// ``group`` (windows a block, a multiple of 4) and ``smem`` are what the
// caller planned (kernels/window_attention_bwd.py
// ``window_attention_bwd_plan``); a launch whose shared memory differs from
// this file's layout is refused. ``part`` holds ceil(windows / group) * nh
// * 16 * 16 f32.
extern "C" int adsr_window_attention_bwd4(const void* qkv, long long ldq,
                                          const void* dctx, long long ldg,
                                          const void* bias, const void* mask,
                                          void* dqkv, long long ldd,
                                          void* part, void* dbias, int B,
                                          int H, int W, int C, int nh,
                                          int shift, int group,
                                          long long smem, void* stream) {
  if (H % kWin || W % kWin || nh <= 0 || C % nh || C % 4 || B < 0 ||
      shift < 0 || shift >= kWin || (shift > 0) != (mask != nullptr) ||
      group < kQuad || group % kQuad || ldq % 8 || ldg % 8 || ldd % 8 ||
      ldq < 3ll * C || ldg < C || ldd < 3ll * C ||
      reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(dctx) % 16 ||
      reinterpret_cast<uintptr_t>(dqkv) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int hd = C / nh;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return launch<16>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, B, H, W, C, nh, hd, shift, group, smem, s);
    case 2: return launch<32>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, B, H, W, C, nh, hd, shift, group, smem, s);
    case 3: return launch<48>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, B, H, W, C, nh, hd, shift, group, smem, s);
    case 4: return launch<64>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, B, H, W, C, nh, hd, shift, group, smem, s);
    case 5: return launch<80>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, B, H, W, C, nh, hd, shift, group, smem, s);
    case 6: return launch<96>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, B, H, W, C, nh, hd, shift, group, smem, s);
    case 7: return launch<112>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, B, H, W, C, nh, hd, shift, group, smem, s);
    case 8: return launch<128>(qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, B, H, W, C, nh, hd, shift, group, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
