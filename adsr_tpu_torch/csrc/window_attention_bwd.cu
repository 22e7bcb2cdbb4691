// window_attention_bwd: backward of the shifted-window multi-head
// self-attention over 8x8 windows (window_attention.cu), from the raster
// qkv and the context's gradient (16x16 windows: window_attention_bwd16.cu).
//
//   S  = q k^T * scale + bias + mask,  P = softmax(S)   (recomputed)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dO o O)),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  d(bias) = sum of dS
//
// Replaces: the attention backward phases of the Pallas kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770): the per-(window, head)
// recompute of the probabilities and the gradient of q, k, v and of the
// additive attention term.
// Bound on H100: bytes. Each window reads 64 tokens x hd of q, k, v and dO
// once and writes 64 x hd of dq, dk, dv; the five 64-token products are
// ~100 flop per byte, below the bf16 ridge, so mma.sync is enough.
// Design: a block (4 warps, 16 query rows each) takes one head and a group
// of G consecutive (image, window)s (kernels/window_attention_bwd.py
// ``window_attention_bwd_plan`` picks G), in a fixed order:
//   - gather: the 16-byte pieces of the window's 64 qkv rows that hold the
//     head's q, k and v, and of its 64 dO rows, eight loads in flight a
//     thread, unpacked into bf16 planes [4][64][HDP + 8] (head dims zero-
//     padded to a multiple of 16); the cyclic shift is the forward's
//     raster-row arithmetic, so nothing is rolled or gathered in memory;
//   - each warp runs window_attn_bwd_core.cuh on its 16 query rows: S, the
//     stabilised f32 softmax, dP, dS and dQ in registers (no f32 score tile
//     in shared memory), P and dS once to bf16 tiles; after a barrier, its
//     16 key rows of dK = dS^T Q and then dV = P^T dO from the tiles;
//   - the three results go through the planes that are free by then and
//     back to dqkv in 16-byte stores (element stores where a piece is
//     shared with a neighbouring head), at dqkv's row stride;
//   - d(bias): each warp adds its dS into a register fragment that lives
//     across the group, and the block writes one f32 [64 x 64] partial per
//     (group, head) at the end; partials.cuh's column mode sums the groups'
//     partials in a fixed order (bitwise reproducible, no atomics), which
//     cuts the partial traffic by G against one partial per window.
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

constexpr int kWin = 8;
constexpr int N = kWin * kWin;     // tokens per window
constexpr int kThreads = 128;      // 4 warps x 16 query (and key) rows
constexpr int kBatch = 8;          // 16-byte loads in flight a thread
constexpr size_t kMaxSmem = 232448;

// Blocks an SM must hold by registers (168 a thread for head tiles up to
// 80, else 255): left alone, ptxas takes 220-255 registers at every tile
// and so holds two blocks an SM. A third block, at the cost of a few
// spilled bytes, measured faster an RDG on the H100 (PERF.md, from
// scripts/torch_attention_bwd_sweep.py); the plan
// (kernels/window_attention_bwd.py) sizes the grid to one wave of them.
constexpr int min_blocks(int hdp) { return hdp <= 80 ? 3 : 2; }

typedef __nv_bfloat16 bf16;

// Shared memory of one block: q, k, v, dO planes and the P, dS tiles
__host__ __device__ inline size_t smem_bytes(int hdp) {
  return (size_t)4 * N * (hdp + 8) * 2 + (size_t)2 * N * kBwdTileLd * 2;
}

// A thread's walk over the (token, piece) pairs i = threadIdx.x + j *
// kThreads of a window, i = token * chunks + piece, stepped without a
// division (the same pairs for every window of the group).
struct Walk {
  int t, k, dt, dk, chunks;

  __device__ Walk(int chunks_) : chunks(chunks_) {
    t = threadIdx.x / chunks;
    k = threadIdx.x - t * chunks;
    dt = kThreads / chunks;
    dk = kThreads - dt * chunks;
  }
  __device__ __forceinline__ void step() {
    t += dt;
    k += dk;
    if (k >= chunks) {
      k -= chunks;
      ++t;
    }
  }
};

// The raster row of token t of the block's current window: the cyclic
// shift wraps at most once (a window starts below H - 7 and shift < 8).
struct WindowRows {
  long long img;
  int row0, col0, H, W;

  __device__ __forceinline__ long long operator()(int t) const {
    int r = row0 + (t >> 3), c = col0 + (t & 7);
    r -= r >= H ? H : 0;
    c -= c >= W ? W : 0;
    return img + (long long)r * W + c;
  }
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, min_blocks(HDP))
window_attention_bwd_kernel(const bf16* __restrict__ qkv, long long ldq,
                            const bf16* __restrict__ dctx, long long ldg,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            bf16* __restrict__ dqkv, long long ldd,
                            float* __restrict__ part, int windows, int group,
                            int H, int W, int C, int nh, int hd, int shift,
                            float scale) {
  constexpr int LD = HDP + 8;
  constexpr int kPlane = N * LD;          // elements of one plane
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* planes = reinterpret_cast<bf16*>(smem);   // q, k, v, dO
  const uint32_t sp = (uint32_t)__cvta_generic_to_shared(planes);
  const uint32_t sq = sp, sk = sp + 2u * kPlane, sv = sp + 4u * kPlane,
                 sg = sp + 6u * kPlane;
  const uint32_t tp = sp + 8u * kPlane;                  // P tile
  const uint32_t tds = tp + 2u * N * kBwdTileLd;         // dS tile

  const int h = blockIdx.x % nh;
  const int grp = blockIdx.x / nh;
  const int w_end = min(windows, (grp + 1) * group);
  const int nww = W / kWin;
  const int nw = (H / kWin) * nww;
  const int C3 = 3 * C;
  const Parts pc(h, hd, C);
  const int chunks = pc.begin[4];
  const int total = N * chunks;

  if (HDP > hd) {                         // the padded head dims are zero
    const int pad = HDP - hd;
    for (int i = threadIdx.x; i < 4 * N * pad; i += kThreads) {
      const int row = i / pad;            // (plane, token)
      planes[row * LD + hd + (i - row * pad)] = __float2bfloat16(0.f);
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp, g = lane >> 2, tq = lane & 3;
  float dbias[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dbias[j][i] = 0.f;

  const Walk start(chunks);
  for (int wg = grp * group; wg < w_end; ++wg) {
    const int b = wg / nw, win = wg % nw;
    const int wi = win / nww, wj = win % nww;
    const WindowRows rows{(long long)b * H * W, wi * kWin + shift,
                          wj * kWin + shift, H, W};

    // gather the head's q, k, v and dO of the window's 64 tokens
    Walk it = start;
    for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
      uint4 v[kBatch];
      int dst[kBatch], j0[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (base + j * kThreads < total) {
          const int p = pc.part(it.k);
          const int c0 = pc.first(it.k, p);
          const long long row = rows(it.t);
          const bf16* src = p < 3 ? qkv + row * ldq + c0
                                  : dctx + row * ldg + c0;
          if (c0 + 8 <= (p < 3 ? C3 : C)) {
            v[j] = __ldg(reinterpret_cast<const uint4*>(src));
          } else {                        // 4 columns at the end of a row
            const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
            v[j] = make_uint4(u.x, u.y, 0u, 0u);
          }
          dst[j] = p * kPlane + it.t * LD;
          j0[j] = c0 - Parts::pick(pc.start, p);
          it.step();
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (base + j * kThreads < total) put8(planes + dst[j], j0[j], hd, v[j]);
    }
    __syncthreads();

    float acc[HDP / 8][4];
    attn_bwd_rows<HDP>(sq, sk, sv, sg, LD, tp, tds, r0,
                       bias + (size_t)h * N * N,
                       mask != nullptr ? mask + (size_t)win * N * N : nullptr,
                       scale, dbias, acc);
    __syncthreads();   // the tiles are whole; nothing reads k or v again

    // the results of part p go over plane (p + 1) % 3, each free when it is
    // written: dQ * scale over this warp's query rows of the k plane, then
    // its key rows of dK * scale over the v plane; dV waits in registers
    // until every warp is done with q and dO
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      if (which > 0)
        tile_t_times<HDP>(which == 1 ? tds : tp, which == 1 ? sq : sg, LD,
                          r0, acc);
      if (which == 2) __syncthreads();
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
    __syncthreads();

    // dq, dk, dv: columns [start_p, start_p + hd) of part p of each row
    Walk ot(pc.begin[3]);
    for (int i = threadIdx.x; i < N * pc.begin[3]; i += kThreads, ot.step()) {
      const int p = pc.part(ot.k);
      const int c0 = pc.first(ot.k, p);
      const int s0 = Parts::pick(pc.start, p);
      const int n = min(8, C3 - c0);      // 4 at the end of a row 4 past 8
      const bf16* src = planes + (p + 1) % 3 * kPlane + ot.t * LD;
      bf16* dst = dqkv + rows(ot.t) * ldd + c0;
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
    __syncthreads();   // the next window's gather overwrites the planes
  }

  // this block's d(bias) partial: row (group, head) of [groups * nh][64 x 64]
  float* pr = part + ((size_t)grp * nh + h) * N * N + (r0 + g) * N + 2 * tq;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(pr + 8 * j) =
        make_float2(dbias[j][0], dbias[j][1]);
    *reinterpret_cast<float2*>(pr + 8 * N + 8 * j) =
        make_float2(dbias[j][2], dbias[j][3]);
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
        window_attention_bwd_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  const long long windows = (long long)B * (H / kWin) * (W / kWin);
  const long long groups = (windows + group - 1) / group;
  if (windows > 0x7fffffffll || groups * nh > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  window_attention_bwd_kernel<HDP>
      <<<(unsigned)(groups * nh), kThreads, bytes, stream>>>(
          (const bf16*)qkv, ldq, (const bf16*)dctx, ldg, (const float*)bias,
          (const float*)mask, (bf16*)dqkv, ldd, (float*)part, (int)windows,
          group, H, W, C, nh, hd, shift,
          (float)(1.0 / std::sqrt((double)hd)));
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  // d(bias)[i] = sum over the groups of part[group][i], i < nh * 64 * 64
  return sum_partials(nullptr, 0, 0, nullptr, 0, nullptr, stream,
                      (const float*)part, (int)groups, nh * N * N,
                      (float*)dbias);
}

}  // namespace

// ``group`` windows a block and ``smem`` are what the caller planned
// (kernels/window_attention_bwd.py ``window_attention_bwd_plan``); a launch
// whose shared memory differs from this file's layout is refused. ``part``
// holds ceil(windows / group) * nh * 64 * 64 f32.
extern "C" int adsr_window_attention_bwd(const void* qkv, long long ldq,
                                         const void* dctx, long long ldg,
                                         const void* bias, const void* mask,
                                         void* dqkv, long long ldd,
                                         void* part, void* dbias, int B,
                                         int H, int W, int C, int nh, int win,
                                         int shift, int group, long long smem,
                                         void* stream) {
  if (win != kWin || H % kWin || W % kWin || nh <= 0 || C % nh || C % 4 ||
      B < 0 || shift < 0 || shift >= kWin ||
      (shift > 0) != (mask != nullptr) || group < 1 || ldq % 8 || ldg % 8 ||
      ldd % 8 || ldq < 3ll * C || ldg < C || ldd < 3ll * C ||
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
