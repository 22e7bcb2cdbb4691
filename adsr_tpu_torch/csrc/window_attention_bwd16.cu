// window_attention_bwd at 16x16 windows (N = 256 tokens): the backward of
// window_attention.cu's N = 256 kernel, kernel (f)'s second geometry (the
// 8x8 one is window_attention_bwd.cu).
//
// Replaces: the attention backward phases of the Pallas kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770) at L = 4096 (_bwd_split :860).
// Bound on H100: bytes (q, k, v, dO read and dq, dk, dv written once), but
// the products and the f32 bias and mask of 256 x 256 a (window, head) are
// several times the bytes of the 64-token kernel a token.
//
// Design: FlashAttention-2's deterministic backward in two launches on
// tiles of 64 tokens (window_tiles.cuh), then the partial sums of d(bias):
//   1. dq: a block per (image, window, head, tile of 64 query rows) keeps
//      its Q and dO tiles and one 64-key K and V tile ([4][64][HDP + 8]
//      bf16), with cp.async staging the next K and V tiles during the
//      products (as kernel (c) at N = 256), and walks the four key tiles
//      twice: first each row's max m, sum l of exp(S - m) and D =
//      rowsum(P o dP) (dP = dO V^T; the two
//      sums in f32, rescaled as the max grows, as the online softmax of
//      FlashAttention-2; D the N = 64 kernel's rowsum(P o dP) in another
//      order); then P = exp(S - m) / l, dS = P o (dP - D) once to bf16 and
//      dQ += dS K. It writes dq and each row's (m, 1 / l, D) as a float4.
//   2. dkv: a block per (group of G windows, head, tile of 64 keys) keeps
//      its K and V tiles, and walks the four query tiles of each window of
//      its group with their rows' (max, 1 / sum, D): each warp's 16 keys
//      take S^T = K Q^T, P^T, dP^T = V dO^T, dS^T = P^T o (dP^T - D) in
//      registers, dV += P^T dO and dK += dS^T Q with P^T and dS^T once to
//      bf16 as the A operands straight from registers (the C layout of S^T
//      is the A layout of the next product). dS^T adds into an f32 [256
//      queries][64 keys] d(bias) accumulator in shared memory, each warp
//      its own key columns; the block writes it once as its columns of a
//      [nh][256][256] partial per group. It reads bias and mask transposed
//      (the wrapper's [key][query] copies), so the key rows of S^T take the
//      forward's 8-byte loads (add_bias). Where it costs no block an SM
//      (dkv_staged), cp.async stages the next Q and dO tiles during the
//      products.
//   3. partials.cuh sums the groups' partials in a fixed order.
// No atomics: two runs are bitwise equal. G (the plan's) keeps the
// partials at most 32 MiB a call. The numerics are the N = 64 kernel's: f32
// softmax, D and dS, P and dS rounded once to bf16 before the products,
// f32 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "partials.cuh"
#include "window_attn_core.cuh"
#include "window_tiles.cuh"

namespace {

constexpr int kThreads = 128;      // 4 warps x 16 query (or key) rows
constexpr size_t kMaxSmem = 232448;

typedef __nv_bfloat16 bf16;

constexpr int kWin16 = 16;
constexpr int N16 = kWin16 * kWin16;
constexpr int kKeyTiles = N16 / kTileRows;
constexpr int kAccLd = kTileRows + 4;   // f32 pitch of the d(bias) tile

// Shared memory of a block: dq, the Q, dO, K, V tiles and the staging of
// the next K and V tiles; dkv, the K, V, Q, dO tiles, the f32 d(bias) tile
// and the Q tile's row statistics
__host__ __device__ inline size_t smem_dq16(int hdp) {
  return (size_t)4 * kTileRows * (hdp + 8) * 2
         + (size_t)2 * stage_slots(hdp) * 16;
}
__host__ __device__ constexpr size_t smem_dkv16(int hdp, bool staged) {
  return (size_t)4 * kTileRows * (hdp + 8) * 2 + (size_t)N16 * kAccLd * 4
         + kTileRows * 16 + (staged ? (size_t)2 * stage_slots(hdp) * 16 : 0);
}

// The dkv blocks an SM holds: by shared memory, and at most 2 (ptxas gives
// the kernel up to 255 registers a thread)
__host__ __device__ constexpr int dkv_blocks_per_sm(size_t bytes) {
  return 233472 / (int)(bytes + 1024) < 2 ? 233472 / (int)(bytes + 1024) : 2;
}

// dkv stages the next Q and dO tiles by cp.async wherever that costs no
// block an SM (every head tile but 64 and 80, whose unstaged blocks just
// fit two to an SM); kernels/window_attention_bwd.py plans the same
__host__ __device__ constexpr bool dkv_staged(int hdp) {
  return dkv_blocks_per_sm(smem_dkv16(hdp, true))
         == dkv_blocks_per_sm(smem_dkv16(hdp, false));
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd16_dq_kernel(const bf16* __restrict__ qkv, long long ldq,
                                 const bf16* __restrict__ dctx, long long ldg,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ mask,
                                 bf16* __restrict__ dqkv, long long ldd,
                                 float4* __restrict__ stats, int H, int W,
                                 int C, int nh, int hd, int shift,
                                 float scale) {
  constexpr int LD = HDP + 8;
  constexpr int kPlane = kTileRows * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* pq = reinterpret_cast<bf16*>(smem);      // Q, dO, K, V tiles
  bf16* pg = pq + kPlane;
  bf16* pk = pq + 2 * kPlane;
  bf16* pv = pq + 3 * kPlane;
  const uint32_t sq = (uint32_t)__cvta_generic_to_shared(pq);
  const uint32_t sg = sq + 2u * kPlane, sk = sq + 4u * kPlane,
                 sv = sq + 6u * kPlane, ldb = 2u * LD;

  const int nww = W / kWin16;
  const int nw = (H / kWin16) * nww;
  const int qt = blockIdx.x % kKeyTiles;
  const int h = (blockIdx.x / kKeyTiles) % nh;
  const int wg = blockIdx.x / (kKeyTiles * nh);   // image * nw + window
  const int win = wg % nw, wi = win / nww, wj = win % nww;
  const int C3 = 3 * C, s0 = h * hd;
  const WinRows<kWin16> rows{(long long)(wg / nw) * H * W,
                             wi * kWin16 + shift, wj * kWin16 + shift, H, W};

  // staging for the next K and V tiles' raw pieces (cp.async)
  const uint4* stk = reinterpret_cast<const uint4*>(pq + 4 * kPlane);
  const uint4* stv = stk + stage_slots(HDP);
  const uint32_t ssk = sq + 8u * kPlane, ssv = ssk + 16u * stage_slots(HDP);
  auto stage_kv = [&](int kt) {
    stage_tile<kWin16>(ssk, qkv, ldq, C3, s0 + C, hd, rows, kt * kTileRows);
    stage_tile<kWin16>(ssv, qkv, ldq, C3, s0 + 2 * C, hd, rows,
                       kt * kTileRows);
    stage_commit();
  };
  // tile kt staged and every warp done with the last one: into the planes
  auto next_kv = [&]() {
    stage_wait_all();
    __syncthreads();
    unpack_tile(pk, LD, stk, s0 + C, hd);
    unpack_tile(pv, LD, stv, s0 + 2 * C, hd);
    __syncthreads();
  };
  stage_kv(0);
  zero_pad<HDP>(pq, 4 * kTileRows, hd);
  load_tile<kWin16>(pq, LD, qkv, ldq, C3, s0, hd, rows, qt * kTileRows);
  load_tile<kWin16>(pg, LD, dctx, ldg, C, s0, hd, rows, qt * kTileRows);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp, g = lane >> 2, tq = lane & 3;
  const size_t q0 = (size_t)qt * kTileRows + r0;
  const float* bias_r = bias + ((size_t)h * N16 + q0) * N16;
  const float* mask_r =
      mask != nullptr ? mask + ((size_t)win * N16 + q0) * N16 : nullptr;
  auto scores = [&](int kt, float (&s)[8][4]) {
    qk_tile<HDP>(sq, sk, ldb, r0, s);
    add_bias<N16>(s, bias_r + kt * kTileRows,
                  mask_r != nullptr ? mask_r + kt * kTileRows : nullptr,
                  scale);
  };

  // sweep 1 (K and V tiles 0..3): each row's max m, sum l of exp(S - m)
  // and D = rowsum(P o dP) = rowsum(exp(S - m) o dP) / l, the sums rescaled
  // by exp(m_old - m) as m grows
  float mx0 = -INFINITY, mx1 = -INFINITY, sum0 = 0.f, sum1 = 0.f;
  float d0 = 0.f, d1 = 0.f;
  float s[8][4], dp[8][4];
  for (int kt = 0; kt < kKeyTiles; ++kt) {
    next_kv();
    // then tiles 1, 2, 3 and, for sweep 2 (tile 3 stays), tile 2
    stage_kv(kt + 1 < kKeyTiles ? kt + 1 : kKeyTiles - 2);
    scores(kt, s);
    qk_tile<HDP>(sg, sv, ldb, r0, dp);
    float t0 = mx0, t1 = mx1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
      t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, sh));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, sh));
    }
    float e0 = 0.f, e1 = 0.f, f0 = 0.f, f1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x0 = expf(s[j][0] - t0), x1 = expf(s[j][1] - t0);
      const float x2 = expf(s[j][2] - t1), x3 = expf(s[j][3] - t1);
      e0 += x0 + x1;
      e1 += x2 + x3;
      f0 += x0 * dp[j][0] + x1 * dp[j][1];
      f1 += x2 * dp[j][2] + x3 * dp[j][3];
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      e0 += __shfl_xor_sync(0xffffffffu, e0, sh);
      e1 += __shfl_xor_sync(0xffffffffu, e1, sh);
      f0 += __shfl_xor_sync(0xffffffffu, f0, sh);
      f1 += __shfl_xor_sync(0xffffffffu, f1, sh);
    }
    const float a0 = expf(mx0 - t0), a1 = expf(mx1 - t1);  // 0 at tile 0
    sum0 = sum0 * a0 + e0;
    sum1 = sum1 * a1 + e1;
    d0 = d0 * a0 + f0;
    d1 = d1 * a1 + f1;
    mx0 = t0;
    mx1 = t1;
  }
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  d0 *= inv0;
  d1 *= inv1;

  // sweep 2 (K and V tiles 3..0; tile 3 is in place): dS = P o (dP - D)
  // with P = exp(S - m) / l, dQ += dS K
  float dq[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[j][i] = 0.f;
  for (int kt = kKeyTiles - 1; kt >= 0; --kt) {
    if (kt != kKeyTiles - 1) {
      next_kv();
      if (kt > 0) stage_kv(kt - 1);
    }
    scores(kt, s);
    qk_tile<HDP>(sg, sv, ldb, r0, dp);
    uint32_t ds[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = expf(s[j][0] - mx0) * inv0;
      const float p1 = expf(s[j][1] - mx0) * inv0;
      const float p2 = expf(s[j][2] - mx1) * inv1;
      const float p3 = expf(s[j][3] - mx1) * inv1;
      ds[j][0] = pack_bf16x2(p0 * (dp[j][0] - d0), p1 * (dp[j][1] - d0));
      ds[j][1] = pack_bf16x2(p2 * (dp[j][2] - d1), p3 * (dp[j][3] - d1));
    }
    pv_tile<HDP>(ds, sk, ldb, dq);
  }

  // each row's (max, 1 / sum, D) for the dkv launch
  if (tq == 0) {
    float4* st = stats + ((size_t)wg * nh + h) * N16 + q0 + g;
    st[0] = make_float4(mx0, inv0, d0, 0.f);
    st[8] = make_float4(mx1, inv1, d1, 0.f);
  }
  // dQ * scale over this warp's own rows of the Q tile, then to dqkv
  bf16* o = pq + (r0 + g) * LD;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * tq;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (d + x < hd) {
        o[d + x] = __float2bfloat16(dq[j][x] * scale);
        o[8 * LD + d + x] = __float2bfloat16(dq[j][2 + x] * scale);
      }
    }
  }
  __syncthreads();
  store_tile<kWin16>(pq, LD, dqkv, ldd, C3, s0, hd, rows, qt * kTileRows);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
window_attention_bwd16_dkv_kernel(const bf16* __restrict__ qkv, long long ldq,
                                  const bf16* __restrict__ dctx, long long ldg,
                                  const float* __restrict__ bias_t,
                                  const float* __restrict__ mask_t,
                                  bf16* __restrict__ dqkv, long long ldd,
                                  const float4* __restrict__ stats,
                                  float* __restrict__ part, int windows,
                                  int group, int H, int W, int C, int nh,
                                  int hd, int shift, float scale) {
  constexpr int LD = HDP + 8;
  constexpr int kPlane = kTileRows * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* pk = reinterpret_cast<bf16*>(smem);      // K, V, Q, dO tiles
  bf16* pv = pk + kPlane;
  bf16* pq = pk + 2 * kPlane;
  bf16* pg = pk + 3 * kPlane;
  float* acc = reinterpret_cast<float*>(pk + 4 * kPlane);   // [256][68]
  float4* st = reinterpret_cast<float4*>(acc + N16 * kAccLd);   // [64]
  const uint32_t sk = (uint32_t)__cvta_generic_to_shared(pk);
  const uint32_t sv = sk + 2u * kPlane, sq = sk + 4u * kPlane,
                 sg = sk + 6u * kPlane, ldb = 2u * LD;
  // the staging of the next Q and dO tiles (staged instances only)
  constexpr bool kStaged = dkv_staged(HDP);
  const uint4* stq = reinterpret_cast<const uint4*>(st + kTileRows);
  const uint4* stg = stq + stage_slots(HDP);
  const uint32_t ssq = (uint32_t)__cvta_generic_to_shared(stq);
  const uint32_t ssg = ssq + 16u * stage_slots(HDP);

  const int kt = blockIdx.x % kKeyTiles;
  const int h = (blockIdx.x / kKeyTiles) % nh;
  const int grp = blockIdx.x / (kKeyTiles * nh);
  const int w_end = min(windows, (grp + 1) * group);
  const int nww = W / kWin16;
  const int nw = (H / kWin16) * nww;
  const int C3 = 3 * C, s0 = h * hd;
  auto window_rows = [&](int wg) {
    const int win = wg % nw;
    return WinRows<kWin16>{(long long)(wg / nw) * H * W,
                           win / nww * kWin16 + shift,
                           win % nww * kWin16 + shift, H, W};
  };
  auto stage_qg = [&](int wg, int qt) {   // Q and dO of (window, query tile)
    const WinRows<kWin16> rows = window_rows(wg);
    stage_tile<kWin16>(ssq, qkv, ldq, C3, s0, hd, rows, qt * kTileRows);
    stage_tile<kWin16>(ssg, dctx, ldg, C, s0, hd, rows, qt * kTileRows);
    stage_commit();
  };
  if (kStaged && grp * group < w_end) stage_qg(grp * group, 0);

  zero_pad<HDP>(pk, 4 * kTileRows, hd);
  for (int i = threadIdx.x; i < N16 * kAccLd; i += kThreads) acc[i] = 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp, g = lane >> 2, tq = lane & 3;
  // S^T's rows are keys: the transposed bias and mask [key][query] give
  // them add_bias's 8-byte row loads (the mask of the window's shift is
  // symmetric, but a caller's need not be)
  const float* bias_r =
      bias_t + ((size_t)h * N16 + kt * kTileRows + r0) * N16;

  float dk[HDP / 8][4], dv[HDP / 8][4];
  for (int wg = grp * group; wg < w_end; ++wg) {
    const int win = wg % nw;
    const WinRows<kWin16> rows = window_rows(wg);
    const float* mask_r =
        mask_t != nullptr
            ? mask_t + ((size_t)win * N16 + kt * kTileRows + r0) * N16
            : nullptr;
    __syncthreads();        // the last window's stores have read K and V
    load_tile<kWin16>(pk, LD, qkv, ldq, C3, s0 + C, hd, rows,
                      kt * kTileRows);
    load_tile<kWin16>(pv, LD, qkv, ldq, C3, s0 + 2 * C, hd, rows,
                      kt * kTileRows);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

    for (int qt = 0; qt < kKeyTiles; ++qt) {
      if (kStaged) {
        stage_wait_all();
        __syncthreads();     // staged; nobody reads the last Q, dO tiles
        unpack_tile(pq, LD, stq, s0, hd);
        unpack_tile(pg, LD, stg, s0, hd);
      } else {
        if (qt > 0) __syncthreads();   // nobody reads the last Q, dO tiles
        load_tile<kWin16>(pq, LD, qkv, ldq, C3, s0, hd, rows,
                          qt * kTileRows);
        load_tile<kWin16>(pg, LD, dctx, ldg, C, s0, hd, rows,
                          qt * kTileRows);
      }
      if (threadIdx.x < kTileRows)
        st[threadIdx.x] = stats[((size_t)wg * nh + h) * N16
                                + qt * kTileRows + threadIdx.x];
      __syncthreads();
      if (kStaged) {         // the next (window, query tile) lands meanwhile
        if (qt + 1 < kKeyTiles)
          stage_qg(wg, qt + 1);
        else if (wg + 1 < w_end)
          stage_qg(wg + 1, 0);
      }

      float s[8][4], dp[8][4];
      qk_tile<HDP>(sk, sq, ldb, r0, s);     // S^T = K Q^T
      add_bias<N16>(s, bias_r + qt * kTileRows,
                    mask_r != nullptr ? mask_r + qt * kTileRows : nullptr,
                    scale);
      qk_tile<HDP>(sv, sg, ldb, r0, dp);    // dP^T = V dO^T
      uint32_t p[8][2], ds[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pr[4], dr[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {          // query 8j + 2 tq + i
          const int ql = 8 * j + 2 * tq + i;
          const float4 q4 = st[ql];            // (max, 1 / sum, D)
#pragma unroll
          for (int r = 0; r < 2; ++r) {        // keys r0 + g and + 8
            const float pv_ = expf(s[j][2 * r + i] - q4.x) * q4.y;
            const float d = pv_ * (dp[j][2 * r + i] - q4.z);
            pr[2 * r + i] = pv_;
            dr[2 * r + i] = d;
            acc[(qt * kTileRows + ql) * kAccLd + r0 + g + 8 * r] += d;
          }
        }
        p[j][0] = pack_bf16x2(pr[0], pr[1]);
        p[j][1] = pack_bf16x2(pr[2], pr[3]);
        ds[j][0] = pack_bf16x2(dr[0], dr[1]);
        ds[j][1] = pack_bf16x2(dr[2], dr[3]);
      }
      pv_tile<HDP>(p, sg, ldb, dv);       // dV += P^T dO
      pv_tile<HDP>(ds, sq, ldb, dk);      // dK += dS^T Q
    }

    // dK * scale and dV over this warp's own rows of the K and V tiles
    // (which only this warp reads), then to dqkv
    bf16* ok = pk + (r0 + g) * LD;
    bf16* ov = pv + (r0 + g) * LD;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = 8 * j + 2 * tq;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (d + x < hd) {
          ok[d + x] = __float2bfloat16(dk[j][x] * scale);
          ok[8 * LD + d + x] = __float2bfloat16(dk[j][2 + x] * scale);
          ov[d + x] = __float2bfloat16(dv[j][x]);
          ov[8 * LD + d + x] = __float2bfloat16(dv[j][2 + x]);
        }
      }
    }
    __syncthreads();
    store_tile<kWin16>(pk, LD, dqkv, ldd, C3, s0 + C, hd, rows,
                       kt * kTileRows);
    store_tile<kWin16>(pv, LD, dqkv, ldd, C3, s0 + 2 * C, hd, rows,
                       kt * kTileRows);
  }

  // this block's columns of the group's [nh][256][256] d(bias) partial
  __syncthreads();
  float* pr = part + ((size_t)grp * nh + h) * N16 * N16 + kt * kTileRows;
  for (int i = threadIdx.x; i < N16 * kTileRows; i += kThreads) {
    const int q = i / kTileRows, k = i % kTileRows;
    pr[(size_t)q * N16 + k] = acc[q * kAccLd + k];
  }
}

template <int HDP>
int launch16(const void* qkv, long long ldq, const void* dctx, long long ldg,
             const void* bias, const void* mask, const void* bias_t,
             const void* mask_t, void* dqkv, long long ldd,
             void* stats, void* part, void* dbias, int B, int H, int W, int C,
             int nh, int hd, int shift, int group, long long smem_dq,
             long long smem_dkv, cudaStream_t stream) {
  const size_t b_dq = smem_dq16(HDP), b_dkv = smem_dkv16(HDP, dkv_staged(HDP));
  if ((long long)b_dq != smem_dq || (long long)b_dkv != smem_dkv ||
      b_dkv > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;   // per template instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attention_bwd16_dq_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b_dq);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(window_attention_bwd16_dkv_kernel<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)b_dkv);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long windows = (long long)B * (H / kWin16) * (W / kWin16);
  const long long groups = (windows + group - 1) / group;
  if (windows * nh * kKeyTiles > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  window_attention_bwd16_dq_kernel<HDP>
      <<<(unsigned)(windows * nh * kKeyTiles), kThreads, b_dq, stream>>>(
          (const bf16*)qkv, ldq, (const bf16*)dctx, ldg, (const float*)bias,
          (const float*)mask, (bf16*)dqkv, ldd, (float4*)stats, H, W, C, nh,
          hd, shift, scale);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  window_attention_bwd16_dkv_kernel<HDP>
      <<<(unsigned)(groups * nh * kKeyTiles), kThreads, b_dkv, stream>>>(
          (const bf16*)qkv, ldq, (const bf16*)dctx, ldg,
          (const float*)bias_t, (const float*)mask_t, (bf16*)dqkv, ldd,
          (const float4*)stats,
          (float*)part, (int)windows, group, H, W, C, nh, hd, shift, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  // d(bias)[i] = sum over the groups of part[group][i], i < nh * 256 * 256
  return sum_partials(nullptr, 0, 0, nullptr, 0, nullptr, stream,
                      (const float*)part, (int)groups, nh * N16 * N16,
                      (float*)dbias);
}

}  // namespace

// Kernel (f) at 16x16 windows: ``group`` windows a dkv block and the two
// launches' shared memory are what the caller planned
// (kernels/window_attention_bwd.py ``window_attention_bwd_plan``, window
// 16). ``bias_t`` and ``mask_t`` are ``bias`` and ``mask`` with their last
// two dims transposed, ``stats`` holds B * nW * nh * 256 float4, ``part``
// ceil(windows / group) * nh * 256 * 256 f32.
extern "C" int adsr_window_attention_bwd16(
    const void* qkv, long long ldq, const void* dctx, long long ldg,
    const void* bias, const void* mask, const void* bias_t,
    const void* mask_t, void* dqkv, long long ldd,
    void* stats, void* part, void* dbias, int B, int H, int W, int C, int nh,
    int shift, int group, long long smem_dq, long long smem_dkv,
    void* stream) {
  if (H % kWin16 || W % kWin16 || nh <= 0 || C % nh || C % 4 || B < 0 ||
      shift < 0 || shift >= kWin16 || (shift > 0) != (mask != nullptr) ||
      (mask != nullptr) != (mask_t != nullptr) || bias_t == nullptr ||
      group < 1 || ldq % 8 || ldg % 8 || ldd % 8 || ldq < 3ll * C ||
      ldg < C || ldd < 3ll * C || reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(dctx) % 16 ||
      reinterpret_cast<uintptr_t>(dqkv) % 16 ||
      reinterpret_cast<uintptr_t>(stats) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int hd = C / nh;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return launch16<16>(qkv, ldq, dctx, ldg, bias, mask, bias_t, mask_t, dqkv, ldd, stats, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 2: return launch16<32>(qkv, ldq, dctx, ldg, bias, mask, bias_t, mask_t, dqkv, ldd, stats, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 3: return launch16<48>(qkv, ldq, dctx, ldg, bias, mask, bias_t, mask_t, dqkv, ldd, stats, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 4: return launch16<64>(qkv, ldq, dctx, ldg, bias, mask, bias_t, mask_t, dqkv, ldd, stats, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 5: return launch16<80>(qkv, ldq, dctx, ldg, bias, mask, bias_t, mask_t, dqkv, ldd, stats, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 6: return launch16<96>(qkv, ldq, dctx, ldg, bias, mask, bias_t, mask_t, dqkv, ldd, stats, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 7: return launch16<112>(qkv, ldq, dctx, ldg, bias, mask, bias_t, mask_t, dqkv, ldd, stats, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 8: return launch16<128>(qkv, ldq, dctx, ldg, bias, mask, bias_t, mask_t, dqkv, ldd, stats, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
