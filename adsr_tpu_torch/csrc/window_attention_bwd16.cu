// window_attention_bwd at 16x16 windows (N = 256 tokens): the backward of
// window_attention16.cu, kernel (f)'s second geometry (the 8x8 one is
// window_attention_bwd.cu).
//
// Replaces: the attention backward phases of the Pallas kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770) at L = 4096 (_bwd_split :860).
// Bound on H100: bytes (q, k, v, dO, the context and its row statistics
// read and dq, dk, dv written once), but five 256-key products a (window,
// head) make it the heaviest kernel of the training step at this geometry.
// The relative-position bias comes as its head's 961-entry table and the
// shift mask as the window's region labels, both looked up in shared
// memory (attn16.cuh).
//
// Inputs beyond the forward's: the forward's context ``ctx`` and each query
// row's softmax statistics (max m, 1 / sum l) per head, which kernel (c)
// writes in the training backward's recompute. So P = exp(S - m) / l comes
// without a sweep of its own, and D = rowsum(dO o O) from dO and the bf16
// context (FlashAttention-2's D; the Pallas kernel and the plain version
// sum rowsum(P o dP), the same value in another order).
//
// Design: FlashAttention-2's deterministic backward in two launches on
// tiles of 64 tokens, every product on wgmma (attn16.cuh), then the partial
// sums of d(bias):
//   1. dq: a block (one warpgroup) per (image, window, head, tile of 64
//      query rows) gathers its Q and dO tiles, computes D of its rows, and
//      walks the four key tiles once (the next K and V tiles cp.async-staged
//      during the products): S = Q K^T and dP = dO V^T (m64n64k16 from
//      shared memory), P = exp(S * scale + bias (+ mask) - m) / l (the bias
//      and mask looked up in shared memory, attn16.cuh) and
//      dS = P o (dP - D) in f32, dS once to bf16 as the register A of
//      dQ += dS K (K read MN-major from the same tile). It writes dq and
//      each row's (m, 1 / l, D) as a float4.
//   2. dkv: a block (two warpgroups) per (group of G windows, head, tile of
//      64 keys) gathers each window's K and V tile; warpgroup w takes the
//      window's query tiles w and w + 2 with their rows' (m, 1 / l, D):
//      S^T = K Q^T and dP^T = V dO^T, P^T and dS^T = P^T o (dP^T - D) in
//      registers, dV += P^T dO and dK += dS^T Q with P^T and dS^T once to
//      bf16 as register A (dO and Q read MN-major). dS^T adds into one f32
//      [256 queries][64 keys] d(bias) tile in shared memory: the warpgroups'
//      query rows are disjoint, so there is no race. At each window's end
//      warpgroup 1's dK and dV go through shared memory to warpgroup 0, in
//      that order, and out in 16-byte stores; at the group's end the block
//      writes its columns of one [nh][256][256] partial per group. Where
//      they fit, each warpgroup's next Q and dO tiles and row statistics
//      (head tiles up to 80) and the next window's K and V tiles (up to 64)
//      are cp.async-staged during the products.
//   3. partials.cuh sums the groups' partials in a fixed order.
// No atomics: two runs are bitwise equal. G (the plan's) keeps the
// partials at most 32 MiB a call. The numerics are the N = 64 kernel's: f32
// softmax, D and dS, P and dS rounded once to bf16 before the products,
// f32 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn16.cuh"
#include "partials.cuh"

namespace {

constexpr int kWin = 16;
constexpr int N = kWin * kWin;
constexpr int kKeyTiles = N / kTileRows;
constexpr int kDqThreads = 128;           // one warpgroup
constexpr int kDkvThreads = 256;          // two warpgroups
constexpr bool kBias = true;              // bias and mask loads at all
constexpr bool kStore = true;             // the dq, dk, dv stores
// P recomputed with the hardware exponent (ex2.approx, a few ulp of f32;
// P is rounded to bf16 before its products and dS sums in f32)
constexpr bool kFastExp = true;
constexpr size_t kMaxSmem = 232448;

typedef __nv_bfloat16 bf16;

// Shared memory of a dq block: 1024 bytes of alignment, the Q, dO, K and V
// tiles, the staging of the next K and V tiles (after the last, the dQ
// plane), D of the 64 rows, the head's relative-position table and the
// window's region labels
__host__ __device__ constexpr size_t smem_dq16(int hdp) {
  return 1024 + (size_t)4 * swz_bytes(hdp)
         + (size_t)2 * stage_slots(hdp) * 16 + kTileRows * 4 + kRelTableBytes
         + kLabelBytes;
}

__host__ __device__ constexpr int dq_min_blocks(int hdp) {
  return hdp <= 64 ? 3 : 2;
}

// Shared memory of a dkv block: 1024 bytes of alignment, the K and V tiles,
// each warpgroup's Q and dO tiles and their rows' statistics, the f32
// d(bias) tile [256][64] (swizzled, acc_at), the head's relative-position
// table, the window's region labels and, where they fit, each
// warpgroup's staging of its next Q and dO tiles and their statistics
// (dkv_staged) and then the staging of the next window's K and V tiles
// (dkv_kv_staged)
__host__ __device__ constexpr size_t smem_dkv_base(int hdp) {
  return 1024 + (size_t)6 * swz_bytes(hdp) + 2 * kTileRows * 16
         + (size_t)N * kTileRows * 4 + kRelTableBytes + kLabelBytes;
}
__host__ __device__ constexpr size_t qg_stage_bytes(int hdp) {
  return (size_t)2 * stage_slots(hdp) * 16 + kTileRows * 16;
}
__host__ __device__ constexpr bool dkv_staged(int hdp) {
  return smem_dkv_base(hdp) + 2 * qg_stage_bytes(hdp) <= kMaxSmem;
}
__host__ __device__ constexpr bool dkv_kv_staged(int hdp) {
  return dkv_staged(hdp) && smem_dkv_base(hdp) + 2 * qg_stage_bytes(hdp)
                                + (size_t)2 * stage_slots(hdp) * 16
                            <= kMaxSmem;
}
__host__ __device__ constexpr size_t smem_dkv16(int hdp) {
  return smem_dkv_base(hdp) + (dkv_staged(hdp) ? 2 * qg_stage_bytes(hdp) : 0)
         + (dkv_kv_staged(hdp) ? (size_t)2 * stage_slots(hdp) * 16 : 0);
}

__device__ __forceinline__ float exp_p(float x) {
  return kFastExp ? __expf(x) : expf(x);
}

// Element (query q, key k) of the [256][64] d(bias) tile: key k of row q at
// k ^ 8 ((q / 2) % 4), so the 32 lanes of a warp, which add at queries 2t +
// {0, 1} and keys g (+ 8) (lane = 4g + t), hit 32 banks
__device__ __forceinline__ int acc_at(int q, int k) {
  return q * kTileRows + (k ^ (((q >> 1) & 3) << 3));
}

__device__ __forceinline__ uint32_t smem_offset(const unsigned char* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The dO tile as load_swz gathers it (columns [s, s + hd) of tokens [t0, t0
// + 64) of dctx), and the dot product of each of its 16-byte chunks with the
// same head dims of the context rows: part[t * HDP / 8 + q] for chunk q of
// row t (dctx and ctx share their columns, so one shift serves both); two
// chunks (eight loads) in flight a thread
template <int HDP>
__device__ __forceinline__ void load_dout_dot(
    uint32_t tile, float* part, const bf16* __restrict__ dctx, long long ldg,
    const bf16* __restrict__ ctx, long long ldc, int width, int s, int hd,
    const WinRows<kWin>& rows, int t0, int tid, int nthr) {
  constexpr int CQ = HDP / 8, kB = 2, kTotal = kTileRows * CQ;
  const int lo = s & ~7, o = s - lo, n = (o + hd + 7) >> 3;
  for (int base = tid; base < kTotal; base += nthr * kB) {
    uint4 a[kB], b[kB], c[kB], d[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = base + j * nthr;
      a[j] = b[j] = c[j] = d[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kTotal) {
        const int t = i / CQ, q = i - t * CQ;
        if (8 * q < hd) {
          const long long r = rows(t0 + t);
          a[j] = ld_piece(dctx + r * ldg, lo + 8 * q, width);
          c[j] = ld_piece(ctx + r * ldc, lo + 8 * q, width);
          if (q + 1 < n) {
            b[j] = ld_piece(dctx + r * ldg, lo + 8 * q + 8, width);
            d[j] = ld_piece(ctx + r * ldc, lo + 8 * q + 8, width);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = base + j * nthr;
      if (i < kTotal) {
        const int t = i / CQ, q = i - t * CQ;
        const uint4 x = shift8(a[j], b[j], o, hd - 8 * q);
        const uint4 y = shift8(c[j], d[j], o, hd - 8 * q);
        sts16(tile + swz_chunk(t, q), x);
        const bf16* ex = reinterpret_cast<const bf16*>(&x);
        const bf16* ey = reinterpret_cast<const bf16*>(&y);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dot += __bfloat162float(ex[e]) * __bfloat162float(ey[e]);
        part[i] = dot;
      }
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kDqThreads, dq_min_blocks(HDP))
window_attention_bwd16_dq_kernel(const bf16* __restrict__ qkv, long long ldq,
                                 const bf16* __restrict__ dctx, long long ldg,
                                 const bf16* __restrict__ ctx, long long ldc,
                                 const float* __restrict__ table,
                                 const int* __restrict__ labels,
                                 const float2* __restrict__ stats,
                                 bf16* __restrict__ dqkv, long long ldd,
                                 float4* __restrict__ stats4, int H, int W,
                                 int C, int nh, int hd, int shift,
                                 float scale) {
  constexpr uint32_t TB = swz_bytes(HDP);
  constexpr uint32_t kStage = 16u * stage_slots(HDP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = swz_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_offset(smem_raw));
  const uint32_t sq = base, sg = base + TB, sk = base + 2 * TB,
                 sv = base + 3 * TB, sst = base + 4 * TB;
  float* dsm = reinterpret_cast<float*>(smem + 4 * TB + 2 * kStage);
  float* tab = dsm + kTileRows;
  int* lab = reinterpret_cast<int*>(tab) + kRelTableBytes / 4;

  const int nww = W / kWin;
  const int nw = (H / kWin) * nww;
  const int qt = blockIdx.x % kKeyTiles;
  const int h = (blockIdx.x / kKeyTiles) % nh;
  const int wgi = blockIdx.x / (kKeyTiles * nh);   // image * nw + window
  const int win = wgi % nw;
  const int C3 = 3 * C, s0 = h * hd;
  const WinRows<kWin> rows{(long long)(wgi / nw) * H * W,
                           (win / nww) * kWin + shift,
                           (win % nww) * kWin + shift, H, W};
  const int tid = threadIdx.x;
  const int ok = (s0 + C) & 7, ov = (s0 + 2 * C) & 7;
  auto stage_kv = [&](int kt) {
    stage_raw<kWin>(sst, qkv, ldq, C3, s0 + C, hd, rows, kt * kTileRows, tid,
                    kDqThreads);
    stage_raw<kWin>(sst + kStage, qkv, ldq, C3, s0 + 2 * C, hd, rows,
                    kt * kTileRows, tid, kDqThreads);
    stage_commit();
  };
  stage_kv(0);
  load_rel_table(tab, table + (size_t)h * kRelTable, tid, kDqThreads);
  const bool masked = kBias && labels != nullptr;
  if (masked)
    for (int i = tid; i < N; i += kDqThreads) lab[i] = labels[(size_t)win * N + i];
  load_swz<HDP, kWin>(sq, qkv, ldq, C3, s0, hd, rows, qt * kTileRows, tid,
                      kDqThreads);
  // the dO tile and, chunk by chunk, D = rowsum(dO o O) of its rows: the
  // pieces in the K tile (free until the first unpack), summed in order
  float* dpart = reinterpret_cast<float*>(smem + 2 * TB);
  load_dout_dot<HDP>(sg, dpart, dctx, ldg, ctx, ldc, C, s0, hd, rows,
                     qt * kTileRows, tid, kDqThreads);
  fence_async_smem();
  __syncthreads();
  if (tid < kTileRows) {
    float d = 0.f;
#pragma unroll
    for (int q = 0; q < HDP / 8; ++q) d += dpart[tid * (HDP / 8) + q];
    dsm[tid] = d;
  }

  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rl = 16 * (tid >> 5) + g;          // the tile's rows rl, rl + 8
  const int r = qt * kTileRows + rl;
  const size_t srow = ((size_t)wgi * nh + h) * N + r;
  const float2 st0 = stats[srow], st1 = stats[srow + 8];
  const int ar = rel_pos(r) + kRelCentre;       // (row r + 8: + 8)
  float d0 = 0.f, d1 = 0.f;
  float dq[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;

  for (int kt = 0; kt < kKeyTiles; ++kt) {
    stage_wait_all();
    __syncthreads();        // tile kt staged; the last one's products done
    unpack_swz<HDP>(sk, sst, ok, hd, tid, kDqThreads);
    unpack_swz<HDP>(sv, sst + kStage, ov, hd, tid, kDqThreads);
    fence_async_smem();
    __syncthreads();
    if (kt == 0) {
      d0 = dsm[rl];
      d1 = dsm[rl + 8];
    }
    if (kt + 1 < kKeyTiles) stage_kv(kt + 1);   // lands during the products
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg_fence_acc(s);
    wg_fence_acc(dp);
    wg_fence();
    wg_scores<HDP>(s, sq, sk);        // S = Q K^T
    wg_commit();
    wg_scores<HDP>(dp, sg, sv);       // dP = dO V^T
    wg_commit();
    wg_wait1();                       // S (dP may still run)
    wg_fence_acc(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {     // the bias from the head's table
      const int a = ar - rel_pos(kt * kTileRows + 8 * j + 2 * t);
      s[4 * j] = s[4 * j] * scale + (kBias ? tab[a] : 0.f);
      s[4 * j + 1] = s[4 * j + 1] * scale + (kBias ? tab[a - 1] : 0.f);
      s[4 * j + 2] = s[4 * j + 2] * scale + (kBias ? tab[a + 8] : 0.f);
      s[4 * j + 3] = s[4 * j + 3] * scale + (kBias ? tab[a + 7] : 0.f);
    }
    if (masked) {            // the mask from the window's region labels
      const int l0 = lab[r], l1 = lab[r + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kt * kTileRows + 8 * j + 2 * t;
        const int k0 = lab[c], k1 = lab[c + 1];
        s[4 * j] += mask_term(l0, k0);
        s[4 * j + 1] += mask_term(l0, k1);
        s[4 * j + 2] += mask_term(l1, k0);
        s[4 * j + 3] += mask_term(l1, k1);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {     // P = exp(x - m) / l over S
      s[4 * j] = exp_p(s[4 * j] - st0.x) * st0.y;
      s[4 * j + 1] = exp_p(s[4 * j + 1] - st0.x) * st0.y;
      s[4 * j + 2] = exp_p(s[4 * j + 2] - st1.x) * st1.y;
      s[4 * j + 3] = exp_p(s[4 * j + 3] - st1.x) * st1.y;
    }
    wg_wait0();                       // dP
    wg_fence_acc(dp);
    uint32_t ds[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ds[j][0] = pack2(s[4 * j] * (dp[4 * j] - d0),
                       s[4 * j + 1] * (dp[4 * j + 1] - d0));
      ds[j][1] = pack2(s[4 * j + 2] * (dp[4 * j + 2] - d1),
                       s[4 * j + 3] * (dp[4 * j + 3] - d1));
    }
    wg_fence_acc(dq);
    wg_fence();
    wg_pv<HDP>(dq, ds, sk);           // dQ += dS K
    wg_commit();
    wg_wait0();
    wg_fence_acc(dq);
  }

  // each row's (max, 1 / sum, D) for the dkv launch
  if (t == 0) {
    stats4[srow] = make_float4(st0.x, st0.y, d0, 0.f);
    stats4[srow + 8] = make_float4(st1.x, st1.y, d1, 0.f);
  }
  // dQ * scale through a plane in the staging area (free since the last
  // unpack) to dqkv
  bf16* plane = reinterpret_cast<bf16*>(smem + 4 * TB);
  acc_to_plane<HDP>(plane, dq, scale, scale, tid);
  __syncthreads();
  if (kStore)
    store_plane<HDP, kWin>(plane, dqkv, ldd, C3, s0, hd, rows,
                           qt * kTileRows, tid, kDqThreads);
}

template <int HDP>
__global__ void __launch_bounds__(kDkvThreads, 1)
window_attention_bwd16_dkv_kernel(const bf16* __restrict__ qkv, long long ldq,
                                  const bf16* __restrict__ dctx, long long ldg,
                                  const float* __restrict__ table,
                                  const int* __restrict__ labels,
                                  bf16* __restrict__ dqkv, long long ldd,
                                  const float4* __restrict__ stats4,
                                  float* __restrict__ part, int windows,
                                  int group, int H, int W, int C, int nh,
                                  int hd, int shift, float scale) {
  constexpr uint32_t TB = swz_bytes(HDP);
  constexpr uint32_t kStage = 16u * stage_slots(HDP);
  constexpr bool kStaged = dkv_staged(HDP);
  constexpr bool kKvStaged = dkv_kv_staged(HDP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = swz_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_offset(smem_raw));
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const uint32_t sk = base, sv = base + TB;
  const uint32_t sq = base + (2 + 2 * wg) * TB, sg = sq + TB;
  float4* st = reinterpret_cast<float4*>(smem + 6 * TB) + wg * kTileRows;
  float* acc = reinterpret_cast<float*>(smem + 6 * TB + 2 * kTileRows * 16);
  float* tab = acc + N * kTileRows;
  int* lab = reinterpret_cast<int*>(tab) + kRelTableBytes / 4;
  const bool masked = kBias && labels != nullptr;
  const uint32_t sqg = base + 6 * TB + 2 * kTileRows * 16 + N * kTileRows * 4
                       + kRelTableBytes + kLabelBytes
                       + wg * (uint32_t)qg_stage_bytes(HDP);
  const uint32_t skv = sqg + (2 - wg) * (uint32_t)qg_stage_bytes(HDP);
  const float4* st_staged =
      reinterpret_cast<const float4*>(smem + (sqg - base) + 2 * kStage);

  const int kt = blockIdx.x % kKeyTiles;
  const int h = (blockIdx.x / kKeyTiles) % nh;
  const int grp = blockIdx.x / (kKeyTiles * nh);
  const int w_begin = grp * group, w_end = min(windows, (grp + 1) * group);
  const int nww = W / kWin;
  const int nw = (H / kWin) * nww;
  const int C3 = 3 * C, s0 = h * hd, oq = s0 & 7;
  const int ok = (s0 + C) & 7, ov = (s0 + 2 * C) & 7;
  auto window_rows = [&](int w) {
    const int win = w % nw;
    return WinRows<kWin>{(long long)(w / nw) * H * W,
                         win / nww * kWin + shift, win % nww * kWin + shift,
                         H, W};
  };
  auto stats_row = [&](int w, int qt) {
    return stats4 + ((size_t)w * nh + h) * N + qt * kTileRows;
  };
  // the next window's K and V tiles, by all threads
  auto stage_kv = [&](int w) {
    const WinRows<kWin> rows = window_rows(w);
    stage_raw<kWin>(skv, qkv, ldq, C3, s0 + C, hd, rows, kt * kTileRows, tid,
                    kDkvThreads);
    stage_raw<kWin>(skv + kStage, qkv, ldq, C3, s0 + 2 * C, hd, rows,
                    kt * kTileRows, tid, kDkvThreads);
    stage_commit();
  };
  // this warpgroup's next Q and dO tiles and their rows' statistics
  auto stage_qg = [&](int w, int qt) {
    const WinRows<kWin> rows = window_rows(w);
    stage_raw<kWin>(sqg, qkv, ldq, C3, s0, hd, rows, qt * kTileRows, wtid,
                    128);
    stage_raw<kWin>(sqg + kStage, dctx, ldg, C, s0, hd, rows, qt * kTileRows,
                    wtid, 128);
    if (wtid < kTileRows)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   ::"r"(sqg + 2 * kStage + 16u * wtid),
                   "l"(stats_row(w, qt) + wtid));
    stage_commit();
  };
  // the warpgroup's Q and dO tiles and statistics for (window, query tile):
  // unpacked from its staging, or gathered straight from global memory
  auto take_qg = [&](int w, int qt) {
    if (kStaged) {
      unpack_swz<HDP>(sq, sqg, oq, hd, wtid, 128);
      unpack_swz<HDP>(sg, sqg + kStage, oq, hd, wtid, 128);
      if (wtid < kTileRows) st[wtid] = st_staged[wtid];
    } else {
      const WinRows<kWin> rows = window_rows(w);
      load_swz<HDP, kWin>(sq, qkv, ldq, C3, s0, hd, rows, qt * kTileRows,
                          wtid, 128);
      load_swz<HDP, kWin>(sg, dctx, ldg, C, s0, hd, rows, qt * kTileRows,
                          wtid, 128);
      if (wtid < kTileRows) st[wtid] = stats_row(w, qt)[wtid];
    }
    fence_async_smem();
  };
  if (w_begin < w_end) {
    if (kStaged) stage_qg(w_begin, wg);
    if (kKvStaged) stage_kv(w_begin);
  }
  for (int i = tid; i < N * kTileRows; i += kDkvThreads) acc[i] = 0.f;
  load_rel_table(tab, table + (size_t)h * kRelTable, tid, kDkvThreads);

  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kr = 16 * (wtid >> 5) + g;      // the tile's keys kr, kr + 8
  float dk[HDP / 2], dv[HDP / 2];

  // one query tile of the window: S^T, dP^T, P^T, dS^T, d(bias), dV, dK
  auto step = [&](int win, int qt) {
    float s[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    wg_fence_acc(s);
    wg_fence_acc(dp);
    wg_fence();
    wg_scores<HDP>(s, sk, sq);       // S^T = K Q^T
    wg_commit();
    wg_scores<HDP>(dp, sv, sg);      // dP^T = V dO^T
    wg_commit();
    wg_wait1();                      // S^T (dP^T may still run)
    wg_fence_acc(s);
    // s[4j + 2rr + ii]: key kr + 8rr, query 8j + 2t + ii of the tile; the
    // bias from the head's table, the mask from the window's labels
    const size_t q0 = (size_t)qt * kTileRows;
    const int ak = kRelCentre - rel_pos(kt * kTileRows + kr);   // (+ 8: - 8)
    const int lk0 = lab[kt * kTileRows + kr], lk1 = lab[kt * kTileRows + kr + 8];
    // P^T over S^T, then dV += P^T dO while dS^T is computed
    uint32_t p[8][2], ds[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int ql = 8 * j + 2 * t + ii;
        const float4 q4 = st[ql];            // (max, 1 / sum, D)
        const int aq = ak + rel_pos((int)q0 + ql);
        const int lq = masked ? lab[q0 + ql] : 0;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int e = 4 * j + 2 * rr + ii;
          float x = s[e] * scale;
          if (kBias) {
            x += tab[aq - 8 * rr];
            if (masked) x += mask_term(lq, rr ? lk1 : lk0);
          }
          s[e] = exp_p(x - q4.x) * q4.y;
        }
      }
      p[j][0] = pack2(s[4 * j], s[4 * j + 1]);
      p[j][1] = pack2(s[4 * j + 2], s[4 * j + 3]);
    }
    wg_fence_acc(dv);
    wg_fence();
    wg_pv<HDP>(dv, p, sg);           // dV += P^T dO
    wg_commit();
    wg_wait1();                      // dP^T (dV may still run)
    wg_fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const float dd = st[8 * j + 2 * t + ii].z;        // D
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int e = 4 * j + 2 * rr + ii;
          dp[e] = s[e] * (dp[e] - dd);
        }
      }
      ds[j][0] = pack2(dp[4 * j], dp[4 * j + 1]);
      ds[j][1] = pack2(dp[4 * j + 2], dp[4 * j + 3]);
    }
    wg_fence_acc(dk);
    wg_fence();
    wg_pv<HDP>(dk, ds, sq);          // dK += dS^T Q
    wg_commit();
    // dS^T into the d(bias) tile while the products run
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          acc[acc_at((int)q0 + 8 * j + 2 * t + ii, kr + 8 * rr)] +=
              dp[4 * j + 2 * rr + ii];
    wg_wait0();
    wg_fence_acc(dv);
    wg_fence_acc(dk);
  };

  for (int w = w_begin; w < w_end; ++w) {
    const int win = w % nw;
    const bool more = w + 1 < w_end;
    // this window's K and V (and, staged, Q and dO) have landed; the last
    // window's stores have read the planes
    stage_wait_all();
    __syncthreads();
    if (masked) lab[tid] = labels[(size_t)win * N + tid];   // 256 threads
    if (kKvStaged) {
      unpack_swz<HDP>(sk, skv, ok, hd, tid, kDkvThreads);
      unpack_swz<HDP>(sv, skv + kStage, ov, hd, tid, kDkvThreads);
    } else {
      const WinRows<kWin> rows = window_rows(w);
      load_swz<HDP, kWin>(sk, qkv, ldq, C3, s0 + C, hd, rows,
                          kt * kTileRows, tid, kDkvThreads);
      load_swz<HDP, kWin>(sv, qkv, ldq, C3, s0 + 2 * C, hd, rows,
                          kt * kTileRows, tid, kDkvThreads);
    }
    take_qg(w, wg);
    __syncthreads();
    // in flight during this window: its second query tiles, then the next
    // window's K and V
    if (kStaged) stage_qg(w, wg + 2);
    if (kKvStaged && more) stage_kv(w + 1);
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dk[i] = dv[i] = 0.f;
    step(win, wg);
    wg_sync(wg);             // the warpgroup is done with Q, dO and st
    if (kStaged) {
      if (kKvStaged && more)
        stage_wait<1>();     // the next window's K and V may stay in flight
      else
        stage_wait_all();
      wg_sync(wg);
    }
    take_qg(w, wg + 2);
    wg_sync(wg);
    if (kStaged && more) stage_qg(w + 1, wg);
    step(win, wg + 2);

    // warpgroup 1's dK and dV to warpgroup 0 through the (now free) Q and
    // dO tiles, then both as bf16 planes there and out to dqkv
    const WinRows<kWin> rows = window_rows(w);
    float* scratch = reinterpret_cast<float*>(smem + 2 * TB);
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int x = 0; x < HDP / 2; ++x) {
        scratch[x * 128 + wtid] = dk[x];
        scratch[(HDP / 2 + x) * 128 + wtid] = dv[x];
      }
    }
    __syncthreads();
    bf16* pk = reinterpret_cast<bf16*>(smem + 2 * TB);
    bf16* pv = pk + kTileRows * (HDP + 8);
    if (wg == 0) {
#pragma unroll
      for (int x = 0; x < HDP / 2; ++x) {
        dk[x] += scratch[x * 128 + wtid];
        dv[x] += scratch[(HDP / 2 + x) * 128 + wtid];
      }
    }
    __syncthreads();
    if (wg == 0) {
      acc_to_plane<HDP>(pk, dk, scale, scale, wtid);
      acc_to_plane<HDP>(pv, dv, 1.f, 1.f, wtid);
    }
    __syncthreads();
    if (kStore) {
      store_plane<HDP, kWin>(pk, dqkv, ldd, C3, s0 + C, hd, rows,
                             kt * kTileRows, tid, kDkvThreads);
      store_plane<HDP, kWin>(pv, dqkv, ldd, C3, s0 + 2 * C, hd, rows,
                             kt * kTileRows, tid, kDkvThreads);
    }
  }

  // this block's columns of the group's [nh][256][256] d(bias) partial
  __syncthreads();
  float* pr = part + ((size_t)grp * nh + h) * N * N + kt * kTileRows;
  for (int i = tid; i < N * kTileRows; i += kDkvThreads) {
    const int q = i / kTileRows, k = i % kTileRows;
    pr[(size_t)q * N + k] = acc[acc_at(q, k)];
  }
}

template <int HDP>
int launch16(const void* qkv, long long ldq, const void* dctx, long long ldg,
             const void* ctx, long long ldc, const void* table,
             const void* labels, const void* stats, void* dqkv, long long ldd,
             void* stats4, void* part, void* dbias, int B, int H, int W,
             int C, int nh, int hd, int shift, int group, long long smem_dq,
             long long smem_dkv, cudaStream_t stream) {
  const size_t b_dq = smem_dq16(HDP), b_dkv = smem_dkv16(HDP);
  if ((long long)b_dq != smem_dq || (long long)b_dkv != smem_dkv ||
      b_dkv > kMaxSmem || b_dq > kMaxSmem)
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
  const long long windows = (long long)B * (H / kWin) * (W / kWin);
  const long long groups = (windows + group - 1) / group;
  if (windows * nh * kKeyTiles > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  window_attention_bwd16_dq_kernel<HDP>
      <<<(unsigned)(windows * nh * kKeyTiles), kDqThreads, b_dq, stream>>>(
          (const bf16*)qkv, ldq, (const bf16*)dctx, ldg, (const bf16*)ctx,
          ldc, (const float*)table, (const int*)labels, (const float2*)stats,
          (bf16*)dqkv, ldd, (float4*)stats4, H, W, C, nh, hd, shift, scale);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  window_attention_bwd16_dkv_kernel<HDP>
      <<<(unsigned)(groups * nh * kKeyTiles), kDkvThreads, b_dkv, stream>>>(
          (const bf16*)qkv, ldq, (const bf16*)dctx, ldg, (const float*)table,
          (const int*)labels, (bf16*)dqkv, ldd, (const float4*)stats4,
          (float*)part, (int)windows, group, H, W, C, nh, hd, shift, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  // d(bias)[i] = sum over the groups of part[group][i], i < nh * 256 * 256
  return sum_partials(nullptr, 0, 0, nullptr, 0, nullptr, stream,
                      (const float*)part, (int)groups, nh * N * N,
                      (float*)dbias);
}

}  // namespace

// Kernel (f) at 16x16 windows: ``group`` windows a dkv block and the two
// launches' shared memory are what the caller planned
// (kernels/window_attention_bwd.py ``window_attention_bwd_plan``, window
// 16). ``table`` is the relative-position bias table [nh][961] f32 and
// ``labels`` (null at shift 0) the shift mask as region labels [nW][256]
// int32 (as window_attention16.cu takes them), ``ctx`` the forward's context (row
// stride ``ldc``), ``stats`` the forward's B * nW * nh * 256 float2 (max,
// 1 / sum) (kernel (c)'s);
// ``stats4`` receives B * nW * nh * 256 float4 (max, 1 / sum, D, 0) from
// the dq launch for the dkv launch, ``part`` ceil(windows / group) * nh *
// 256 * 256 f32.
extern "C" int adsr_window_attention_bwd16(
    const void* qkv, long long ldq, const void* dctx, long long ldg,
    const void* ctx, long long ldc, const void* table, const void* labels,
    const void* stats, void* dqkv, long long ldd, void* stats4, void* part,
    void* dbias, int B, int H, int W, int C, int nh, int shift, int group,
    long long smem_dq, long long smem_dkv, void* stream) {
  if (H % kWin || W % kWin || nh <= 0 || C % nh || C % 4 || B < 0 ||
      shift < 0 || shift >= kWin || (shift > 0) != (labels != nullptr) ||
      stats == nullptr || group < 1 || ldq % 8 || ldg % 8 || ldc % 8 ||
      ldd % 8 || ldq < 3ll * C || ldg < C || ldc < C || ldd < 3ll * C ||
      reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(dctx) % 16 ||
      reinterpret_cast<uintptr_t>(ctx) % 16 ||
      reinterpret_cast<uintptr_t>(dqkv) % 16 ||
      reinterpret_cast<uintptr_t>(stats) % 8 ||
      reinterpret_cast<uintptr_t>(stats4) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int hd = C / nh;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return launch16<16>(qkv, ldq, dctx, ldg, ctx, ldc, table, labels, stats, dqkv, ldd, stats4, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 2: return launch16<32>(qkv, ldq, dctx, ldg, ctx, ldc, table, labels, stats, dqkv, ldd, stats4, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 3: return launch16<48>(qkv, ldq, dctx, ldg, ctx, ldc, table, labels, stats, dqkv, ldd, stats4, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 4: return launch16<64>(qkv, ldq, dctx, ldg, ctx, ldc, table, labels, stats, dqkv, ldd, stats4, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 5: return launch16<80>(qkv, ldq, dctx, ldg, ctx, ldc, table, labels, stats, dqkv, ldd, stats4, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 6: return launch16<96>(qkv, ldq, dctx, ldg, ctx, ldc, table, labels, stats, dqkv, ldd, stats4, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 7: return launch16<112>(qkv, ldq, dctx, ldg, ctx, ldc, table, labels, stats, dqkv, ldd, stats4, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    case 8: return launch16<128>(qkv, ldq, dctx, ldg, ctx, ldc, table, labels, stats, dqkv, ldd, stats4, part, dbias, B, H, W, C, nh, hd, shift, group, smem_dq, smem_dkv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
