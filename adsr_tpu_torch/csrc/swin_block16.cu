// swin_block16: kernel (g) swin_block at 16x16 windows (N = 256 tokens a
// window): one whole Swin block in one launch, a cluster of four thread
// blocks per (image, shifted window), each block owning one 64-row query
// tile of the window: LN1 -> qkv -> shifted-window multi-head attention
// over the window's 256 keys (relative-position bias + shift mask, online
// stabilised softmax) -> proj + residual -> LN2 -> fc1 + exact-erf GELU ->
// fc2 + residual.
//
// Replaces: the Pallas kernel fused_swin_block
// (adsr_tpu/ops/fused_swin_block.py:297, body _kernel :215, pallas_call
// :337) at window 16, the per-block program of the "block" serving mode
// (adsr_tpu/ops/fused_drct.py:168-189) of the 256px/x4 and 512/x8 models.
// Bound on H100: operations (the products and the attention on the tensor
// cores; the weights are read from L2 by every cluster).
// Design: the window's f32 residual stream (256 rows x up to 312 columns,
// ~315 KB) does not fit one block's shared memory, so the window is split
// by rows over a thread-block cluster of four (distributed shared memory):
//   - each block gathers its 64 token rows (WinRows<16>: the cyclic shift as
//     index arithmetic), keeps them in f32 in shared memory through the
//     whole block and runs LN1, every product, LN2 and the MLP on them on
//     the ping-pong path of swin_block_core.cuh (m64n64k16, a warpgroup a
//     64-column output tile, the tiles alternating between the warpgroups);
//     q, k and v of a head are one product of 3 HDP columns, the MLP runs
//     in hidden chunks of 128; each block streams every weight tile
//     itself (L2 serves a tile to the four blocks of a window);
//   - the qkv epilogue writes the head's q, k and v transposed, head dims
//     as rows of 64 tokens (128 bytes, swizzled): HDP x 128 bytes a tile, no
//     padding to 64 dims, and the layouts wgmma reads: S = Q K^T with both
//     operands MN-major, O += P V with V^T as a K-major B;
//   - per head, after a cluster barrier, both consumer warpgroups walk the
//     window's four 64-key tiles, each taking 32 keys of every tile on
//     wgmma (S m64n32k16 from shared memory; P in registers as the A of
//     m64nHDPk16) with the online softmax of kernel (c): its own K and V
//     first, then each peer's, pulled from the peer's shared memory
//     (ld.shared::cluster, 16 bytes a load) into one staging tile, K then
//     V; the bias comes from the head's 961-entry relative-position table
//     and the shift mask from the window's 256 region labels, both in
//     shared memory (attn16.cuh's lookups, the inputs of kernel (c) at
//     N = 256);
//   - the two warpgroups' (max, sum, context) merge in a fixed order,
//     warpgroup 0's term first, through the staging tile in two halves of
//     the head dims; the context goes transposed over the dead q tile, and
//     the head's share of proj (A MN-major) accumulates into the stream;
//   - two cluster barriers a head: one after the tiles are written, one
//     (split: arrive after the last pull, wait before the next head's
//     tiles are written, and before exit) before they are overwritten, so
//     no block exits while a peer may still read its shared memory. The
//     producer warp takes part in every cluster barrier: it arrives at a
//     barrier before it streams the first weight tile that the consumers
//     need after the next one, so the ring never waits on a barrier that
//     waits on the ring.
// No atomics: the output is bitwise repeatable. Numerics are the 8x8
// kernel's with kernel (c)'s online softmax: exp(S - running max) rounded
// once to bf16 for P V, the f32 context rescaled as the max grows, and the
// two halves' contexts joined in f32 and divided by the row sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attn16.cuh"            // bias table, region labels, register-A wgmma
#include "swin_block_core.cuh"   // ring, products, LayerNorm, launch arguments
#include "window_tiles.cuh"      // WinRows: the shifted window's raster rows

namespace {

constexpr int kWin16 = 16;
constexpr int kWinTok = kWin16 * kWin16;           // tokens a window (N)
constexpr int kCluster = kWinTok / kBlockRows;     // blocks a window
constexpr int kChunk = 128;                        // hidden columns a chunk
constexpr int kPullBatch = 8;                      // 16-byte loads in flight
constexpr int kMlBytes = 2 * kBlockRows * 8;       // (max, sum) a row and half
constexpr bool kAttend = true;     // the attention's products and softmax
constexpr bool kExchange = true;   // the pulls of the peers' K and V tiles

// Shared memory of one block (byte offsets from the 1024-aligned base), for
// width C, head tile HDP, ``kk`` k-steps of the transposed context (16 of
// its rows each: the largest (h hd) % 8 + hd of the block's heads, rounded
// up) and ``stages`` ring stages; a "tile" is HDP rows x 128 bytes
//   ring   stages x 8 KB of weight tiles
//   y      the LayerNorm output as swizzled A atoms [kp / 64][64 x 64] bf16
//   q      this block's rows of the head's q, transposed; after the
//          attention the head's context the same way, its dims at rows
//          (h hd) % 8 + d (max(HDP, 16 kk) rows)
//   slot   a peer's K or V tile; the merge's scratch; with q, the MLP's
//          128-wide hidden chunk (q and slot take 16 KB at least)
//   k, v   this block's rows of the head's k and v, transposed (the peers
//          read them)
//   x      the f32 residual stream [64][ldx]
//   tab    the head's relative-position table (961 f32)
//   lab    the window's region labels (256 int32; the shift mask)
//   ml     each row's running (max, sum) of both warpgroups
//   bars   a full and an empty mbarrier a stage
struct Layout16 {
  int kp, ldx;
  size_t y, q, slot, k, v, x, tab, lab, ml, bars, bytes;
};

__host__ __device__ inline Layout16 make_layout16(int C, int hdp, int kk,
                                                  int stages) {
  Layout16 L;
  L.kp = (C + 63) / 64 * 64;
  L.ldx = C + (24 - C % 16) % 16;
  const size_t tile = (size_t)hdp * 128;
  const size_t qb = (size_t)(hdp > 16 * kk ? hdp : 16 * kk) * 128;
  size_t off = (size_t)stages * kStageBytes;
  L.y = off;    off += (size_t)L.kp / 64 * kAtomBytes;
  L.q = off;    L.slot = off + qb;
  off += qb + tile > 2 * kAtomBytes ? qb + tile : 2 * kAtomBytes;
  L.k = off;    off += tile;
  L.v = off;    off += tile;
  L.x = off;    off += (size_t)kBlockRows * L.ldx * 4;
  L.tab = off;  off += kRelTableBytes;
  L.lab = off;  off += kLabelBytes;
  L.ml = off;   off += kMlBytes;
  L.bars = off; off += (size_t)16 * stages;
  L.bytes = 1024 + off;          // room to align the base to 1024 bytes
  return L;
}

// byte offset of element (row r, token t) of a transposed tile: 64 tokens
// (128 bytes) a row, the 16-byte chunk of t at (t / 8) ^ (r % 8)
__device__ __forceinline__ uint32_t tswz(int r, int t) {
  return (uint32_t)(r * 128 + ((((t >> 3) ^ (r & 7)) << 4) | ((t & 7) << 1)));
}

// ``bytes`` (a multiple of 16) from shared address ``src`` of cluster block
// ``rank`` (the same offset as in this block: the layouts are equal) into
// ``dst`` of this block, by the consumer threads
__device__ __forceinline__ void pull(unsigned char* dst, uint32_t src,
                                     uint32_t rank, int bytes) {
  const uint32_t remote = peer_addr(src, rank);
  const int n = bytes / 16;
  for (int base = threadIdx.x; base < n;
       base += kMathThreads * kPullBatch) {
    uint4 v[kPullBatch];
#pragma unroll
    for (int j = 0; j < kPullBatch; ++j) {
      const int i = base + j * kMathThreads;
      if (i < n) v[j] = ld_cluster16(remote + 16u * i);
    }
#pragma unroll
    for (int j = 0; j < kPullBatch; ++j) {
      const int i = base + j * kMathThreads;
      if (i < n) reinterpret_cast<uint4*>(dst)[i] = v[j];
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swin_block16_kernel(const __grid_constant__ Maps maps, const Args a, int kk) {
  const int C = a.C, F = a.F, hd = a.hd;
  const Layout16 L = make_layout16(C, HDP, kk, a.stages);
  extern __shared__ __align__(1024) unsigned char swin_smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(swin_smem);
  unsigned char* smem = swin_smem + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  const uint32_t sbars = sbase + (uint32_t)L.bars;
  if (threadIdx.x == 0) {
    init_split_rings(sbase, sbars, a.stages);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  SWIN_CLOCK_BEGIN(t_kernel);

  const uint32_t rank = cluster_rank();            // the block's query tile
  const int nww = a.W / kWin16;
  const int nw = (a.H / kWin16) * nww;
  const int cl = blockIdx.x / kCluster;            // the (image, window)
  const int win = cl % nw;
  const int b = cl / nw;
  const WinRows<kWin16> rows{(long long)b * a.H * a.W,
                             (win / nww) * kWin16 + a.shift,
                             (win % nww) * kWin16 + a.shift, a.H, a.W};
  const int t0 = (int)rank * kBlockRows;           // its first token
  const int ks = (C + 63) / 64;                    // 64-wide K steps over c
  const int kp_stages = (kk + 3) / 4;              // proj's over a context

  if (threadIdx.x >= kMathThreads) {
    // ---- producer warp: every weight tile, in the consumers' order ----
    // The consumers wait at cluster barriers 2h (head h's tiles written)
    // and 2h + 1 (head h's tiles read by the peers; waited before head
    // h + 1's qkv, the last one at exit), so their tiles fall into
    // segments: 2h = head h's qkv, 2h + 1 = its proj (and after the last
    // head the MLP). Before the tiles of segment s the warp has arrived at
    // barriers 0..s-1, waiting at each one but the last before arriving at
    // the next (a barrier's phases alternate), so its waits need only
    // tiles it has already issued.
    const bool leader = threadIdx.x == kMathThreads;
    int arrived = 0, waited = 0;
    auto sync_to = [&](int s) {
      while (arrived < s) {
        if (waited < arrived) {
          __syncwarp();
          cluster_wait();
          ++waited;
        }
        cluster_arrive();
        ++arrived;
      }
    };
    // tile i of the order goes into ring i % 2: ``load`` streams one stage
    // into the current tile's ring, ``n`` rows (16-row boxes; ``row(i)``
    // the matrix row of the stage's row i) x 64 columns from k0; ``tile``,
    // after each tile, turns to the next one's ring
    RingState ring = split_ring(sbase, sbars, a.stages, 0);
    RingState next = split_ring(sbase, sbars, a.stages, 1);
    auto tile = [&]() {
      const RingState r = ring;
      ring = next;
      next = r;
    };
    auto load = [&](const CUtensorMap* map, int n, int k0, auto row) {
      if (leader) {
        SWIN_TIMED(kProfEmpty,
                   mbar_wait(ring.empty(ring.stage), ring.phase ^ 1));
        mbar_arrive_expect_tx(ring.full(ring.stage), n * 128);
        const uint32_t dst = ring.base + ring.stage * kStageBytes;
        for (int i = 0; i < n; i += kBoxRows)
          tma_2d(dst + i * 128, map, k0, row(i), ring.full(ring.stage));
      }
      ring.advance();
    };
    for (int h = 0; h < a.nh; ++h) {
      sync_to(2 * h);
      // q, k, v of head h as one product: its column v is Wqkv's row
      // p C + h hd + d, p = v / HDP, d = v % HDP
      for (int n0 = 0; n0 < 3 * HDP; n0 += kStageRows, tile())
        for (int s = 0; s < ks; ++s)
          load(&maps.qkv, min(kStageRows, 3 * HDP - n0), 64 * s, [&](int i) {
            const int v = n0 + i, p = v / HDP;
            return p * C + h * hd + v - p * HDP;
          });
      sync_to(2 * h + 1);
      for (int n0 = 0; n0 < C; n0 += kStageRows, tile())   // its proj share
        for (int s = 0; s < kp_stages; ++s)
          load(&maps.proj, tile_rows(C - n0), (h * hd & ~7) + 64 * s,
               [&](int i) { return n0 + i; });
    }
    for (int f0 = 0; f0 < F; f0 += kChunk) {
      const int nf = min(kChunk, F - f0);
      for (int u = 0; u < nf; u += kStageRows, tile())
        for (int s = 0; s < ks; ++s)
          load(&maps.fc1, tile_rows(nf - u), 64 * s,
               [&](int i) { return f0 + u + i; });
      for (int n0 = 0; n0 < C; n0 += kStageRows, tile())
        for (int s = 0; s < nf; s += 64)
          load(&maps.fc2, tile_rows(C - n0), f0 + s,
               [&](int i) { return n0 + i; });
    }
    sync_to(2 * a.nh);
    __syncwarp();
    cluster_wait();
    return;
  }

  // ---- consumer warpgroups ----
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * (warp & 3), g = lane >> 2, tq = lane & 3;
  const int wg = tid >> 7;              // consumer warpgroup
  const int ldx = L.ldx, kp = L.kp;
  float* X = reinterpret_cast<float*>(smem + L.x);
  bf16* Y = reinterpret_cast<bf16*>(smem + L.y);
  bf16* Hb = reinterpret_cast<bf16*>(smem + L.q);   // the MLP's hidden chunk
  float* scratch = reinterpret_cast<float*>(smem + L.slot);
  float* tab = reinterpret_cast<float*>(smem + L.tab);
  int* lab = reinterpret_cast<int*>(smem + L.lab);
  float2* ml = reinterpret_cast<float2*>(smem + L.ml);
  const uint32_t s_y = sbase + (uint32_t)L.y, s_q = sbase + (uint32_t)L.q;
  const uint32_t s_slot = sbase + (uint32_t)L.slot;
  const uint32_t s_k = sbase + (uint32_t)L.k, s_v = sbase + (uint32_t)L.v;
  constexpr int kTile = HDP * 128;      // bytes of a transposed tile
  const int* labels = reinterpret_cast<const int*>(a.mask);
  RingState ring = split_ring(sbase, sbars, a.stages, wg);
  float acc[32];
  float2 vec[8];
  Turn turn;

  // gather the block's 64 rows into the f32 residual: every 8-byte copy in
  // flight at once, by cp.async into the Y region (LN1 overwrites it), then
  // widened; the window's region labels beside them
  const int q4 = C / 4;
  for (int i = tid; i < kBlockRows * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    cp_async<8>(s_y + 2u * (t * C + c), a.x + rows(t0 + t) * a.ldx + c, 8);
  }
  if (labels != nullptr)
    for (int i = tid; i < kWinTok; i += kMathThreads)
      lab[i] = labels[(size_t)win * kWinTok + i];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  math_barrier();
  for (int i = tid; i < kBlockRows * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    *reinterpret_cast<float4*>(X + t * ldx + c) =
        unpack4(*reinterpret_cast<const uint2*>(Y + t * C + c));
  }
  math_barrier();
  layer_norm(X, ldx, Y, C, kp, a.ln1_w, a.ln1_b, a.eps);
  fence_async_shared();
  math_barrier();

  // the thread's query rows (window tokens tr and tr + 8) in the table
  const int tr = t0 + r0 + g;
  const int ar = rel_pos(tr) + kRelCentre;
  // the head's context over ``kk`` k-steps, into the stream (bproj once)
  auto proj = [&](int h, auto kk_const) {
    constexpr int KK = decltype(kk_const)::value;
    for (int n0 = 0; n0 < C; n0 += kStageRows) {
      const int n = tile_rows(C - n0);
      if (!turn.mine()) continue;
      load_cols64(vec, h == 0 ? a.bproj : nullptr, n0, n, C);
      mma_tile64_mn<KK>(ring, s_q, acc);
      add_into_stream64(X, ldx, n0, n, C, acc, vec);
    }
  };

  // ---- attention and proj, one head at a time: X += ctx_h Wproj_h^T ----
  for (int h = 0; h < a.nh; ++h) {
    if (h > 0) cluster_wait();         // the peers have read head h - 1
    for (int n0 = 0; n0 < 3 * HDP; n0 += kStageRows) {
      const int n = min(kStageRows, 3 * HDP - n0);
      if (!turn.mine()) continue;
      // column v = n0 + 8 j + 2 tq (+ 1) is dim d = v % HDP of part
      // p = v / HDP (q, k, v); zeros past the head dim
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = n0 + 8 * j + 2 * tq, p = v / HDP, d = v - p * HDP;
        const bool in = 8 * j < n;
        const float* bp = a.bqkv + p * C + h * hd + d;
        vec[j] = make_float2(in && d < hd ? bp[0] : 0.f,
                             in && d + 1 < hd ? bp[1] : 0.f);
      }
      mma_tile64(ring, s_y, ks, acc);
      SWIN_CLOCK_BEGIN(t_qkv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = n0 + 8 * j + 2 * tq, p = v / HDP, d = v - p * HDP;
        if (8 * j < n) {
          unsigned char* t = smem + (p == 0 ? L.q : (p == 1 ? L.k : L.v));
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const bool in = d + x < hd;
            *reinterpret_cast<bf16*>(t + tswz(d + x, r0 + g)) =
                __float2bfloat16(in ? acc[4 * j + x] + (x ? vec[j].y
                                                          : vec[j].x) : 0.f);
            *reinterpret_cast<bf16*>(t + tswz(d + x, r0 + g + 8)) =
                __float2bfloat16(in ? acc[4 * j + 2 + x] + (x ? vec[j].y
                                                              : vec[j].x)
                                    : 0.f);
          }
        }
      }
      SWIN_CLOCK_END(kProfEpilogue, t_qkv);
    }
    load_rel_table(tab, a.bias + (size_t)h * kRelTable, tid, kMathThreads);
    fence_async_shared();
    math_barrier();
    cluster_arrive();                  // every block's tiles are whole
    cluster_wait();

    // the four key tiles, this block's own first, then the peers' in turn
    // through the slot; warpgroup w takes keys [32 w, 32 w + 32) of each
    float mx0 = -INFINITY, mx1 = -INFINITY, sum0 = 0.f, sum1 = 0.f;
    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    for (int i = 0; i < kCluster; ++i) {
      const uint32_t kt = (rank + i) % kCluster;
      uint32_t kT = s_k, vT = s_v;
      if (i > 0) {
        if (kExchange)
          SWIN_TIMED(kProfExchange, pull(smem + L.slot, s_k, kt, kTile));
        fence_async_shared();
        math_barrier();                // the peer's K is whole
        kT = s_slot;
      }
      uint32_t p[4][2];                // P in bf16: the A of P V
      if (kAttend) {
        SWIN_CLOCK_BEGIN(t_scores);
        float s[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) s[j] = 0.f;
        fence_operand(s);
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < HDP / 16; ++k16)
          wgmma_n32<1, 1>(s, smem_desc(s_q + k16 * 2048, kAtomBytes, 1024),
                          smem_desc(kT + k16 * 2048 + 64 * wg, kAtomBytes,
                                    1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(s);
        // x = S * scale + bias (+ mask): the table and the labels
        const int c0 = kt * kBlockRows + 32 * wg + 2 * tq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ai = ar - rel_pos(c0 + 8 * j);
          s[4 * j] = s[4 * j] * a.scale + tab[ai];
          s[4 * j + 1] = s[4 * j + 1] * a.scale + tab[ai - 1];
          s[4 * j + 2] = s[4 * j + 2] * a.scale + tab[ai + 8];
          s[4 * j + 3] = s[4 * j + 3] * a.scale + tab[ai + 7];
        }
        if (labels != nullptr) {
          const int l0 = lab[tr], l1 = lab[tr + 8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k0 = lab[c0 + 8 * j], k1 = lab[c0 + 8 * j + 1];
            s[4 * j] += mask_term(l0, k0);
            s[4 * j + 1] += mask_term(l0, k1);
            s[4 * j + 2] += mask_term(l1, k0);
            s[4 * j + 3] += mask_term(l1, k1);
          }
        }
        float m0 = mx0, m1 = mx1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
          m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, sh));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, sh));
        }
        const float a0 = expf(mx0 - m0), a1 = expf(mx1 - m1);  // 0 at tile 0
        mx0 = m0;
        mx1 = m1;
        float e0 = 0.f, e1 = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x0 = expf(s[4 * j] - m0), x1 = expf(s[4 * j + 1] - m0);
          const float x2 = expf(s[4 * j + 2] - m1);
          const float x3 = expf(s[4 * j + 3] - m1);
          e0 += x0 + x1;
          e1 += x2 + x3;
          p[j][0] = pack2(x0, x1);
          p[j][1] = pack2(x2, x3);
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          e0 += __shfl_xor_sync(0xffffffffu, e0, sh);
          e1 += __shfl_xor_sync(0xffffffffu, e1, sh);
        }
        sum0 = sum0 * a0 + e0;
        sum1 = sum1 * a1 + e1;
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
        SWIN_CLOCK_END(kProfAttention, t_scores);
      }
      if (i > 0) {
        math_barrier();                // both warpgroups have read the K
        if (kExchange)
          SWIN_TIMED(kProfExchange, pull(smem + L.slot, s_v, kt, kTile));
        fence_async_shared();
        if (i == kCluster - 1) cluster_arrive();  // done reading the peers
        math_barrier();                // the peer's V is whole
        vT = s_slot;
      }
      if (kAttend) {
        SWIN_CLOCK_BEGIN(t_pv);
        fence_operand(o);
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {
          const uint32_t pa[4] = {p[2 * kb][0], p[2 * kb][1],
                                  p[2 * kb + 1][0], p[2 * kb + 1][1]};
          wgmma_rs<HDP, 0>(o, pa,
                           smem_desc(vT + 64 * wg + 32 * kb, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(o);
        SWIN_CLOCK_END(kProfAttention, t_pv);
      }
      if (i > 0) math_barrier();       // the slot is read before it changes
    }

    // ---- the merge: ctx = (e_0 o_0 + e_1 o_1) / (e_0 l_0 + e_1 l_1) ----
    SWIN_CLOCK_BEGIN(t_merge);
    if (tq == 0) {
      ml[wg * kBlockRows + r0 + g] = make_float2(mx0, sum0);
      ml[wg * kBlockRows + r0 + g + 8] = make_float2(mx1, sum1);
    }
    for (int i = tid; i < (HDP > 16 * kk ? HDP : 16 * kk) * 8;
         i += kMathThreads)
      reinterpret_cast<uint4*>(smem + L.q)[i] = make_uint4(0u, 0u, 0u, 0u);
    math_barrier();
    float f[2];                        // this warpgroup's factor, rows g, g + 8
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float2 w0 = ml[r0 + g + 8 * u];
      const float2 w1 = ml[kBlockRows + r0 + g + 8 * u];
      const float m = fmaxf(w0.x, w1.x);
      const float e0 = expf(w0.x - m), e1 = expf(w1.x - m);
      f[u] = (wg ? e1 : e0) / (w0.y * e0 + w1.y * e1);
    }
    const int oc = (h * hd) & 7;
    constexpr int kHalfD = HDP / 2;    // scratch columns a round
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          if ((j < HDP / 16) != (round == 0)) continue;
          const int col = 8 * j + 2 * tq - round * kHalfD;
          *reinterpret_cast<float2*>(scratch + (r0 + g) * kHalfD + col) =
              make_float2(o[4 * j] * f[0], o[4 * j + 1] * f[0]);
          *reinterpret_cast<float2*>(scratch + (r0 + g + 8) * kHalfD + col) =
              make_float2(o[4 * j + 2] * f[1], o[4 * j + 3] * f[1]);
        }
      }
      math_barrier();
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          if ((j < HDP / 16) != (round == 0)) continue;
          const int col = 8 * j + 2 * tq - round * kHalfD;
          const float2 u0 = *reinterpret_cast<const float2*>(
              scratch + (r0 + g) * kHalfD + col);
          const float2 u1 = *reinterpret_cast<const float2*>(
              scratch + (r0 + g + 8) * kHalfD + col);
          const float v[4] = {o[4 * j] * f[0] + u0.x,
                              o[4 * j + 1] * f[0] + u0.y,
                              o[4 * j + 2] * f[1] + u1.x,
                              o[4 * j + 3] * f[1] + u1.y};
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int d = 8 * j + 2 * tq + x;
            if (d < hd) {
              *reinterpret_cast<bf16*>(smem + L.q + tswz(oc + d, r0 + g)) =
                  __float2bfloat16(v[x]);
              *reinterpret_cast<bf16*>(smem + L.q + tswz(oc + d, r0 + g + 8)) =
                  __float2bfloat16(v[2 + x]);
            }
          }
        }
        fence_async_shared();
      }
      math_barrier();                  // the scratch is free; the context whole
    }
    SWIN_CLOCK_END(kProfMerge, t_merge);
    if (kk == HDP / 16)
      proj(h, std::integral_constant<int, HDP / 16>{});
    else
      proj(h, std::integral_constant<int, HDP / 16 + 1>{});
    math_barrier();                    // the context is read before it changes
  }

  // ---- MLP: X += GELU(LN2(X) W1^T + b1) W2^T + b2, 128 hidden at a time ----
  layer_norm(X, ldx, Y, C, kp, a.ln2_w, a.ln2_b, a.eps);
  fence_async_shared();
  math_barrier();
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int nf = min(kChunk, F - f0);
    for (int u = 0; u < nf; u += kStageRows) {   // fc1: one tile a warpgroup
      const int n = tile_rows(nf - u);
      if (!turn.mine()) continue;
      load_cols64(vec, a.b1 + f0 + u, 0, n, F - f0 - u);
      mma_tile64(ring, s_y, ks, acc);
      gelu_into_chunk(Hb, u, n, f0, F, acc, vec);
    }
    fence_async_shared();
    math_barrier();
    const int kf = (nf + 63) / 64;     // fc2's K steps over the chunk
    for (int n0 = 0; n0 < C; n0 += kStageRows) {
      const int n = tile_rows(C - n0);
      if (!turn.mine()) continue;
      load_cols64(vec, f0 == 0 ? a.b2 : nullptr, n0, n, C);
      mma_tile64(ring, s_q, kf, acc);
      add_into_stream64(X, ldx, n0, n, C, acc, vec);
    }
    math_barrier();                    // the chunk is read before it changes
  }

  // ---- scatter the block's rows back ----
  for (int i = tid; i < kBlockRows * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    *reinterpret_cast<uint2*>(a.out + rows(t0 + t) * a.ldo + c) =
        pack4(*reinterpret_cast<const float4*>(X + t * ldx + c));
  }
  cluster_wait();                      // no peer pulls from this block
  SWIN_SPAN_END(t_kernel);
}

// The launch configuration: a cluster of kCluster blocks per window
struct Launch16 {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
};

inline void make_launch16(Launch16& l, long long blocks, size_t smem,
                          cudaStream_t stream) {
  l.cfg = cudaLaunchConfig_t{};
  l.cfg.gridDim = dim3((unsigned)blocks);
  l.cfg.blockDim = dim3(kThreads);
  l.cfg.dynamicSmemBytes = smem;
  l.cfg.stream = stream;
  l.attr.id = cudaLaunchAttributeClusterDimension;
  l.attr.val.clusterDim.x = kCluster;
  l.attr.val.clusterDim.y = 1;
  l.attr.val.clusterDim.z = 1;
  l.cfg.attrs = &l.attr;
  l.cfg.numAttrs = 1;
}

template <int HDP>
int configure16(size_t bytes) {
  static size_t configured = 0;   // per template instance
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        swin_block16_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  return 0;
}

// k-steps (16 rows each) of the transposed context of width C at nh heads:
// the largest (h hd) % 8 + hd, rounded up to 16
inline int context_ksteps(int C, int nh) {
  const int hd = C / nh;
  int rows = 0;
  for (int h = 0; h < nh; ++h) {
    const int r = ((h * hd) & 7) + hd;
    rows = r > rows ? r : rows;
  }
  return (rows + 15) / 16;
}

template <int HDP>
int launch16(const Args& a, const Maps& maps, int B, long long smem,
             cudaStream_t stream) {
  const int kk = context_ksteps(a.C, a.nh);
  const Layout16 L = make_layout16(a.C, HDP, kk, a.stages);
  if (a.stages < 2 * kMinRing || a.stages > kMaxStages ||
      (long long)L.bytes != smem ||
      L.bytes > kMaxSmem || kk < HDP / 16 || kk > HDP / 16 + 1)
    return (int)cudaErrorInvalidValue;
  int rc = configure16<HDP>(L.bytes);
  if (rc) return rc;
  const long long blocks =
      (long long)B * (a.H / kWin16) * (a.W / kWin16) * kCluster;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  Launch16 l;
  make_launch16(l, blocks, L.bytes, stream);
  cudaError_t e = cudaLaunchKernelEx(&l.cfg, swin_block16_kernel<HDP>, maps,
                                     a, kk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int HDP>
int clusters16(long long smem, int* out) {
  int rc = configure16<HDP>((size_t)smem);
  if (rc) return rc;
  Launch16 l;
  make_launch16(l, 64 * kCluster, (size_t)smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, swin_block16_kernel<HDP>,
                                             &l.cfg);
}

}  // namespace

// The 16x16-window launch of kernel (g): the arguments of adsr_swin_block
// (swin_block.cu), ``win`` 16, with the bias as its relative-position table
// [nh][961] f32 and the shift mask (null at shift 0) as each window's region
// labels [nW][256] int32 (kernel (c)'s inputs at N = 256), and ``cluster``
// (4: blocks a window). ``stages`` and ``smem`` are the ring depth and
// shared-memory size the caller planned (kernels/fused_swin_block.py
// ``swin_block_plan``); a launch whose plan differs from this file's layout
// is refused.
extern "C" int adsr_swin_block16(
    const void* x, long long ldx, void* out, long long ldo, const void* ln1_w,
    const void* ln1_b, const void* wqkv, long long ld_qkv, const void* bqkv,
    const void* table, const void* labels, const void* wproj,
    long long ld_proj, const void* bproj, const void* ln2_w,
    const void* ln2_b, const void* w1, long long ld1, const void* b1,
    const void* w2, long long ld2, const void* b2, int B, int H, int W,
    int C, int F, int nh, int win, int shift, int stages, int cluster,
    float eps, long long smem, void* stream) {
  if (win != kWin16 || H % kWin16 || W % kWin16 || B < 0 || C <= 0 ||
      C > kMaxC || C % 4 || F <= 0 || F % 4 || nh <= 0 || C % nh ||
      ldx % 4 || ldo % 4 || ldx < C || ldo < C || shift < 0 ||
      shift >= kWin16 || (shift > 0) != (labels != nullptr) ||
      cluster != kCluster)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.x = (const bf16*)x; a.ldx = ldx; a.out = (bf16*)out; a.ldo = ldo;
  a.ln1_w = (const float*)ln1_w; a.ln1_b = (const float*)ln1_b;
  a.bqkv = (const float*)bqkv; a.bias = (const float*)table;
  a.mask = (const float*)labels; a.bproj = (const float*)bproj;
  a.ln2_w = (const float*)ln2_w; a.ln2_b = (const float*)ln2_b;
  a.b1 = (const float*)b1; a.b2 = (const float*)b2;
  a.H = H; a.W = W; a.C = C; a.F = F; a.nh = nh; a.hd = C / nh;
  a.shift = shift; a.stages = stages; a.eps = eps;
  a.scale = (float)(1.0 / std::sqrt((double)a.hd));
  Maps maps;
  int rc = weight_map(&maps.qkv, wqkv, ld_qkv, 3 * C, C);
  if (!rc) rc = weight_map(&maps.proj, wproj, ld_proj, C, C);
  if (!rc) rc = weight_map(&maps.fc1, w1, ld1, F, C);
  if (!rc) rc = weight_map(&maps.fc2, w2, ld2, C, F);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((a.hd + 15) / 16) {
    case 1: return launch16<16>(a, maps, B, smem, s);
    case 2: return launch16<32>(a, maps, B, smem, s);
    case 3: return launch16<48>(a, maps, B, smem, s);
    case 4: return launch16<64>(a, maps, B, smem, s);
    case 5: return launch16<80>(a, maps, B, smem, s);
    case 6: return launch16<96>(a, maps, B, smem, s);
    case 7: return launch16<112>(a, maps, B, smem, s);
    case 8: return launch16<128>(a, maps, B, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of the 16x16-window kernel the card holds at once, for
// head dim ``hd`` and the planned shared memory ``smem``, into ``*out``
// (cudaOccupancyMaxActiveClusters: four blocks of one SM each, in one GPC)
extern "C" int adsr_swin_block16_clusters(int hd, long long smem, void* out) {
  int* n = (int*)out;
  switch ((hd + 15) / 16) {
    case 1: return clusters16<16>(smem, n);
    case 2: return clusters16<32>(smem, n);
    case 3: return clusters16<48>(smem, n);
    case 4: return clusters16<64>(smem, n);
    case 5: return clusters16<80>(smem, n);
    case 6: return clusters16<96>(smem, n);
    case 7: return clusters16<112>(smem, n);
    case 8: return clusters16<128>(smem, n);
    default: return (int)cudaErrorInvalidValue;
  }
}
