// swin_block4: one whole Swin Transformer block in one launch at 4x4
// windows (N = 16 tokens), per group of four windows one thread block or a
// cluster of two: LN1 -> qkv -> shifted-window multi-head attention
// (relative-position bias + shift mask, stabilised softmax) -> proj +
// residual -> LN2 -> fc1 + exact-erf GELU -> fc2 + residual (8x8 windows:
// swin_block.cu; 16x16: swin_block16.cu).
//
// Replaces: the Pallas kernel fused_swin_block
// (adsr_tpu/ops/fused_swin_block.py:297, body _kernel :215, pallas_call
// :337) at window 4 (the 64/x4, 128/x8 and 32/x2 models), the per-block
// program of the "block" serving mode (adsr_tpu/ops/fused_drct.py:168-189).
// Bound on H100: operations (the weights are read from L2 by every block;
// each window's activations are read and written once).
// Design: a thread block holds four windows, 64 token rows, in an f32
// residual stream in shared memory, so every product has M = 64 and runs on
// the ping-pong path of swin_block_core.cuh (m64n64k16, a warpgroup a
// 64-column output tile, the tiles alternating between the two
// warpgroups); q, k and v of a head are one product of 3 HDP columns, the
// MLP runs in hidden chunks of 128 (fc1 one tile a warpgroup, then fc2 with
// K = 128).
//   - the gather and the scatter map row t of group g to window 4g + t / 16
//     over the flat (image, window) index, token t % 16 (raster row ((wi*4
//     + r + shift) mod H) * W + (wj*4 + s + shift) mod W); the last group
//     may be short, and rows past the last window are neither read nor
//     written (their f32 stream is zero, so every product stays finite);
//   - attention, per head: each of the first warpgroup's four warps runs
//     the 16-key core of window_attn_core.cuh (attn_core<HDP, 16>, shared
//     with kernel (c)) on its own window and writes its context into the
//     swizzled A tile of proj.
// At batch 16 of the 64/x4 model there are 64 groups, half the card's 132
// SMs. Where the grid of groups leaves half the card idle (the plan's
// ``cluster``: 2 when two blocks a group still fit one wave), a cluster of
// two blocks shares each group. Block r owns rows [32 r, 32 r + 32) of the
// group: its f32 stream starts as the group's tokens there and zeros in
// the peer's rows, and it takes heads h = r mod 2 (qkv, attention, and
// their share of proj over all 64 rows) and hidden chunks i = r mod 2 (fc1,
// fc2), so that the two streams sum to the block's. Through distributed
// shared memory (ld.shared::cluster):
//   - LN1 and LN2 of its own rows, the peer's half of the LayerNorm output
//     copied in after a cluster barrier (every product needs all 64 rows);
//   - after proj each block adds the peer's partial into its own rows
//     (then LN2 there), and at the end it adds the peer's partial into
//     its own rows and stores them; its other rows then restart at zero.
// The sums run in a fixed order (own + peer), with four more cluster
// barriers than the lone block; the producer warp takes part in each,
// arriving before it streams the tiles that the consumers need after it.
// No atomics: the output is bitwise repeatable. Numerics are the eager
// model's: stabilised f32 softmax, exact erf, no weight folds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "swin_block_core.cuh"   // ring, products, LayerNorm, launch arguments

namespace {

constexpr int kWin = 4;
constexpr int kTok = kWin * kWin;              // tokens per window
constexpr int kGroup = kBlockRows / kTok;      // windows a thread block
constexpr int kChunk = 128;                    // hidden columns a chunk
constexpr int kMaxSplit = 2;                   // blocks a group
constexpr int kPeerBatch = 4;                  // 16-byte peer loads in flight
constexpr bool kAttend = true;     // the attention core
constexpr bool kExchange = true;   // the peer blocks' rows (with a cluster)
static_assert(kGroup == 4, "four windows a thread block: one a warp of the "
                           "first consumer warpgroup");

// Shared memory (byte offsets from the 1024-aligned base), for width C, head
// dim hd (its tile HDP = hd rounded up to 16) and ``stages`` ring stages:
//   ring   stages x 8 KB of weight tiles
//   y      the LayerNorm output as swizzled A atoms [kp / 64][64 x 64] bf16
//   ctx    one head's context, the same way (hk = ceil((hd + 7) / 64)
//          atoms: the context starts at column (h hd) % 8, so that its
//          share of Wproj starts 16-byte aligned for TMA); in the MLP, the
//          128-wide hidden chunk (two atoms at least)
//   x      the f32 residual stream [64][ldx] (ldx = 8 mod 16: the
//          accumulator layout's float2 stores hit 32 distinct banks)
//   qkv    one head's q, k, v planes [3][64][hdp + 8] bf16 (16 rows a
//          window)
//   bars   a full and an empty mbarrier a stage
struct Layout {
  int kp, hk, ldx, ldq;
  size_t y, ctx, x, qkv, bars, bytes;
};

__host__ __device__ inline Layout make_layout(int C, int hd, int stages) {
  const int HDP = round16(hd);
  Layout L;
  L.kp = (C + 63) / 64 * 64;
  L.hk = (hd + 7 + 63) / 64;
  L.ldx = C + (24 - C % 16) % 16;
  L.ldq = HDP + 8;
  size_t off = (size_t)stages * kStageBytes;
  L.y = off;   off += (size_t)L.kp / 64 * kAtomBytes;
  L.ctx = off; off += (size_t)(L.hk > 2 ? L.hk : 2) * kAtomBytes;
  L.x = off;   off += (size_t)kBlockRows * L.ldx * 4;
  L.qkv = off; off += (size_t)3 * kBlockRows * L.ldq * 2;
  L.bars = off; off += (size_t)16 * stages;
  L.bytes = 1024 + off;          // room to align the base to 1024 bytes
  return L;
}

// The raster row of row t of group ``grp`` (window 4 grp + t / 16, token
// t % 16), or -1 past the last window
__device__ __forceinline__ long long token_row(int grp, int t, int windows,
                                               int H, int W, int shift) {
  const int fw = grp * kGroup + t / kTok;
  if (fw >= windows) return -1;
  const int nww = W / kWin, nw = (H / kWin) * nww;
  const int b = fw / nw, win = fw - b * nw;
  const int wi = win / nww, wj = win - wi * nww;
  const int tt = t % kTok;
  const int row = (wi * kWin + tt / kWin + shift) % H;
  const int col = (wj * kWin + tt % kWin + shift) % W;
  return (long long)b * H * W + (long long)row * W + col;
}

// Rows [r0, r0 + 32) of the f32 stream X (shared address ``sx``) from the
// peer block's: X += peer (``add``; X_0 + X_1 in either block, f32 addition
// being commutative) or X = peer, by the consumer threads, ``kPeerBatch``
// 16-byte loads in flight a thread
__device__ __forceinline__ void peer_rows(float* X, uint32_t sx,
                                          uint32_t peer, int ldx, int C,
                                          int r0, bool add) {
  const uint32_t remote = peer_addr(sx, peer);
  const int q4 = C / 4, n = (kBlockRows / 2) * q4;
  for (int base = threadIdx.x; base < n; base += kMathThreads * kPeerBatch) {
    uint4 v[kPeerBatch];
#pragma unroll
    for (int u = 0; u < kPeerBatch; ++u) {
      const int i = base + u * kMathThreads, t = i / q4;
      if (i < n)
        v[u] = ld_cluster16(remote + 4u * ((r0 + t) * ldx + 4 * (i - t * q4)));
    }
#pragma unroll
    for (int u = 0; u < kPeerBatch; ++u) {
      const int i = base + u * kMathThreads, t = i / q4;
      if (i < n) {
        float4* p = reinterpret_cast<float4*>(X + (r0 + t) * ldx
                                              + 4 * (i - t * q4));
        const float4 w = *reinterpret_cast<const float4*>(&v[u]);
        if (add) {
          float4 o = *p;
          o.x += w.x; o.y += w.y; o.z += w.z; o.w += w.w;
          *p = o;
        } else {
          *p = w;
        }
      }
    }
  }
}

// Rows [r0, r0 + 32) of each of the ``atoms`` swizzled atoms at shared
// address ``sy`` (a LayerNorm output) from the peer block's, by the
// consumer threads (a row is 128 bytes of an atom), made visible to wgmma
__device__ __forceinline__ void peer_atom_rows(uint32_t sy, uint32_t peer,
                                               int atoms, int r0) {
  const uint32_t remote = peer_addr(sy, peer);
  constexpr int kChunks = (kBlockRows / 2) * 128 / 16;   // 16-byte a row half
  const int n = atoms * kChunks;
  for (int base = threadIdx.x; base < n; base += kMathThreads * kPeerBatch) {
    uint4 v[kPeerBatch];
#pragma unroll
    for (int u = 0; u < kPeerBatch; ++u) {
      const int i = base + u * kMathThreads;
      const uint32_t off = (uint32_t)((i / kChunks) * kAtomBytes + r0 * 128
                                      + (i % kChunks) * 16);
      if (i < n) v[u] = ld_cluster16(remote + off);
    }
#pragma unroll
    for (int u = 0; u < kPeerBatch; ++u) {
      const int i = base + u * kMathThreads;
      const uint32_t off = (uint32_t)((i / kChunks) * kAtomBytes + r0 * 128
                                      + (i % kChunks) * 16);
      if (i < n)
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(sy + off), "r"(v[u].x), "r"(v[u].y),
                        "r"(v[u].z), "r"(v[u].w) : "memory");
    }
  }
  fence_async_shared();
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swin_block4_kernel(const __grid_constant__ Maps maps, const Args a,
                   int windows, int split) {
  const int C = a.C, F = a.F, hd = a.hd;
  const Layout L = make_layout(C, hd, a.stages);
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

  // the block's share of the group: heads h and hidden chunks i with
  // h, i = rank mod split
  const uint32_t rank = split > 1 ? cluster_rank() : 0u;
  const int grp = blockIdx.x / split;
  const int nw = (a.H / kWin) * (a.W / kWin);
  const int ks = (C + 63) / 64;                    // 64-wide K steps over c
  const int hk = L.hk;                             // ... over a head's dims

  if (threadIdx.x >= kMathThreads) {
    // ---- producer warp: the block's weight tiles, in the consumers' order
    const bool leader = threadIdx.x == kMathThreads;
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
    if (split > 1) cluster_arrive();  // LN1's halves (waited below)
    for (int h = rank; h < a.nh; h += split) {
      // q, k, v of head h as one product: column v of it is Wqkv's row
      // p C + h hd + d, p = v / HDP, d = v % HDP (a box never straddles
      // two parts: HDP % 16 == 0)
      for (int n0 = 0; n0 < 3 * HDP; n0 += kStageRows, tile())
        for (int s = 0; s < ks; ++s)
          load(&maps.qkv, min(kStageRows, 3 * HDP - n0), 64 * s, [&](int i) {
            const int v = n0 + i, p = v / HDP;
            return p * C + h * hd + v - p * HDP;
          });
      for (int n0 = 0; n0 < C; n0 += kStageRows, tile())   // its proj share
        for (int s = 0; s < hk; ++s)
          load(&maps.proj, tile_rows(C - n0), (h * hd & ~7) + 64 * s,
               [&](int i) { return n0 + i; });
    }
    if (split > 1) {                  // the consumers' first exchange
      __syncwarp();
      cluster_wait();
      cluster_sync();
      cluster_arrive();
    }
    for (int f0 = kChunk * rank; f0 < F; f0 += kChunk * split) {
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
    if (split > 1) {                  // the last exchange, then exit
      __syncwarp();
      cluster_wait();
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * (warp & 3), g = lane >> 2, tq = lane & 3;
  const int wg = tid >> 7;              // consumer warpgroup
  const int ldx = L.ldx, ldq = L.ldq, kp = L.kp;
  float* X = reinterpret_cast<float*>(smem + L.x);
  bf16* Y = reinterpret_cast<bf16*>(smem + L.y);
  bf16* Cx = reinterpret_cast<bf16*>(smem + L.ctx);
  bf16* Hb = Cx;                        // the MLP's hidden chunk, after proj
  bf16* planes = reinterpret_cast<bf16*>(smem + L.qkv);
  const uint32_t s_y = sbase + (uint32_t)L.y, s_ctx = sbase + (uint32_t)L.ctx;
  const uint32_t s_q = sbase + (uint32_t)L.qkv, s_x = sbase + (uint32_t)L.x;
  const uint32_t plane_bytes = 2u * kBlockRows * ldq;
  RingState ring = split_ring(sbase, sbars, a.stages, wg);
  float acc[32];
  float2 vec[8];
  Turn turn;

  // gather the block's own rows into the f32 residual (with a peer, rows
  // [32 r, 32 r + 32); else all 64): every 8-byte copy in flight at once,
  // by cp.async into the Y region (LN1 overwrites it), then widened; the
  // other rows, and rows past the last window, as zeros; the context tile
  // is zero past the head dim (proj reduces over hk atoms)
  const uint32_t peer = rank ^ 1u;
  const int own0 = split > 1 ? 32 * (int)rank : 0;
  const int own_n = kBlockRows / split;
  const int q4 = C / 4;
  for (int i = tid; i < own_n * q4; i += kMathThreads) {
    const int t = own0 + i / q4, c = (i - (t - own0) * q4) * 4;
    const long long row = token_row(grp, t, windows, a.H, a.W, a.shift);
    if (row >= 0)
      cp_async<8>(s_y + 2u * (t * C + c), a.x + row * a.ldx + c, 8);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  math_barrier();
  for (int i = tid; i < kBlockRows * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    *reinterpret_cast<float4*>(X + t * ldx + c) =
        t - own0 >= 0 && t - own0 < own_n &&
                grp * kGroup + t / kTok < windows
            ? unpack4(*reinterpret_cast<const uint2*>(Y + t * C + c))
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < kBlockRows * 64 * hk; i += kMathThreads)
    Cx[i] = __float2bfloat16(0.f);
  math_barrier();
  if (split > 1) {                     // LN1 of its rows, the peer's copied
    layer_norm<kBlockRows / 2>(X, ldx, Y, C, kp, a.ln1_w, a.ln1_b, a.eps,
                               own0);
    cluster_sync();
    if (kExchange)
      SWIN_TIMED(kProfExchange,
                 peer_atom_rows(s_y, peer, kp / 64, 32 * (int)peer));
  } else {
    layer_norm(X, ldx, Y, C, kp, a.ln1_w, a.ln1_b, a.eps);
  }
  fence_async_shared();
  math_barrier();

  // ---- attention and proj, one head at a time: X += ctx_h Wproj_h^T ----
  // the first warpgroup's warp w attends window 4 grp + w (r0 = 16 w)
  const int fw = grp * kGroup + (warp & 3);
  const bool live = fw < windows;
  const float* mw = a.mask != nullptr && live
                        ? a.mask + (size_t)(fw % nw) * kTok * kTok
                        : nullptr;
  for (int h = rank; h < a.nh; h += split) {
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
          bf16* plane = planes + p * kBlockRows * ldq;
          const bool in0 = d < hd, in1 = d + 1 < hd;
          *reinterpret_cast<__nv_bfloat162*>(plane + (r0 + g) * ldq + d) =
              __floats2bfloat162_rn(in0 ? acc[4 * j] + vec[j].x : 0.f,
                                    in1 ? acc[4 * j + 1] + vec[j].y : 0.f);
          *reinterpret_cast<__nv_bfloat162*>(plane + (r0 + g + 8) * ldq
                                             + d) =
              __floats2bfloat162_rn(in0 ? acc[4 * j + 2] + vec[j].x : 0.f,
                                    in1 ? acc[4 * j + 3] + vec[j].y : 0.f);
        }
      }
      SWIN_CLOCK_END(kProfEpilogue, t_qkv);
    }
    math_barrier();                    // the head's planes are whole
    // the context at columns oc + d of its tile, oc = (h hd) % 8: the
    // tile's column 0 is Wproj's column h hd - oc, 16-byte aligned
    const int oc = (h * hd) & 7;
    if (kAttend && wg == 0 && live) {  // the core on the first warpgroup
      SWIN_CLOCK_BEGIN(t_attn);
      const uint32_t sw = s_q + 2u * r0 * ldq;   // the warp's window
      float o[HDP / 8][4];
      attn_core<HDP, kTok>(sw, sw + plane_bytes, sw + 2 * plane_bytes, ldq,
                           0, a.bias + (size_t)h * kTok * kTok, mw, a.scale,
                           o);
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int d = 8 * j + 2 * tq + x;
          if (d < hd) {
            Cx[swz(r0 + g, oc + d)] = __float2bfloat16(o[j][x]);
            Cx[swz(r0 + g + 8, oc + d)] = __float2bfloat16(o[j][2 + x]);
          }
        }
      }
      SWIN_CLOCK_END(kProfAttention, t_attn);
    }
    fence_async_shared();
    math_barrier();                    // the context is whole; the planes free
    for (int n0 = 0; n0 < C; n0 += kStageRows) {
      const int n = tile_rows(C - n0);
      if (!turn.mine()) continue;
      load_cols64(vec, h == 0 ? a.bproj : nullptr, n0, n, C);
      mma_tile64(ring, s_ctx, hk, acc);
      add_into_stream64(X, ldx, n0, n, C, acc, vec);
    }
    math_barrier();                    // the context is read before it changes
    // back to zeros, so the next head's tile is zero off its own columns
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int d = 8 * j + 2 * tq + x;
          if (d < hd) {
            Cx[swz(r0 + g, oc + d)] = __float2bfloat16(0.f);
            Cx[swz(r0 + g + 8, oc + d)] = __float2bfloat16(0.f);
          }
        }
      }
    }
  }

  // ---- LN2 of the block's rows of X = X_0 + X_1 ----
  if (split > 1) {
    cluster_sync();                    // both partial streams whole
    if (kExchange)
      SWIN_TIMED(kProfExchange,
                 peer_rows(X, s_x, peer, ldx, C, own0, true));
    math_barrier();
    layer_norm<kBlockRows / 2>(X, ldx, Y, C, kp, a.ln2_w, a.ln2_b, a.eps,
                               own0);
    cluster_sync();                    // both halves of LN2 whole; the peer
    if (kExchange)                     // has read this block's rows
      SWIN_TIMED(kProfExchange,
                 peer_atom_rows(s_y, peer, kp / 64, 32 * (int)peer));
    for (int i = tid; i < (kBlockRows / 2) * q4; i += kMathThreads) {
      const int t = 32 * (int)peer + i / q4, c = (i - (i / q4) * q4) * 4;
      *reinterpret_cast<float4*>(X + t * ldx + c) =     // the peer's rows
          make_float4(0.f, 0.f, 0.f, 0.f);              // restart at zero
    }
  } else {
    math_barrier();
    layer_norm(X, ldx, Y, C, kp, a.ln2_w, a.ln2_b, a.eps);
  }
  fence_async_shared();
  math_barrier();

  // ---- MLP: X += GELU(LN2(X) W1^T + b1) W2^T + b2, 128 hidden at a time ----
  for (int f0 = kChunk * rank; f0 < F; f0 += kChunk * split) {
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
      mma_tile64(ring, s_ctx, kf, acc);
      add_into_stream64(X, ldx, n0, n, C, acc, vec);
    }
    math_barrier();                    // the chunk is read before it changes
  }

  // ---- out: the block's own live rows (with a peer: X_0 + X_1) ----
  if (split > 1) {
    cluster_sync();                    // both partial streams whole
    if (kExchange)
      SWIN_TIMED(kProfExchange,
                 peer_rows(X, s_x, peer, ldx, C, own0, true));
    math_barrier();
  }
  for (int i = tid; i < own_n * q4; i += kMathThreads) {
    const int t = own0 + i / q4, c = (i - (t - own0) * q4) * 4;
    const long long row = token_row(grp, t, windows, a.H, a.W, a.shift);
    if (row >= 0)
      *reinterpret_cast<uint2*>(a.out + row * a.ldo + c) =
          pack4(*reinterpret_cast<const float4*>(X + t * ldx + c));
  }
  if (split > 1) cluster_sync();       // no peer reads this block any more
  SWIN_SPAN_END(t_kernel);
}

template <int HDP>
int launch(const Args& a, const Maps& maps, int B, int split, long long smem,
           cudaStream_t stream) {
  const Layout L = make_layout(a.C, a.hd, a.stages);
  if (a.stages < 2 * kMinRing || a.stages > kMaxStages ||
      (long long)L.bytes != smem ||
      L.bytes > kMaxSmem || split < 1 || split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  static size_t configured = 0;   // per template instance
  if (L.bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        swin_block4_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L.bytes);
    if (e != cudaSuccess) return (int)e;
    configured = L.bytes;
  }
  const long long windows = (long long)B * (a.H / kWin) * (a.W / kWin);
  const long long blocks = (windows + kGroup - 1) / kGroup * split;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, swin_block4_kernel<HDP>, maps, a,
                                     (int)windows, split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// ``stages`` and ``smem`` are the ring depth and shared-memory size the
// caller planned, ``cluster`` the blocks a group of four windows (1 or 2)
// (kernels/fused_swin_block.py ``swin_block_plan``); a launch whose plan
// differs from this file's layout is refused. The weights are torch Linear
// matrices with 16-byte rows (row strides ld*, multiples of 8).
extern "C" int adsr_swin_block4(
    const void* x, long long ldx, void* out, long long ldo, const void* ln1_w,
    const void* ln1_b, const void* wqkv, long long ld_qkv, const void* bqkv,
    const void* bias, const void* mask, const void* wproj, long long ld_proj,
    const void* bproj, const void* ln2_w, const void* ln2_b, const void* w1,
    long long ld1, const void* b1, const void* w2, long long ld2,
    const void* b2, int B, int H, int W, int C, int F, int nh, int win,
    int shift, int stages, int cluster, float eps, long long smem,
    void* stream) {
  if (win != kWin || H % kWin || W % kWin || B < 0 || C <= 0 || C > kMaxC ||
      C % 4 || F <= 0 || F % 4 || nh <= 0 || C % nh || ldx % 4 || ldo % 4 ||
      ldx < C || ldo < C || shift < 0 || shift >= kWin ||
      (shift > 0) != (mask != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.x = (const bf16*)x; a.ldx = ldx; a.out = (bf16*)out; a.ldo = ldo;
  a.ln1_w = (const float*)ln1_w; a.ln1_b = (const float*)ln1_b;
  a.bqkv = (const float*)bqkv; a.bias = (const float*)bias;
  a.mask = (const float*)mask; a.bproj = (const float*)bproj;
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
    case 1: return launch<16>(a, maps, B, cluster, smem, s);
    case 2: return launch<32>(a, maps, B, cluster, smem, s);
    case 3: return launch<48>(a, maps, B, cluster, smem, s);
    case 4: return launch<64>(a, maps, B, cluster, smem, s);
    case 5: return launch<80>(a, maps, B, cluster, smem, s);
    case 6: return launch<96>(a, maps, B, cluster, smem, s);
    case 7: return launch<112>(a, maps, B, cluster, smem, s);
    case 8: return launch<128>(a, maps, B, cluster, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
