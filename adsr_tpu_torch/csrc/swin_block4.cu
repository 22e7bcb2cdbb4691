// swin_block4: one whole Swin Transformer block in one launch at 4x4
// windows (N = 16 tokens), one thread block per group of four windows:
// LN1 -> qkv -> shifted-window multi-head attention (relative-position bias
// + shift mask, stabilised softmax) -> proj + residual -> LN2 -> fc1 +
// exact-erf GELU -> fc2 + residual (8x8 windows: swin_block.cu; 16x16:
// swin_block16.cu).
//
// Replaces: the Pallas kernel fused_swin_block
// (adsr_tpu/ops/fused_swin_block.py:297, body _kernel :215, pallas_call
// :337) at window 4 (the 64/x4, 128/x8 and 32/x2 models), the per-block
// program of the "block" serving mode (adsr_tpu/ops/fused_drct.py:168-189).
// Bound on H100: operations (the weights are read from L2 by every block;
// each window's activations are read and written once).
// Design: swin_block.cu's, with four windows a thread block in place of
// one 8x8 window: 64 token rows, so every product (wgmma m64n32k16, M = 64),
// the LayerNorms, the weight ring and the epilogues of swin_block_core.cuh
// run unchanged. Two things differ:
//   - the gather and the scatter map row t of group g to window 4g + t / 16
//     over the flat (image, window) index, token t % 16 (raster row ((wi*4
//     + r + shift) mod H) * W + (wj*4 + s + shift) mod W); the last group
//     may be short, and rows past the last window are neither read nor
//     written (their f32 stream is zero, so every product stays finite);
//   - attention, per head: each of the first warpgroup's four warps runs
//     the 16-key core of window_attn_core.cuh (attn_core<HDP, 16>, shared
//     with kernel (c)) on its own window and writes its context into the
//     swizzled A tile of proj.
// At batch 16 of the 64/x4 model (256 windows) the grid is 64 blocks on
// the card's 132 SMs. Numerics are the eager model's: stabilised f32
// softmax, exact erf, no weight folds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "swin_block_core.cuh"   // ring, products, LayerNorm, launch arguments

namespace {

constexpr int kWin = 4;
constexpr int kTok = kWin * kWin;              // tokens per window
constexpr int kGroup = kBlockRows / kTok;      // windows a thread block
static_assert(kGroup == 4, "four windows a thread block: one a warp of the "
                           "first consumer warpgroup");

// Shared memory (byte offsets from the 1024-aligned base), for width C, head
// dim hd (its tile HDP = hd rounded up to 16) and ``stages`` ring stages:
//   ring   stages x 8 KB of weight tiles
//   y      the LayerNorm output as swizzled A atoms [kp / 64][64 x 64] bf16
//   ctx    one head's context, the same way (hk = ceil((hd + 7) / 64)
//          atoms: the context starts at column (h hd) % 8, so that its
//          share of Wproj starts 16-byte aligned for TMA); in the MLP, the
//          hidden chunk
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
  L.ctx = off; off += (size_t)L.hk * kAtomBytes;
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

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swin_block4_kernel(const __grid_constant__ Maps maps, const Args a,
                   int windows) {
  const int C = a.C, F = a.F, hd = a.hd;
  const Layout L = make_layout(C, hd, a.stages);
  extern __shared__ __align__(1024) unsigned char swin_smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(swin_smem);
  unsigned char* smem = swin_smem + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  RingState ring{sbase, sbase + (uint32_t)L.bars, a.stages, 0, 0u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(ring.full(s), 1);                  // the producer's arrival
      mbar_init(ring.empty(s), kMathThreads / 32); // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int grp = blockIdx.x;
  const int nw = (a.H / kWin) * (a.W / kWin);
  const int ks = (C + 63) / 64;                    // 64-wide K steps over c
  const int hk = L.hk;                             // ... over a head's dims

  if (threadIdx.x >= kMathThreads) {
    // ---- producer: every weight tile, in the consumers' order ----
    if (threadIdx.x == kMathThreads) {
      auto load = [&](const CUtensorMap* map, int row0, int rows, int k0) {
        mbar_wait(ring.empty(ring.stage), ring.phase ^ 1);
        mbar_arrive_expect_tx(ring.full(ring.stage), rows * 128);
        const uint32_t dst = sbase + ring.stage * kStageBytes;
        for (int i = 0; i < rows; i += kBoxRows)
          tma_2d(dst + i * 128, map, k0, row0 + i, ring.full(ring.stage));
        ring.advance();
      };
      for (int h = 0; h < a.nh; ++h) {
        for (int p = 0; p < 3; ++p)
          for (int n0 = 0; n0 < HDP; n0 += kStageRows)
            for (int s = 0; s < ks; ++s)
              load(&maps.qkv, p * C + h * hd + n0,
                   min(kStageRows, HDP - n0), 64 * s);
        for (int n0 = 0; n0 < C; n0 += kStageRows)    // the head's proj share
          for (int s = 0; s < hk; ++s)
            load(&maps.proj, n0, tile_rows(C - n0), (h * hd & ~7) + 64 * s);
      }
      for (int f0 = 0; f0 < F; f0 += kStageRows) {
        for (int s = 0; s < ks; ++s)
          load(&maps.fc1, f0, tile_rows(F - f0), 64 * s);
        for (int n0 = 0; n0 < C; n0 += kStageRows)
          load(&maps.fc2, n0, tile_rows(C - n0), f0);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * (warp & 3), g = lane >> 2, tq = lane & 3;
  const int wg = tid >> 7;              // consumer warpgroup
  const int cb = kHalf * wg;            // its columns of every output tile
  const int ldx = L.ldx, ldq = L.ldq, kp = L.kp;
  float* X = reinterpret_cast<float*>(smem + L.x);
  bf16* Y = reinterpret_cast<bf16*>(smem + L.y);
  bf16* Cx = reinterpret_cast<bf16*>(smem + L.ctx);
  bf16* Hb = Cx;                        // the MLP's hidden chunk, after proj
  bf16* planes = reinterpret_cast<bf16*>(smem + L.qkv);
  const uint32_t s_y = sbase + (uint32_t)L.y, s_ctx = sbase + (uint32_t)L.ctx;
  const uint32_t s_q = sbase + (uint32_t)L.qkv;
  const uint32_t plane_bytes = 2u * kBlockRows * ldq;
  float acc[16];

  // gather the group's rows into the f32 residual: every 8-byte copy in
  // flight at once, by cp.async into the Y region (LN1 overwrites it), then
  // widened, rows past the last window as zeros; the context tile is zero
  // past the head dim (proj reduces over hk atoms)
  const int q4 = C / 4;
  for (int i = tid; i < kBlockRows * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    const long long row = token_row(grp, t, windows, a.H, a.W, a.shift);
    if (row >= 0)
      cp_async<8>(s_y + 2u * (t * C + c), a.x + row * a.ldx + c, 8);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  math_barrier();
  for (int i = tid; i < kBlockRows * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    *reinterpret_cast<float4*>(X + t * ldx + c) =
        grp * kGroup + t / kTok < windows
            ? unpack4(*reinterpret_cast<const uint2*>(Y + t * C + c))
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < kBlockRows * 64 * hk; i += kMathThreads)
    Cx[i] = __float2bfloat16(0.f);
  math_barrier();
  layer_norm(X, ldx, Y, C, kp, a.ln1_w, a.ln1_b, a.eps);
  fence_async_shared();
  math_barrier();

  // ---- attention and proj, one head at a time: X += ctx_h Wproj_h^T ----
  // the first warpgroup's warp w attends window 4 grp + w (r0 = 16 w)
  const int fw = grp * kGroup + (warp & 3);
  const bool live = fw < windows;
  const float* mw = a.mask != nullptr && live
                        ? a.mask + (size_t)(fw % nw) * kTok * kTok
                        : nullptr;
  float2 vec[4];
  for (int h = 0; h < a.nh; ++h) {
    for (int p = 0; p < 3; ++p) {      // q, k, v of head h into its plane
      bf16* plane = planes + p * kBlockRows * ldq;
      for (int n0 = 0; n0 < HDP; n0 += kStageRows) {
        const int rows = min(kStageRows, HDP - n0);
        load_cols(vec, a.bqkv + p * C + h * hd, n0 + cb, rows - cb, hd);
        mma_tile(ring, s_y, ks, acc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = n0 + cb + 8 * j + 2 * tq;
          if (cb + 8 * j < rows) {     // zeros past the head dim
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
      }
    }
    math_barrier();                    // the head's planes are whole
    // the context at columns oc + d of its tile, oc = (h hd) % 8: the
    // tile's column 0 is Wproj's column h hd - oc, 16-byte aligned
    const int oc = (h * hd) & 7;
    if (wg == 0 && live) {             // the core on the first warpgroup
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
    }
    fence_async_shared();
    math_barrier();                    // the context is whole; the planes free
    for (int n0 = 0; n0 < C; n0 += kStageRows) {
      const int rows = tile_rows(C - n0);
      load_cols(vec, h == 0 ? a.bproj : nullptr, n0 + cb, rows - cb, C);
      mma_tile(ring, s_ctx, hk, acc);
      add_into_stream(X, ldx, n0 + cb, rows - cb, C, acc, vec);
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

  // ---- MLP: X += GELU(LN2(X) W1^T + b1) W2^T + b2, 64 hidden at a time ----
  layer_norm(X, ldx, Y, C, kp, a.ln2_w, a.ln2_b, a.eps);
  fence_async_shared();
  math_barrier();
  for (int f0 = 0; f0 < F; f0 += kStageRows) {
    const int rows = tile_rows(F - f0);
    load_cols(vec, a.b1 + f0, cb, rows - cb, F - f0);
    mma_tile(ring, s_y, ks, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {      // every column of the chunk, zeros
#pragma unroll                          // past F
      for (int x = 0; x < 2; ++x) {
        const int c = cb + 8 * j + 2 * tq + x;
        float u = 0.f, v = 0.f;
        if (cb + 8 * j < rows && f0 + c < F) {
          const float bb = x ? vec[j].y : vec[j].x;
          u = acc[4 * j + x] + bb;
          v = acc[4 * j + 2 + x] + bb;
          u = 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
          v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
        }
        Hb[swz(r0 + g, c)] = __float2bfloat16(u);
        Hb[swz(r0 + g + 8, c)] = __float2bfloat16(v);
      }
    }
    fence_async_shared();
    math_barrier();
    for (int n0 = 0; n0 < C; n0 += kStageRows) {
      const int rows2 = tile_rows(C - n0);
      load_cols(vec, f0 == 0 ? a.b2 : nullptr, n0 + cb, rows2 - cb, C);
      mma_tile(ring, s_ctx, 1, acc);
      add_into_stream(X, ldx, n0 + cb, rows2 - cb, C, acc, vec);
    }
    math_barrier();                    // the chunk is read before it changes
  }

  // ---- scatter the group's live rows back ----
  for (int i = tid; i < kBlockRows * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    const long long row = token_row(grp, t, windows, a.H, a.W, a.shift);
    if (row >= 0)
      *reinterpret_cast<uint2*>(a.out + row * a.ldo + c) =
          pack4(*reinterpret_cast<const float4*>(X + t * ldx + c));
  }
}

template <int HDP>
int launch(const Args& a, const Maps& maps, int B, long long smem,
           cudaStream_t stream) {
  const Layout L = make_layout(a.C, a.hd, a.stages);
  if (a.stages < 2 || a.stages > kMaxStages || (long long)L.bytes != smem ||
      L.bytes > kMaxSmem)
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
  if (windows > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const long long blocks = (windows + kGroup - 1) / kGroup;
  swin_block4_kernel<HDP><<<(unsigned)blocks, kThreads, L.bytes, stream>>>(
      maps, a, (int)windows);
  return (int)cudaGetLastError();
}

}  // namespace

// ``stages`` and ``smem`` are the ring depth and shared-memory size the
// caller planned (kernels/fused_swin_block.py ``swin_block_plan``); a launch
// whose plan differs from this file's layout is refused. The weights are
// torch Linear matrices with 16-byte rows (row strides ld*, multiples of 8).
extern "C" int adsr_swin_block4(
    const void* x, long long ldx, void* out, long long ldo, const void* ln1_w,
    const void* ln1_b, const void* wqkv, long long ld_qkv, const void* bqkv,
    const void* bias, const void* mask, const void* wproj, long long ld_proj,
    const void* bproj, const void* ln2_w, const void* ln2_b, const void* w1,
    long long ld1, const void* b1, const void* w2, long long ld2,
    const void* b2, int B, int H, int W, int C, int F, int nh, int win,
    int shift, int stages, float eps, long long smem, void* stream) {
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
    case 1: return launch<16>(a, maps, B, smem, s);
    case 2: return launch<32>(a, maps, B, smem, s);
    case 3: return launch<48>(a, maps, B, smem, s);
    case 4: return launch<64>(a, maps, B, smem, s);
    case 5: return launch<80>(a, maps, B, smem, s);
    case 6: return launch<96>(a, maps, B, smem, s);
    case 7: return launch<112>(a, maps, B, smem, s);
    case 8: return launch<128>(a, maps, B, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
