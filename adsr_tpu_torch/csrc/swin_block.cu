// swin_block: one whole Swin Transformer block in one launch, one thread
// block per (image, 8x8 window): LN1 -> qkv -> shifted-window multi-head
// attention (relative-position bias + shift mask, stabilised softmax) ->
// proj + residual -> LN2 -> fc1 + exact-erf GELU -> fc2 + residual.
//
// Replaces: the Pallas kernel fused_swin_block
// (adsr_tpu/ops/fused_swin_block.py:297, body _kernel :215, pallas_call
// :337), the per-block program of the "block" serving mode
// (adsr_tpu/ops/fused_drct.py:168-189).
// Bound on H100: operations. A block of the flagship RDG does ~1.2k flop per
// byte of its activations (the weights are read from L2 by every window),
// far above the bf16 ridge, so the bound is the tensor-core rate.
// Design: the TPU kernel keeps one image's tokens in VMEM; on Hopper the
// unit that fits in shared memory is one window. Attention is local to the
// window and everything else is row-local, so a thread block gathers the
// window's 64 token rows (the cyclic shift is index arithmetic: token (r, s)
// of shifted window (wi, wj) is raster row ((wi*8+r+shift) mod H)*W +
// (wj*8+s+shift) mod W, the map window_attention uses), keeps the residual
// stream in f32 in shared memory through the whole block, and writes the 64
// rows back once through the same map. Every product is WMMA bf16 with f32
// accumulation; the weights stream from global memory (L2-resident, at most
// ~1.1 MB a block in bf16) through one 64x64 staged tile, zero-filled past
// their edges, the next tile's loads in flight in registers while the
// current one feeds the tensor cores. qkv runs one head at a time, its head
// dim zero-padded to a multiple of 16 (30/53/122/46/77 at the flagship);
// the proj and fc2
// products accumulate straight into the f32 residual; the MLP runs in
// chunks of 64 hidden columns (fc1 + GELU into a bf16 tile, then fc2).
// Numerics are the eager model's: stabilised f32 softmax, exact erf, no
// weight folds (the TPU kernel's A&S erf polynomial was a Mosaic
// workaround). Simple and correct first: no cp.async, wgmma or TMA, one
// block per SM (the shared-memory footprint is up to ~222 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kWin = 8;
constexpr int N = kWin * kWin;    // tokens per window
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BN = 64;            // output columns per product tile
constexpr int BK = 64;            // reduction step of the staged weight tile
constexpr int LDW = BK + 8;       // bf16 pitch of the weight tile
constexpr int LDS = N + 4;        // f32 pitch of the score / staging tile
constexpr int LDP = 2 * LDS;      // bf16 pitch of P, written over the scores
constexpr int FC = 64;            // hidden columns per MLP chunk
constexpr int LDH = FC + 8;       // bf16 pitch of the hidden chunk
constexpr int kMaxC = 320;        // LayerNorm keeps <= 10 values a lane
constexpr int kMaxPerLane = kMaxC / 32;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline size_t align128(size_t v) {
  return (v + 127) / 128 * 128;
}

// Shared-memory regions (byte offsets) for channel width C.
struct Layout {
  int cp, ldx, lda, ldq;
  size_t x, y, ctx, qkv, st, w, bytes;
};

__host__ __device__ inline Layout make_layout(int C, int HDP) {
  Layout L;
  L.cp = round16(C);
  L.ldx = L.cp + 4;    // f32 residual stream [64][ldx]
  L.lda = L.cp + 8;    // bf16 LayerNorm output and context [64][lda]
  L.ldq = HDP + 8;     // bf16 q, k, v planes [3][64][ldq]
  size_t off = 0;
  L.x = off;   off += align128((size_t)N * L.ldx * 4);
  L.y = off;   off += align128((size_t)N * L.lda * 2);
  // the context; after proj, the bf16 hidden chunk of the MLP
  L.ctx = off;
  {
    const size_t a = (size_t)N * L.lda * 2, h = (size_t)N * LDH * 2;
    off += align128(a > h ? a : h);
  }
  L.qkv = off; off += align128((size_t)3 * N * L.ldq * 2);
  L.st = off;  off += align128((size_t)N * LDS * 4);   // scores / staging
  L.w = off;   off += align128((size_t)BN * LDW * 2);  // weight tile
  L.bytes = off;
  return L;
}

struct Args {
  const bf16* x; long long ldx;
  bf16* out; long long ldo;
  const float* ln1_w; const float* ln1_b;
  const bf16* wqkv; const float* bqkv;
  const float* bias; const float* mask;
  const bf16* wproj; const float* bproj;
  const float* ln2_w; const float* ln2_b;
  const bf16* w1; const float* b1;
  const bf16* w2; const float* b2;
  int H, W, C, F, nh, hd, shift;
  float eps, scale;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// ---- weight rows of each product (nullptr: a zero row) -------------------

struct QkvRows {     // output column j of head h: part j / HDP, dim j % HDP
  const bf16* w; int C, hd, hdp, h;
  __device__ const bf16* operator()(int j) const {
    const int part = j / hdp, d = j - part * hdp;
    return (part < 3 && d < hd) ? w + (long long)(part * C + h * hd + d) * C
                                : nullptr;
  }
};

struct LinearRows {  // a torch Linear [N, K] from column offset k0
  const bf16* w; int n, ld, k0;
  __device__ const bf16* operator()(int j) const {
    return j < n ? w + (long long)j * ld + k0 : nullptr;
  }
};

constexpr int kChunks = BN * BK / 4 / kThreads;   // 8-byte loads a thread
static_assert(BN * BK / 4 % kThreads == 0, "whole chunks a thread");

// Rows [n0, n0+BN) x cols [k0, k0+BK) of the weight into registers, zero
// where the row does not exist or k >= klim (every K here is a multiple
// of 4); store_weight_tile puts them into Ws.
template <class Rows>
__device__ __forceinline__ void fetch_weight_tile(uint2* v, const Rows& rows,
                                                  int n0, int k0, int klim) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
    const bf16* p = rows(n0 + r);
    v[j] = make_uint2(0u, 0u);
    if (p != nullptr && k0 + c < klim)
      v[j] = *reinterpret_cast<const uint2*>(p + k0 + c);
  }
}

__device__ __forceinline__ void store_weight_tile(bf16* Ws, const uint2* v) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
    *reinterpret_cast<uint2*>(Ws + r * LDW + c) = v[j];
  }
}

// acc (+)= A[64 x K] @ W[n0:n0+BN, :K]^T for this warp's two 16x16
// fragments: rows 16*(warp%4), columns 32*(warp/4) + {0, 16} of the tile.
// A is in shared memory and zero in its columns [K, round16(K)). The next
// weight tile is loaded into registers before this tile's products start,
// so its latency hides behind the tensor-core work.
template <class Rows>
__device__ void tile_mma(Acc* acc, const bf16* A, int lda, int K,
                         const Rows& rows, int n0, bf16* Ws) {
  const int warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  const int kp = round16(K);
  uint2 next[kChunks];
  fetch_weight_tile(next, rows, n0, 0, K);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_weight_tile(Ws, next);
    __syncthreads();
    if (k0 + BK < K) fetch_weight_tile(next, rows, n0, k0 + BK, K);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      if (k0 + kk < kp) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + r0 * lda + k0 + kk, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, Ws + (c0 + 16 * j) * LDW + kk, LDW);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    __syncthreads();
  }
}

// out[64 x Nout] = A @ W^T, each 64-column tile staged in f32 and handed to
// epi(token, column, value).
template <class Rows, class Epi>
__device__ void gemm_staged(const bf16* A, int lda, int K, int Nout,
                            const Rows& rows, bf16* Ws, float* St,
                            const Epi& epi) {
  const int warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  for (int n0 = 0; n0 < Nout; n0 += BN) {
    Acc acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    tile_mma(acc, A, lda, K, rows, n0, Ws);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(St + r0 * LDS + c0 + 16 * j, acc[j], LDS,
                              wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < N * BN; i += kThreads) {
      const int t = i / BN, c = i % BN;
      if (n0 + c < Nout) epi(t, n0 + c, St[t * LDS + c]);
    }
    __syncthreads();
  }
}

// X[64 x Nout] += A @ W^T, accumulating straight into the f32 residual.
template <class Rows>
__device__ void gemm_accumulate(float* X, int ldx, int Nout, const bf16* A,
                                int lda, int K, const Rows& rows, bf16* Ws) {
  const int warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  const int np = round16(Nout);
  for (int n0 = 0; n0 < Nout; n0 += BN) {
    Acc acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + c0 + 16 * j;
      if (col < np)
        wmma::load_matrix_sync(acc[j], X + r0 * ldx + col, ldx,
                               wmma::mem_row_major);
      else
        wmma::fill_fragment(acc[j], 0.f);
    }
    tile_mma(acc, A, lda, K, rows, n0, Ws);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + c0 + 16 * j;
      if (col < np)
        wmma::store_matrix_sync(X + r0 * ldx + col, acc[j], ldx,
                                wmma::mem_row_major);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Y[t, :C] = LayerNorm(X[t, :C]) in bf16 (f32 two-pass statistics over the
// true C), Y[t, C:cp] = 0; one warp per row.
__device__ void layer_norm(const float* X, int ldx, bf16* Y, int ldy, int C,
                           int cp, const float* __restrict__ w,
                           const float* __restrict__ b, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < N; t += kWarps) {
    const float* xr = X + t * ldx;
    float v[kMaxPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? xr[c] : 0.f;
      s += v[i];
    }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      const float d = v[i] - mu;
      q += c < C ? d * d : 0.f;
    }
    const float inv = rsqrtf(warp_sum(q) / C + eps);
    bf16* yr = Y + t * ldy;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < C)
        yr[c] = __float2bfloat16((v[i] - mu) * inv * w[c] + b[c]);
      else if (c < cp)
        yr[c] = __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ long long token_row(int b, int wi, int wj, int t,
                                               int H, int W, int shift) {
  const int r = t / kWin, s = t % kWin;
  const int row = (wi * kWin + r + shift) % H;
  const int col = (wj * kWin + s + shift) % W;
  return (long long)b * H * W + (long long)row * W + col;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swin_block_kernel(const Args a) {
  static_assert(N * (HDP + 4) * 4 <= 2 * N * (HDP + 8) * 2,
                "the f32 context tile must fit the q and k planes");
  constexpr int NF = HDP / 16;          // 16-wide fragments of a head
  constexpr int NJ = (NF + 1) / 2;      // of them per warp in P @ V
  constexpr int LDO = HDP + 4;          // f32 pitch of a head's context
  const int C = a.C, F = a.F, hd = a.hd;
  const Layout L = make_layout(C, HDP);
  const int ldx = L.ldx, lda = L.lda, ldq = L.ldq, cp = L.cp;

  extern __shared__ __align__(128) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem + L.x);
  bf16* Y = reinterpret_cast<bf16*>(smem + L.y);
  bf16* Ctx = reinterpret_cast<bf16*>(smem + L.ctx);
  bf16* Hb = Ctx;                       // the MLP's chunk, after proj
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.qkv);
  bf16* Ks = Qs + N * ldq;
  bf16* Vs = Ks + N * ldq;
  float* Os = reinterpret_cast<float*>(smem + L.qkv);   // over q and k
  float* St = reinterpret_cast<float*>(smem + L.st);
  bf16* Ps = reinterpret_cast<bf16*>(St);               // over the scores
  bf16* Ws = reinterpret_cast<bf16*>(smem + L.w);

  const int nww = a.W / kWin;
  const int nw = (a.H / kWin) * nww;
  const int win = blockIdx.x % nw;
  const int b = blockIdx.x / nw;
  const int wi = win / nww, wj = win % nww;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 3);
  const bf16 zero = __float2bfloat16(0.f);

  // gather the window's rows into the f32 residual (4 bf16 per load)
  const int q4 = C / 4;
  for (int i = threadIdx.x; i < N * q4; i += kThreads) {
    const int t = i / q4, c = (i % q4) * 4;
    const uint2 raw = *reinterpret_cast<const uint2*>(
        a.x + token_row(b, wi, wj, t, a.H, a.W, a.shift) * a.ldx + c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 lo = __bfloat1622float2(h2[0]), hi = __bfloat1622float2(h2[1]);
    *reinterpret_cast<float4*>(X + t * ldx + c) =
        make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  for (int i = threadIdx.x; i < N * (cp - C); i += kThreads) {
    const int t = i / (cp - C), c = C + i % (cp - C);
    X[t * ldx + c] = 0.f;
    Ctx[t * lda + c] = zero;            // the proj product reads [C, cp)
  }
  __syncthreads();

  layer_norm(X, ldx, Y, lda, C, cp, a.ln1_w, a.ln1_b, a.eps);
  __syncthreads();

  // ---- attention, one head at a time -------------------------------------
  const float* mw = a.mask != nullptr ? a.mask + (size_t)win * N * N : nullptr;
  for (int h = 0; h < a.nh; ++h) {
    const float* bqkv = a.bqkv;
    auto qkv_epi = [&](int t, int j, float v) {
      const int part = j / HDP, d = j - part * HDP;
      const float val = d < hd ? v + bqkv[part * C + h * hd + d] : 0.f;
      Qs[part * N * ldq + t * ldq + d] = __float2bfloat16(val);
    };
    gemm_staged(Y, lda, C, 3 * HDP, QkvRows{a.wqkv, C, hd, HDP, h}, Ws, St,
                qkv_epi);

    {  // scores S = Q K^T: this warp's rows x 32 keys
      const int c0 = 32 * (warp >> 2);
      Acc s[2];
      wmma::fill_fragment(s[0], 0.f);
      wmma::fill_fragment(s[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < HDP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf;
        wmma::load_matrix_sync(qf, Qs + r0 * ldq + kk, ldq);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, Ks + (c0 + 16 * j) * ldq + kk, ldq);
          wmma::mma_sync(s[j], qf, kf, s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(St + r0 * LDS + c0 + 16 * j, s[j], LDS,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // stabilised softmax in f32, 8 rows a warp, lane owns keys lane and
    // lane + 32; P (bf16) is written over the row's own scores
    const float* bh = a.bias + (size_t)h * N * N;
    for (int r = warp * (N / kWarps); r < (warp + 1) * (N / kWarps); ++r) {
      float x0 = St[r * LDS + lane] * a.scale + bh[r * N + lane];
      float x1 = St[r * LDS + lane + 32] * a.scale + bh[r * N + lane + 32];
      if (mw != nullptr) {
        x0 += mw[r * N + lane];
        x1 += mw[r * N + lane + 32];
      }
      const float mx = warp_max(fmaxf(x0, x1));
      const float e0 = expf(x0 - mx), e1 = expf(x1 - mx);
      const float inv = 1.f / warp_sum(e0 + e1);
      __syncwarp();
      Ps[r * LDP + lane] = __float2bfloat16(e0 * inv);
      Ps[r * LDP + lane + 32] = __float2bfloat16(e1 * inv);
    }
    __syncthreads();

    {  // context O = P V into f32 over the q and k planes (both done)
      const int jw = warp >> 2;
      Acc o[NJ];
#pragma unroll
      for (int i = 0; i < NJ; ++i) wmma::fill_fragment(o[i], 0.f);
#pragma unroll
      for (int kk = 0; kk < N; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::load_matrix_sync(pf, Ps + r0 * LDP + kk, LDP);
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int j = jw + 2 * i;
          if (j < NF) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                vf;
            wmma::load_matrix_sync(vf, Vs + kk * ldq + 16 * j, ldq);
            wmma::mma_sync(o[i], pf, vf, o[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = jw + 2 * i;
        if (j < NF)
          wmma::store_matrix_sync(Os + r0 * LDO + 16 * j, o[i], LDO,
                                  wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      Ctx[t * lda + h * hd + d] = __float2bfloat16(Os[t * LDO + d]);
    }
    __syncthreads();
  }

  // ---- proj + residual: X += bproj, then X += ctx @ Wproj^T --------------
  for (int i = threadIdx.x; i < N * C; i += kThreads)
    X[(i / C) * ldx + i % C] += a.bproj[i % C];
  __syncthreads();
  gemm_accumulate(X, ldx, C, Ctx, lda, C, LinearRows{a.wproj, C, C, 0}, Ws);

  // ---- MLP: X += b2, then per chunk X += GELU(LN2(X) W1^T + b1) W2^T -----
  layer_norm(X, ldx, Y, lda, C, cp, a.ln2_w, a.ln2_b, a.eps);
  __syncthreads();                      // every row read before b2 lands
  for (int i = threadIdx.x; i < N * C; i += kThreads)
    X[(i / C) * ldx + i % C] += a.b2[i % C];
  __syncthreads();
  for (int f0 = 0; f0 < F; f0 += FC) {
    const float* b1 = a.b1;
    auto fc1_epi = [&](int t, int j, float v) {
      const int f = f0 + j;
      float g = 0.f;
      if (f < F) {
        v += b1[f];
        g = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      }
      Hb[t * LDH + j] = __float2bfloat16(g);
    };
    gemm_staged(Y, lda, C, FC, LinearRows{a.w1 + (long long)f0 * C, F - f0,
                                          C, 0},
                Ws, St, fc1_epi);
    const int kc = F - f0 < FC ? F - f0 : FC;
    gemm_accumulate(X, ldx, C, Hb, LDH, kc, LinearRows{a.w2, C, F, f0}, Ws);
  }

  // ---- scatter the window's rows back --------------------------------------
  for (int i = threadIdx.x; i < N * q4; i += kThreads) {
    const int t = i / q4, c = (i % q4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(X + t * ldx + c);
    __nv_bfloat162 h2[2] = {__floats2bfloat162_rn(v.x, v.y),
                            __floats2bfloat162_rn(v.z, v.w)};
    *reinterpret_cast<uint2*>(
        a.out + token_row(b, wi, wj, t, a.H, a.W, a.shift) * a.ldo + c) =
        *reinterpret_cast<const uint2*>(h2);
  }
}

template <int HDP>
int launch(const Args& a, int B, cudaStream_t stream) {
  const Layout L = make_layout(a.C, HDP);
  if (L.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t configured = 0;   // per template instance
  if (L.bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        swin_block_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L.bytes);
    if (e != cudaSuccess) return (int)e;
    configured = L.bytes;
  }
  const long long blocks = (long long)B * (a.H / kWin) * (a.W / kWin);
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  swin_block_kernel<HDP><<<(unsigned)blocks, kThreads, L.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int adsr_swin_block(
    const void* x, long long ldx, void* out, long long ldo, const void* ln1_w,
    const void* ln1_b, const void* wqkv, const void* bqkv, const void* bias,
    const void* mask, const void* wproj, const void* bproj, const void* ln2_w,
    const void* ln2_b, const void* w1, const void* b1, const void* w2,
    const void* b2, int B, int H, int W, int C, int F, int nh, int win,
    int shift, float eps, void* stream) {
  if (win != kWin || H % kWin || W % kWin || B < 0 || C <= 0 || C > kMaxC ||
      C % 4 || F <= 0 || F % 4 || nh <= 0 || C % nh || ldx % 4 || ldo % 4 ||
      ldx < C || ldo < C || shift < 0 || shift >= kWin ||
      (shift > 0) != (mask != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.x = (const bf16*)x; a.ldx = ldx; a.out = (bf16*)out; a.ldo = ldo;
  a.ln1_w = (const float*)ln1_w; a.ln1_b = (const float*)ln1_b;
  a.wqkv = (const bf16*)wqkv; a.bqkv = (const float*)bqkv;
  a.bias = (const float*)bias; a.mask = (const float*)mask;
  a.wproj = (const bf16*)wproj; a.bproj = (const float*)bproj;
  a.ln2_w = (const float*)ln2_w; a.ln2_b = (const float*)ln2_b;
  a.w1 = (const bf16*)w1; a.b1 = (const float*)b1;
  a.w2 = (const bf16*)w2; a.b2 = (const float*)b2;
  a.H = H; a.W = W; a.C = C; a.F = F; a.nh = nh; a.hd = C / nh;
  a.shift = shift; a.eps = eps;
  a.scale = (float)(1.0 / std::sqrt((double)a.hd));
  cudaStream_t s = (cudaStream_t)stream;
  switch ((a.hd + 15) / 16) {
    case 1: return launch<16>(a, B, s);
    case 2: return launch<32>(a, B, s);
    case 3: return launch<48>(a, B, s);
    case 4: return launch<64>(a, B, s);
    case 5: return launch<80>(a, B, s);
    case 6: return launch<96>(a, B, s);
    case 7: return launch<112>(a, B, s);
    case 8: return launch<128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
