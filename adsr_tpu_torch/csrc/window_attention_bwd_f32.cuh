// window_attention_bwd_f32.cuh: the backward of the shifted-window
// multi-head self-attention in full f32 (fp32 training) over 4x4, 8x8 and
// 16x16 windows (N = 16, 64 and 256 tokens).
//
//   S = scale q k^T + bias (+ mask),  P = softmax(S),  D = rowsum(dO o O)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q,  d(bias) = sum over windows of dS
//
// Replaces: the attention backward phases of the Pallas kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770, called from _rdg_train_bwd
// :968) at dtype f32, where the TPU kernel stages in f32 with f32
// accumulators (fused_rdg_train.py:442, 961-967). The bf16 instances are
// window_attention_bwd{4,,16}.cu.
// Bound on H100: bytes at N = 16 and 64 (qkv, dO and dqkv once; the
// products of 64 x 64 a head are cheap), operations at N = 256 (ten
// 256 x 256 x hd products a head in f32 FFMA).
// Design: every product in f32 on the CUDA cores, the operand planes in
// shared memory as the forward's (window_attention_f32.cuh, whose staging,
// row map and bias / mask lookups this file reuses): a head's rows of q, k,
// v and dO staged from the 16-byte pieces that hold its columns (head dims
// 30, 53, 122, 46 and 77 at the flagship start on any 4-byte column) and
// sliced out in registers into planes [R][hdp + 4], zero-padded. Scores and
// dP tiles are a 16 x 16 grid of threads, R / 16 x R / 16 values each, a
// row's sums half-warp shuffles; the three output products take a thread's
// rows and four head dims, reading P and dS from shared tiles [R][R + 4].
// - N = 16 and 64 (R = N, the whole window in one tile): one launch, a
//   block per (group of ``group`` consecutive windows, head): for each
//   window it recomputes the stabilised softmax from q, k, the bias and
//   the mask, D = rowsum(P o dP), dS, then dQ, dK and dV, written into the
//   head's columns of the raster-order dqkv; dS is summed over the group's
//   windows in registers into one d(bias) partial [N][N] a (group, head).
// - N = 256 (R = 64): FlashAttention-2's deterministic backward in two
//   launches, as the bf16 kernels (window_attention_bwd16.cu): P from the
//   forward's softmax statistics (kernel (c) writes (max, 1 / sum) a query
//   row) and D = rowsum(dO o O) from the forward's context. ``dq``: a block
//   per (window, head, query tile) computes D of its rows (written to
//   ``dsum`` for the second launch), sweeps the four key tiles and writes
//   dQ. ``dkv``: a block per (group of windows, head, key tile) walks its
//   group's windows and each window's four query tiles, accumulates dK and
//   dV of its keys in registers and the [256][64] d(bias) columns of its
//   keys in registers over the group, and writes one partial a (group,
//   head). The bias comes from the relative-position table and the mask
//   from the region labels, so a 16x16 window's f32 bias (256 KB) is never
//   staged.
// partials.cuh's sum_partials adds the d(bias) partials in a fixed order:
// no atomics, bitwise repeatable; nothing survives a launch.
//
// One source a window includes this file (window_attention_bwd4_f32.cu,
// window_attention_bwd_f32.cu, window_attention_bwd16_f32.cu), so nvcc
// builds the three windows' instances in parallel.

#pragma once

#include "partials.cuh"
#include "window_attention_f32.cuh"

namespace {

constexpr int kMaxPartialBlocks = 1 << 20;

// the thread layouts of a 256-thread block for R rows and a head tile HDP
template <int N, int HDP>
struct BwdGeo {
  static constexpr int R = Geo<N>::R;
  static constexpr int SR = R / 16;       // scores a thread a dim
  static constexpr int SP = Geo<N>::kSP;  // floats a row of a P / dS tile
  static constexpr int P = kPitch<HDP>;   // floats a row of a plane
  static constexpr int G4 = HDP / 4;      // head-dim quads
  static constexpr int RS = kThreads / G4;  // product rows a pass
  static constexpr int RPT = (R + RS - 1) / RS;
  static constexpr size_t kPlanes = 4ull * R * P;   // q, k, v, dO
  static constexpr size_t kTile = (size_t)R * SP;
};

// shared memory of each kernel, in bytes (kernels/window_attention_bwd.py
// ``window_attention_bwd_f32_plan``): the four planes, then the P and dS
// tiles (the dq launch only dS), then (N = 256) each row's max, 1 / sum
// and D
template <int N, int HDP>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  using G = BwdGeo<N, HDP>;
  return 4 * (G::kPlanes + 2 * G::kTile + (N == 256 ? 3 * G::R : 0));
}

template <int HDP>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  using G = BwdGeo<256, HDP>;
  return 4 * (G::kPlanes + G::kTile + 3 * G::R);
}

// zero the padded head dims of the four planes (the staged rows write head
// dims below hd only, so they stay zero)
template <int N, int HDP>
__device__ __forceinline__ void zero_pads(float* planes, int hd) {
  using G = BwdGeo<N, HDP>;
  if (HDP > hd) {
    const int pad = HDP - hd;
    for (int i = threadIdx.x; i < 4 * G::R * pad; i += kThreads) {
      const int row = i / pad;
      planes[row * G::P + hd + (i - row * pad)] = 0.f;
    }
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over the head dims
template <int N, int HDP>
__device__ __forceinline__ void dot_tile(
    const float* a, const float* b, int ty, int tx,
    float (&s)[BwdGeo<N, HDP>::SR][BwdGeo<N, HDP>::SR]) {
  using G = BwdGeo<N, HDP>;
  constexpr int SR = G::SR;
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SR; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; d += 4) {
    float4 a4[SR], b4[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i)
      a4[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * G::P + d);
#pragma unroll
    for (int j = 0; j < SR; ++j)
      b4[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * G::P + d);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        float v = s[i][j];
        v = fmaf(a4[i].x, b4[j].x, v);
        v = fmaf(a4[i].y, b4[j].y, v);
        v = fmaf(a4[i].z, b4[j].z, v);
        s[i][j] = fmaf(a4[i].w, b4[j].w, v);
      }
    }
  }
}

// the sum and the max over the 16 lanes of a half-warp (one score row)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[i] += sum over k < R of T(row r_i, k) X[k] (kT false: T[r][k], as
// dQ = dS K; kT true: T[k][r], as dK = dS^T Q and dV = P^T dO), the thread's
// rows r_i = r0 + RS i and head dims 4 dg .. 4 dg + 3
template <int N, int HDP, bool kT>
__device__ __forceinline__ void tile_product(
    const float* T, const float* X, int r0, int dg,
    float (&acc)[BwdGeo<N, HDP>::RPT][4]) {
  using G = BwdGeo<N, HDP>;
#pragma unroll 4
  for (int k = 0; k < G::R; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(X + k * G::P + 4 * dg);
#pragma unroll
    for (int i = 0; i < G::RPT; ++i) {
      const int r = r0 + G::RS * i;
      if (r < G::R) {
        const float t = kT ? T[k * G::SP + r] : T[r * G::SP + k];
        acc[i][0] = fmaf(t, x.x, acc[i][0]);
        acc[i][1] = fmaf(t, x.y, acc[i][1]);
        acc[i][2] = fmaf(t, x.z, acc[i][2]);
        acc[i][3] = fmaf(t, x.w, acc[i][3]);
      }
    }
  }
}

template <int N, int HDP>
__device__ __forceinline__ void zero_acc(float (&acc)[BwdGeo<N, HDP>::RPT][4]) {
#pragma unroll
  for (int i = 0; i < BwdGeo<N, HDP>::RPT; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[i][x] = 0.f;
}

// mul * acc into the head's columns ``col`` of dqkv at the window's tokens
// t0 + r_i
template <int N, int HDP>
__device__ __forceinline__ void store_rows(
    const float (&acc)[BwdGeo<N, HDP>::RPT][4], float mul,
    float* __restrict__ dqkv, long long ldd, int b, int wi, int wj, int t0,
    int H, int W, int shift, int col, int hd, int r0, int dg) {
  using G = BwdGeo<N, HDP>;
#pragma unroll
  for (int i = 0; i < G::RPT; ++i) {
    const int r = r0 + G::RS * i;
    if (r >= G::R) continue;
    float* dst = dqkv + token_row<N>(b, wi, wj, t0 + r, H, W, shift) * ldd
                 + col;
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (4 * dg + x < hd) dst[4 * dg + x] = acc[i][x] * mul;
  }
}

// ---- N = 16 and 64: one launch, a block per (group of windows, head) -------

template <int N, int HDP>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_f32_kernel(const float* __restrict__ qkv, long long ldq,
                    const float* __restrict__ dout, long long ldg,
                    const float* __restrict__ bias,
                    const void* __restrict__ mask, float* __restrict__ dqkv,
                    long long ldd, float* __restrict__ part, int H, int W,
                    int C, int nh, int hd, int shift, int group, int windows,
                    float scale) {
  using G = BwdGeo<N, HDP>;
  constexpr int R = G::R, SR = G::SR, SP = G::SP, P = G::P;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + R * P;
  float* vs = ks + R * P;
  float* dos = vs + R * P;
  float* ps = dos + R * P;
  float* dss = ps + R * SP;

  const int h = blockIdx.x % nh, grp = blockIdx.x / nh;
  const int nww = W / Geo<N>::kWin;
  const int nw = (H / Geo<N>::kWin) * nww;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int dg = tid % G::G4, r0 = tid / G::G4;
  const bool pv = tid < G::RS * G::G4;
  const int col = h * hd;
  zero_pads<N, HDP>(smem, hd);

  float db[SR][SR];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SR; ++j) db[i][j] = 0.f;

  const int w_end = min(windows, (grp + 1) * group);
  for (int gw = grp * group; gw < w_end; ++gw) {
    const int b = gw / nw, win = gw % nw;
    const int wi = win / nww, wj = win % nww;
    stage_rows<N, HDP>(qs, qkv, ldq, b, wi, wj, 0, H, W, shift, col, hd);
    stage_rows<N, HDP>(ks, qkv, ldq, b, wi, wj, 0, H, W, shift, C + col, hd);
    stage_rows<N, HDP>(vs, qkv, ldq, b, wi, wj, 0, H, W, shift, 2 * C + col,
                       hd);
    stage_rows<N, HDP>(dos, dout, ldg, b, wi, wj, 0, H, W, shift, col, hd);
    __syncthreads();

    float s[SR][SR], dp[SR][SR];
    dot_tile<N, HDP>(qs, ks, ty, tx, s);
    dot_tile<N, HDP>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        s[i][j] = s[i][j] * scale
                  + attn_term<N>(bias, mask, h, win, r, tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
      const float inv = 1.f / row_sum16(sum);
      float dsum = 0.f;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        s[i][j] *= inv;                   // P
        dsum += s[i][j] * dp[i][j];
      }
      const float d = row_sum16(dsum);    // D = rowsum(P o dP)
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        const float ds = s[i][j] * (dp[i][j] - d);
        db[i][j] += ds;
        ps[r * SP + tx + 16 * j] = s[i][j];
        dss[r * SP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    if (pv) {
      float acc[G::RPT][4];
      zero_acc<N, HDP>(acc);
      tile_product<N, HDP, false>(dss, ks, r0, dg, acc);      // dQ
      store_rows<N, HDP>(acc, scale, dqkv, ldd, b, wi, wj, 0, H, W, shift,
                         col, hd, r0, dg);
      zero_acc<N, HDP>(acc);
      tile_product<N, HDP, true>(dss, qs, r0, dg, acc);       // dK
      store_rows<N, HDP>(acc, scale, dqkv, ldd, b, wi, wj, 0, H, W, shift,
                         C + col, hd, r0, dg);
      zero_acc<N, HDP>(acc);
      tile_product<N, HDP, true>(ps, dos, r0, dg, acc);       // dV
      store_rows<N, HDP>(acc, 1.f, dqkv, ldd, b, wi, wj, 0, H, W, shift,
                         2 * C + col, hd, r0, dg);
    }
    __syncthreads();                      // before the next window's rows
  }
  float* out = part + (size_t)blockIdx.x * N * N;   // (group, head)
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SR; ++j)
      out[(ty + 16 * i) * N + tx + 16 * j] = db[i][j];
}

// ---- N = 256: dq launch, a block per (window, head, query tile) -------------

template <int HDP>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd16_dq_f32_kernel(const float* __restrict__ qkv, long long ldq,
                         const float* __restrict__ dout, long long ldg,
                         const float* __restrict__ ctx, long long ldc,
                         const float* __restrict__ table,
                         const void* __restrict__ labels,
                         const float* __restrict__ stats,
                         float* __restrict__ dqkv, long long ldd,
                         float* __restrict__ dsum, int H, int W, int C,
                         int nh, int hd, int shift, float scale) {
  constexpr int N = 256;
  using G = BwdGeo<N, HDP>;
  constexpr int R = G::R, SR = G::SR, SP = G::SP, P = G::P;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + R * P;
  float* vs = ks + R * P;
  float* dos = vs + R * P;
  float* dss = dos + R * P;
  float* rmax = dss + R * SP;
  float* rinv = rmax + R;
  float* rd = rinv + R;

  const int nww = W / Geo<N>::kWin;
  const int nw = (H / Geo<N>::kWin) * nww;
  int bid = blockIdx.x;
  const int qt = bid % Geo<N>::kTiles;
  bid /= Geo<N>::kTiles;
  const int h = bid % nh;
  const int gw = bid / nh;                // image * nW + window
  const int b = gw / nw, win = gw % nw;
  const int wi = win / nww, wj = win % nww;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int dg = tid % G::G4, r0 = tid / G::G4;
  const bool pv = tid < G::RS * G::G4;
  const int col = h * hd, t0 = qt * R;
  const size_t row0 = ((size_t)gw * nh + h) * N + t0;   // stats / dsum row
  zero_pads<N, HDP>(smem, hd);
  __syncthreads();
  stage_rows<N, HDP>(qs, qkv, ldq, b, wi, wj, t0, H, W, shift, col, hd);
  stage_rows<N, HDP>(dos, dout, ldg, b, wi, wj, t0, H, W, shift, col, hd);
  stage_rows<N, HDP>(ks, ctx, ldc, b, wi, wj, t0, H, W, shift, col, hd);
  for (int r = tid; r < R; r += kThreads) {
    const float2 st = reinterpret_cast<const float2*>(stats)[row0 + r];
    rmax[r] = st.x;
    rinv[r] = st.y;
  }
  __syncthreads();
  {
    // D = rowsum(dO o O): four lanes a row, a quarter of the head dims each
    const int r = tid / 4, part = tid % 4;
    float d = 0.f;
    for (int x = part; x < HDP; x += 4) d += dos[r * P + x] * ks[r * P + x];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      rd[r] = d;
      dsum[row0 + r] = d;
    }
  }
  __syncthreads();                        // ks is free for the key tiles

  float acc[G::RPT][4];
  zero_acc<N, HDP>(acc);
  for (int kt = 0; kt < Geo<N>::kTiles; ++kt) {
    stage_rows<N, HDP>(ks, qkv, ldq, b, wi, wj, kt * R, H, W, shift,
                       C + col, hd);
    stage_rows<N, HDP>(vs, qkv, ldq, b, wi, wj, kt * R, H, W, shift,
                       2 * C + col, hd);
    __syncthreads();
    float s[SR][SR], dp[SR][SR];
    dot_tile<N, HDP>(qs, ks, ty, tx, s);
    dot_tile<N, HDP>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = ty + 16 * i;
      const float mx = rmax[r], inv = rinv[r], d = rd[r];
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        const int c = tx + 16 * j;
        const float p = expf(s[i][j] * scale
                             + attn_term<N>(table, labels, h, win, t0 + r,
                                            kt * R + c) - mx) * inv;
        dss[r * SP + c] = p * (dp[i][j] - d);
      }
    }
    __syncthreads();
    if (pv) tile_product<N, HDP, false>(dss, ks, r0, dg, acc);
    __syncthreads();                      // before the next tile's rows
  }
  if (pv)
    store_rows<N, HDP>(acc, scale, dqkv, ldd, b, wi, wj, t0, H, W, shift,
                       col, hd, r0, dg);
}

// ---- N = 256: dkv launch, a block per (group of windows, head, key tile) ----

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd16_dkv_f32_kernel(const float* __restrict__ qkv, long long ldq,
                          const float* __restrict__ dout, long long ldg,
                          const float* __restrict__ table,
                          const void* __restrict__ labels,
                          const float* __restrict__ stats,
                          const float* __restrict__ dsum,
                          float* __restrict__ dqkv, long long ldd,
                          float* __restrict__ part, int H, int W, int C,
                          int nh, int hd, int shift, int group, int windows,
                          float scale) {
  constexpr int N = 256;
  using G = BwdGeo<N, HDP>;
  constexpr int R = G::R, SR = G::SR, SP = G::SP, P = G::P;
  constexpr int kQT = Geo<N>::kTiles;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + R * P;
  float* vs = ks + R * P;
  float* dos = vs + R * P;
  float* ps = dos + R * P;
  float* dss = ps + R * SP;
  float* rmax = dss + R * SP;
  float* rinv = rmax + R;
  float* rd = rinv + R;

  const int nww = W / Geo<N>::kWin;
  const int nw = (H / Geo<N>::kWin) * nww;
  int bid = blockIdx.x;
  const int kt = bid % kQT;
  bid /= kQT;
  const int h = bid % nh, grp = bid / nh;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int dg = tid % G::G4, r0 = tid / G::G4;
  const bool pv = tid < G::RS * G::G4;
  const int col = h * hd, k0 = kt * R;
  zero_pads<N, HDP>(smem, hd);

  float db[kQT][SR][SR];                  // d(bias) rows qt * 64 + ty + 16 i
#pragma unroll
  for (int qt = 0; qt < kQT; ++qt)
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SR; ++j) db[qt][i][j] = 0.f;

  const int w_end = min(windows, (grp + 1) * group);
  for (int gw = grp * group; gw < w_end; ++gw) {
    const int b = gw / nw, win = gw % nw;
    const int wi = win / nww, wj = win % nww;
    const size_t srow = ((size_t)gw * nh + h) * N;
    __syncthreads();                      // the last window's reads are done
    stage_rows<N, HDP>(ks, qkv, ldq, b, wi, wj, k0, H, W, shift, C + col, hd);
    stage_rows<N, HDP>(vs, qkv, ldq, b, wi, wj, k0, H, W, shift, 2 * C + col,
                       hd);
    float dk[G::RPT][4], dv[G::RPT][4];
    zero_acc<N, HDP>(dk);
    zero_acc<N, HDP>(dv);
#pragma unroll
    for (int qt = 0; qt < kQT; ++qt) {
      const int t0 = qt * R;
      stage_rows<N, HDP>(qs, qkv, ldq, b, wi, wj, t0, H, W, shift, col, hd);
      stage_rows<N, HDP>(dos, dout, ldg, b, wi, wj, t0, H, W, shift, col,
                         hd);
      for (int r = tid; r < R; r += kThreads) {
        const float2 st =
            reinterpret_cast<const float2*>(stats)[srow + t0 + r];
        rmax[r] = st.x;
        rinv[r] = st.y;
        rd[r] = dsum[srow + t0 + r];
      }
      __syncthreads();
      float s[SR][SR], dp[SR][SR];
      dot_tile<N, HDP>(qs, ks, ty, tx, s);
      dot_tile<N, HDP>(dos, vs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = ty + 16 * i;
        const float mx = rmax[r], inv = rinv[r], d = rd[r];
#pragma unroll
        for (int j = 0; j < SR; ++j) {
          const int c = tx + 16 * j;
          const float p = expf(s[i][j] * scale
                               + attn_term<N>(table, labels, h, win, t0 + r,
                                              k0 + c) - mx) * inv;
          const float ds = p * (dp[i][j] - d);
          db[qt][i][j] += ds;
          ps[r * SP + c] = p;
          dss[r * SP + c] = ds;
        }
      }
      __syncthreads();
      if (pv) {
        tile_product<N, HDP, true>(ps, dos, r0, dg, dv);
        tile_product<N, HDP, true>(dss, qs, r0, dg, dk);
      }
      __syncthreads();                    // before the next tile's rows
    }
    if (pv) {
      store_rows<N, HDP>(dk, scale, dqkv, ldd, b, wi, wj, k0, H, W, shift,
                         C + col, hd, r0, dg);
      store_rows<N, HDP>(dv, 1.f, dqkv, ldd, b, wi, wj, k0, H, W, shift,
                         2 * C + col, hd, r0, dg);
    }
  }
  float* out = part + ((size_t)grp * nh + h) * N * N + k0;
#pragma unroll
  for (int qt = 0; qt < kQT; ++qt)
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SR; ++j)
        out[(size_t)(qt * R + ty + 16 * i) * N + tx + 16 * j] = db[qt][i][j];
}

// ---- launches ---------------------------------------------------------------

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  configured = true;
  return 0;
}

struct BwdArgs {
  const float* qkv;
  long long ldq;
  const float* dout;
  long long ldg;
  const float* ctx;             // N = 256 only
  long long ldc;
  const float* bias;
  const void* mask;
  const float* stats;           // N = 256 only
  float* dqkv;
  long long ldd;
  float* dsum;                  // N = 256 only
  float* part;
  float* dbias;
  int B, H, W, C, nh, shift, group;
  long long smem, smem_dq;
};

template <int N, int HDP>
int bwd_launch(const BwdArgs& a, cudaStream_t s) {
  constexpr int kWin = Geo<N>::kWin;
  const int hd = a.C / a.nh;
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  const long long windows = (long long)a.B * (a.H / kWin) * (a.W / kWin);
  const long long groups = (windows + a.group - 1) / a.group;
  if (groups * a.nh > kMaxPartialBlocks) return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = bwd_smem_bytes<N, HDP>();
  static_assert(bytes <= kMaxSmem, "window_attention_bwd_f32: shared memory");
  if ((long long)bytes != a.smem) return (int)cudaErrorInvalidValue;
  int rc;
  if constexpr (N < 256) {
    static bool configured = false;
    if ((rc = allow_smem(attn_bwd_f32_kernel<N, HDP>, bytes, configured)))
      return rc;
    attn_bwd_f32_kernel<N, HDP><<<(unsigned)(groups * a.nh), kThreads, bytes,
                                  s>>>(
        a.qkv, a.ldq, a.dout, a.ldg, a.bias, a.mask, a.dqkv, a.ldd, a.part,
        a.H, a.W, a.C, a.nh, hd, a.shift, a.group, (int)windows, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
  } else {
    constexpr size_t dq_bytes = dq_smem_bytes<HDP>();
    if ((long long)dq_bytes != a.smem_dq) return (int)cudaErrorInvalidValue;
    static bool dq_configured = false, dkv_configured = false;
    if ((rc = allow_smem(attn_bwd16_dq_f32_kernel<HDP>, dq_bytes,
                         dq_configured)) ||
        (rc = allow_smem(attn_bwd16_dkv_f32_kernel<HDP>, bytes,
                         dkv_configured)))
      return rc;
    constexpr int kQT = Geo<N>::kTiles;
    attn_bwd16_dq_f32_kernel<HDP>
        <<<(unsigned)(windows * a.nh * kQT), kThreads, dq_bytes, s>>>(
            a.qkv, a.ldq, a.dout, a.ldg, a.ctx, a.ldc, a.bias, a.mask,
            a.stats, a.dqkv, a.ldd, a.dsum, a.H, a.W, a.C, a.nh, hd, a.shift,
            scale);
    if ((rc = (int)cudaGetLastError())) return rc;
    attn_bwd16_dkv_f32_kernel<HDP>
        <<<(unsigned)(groups * a.nh * kQT), kThreads, bytes, s>>>(
            a.qkv, a.ldq, a.dout, a.ldg, a.bias, a.mask, a.stats, a.dsum,
            a.dqkv, a.ldd, a.part, a.H, a.W, a.C, a.nh, hd, a.shift, a.group,
            (int)windows, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  const long long total = (long long)a.nh * N * N;
  return sum_partials(a.part, (int)groups, total, a.dbias, total, nullptr, s);
}

template <int N>
int bwd_by_head(const BwdArgs& a, cudaStream_t s) {
  switch ((a.C / a.nh + 15) / 16) {
#define ADSR_HDP(K) \
    case K: return bwd_launch<N, 16 * K>(a, s);
    ADSR_HDP(1) ADSR_HDP(2) ADSR_HDP(3) ADSR_HDP(4)
    ADSR_HDP(5) ADSR_HDP(6) ADSR_HDP(7) ADSR_HDP(8)
#undef ADSR_HDP
    default: return (int)cudaErrorInvalidValue;
  }
}

// The checks of the C entry of window ``kWin`` (N = kWin^2): qkv, dout,
// dqkv (and at N = 256 ctx) with 16-byte aligned bases and row strides
// that are multiples of 4 floats; ``bias`` and ``mask`` in the forward's
// forms; ``group`` windows a (d(bias) partial, head); ``smem`` (and at N
// = 256 ``smem_dq``) as kernels/window_attention_bwd.py
// ``window_attention_bwd_f32_plan`` planned: a launch whose plan differs
// from this file's layout is refused.
template <int kWin>
int bwd_entry(const BwdArgs& a, void* stream) {
  const auto odd = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (a.H % kWin || a.W % kWin || a.nh <= 0 || a.C % a.nh || a.C % 4 ||
      a.B < 0 || a.shift < 0 || a.shift >= kWin ||
      (a.shift > 0) != (a.mask != nullptr) || a.group < 1 || a.ldq % 4 ||
      a.ldg % 4 || a.ldd % 4 || a.ldq < 3ll * a.C || a.ldg < a.C ||
      a.ldd < 3ll * a.C || a.C / a.nh > 128 || odd(a.qkv) || odd(a.dout) ||
      odd(a.dqkv) || a.part == nullptr || a.dbias == nullptr ||
      (kWin == 16 && (a.ctx == nullptr || a.stats == nullptr ||
                      a.dsum == nullptr || a.ldc % 4 || a.ldc < a.C ||
                      odd(a.ctx))))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  return bwd_by_head<kWin * kWin>(a, (cudaStream_t)stream);
}

}  // namespace
