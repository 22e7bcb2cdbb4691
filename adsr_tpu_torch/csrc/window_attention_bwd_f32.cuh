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
// Bound on H100: bytes at N = 16 and 64 (qkv, dO and dqkv once; the five
// products of 64 x 64 a head are cheap as 3xTF32: ~0.17 ms of bytes an RDG
// at the flagship against ~0.08 ms of tensor-core work), operations at N =
// 256 (seven 256 x 256 x hd products a head: 208 GFLOP an RDG at
// 256px/x4, 3.11 ms at the 67 TFLOP/s of f32 FFMA, 1.26 ms as three TF32
// products each at 495 TFLOP/s).
// Design: every product f32-accurate as 3xTF32 on the tensor cores
// (mma.sync m16n8k8, tf32_mma.cuh). Operand planes [rows][hdp + 4] in
// shared memory hold a head's rows of q, k, v and dO, staged by cp.async
// in the 16-byte pieces that hold the head's columns, as they lie: head
// dim j of a row sits at column j + (col & 3) of the plane (every part of
// a head shares that offset: C % 4 == 0), and each row's last piece has its
// columns past the head dim zeroed once it lands (the planes start zeroed,
// so the columns past a row's last piece stay zero).
// - N = 16 and 64 (hdp a multiple of 16): one launch, a block of eight
//   warps per (group of ``group`` consecutive windows, head), 64 token rows
//   at a time (a set: one 8x8 window, or four 4x4 windows), each set's
//   rows landing while the last set is computed where two sets of planes
//   fit (``Tc64::kBuffers``). Warp (wr, wc) takes rows 16 wr .. 16 wr + 15
//   of the set (at N = 16 window wr of the set) and half of its window's
//   keys (32 at N = 64, 8 at N = 16): it recomputes S and dP of its 16 x
//   N / 2 tile in registers (each value split as its fragment loads: hi =
//   x with its low 13 bits cleared, lo = x - hi, exact), the rows' max,
//   sum of exp and D = rowsum(P o dP) summed over the quad's lanes and then
//   the two halves in order through shared memory, dS = P o (dP - D), and
//   adds dS into the d(bias) partial it owns in registers over the group's
//   windows. P and dS go to shared tiles [64][N + 4]; then each warp takes
//   its 16 rows' dQ (over the window's keys), dK and dV (over its queries)
//   in the head-dim n8 tiles wc, wc + 2, .., with the tiles' values as A in
//   the paired order (a0 a2 from rows 2t, 2t + 1) and the planes' rows as
//   B (frag_b_cols). The three results go through the dead q, k and v
//   planes and out in whole 16-byte pieces (the pieces a head shares with
//   its neighbours value by value). At N = 16 the four windows' d(bias)
//   partials are added in window order at the end.
// - N = 256 (R = 64; hdp a multiple of 8): FlashAttention-2's
//   deterministic backward in two launches, as the bf16 kernels
//   (window_attention_bwd16.cu): P from the forward's softmax statistics
//   (kernel (c) writes (max, 1 / sum) a query row) and D = rowsum(dO o O)
//   from the forward's context. ``dq``: a block per (window, head, query
//   tile) computes D of its rows (written to ``dsum`` for the second
//   launch), sweeps the four key tiles and writes dQ. ``dkv``: a block per
//   (group of windows, head, key tile) walks its group's windows and each
//   window's four query tiles, accumulates dK and dV of its keys in
//   registers and the [256][64] d(bias) columns of its keys in shared
//   memory over the group, and writes one partial a (group, head). The bias
//   comes from the relative-position table and the mask from the region
//   labels, so a 16x16 window's f32 bias (256 KB) is never staged.
// partials.cuh's sum_partials adds the d(bias) partials in a fixed order:
// no atomics, bitwise repeatable; nothing survives a launch.
//
// One source a window includes this file (window_attention_bwd4_f32.cu,
// window_attention_bwd_f32.cu, window_attention_bwd16_f32.cu, and at N =
// 256 head tiles past 64 window_attention_bwd16_f32_wide.cu), so nvcc
// builds the windows' instances in parallel.

#pragma once

#include "partials.cuh"
#include "tf32_mma.cuh"            // 3xTF32 mma.sync, fragments, cp.async
#include "window_attention_f32.cuh"

#ifndef ADSR_BWD16_WIDE
#define ADSR_BWD16_WIDE 0         // 1: the N = 256 head tiles past 64
#endif

// ablation switches of scripts/torch_attention_bwd_f32_sweep.py at N = 16
// and 64 (timing only: a variant without them computes something else; the
// shared ATTN16_F32_X3 0 leaves one TF32 product of three)
#ifndef ATTN_BWD_F32_STAGE
#define ATTN_BWD_F32_STAGE 1      // 0: no rows loaded (the planes stay 0)
#endif
#ifndef ATTN_BWD_F32_TERM
#define ATTN_BWD_F32_TERM 1       // 0: no bias / mask lookups and no exp
#endif
#ifndef ATTN_BWD_F32_STORE
#define ATTN_BWD_F32_STORE 1      // 0: dQ, dK and dV not written
#endif

namespace {

constexpr int kMaxPartialBlocks = 1 << 20;

// ---- N = 16 and 64: one launch, a block per (group of windows, head) -------

constexpr int kSetRows = 64;              // token rows of a set

template <int N, int HDP>
struct Tc64 {
  static_assert(HDP % 16 == 0 && HDP <= 128 && (N == 16 || N == 64),
                "head tile");
  static constexpr int P = kPitch<HDP>;   // floats a row of a plane
  static constexpr int SP = N + 4;        // floats a row of the P / dS tiles
  static constexpr int WPS = kSetRows / N;  // windows a set
  static constexpr int KH = HDP / 16;     // a warp's head-dim n8 tiles
  static constexpr int KN = N / 16;       // a warp's key n8 tiles (N / 2)
  static constexpr size_t kPlane = (size_t)kSetRows * P;
  static constexpr size_t kTile = (size_t)kSetRows * SP;
  static constexpr size_t kRed = 3 * 2 * kSetRows;  // max, sum, D a half
  // two sets of the four planes where they fit beside the tiles
  static constexpr int kBuffers =
      4 * (8 * kPlane + 2 * kTile + kRed) <= kMaxSmem ? 2 : 1;
  // blocks an SM asked of the registers (kernels/window_attention_bwd.py
  // ``bwd_f32_min_blocks``): two (128 registers a thread) up to a head
  // tile of 48 (64 spills there), else one
  static constexpr int kMinBlocks = HDP <= 48 ? 2 : 1;
};

// shared memory of the N = 16 and 64 kernel, in bytes
// (kernels/window_attention_bwd.py ``window_attention_bwd_f32_plan``): one
// or two sets of the q, k, v and dO planes, the P and dS tiles and the
// rows' halves of max, sum and D
template <int N, int HDP>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  using T = Tc64<N, HDP>;
  return 4 * (4 * T::kBuffers * T::kPlane + 2 * T::kTile + T::kRed);
}

// the 16 x 8 A fragment (paired order) of element (i, k) = X[k][i]: rows kr
// + 2t, kr + 2t + 1 and columns c0 + g (+ 8) of a tile of pitch SP (a
// product over the tile's rows)
template <int SP>
__device__ __forceinline__ void frag_a_t(const float* X, int kr, int c0,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* x = X + (kr + 2 * t) * SP + c0 + g;
  split_as<true>(x[0], hi[0], lo[0]);
  split_as<true>(x[8], hi[1], lo[1]);
  split_as<true>(x[SP], hi[2], lo[2]);
  split_as<true>(x[SP + 8], hi[3], lo[3]);
}

// the A fragment (paired order) of element (i, k) = X[r0 + i][k0 + k]: a
// product over the tile's columns
template <int SP>
__device__ __forceinline__ void frag_a_p(const float* X, int r0, int k0,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float2 a = *reinterpret_cast<const float2*>(X + (r0 + g) * SP + k0
                                                    + 2 * t);
  const float2 b = *reinterpret_cast<const float2*>(X + (r0 + g + 8) * SP
                                                    + k0 + 2 * t);
  split_as<true>(a.x, hi[0], lo[0]);
  split_as<true>(b.x, hi[1], lo[1]);
  split_as<true>(a.y, hi[2], lo[2]);
  split_as<true>(b.y, hi[3], lo[3]);
}

// S and dP of a warp's 16 rows (r0 ..) of planes (a, a2) against KN x 8
// rows (n0 ..) of planes (b, b2), over the head dims: s = a b^T, dp = a2
// b2^T
template <int HDP, int KN>
__device__ __forceinline__ void scores_pairs(const float* a, const float* a2,
                                             const float* b, const float* b2,
                                             int r0, int n0,
                                             float (&s)[KN][4],
                                             float (&dp)[KN][4]) {
  constexpr int P = kPitch<HDP>, KT = HDP / 8;
#pragma unroll
  for (int j = 0; j < KN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t ah[4], al[4], ch[4], cl[4];
    frag_a<P, true>(a, r0, 8 * kk, ah, al);
    frag_a<P, true>(a2, r0, 8 * kk, ch, cl);
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      uint32_t bh[2], bl[2], b2h[2], b2l[2];
      frag_b_rows<P, true>(b, n0 + 8 * j, 8 * kk, bh, bl);
      frag_b_rows<P, true>(b2, n0 + 8 * j, 8 * kk, b2h, b2l);
      mma3x2(s[j], ah, al, bh, bl, dp[j], ch, cl, b2h, b2l);
    }
  }
}

// waits for this thread's copies, then zeroes the columns past the head dim
// that its row's last piece brought into ``count`` planes, ``stride``
// floats apart from ``first`` (the caller synchronises the block before the
// planes are read)
template <int HDP>
__device__ __forceinline__ void land_async(float* first, int stride,
                                           int count, int col, int hd) {
  constexpr int P = kPitch<HDP>;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const int end = (col & 3) + hd, pieces = (end + 3) / 4;
  if (4 * pieces == end || (threadIdx.x & 3) != ((pieces - 1) & 3)) return;
  const int r = threadIdx.x >> 2;
  for (int p = 0; p < count; ++p)
    for (int x = end; x < 4 * pieces; ++x)
      first[p * stride + r * P + x] = 0.f;
}

// the sum (or max) of a row's values over the four lanes of a quad
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

template <int N, int HDP>
__global__ void __launch_bounds__(kThreads, Tc64<N, HDP>::kMinBlocks)
attn_bwd_f32_kernel(const float* __restrict__ qkv, long long ldq,
                    const float* __restrict__ dout, long long ldg,
                    const float* __restrict__ bias,
                    const void* __restrict__ mask, float* __restrict__ dqkv,
                    long long ldd, float* __restrict__ part, int H, int W,
                    int C, int nh, int hd, int shift, int group, int windows,
                    float scale) {
  using T = Tc64<N, HDP>;
  constexpr int P = T::P, SP = T::SP, WPS = T::WPS, KH = T::KH, KN = T::KN;
  constexpr int NB = T::kBuffers;
  constexpr int PL = (int)T::kPlane, R = kSetRows;
  extern __shared__ __align__(16) float smem[];
  float* ps = smem + 4 * NB * PL;         // P [64][SP]
  float* dss = ps + T::kTile;             // dS [64][SP]
  float* red = dss + T::kTile;            // [max, sum, D][half][64 rows]

  const int h = blockIdx.x % nh, grp = blockIdx.x / nh;
  const int nww = W / Geo<N>::kWin;
  const int nw = (H / Geo<N>::kWin) * nww;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int col = h * hd, sc = col & 3;
  const int r0 = 16 * wr;                 // the warp's rows of the set
  const int wb = N == 16 ? r0 : 0;        // the first row of its window
  const int q0 = N == 16 ? 0 : r0;        // its rows' first window token
  const int kh = (N / 2) * wc;            // its keys' first window token
  const int w_begin = grp * group, w_end = min(windows, w_begin + group);

  for (int i = tid; i < 4 * NB * PL / 4; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // the set of windows from ``first`` into buffer ``buf``: row tid / 4 of
  // each plane, its pieces tid % 4, + 4, ..; one commit group
  const int pieces = (sc + hd + 3) / 4;
  auto stage = [&](int first, int buf) {
    const int r = tid >> 2, fw = first + r / N;
    if (ATTN_BWD_F32_STAGE && fw < w_end) {
      const int b = fw / nw, win = fw % nw;
      const long long row =
          token_row<N>(b, win / nww, win % nww, r % N, H, W, shift);
      float* dst = smem + 4 * buf * PL + r * P;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float* src = p == 3 ? dout + row * ldg + (col & ~3)
                                  : qkv + row * ldq + ((p * C + col) & ~3);
        for (int k = tid & 3; k < pieces; k += 4)
          cp_async_piece(dst + p * PL + 4 * k, src + 4 * k);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float db[KN][4];
#pragma unroll
  for (int j = 0; j < KN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[j][e] = 0.f;

  int buf = 0;
  stage(w_begin, 0);
  for (int first = w_begin; first < w_end; first += WPS) {
    float* qs = smem + 4 * buf * PL;
    float* ks = qs + PL;
    float* vs = ks + PL;
    float* dos = vs + PL;
    if (NB == 1 && first != w_begin) stage(first, 0);
    land_async<HDP>(qs, PL, 4, col, hd);
    __syncthreads();
    if (NB == 2 && first + WPS < w_end) stage(first + WPS, buf ^ 1);

    // the warp's window: at N = 16 window wr of the set (none past the
    // group's last window)
    const int fw = first + (N == 16 ? wr : 0);
    const bool valid = fw < w_end;
    const int win = valid ? fw % nw : 0;

    // S = Q K^T and dP = dO V^T of its rows x its half of the keys, then
    // the scale and the bias (and mask) term
    float s[KN][4], dp[KN][4];
    scores_pairs<HDP, KN>(qs + sc, dos + sc, ks + sc, vs + sc, r0, wb + kh,
                          s, dp);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + g + 8 * (e >> 1), kj = kh + 8 * j + 2 * t + (e & 1);
#if ATTN_BWD_F32_TERM
        s[j][e] = s[j][e] * scale + attn_term<N>(bias, mask, h, win, qi, kj);
#else
        s[j][e] *= scale;
#endif
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    // the softmax of each row over both halves: max, then the sum of exp,
    // each over the quad and then the two halves (wc 0 + wc 1) in order
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = quad_max(mx[x]);
      if (t == 0) red[wc * R + r0 + g + 8 * x] = mx[x];
    }
    __syncthreads();
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r0 + g + 8 * x;
      mx[x] = fmaxf(red[r], red[R + r]);
    }
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#if ATTN_BWD_F32_TERM
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
#else
        s[j][e] -= mx[e >> 1];
#endif
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      sum[x] = quad_sum(sum[x]);
      if (t == 0) red[(2 + wc) * R + r0 + g + 8 * x] = sum[x];
    }
    __syncthreads();
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r0 + g + 8 * x;
      sum[x] = 1.f / (red[2 * R + r] + red[3 * R + r]);
    }
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= sum[e >> 1];                 // P
        dsum[e >> 1] += s[j][e] * dp[j][e];
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      dsum[x] = quad_sum(dsum[x]);
      if (t == 0) red[(4 + wc) * R + r0 + g + 8 * x] = dsum[x];
    }
    __syncthreads();
    // dS = P o (dP - D) into the d(bias) partial; P and dS into their tiles
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r0 + g + 8 * x;
      const float d = red[4 * R + r] + red[5 * R + r];
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float ds0 = s[j][2 * x] * (dp[j][2 * x] - d);
        const float ds1 = s[j][2 * x + 1] * (dp[j][2 * x + 1] - d);
        if (valid) {
          db[j][2 * x] += ds0;
          db[j][2 * x + 1] += ds1;
        }
        const int c = kh + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(ps + r * SP + c) =
            make_float2(s[j][2 * x], s[j][2 * x + 1]);
        *reinterpret_cast<float2*>(dss + r * SP + c) = make_float2(ds0, ds1);
      }
    }
    __syncthreads();

    // dV = P^T dO and dK = dS^T Q of the warp's rows as keys, over the
    // window's queries; dQ = dS K of its rows as queries, over the window's
    // keys; head-dim n8 tiles wc, wc + 2, ..
    float dq[KH][4], dk[KH][4], dv[KH][4];
#pragma unroll
    for (int i = 0; i < KH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][e] = dk[i][e] = dv[i][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < N; k0 += 8) {
      uint32_t pah[4], pal[4], sah[4], sal[4], qah[4], qal[4];
      frag_a_t<SP>(ps, wb + k0, q0, pah, pal);
      frag_a_t<SP>(dss, wb + k0, q0, sah, sal);
      frag_a_p<SP>(dss, r0, k0, qah, qal);
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        const int n = 8 * (wc + 2 * i);
        uint32_t vh[2], vl[2], kh2[2], kl2[2], qh[2], ql[2];
        frag_b_cols<P, true>(dos + sc, wb + k0, n, vh, vl);
        frag_b_cols<P, true>(qs + sc, wb + k0, n, qh, ql);
        frag_b_cols<P, true>(ks + sc, wb + k0, n, kh2, kl2);
        mma3x2(dv[i], pah, pal, vh, vl, dk[i], sah, sal, qh, ql);
        mma3(dq[i], qah, qal, kh2, kl2);
      }
    }
    __syncthreads();                      // every read of the planes done
    // dQ into q's plane, dK into k's, dV into v's, as the rows were staged
#pragma unroll
    for (int i = 0; i < KH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1);
        const int j = sc + 8 * (wc + 2 * i) + 2 * t + (e & 1);
        qs[r * P + j] = dq[i][e] * scale;
        ks[r * P + j] = dk[i][e] * scale;
        vs[r * P + j] = dv[i][e];
      }
    __syncthreads();
    // the rows out: whole 16-byte pieces, a head's edge pieces value by
    // value (its neighbours' columns belong to other blocks)
    {
      const int r = tid >> 2, ow = first + r / N;
      if (ATTN_BWD_F32_STORE && ow < w_end) {
        const int b = ow / nw, win_o = ow % nw;
        const long long row =
            token_row<N>(b, win_o / nww, win_o % nww, r % N, H, W, shift);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const float* src = qs + p * PL + r * P;
          float* dst = dqkv + row * ldd + ((p * C + col) & ~3);
          for (int k = tid & 3; k < pieces; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(src + 4 * k);
            if (4 * k >= sc && 4 * k + 4 <= sc + hd) {
              *reinterpret_cast<float4*>(dst + 4 * k) = v;
            } else {
              const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int x = 0; x < 4; ++x)
                if (4 * k + x >= sc && 4 * k + x < sc + hd)
                  dst[4 * k + x] = e4[x];
            }
          }
        }
      }
    }
    __syncthreads();                      // the planes free for new rows
    buf ^= NB - 1;
  }

  // the (group, head)'s d(bias) partial [N][N]: at N = 64 each value has
  // one owner; at N = 16 the set's four windows' partials are added in
  // window order (through the P tile)
  float* out = part + (size_t)blockIdx.x * N * N;
  if constexpr (N == 64) {
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(r0 + g + 8 * (e >> 1)) * N + kh + 8 * j + 2 * t + (e & 1)] =
            db[j][e];
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ps[(wr * 16 + g + 8 * (e >> 1)) * 16 + kh + 2 * t + (e & 1)] = db[0][e];
    __syncthreads();
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) v += ps[w * 256 + tid];
    out[tid] = v;
  }
}

// ---- N = 256 on the tensor cores: 3xTF32 mma.sync --------------------------
//
// Every product is m16n8k8 TF32 mma.sync a warp, each operand split as x =
// hi + lo (hi = tf32(x), lo = tf32(x - hi), to nearest) and the f32
// accumulators summing a_lo b_hi + a_hi b_lo + a_hi b_hi (mma3). Operands
// are split as their fragments are loaded from the f32 planes (pitch HDP +
// 4, HDP the head dim rounded up to 8: the fragments' row and paired-row
// reads are free of bank conflicts). A product's accumulator tile becomes
// the A operand of the next product over its columns without leaving the
// registers: its lane holds columns 2t and 2t + 1, so the reduction takes
// its keys (or queries) in the paired order (a0, a1, a2, a3) = (c0, c2, c1,
// c3) and the B operand reads rows k0 + 2t and k0 + 2t + 1 (frag_b_cols).
// Eight warps a block: warp (wr, wc) takes rows 16 wr .. of the block's
// 64 and columns 32 wc .. of each 64-wide tile of the other side; the two
// warps of a row trade the half of a tile the other needs through an
// exchange buffer of C fragments ([writer][wr][n8 tile][lane] float4s,
// free of conflicts), so each output has one owner and no sum crosses warps.
// A tile's rows are staged by cp.async in the 16-byte pieces that hold the
// head's columns, as they lie: head dim j of a row sits at column j + (col
// & 3) of the plane (every plane of a head shares that offset: C % 4 == 0),
// and each row's last piece has the columns past the head dim zeroed once it
// lands (the planes start zeroed, so the columns past a row's last piece
// stay zero).

// ablation switches of scripts/torch_attention_bwd16_f32_sweep.py (timing
// only: a variant without them computes something else)
#ifndef ATTN16_F32_STAGE
#define ATTN16_F32_STAGE 1        // 0: the tiles' rows are not loaded
#endif
#ifndef ATTN16_F32_TERM
#define ATTN16_F32_TERM 1         // 0: no bias / mask lookups and no exp
#endif

constexpr int kDbPitch = 64 + 4;          // floats a row of dkv's d(bias)
constexpr int kExchange = 2 * 4 * 4 * 32;   // float4s of the exchange
constexpr int kStatFloats = 3 * 64;       // (max, 1 / sum) pairs, then D

template <int HDP>
struct Tc16 {
  static_assert(HDP % 8 == 0 && HDP <= 128, "head tile");
  static constexpr int R = 64, P = kPitch<HDP>, KT = HDP / 8;
  static constexpr size_t kPlane = (size_t)R * P;
  // dkv double-buffers its q and dO tiles (and their rows' statistics)
  // where six planes fit beside its d(bias) tile; dq always does its k and
  // v tiles
  static constexpr bool kDkvDouble =
      4 * (6 * kPlane + 4 * kExchange + 2 * kStatFloats + 256 * kDbPitch)
      <= kMaxSmem;
  static constexpr int kDkvBuffers = kDkvDouble ? 2 : 1;
  // blocks an SM asked of the registers (kernels/window_attention_bwd.py
  // ``bwd16_f32_min_blocks``): dq two where 128 registers hold a thread
  // without spills and its shared memory lets two in
  static constexpr int kDqMinBlocks = HDP >= 32 && HDP <= 64 ? 2 : 1;
  static constexpr int kDkvMinBlocks = 1;
};

// shared memory of the two launches (kernels/window_attention_bwd.py
// ``window_attention_bwd_f32_plan``): dq holds q, dO, two k and two v
// planes, the exchange and its rows' statistics; dkv k, v, one or two q and
// dO planes, the exchange, their rows' statistics and the d(bias) tile
// [256][kDbPitch] of its keys
template <int HDP>
__host__ __device__ constexpr size_t dq16_smem_bytes() {
  return 4 * (6 * Tc16<HDP>::kPlane + 4 * kExchange + kStatFloats);
}

template <int HDP>
__host__ __device__ constexpr size_t dkv16_smem_bytes() {
  constexpr int nb = Tc16<HDP>::kDkvBuffers;
  return 4 * ((2 + 2 * nb) * Tc16<HDP>::kPlane + 4 * kExchange
              + nb * kStatFloats + 256 * kDbPitch);
}

// rows [t0, t0 + 64) of a window's part of ``src`` (the head's hd columns
// from ``col``) into ``plane`` by cp.async, each row's 16-byte pieces as
// they lie (head dim j at column j + (col & 3)): thread tid takes row
// tid / 4 and its pieces tid % 4, + 4, ..; nothing waits
template <int HDP>
__device__ __forceinline__ void stage_async(float* plane,
                                            const float* __restrict__ src,
                                            long long ld, int col, int b,
                                            int wi, int wj, int t0, int H,
                                            int W, int shift, int hd) {
#if ATTN16_F32_STAGE
  constexpr int N = 256, P = kPitch<HDP>;
  const int r = threadIdx.x >> 2;
  const int pieces = ((col & 3) + hd + 3) / 4;
  const float* g = src + token_row<N>(b, wi, wj, t0 + r, H, W, shift) * ld
                   + (col & ~3);
  for (int k = threadIdx.x & 3; k < pieces; k += 4)
    cp_async_piece(plane + r * P + 4 * k, g + 4 * k);
#endif
}

// rows [row0, row0 + 64)'s (max, 1 / sum) from ``stats`` and, where
// given, D from ``dsum`` into ``st`` ([64] float2, then [64] float) by
// cp.async
__device__ __forceinline__ void stage_stats(float* st,
                                            const float* __restrict__ stats,
                                            const float* __restrict__ dsum,
                                            size_t row0) {
  const int tid = threadIdx.x;
  if (tid < 32)
    cp_async_piece(st + 4 * tid, stats + 2 * row0 + 4 * tid);
  else if (dsum != nullptr && tid < 48)
    cp_async_piece(st + 128 + 4 * (tid - 32), dsum + row0 + 4 * (tid - 32));
}

// the relative-position table's index of (query qi, key kj) at 16x16
// windows (attn_term<256>'s) is rel16(qi) - rel16(kj) + 480
__device__ __forceinline__ int rel16(int t) { return 31 * (t >> 4) + (t & 15); }

// P = exp(scale s + term - max) / sum of (query qi, key kj), the additive
// term from the head's table centred at index 480 (``tab``: table + h * 961
// + 480) and the window's region labels (``lab``, null at shift 0), the
// row's and the column's parts given: ``rel`` = rel16(qi) - rel16(kj),
// ``same`` = whether qi and kj share a region
__device__ __forceinline__ float probability(float s, float scale,
                                             const float* __restrict__ tab,
                                             int rel, bool same, float mx,
                                             float inv) {
#if ATTN16_F32_TERM
  const float term = __ldg(tab + rel) + (same ? 0.f : kMaskOff);
  return expf(s * scale + term - mx) * inv;
#else
  return s * scale * inv - mx + (float)rel + (same ? 0.f : 1.f);
#endif
}

// S and dP of a warp's 16 rows of planes (a, a2) against 32 rows of
// planes (b, b2) from row n0, over the head dims: s += a b^T, dp += a2 b2^T
template <int HDP>
__device__ __forceinline__ void scores_pair(const float* a, const float* a2,
                                            const float* b, const float* b2,
                                            int r0, int n0,
                                            float (&s)[4][4],
                                            float (&dp)[4][4]) {
  constexpr int P = kPitch<HDP>, KT = HDP / 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  auto step = [&](int kk) {
    uint32_t ah[4], al[4], ch[4], cl[4];
    frag_a<P>(a, r0, 8 * kk, ah, al);
    frag_a<P>(a2, r0, 8 * kk, ch, cl);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bh[2], bl[2], b2h[2], b2l[2];
      frag_b_rows<P>(b, n0 + 8 * j, 8 * kk, bh, bl);
      frag_b_rows<P>(b2, n0 + 8 * j, 8 * kk, b2h, b2l);
      mma3x2(s[j], ah, al, bh, bl, dp[j], ch, cl, b2h, b2l);
    }
  };
#pragma unroll 1
  for (int kk = 0; kk + 1 < KT; kk += 2) {    // two head-dim steps a pass
    step(kk);
    step(kk + 1);
  }
  if (KT & 1) step(KT - 1);
}

// ---- N = 256: dq launch, a block per (window, head, query tile) -------------
//
// Warp (wr, wc) keeps S, dP (then dS) of its 16 query rows x 32 keys of
// each key tile in registers, trades its dS half with its row's other warp
// and accumulates dQ of its rows over the tile's 64 keys in the head dims'
// n8 tiles wc, wc + 2, .. The next key tile's k and v land in the other
// pair of planes while a tile is computed.

template <int HDP>
__global__ void __launch_bounds__(kThreads, Tc16<HDP>::kDqMinBlocks)
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
  using T = Tc16<HDP>;
  constexpr int R = T::R, P = T::P, KT = T::KT, NQ = (KT + 1) / 2;
  constexpr int kTiles = Geo<N>::kTiles;
  extern __shared__ __align__(16) float smem[];
  constexpr int PL = T::kPlane;
  float* qs = smem;                       // planes: q, dO, k0, k1, v0, v1
  float* dos = qs + PL;
  float* ks = dos + PL;                   // key tile kt in ks + (kt & 1) PL
  float* vs = ks + 2 * PL;
  float4* exch = reinterpret_cast<float4*>(vs + 2 * PL);
  float* st = reinterpret_cast<float*>(exch + kExchange);
  float* rd = st + 128;

  const int nww = W / Geo<N>::kWin;
  const int nw = (H / Geo<N>::kWin) * nww;
  int bid = blockIdx.x;
  const int qt = bid % kTiles;
  bid /= kTiles;
  const int h = bid % nh;
  const int gw = bid / nh;                // image * nW + window
  const int b = gw / nw, win = gw % nw;
  const int wi = win / nww, wj = win % nww;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid / 32, t = tid & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int col = h * hd, t0 = qt * R, sc = col & 3;
  const size_t row0 = ((size_t)gw * nh + h) * N + t0;   // stats / dsum row
  for (int i = tid; i < 6 * R * P; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  // q, dO, O (into the second k plane) and key tile 0
  stage_async<HDP>(qs, qkv, ldq, col, b, wi, wj, t0, H, W, shift, hd);
  stage_async<HDP>(dos, dout, ldg, col, b, wi, wj, t0, H, W, shift, hd);
  stage_async<HDP>(ks + PL, ctx, ldc, col, b, wi, wj, t0, H, W, shift, hd);
  stage_async<HDP>(ks, qkv, ldq, C + col, b, wi, wj, 0, H, W, shift, hd);
  stage_async<HDP>(vs, qkv, ldq, 2 * C + col, b, wi, wj, 0, H, W, shift,
                   hd);
  stage_stats(st, stats, nullptr, row0);
  land_async<HDP>(qs, PL, 5, col, hd);    // q, dO, k0, O, v0
  __syncthreads();
  {
    // D = rowsum(dO o O): four lanes a row, a quarter of the head dims each
    const int r = tid / 4, part = tid % 4;
    float d = 0.f;
    for (int x = part; x < HDP; x += 4)
      d += dos[r * P + sc + x] * ks[PL + r * P + sc + x];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      rd[r] = d;
      dsum[row0 + r] = d;
    }
  }
  __syncthreads();                        // O's plane is free for tile 1

  const int ra = 16 * wr + ((tid & 31) >> 2);   // rows ra, ra + 8
  const float* tab = table + h * 961 + 480;
  const int* lab = static_cast<const int*>(labels);
  if (lab != nullptr) lab += (size_t)win * N;
  const int rel_q[2] = {rel16(t0 + ra), rel16(t0 + ra + 8)};
  const int lab_q[2] = {lab ? __ldg(lab + t0 + ra) : 0,
                        lab ? __ldg(lab + t0 + ra + 8) : 0};
  float dq[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = 0; kt < kTiles; ++kt) {
    const int cur = (kt & 1) * PL, nxt = PL - cur;
    if (kt + 1 < kTiles) {                // the next key tile, meanwhile
      stage_async<HDP>(ks + nxt, qkv, ldq, C + col, b, wi, wj, (kt + 1) * R,
                       H, W, shift, hd);
      stage_async<HDP>(vs + nxt, qkv, ldq, 2 * C + col, b, wi, wj,
                       (kt + 1) * R, H, W, shift, hd);
    }
    const float* kp = ks + cur + sc;
    float s[4][4], dp[4][4];              // S = Q K^T, dP = dO V^T
    scores_pair<HDP>(qs + sc, dos + sc, kp, vs + cur + sc, 16 * wr, 32 * wc,
                     s, dp);
    // dS = P o (dP - D), P from the forward's statistics, in place of S,
    // and the half the row's other warp needs into the exchange
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, r = ra + 8 * hh;
        const int kj = kt * R + 32 * wc + 8 * j + 2 * t + (e & 1);
        const bool same = lab == nullptr || __ldg(lab + kj) == lab_q[hh];
        const float p = probability(s[j][e], scale, tab,
                                    rel_q[hh] - rel16(kj), same, st[2 * r],
                                    st[2 * r + 1]);
        s[j][e] = p * (dp[j][e] - rd[r]);
      }
      exch[((wc * 4 + wr) * 4 + j) * 32 + lane] =
          make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
    __syncthreads();
    // dQ += dS K over the tile's 64 keys, the warp's head-dim n8 tiles
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 o = exch[(((1 - wc) * 4 + wr) * 4 + j) * 32 + lane];
        const bool own = hf == wc;
        uint32_t ah[4], al[4];
        frag_a_of_c(own ? s[j][0] : o.x, own ? s[j][1] : o.y,
                    own ? s[j][2] : o.z, own ? s[j][3] : o.w, ah, al);
#pragma unroll
        for (int n = 0; n < NQ; n += 2) {   // two n8 tiles at a time
          const int nt = 2 * n + wc;
          uint32_t bh[2], bl[2], b2h[2], b2l[2];
          if (n + 1 < NQ && nt + 2 < KT) {
            frag_b_cols<P>(kp, 32 * hf + 8 * j, 8 * nt, bh, bl);
            frag_b_cols<P>(kp, 32 * hf + 8 * j, 8 * (nt + 2), b2h, b2l);
            mma3x2(dq[n], ah, al, bh, bl, dq[n + 1], ah, al, b2h, b2l);
          } else if (nt < KT) {
            frag_b_cols<P>(kp, 32 * hf + 8 * j, 8 * nt, bh, bl);
            mma3(dq[n], ah, al, bh, bl);
          }
        }
      }
    }
    if (kt + 1 < kTiles) land_async<HDP>(ks + nxt, 2 * PL, 2, col, hd);
    __syncthreads();                      // this tile's reads are done
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = ra + 8 * hh;
    float* dst = dqkv + token_row<N>(b, wi, wj, t0 + r, H, W, shift) * ldd
                 + col;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (2 * n + wc) + 2 * t + e;
        if (c < hd) dst[c] = dq[n][2 * hh + e] * scale;
      }
  }
}

// ---- N = 256: dkv launch, a block per (group of windows, head, key tile) ----
//
// Warp (wr, wc) computes S^T = K Q^T and dP^T = V dO^T of its 16 keys x 32
// queries of each query tile in registers, P^T and dS^T in their place, and
// adds dS^T into the block's d(bias) tile in shared memory (each element
// always by the same thread: a fixed order over the group's windows). Warp
// wc = 0 accumulates dV = P^T dO of its keys over the tile's 64 queries,
// wc = 1 dK = dS^T Q: each trades the half the other needs (its dS, its P)
// through the exchange. Where two q and dO planes fit (kDkvDouble), the
// next query tile (of this window or the next one) lands while a tile is
// computed.

template <int HDP>
__global__ void __launch_bounds__(kThreads, Tc16<HDP>::kDkvMinBlocks)
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
  using T = Tc16<HDP>;
  constexpr int R = T::R, P = T::P, KT = T::KT, NB = T::kDkvBuffers;
  constexpr int kQT = Geo<N>::kTiles;
  extern __shared__ __align__(16) float smem[];
  constexpr int PL = T::kPlane;
  float* ks = smem;                       // planes: k, v, then q and dO a
  float* vs = ks + PL;                    // buffer: buffer u's q at qs + 2u
  float* qs = vs + PL;                    // PL, its dO PL after it
  float4* exch = reinterpret_cast<float4*>(qs + 2 * NB * PL);
  float* st = reinterpret_cast<float*>(exch + kExchange);   // a buffer's
  float* dbs = st + NB * kStatFloats;     // statistics, then d(bias)

  const int nww = W / Geo<N>::kWin;
  const int nw = (H / Geo<N>::kWin) * nww;
  int bid = blockIdx.x;
  const int kt = bid % kQT;
  bid /= kQT;
  const int h = bid % nh, grp = bid / nh;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid / 32, t = tid & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int col = h * hd, k0 = kt * R, sc = col & 3;
  const int ka = 16 * wr + ((tid & 31) >> 2);   // keys ka, ka + 8
  const float* tab = table + h * 961 + 480;
  const int rel_k[2] = {rel16(k0 + ka), rel16(k0 + ka + 8)};
  for (int i = tid; i < (2 + 2 * NB) * R * P; i += kThreads) smem[i] = 0.f;
  for (int i = tid; i < N * kDbPitch; i += kThreads) dbs[i] = 0.f;
  __syncthreads();

  // a query tile's q and dO rows and their statistics into buffer ``buf``
  auto stage_q = [&](int gw_, int qt_, int buf) {
    const int b_ = gw_ / nw, win_ = gw_ % nw;
    stage_async<HDP>(qs + 2 * buf * PL, qkv, ldq, col, b_, win_ / nww,
                     win_ % nww, qt_ * R, H, W, shift, hd);
    stage_async<HDP>(qs + (2 * buf + 1) * PL, dout, ldg, col, b_, win_ / nww,
                     win_ % nww, qt_ * R, H, W, shift, hd);
    stage_stats(st + buf * kStatFloats, stats, dsum,
                ((size_t)gw_ * nh + h) * N + qt_ * R);
  };
  const int w_begin = grp * group, w_end = min(windows, (grp + 1) * group);
  int buf = 0;
  if (NB == 2) stage_q(w_begin, 0, 0);
  for (int gw = w_begin; gw < w_end; ++gw) {
    const int b = gw / nw, win = gw % nw;
    const int wi = win / nww, wj = win % nww;
    const int* lab = static_cast<const int*>(labels);
    if (lab != nullptr) lab += (size_t)win * N;
    const int lab_k[2] = {lab ? __ldg(lab + k0 + ka) : 0,
                          lab ? __ldg(lab + k0 + ka + 8) : 0};
    // k and v of the window: the last window's reads ended at its last
    // tile's barrier
    stage_async<HDP>(ks, qkv, ldq, C + col, b, wi, wj, k0, H, W, shift, hd);
    stage_async<HDP>(vs, qkv, ldq, 2 * C + col, b, wi, wj, k0, H, W, shift,
                     hd);
    float acc[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int qt = 0; qt < kQT; ++qt) {
      const int t0 = qt * R;
      if (NB == 1) stage_q(gw, qt, 0);
      land_async<HDP>(qs + 2 * buf * PL, PL, 2, col, hd);
      if (qt == 0) land_async<HDP>(ks, PL, 2, col, hd);
      __syncthreads();
      if (NB == 2) {                      // the next tile, meanwhile
        if (qt + 1 < kQT)
          stage_q(gw, qt + 1, buf ^ 1);
        else if (gw + 1 < w_end)
          stage_q(gw + 1, 0, buf ^ 1);
      }
      const float* qp = qs + 2 * buf * PL + sc;
      const float* op = qp + PL;
      const float* rs = st + buf * kStatFloats;
      float s[4][4], dp[4][4];            // S^T, dP^T: keys ka (+ 8),
      scores_pair<HDP>(ks + sc, vs + sc, qp, op, 16 * wr, 32 * wc, s, dp);
#pragma unroll                            // queries 32 wc + 8 j + 2 t (+ 1)
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, key = ka + 8 * hh;
          const int q = 32 * wc + 8 * j + 2 * t + (e & 1);
          const bool same = lab == nullptr || __ldg(lab + t0 + q) == lab_k[hh];
          const float p = probability(s[j][e], scale, tab,
                                      rel16(t0 + q) - rel_k[hh], same,
                                      rs[2 * q], rs[2 * q + 1]);
          const float ds = p * (dp[j][e] - rs[128 + q]);
          dbs[(t0 + q) * kDbPitch + key] += ds;
          s[j][e] = p;
          dp[j][e] = ds;
        }
        // wc = 0 hands its dS to the dK warp, wc = 1 its P to the dV warp
        exch[((wc * 4 + wr) * 4 + j) * 32 + lane] = wc == 0
            ? make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3])
            : make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      }
      __syncthreads();
      // wc = 0: dV from P^T and dO; wc = 1: dK from dS^T and Q
      const float* bplane = wc == 0 ? op : qp;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {    // the tile's 64 queries
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 o = exch[(((1 - wc) * 4 + wr) * 4 + j) * 32 + lane];
          const float4 m = wc == 0
              ? make_float4(s[j][0], s[j][1], s[j][2], s[j][3])
              : make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
          const float4 a = hf == wc ? m : o;
          uint32_t ah[4], al[4];
          frag_a_of_c(a.x, a.y, a.z, a.w, ah, al);
#pragma unroll
          for (int n = 0; n < KT; n += 2) {   // two n8 tiles at a time
            uint32_t bh[2], bl[2], b2h[2], b2l[2];
            frag_b_cols<P>(bplane, 32 * hf + 8 * j, 8 * n, bh, bl);
            if (n + 1 < KT) {
              frag_b_cols<P>(bplane, 32 * hf + 8 * j, 8 * (n + 1), b2h, b2l);
              mma3x2(acc[n], ah, al, bh, bl, acc[n + 1], ah, al, b2h, b2l);
            } else {
              mma3(acc[n], ah, al, bh, bl);
            }
          }
        }
      }
      __syncthreads();                    // this tile's reads are done
      buf ^= NB - 1;
    }
    // wc = 0 writes dV, wc = 1 dK (scaled) of its keys
    const float mul = wc == 0 ? 1.f : scale;
    const int part_col = (wc == 0 ? 2 * C : C) + col;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = ka + 8 * hh;
      float* dst = dqkv + token_row<N>(b, wi, wj, k0 + key, H, W, shift) * ldd
                   + part_col;
#pragma unroll
      for (int n = 0; n < KT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < hd) dst[c] = acc[n][2 * hh + e] * mul;
        }
    }
  }
  float* out = part + ((size_t)grp * nh + h) * N * N + k0;
  for (int i = tid; i < N * R; i += kThreads)
    out[(size_t)(i / R) * N + i % R] = dbs[(i / R) * kDbPitch + i % R];
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
  int rc;
  if constexpr (N < 256) {
    constexpr size_t bytes = bwd_smem_bytes<N, HDP>();
    static_assert(bytes <= kMaxSmem,
                  "window_attention_bwd_f32: shared memory");
    if ((long long)bytes != a.smem) return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if ((rc = allow_smem(attn_bwd_f32_kernel<N, HDP>, bytes, configured)))
      return rc;
    attn_bwd_f32_kernel<N, HDP><<<(unsigned)(groups * a.nh), kThreads, bytes,
                                  s>>>(
        a.qkv, a.ldq, a.dout, a.ldg, a.bias, a.mask, a.dqkv, a.ldd, a.part,
        a.H, a.W, a.C, a.nh, hd, a.shift, a.group, (int)windows, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
  } else {
    constexpr size_t bytes = dkv16_smem_bytes<HDP>();
    constexpr size_t dq_bytes = dq16_smem_bytes<HDP>();
    static_assert(bytes <= kMaxSmem && dq_bytes <= kMaxSmem,
                  "window_attention_bwd_f32: shared memory");
    if ((long long)bytes != a.smem || (long long)dq_bytes != a.smem_dq)
      return (int)cudaErrorInvalidValue;
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

// head dims padded to 16 at N = 16 and 64 (a row's two warps take the n8
// tiles wc, wc + 2, ..), to 8 at N = 256 (the mma k8 steps and n8 tiles)
template <int N>
int bwd_by_head(const BwdArgs& a, cudaStream_t s) {
  const int hd = a.C / a.nh;
  if constexpr (N == 256) {
    // the head tiles of this source: up to 64 in
    // window_attention_bwd16_f32.cu, 72-128 in
    // window_attention_bwd16_f32_wide.cu (ADSR_BWD16_WIDE), so nvcc builds
    // the two halves of the 32 instances in parallel
    switch ((hd + 7) / 8) {
#define ADSR_HDP(K) \
      case K: return bwd_launch<N, 8 * K>(a, s);
#if ADSR_BWD16_WIDE
      ADSR_HDP(9) ADSR_HDP(10) ADSR_HDP(11) ADSR_HDP(12)
      ADSR_HDP(13) ADSR_HDP(14) ADSR_HDP(15) ADSR_HDP(16)
#else
      ADSR_HDP(1) ADSR_HDP(2) ADSR_HDP(3) ADSR_HDP(4)
      ADSR_HDP(5) ADSR_HDP(6) ADSR_HDP(7) ADSR_HDP(8)
#endif
#undef ADSR_HDP
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch ((hd + 15) / 16) {
#define ADSR_HDP(K) \
      case K: return bwd_launch<N, 16 * K>(a, s);
      ADSR_HDP(1) ADSR_HDP(2) ADSR_HDP(3) ADSR_HDP(4)
      ADSR_HDP(5) ADSR_HDP(6) ADSR_HDP(7) ADSR_HDP(8)
#undef ADSR_HDP
      default: return (int)cudaErrorInvalidValue;
    }
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
