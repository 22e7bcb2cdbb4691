// window_attention_f32.cuh: the f32 window-attention pieces shared by the
// f32 kernels over 4x4, 8x8 and 16x16 windows (N = 16, 64 and 256 tokens):
// the window geometry and its plane pitch, the cyclic shift's raster row
// map (token_row), the staging of a head's rows into zero-padded planes
// (stage_rows, kernel (f) f32 at N = 16 and 64), the bias and mask lookup
// in the forms kernels/window_attention.py ``attn_operands`` gives
// (attn_term: the full [nh, N, N] bias and [nW, N, N] mask at N = 16 and
// 64, the relative-position table [nh, 31 * 31] and the region labels [nW,
// 256] at N = 256), and the SIMT online-softmax core over one key tile
// (attend_scores, attend_pv: FFMA products on a 256-thread block), which
// is kernel (g) f32's attention (swin_block_f32.cuh).
//
// Kernel (c) f32 itself, on the tensor cores, is window_attention_tc_f32.cuh;
// (f) f32 is window_attention_bwd_f32.cuh.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;
constexpr float kMaskOff = -100.f;        // between regions at N = 256

template <int N>
struct Geo {
  static constexpr int kWin = N == 16 ? 4 : (N == 64 ? 8 : 16);
  static constexpr int R = N < 64 ? N : 64;   // query rows, keys a tile
  static constexpr int kTiles = N / R;        // key tiles = query tiles
  static constexpr int kSP = R + 4;           // floats a row of S
};

// floats a row of the q, k and v planes: the padded head dim and 4 more, so
// eight consecutive rows start in eight different 16-byte bank groups
template <int HDP>
constexpr int kPitch = HDP + 4;

template <int N>
__device__ __forceinline__ long long token_row(int b, int wi, int wj, int t,
                                               int H, int W, int shift) {
  constexpr int kWin = Geo<N>::kWin;
  const int r = t / kWin, s = t % kWin;
  const int row = (wi * kWin + r + shift) % H;
  const int col = (wj * kWin + s + shift) % W;
  return (long long)b * H * W + (long long)row * W + col;
}

// rows [t0, t0 + R) of the window's part ``part`` (0 q, 1 k, 2 v) into the
// plane: the 16-byte pieces of each row that hold the head's hd columns,
// each value kept where it falls in [0, hd)
template <int N, int HDP>
__device__ __forceinline__ void stage_rows(float* plane,
                                           const float* __restrict__ qkv,
                                           long long ldq, int b, int wi,
                                           int wj, int t0, int H, int W,
                                           int shift, int col, int hd) {
  constexpr int R = Geo<N>::R;
  const int lo = col & ~3;
  const int pieces = (col + hd - lo + 3) / 4;
  for (int i = threadIdx.x; i < R * pieces; i += kThreads) {
    const int r = i / pieces, k = i - r * pieces;
    const int c0 = lo + 4 * k;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        qkv + token_row<N>(b, wi, wj, t0 + r, H, W, shift) * ldq + c0));
    const float e[4] = {v.x, v.y, v.z, v.w};
    float* dst = plane + r * kPitch<HDP>;
    const int j0 = c0 - col;              // head dim of e[0]
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (j0 + x >= 0 && j0 + x < hd) dst[j0 + x] = e[x];
  }
}

// the additive term of query qi and key kj (window-local token indices)
template <int N>
__device__ __forceinline__ float attn_term(const float* __restrict__ bias,
                                           const void* __restrict__ mask,
                                           int h, int win, int qi, int kj) {
  if constexpr (N == 256) {
    constexpr int kW = Geo<N>::kWin, kT = 2 * kW - 1;
    const int idx = (qi / kW - kj / kW + kW - 1) * kT + (qi % kW - kj % kW)
                    + kW - 1;
    float t = __ldg(bias + h * kT * kT + idx);
    if (mask != nullptr) {
      const int* lab = static_cast<const int*>(mask) + (size_t)win * N;
      if (__ldg(lab + qi) != __ldg(lab + kj)) t += kMaskOff;
    }
    return t;
  } else {
    float t = __ldg(bias + ((size_t)h * N + qi) * N + kj);
    if (mask != nullptr)
      t += __ldg(static_cast<const float*>(mask) + ((size_t)win * N + qi) * N
                 + kj);
    return t;
  }
}

// The thread maps of the online-softmax core (attend_scores, attend_pv) for
// N keys a window and head dims padded to HDP, on a block of kThreads
// threads
template <int N, int HDP>
struct Attend {
  static constexpr int R = Geo<N>::R, SP = Geo<N>::kSP, P = kPitch<HDP>;
  // scores: a 16 x 16 grid of threads, SR x SR scores each
  static constexpr int SR = R / 16;
  // softmax: TPR lanes a row, KPT keys each
  static constexpr int TPR = kThreads / R, KPT = R / TPR;
  // P @ V: a thread takes four head dims (group dg of G4) of RPT rows RS
  // apart
  static constexpr int G4 = HDP / 4, RS = kThreads / G4;
  static constexpr int RPT = (R + RS - 1) / RS;
};

// One key tile of the online softmax, the core of kernel (g) f32
// (swin_block_f32.cuh), in two halves. attend_scores: the R
// query rows of ``qs`` (window tokens q0 ..) against the R keys of ``ks``
// (window tokens k0 ..), planes [R][P] zero past the head dim: S = scale q
// k^T + bias (+ mask) into ``ss`` as P = exp(S - max), each row's running
// max and sum updated and its rescale factor in ``row_alpha``. The caller
// has synchronised the block after filling the planes and setting row_max
// to -inf and row_sum to 0; this ends with a barrier, so ``ks`` may be
// refilled after it. attend_pv: the context ``o`` (this thread's rows and
// four head dims) rescaled and accumulated over the tile's values ``vs``;
// it ends with a barrier, so ``vs`` and ``ss`` may be refilled after it.
template <int N, int HDP>
__device__ __forceinline__ void attend_scores(
    const float* qs, const float* ks, float* ss, float* row_max,
    float* row_sum, float* row_alpha, const float* __restrict__ bias,
    const void* __restrict__ mask, int h, int win, int q0, int k0,
    float scale) {
  using A = Attend<N, HDP>;
  constexpr int SP = A::SP, P = A::P, SR = A::SR;
  constexpr int TPR = A::TPR, KPT = A::KPT;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;          // scores
  const int srow = tid / TPR, spart = tid % TPR;   // softmax

  // S = scale * q k^T + bias (+ mask)
  float s[SR][SR];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SR; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; d += 4) {
    float4 q4[SR], k4[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i)
      q4[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * P + d);
#pragma unroll
    for (int j = 0; j < SR; ++j)
      k4[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * P + d);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        float v = s[i][j];
        v = fmaf(q4[i].x, k4[j].x, v);
        v = fmaf(q4[i].y, k4[j].y, v);
        v = fmaf(q4[i].z, k4[j].z, v);
        s[i][j] = fmaf(q4[i].w, k4[j].w, v);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < SR; ++j) {
      const int c = tx + 16 * j;
      ss[r * SP + c] = s[i][j] * scale
                       + attn_term<N>(bias, mask, h, win, q0 + r, k0 + c);
    }
  }
  __syncthreads();

  // the online softmax of each row over this tile: TPR lanes a row
  {
    float* sr = ss + srow * SP;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) mx = fmaxf(mx, sr[spart + TPR * j]);
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = row_max[srow];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float e = expf(sr[spart + TPR * j] - m_new);
      sr[spart + TPR * j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
    if (spart == 0) {
      const float alpha = expf(m_old - m_new);    // 0 on the first tile
      row_alpha[srow] = alpha;
      row_sum[srow] = row_sum[srow] * alpha + sum;
      row_max[srow] = m_new;
    }
  }
  __syncthreads();
}

template <int N, int HDP>
__device__ __forceinline__ void attend_pv(
    const float* vs, const float* ss, const float* row_alpha,
    float (&o)[Attend<N, HDP>::RPT][4]) {
  using A = Attend<N, HDP>;
  constexpr int R = A::R, SP = A::SP, P = A::P, G4 = A::G4, RS = A::RS;
  constexpr int RPT = A::RPT;
  const int tid = threadIdx.x;
  const int dg = tid % G4, r0 = tid / G4;
  const bool pv = tid < RS * G4;

  // o = alpha o + P v over this tile's keys
  if (pv) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + RS * i;
      if (r < R) {
        const float alpha = row_alpha[r];
#pragma unroll
        for (int x = 0; x < 4; ++x) o[i][x] *= alpha;
      }
    }
#pragma unroll 4
    for (int k = 0; k < R; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(vs + k * P + 4 * dg);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = r0 + RS * i;
        if (r < R) {
          const float pk = ss[r * SP + k];
          o[i][0] = fmaf(pk, v.x, o[i][0]);
          o[i][1] = fmaf(pk, v.y, o[i][1]);
          o[i][2] = fmaf(pk, v.z, o[i][2]);
          o[i][3] = fmaf(pk, v.w, o[i][3]);
        }
      }
    }
  }
  __syncthreads();                        // before the next tile's loads
}

}  // namespace
