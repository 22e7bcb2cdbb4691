// window_attention_f32.cuh: the f32 window-attention pieces shared by the
// f32 kernels over 4x4, 8x8 and 16x16 windows (N = 16, 64 and 256 tokens):
// the window geometry and its plane pitch, the cyclic shift's raster row
// map (token_row) and the bias and mask lookup in the forms
// kernels/window_attention.py ``attn_operands`` gives (attn_term: the full
// [nh, N, N] bias and [nW, N, N] mask at N = 16 and 64, the
// relative-position table [nh, 31 * 31] and the region labels [nW, 256] at
// N = 256).
//
// Kernel (c) f32 is window_attention_tc_f32.cuh, (f) f32
// window_attention_bwd_f32.cuh and (g) f32 swin_block_f32.cuh, each on the
// tensor cores.

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

}  // namespace
