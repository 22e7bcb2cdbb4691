// The token rows of one 4x4 window (N = 16) for kernels (c) and (f) at
// that window (window_attention4.cu, window_attention_bwd4.cu): each block
// takes every head of its windows, so it moves whole token rows.
//   - stage_rows: the window's 16 raster rows (a width of 3C for qkv, C for
//     dO), cp.async'd in 16-byte pieces into a raw staging area, one row a
//     warp at a time, the row's address computed once (Win4); a row whose
//     width is 4 past a multiple of 8 ends on an 8-byte piece, copied as a
//     16-byte piece with 8 bytes zero-filled.
//   - row_pair, times_rows: the operands of the products read in place
//     from a head's columns of the staged rows, with no re-lay into planes:
//     pairs of columns (one 4-byte load) where head dims are the reduction,
//     pairs of rows (two 2-byte loads) where tokens are;
//   - put_frag: a warp's f32 result in mma's C layout into a head's columns
//     of staged or output rows, so that
//   - store_rows: writes whole rows back in 16-byte pieces (8 bytes at the
//     end of such a row): no element stores, no sector shared with another
//     block.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "window_attn_core.cuh"   // ldsm_x4(_trans), mma_16816

namespace {

typedef __nv_bfloat16 a4_bf16;

constexpr int kTok4 = 16;          // tokens a 4x4 window
constexpr int kMaskBytes4 = kTok4 * kTok4 * 4;   // one window's f32 mask
constexpr int kBiasBytes4 = kTok4 * kTok4 * 4;   // one head's f32 bias

// Elements a staged row takes: its width rounded up to 32 bytes, and 16
// bytes more: 4 (2k + 1) words, so that the words of eight rows at one
// column fall in eight distinct groups of four banks (the pair loads of
// window_attention4.cu's qk_staged, put_frag's stores)
__host__ __device__ constexpr int raw_pitch(int width) {
  return (width + 15) / 16 * 16 + 8;
}

// Bytes of one staged window: its mask and its rows of each width
__host__ __device__ constexpr int stage_bytes4(int w0, int w1) {
  return kMaskBytes4 + kTok4 * 2 * (raw_pitch(w0) + (w1 ? raw_pitch(w1) : 0));
}

// The raster row of token t of window fw (over the flat (image, window)
// index) of a B x H x W token grid cyclically shifted by ``shift``: the
// shift wraps at most once (shift < 4)
struct Win4 {
  long long img;
  int r0, c0, win, H, W;

  __device__ __forceinline__ Win4(int fw, int H_, int W_, int shift) {
    H = H_;
    W = W_;
    const int nww = W >> 2, nw = (H >> 2) * nww;
    const int b = fw / nw;
    win = fw - b * nw;
    const int wi = win / nww, wj = win - wi * nww;
    img = (long long)b * H * W;
    r0 = 4 * wi + shift;
    c0 = 4 * wj + shift;
  }

  __device__ __forceinline__ long long operator()(int t) const {
    int r = r0 + (t >> 2), c = c0 + (t & 3);
    r -= r >= H ? H : 0;
    c -= c >= W ? W : 0;
    return img + (long long)r * W + c;
  }
};

// The timeline build of scripts/torch_attention4_sweep.py (``profile``)
// defines ATTN4_PROFILE: thread 0 of each of the first 2048 blocks marks
// [0] its start (%globaltimer, ns), [1] its start (clock64), then in SM
// cycles [2] its first window's rows staged, [3] its heads computed, [4]
// its rows stored, [5] its end; [6] its end (%globaltimer); [8..11] the
// steps of warp 0's first head (the kernel's own)
#ifdef ATTN4_PROFILE
__device__ unsigned long long attn4_profile[2048 * 16];
#define ATTN4_MARK(k, on)                                                  \
  do {                                                                    \
    if ((on) && threadIdx.x == 0 && blockIdx.x < 2048) {                  \
      unsigned long long t_;                                              \
      if ((k) == 0 || (k) == 6)                                           \
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));            \
      else                                                                \
        t_ = clock64();                                                   \
      attn4_profile[blockIdx.x * 16 + (k)] = t_;                          \
    }                                                                     \
  } while (0)
#else
#define ATTN4_MARK(k, on) \
  do {                    \
  } while (0)
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes at ``dst`` from the first ``bytes`` (16 or 8) at ``src``, the
// rest zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0, 1 or 2) of this thread's groups are in flight
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ uint4 a4_lds16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The 16 rows of window ``rows`` of ``src`` (row stride ``ld``, ``width``
// elements) into ``raw`` (rows of raw_pitch(width) elements): warp ``warp``
// of ``warps`` takes rows warp, warp + warps, ..., its lanes the pieces
__device__ __forceinline__ void stage_rows(uint32_t raw,
                                           const a4_bf16* __restrict__ src,
                                           long long ld, int width,
                                           const Win4& rows, int warp,
                                           int warps, int lane) {
  const int pieces = (width + 7) >> 3;
  const uint32_t pitch = 2u * raw_pitch(width);
  for (int t = warp; t < kTok4; t += warps) {
    const a4_bf16* row = src + rows(t) * ld;
    for (int k = lane; k < pieces; k += 32)
      cp_async16(raw + t * pitch + 16u * k, row + 8 * k,
                 8 * k + 8 <= width ? 16 : 8);
  }
}

// The warps of a block at 4x4 windows, and the head slots they take: one
// warp a slot ((c), and (f) for more than four heads) or two ((f) for four
// heads or fewer), each head its own slot
constexpr int kWarps4 = 8;
__host__ __device__ constexpr int head_slots(int nh) {
  return nh < 8 ? nh : 8;
}
__host__ __device__ constexpr int warps_a_head(int nh) {
  return nh <= 4 ? 2 : 1;
}

// The warps of head slot ``slot`` (``wph`` of them) meet: named barrier 1 +
// slot
__device__ __forceinline__ void head_sync(int slot, int wph) {
  if (wph == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slot), "r"(32 * wph)
                 : "memory");
}

// The two bf16 at elements e, e + 1 of a staged row (e odd where ``odd``),
// those of dims d, d + 1 past the head (>= hd) zero: the row operand of a
// product over head dims (S = q k^T, (f)'s dP = dO v^T), one 4-byte load
// (two and a byte permute where e is odd)
__device__ __forceinline__ uint32_t row_pair(const unsigned char* row, int e,
                                             bool odd, int d, int hd) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (e >> 1);
  const uint32_t v = odd ? __byte_perm(w[0], w[1], 0x5432u) : w[0];
  return d >= hd ? 0u : (d + 1 >= hd ? v & 0xFFFFu : v);
}

// Element e of staged rows ``row`` and row + pitch: the row-major operand
// of a product over tokens ((c)'s P V; (f)'s dQ = dS k, dK = dS^T q, dV =
// P^T dO): two 2-byte loads, the rows of a warp in distinct banks
__device__ __forceinline__ uint32_t rows_pair(const unsigned char* row,
                                              uint32_t pitch, int e) {
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(row + 2 * e);
  const uint32_t hi =
      *reinterpret_cast<const unsigned short*>(row + pitch + 2 * e);
  return lo | (hi << 16);
}

// y[16 x HDP] (mma's C layout, rows lane / 4 and + 8, dims 8j + 2 (lane %
// 4) + {0, 1}) = A[16 x 16] X[16 tokens][HDP dims], X read from the staged
// rows ``x`` (``pitch`` bytes a row) from element s: the A fragment ``a`` in
// registers. The numerics of pv_tile<HDP, 16> and tile_t_times<HDP, 16>: the
// same bf16 operands, one mma an n8 tile
template <int HDP>
__device__ __forceinline__ void times_rows(const uint32_t (&a)[4],
                                           const unsigned char* x,
                                           uint32_t pitch, int s,
                                           float (&y)[HDP / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned char* x0 = x + 2 * t * pitch;      // tokens 2t, 2t + 1
  const unsigned char* x1 = x0 + 8 * pitch;         // tokens 2t + 8, + 9
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) y[j][i] = 0.f;
    mma_16816(y[j], a, rows_pair(x0, pitch, s + 8 * j + g),
              rows_pair(x1, pitch, s + 8 * j + g));
  }
}

// A warp's result o (mma's C layout: o[j][0..1] row lane / 4, dims 8j + 2
// (lane % 4) + {0, 1}; o[j][2..3] row lane / 4 + 8) times ``mul``, dims
// [0, hd), in bf16 into columns [s, s + hd) of the rows at ``raw``
// (``pitch`` bytes a row): pairs as one 4-byte store where s is even, else
// element by element
template <int HDP>
__device__ __forceinline__ void put_frag(unsigned char* raw, uint32_t pitch,
                                         int s, int hd,
                                         const float (&o)[HDP / 8][4],
                                         float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned char* r0 = raw + g * pitch + 2 * s;
  unsigned char* r1 = r0 + 8 * pitch;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * t;
    if (d >= hd) continue;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o[j][0] * mul,
                                                    o[j][1] * mul);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o[j][2] * mul,
                                                    o[j][3] * mul);
    if (((s & 1) == 0) && d + 1 < hd) {
      *reinterpret_cast<__nv_bfloat162*>(r0 + 2 * d) = lo;
      *reinterpret_cast<__nv_bfloat162*>(r1 + 2 * d) = hi;
    } else {
      reinterpret_cast<a4_bf16*>(r0)[d] = lo.x;
      reinterpret_cast<a4_bf16*>(r1)[d] = hi.x;
      if (d + 1 < hd) {
        reinterpret_cast<a4_bf16*>(r0)[d + 1] = lo.y;
        reinterpret_cast<a4_bf16*>(r1)[d + 1] = hi.y;
      }
    }
  }
}

// Columns [0, width) of the 16 staged rows at ``raw`` to the window's rows
// of ``dst`` (row stride ``ld``): whole 16-byte pieces (8 bytes at the end
// of a row whose width is 4 past a multiple of 8), rows by warp as
// stage_rows takes them
__device__ __forceinline__ void store_rows(a4_bf16* __restrict__ dst,
                                           long long ld, int width,
                                           uint32_t raw, uint32_t pitch,
                                           const Win4& rows, int warp,
                                           int warps, int lane) {
  const int pieces = (width + 7) >> 3;
  for (int t = warp; t < kTok4; t += warps) {
    a4_bf16* row = dst + rows(t) * ld;
    for (int k = lane; k < pieces; k += 32) {
      const uint4 v = a4_lds16(raw + t * pitch + 16u * k);
      if (8 * k + 8 <= width)
        *reinterpret_cast<uint4*>(row + 8 * k) = v;
      else
        *reinterpret_cast<uint2*>(row + 8 * k) = make_uint2(v.x, v.y);
    }
  }
}

}  // namespace
