// Tiles of one window's tokens for the attention kernels at 16x16 windows
// (N = 256 tokens, walked in tiles of 64): the raster row of a token of a
// (cyclically shifted) window, the 16-byte slots a staged tile takes and
// the cp.async group calls (the gathers themselves are attn16.cuh's and
// swin_block16.cu's). put8 / get8 are kernel (f)'s N = 64 gather and store
// of 16-byte pieces.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 tile_bf16;

constexpr int kTileRows = 64;      // tokens a tile

// The raster row of token t of a WIN x WIN window whose shifted origin is
// (row0, col0): the cyclic shift wraps at most once (shift < WIN).
template <int WIN>
struct WinRows {
  long long img;
  int row0, col0, H, W;

  __device__ __forceinline__ long long operator()(int t) const {
    int r = row0 + t / WIN, c = col0 + t % WIN;
    r -= r >= H ? H : 0;
    c -= c >= W ? W : 0;
    return img + (long long)r * W + c;
  }
};

// 8 bf16 of a 16-byte piece into head dims [j0, j0 + 8) of a plane row,
// those in [0, hd) only: one 16-byte or four 4-byte stores where the piece
// lies inside the head and is so aligned, element stores at its edges.
__device__ __forceinline__ void put8(tile_bf16* row, int j0, int hd, uint4 v) {
  if (j0 >= 0 && j0 + 8 <= hd && (j0 & 1) == 0) {
    if ((j0 & 7) == 0) {
      *reinterpret_cast<uint4*>(row + j0) = v;
    } else {
      uint32_t* d = reinterpret_cast<uint32_t*>(row + j0);
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    return;
  }
  const tile_bf16* e = reinterpret_cast<const tile_bf16*>(&v);
#pragma unroll
  for (int x = 0; x < 8; ++x)
    if (j0 + x >= 0 && j0 + x < hd) row[j0 + x] = e[x];
}

// n (8 or 4) bf16 of a plane row from head dim j0 (inside the head), as
// put8 stores them
__device__ __forceinline__ uint4 get8(const tile_bf16* row, int j0, int n) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if ((j0 & 7) == 0 && n == 8)
    return *reinterpret_cast<const uint4*>(row + j0);
  if ((j0 & 1) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(row + j0);
    v.x = s[0];
    v.y = s[1];
    if (n == 8) {
      v.z = s[2];
      v.w = s[3];
    }
    return v;
  }
  tile_bf16* e = reinterpret_cast<tile_bf16*>(&v);
#pragma unroll
  for (int x = 0; x < 8; ++x)
    if (x < n) e[x] = row[j0 + x];
  return v;
}

// The 16-byte slots a tile of one part needs in a staging area: 64 rows
// of at most HDP / 8 + 1 pieces (a head of hd <= HDP columns from any
// column offset spans at most that many)
__host__ __device__ constexpr int stage_slots(int hdp) {
  return kTileRows * (hdp / 8 + 1);
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void stage_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
