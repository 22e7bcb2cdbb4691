// Tiles of one window's tokens for the attention kernels at 16x16 windows
// (N = 256 tokens, walked in tiles of 64): the raster row of a token of a
// (cyclically shifted) window, and the gather of a head's columns of 64
// token rows into a bf16 plane in shared memory, and the scatter back, by
// 16-byte pieces of rows with 16-byte rows (row strides a multiple of 8
// elements): synchronously (load_tile), or by cp.async into a staging area
// that a later unpack_tile spreads into the plane (stage_tile), so that the
// next tile's loads overlap this tile's products. put8 / get8 are also
// kernel (f)'s N = 64 gather and store.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 tile_bf16;

constexpr int kTileRows = 64;      // tokens a tile
constexpr int kTileThreads = 128;  // 4 warps x 16 rows
constexpr int kTileBatch = 8;      // 16-byte loads in flight a thread

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

// Tokens [t0, t0 + 64) of a window, columns [s, s + hd) of ``src`` (row
// stride ``ld``, rows ``width`` wide), into rows [0, 64) of a plane (``LD``
// elements a row; dims >= hd are left alone). The pieces start at column
// s & ~7; a piece is 4 columns wide at the end of a row whose width is 4
// past a multiple of 8.
template <int WIN>
__device__ __forceinline__ void load_tile(tile_bf16* plane, int LD,
                                          const tile_bf16* __restrict__ src,
                                          long long ld, int width, int s,
                                          int hd, const WinRows<WIN>& rows,
                                          int t0) {
  const int lo = s & ~7, n = (s + hd - lo + 7) >> 3, total = kTileRows * n;
  for (int base = threadIdx.x; base < total;
       base += kTileThreads * kTileBatch) {
    uint4 v[kTileBatch];
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      const int i = base + j * kTileThreads;
      if (i < total) {
        const int t = i / n, c0 = lo + 8 * (i - t * n);
        const tile_bf16* p = src + rows(t0 + t) * ld + c0;
        if (c0 + 8 <= width) {
          v[j] = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
          v[j] = make_uint4(u.x, u.y, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      const int i = base + j * kTileThreads;
      if (i < total) {
        const int t = i / n, c0 = lo + 8 * (i - t * n);
        put8(plane + t * LD, c0 - s, hd, v[j]);
      }
    }
  }
}

// Rows [0, 64) of a plane (head dims [0, hd)) back to columns [s, s + hd)
// of tokens [t0, t0 + 64) of ``dst``: 16-byte stores, element stores where
// a piece is shared with a neighbouring head or part.
template <int WIN>
__device__ __forceinline__ void store_tile(const tile_bf16* plane, int LD,
                                           tile_bf16* __restrict__ dst,
                                           long long ld, int width, int s,
                                           int hd, const WinRows<WIN>& rows,
                                           int t0) {
  const int lo = s & ~7, n = (s + hd - lo + 7) >> 3;
  for (int i = threadIdx.x; i < kTileRows * n; i += kTileThreads) {
    const int t = i / n, c0 = lo + 8 * (i - t * n);
    const int m = min(8, width - c0);
    const tile_bf16* row = plane + t * LD;
    tile_bf16* d = dst + rows(t0 + t) * ld + c0;
    if (c0 >= s && c0 + m <= s + hd) {
      const uint4 v = get8(row, c0 - s, m);
      if (m == 8)
        *reinterpret_cast<uint4*>(d) = v;
      else
        *reinterpret_cast<uint2*>(d) = make_uint2(v.x, v.y);
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x)
        if (x < m && c0 + x >= s && c0 + x < s + hd) d[x] = row[c0 - s + x];
    }
  }
}

// The 16-byte slots a tile of one part needs in a staging area: 64 rows
// of at most HDP / 8 + 1 pieces (a head of hd <= HDP columns from any
// column offset spans at most that many)
__host__ __device__ constexpr int stage_slots(int hdp) {
  return kTileRows * (hdp / 8 + 1);
}

// cp.async the raw 16-byte pieces of a tile (the pieces load_tile reads)
// into ``stage`` (a shared-memory address, 16-byte slots, piece i of the
// tile in slot i); the caller commits and waits. A 4-column piece at the
// end of a row copies 8 bytes (the rest of its slot is never unpacked:
// columns past the row width belong to no head).
template <int WIN>
__device__ __forceinline__ void stage_tile(uint32_t stage,
                                           const tile_bf16* __restrict__ src,
                                           long long ld, int width, int s,
                                           int hd, const WinRows<WIN>& rows,
                                           int t0) {
  const int lo = s & ~7, n = (s + hd - lo + 7) >> 3;
  for (int i = threadIdx.x; i < kTileRows * n; i += kTileThreads) {
    const int t = i / n, c0 = lo + 8 * (i - t * n);
    const tile_bf16* p = src + rows(t0 + t) * ld + c0;
    if (c0 + 8 <= width)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   ::"r"(stage + 16u * i), "l"(p));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   ::"r"(stage + 16u * i), "l"(p));
  }
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void stage_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The staged pieces of a tile (stage_tile's ``stage``, here as a pointer)
// into rows [0, 64) of a plane, as load_tile unpacks them
__device__ __forceinline__ void unpack_tile(tile_bf16* plane, int LD,
                                            const uint4* stage, int s,
                                            int hd) {
  const int lo = s & ~7, n = (s + hd - lo + 7) >> 3;
  for (int i = threadIdx.x; i < kTileRows * n; i += kTileThreads) {
    const int t = i / n, c0 = lo + 8 * (i - t * n);
    put8(plane + t * LD, c0 - s, hd, stage[i]);
  }
}

// Zero dims [hd, HDP) of ``rows`` plane rows (the mma k and n padding)
template <int HDP>
__device__ __forceinline__ void zero_pad(tile_bf16* planes, int rows, int hd) {
  const int pad = HDP - hd;
  if (pad <= 0) return;
  for (int i = threadIdx.x; i < rows * pad; i += kTileThreads) {
    const int r = i / pad;
    planes[r * (HDP + 8) + hd + (i - r * pad)] = __float2bfloat16(0.f);
  }
}

}  // namespace
