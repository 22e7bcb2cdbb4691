// The wgmma building blocks of the 16x16-window attention kernels (N = 256
// tokens a window, walked in tiles of 64): kernel (c) at N = 256
// (window_attention16.cu) and kernel (f) at N = 256
// (window_attention_bwd16.cu), and kernel (g) at N = 256
// (swin_block16.cu: the bias-table and region-label lookups, the register-A
// wgmma; its tiles hold head dims as rows, see there). The 8x8-window
// kernels keep their own code and registers.
//
// Tiles. A head's 64 token rows of q, k, v, dO (or ctx) are bf16 tiles in
// shared memory in the 128-byte swizzle that wgmma reads: head dims in
// atoms of 64 (one 128-byte row a token, 16-byte chunk q of row r at chunk
// q ^ (r % 8), each atom 64 x 128 B = 8192 B, tiles 1024-byte aligned), the
// layout of csrc/hopper_gemm.cuh's operands. One tile serves both ways:
//   - K-major (rows = the product's M or N, head dims the reduction), as the
//     A or B of S = Q K^T: k-step kk at atom kk / 4, +32 B a step inside it,
//     SBO 1024 (8-row groups);
//   - MN-major (rows = the reduction, head dims = N), as the B of O += P V:
//     k-step kk (16 rows) at +2048 B, LBO 8192 (the next 64 head dims), SBO
//     1024, wgmma's transpose bit set.
// Head tiles of 16..64 take one atom, 80..128 two (hd 30/53/122/46/77 of the
// 256px model: 32/64/128/48/80 computed, 64/64/128/64/128 stored).
//
// Gather. A head's slice of a token row (h * hd, plus c or 2c for k and v)
// is not 16-byte aligned, so neither TMA nor a plain copy can place it: the
// 16-byte pieces of the row that hold the slice (from column s & ~7) are
// read whole, straight from global memory (load_swz) or staged first by
// cp.async (stage_raw, then unpack_swz), and each 16-byte chunk of the tile
// is cut from two neighbouring pieces by a shift of s % 8 elements (shift8:
// selects and byte permutes), dims >= hd zeroed, one 16-byte store.
//
// Products. wgmma m64n64k16 from shared memory (both operands K-major) for
// the 64 x 64 score tiles S = Q K^T, dP = dO V^T and their transposes; then
// the register-A form m64nHDPk16 for O += P V, dQ += dS K, dV += P^T dO and
// dK += dS^T Q: the f32 accumulator layout of a score tile is, rounded to
// bf16 and packed in pairs, the A layout of the next product (warp w of the
// warpgroup holds rows 16w + lane / 4 and + 8, columns 8j + 2 (lane % 4) +
// {0, 1} in accumulators 4j + {0, 1} and 4j + {2, 3}), as in FlashAttention-3.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "window_tiles.cuh"

namespace {

typedef __nv_bfloat16 a16_bf16;

constexpr int kSwzAtom = kTileRows * 128;   // 64 rows x 64 bf16, 8192 B

// head dims a tile stores for head tile ``hdp``: whole atoms of 64
__host__ __device__ constexpr int swz_cols(int hdp) {
  return (hdp + 63) / 64 * 64;
}
__host__ __device__ constexpr int swz_bytes(int hdp) {
  return kTileRows * swz_cols(hdp) * 2;
}

// byte offset of 16-byte chunk q (head dims [8q, 8q + 8)) of row r
__device__ __forceinline__ uint32_t swz_chunk(int r, int q) {
  return (uint32_t)((q >> 3) * kSwzAtom + r * 128 + (((q & 7) ^ (r & 7)) << 4));
}

// the 1024-byte aligned start of the dynamic shared memory (the plans ask
// for 1024 bytes more than the layout)
__device__ __forceinline__ uint32_t swz_base(const unsigned char* smem) {
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  return (raw + 1023u) & ~1023u;
}

// ---- descriptors and wgmma --------------------------------------------

__device__ __forceinline__ uint64_t swz_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// k-step kk (head dims [16kk, 16kk + 16)) of a K-major tile
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return swz_desc(tile + (uint32_t)((kk >> 2) * kSwzAtom + (kk & 3) * 32), 16);
}

// k-step kk (rows [16kk, 16kk + 16)) of an MN-major tile
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return swz_desc(tile + (uint32_t)(kk * 2048), kSwzAtom);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// all but the last committed group done
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries
template <int R>
__device__ __forceinline__ void wg_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// shared-memory writes of the generic proxy (st.shared) made visible to
// wgmma's async proxy; the writers fence before the barrier that precedes
// the product
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// D[64 x N] += A[64 x 16] B[16 x N]: A from registers (the A layout above),
// B an MN-major tile (TB = 1, the transpose bit: the attention kernels' V
// tiles) or a K-major one (TB = 0: rows are the N head dims, kernel (g)'s
// transposed V). One specialization of WgmmaRS a width N.
template <int N>
struct WgmmaRS;

template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  WgmmaRS<N>::template run<TB>(d, a, db);
}

template <>
struct WgmmaRS<16> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<32> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<48> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<64> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<80> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<96> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<112> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, %62;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<128> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

// D[64 x 64] += A[64 x 16] B[16 x 64], both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// S[64 x 64] += A B^T over HDP head dims, A and B K-major tiles (the caller
// fences, commits and waits)
template <int HDP>
__device__ __forceinline__ void wg_scores(float (&s)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wgmma_ss64(s, desc_k(a, kk), desc_k(b, kk));
}

// o[64 x HDP] += P[64 x 64] T: ``p`` the bf16 P in the A layout (p[j][0]
// the lane's row r, p[j][1] row r + 8, of columns 8j + 2 (lane % 4) + {0,
// 1}), ``t`` a tile of 64 rows read MN-major (the caller fences, commits and
// waits)
template <int HDP>
__device__ __forceinline__ void wg_pv(float (&o)[HDP / 2],
                                      const uint32_t (&p)[8][2], uint32_t t) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint32_t a[4] = {p[2 * kb][0], p[2 * kb][1], p[2 * kb + 1][0],
                           p[2 * kb + 1][1]};
    wgmma_rs<HDP>(o, a, desc_mn(t, kb));
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- the relative-position bias ---------------------------------------
// A 16x16 window's bias is a gather of its head's (2 * 16 - 1)^2 = 961-entry
// table: bias[i][j] = table[idx(i, j)], idx = (ri - rj + 15) * 31 + (ci - cj
// + 15) for tokens i = 16 ri + ci, j = 16 rj + cj (the reference's
// relative_position_index), that is rel_pos(i) - rel_pos(j) + 480 with
// rel_pos(i) = 31 ri + ci. The kernels keep their head's table in shared
// memory (kRelTableBytes) and look each score's term up there.
constexpr int kRelTable = 961;
constexpr int kRelCentre = 480;
constexpr int kRelTableBytes = (kRelTable * 4 + 15) / 16 * 16;

__device__ __forceinline__ int rel_pos(int i) { return 31 * (i >> 4) + (i & 15); }

// the head's table into shared memory (the caller's barrier publishes it)
__device__ __forceinline__ void load_rel_table(float* tab,
                                               const float* __restrict__ t,
                                               int tid, int nthr) {
  for (int i = tid; i < kRelTable; i += nthr) tab[i] = __ldg(t + i);
}

// The shift mask comes as each window's region labels [256] int32: 0
// between tokens of one region, kMaskOff between regions (the reference's
// shift_attn_mask, built from the same labels); a window's labels sit in
// shared memory (kLabelBytes) beside its head's table.
constexpr float kMaskOff = -100.f;
constexpr int kLabelBytes = 256 * 4;

__device__ __forceinline__ float mask_term(int a, int b) {
  return a != b ? kMaskOff : 0.f;
}

// ---- gather and scatter -----------------------------------------------

// The 8 bf16 of words r[0..4] from their first element (odd: from the
// second), those of dims >= lim (the chunk's dims past the head) zero
__device__ __forceinline__ uint4 shift_words(const uint32_t (&r)[5], int odd,
                                             int lim) {
  const uint32_t sel = odd ? 0x5432u : 0x3210u;
  uint32_t out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t v = __byte_perm(r[k], r[k + 1], sel);
    if (2 * k >= lim)
      v = 0u;
    else if (2 * k + 1 >= lim)
      v &= 0xFFFFu;
    out[k] = v;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// 8 bf16 from element o (0..7) of the 16 in lo:hi, those of dims >= lim
// (the chunk's dims past the head) zero
__device__ __forceinline__ uint4 shift8(uint4 lo, uint4 hi, int o, int lim) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int ws = o >> 1;
  uint32_t r[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    uint32_t v = w[k];
    v = ws == 1 ? w[k + 1] : v;
    v = ws == 2 ? w[k + 2] : v;
    v = ws == 3 ? w[k + 3] : v;
    r[k] = v;
  }
  return shift_words(r, o & 1, lim);
}

// floor(i / n) for the piece index i < 64 * 17 of a tile and the pieces a
// row n <= 17: (i * m) >> 16 with m = 2^16 / n + 1 a call (exact there: the
// error i (m - 2^16 / n) / 2^16 stays below 1 / n)
__device__ __forceinline__ int div_magic(int n) { return 65536 / n + 1; }
__device__ __forceinline__ int div_by(int i, int m) { return (i * m) >> 16; }

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 lds16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// the 16-byte piece at column c0 of a row ``width`` wide (8 bytes at the
// end of a row whose width is 4 past a multiple of 8)
__device__ __forceinline__ uint4 ld_piece(const a16_bf16* row, int c0,
                                          int width) {
  if (c0 + 8 <= width)
    return __ldg(reinterpret_cast<const uint4*>(row + c0));
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + c0));
  return make_uint4(u.x, u.y, 0u, 0u);
}

// Tokens [t0, t0 + 64) of a window, columns [s, s + hd) of ``src`` (row
// stride ``ld``, rows ``width`` wide), into a swizzled tile (dims [hd, HDP)
// zero) by threads ``tid`` of ``nthr``, four chunks (eight loads) in flight
// a thread
template <int HDP, int WIN>
__device__ __forceinline__ void load_swz(uint32_t tile,
                                         const a16_bf16* __restrict__ src,
                                         long long ld, int width, int s,
                                         int hd, const WinRows<WIN>& rows,
                                         int t0, int tid, int nthr) {
  constexpr int CQ = HDP / 8, kB = 4, kTotal = kTileRows * CQ;
  const int lo = s & ~7, o = s - lo, n = (o + hd + 7) >> 3;
  for (int base = tid; base < kTotal; base += nthr * kB) {
    uint4 a[kB], b[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = base + j * nthr;
      a[j] = b[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kTotal) {
        const int t = i / CQ, q = i - t * CQ;
        if (8 * q < hd) {
          const a16_bf16* row = src + rows(t0 + t) * ld;
          a[j] = ld_piece(row, lo + 8 * q, width);
          if (q + 1 < n) b[j] = ld_piece(row, lo + 8 * q + 8, width);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = base + j * nthr;
      if (i < kTotal) {
        const int t = i / CQ, q = i - t * CQ;
        sts16(tile + swz_chunk(t, q), shift8(a[j], b[j], o, hd - 8 * q));
      }
    }
  }
}

// cp.async the raw 16-byte pieces of tokens [t0, t0 + 64), columns [s, s +
// hd), into ``stage`` (a shared-memory address: row t's n pieces in slots
// t * n ..., n = (s % 8 + hd + 7) / 8); the caller commits and waits. A
// 4-column piece at the end of a row copies 8 bytes.
template <int WIN>
__device__ __forceinline__ void stage_raw(uint32_t stage,
                                          const a16_bf16* __restrict__ src,
                                          long long ld, int width, int s,
                                          int hd, const WinRows<WIN>& rows,
                                          int t0, int tid, int nthr) {
  const int lo = s & ~7, n = (s - lo + hd + 7) >> 3;
  const int m = div_magic(n);
  for (int i = tid; i < kTileRows * n; i += nthr) {
    const int t = div_by(i, m), c0 = lo + 8 * (i - t * n);
    const a16_bf16* p = src + rows(t0 + t) * ld + c0;
    if (c0 + 8 <= width)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   ::"r"(stage + 16u * i), "l"(p));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   ::"r"(stage + 16u * i), "l"(p));
  }
}

// The pieces stage_raw staged (element offset o = s % 8) into a swizzled
// tile, as load_swz places them: each chunk's words read where they lie in
// the row's pieces (4-byte loads from word o / 2 on; those past the row's
// last piece, which give only dims past the head, are not read), then one
// byte permute a word (a runtime selector for odd o). (A variant with the
// pieces' 16-byte reads and a uniform switch on o / 2 measured slower.)
template <int HDP>
__device__ __forceinline__ void unpack_swz(uint32_t tile, uint32_t stage,
                                           int o, int hd, int tid,
                                           int nthr) {
  constexpr int CQ = HDP / 8;
  const int n = (o + hd + 7) >> 3, w0 = o >> 1, odd = o & 1;
  for (int i = tid; i < kTileRows * CQ; i += nthr) {
    const int t = i / CQ, q = i - t * CQ;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (8 * q < hd) {
      const uint32_t a = stage + 16u * (t * n + q) + 4u * w0;
      const bool next = q + 1 < n;
      uint32_t r[5];
#pragma unroll
      for (int k = 0; k < 5; ++k)
        r[k] = (k < 4 || odd) && (w0 + k < 4 || next) ? lds32(a + 4u * k)
                                                      : 0u;
      v = shift_words(r, odd, hd - 8 * q);
    }
    sts16(tile + swz_chunk(t, q), v);
  }
}

// A warpgroup's f32 accumulator [64 x HDP] (rows scaled by ``lo`` and
// ``hi``: the lane's row r and r + 8) into rows [0, 64) of a bf16 plane of
// HDP + 8 elements a row; ``wtid`` the thread's index in its warpgroup
template <int HDP>
__device__ __forceinline__ void acc_to_plane(a16_bf16* plane,
                                             const float (&o)[HDP / 2],
                                             float lo, float hi, int wtid) {
  constexpr int LD = HDP + 8;
  const int lane = wtid & 31, g = lane >> 2, t = lane & 3;
  a16_bf16* r = plane + (16 * (wtid >> 5) + g) * LD + 2 * t;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    *reinterpret_cast<uint32_t*>(r + 8 * j) =
        pack2(o[4 * j] * lo, o[4 * j + 1] * lo);
    *reinterpret_cast<uint32_t*>(r + 8 * LD + 8 * j) =
        pack2(o[4 * j + 2] * hi, o[4 * j + 3] * hi);
  }
}

// The same into a swizzled tile (head dims as a 64-row tile holds them)
template <int HDP>
__device__ __forceinline__ void acc_to_swz(uint32_t tile,
                                           const float (&o)[HDP / 2],
                                           float lo, float hi, int wtid) {
  const int lane = wtid & 31, g = lane >> 2, t = lane & 3;
  const int r = 16 * (wtid >> 5) + g;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    asm volatile("st.shared.u32 [%0], %1;\n"
                 :: "r"(tile + swz_chunk(r, j) + 4 * t),
                 "r"(pack2(o[4 * j] * lo, o[4 * j + 1] * lo)) : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n"
                 :: "r"(tile + swz_chunk(r + 8, j) + 4 * t),
                 "r"(pack2(o[4 * j + 2] * hi, o[4 * j + 3] * hi)) : "memory");
  }
}

// Rows [0, 64) of a swizzled tile (head dims [0, hd)) to columns [s, s +
// hd) of tokens [t0, t0 + 64) of ``dst``, as store_plane stores a plane
template <int WIN>
__device__ __forceinline__ void store_swz(uint32_t tile,
                                          a16_bf16* __restrict__ dst,
                                          long long ld, int width, int s,
                                          int hd, const WinRows<WIN>& rows,
                                          int t0, int tid, int nthr) {
  const int lo = s & ~7, n = (s - lo + hd + 7) >> 3, dm = div_magic(n);
  for (int i = tid; i < kTileRows * n; i += nthr) {
    const int t = div_by(i, dm), c0 = lo + 8 * (i - t * n);
    const int m = min(8, width - c0);
    a16_bf16* d = dst + rows(t0 + t) * ld + c0;
    if (c0 >= s && c0 + m <= s + hd) {
      // head dims [j0, j0 + 8): element j0 % 8 on of chunks j0 / 8 and next
      const int j0 = c0 - s, q = j0 >> 3, o = j0 & 7;
      const uint4 a = lds16(tile + swz_chunk(t, q));
      const uint4 b = o ? lds16(tile + swz_chunk(t, q + 1))
                        : make_uint4(0u, 0u, 0u, 0u);
      const uint4 v = shift8(a, b, o, 8);
      if (m == 8)
        *reinterpret_cast<uint4*>(d) = v;
      else
        *reinterpret_cast<uint2*>(d) = make_uint2(v.x, v.y);
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int e = c0 - s + x;           // head dim
        if (x < m && e >= 0 && e < hd) {
          unsigned short u;
          asm volatile("ld.shared.u16 %0, [%1];\n"
                       : "=h"(u)
                       : "r"(tile + swz_chunk(t, e >> 3) + 2 * (e & 7)));
          d[x] = *reinterpret_cast<const a16_bf16*>(&u);
        }
      }
    }
  }
}

// Rows [0, 64) of a plane (HDP + 8 elements a row, head dims [0, hd)) to
// columns [s, s + hd) of tokens [t0, t0 + 64) of ``dst``: a 16-byte store
// per piece that lies inside the head, element stores where a piece is
// shared with a neighbouring head or part
template <int HDP, int WIN>
__device__ __forceinline__ void store_plane(const a16_bf16* plane,
                                            a16_bf16* __restrict__ dst,
                                            long long ld, int width, int s,
                                            int hd, const WinRows<WIN>& rows,
                                            int t0, int tid, int nthr) {
  constexpr int LD = HDP + 8;
  const int lo = s & ~7, n = (s - lo + hd + 7) >> 3, dm = div_magic(n);
  for (int i = tid; i < kTileRows * n; i += nthr) {
    const int t = div_by(i, dm), c0 = lo + 8 * (i - t * n);
    const int m = min(8, width - c0);
    const a16_bf16* row = plane + t * LD;
    a16_bf16* d = dst + rows(t0 + t) * ld + c0;
    if (c0 >= s && c0 + m <= s + hd) {
      const int j0 = c0 - s;
      const uint4* r16 = reinterpret_cast<const uint4*>(row) + (j0 >> 3);
      const uint4 v = shift8(r16[0], r16[1], j0 & 7, 8);
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

}  // namespace
