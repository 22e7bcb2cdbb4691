// One pipelined Hopper GEMM mainloop for the RDG's products: the forward
// (rdg_gemm.cu) and both halves of the backward (rdg_gemm_bwd.cu) are
// instances of gemm_body below, each with its own operand layouts and
// epilogue.
//
//   C[M, N] = sum_r A[m, r] B[r, n]     bf16 operands, f32 accumulators
//
// A is "K-major" (row m holds its r values contiguously, A[m * ld + r]) or
// "MN-major" (row r holds its m values, A[r * ld + m]); B likewise, K-major
// B[n * ld + r] (a torch Linear weight) or MN-major B[r * ld + n]:
//   forward  out = act @ W^T      A K-major (act),  B K-major (W [N, K])
//   dgrad    dA  = dY @ W         A K-major (dY),   B MN-major (W [N, K])
//   wgrad    dW  = dY^T @ act     A MN-major (dY),  B MN-major (act)
//
// Block: 384 threads, warpgroups 0-1 consume, warpgroup 2 produces (the
// consumers come first: wgmma needs warpgroup-aligned warps). One persistent
// block per SM walks the output tiles (kBM x BN, unit u = blockIdx.x,
// blockIdx.x + gridDim.x, ...), so the producer loads the next tile's stages
// while the consumers run the previous tile's epilogue, and no grid
// dimension limits M.
//
// Ring: kStages stages of [A 128 x 64 | B BN x 64] bf16 in dynamic shared
// memory (as many as fit in ~200 KB), each with a "full" mbarrier and an
// "empty" one. The producer warpgroup waits for a stage to be empty, then
// fills it: an operand whose rows are 16-byte aligned comes by TMA (one
// thread issues whole boxes and arms the full barrier with their bytes), any
// other by cp.async from all 128 producer threads (8-byte copies, 16 where
// aligned), each thread's cp.async.mbarrier.arrive firing when its copies
// land. The port keeps its GEMM operands in 16-byte rows (padded row pitches,
// kernels/rdg_gemm.py ``pitched``): per-SM throughput of the cp.async path
// stays far below TMA's. Both paths zero-fill past every edge (TMA's
// out-of-bounds fill; cp.async with src-size 0): rows past M or N and the
// reduction past its end land as zeros, so no product sees a ragged edge,
// and both write the 128-byte swizzle (16-byte chunk ^ (row % 8) in each
// 1024-byte group of eight 128-byte rows) that the wgmma descriptors read:
//   K-major  : row (m or n) at row * 128 B, r in 64-element (128 B) rows;
//              descriptor SBO 1024 (8-row groups), k16 step +32 B
//   MN-major : 64-wide atoms of [64 r rows][64 m or n] at atom * 8192 B;
//              descriptor LBO 8192 (atoms), SBO 1024 (8-row groups of r),
//              k16 step +2048 B, and wgmma's transpose bit set.
// The consumers fence the async proxy after each full-barrier wait (cp.async
// writes through the generic proxy, wgmma reads through the async one),
// issue up to four m64nBNk16 wgmma on the stage, keep one wgmma group in
// flight, and release each stage (one arrival per consumer warp on its
// empty barrier) once the group that read it has retired. The epilogue runs
// from the accumulator registers (init_tile, store_tile below).

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kBM = 128;              // output rows of a tile (2 x 64)
constexpr int kBK = 64;               // reduction step: one 128-byte row
constexpr int kConsumers = 2;         // consumer warpgroups
constexpr int kGemmThreads = 128 * (kConsumers + 1);
constexpr int kProducerThreads = 128;
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kAtomBytes = kBK * 128;  // one 64 x 64 bf16 swizzle atom run
// cp.async rows unrolled per pass: a full unroll keeps every row's address
// live and spills the MN-major kernels (ptxas -v)
constexpr int kProducerUnroll = 4;

struct Operand {
  const __nv_bfloat16* ptr;
  long long ld;   // row stride in elements
  int vec16;      // 16-byte aligned base and ld % 8 == 0: 16-byte copies
  int tma;        // loaded by TMA through its tensor map (see plan_tma)
};

inline Operand operand(const void* ptr, long long ld) {
  return Operand{static_cast<const __nv_bfloat16*>(ptr), ld,
                 (reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ld % 8 == 0)
                     ? 1 : 0, 0};
}

struct Problem {
  Operand a, b;
  int M, N;              // output rows and columns
  int R;                 // reduction extent
  int m_tiles, n_tiles;
  int splits, rows_per_split;   // reduction splits (wgrad); else 1 and R
  uint32_t tx_bytes;     // bytes a stage receives by TMA
};

// The operands' TMA tensor maps, passed by value as a __grid_constant__
// kernel parameter (a map must live in parameter, constant or global memory).
struct alignas(64) TmaPair {
  CUtensorMap a, b;
};

template <int BN>
struct Ring {
  static_assert(BN == 32 || BN == 64 || BN == 128 || BN == 192,
                "tile width");
  // as many stages as fit in ~200 KB, at most 8
  static constexpr int kStages =
      (200 * 1024) / (kBM * kBK * 2 + BN * kBK * 2) < 8
          ? (200 * 1024) / (kBM * kBK * 2 + BN * kBK * 2) : 8;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes
                                    + 2 * kStages * 8;
};

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// arrives on ``bar`` and expects ``bytes`` more from TMA before its phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one TMA box at coordinates (c0 inner, c1 outer) into shared memory
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// arrives on ``bar`` once every cp.async this thread issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

// D[64 x N] += A[64 x 16] B[16 x N]; TA / TB: operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 32)
    wgmma_n32<TA, TB>(d, da, db);
  else if constexpr (BN == 64)
    wgmma_n64<TA, TB>(d, da, db);
  else if constexpr (BN == 128)
    wgmma_n128<TA, TB>(d, da, db);
  else
    wgmma_n192<TA, TB>(d, da, db);
}

// ---- producer: one stage's tile of one operand --------------------------

// K-major: ROWS rows (row0.. of ``rows``), reduction [r0, r0 + 64) of r_end
template <int ROWS, int VEC>
__device__ __forceinline__ void load_kmajor(uint32_t dst, const Operand& op,
                                            int row0, int rows, int r0,
                                            int r_end, int tid) {
  constexpr int kPerRow = kBK / VEC;
  constexpr int kRowStep = kProducerThreads / kPerRow;
  static_assert(ROWS % kRowStep == 0, "rows per producer pass");
  const int piece = tid % kPerRow;              // the same for every row
  const int r = r0 + piece * VEC;
  const int bytes = min(max((r_end - r) * 2, 0), VEC * 2);
  const uint32_t col = ((piece * VEC) / 8) << 4 | ((piece * VEC) % 8) << 1;
#pragma unroll kProducerUnroll
  for (int i = 0; i < ROWS / kRowStep; ++i) {
    const int row = tid / kPerRow + i * kRowStep;
    const int grow = row0 + row;
    const int n = grow < rows ? bytes : 0;
    const __nv_bfloat16* src = n ? op.ptr + (long long)grow * op.ld + r
                                 : op.ptr;
    cp_async<VEC * 2>(dst + row * 128 + (col ^ ((row & 7) << 4)), src, n);
  }
}

// MN-major: reduction rows [r0, r0 + 64) of r_end, COLS columns (mn0.. of
// ``cols``) in 64-wide atoms
template <int COLS, int VEC>
__device__ __forceinline__ void load_mnmajor(uint32_t dst, const Operand& op,
                                             int mn0, int cols, int r0,
                                             int r_end, int tid) {
  constexpr int kPerRow = COLS / VEC;
  constexpr int kTotal = kBK * kPerRow;
  static_assert(kTotal % kProducerThreads == 0, "pieces per producer pass");
#pragma unroll kProducerUnroll
  for (int i = 0; i < kTotal / kProducerThreads; ++i) {
    const int p = tid + i * kProducerThreads;
    const int row = p / kPerRow, c = (p % kPerRow) * VEC;
    const int gr = r0 + row, gc = mn0 + c;
    const int n = gr < r_end ? min(max((cols - gc) * 2, 0), VEC * 2) : 0;
    const __nv_bfloat16* src = n ? op.ptr + (long long)gr * op.ld + gc
                                 : op.ptr;
    const uint32_t chunk = ((c % 64) / 8) ^ (row & 7);
    cp_async<VEC * 2>(dst + (c / 64) * kAtomBytes + row * 128 + (chunk << 4)
                          + ((c % 8) << 1), src, n);
  }
}

// The same stage tile by TMA: K-major as one box of 64 x ROWS, MN-major as
// ROWS / 64 boxes of 64 x 64 (one per atom); the 128-byte swizzle of the map
// gives the layout the cp.async path writes.
template <int ROWS, bool MN>
__device__ __forceinline__ void tma_operand(uint32_t dst,
                                            const CUtensorMap* map, int mn0,
                                            int r0, uint32_t bar) {
  if constexpr (MN) {
#pragma unroll
    for (int j = 0; j < ROWS / 64; ++j)
      tma_2d(dst + j * kAtomBytes, map, mn0 + 64 * j, r0, bar);
  } else {
    tma_2d(dst, map, r0, mn0, bar);
  }
}

template <int ROWS, bool MN>
__device__ __forceinline__ void load_operand(uint32_t dst, const Operand& op,
                                             int mn0, int mn_extent, int r0,
                                             int r_end, int tid) {
  if constexpr (MN) {
    if (op.vec16) load_mnmajor<ROWS, 8>(dst, op, mn0, mn_extent, r0, r_end, tid);
    else load_mnmajor<ROWS, 4>(dst, op, mn0, mn_extent, r0, r_end, tid);
  } else {
    if (op.vec16) load_kmajor<ROWS, 8>(dst, op, mn0, mn_extent, r0, r_end, tid);
    else load_kmajor<ROWS, 4>(dst, op, mn0, mn_extent, r0, r_end, tid);
  }
}

// ---- the kernel body ----------------------------------------------------

struct Unit {
  int m0, n0, split, r_begin, r_end;
};

template <int BN>
__device__ __forceinline__ Unit unit_of(const Problem& p, long long u) {
  const long long per_split = (long long)p.m_tiles * p.n_tiles;
  const int rem = (int)(u % per_split);
  Unit t;
  t.split = (int)(u / per_split);
  t.m0 = (rem / p.n_tiles) * kBM;      // consecutive units share A rows
  t.n0 = (rem % p.n_tiles) * BN;
  t.r_begin = t.split * p.rows_per_split;
  t.r_end = min(p.R, t.r_begin + p.rows_per_split);
  return t;
}

// Each consumer thread's accumulators in the m64nBN layout: rows m and m + 8
// (h = 0, 1), column pairs (n, n + 1) at n = n_base + 8 j + 2 (lane % 4),
// values acc[4 j + 2 h] and acc[4 j + 2 h + 1]. A warp storing those pairs
// writes 16 bytes in each of 8 rows; the epilogue first trades pairs within
// each quad of lanes (row_vector) so that a lane holds 4 consecutive columns
// of one row and a warp writes 32-byte runs: whole sectors, with half the
// store instructions.
//
// ``epi.init<BN>(acc, n0, N)`` sets the accumulators before the mainloop
// (zeros, or the bias: its loads land while the first stage arrives);
// ``epi.row<BN>(acc, h, m, split, n0, N, valid)`` writes row m's vectors
// v = row_vector(acc, h, jp) at columns n0 + 16 jp .. + 3 (n0 = n_base +
// 4 (lane % 4)) that lie inside [0, N), loading whatever it reads for the
// row before its first store. Every lane calls both (the trades are warp
// shuffles); ``valid`` is false for rows past M.
template <int BN>
__device__ __forceinline__ float4 row_vector(const float (&acc)[BN / 2],
                                             int h, int jp) {
  const int q = threadIdx.x & 3;
  const int s0 = (threadIdx.x & 28) + 2 * (q & 1);   // the pairs' owners
  const float a0 = acc[8 * jp + 2 * h], a1 = acc[8 * jp + 2 * h + 1];
  const float b0 = acc[8 * jp + 4 + 2 * h], b1 = acc[8 * jp + 4 + 2 * h + 1];
  const float x0 = __shfl_sync(~0u, a0, s0), x1 = __shfl_sync(~0u, a1, s0);
  const float y0 = __shfl_sync(~0u, b0, s0), y1 = __shfl_sync(~0u, b1, s0);
  const float z0 = __shfl_sync(~0u, a0, s0 + 1);
  const float z1 = __shfl_sync(~0u, a1, s0 + 1);
  const float w0 = __shfl_sync(~0u, b0, s0 + 1);
  const float w1 = __shfl_sync(~0u, b1, s0 + 1);
  return q >= 2 ? make_float4(y0, y1, w0, w1) : make_float4(x0, x1, z0, z1);
}

template <int BN, class Epi>
__device__ __forceinline__ void init_tile(float (&acc)[BN / 2], int n_base,
                                          int N, const Epi& epi) {
  epi.template init<BN>(acc, n_base + 2 * (threadIdx.x % 4), N);
}

template <int BN, class Epi>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           int m_base, int n_base, int split,
                                           int M, int N, const Epi& epi) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  const int n0 = n_base + 4 * (l % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m_base + 16 * w + l / 4 + 8 * h;
    epi.template row<BN>(acc, h, m, split, n0, N, m < M);
  }
}

// four bf16 (8 bytes) from four floats, and back
__device__ __forceinline__ uint2 pack4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ float4 unpack4(uint2 u) {
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The accumulators start at zero (every epilogue but the forward's, which
// starts them at the bias).
struct ZeroInit {
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], int,
                                       int) const {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  }
};

template <int BN, bool A_MN, bool B_MN, class Epi>
__device__ __forceinline__ void gemm_body(const Problem& p, const Epi& epi,
                                          const TmaPair& tm) {
  using RingT = Ring<BN>;
  constexpr int kStages = RingT::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * RingT::kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), kProducerThreads + 1);   // + the TMA issuer
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long units = (long long)p.m_tiles * p.n_tiles * p.splits;
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ---- producer warpgroup: keep the ring full ----
    const int tid = threadIdx.x - 128 * kConsumers;
    int stage = 0;
    uint32_t phase = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_of<BN>(p, u);
      for (int r0 = t.r_begin; r0 < t.r_end; r0 += kBK) {
        mbar_wait(empty(stage), phase ^ 1);
        const uint32_t sa = base + stage * RingT::kStageBytes;
        const uint32_t sb = sa + RingT::kABytes;
        if (tid == 0) {              // TMA operands: one thread, whole boxes
          mbar_arrive_expect_tx(full(stage), p.tx_bytes);
          if (p.a.tma) tma_operand<kBM, A_MN>(sa, &tm.a, t.m0, r0, full(stage));
          if (p.b.tma) tma_operand<BN, B_MN>(sb, &tm.b, t.n0, r0, full(stage));
        }
        if (!p.a.tma)
          load_operand<kBM, A_MN>(sa, p.a, t.m0, p.M, r0, t.r_end, tid);
        if (!p.b.tma)
          load_operand<BN, B_MN>(sb, p.b, t.n0, p.N, r0, t.r_end, tid);
        cp_async_arrive(full(stage));     // at once if it copied nothing
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- consumer warpgroups: 64 output rows each ----
    const int lane = threadIdx.x % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_of<BN>(p, u);
      const int m_wg = t.m0 + 64 * wg;
      const bool active = m_wg < p.M;     // uniform over the warpgroup
      init_tile<BN>(acc, t.n0, p.N, epi);
      int prev = -1;
      for (int r0 = t.r_begin; r0 < t.r_end; r0 += kBK) {
        mbar_wait(full(stage), phase);
        if (active) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          const uint32_t sa = base + stage * RingT::kStageBytes
                              + wg * kAtomBytes;
          const uint32_t sb = base + stage * RingT::kStageBytes
                              + RingT::kABytes;
          const int nk = min(4, (t.r_end - r0 + 15) / 16);
          fence_operand(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (kk < nk) {
              const uint64_t da = A_MN
                  ? smem_desc(sa + kk * 2048, kAtomBytes, 1024)
                  : smem_desc(sa + kk * 32, 16, 1024);
              const uint64_t db = B_MN
                  ? smem_desc(sb + kk * 2048, kAtomBytes, 1024)
                  : smem_desc(sb + kk * 32, 16, 1024);
              wgmma<BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();                   // the previous stage's group
          fence_operand(acc);
        }
        if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_operand(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
      if (active)
        store_tile<BN>(acc, m_wg, t.n0, t.split, p.M, p.N, epi);
    }
  }
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's entry
// point query (the library links no -lcuda)
typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<TensorMapEncodeTiled>(f);
  }();
  return fn;
}

// A bf16 matrix of ``rows`` x ``cols`` (cols contiguous, row stride ``ld``)
// in boxes of box_rows x 64 columns (128 bytes, the swizzle's span); reads
// past the matrix land as zeros. An operand without 16-byte rows needs no
// map (it goes by cp.async); for one with them, a missing encoder or a map
// cuTensorMapEncodeTiled refuses is an error, never a silent cp.async path.
inline int encode_map(CUtensorMap* map, const Operand& op, long long cols,
                      long long rows, int box_rows) {
  if (!op.vec16) return 0;
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)op.ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<__nv_bfloat16*>(op.ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : (int)cudaErrorInvalidValue;
}

// Every operand whose rows are 16-byte aligned goes by TMA, the others by
// cp.async. A is kBM x R (K-major) or R x M (MN-major), B BN x R or R x N.
template <int BN, bool A_MN, bool B_MN>
inline int plan_tma(Problem& p, TmaPair& tm) {
  int rc = A_MN ? encode_map(&tm.a, p.a, p.M, p.R, kBK)
                : encode_map(&tm.a, p.a, p.R, p.M, kBM);
  if (!rc)
    rc = B_MN ? encode_map(&tm.b, p.b, p.N, p.R, kBK)
              : encode_map(&tm.b, p.b, p.R, p.N, BN);
  p.a.tma = p.a.vec16;
  p.b.tma = p.b.vec16;
  p.tx_bytes = (p.a.tma ? Ring<BN>::kABytes : 0)
               + (p.b.tma ? Ring<BN>::kBBytes : 0);
  return rc;
}

// One persistent launch of ``Kernel`` (a __global__ wrapper of gemm_body):
// min(units, SMs) blocks; the shared-memory attribute is set once a kernel.
// ``paths`` counts the operands of the launches made, [TMA, cp.async]: each
// source file exports its own pair, which the wrappers read through ctypes.
template <auto Kernel, int BN, bool A_MN, bool B_MN, class Epi>
inline int launch_gemm(Problem p, const Epi& epi, cudaStream_t stream,
                       long long (&paths)[2]) {
  static const int attr = (int)cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<BN>::kSmemBytes);
  if (attr) return attr;
  const long long units = (long long)p.m_tiles * p.n_tiles * p.splits;
  if (units == 0) return 0;
  const int grid = (int)std::min<long long>(units, sm_count());
  TmaPair tm{};
  const int rc = plan_tma<BN, A_MN, B_MN>(p, tm);
  if (rc) return rc;
  Kernel<<<grid, kGemmThreads, Ring<BN>::kSmemBytes, stream>>>(p, epi, tm);
  const int launched = (int)cudaGetLastError();
  if (!launched) {
    paths[0] += p.a.tma + p.b.tma;
    paths[1] += 2 - p.a.tma - p.b.tma;
  }
  return launched;
}

}  // namespace
