// rdg_gemm_f32: out = epilogue(A[M,K] @ W[N,K]^T + bias[N]) in f32, every
// product f32-accurate as 3xTF32 on the tensor cores (wgmma), f32 out.
//
// Replaces: the five matmuls of each Swin block inside the Pallas kernel
// _rdg_kernel_impl (adsr_tpu/ops/fused_rdg.py:731, 858, 861, 887-892) at
// dtype f32, where the TPU kernel takes f32 operands with an f32 result
// (fused_rdg.py:728, 769-778): qkv, proj, fc1, fc2 and the 1x1 adjust conv.
// It keeps every epilogue of the bf16 kernel (rdg_gemm.cu), the training
// ones included, so one kernel serves any f32 caller.
// Bound on H100: operations. One flagship RDG's 25 products at M = 16384
// token rows are 72.3 GFLOP: 1.08 ms at the 67 TFLOP/s of f32 FFMA, 0.44
// ms as three TF32 products each at 495 TFLOP/s, against ~1.2 GB of f32
// bytes (0.35 ms at 3.35 TB/s).
// Design: each operand is split as x = hi + lo, hi = tf32(x) and lo =
// tf32(x - hi) (both rounded to nearest, ties away from zero: cvt.rna's
// rounding), and the f32 accumulators sum a_lo w_hi + a_hi w_lo + a_hi
// w_hi, k by k, on m64nBNk8 TF32 wgmma (CUTLASS's "fast f32"; a_lo w_lo,
// ~2^-22 of a product, is dropped). Persistent blocks of 512 threads walk
// 128 x BN output tiles (BN 128, 64 or 32: the fewest rounds of the grid
// times the tile's width, kernels/rdg_gemm.py ``f32_tile_width``):
// warpgroups 0 and 1 consume 64 rows each, warp 8 issues TMA, warps 9-15
// split. K goes in steps of 32 floats (one 128-byte swizzled row, four k8
// steps) through a ring of stages [A hi | W hi | A lo | W lo]: TMA lands A
// and W (both K-major, zero-filled past M, N and K) in the hi half and
// fires the stage's "loaded" barrier; the splitters rewrite each float in
// place as its hi and put its lo at the same offset of the lo half (the
// split is elementwise, so the swizzle carries over), fence the async proxy
// and fire "full"; the consumers run the twelve wgmma of the stage and
// release it on "empty" once the next stage's group is issued. No wgmma
// sits under a condition (past-the-edge rows and columns are zeros), so
// none is serialized. The epilogue runs from the accumulators: lanes trade
// pairs so each holds 4 columns of a row (hopper_gemm.cuh ``row_vector``),
// 16-byte loads and stores where out, residual and aux allow them, else
// one float a column at any row stride; each element's residual is read
// before it is written by the same thread, so out may alias residual
// (adjust 5 in place). Each output is one f32 sum in a fixed order: bitwise repeatable,
// graph-capturable.

#include "hopper_gemm.cuh"

// ablation switches of scripts/torch_gemm_f32_sweep.py (timing only: a
// variant without them computes something else)
#ifndef RDG_F32_SPLIT
#define RDG_F32_SPLIT 1           // 0: the split warps only pass stages on
#endif
#ifndef RDG_F32_X3
#define RDG_F32_X3 1              // 0: one TF32 product a k8 step
#endif

namespace {

constexpr int kF32BK = 32;                // floats of K a stage: one 128-byte
constexpr int kRowBytes = kF32BK * 4;     // swizzled row, four k8 steps
constexpr int kProducerWarp = 8;          // lane 0 issues TMA
constexpr int kSplitWarp0 = 9;            // the split warps follow it
constexpr int kSplitThreads = 32 * 7;     // 512 threads a block: 128
                                          // registers a consumer thread
constexpr int kF32Threads = 32 * kSplitWarp0 + kSplitThreads;
constexpr int kF32ABytes = kBM * kRowBytes;

enum Epilogue { kNone = 0, kResidual = 1, kGelu = 2, kLeakyRelu = 3,
                kScaledResidual = 4, kDropResidual = 5, kGeluAux = 6 };

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <int BN>
struct F32Ring {
  static_assert(BN == 32 || BN == 64 || BN == 128, "tile width");
  static constexpr int kHiBytes = (kBM + BN) * kRowBytes;
  static constexpr int kStageBytes = 2 * kHiBytes;
  // as many stages as fit in 200 KB, at most 6
  static constexpr int kStages = (200 * 1024) / kStageBytes < 6
                                     ? (200 * 1024) / kStageBytes : 6;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes
                                    + 3 * kStages * 8;
};

// m64nNk8 TF32 wgmma, both operands K-major from shared memory (128-byte
// swizzle): D[64 x N] += A[64 x 8] B[8 x N]
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 32)
    wgmma_tf32_n32(d, da, db);
  else if constexpr (BN == 64)
    wgmma_tf32_n64(d, da, db);
  else
    wgmma_tf32_n128(d, da, db);
}

// tf32(x): the nearest TF32 value, ties away from zero (the rounding of
// cvt.rna.tf32.f32), in two integer operations: the conversion runs at a
// lower rate
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x -> (hi, lo): hi = tf32(x) in place of x, lo = tf32(x - hi)
__device__ __forceinline__ void split4(float4& x, float4& lo) {
  const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                               tf32_rna(x.w));
  lo = make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y),
                   tf32_rna(x.z - h.z), tf32_rna(x.w - h.w));
  x = h;
}

struct F32Problem {
  int M, N, K;
  int m_tiles, n_tiles, k_steps;
};

struct alignas(64) F32Maps {
  CUtensorMap a, w;
};

template <int EPI>
struct F32Epi {
  const float* bias;
  float* out;
  long long ldo;
  const float* res;
  long long ldr;
  const float* row_scale;
  long long scale_stride;
  int rows_per_scale;
  float* aux;
  long long ldaux;
  int vec;              // out, res and aux take 16-byte pieces, N % 4 == 0

  static constexpr bool kReadsResidual =
      EPI == kResidual || EPI == kScaledResidual || EPI == kDropResidual;

  __device__ __forceinline__ float apply(float v, float r, float s) const {
    if constexpr (EPI == kResidual) return v + r;
    if constexpr (EPI == kScaledResidual) return 0.2f * v + r;
    if constexpr (EPI == kDropResidual) return r + s * v;
    if constexpr (EPI == kGelu || EPI == kGeluAux) return gelu(v);
    if constexpr (EPI == kLeakyRelu) return v >= 0.f ? v : 0.2f * v;
    return v;
  }

  // row m's columns n .. n + 3 from the accumulators' 4 values (the bias
  // not yet added); those at or past N are left alone
  __device__ __forceinline__ void row(float4 acc4, long long m, int n,
                                      int N) const {
    float s = 1.f;
    if constexpr (EPI == kDropResidual)
      s = __ldg(row_scale + (m / rows_per_scale) * scale_stride);
    float v[4] = {acc4.x, acc4.y, acc4.z, acc4.w};
    if (vec) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + n));
      v[0] += b.x; v[1] += b.y; v[2] += b.z; v[3] += b.w;
      float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kReadsResidual)
        r = *reinterpret_cast<const float4*>(res + m * ldr + n);
      if constexpr (EPI == kGeluAux)
        *reinterpret_cast<float4*>(aux + m * ldaux + n) =
            make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(out + m * ldo + n) = make_float4(
          apply(v[0], r.x, s), apply(v[1], r.y, s), apply(v[2], r.z, s),
          apply(v[3], r.w, s));
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (n + i >= N) break;
      const float x = v[i] + __ldg(bias + n + i);
      float r = 0.f;
      if constexpr (kReadsResidual) r = res[m * ldr + n + i];
      if constexpr (EPI == kGeluAux) aux[m * ldaux + n + i] = x;
      out[m * ldo + n + i] = apply(x, r, s);
    }
  }
};

template <int BN, int EPI>
__global__ void __launch_bounds__(kF32Threads, 1)
rdg_gemm_f32_kernel(const F32Problem p, const F32Epi<EPI> epi,
                    const __grid_constant__ F32Maps maps) {
  using RingT = F32Ring<BN>;
  constexpr int kStages = RingT::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base
      - (uint32_t)__cvta_generic_to_shared(smem_raw));
  const uint32_t bars = base + kStages * RingT::kStageBytes;
  auto loaded = [&](int s) { return bars + 8 * s; };
  auto full = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(loaded(s), 1);
      mbar_init(full(s), kSplitThreads);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int units = p.m_tiles * p.n_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == kProducerWarp) {
    // ---- TMA: A and W tiles into the hi half of each stage ----
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = (u / p.n_tiles) * kBM, n0 = (u % p.n_tiles) * BN;
        for (int ks = 0; ks < p.k_steps; ++ks) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t sa = base + stage * RingT::kStageBytes;
          mbar_arrive_expect_tx(loaded(stage), RingT::kHiBytes);
          tma_2d(sa, &maps.a, ks * kF32BK, m0, loaded(stage));
          tma_2d(sa + kF32ABytes, &maps.w, ks * kF32BK, n0, loaded(stage));
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else if (warp >= kSplitWarp0) {
    // ---- split: hi in place, lo at the same offset of the lo half ----
    constexpr int kPieces = RingT::kHiBytes / 16;
    constexpr int kUnroll = 4;
    const int tid = threadIdx.x - 32 * kSplitWarp0;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      for (int ks = 0; ks < p.k_steps; ++ks) {
        mbar_wait(loaded(stage), phase);
        float4* hi = reinterpret_cast<float4*>(
            base_ptr + stage * RingT::kStageBytes);
        float4* lo = hi + kPieces;
#pragma unroll 1
        for (int i0 = tid; RDG_F32_SPLIT && i0 < kPieces;
             i0 += kUnroll * kSplitThreads) {
          float4 x[kUnroll], l[kUnroll];
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            const int i = i0 + j * kSplitThreads;
            if (i < kPieces) x[j] = hi[i];
          }
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            const int i = i0 + j * kSplitThreads;
            if (i < kPieces) {
              split4(x[j], l[j]);
              hi[i] = x[j];
              lo[i] = l[j];
            }
          }
        }
        // the generic-proxy writes before wgmma's async-proxy reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full(stage));
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else if (warp < kConsumerWarps) {
    // ---- consumers: warpgroup wg takes rows 64 wg .. of the tile ----
    const int wg = warp / 4;
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = (u / p.n_tiles) * kBM, n0 = (u % p.n_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int ks = 0; ks < p.k_steps; ++ks) {
        mbar_wait(full(stage), phase);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t a_hi = base + stage * RingT::kStageBytes
                              + wg * (64 * kRowBytes);
        const uint32_t w_hi = base + stage * RingT::kStageBytes + kF32ABytes;
        const uint32_t a_lo = a_hi + RingT::kHiBytes;
        const uint32_t w_lo = w_hi + RingT::kHiBytes;
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kF32BK / 8; ++kk) {   // k8 steps of 32 bytes
          const uint64_t dah = smem_desc(a_hi + kk * 32, 16, 1024);
          const uint64_t dal = smem_desc(a_lo + kk * 32, 16, 1024);
          const uint64_t dwh = smem_desc(w_hi + kk * 32, 16, 1024);
          const uint64_t dwl = smem_desc(w_lo + kk * 32, 16, 1024);
#if RDG_F32_X3
          wgmma_tf32<BN>(acc, dal, dwh);
          wgmma_tf32<BN>(acc, dah, dwl);
#endif
          wgmma_tf32<BN>(acc, dah, dwh);
        }
        wgmma_commit();
        wgmma_wait<1>();                       // the previous stage's group
        fence_operand(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_operand(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
      // the epilogue: rows m0 + 64 wg + 16 w + l / 4 (+ 8), 4 columns a
      // lane after the quad's trades (hopper_gemm.cuh ``row_vector``)
      const int n_lane = n0 + 4 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * h;
#pragma unroll
        for (int jp = 0; jp < BN / 16; ++jp) {
          const float4 v = row_vector<BN>(acc, h, jp);   // every lane
          const int n = n_lane + 16 * jp;
          if (m < p.M && n < p.N) epi.row(v, m, n, p.N);
        }
      }
    }
  }
}

// A f32 matrix of ``rows`` x ``cols`` (row stride ``ld`` floats) in boxes of
// box_rows x 32 floats (128 bytes, the swizzle's span); reads past the
// matrix land as zeros. A missing encoder or a refused map is an error.
inline int encode_f32_map(CUtensorMap* map, const float* ptr, long long ld,
                          long long cols, long long rows, int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kF32BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : (int)cudaErrorInvalidValue;
}

// The output tile width for M x N outputs: the fewest rounds of the
// persistent grid times a tile's width plus its fixed cost (32 columns),
// the wider tile on a tie (kernels/rdg_gemm.py ``f32_tile_width``)
inline int f32_tile_width(int M, int N) {
  const int widths[3] = {128, 64, 32};
  const long long m_tiles = (M + kBM - 1) / kBM;
  int best = 128;
  long long best_cost = -1;
  for (int w : widths) {
    const long long units = m_tiles * ((N + w - 1) / w);
    const long long cost = (units + sm_count() - 1) / sm_count() * (w + 32);
    if (best_cost < 0 || cost < best_cost) {
      best = w;
      best_cost = cost;
    }
  }
  return best;
}

template <int BN, int EPI>
int launch(F32Problem p, const F32Epi<EPI>& epi, const float* A,
           long long lda, const float* W, long long ldw, cudaStream_t s) {
  using RingT = F32Ring<BN>;
  static const int attr = (int)cudaFuncSetAttribute(
      rdg_gemm_f32_kernel<BN, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, RingT::kSmemBytes);
  if (attr) return attr;
  p.n_tiles = (p.N + BN - 1) / BN;
  F32Maps maps{};
  int rc = encode_f32_map(&maps.a, A, lda, p.K, p.M, kBM);
  if (!rc) rc = encode_f32_map(&maps.w, W, ldw, p.K, p.N, BN);
  if (rc) return rc;
  const int units = p.m_tiles * p.n_tiles;
  const int grid = units < sm_count() ? units : sm_count();
  rdg_gemm_f32_kernel<BN, EPI>
      <<<grid, kF32Threads, RingT::kSmemBytes, s>>>(p, epi, maps);
  return (int)cudaGetLastError();
}

template <int EPI>
int dispatch(const F32Problem& p, const F32Epi<EPI>& epi, const float* A,
             long long lda, const float* W, long long ldw, cudaStream_t s) {
  switch (f32_tile_width(p.M, p.N)) {
    case 32: return launch<32, EPI>(p, epi, A, lda, W, ldw, s);
    case 64: return launch<64, EPI>(p, epi, A, lda, W, ldw, s);
    default: return launch<128, EPI>(p, epi, A, lda, W, ldw, s);
  }
}

inline bool aligned16(const void* ptr, long long ld) {
  return ptr == nullptr
         || (reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ld % 4 == 0);
}

}  // namespace

// The arguments of adsr_rdg_gemm (rdg_gemm.cu) without the tile width, on
// float32 operands and outputs: A and W with 16-byte aligned bases and row
// strides that are multiples of 4 (TMA rows), K % 4 == 0; out, residual and
// aux at any row stride (kernels/rdg_gemm.py ``check_gemm_layout``).
extern "C" int adsr_rdg_gemm_f32(const void* A, long long lda, const void* W,
                                 long long ldw, const void* bias, void* out,
                                 long long ldo, const void* res,
                                 long long ldr, const void* row_scale,
                                 long long scale_stride, int rows_per_scale,
                                 void* aux, long long ldaux, int M, int N,
                                 int K, int epilogue, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || (K % 4) || (lda % 4) || (ldw % 4) ||
      ldw < K || (M > 1 && lda < K) ||
      ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(W))
       % 16) ||
      epilogue < kNone || epilogue > kGeluAux)
    return (int)cudaErrorInvalidValue;
  const bool needs_res = epilogue == kResidual ||
                         epilogue == kScaledResidual ||
                         epilogue == kDropResidual;
  if (needs_res && res == nullptr) return (int)cudaErrorInvalidValue;
  if (epilogue == kDropResidual &&
      (row_scale == nullptr || rows_per_scale <= 0))
    return (int)cudaErrorInvalidValue;
  if (epilogue == kGeluAux && aux == nullptr)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  if (lda < K) lda = K;                   // one row: its stride is unread
  const F32Problem p{M, N, K, (M + kBM - 1) / kBM, 0,
                     (K + kF32BK - 1) / kF32BK};
  const int vec = N % 4 == 0 && aligned16(out, ldo) && aligned16(bias, 0)
                  && (!needs_res || aligned16(res, ldr))
                  && (epilogue != kGeluAux || aligned16(aux, ldaux));
  const cudaStream_t s = (cudaStream_t)stream;
  const float* a = static_cast<const float*>(A);
  const float* w = static_cast<const float*>(W);
  switch (epilogue) {
#define ADSR_EPI(E)                                                         \
    case E: {                                                               \
      const F32Epi<E> epi{static_cast<const float*>(bias),                  \
                          static_cast<float*>(out), ldo,                    \
                          static_cast<const float*>(res), ldr,              \
                          static_cast<const float*>(row_scale),             \
                          scale_stride, rows_per_scale,                     \
                          static_cast<float*>(aux), ldaux, vec};            \
      return dispatch<E>(p, epi, a, lda, w, ldw, s);                        \
    }
    ADSR_EPI(kNone) ADSR_EPI(kResidual) ADSR_EPI(kGelu) ADSR_EPI(kLeakyRelu)
    ADSR_EPI(kScaledResidual) ADSR_EPI(kDropResidual) ADSR_EPI(kGeluAux)
#undef ADSR_EPI
    default: return (int)cudaErrorInvalidValue;
  }
}
