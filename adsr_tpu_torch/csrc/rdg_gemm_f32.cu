// rdg_gemm_f32: out = epilogue(A[M,K] @ W[N,K]^T + bias[N]) in full f32:
// f32 operands, FFMA on the CUDA cores, f32 out (no TF32, no bf16 split).
//
// Replaces: the five matmuls of each Swin block inside the Pallas kernel
// _rdg_kernel_impl (adsr_tpu/ops/fused_rdg.py:731, 858, 861, 887-892) at
// dtype f32, where the TPU kernel takes f32 operands with an f32 result
// (fused_rdg.py:728, 769-778): qkv, proj, fc1, fc2 and the 1x1 adjust conv.
// It keeps every epilogue of the bf16 kernel (rdg_gemm.cu), the training
// ones included, so one kernel serves any f32 caller.
// Bound on H100: operations. One flagship RDG's 25 products at M = 16384
// token rows are 72.3 GFLOP, 1.08 ms at the 67 TFLOP/s of f32 FFMA, against
// ~1.2 GB of f32 bytes (0.35 ms at 3.35 TB/s).
// Design: a plain tiled SIMT GEMM. A block of 128 threads owns a 128 x 64
// output tile, each thread 8 x 8 outputs in registers (rows tm + 16 i,
// columns tn + 8 j: a quarter-warp reads eight consecutive W rows, whose
// 80-byte pitch puts them in eight different bank groups, so the float4
// loads of the inner loop are free of conflicts). K goes in steps of 16
// through a 3-stage ring in static shared memory, A and W tiles staged by
// 16-byte cp.async (rows past M or N and columns past K are zero-filled:
// K % 4 == 0, so a 16-byte piece is wholly in or out), one barrier a step.
// The epilogue runs from the registers, a scalar a thread per output: any
// output row stride, and each row's residual is read before it is written,
// so out may alias residual (adjust 5 in place). Each output is one f32
// sum over k in increasing order: bitwise repeatable, graph-capturable.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBM = 128, kBN = 64, kBK = 16;
constexpr int kThreads = 128;             // 16 x 8 threads, 8 x 8 outputs
constexpr int kStages = 3;
constexpr int kPitch = kBK + 4;           // floats a staged row: 80 bytes
constexpr int kTM = kBM / 8, kTN = kBN / 8;   // 16 x 8 threads

enum Epilogue { kNone = 0, kResidual = 1, kGelu = 2, kLeakyRelu = 3,
                kScaledResidual = 4, kDropResidual = 5, kGeluAux = 6 };

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

struct Params {
  const float* A;
  long long lda;
  const float* W;
  long long ldw;
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
  int M, N, K;
};

struct Stage {
  float a[kBM][kPitch];
  float w[kBN][kPitch];
};

// the 16-byte pieces of ``rows`` rows of ``src`` (row stride ``ld``) from
// column k0 into ``dst``; pieces past ``limit`` rows or K are zero-filled
template <int kRows>
__device__ __forceinline__ void stage_tile(float (*dst)[kPitch],
                                           const float* src, long long ld,
                                           int row0, int limit, int k0,
                                           int K) {
  constexpr int kPieces = kRows * kBK / 4;
#pragma unroll
  for (int j = 0; j < kPieces / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kBK / 4), kc = 4 * (i % (kBK / 4));
    const bool in = row0 + r < limit && k0 + kc < K;
    const float* p = in ? src + (long long)(row0 + r) * ld + k0 + kc : src;
    cp_async16((uint32_t)__cvta_generic_to_shared(&dst[r][kc]), p,
               in ? 16 : 0);
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 3)
rdg_gemm_f32_kernel(const Params p) {
  __shared__ __align__(16) Stage ring[kStages];
  const int tm = threadIdx.x / kTN, tn = threadIdx.x % kTN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int steps = (p.K + kBK - 1) / kBK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto stage = [&](int s, int step) {
    stage_tile<kBM>(ring[s].a, p.A, p.lda, m0, p.M, step * kBK, p.K);
    stage_tile<kBN>(ring[s].w, p.W, p.ldw, n0, p.N, step * kBK, p.K);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) stage(s, s);
    cp_async_commit();                    // one group a step, empty or not
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();         // this step's group has landed
    __syncthreads();                      // ... and the last step's reads
    const int next = step + kStages - 1;  // are done: refill its slot
    if (next < steps) stage(next % kStages, next);
    cp_async_commit();
    const Stage& t = ring[step % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&t.a[tm + kTM * i][kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(&t.w[tn + kTN * j][kk]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = acc[i][j];
          v = fmaf(a[i].x, b[j].x, v);
          v = fmaf(a[i].y, b[j].y, v);
          v = fmaf(a[i].z, b[j].z, v);
          acc[i][j] = fmaf(a[i].w, b[j].w, v);
        }
      }
    }
  }
  cp_async_wait<0>();

  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tn + kTN * j;
    bias[j] = n < p.N ? __ldg(p.bias + n) : 0.f;
  }
  constexpr bool kReadsResidual =
      EPI == kResidual || EPI == kScaledResidual || EPI == kDropResidual;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm + kTM * i;
    if (m >= p.M) continue;
    float s = 1.f;
    if constexpr (EPI == kDropResidual)
      s = __ldg(p.row_scale + (long long)(m / p.rows_per_scale)
                                  * p.scale_stride);
    float r[8];                           // the row's residuals, before any
    if constexpr (kReadsResidual) {       // store: out may alias residual
      const float* rr = p.res + (long long)m * p.ldr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tn + kTN * j;
        r[j] = n < p.N ? rr[n] : 0.f;
      }
    }
    float* o = p.out + (long long)m * p.ldo;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tn + kTN * j;
      if (n >= p.N) continue;
      float v = acc[i][j] + bias[j];
      if constexpr (EPI == kResidual) {
        v = v + r[j];
      } else if constexpr (EPI == kScaledResidual) {
        v = 0.2f * v + r[j];
      } else if constexpr (EPI == kDropResidual) {
        v = r[j] + s * v;                 // residual + m[image] * branch
      } else if constexpr (EPI == kGelu) {
        v = gelu(v);
      } else if constexpr (EPI == kLeakyRelu) {
        v = v >= 0.f ? v : 0.2f * v;
      } else if constexpr (EPI == kGeluAux) {
        p.aux[(long long)m * p.ldaux + n] = v;    // kept for GELU'
        v = gelu(v);
      }
      o[n] = v;
    }
  }
}

template <int EPI>
int launch(const Params& p, cudaStream_t s) {
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  rdg_gemm_f32_kernel<EPI><<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments of adsr_rdg_gemm (rdg_gemm.cu) without the tile width, on
// float32 operands and outputs: A and W with 16-byte aligned bases and row
// strides that are multiples of 4 (16-byte cp.async pieces), K % 4 == 0;
// out, residual and aux at any row stride (kernels/rdg_gemm.py
// ``check_gemm_layout``).
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
  const Params p{(const float*)A, lda, (const float*)W, ldw,
                 (const float*)bias, (float*)out, ldo, (const float*)res,
                 ldr, (const float*)row_scale, scale_stride, rows_per_scale,
                 (float*)aux, ldaux, M, N, K};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case kNone: return launch<kNone>(p, s);
    case kResidual: return launch<kResidual>(p, s);
    case kGelu: return launch<kGelu>(p, s);
    case kLeakyRelu: return launch<kLeakyRelu>(p, s);
    case kScaledResidual: return launch<kScaledResidual>(p, s);
    case kDropResidual: return launch<kDropResidual>(p, s);
    case kGeluAux: return launch<kGeluAux>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
