// rdg_gemm: out = epilogue(A[M,K] @ W[N,K]^T + bias[N]) in bf16 with f32
// accumulation on the tensor cores (wgmma, hopper_gemm.cuh).
//
// Replaces: the five matmuls of each Swin block inside the Pallas kernels
// _rdg_kernel_impl (adsr_tpu/ops/fused_rdg.py:731, 858, 861, 887-892) and
// _fwd_kernel (adsr_tpu/ops/fused_rdg_train.py:266, training forward and
// the backward's recompute): qkv, proj, fc1, fc2 and the 1x1 adjust conv,
// with their residual, GELU, LeakyReLU / dense-concat and 0.2-residual
// epilogues, plus the training ones: the per-sample stochastic-depth
// residual (fused_rdg_train.py:295-296, 367, 372) and GELU that also keeps
// its pre-activation for the backward.
// Bound on H100: one RDG's 25 products at M = 16384 token rows move ~0.58 GB
// (A read once, outputs and residuals once) in 0.17 ms at 3.35 TB/s against
// 0.07 ms of bf16 tensor-core work (72 GFLOP): bytes. K <= 488 gives at most
// ~150 flop per byte on the large products; the N = 32 adjust products are
// bound by the bytes of A.
// Design: the shared pipelined mainloop of hopper_gemm.cuh with both
// operands K-major: persistent blocks over 128 x BN output tiles (BN 32 for
// the adjust products, else 128 or 192 by N: kernels/rdg_gemm.py
// ``n_tile``), the activations and weights by TMA (the port keeps them in
// 16-byte rows) into a 5-8 stage mbarrier ring, two consumer warpgroups on
// wgmma. The epilogue runs from the accumulator registers, one template
// instance per epilogue: the bias is the accumulators' starting value, lanes
// trade pairs so each holds 4 columns of a row, and residual reads and bf16
// stores move 8 bytes a lane at any row stride that is a multiple of 4: the
// adjust output lands straight in columns [c_k, c_k+32) of the concat
// buffer, and block 5's lands in place over the RDG input (each row's
// residuals are read before its first store, so out may alias residual).

#include "hopper_gemm.cuh"

// this file's launches' operands by path, [TMA, cp.async] (read and reset
// through ctypes: kernels/_build.py ``operand_paths``)
extern "C" {
long long adsr_rdg_gemm_operands[2];
}

namespace {

enum Epilogue { kNone = 0, kResidual = 1, kGelu = 2, kLeakyRelu = 3,
                kScaledResidual = 4, kDropResidual = 5, kGeluAux = 6 };

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <int EPI>
struct FwdEpi {
  const float* bias;
  __nv_bfloat16* out;
  long long ldo;
  const __nv_bfloat16* res;
  long long ldr;
  const float* row_scale;
  long long scale_stride;
  int rows_per_scale;
  __nv_bfloat16* aux;
  long long ldaux;

  static constexpr bool kReadsResidual =
      EPI == kResidual || EPI == kScaledResidual || EPI == kDropResidual;

  // the bias is the accumulators' starting value
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], int n0,
                                       int N) const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j;
      const float2 b = n < N ? make_float2(__ldg(bias + n), __ldg(bias + n + 1))
                             : make_float2(0.f, 0.f);
      acc[4 * j] = acc[4 * j + 2] = b.x;
      acc[4 * j + 1] = acc[4 * j + 3] = b.y;
    }
  }

  template <int BN>
  __device__ __forceinline__ void row(const float (&acc)[BN / 2], int h,
                                      int m, int, int n0, int N,
                                      bool valid) const {
    constexpr int J = BN / 16;
    uint2 r[J];                   // the row's residuals, before any store:
    float s = 1.f;                // out may alias residual (each element
    if constexpr (kReadsResidual) {   // is read before it is written)
      const __nv_bfloat16* rr = res + (long long)m * ldr;
#pragma unroll
      for (int jp = 0; jp < J; ++jp)
        r[jp] = valid && n0 + 16 * jp < N
                    ? *reinterpret_cast<const uint2*>(rr + n0 + 16 * jp)
                    : make_uint2(0u, 0u);
      if (EPI == kDropResidual && valid)
        s = __ldg(row_scale + (m / rows_per_scale) * scale_stride);
    }
    __nv_bfloat16* o = out + (long long)m * ldo;
#pragma unroll
    for (int jp = 0; jp < J; ++jp) {
      float4 v = row_vector<BN>(acc, h, jp);
      const int n = n0 + 16 * jp;
      if (!valid || n >= N) continue;
      if constexpr (kReadsResidual) {
        const float4 x = unpack4(r[jp]);
        if constexpr (EPI == kResidual) {
          v = make_float4(v.x + x.x, v.y + x.y, v.z + x.z, v.w + x.w);
        } else if constexpr (EPI == kScaledResidual) {
          v = make_float4(0.2f * v.x + x.x, 0.2f * v.y + x.y,
                          0.2f * v.z + x.z, 0.2f * v.w + x.w);
        } else {          // residual + m[image] * branch, per sample
          v = make_float4(x.x + s * v.x, x.y + s * v.y, x.z + s * v.z,
                          x.w + s * v.w);
        }
      } else if constexpr (EPI == kGelu) {
        v = make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
      } else if constexpr (EPI == kLeakyRelu) {
        v = make_float4(v.x >= 0.f ? v.x : 0.2f * v.x,
                        v.y >= 0.f ? v.y : 0.2f * v.y,
                        v.z >= 0.f ? v.z : 0.2f * v.z,
                        v.w >= 0.f ? v.w : 0.2f * v.w);
      } else if constexpr (EPI == kGeluAux) {
        // the pre-activation is kept for GELU'
        *reinterpret_cast<uint2*>(aux + (long long)m * ldaux + n) = pack4(v);
        v = make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
      }
      *reinterpret_cast<uint2*>(o + n) = pack4(v);
    }
  }
};

template <int BN, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
rdg_gemm_kernel(const Problem p, const FwdEpi<EPI> epi,
                const __grid_constant__ TmaPair tm) {
  gemm_body<BN, false, false>(p, epi, tm);
}

template <int BN, int EPI>
int launch(const Problem& p, const FwdEpi<EPI>& epi, cudaStream_t s) {
  return launch_gemm<rdg_gemm_kernel<BN, EPI>, BN, false, false>(
      p, epi, s, adsr_rdg_gemm_operands);
}

template <int EPI>
int dispatch(Problem p, const void* bias, void* out, long long ldo,
             const void* res, long long ldr, const void* row_scale,
             long long scale_stride, int rows_per_scale, void* aux,
             long long ldaux, int bn, cudaStream_t s) {
  const FwdEpi<EPI> epi{static_cast<const float*>(bias),
                        static_cast<__nv_bfloat16*>(out), ldo,
                        static_cast<const __nv_bfloat16*>(res), ldr,
                        static_cast<const float*>(row_scale), scale_stride,
                        rows_per_scale, static_cast<__nv_bfloat16*>(aux),
                        ldaux};
  p.n_tiles = (p.N + bn - 1) / bn;
  switch (bn) {
    case 32: return launch<32, EPI>(p, epi, s);
    case 64: return launch<64, EPI>(p, epi, s);
    case 128: return launch<128, EPI>(p, epi, s);
    case 192: return launch<192, EPI>(p, epi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bn: the output tile width (32, 64, 128 or 192), chosen by the wrapper
extern "C" int adsr_rdg_gemm(const void* A, long long lda, const void* W,
                             long long ldw, const void* bias, void* out, long long ldo,
                             const void* res, long long ldr,
                             const void* row_scale, long long scale_stride,
                             int rows_per_scale, void* aux, long long ldaux,
                             int M, int N, int K, int epilogue, int bn,
                             void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || (K % 4) || (lda % 4) || (ldw % 4) ||
      ldw < K || (N % 4) || (ldo % 4) || epilogue < kNone ||
      epilogue > kGeluAux)
    return (int)cudaErrorInvalidValue;
  const bool needs_res = epilogue == kResidual ||
                         epilogue == kScaledResidual ||
                         epilogue == kDropResidual;
  if (needs_res && (res == nullptr || (ldr % 4)))
    return (int)cudaErrorInvalidValue;
  if (epilogue == kDropResidual && (row_scale == nullptr || rows_per_scale <= 0))
    return (int)cudaErrorInvalidValue;
  if (epilogue == kGeluAux && (aux == nullptr || (ldaux % 4)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  Problem p{operand(A, lda), operand(W, ldw), M, N, K, (M + kBM - 1) / kBM, 0,
            1, K};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
#define ADSR_EPI(E) \
    case E: return dispatch<E>(p, bias, out, ldo, res, ldr, row_scale, \
                               scale_stride, rows_per_scale, aux, ldaux, bn, s);
    ADSR_EPI(kNone) ADSR_EPI(kResidual) ADSR_EPI(kGelu) ADSR_EPI(kLeakyRelu)
    ADSR_EPI(kScaledResidual) ADSR_EPI(kDropResidual) ADSR_EPI(kGeluAux)
#undef ADSR_EPI
    default: return (int)cudaErrorInvalidValue;
  }
}
