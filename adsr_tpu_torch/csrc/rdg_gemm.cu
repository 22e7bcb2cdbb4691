// rdg_gemm: out = epilogue(A[M,K] @ W[N,K]^T + bias[N]) in bf16 with f32
// accumulation on the tensor cores (WMMA m16n16k16).
//
// Replaces: the five matmuls of each Swin block inside the Pallas kernels
// _rdg_kernel_impl (adsr_tpu/ops/fused_rdg.py:731, 858, 861, 887-892) and
// _fwd_kernel (adsr_tpu/ops/fused_rdg_train.py:266, training forward and
// the backward's recompute): qkv, proj, fc1, fc2 and the 1x1 adjust conv,
// with their residual, GELU, LeakyReLU / dense-concat and 0.2-residual
// epilogues, plus the training ones: the per-sample stochastic-depth
// residual (fused_rdg_train.py:295-296, 367, 372) and GELU that also keeps
// its pre-activation for the backward.
// Bound on H100: the big products (qkv, fc1 at M = 16384) are near the
// bf16 ridge (K <= 308 gives at most ~150 flop per byte); the adjust GEMMs
// (N = 32) are bound by the bytes of A.
// Design: 64x64 output tiles, 4 warps of 32x32, K stepped by 32 through
// shared memory with 8-byte vector loads (every K, N and row stride on this
// path is a multiple of 4). Ragged K and N are zero-filled at the tile edge.
// Each epilogue is its own template instance (no per-element branch), run
// from an f32 staging tile, writing at any row stride,
// so the adjust output lands straight in columns [c_k, c_k+32) of the
// concat buffer and block 5's output lands in place over the RDG input.
// Simple and correct first: no cp.async pipeline, no wgmma, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 8;   // bf16 row pitch of the A / W tiles
constexpr int LDC = BN + 4;   // f32 row pitch of the staging tile
constexpr int kThreads = 128;

enum Epilogue { kNone = 0, kResidual = 1, kGelu = 2, kLeakyRelu = 3,
                kScaledResidual = 4, kDropResidual = 5, kGeluAux = 6 };

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, long long r0,
                                          long long rows, int k0, int K) {
  // BM (== BN) rows x BK cols, 4 bf16 (8 bytes) per chunk
  for (int i = threadIdx.x; i < BM * BK / 4; i += kThreads) {
    const int r = i / (BK / 4);
    const int c = (i % (BK / 4)) * 4;
    const long long gr = r0 + r;
    const int gk = k0 + c;
    uint2 val = make_uint2(0u, 0u);
    if (gr < rows && gk < K)
      val = *reinterpret_cast<const uint2*>(src + gr * ld + gk);
    *reinterpret_cast<uint2*>(dst + r * LDS + c) = val;
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
rdg_gemm_kernel(const __nv_bfloat16* __restrict__ A, long long lda,
                const __nv_bfloat16* __restrict__ W,
                const float* __restrict__ bias, __nv_bfloat16* out,
                long long ldo, const __nv_bfloat16* res, long long ldr,
                const float* __restrict__ row_scale, long long scale_stride,
                int rows_per_scale, __nv_bfloat16* __restrict__ aux,
                long long ldaux, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 Ws[BN * LDS];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile(As, A, lda, m0, M, k0, K);
    load_tile(Ws, W, K, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Ws + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = Cs[r * LDC + c] + bias[n];
    if constexpr (EPI == kResidual) {
      v += __bfloat162float(res[m * ldr + n]);
    } else if constexpr (EPI == kGelu) {
      v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    } else if constexpr (EPI == kLeakyRelu) {
      v = v >= 0.f ? v : 0.2f * v;
    } else if constexpr (EPI == kScaledResidual) {
      v = 0.2f * v + __bfloat162float(res[m * ldr + n]);
    } else if constexpr (EPI == kDropResidual) {
      // residual + m[image] * branch, per sample
      v = __bfloat162float(res[m * ldr + n]) +
          row_scale[((int)m / rows_per_scale) * scale_stride] * v;
    } else if constexpr (EPI == kGeluAux) {
      // the pre-activation is kept for GELU'
      aux[m * ldaux + n] = __float2bfloat16(v);
      v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    }
    out[m * ldo + n] = __float2bfloat16(v);
  }
}

}  // namespace

extern "C" int adsr_rdg_gemm(const void* A, long long lda, const void* W,
                             const void* bias, void* out, long long ldo,
                             const void* res, long long ldr,
                             const void* row_scale, long long scale_stride,
                             int rows_per_scale, void* aux, long long ldaux,
                             int M, int N, int K, int epilogue, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || (K % 4) || (lda % 4) ||
      epilogue < kNone || epilogue > kGeluAux)
    return (int)cudaErrorInvalidValue;
  if ((epilogue == kResidual || epilogue == kScaledResidual ||
       epilogue == kDropResidual) && res == nullptr)
    return (int)cudaErrorInvalidValue;
  if (epilogue == kDropResidual && (row_scale == nullptr || rows_per_scale <= 0))
    return (int)cudaErrorInvalidValue;
  if (epilogue == kGeluAux && aux == nullptr) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const long long mt = (M + BM - 1) / BM;
  if (mt > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (unsigned)mt);
  auto kernel = rdg_gemm_kernel<kNone>;
  switch (epilogue) {
    case kResidual: kernel = rdg_gemm_kernel<kResidual>; break;
    case kGelu: kernel = rdg_gemm_kernel<kGelu>; break;
    case kLeakyRelu: kernel = rdg_gemm_kernel<kLeakyRelu>; break;
    case kScaledResidual: kernel = rdg_gemm_kernel<kScaledResidual>; break;
    case kDropResidual: kernel = rdg_gemm_kernel<kDropResidual>; break;
    case kGeluAux: kernel = rdg_gemm_kernel<kGeluAux>; break;
    default: break;
  }
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)A, lda, (const __nv_bfloat16*)W,
      (const float*)bias, (__nv_bfloat16*)out, ldo,
      (const __nv_bfloat16*)res, ldr, (const float*)row_scale, scale_stride,
      rows_per_scale, (__nv_bfloat16*)aux, ldaux, M, N, K);
  return (int)cudaGetLastError();
}
