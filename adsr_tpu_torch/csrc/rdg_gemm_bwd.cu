// rdg_gemm_bwd: the backward of the RDG's matmuls, out = A @ W^T + b.
//
//   dgrad: dA[M,K]  = dY[M,N] @ W[N,K]            (the NN layout)
//   wgrad: dW[N,K]  = dY^T @ A,  db[N] = colsum(dY)  (reduced over M rows)
//
// Replaces: the dW / dx matmuls of the Pallas backward kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770, called from _rdg_train_bwd
// :968) for qkv, proj, fc1, fc2 and the 1x1 adjust conv of each Swin block.
// Bound on H100: the large products (K, N up to 924 x 488 over M = 16384
// rows) sit near the bf16 ridge; the adjust products (N = 32) and the dY
// reads in f32 are bound by bytes.
// Design: the dY operand is loaded through one transform shared by both
// kernels: dY may be f32 or bf16 at any row stride (a column slice of the
// f32 concat gradient), times a constant (0.2 for adjust 5), times
// LeakyReLU'(pre) read from the sign of the saved concat columns (the
// activation keeps the sign, so nothing is recomputed), times the
// per-sample stochastic-depth multiplier of the branch, four columns a
// thread with 16- or 8-byte loads (every N, K and row stride on this path is
// a multiple of 4). It is rounded to bf16 in shared memory and multiplied on
// the tensor cores (WMMA m16n16k16, f32 accumulation), as in rdg_gemm.cu. dgrad's epilogue multiplies by
// GELU'(pre) for fc1 and writes f32 or bf16 at any row stride.
// wgrad is a reduction over M: a TPU grid runs in order and sums dW in
// place across its steps (fused_rdg_train.py:37-42), a CUDA grid does not.
// So the M rows are cut into S splits, each block writes an f32 partial of
// its split, and partials.cuh sums the S partials in a fixed order: the
// result is bitwise reproducible, with no atomics. db sums the f32 dY
// values before they round to bf16: a bias gradient is a long sum whose
// terms often cancel, and bf16 terms would leave ~2^-9 sqrt(M) of noise.
// Simple and correct first: no cp.async pipeline, no wgmma, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "partials.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;          // 4 warps, 32 x 32 outputs each
constexpr int T = 64;                  // output tile (both dims)
constexpr int BR = 32;                 // reduction step
constexpr int LDR = BR + 8;            // bf16 pitch of a [T][BR] tile
constexpr int LDT = T + 8;             // bf16 pitch of a [BR][T] tile
constexpr int LDC = T + 4;             // f32 pitch of the staging tile

struct DyArgs {
  const void* dy;
  long long ldy;
  int f32;                      // dY is float32 (else bf16)
  float alpha;
  const __nv_bfloat16* slope;   // LeakyReLU'(0.2) from its sign, or null
  long long lds;
  const float* scale;           // per-sample multiplier, or null
  long long scale_stride;
  int rows_per_scale;
};

// dY_eff of row m, columns n..n+3 (N and every row stride are multiples of 4,
// so a chunk is whole and 8- or 16-byte aligned)
__device__ __forceinline__ float4 load_dy4(const DyArgs& d, long long m,
                                           int n) {
  float4 v;
  if (d.f32) {
    v = *reinterpret_cast<const float4*>(static_cast<const float*>(d.dy) +
                                         m * d.ldy + n);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(d.dy) + m * d.ldy + n);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  float mul = d.alpha;
  if (d.scale != nullptr)
    mul *= d.scale[((int)m / d.rows_per_scale) * d.scale_stride];
  v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
  if (d.slope != nullptr) {
    const uint2 u = *reinterpret_cast<const uint2*>(d.slope + m * d.lds + n);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    if (!(lo.x > 0.f)) v.x *= 0.2f;
    if (!(lo.y > 0.f)) v.y *= 0.2f;
    if (!(hi.x > 0.f)) v.z *= 0.2f;
    if (!(hi.y > 0.f)) v.w *= 0.2f;
  }
  return v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// 4 bf16 of a row-major matrix, or zeros past its edge
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* src, long long ld,
                                       long long r, long long rows, int c,
                                       int cols) {
  return (r < rows && c < cols)
             ? *reinterpret_cast<const uint2*>(src + r * ld + c)
             : make_uint2(0u, 0u);
}

__device__ __forceinline__ float gelu_grad(float x) {
  // d/dx [x * Phi(x)] = Phi(x) + x * phi(x), exact erf
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * __expf(-0.5f * x * x);
}

__global__ void __launch_bounds__(kThreads)
dgrad_kernel(DyArgs dy, const __nv_bfloat16* __restrict__ W,
             const __nv_bfloat16* __restrict__ pre, long long ldp, void* out,
             long long ldo, int out_f32, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[T * LDR];    // [m][n]
  __shared__ __align__(128) __nv_bfloat16 Bs[BR * LDT];   // [n][k]
  __shared__ __align__(128) float Cs[T * LDC];

  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const long long m0 = (long long)blockIdx.y * T;
  const int k0 = blockIdx.x * T;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int n0 = 0; n0 < N; n0 += BR) {
    for (int i = threadIdx.x; i < T * BR / 4; i += kThreads) {
      const int r = i / (BR / 4), c = (i % (BR / 4)) * 4;
      const long long gm = m0 + r;
      const int gn = n0 + c;
      const float4 v = (gm < M && gn < N) ? load_dy4(dy, gm, gn)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      store4(As + r * LDR + c, v);
    }
    for (int i = threadIdx.x; i < BR * T / 4; i += kThreads) {
      const int r = i / (T / 4), c = (i % (T / 4)) * 4;
      *reinterpret_cast<uint2*>(Bs + r * LDT + c) =
          load4(W, K, n0 + r, N, k0 + c, K);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDR + kk, LDR);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDT + wn * 32 + j * 16, LDT);
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

  for (int i = threadIdx.x; i < T * T; i += kThreads) {
    const int r = i / T, c = i % T;
    const long long m = m0 + r;
    const int k = k0 + c;
    if (m >= M || k >= K) continue;
    float v = Cs[r * LDC + c];
    if (pre != nullptr) v *= gelu_grad(__bfloat162float(pre[m * ldp + k]));
    if (out_f32)
      static_cast<float*>(out)[m * ldo + k] = v;
    else
      static_cast<__nv_bfloat16*>(out)[m * ldo + k] = __float2bfloat16(v);
  }
}

__global__ void __launch_bounds__(kThreads)
wgrad_kernel(DyArgs dy, const __nv_bfloat16* __restrict__ A, long long lda,
             float* __restrict__ part, int M, int N, int K,
             int rows_per_split) {
  __shared__ __align__(128) __nv_bfloat16 Ds[BR * LDT];   // [m][n]
  __shared__ __align__(128) __nv_bfloat16 Xs[BR * LDT];   // [m][k]
  __shared__ __align__(128) float Cs[T * LDC];            // [n][k]

  const int warp = threadIdx.x >> 5;
  const int wn_ = warp >> 1, wk = warp & 1;
  const int k0 = blockIdx.x * T;
  const int n0 = blockIdx.y * T;
  const long long m_begin = (long long)blockIdx.z * rows_per_split;
  const long long m_end = min((long long)M, m_begin + rows_per_split);
  const bool bias_block = blockIdx.x == 0;     // the k-tile that sums db
  static_assert(kThreads % (T / 4) == 0, "db column map");

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  float4 db = make_float4(0.f, 0.f, 0.f, 0.f);

  for (long long mb = m_begin; mb < m_end; mb += BR) {
    // thread t always loads the columns 4 (t % 16) .. +3 (kThreads is a
    // multiple of T / 4), so it sums its own f32 dY values for db before
    // they round to bf16
    for (int i = threadIdx.x; i < BR * T / 4; i += kThreads) {
      const int r = i / (T / 4), c = (i % (T / 4)) * 4;
      const long long gm = mb + r;
      const float4 v = (gm < m_end && n0 + c < N)
                           ? load_dy4(dy, gm, n0 + c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      db.x += v.x; db.y += v.y; db.z += v.z; db.w += v.w;
      store4(Ds + r * LDT + c, v);
      *reinterpret_cast<uint2*>(Xs + r * LDT + c) =
          load4(A, lda, gm, m_end, k0 + c, K);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      // A operand dY^T [16 n x 16 m]: the [m][n] tile read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], Ds + kk * LDT + wn_ * 32 + i * 16, LDT);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Xs + kk * LDT + wk * 32 + j * 16, LDT);
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
      wmma::store_matrix_sync(Cs + (wn_ * 32 + i * 16) * LDC + wk * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  constexpr int kShare = kThreads / (T / 4);    // threads per column chunk
  __shared__ float dbs[kShare][T];
  {
    const int c = (threadIdx.x % (T / 4)) * 4, j = threadIdx.x / (T / 4);
    dbs[j][c] = db.x; dbs[j][c + 1] = db.y;
    dbs[j][c + 2] = db.z; dbs[j][c + 3] = db.w;
  }
  __syncthreads();

  float* p = part + (long long)blockIdx.z * ((long long)N * K + N);
  for (int i = threadIdx.x; i < T * T; i += kThreads) {
    const int r = i / T, c = i % T;
    const int n = n0 + r, k = k0 + c;
    if (n < N && k < K) p[(long long)n * K + k] = Cs[r * LDC + c];
  }
  if (bias_block && threadIdx.x < T && n0 + (int)threadIdx.x < N) {
    float acc = 0.f;
    for (int j = 0; j < kShare; ++j) acc += dbs[j][threadIdx.x];  // in order
    p[(long long)N * K + n0 + threadIdx.x] = acc;
  }
}

DyArgs dy_args(const void* dy, long long ldy, int dy_f32, float alpha,
               const void* slope, long long lds, const void* scale,
               long long scale_stride, int rows_per_scale) {
  return DyArgs{dy, ldy, dy_f32, alpha,
                static_cast<const __nv_bfloat16*>(slope), lds,
                static_cast<const float*>(scale), scale_stride,
                rows_per_scale};
}

}  // namespace

extern "C" int adsr_rdg_gemm_dgrad(
    const void* dy, long long ldy, int dy_f32, float alpha, const void* slope,
    long long lds, const void* scale, long long scale_stride,
    int rows_per_scale, const void* W, const void* pre, long long ldp,
    void* out, long long ldo, int out_f32, int M, int N, int K, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || (N % 4) || (K % 4) || (ldy % 4) ||
      (slope != nullptr && (lds % 4)) ||
      (scale != nullptr && rows_per_scale <= 0))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const long long mt = (M + T - 1) / T;
  if (mt > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((K + T - 1) / T, (unsigned)mt);
  dgrad_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      dy_args(dy, ldy, dy_f32, alpha, slope, lds, scale, scale_stride,
              rows_per_scale),
      (const __nv_bfloat16*)W, (const __nv_bfloat16*)pre, ldp, out, ldo,
      out_f32, M, N, K);
  return (int)cudaGetLastError();
}

extern "C" int adsr_rdg_gemm_wgrad(
    const void* dy, long long ldy, int dy_f32, float alpha, const void* slope,
    long long lds, const void* scale, long long scale_stride,
    int rows_per_scale, const void* A, long long lda, void* part, int splits,
    int rows_per_split, void* dW, void* db, int M, int N, int K,
    void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || (N % 4) || (K % 4) || (ldy % 4) ||
      (lda % 4) || (slope != nullptr && (lds % 4)) || splits <= 0 ||
      rows_per_split <= 0 ||
      (long long)splits * rows_per_split < M || splits > 65535 ||
      (scale != nullptr && rows_per_scale <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((K + T - 1) / T, (N + T - 1) / T, splits);
  wgrad_kernel<<<grid, kThreads, 0, s>>>(
      dy_args(dy, ldy, dy_f32, alpha, slope, lds, scale, scale_stride,
              rows_per_scale),
      (const __nv_bfloat16*)A, lda, (float*)part, M, N, K, rows_per_split);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return sum_partials((const float*)part, splits, (long long)N * K + N,
                      (float*)dW, (long long)N * K, (float*)db, s);
}
