// rdg_gemm_bwd_f32: the backward of the RDG's matmuls, out = A @ W^T + b,
// in full f32 (fp32 training): f32 operands, FFMA on the CUDA cores, f32
// results (no TF32, no bf16 rounding of dY_eff).
//
//   dgrad: dA[M,K]  = dY_eff[M,N] @ W[N,K]  (x GELU'(pre) for fc1)
//   wgrad: dW[N,K]  = dY_eff^T @ A,  db[N] = colsum(dY_eff)  (over M rows)
//
// dY_eff = alpha * dY * LeakyReLU'(sign of the saved concat) * the
// per-sample stochastic-depth multiplier m[row // L].
//
// Replaces: the dW / dx matmuls of the Pallas backward kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770, called from _rdg_train_bwd
// :968) at dtype f32, where the TPU kernel stages in f32 with f32
// accumulators (fused_rdg_train.py:442, 961-967): qkv, proj, fc1, fc2 and
// the 1x1 adjust conv of each Swin block. The bf16 instance is
// rdg_gemm_bwd.cu (which rounds dY_eff once to bf16; this one keeps it f32,
// as the JAX f32 path does).
// Bound on H100: operations. One flagship RDG's 25 dgrad and 25 wgrad
// products at M = 16384 are ~145 GFLOP, ~2.2 ms at the 67 TFLOP/s of f32
// FFMA, against ~2.5 GB of f32 bytes (0.75 ms at 3.35 TB/s).
// Design: a pre-pass forms dY_eff once per call: a block per 32 x 32 tile
// of dY reads it as float4, writes dY_eff [M, N] where wgrad cannot read
// dY in place (a transform, or dY not in 16-byte rows), its transpose
// dY_eff^T [N, M'] (M' = M rounded up to 4; through a shared-memory tile)
// for dgrad, and the f32 column sums of its 32 rows as a db partial row.
// Both products then run one SIMT GEMM, C[i, j] = sum_r P[r, i] Q[r, j]
// with both operands stored reduction-major (row r, the output index
// contiguous): dgrad with P = dY_eff^T (r = n, i = m) and Q = W (r = n,
// j = k), wgrad with P = dY_eff (r = m, i = n) and Q = A (r = m, j = k).
// So every operand tile is staged by 16-byte cp.async with no transpose:
// a block of 128 threads owns a 128 x 64 output tile, each thread 8 x 8
// outputs in registers (rows 4 ti + {0..3} and 64 + 4 ti + {0..3}, columns
// 4 tj + {0..3} and 32 + 4 tj + {0..3}), the reduction in steps of 16
// through a 3-stage ring of [16][128] and [16][64] tiles in static shared
// memory (a step's reads: 4 and 8 distinct float4 a warp, free of bank
// conflicts), one barrier a step. dgrad's epilogue multiplies by GELU'(pre)
// for fc1 and writes float4s at any row stride that is a multiple of 4.
// wgrad is a reduction over M: the M rows are cut into S splits (grid z),
// each writes an f32 partial [N, K], and partials.cuh's sum_partials adds
// the S partials and the pre-pass's db partials in a fixed order in one
// launch. Every output is one f32 sum in a fixed order: bitwise repeatable,
// no atomics; nothing is allocated here and nothing survives a launch.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "partials.cuh"

namespace {

constexpr int kBM = 128, kBN = 64, kBK = 16;
constexpr int kThreads = 128;             // 16 x 8 threads, 8 x 8 outputs
constexpr int kStages = 3;
constexpr int kPrepRows = 32;             // rows of one db partial
constexpr int kPrepThreads = 256;

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

__device__ __forceinline__ float gelu_grad(float x) {
  // d/dx [x * Phi(x)] = Phi(x) + x * phi(x), exact erf
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * expf(-0.5f * x * x);
}

struct DyArgs {
  const float* dy;
  long long ldy;
  float alpha;
  const float* slope;           // LeakyReLU'(0.2) from its sign, or null
  long long lds;
  const float* scale;           // per-sample multiplier, or null
  long long scale_stride;
  int rows_per_scale;
};

// dY_eff of row m, columns n..n+3 (N and every row stride are multiples of
// 4 and the bases 16-byte aligned, so a quad is whole and aligned)
__device__ __forceinline__ float4 load_dy4(const DyArgs& d, long long m,
                                           int n) {
  float4 v = *reinterpret_cast<const float4*>(d.dy + m * d.ldy + n);
  float mul = d.alpha;
  if (d.scale != nullptr)
    mul *= d.scale[(m / d.rows_per_scale) * d.scale_stride];
  v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
  if (d.slope != nullptr) {
    const float4 s =
        *reinterpret_cast<const float4*>(d.slope + m * d.lds + n);
    if (!(s.x > 0.f)) v.x *= 0.2f;
    if (!(s.y > 0.f)) v.y *= 0.2f;
    if (!(s.z > 0.f)) v.z *= 0.2f;
    if (!(s.w > 0.f)) v.w *= 0.2f;
  }
  return v;
}

// ---- dY_eff pre-pass: a block per 32 x 32 tile of dY ------------------------
//
// Thread t loads row t / 8, columns 4 (t % 8) .. + 3 of the tile; the tile
// goes through shared memory [32][33] (conflict-free both ways) for the
// transposed store (thread t: column t / 8, rows 4 (t % 8) .. + 3) and the
// db partial (thread t < 32: column t, the 32 rows in order). Rows past M
// are zeros, so dY_eff^T's padding columns up to M' are written as 0.

__global__ void __launch_bounds__(kPrepThreads)
dy_prep_f32_kernel(DyArgs d, float* __restrict__ eff, long long lde,
                   float* __restrict__ eff_t, long long ldt,
                   float* __restrict__ db_part, int M, int N) {
  __shared__ float tile[kPrepRows][kPrepRows + 1];
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * kPrepRows, m0 = blockIdx.y * kPrepRows;
  {
    const int r = t / 8, c = 4 * (t % 8);
    const int m = m0 + r, n = n0 + c;
    const bool in = m < M && n < N;
    const float4 v = in ? load_dy4(d, m, n) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (eff != nullptr && in)
      *reinterpret_cast<float4*>(eff + (long long)m * lde + n) = v;
    tile[r][c] = v.x;
    tile[r][c + 1] = v.y;
    tile[r][c + 2] = v.z;
    tile[r][c + 3] = v.w;
  }
  __syncthreads();
  if (db_part != nullptr && t < kPrepRows && n0 + t < N) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < kPrepRows; ++r) s += tile[r][t];      // in order
    db_part[(long long)blockIdx.y * N + n0 + t] = s;
  }
  if (eff_t != nullptr) {
    const int c = t / 8, r = 4 * (t % 8);
    const int n = n0 + c, m = m0 + r;
    if (n < N && m < ldt)
      *reinterpret_cast<float4*>(eff_t + (long long)n * ldt + m) =
          make_float4(tile[r][c], tile[r + 1][c], tile[r + 2][c],
                      tile[r + 3][c]);
  }
}

// ---- the SIMT GEMM: C[i, j] = sum_r P[r, i] Q[r, j] -------------------------

struct Gemm {
  const float* P;               // [R, I], row stride ldp
  long long ldp;
  const float* Q;               // [R, J], row stride ldq
  long long ldq;
  int I, J, R;
  int rows_per_split;           // reduction rows of one split (grid z)
};

enum Epi { kDgrad = 0, kWgrad = 1 };

struct EpiArgs {
  float* out;                   // dgrad: [I = M, J = K] at row stride ldo;
  long long ldo;                // wgrad: partial z at out + z * I * J
  const float* pre;             // dgrad's GELU' source, or null
  long long ldpre;
};

struct Ring {
  float p[kStages][kBK][kBM];
  float q[kStages][kBK][kBN];
};

// the 16-byte pieces of reduction rows [r0, r0 + kBK) and output columns
// [c0, c0 + kCols) of ``src`` into dst[kBK][kCols]; pieces at or past
// ``r_end`` rows or ``limit`` columns are zero-filled
template <int kCols>
__device__ __forceinline__ void stage(float (*dst)[kCols], const float* src,
                                      long long ld, int r0, int r_end,
                                      int c0, int limit) {
  constexpr int kPer = kCols / 4;
  constexpr int kPieces = kBK * kPer;
#pragma unroll
  for (int j = 0; j < kPieces / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kPer, c = 4 * (i % kPer);
    const bool in = r0 + r < r_end && c0 + c < limit;
    const float* p = in ? src + (long long)(r0 + r) * ld + c0 + c : src;
    cp_async16((uint32_t)__cvta_generic_to_shared(&dst[r][c]), p,
               in ? 16 : 0);
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 3)
gemm_f32_kernel(const Gemm g, const EpiArgs e) {
  __shared__ __align__(16) Ring ring;
  const int ti = threadIdx.x / 8, tj = threadIdx.x % 8;
  const int j0 = blockIdx.x * kBN, i0 = blockIdx.y * kBM;
  const int r_begin = blockIdx.z * g.rows_per_split;
  const int r_end = min(g.R, r_begin + g.rows_per_split);
  const int steps = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto load = [&](int s, int step) {
    const int r0 = r_begin + step * kBK;
    stage<kBM>(ring.p[s], g.P, g.ldp, r0, r_end, i0, g.I);
    stage<kBN>(ring.q[s], g.Q, g.ldq, r0, r_end, j0, g.J);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();                    // one group a step, empty or not
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();         // this step's group has landed
    __syncthreads();                      // ... and the last step's reads
    const int next = step + kStages - 1;  // are done: refill its slot
    if (next < steps) load(next % kStages, next);
    cp_async_commit();
    const int s = step % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&ring.p[s][kk][4 * ti]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&ring.p[s][kk][64 + 4 * ti]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ring.q[s][kk][4 * tj]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ring.q[s][kk][32 + 4 * tj]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* base = e.out;
  if constexpr (EPI == kWgrad)
    base += (long long)blockIdx.z * g.I * g.J;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + (i < 4 ? 4 * ti + i : 64 + 4 * ti + i - 4);
    if (row >= g.I) continue;
    const long long ld = EPI == kWgrad ? (long long)g.J : e.ldo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = j0 + 4 * tj + 32 * h;
      if (col >= g.J) continue;           // J % 4 == 0: a quad is whole
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                             acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if constexpr (EPI == kDgrad) {
        if (e.pre != nullptr) {
          const float4 x = *reinterpret_cast<const float4*>(
              e.pre + (long long)row * e.ldpre + col);
          v.x *= gelu_grad(x.x);
          v.y *= gelu_grad(x.y);
          v.z *= gelu_grad(x.z);
          v.w *= gelu_grad(x.w);
        }
      }
      *reinterpret_cast<float4*>(base + (long long)row * ld + col) = v;
    }
  }
}

template <int EPI>
int run_gemm(const Gemm& g, const EpiArgs& e, int splits, cudaStream_t s) {
  const dim3 grid((g.J + kBN - 1) / kBN, (g.I + kBM - 1) / kBM, splits);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  gemm_f32_kernel<EPI><<<grid, kThreads, 0, s>>>(g, e);
  return (int)cudaGetLastError();
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// dgrad, wgrad or both of one f32 dY, behind one pre-pass. dY: dy (row
// stride ldy), alpha, the LeakyReLU sign source slope (f32, or null), the
// per-sample multiplier scale (or null). dgrad writes dY_eff @ W (x
// GELU'(pre), f32 pre or null) into out (f32); a null out skips it. wgrad
// writes dY_eff^T @ A into dW and the column sums of dY_eff into db; a null
// dW skips it. Scratch (f32): eff [M, lde] for dY_eff when wgrad cannot
// read dy in place (else null), eff_t [N, ldt] (ldt >= M, a multiple of 4)
// for dgrad, wgrad's part [splits, N, K] and db_part [ceil(M / 32), N].
// Every pointer 16-byte aligned, N, K and every row stride multiples of 4
// (kernels/rdg_gemm_bwd.py ``check_bwd_layout``, ``gemm_bwd_f32_plan``).
extern "C" int adsr_rdg_gemm_grads_f32(
    const void* dy, long long ldy, float alpha, const void* slope,
    long long lds, const void* scale, long long scale_stride,
    int rows_per_scale, const void* W, long long ldw, const void* pre,
    long long ldp, void* out, long long ldo, const void* A, long long lda,
    void* eff, long long lde, void* eff_t, long long ldt, void* part,
    void* db_part, int splits, int rows_per_split, void* dW, void* db, int M,
    int N, int K, void* stream) {
  const bool dgrad = out != nullptr, wgrad = dW != nullptr;
  const bool transform = alpha != 1.f || slope != nullptr || scale != nullptr;
  if ((!dgrad && !wgrad) || M < 0 || N <= 0 || K <= 0 || N % 4 || K % 4 ||
      ldy % 4 || ldy < N || misaligned(dy) ||
      (slope != nullptr && (lds % 4 || misaligned(slope))) ||
      (scale != nullptr && rows_per_scale <= 0) ||
      (dgrad && (W == nullptr || ldw % 4 || ldw < K || misaligned(W) ||
                 ldo % 4 || misaligned(out) || eff_t == nullptr ||
                 ldt % 4 || ldt < M || misaligned(eff_t) ||
                 (pre != nullptr && (ldp % 4 || misaligned(pre))))) ||
      (wgrad && (A == nullptr || lda % 4 || lda < K || misaligned(A) ||
                 part == nullptr || db_part == nullptr || db == nullptr ||
                 splits <= 0 || rows_per_split <= 0 ||
                 rows_per_split % kBK ||
                 (long long)splits * rows_per_split < M ||
                 (long long)(splits - 1) * rows_per_split >= (M > 0 ? M : 1) ||
                 (transform && (eff == nullptr || lde % 4 || lde < N ||
                                misaligned(eff))))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const DyArgs d{static_cast<const float*>(dy), ldy, alpha,
                 static_cast<const float*>(slope), lds,
                 static_cast<const float*>(scale), scale_stride,
                 rows_per_scale};
  float* const e = wgrad && transform ? static_cast<float*>(eff) : nullptr;
  if (M > 0) {
    const dim3 grid((N + kPrepRows - 1) / kPrepRows,
                    (M + kPrepRows - 1) / kPrepRows);
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    dy_prep_f32_kernel<<<grid, kPrepThreads, 0, s>>>(
        d, e, lde, dgrad ? static_cast<float*>(eff_t) : nullptr, ldt,
        wgrad ? static_cast<float*>(db_part) : nullptr, M, N);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  if (dgrad && M > 0) {
    const Gemm g{static_cast<const float*>(eff_t), ldt,
                 static_cast<const float*>(W), ldw, M, K, N, N};
    const EpiArgs ea{static_cast<float*>(out), ldo,
                     static_cast<const float*>(pre), ldp};
    const int rc = run_gemm<kDgrad>(g, ea, 1, s);
    if (rc) return rc;
  }
  if (!wgrad) return 0;
  if (M > 0) {
    const Gemm g{e != nullptr ? e : static_cast<const float*>(dy),
                 e != nullptr ? lde : ldy, static_cast<const float*>(A), lda,
                 N, K, M, rows_per_split};
    const EpiArgs ea{static_cast<float*>(part), 0, nullptr, 0};
    const int rc = run_gemm<kWgrad>(g, ea, splits, s);
    if (rc) return rc;
  }
  const long long nk = (long long)N * K;
  return sum_partials(static_cast<const float*>(part), M > 0 ? splits : 0,
                      nk, static_cast<float*>(dW), nk, nullptr, s,
                      static_cast<const float*>(db_part),
                      (M + kPrepRows - 1) / kPrepRows, N,
                      static_cast<float*>(db));
}
