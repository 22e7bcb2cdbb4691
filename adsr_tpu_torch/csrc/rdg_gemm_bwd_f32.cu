// rdg_gemm_bwd_f32: the backward of the RDG's matmuls, out = A @ W^T + b,
// in full f32 (fp32 training): f32 operands, every product f32-accurate as
// 3xTF32 on the tensor cores (mma.sync), f32 results (no bf16 rounding of
// dY_eff).
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
// products at M = 16384 are ~145 GFLOP: ~0.88 ms as three TF32 products
// each at 495 TFLOP/s (2.2 ms at the 67 TFLOP/s of f32 FFMA), against ~2.5
// GB of f32 bytes (0.75 ms at 3.35 TB/s).
// Design: where dY is transformed (alpha, the LeakyReLU or the multiplier)
// a pre-pass forms dY_eff [M, N] once per call (a block per 32 x 32 tile,
// float4 loads and stores); where wgrad runs it also sums each 32 rows'
// columns into a db partial row (reading dY when there is no transform).
// Both products then run one GEMM on dY_eff as it lies (the pre-pass's
// copy, or dY itself): C[i, j] = sum_r P(i, r) Q[r, j], dgrad with P =
// dY_eff (i = m, r = n: K-major) and Q = W (r = n, j = k), wgrad with P =
// dY_eff (r = m, i = n) and Q = A (r = m, j = k), both of the latter
// reduction-major. TF32 wgmma reads only K-major (reduction-contiguous)
// operands from shared memory, and W and A are stored the other way;
// mma.sync's fragments are loaded a value a lane, so they read either
// layout and no operand is transposed. Every tile is staged by 16-byte
// cp.async as it lies: a block of 128 threads owns a 64 x 64 (dgrad) or
// 128 x 64 (wgrad) output tile, the reduction in steps of 32 through a
// 3-stage ring in dynamic shared memory whose rows are padded so a
// fragment's reads hit 32 different banks, one barrier a step. Warp (wi,
// wj) takes rows 16 MT wi .. and columns 32 wj .. of the tile (MT = 2 or
// 4 m16 tiles): per k8 step it loads its A and B (4 n8 tiles) fragments,
// splits each value into hi = x with its low 13 bits cleared and lo = x -
// hi (exact; the tensor cores read its top 19 bits: tf32_mma.cuh
// split_tf32_trunc) and runs 12 MT m16n8k8 TF32 mma.sync, interleaved
// over the n8 tiles so no mma waits on its own accumulator. dgrad's
// 64-row tiles fill the card in fewer rounds at M = 4,096-65,536, with
// four blocks an SM. The tensor cores' sums do not round as FFMA does, so
// both products sum in two levels: every kFlushSteps steps (128 of the
// reduction) the accumulators are added into an f32 total by FADD and
// zeroed. dgrad's epilogue multiplies by GELU'(pre) for fc1; both store
// float2 pairs at any row stride that is a multiple of 4. wgrad is a reduction over M: the M rows are cut into S
// splits (grid z), each writes an f32 partial [N, K], and partials.cuh's
// sum_partials adds the S partials and the pre-pass's db partials in a
// fixed order in one launch. Every output is a sum in a fixed order:
// bitwise repeatable, no atomics; nothing is allocated here and nothing
// survives a launch.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "partials.cuh"
#include "tf32_mma.cuh"   // split_as, mma_tf32

// switches of scripts/torch_gemm_bwd_f32_sweep.py (SPLIT 0 and X3 0 are
// timing only: such a variant computes something else)
#ifndef RDG_BWD_F32_SPLIT
#define RDG_BWD_F32_SPLIT 2       // 1: both rounded to nearest; 0: none
#endif
#ifndef RDG_BWD_F32_X3
#define RDG_BWD_F32_X3 1          // 0: one TF32 product a k8 step
#endif
#ifndef RDG_BWD_F32_TWO_LEVEL
#define RDG_BWD_F32_TWO_LEVEL 1   // 0: every sum in one level
#endif

namespace {

constexpr int kBN = 64, kBK = 32;  // output columns, reduction rows a stage
constexpr int kThreads = 128;             // 2 x 2 warps of 16 MT x 32 outputs
constexpr int kStages = 3;
constexpr int kPad = 8;                   // floats past a reduction-major row
constexpr int kPadK = 4;                  // floats past a K-major row
constexpr int kFlushSteps = 128 / kBK;    // steps a partial sum (128 of R)
constexpr bool kTwoLevel = RDG_BWD_F32_TWO_LEVEL;
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
// Thread t loads row t / 8, columns 4 (t % 8) .. + 3 of the tile and writes
// them to dY_eff where asked; for db the tile goes through shared memory
// [32][33] and thread t < 32 sums column t over the 32 rows in order. Rows
// past M are zeros.

__global__ void __launch_bounds__(kPrepThreads)
dy_prep_f32_kernel(DyArgs d, float* __restrict__ eff, long long lde,
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
  if (db_part == nullptr) return;
  __syncthreads();
  if (t < kPrepRows && n0 + t < N) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < kPrepRows; ++r) s += tile[r][t];      // in order
    db_part[(long long)blockIdx.y * N + n0 + t] = s;
  }
}

// ---- the GEMM: C[i, j] = sum_r P(i, r) Q[r, j], 3xTF32 mma.sync -----------

struct Gemm {
  const float* P;               // dgrad: [I, R] (K-major), wgrad: [R, I]
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

// The stages of P's and Q's tiles for BM output rows a block (MT = BM / 32
// m16 tiles a warp): dgrad's P K-major ([BM][kBK + kPadK]: a fragment's
// eight rows 20 floats apart, in eight bank quads), wgrad's P and both Q
// reduction-major ([kBK][cols + kPad]: a fragment's four rows 8 banks
// apart)
template <int EPI, int BM>
struct Ring {
  float p[kStages][kBK][BM + kPad];
  float q[kStages][kBK][kBN + kPad];
};

template <int BM>
struct Ring<kDgrad, BM> {
  float p[kStages][BM][kBK + kPadK];
  float q[kStages][kBK][kBN + kPad];
};

// the 16-byte pieces of reduction rows [r0, r0 + kBK) and output columns
// [c0, c0 + kCols) of ``src`` into dst[kBK][kCols + kPad]; pieces at or
// past ``r_end`` rows or ``limit`` columns are zero-filled
template <int kCols>
__device__ __forceinline__ void stage(float (*dst)[kCols + kPad],
                                      const float* src, long long ld, int r0,
                                      int r_end, int c0, int limit) {
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

// the K-major twin: output rows [c0, c0 + BM) and reduction columns [r0,
// r0 + kBK) of ``src`` into dst[BM][kBK + kPadK], zero-filled at or past
// ``limit`` rows or ``r_end`` columns
template <int BM>
__device__ __forceinline__ void stage_k(float (*dst)[kBK + kPadK],
                                        const float* src, long long ld,
                                        int r0, int r_end, int c0,
                                        int limit) {
  constexpr int kPer = kBK / 4;
#pragma unroll
  for (int j = 0; j < BM * kPer / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int c = i / kPer, r = 4 * (i % kPer);
    const bool in = c0 + c < limit && r0 + r < r_end;
    const float* p = in ? src + (long long)(c0 + c) * ld + r0 + r : src;
    cp_async16((uint32_t)__cvta_generic_to_shared(&dst[c][r]), p,
               in ? 16 : 0);
  }
}

// x -> (hi, lo) for a TF32 product: hi = x with its low 13 bits cleared,
// lo = x - hi (exact), whose low 13 bits the tensor cores ignore (SPLIT 1:
// both rounded to nearest, tf32_mma.cuh)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
#if RDG_BWD_F32_SPLIT
  split_as<RDG_BWD_F32_SPLIT == 2>(x, hi, lo);
#else
  hi = lo = __float_as_uint(x);
#endif
}

// k8 step kk of stage s: acc[mt][nt] += the warp's 16 x 8 tiles (rows
// 16 MT wi + 16 mt, columns 32 wj + 8 nt) over reduction rows kk .. kk +
// 7, each product as 3xTF32; the three products of a value pair go in
// three rounds over the four n8 tiles, so consecutive mma never share an
// accumulator
template <int EPI, int MT>
__device__ __forceinline__ void mma_step(const Ring<EPI, 32 * MT>& ring,
                                         int s, int kk, int wi, int wj,
                                         float (&acc)[MT][4][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const auto& q = ring.q[s];
  const auto& p = ring.p[s];
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = 32 * wj + 8 * nt + g;
    split(q[kk + t][col], bh[nt][0], bl[nt][0]);
    split(q[kk + t + 4][col], bh[nt][1], bl[nt][1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = 16 * MT * wi + 16 * mt + g;
    uint32_t ah[4], al[4];
    if constexpr (EPI == kDgrad) {
      split(p[row][kk + t], ah[0], al[0]);
      split(p[row + 8][kk + t], ah[1], al[1]);
      split(p[row][kk + t + 4], ah[2], al[2]);
      split(p[row + 8][kk + t + 4], ah[3], al[3]);
    } else {
      split(p[kk + t][row], ah[0], al[0]);
      split(p[kk + t][row + 8], ah[1], al[1]);
      split(p[kk + t + 4][row], ah[2], al[2]);
      split(p[kk + t + 4][row + 8], ah[3], al[3]);
    }
#if RDG_BWD_F32_X3
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], al, bh[nt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah, bl[nt]);
#endif
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah, bh[nt]);
  }
}

// blocks an SM asked of the registers: MT = 4 two (the two-level sums
// take 64 more a thread), MT = 2 four (128 registers a thread)
template <int MT>
constexpr int min_blocks() {
  return MT == 2 ? 4 : (kTwoLevel ? 2 : 3);
}

template <int EPI, int MT>
__global__ void __launch_bounds__(kThreads, min_blocks<MT>())
gemm_f32_kernel(const Gemm g, const EpiArgs e) {
  constexpr int BM = 32 * MT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Ring<EPI, BM>& ring = *reinterpret_cast<Ring<EPI, BM>*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wi = warp & 1, wj = warp >> 1;
  const int j0 = blockIdx.x * kBN, i0 = blockIdx.y * BM;
  const int r_begin = blockIdx.z * g.rows_per_split;
  const int r_end = min(g.R, r_begin + g.rows_per_split);
  const int steps = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;

  // the tensor cores' sums do not round as FFMA does: in two levels, acc
  // is added into total every kFlushSteps steps
  float acc[MT][4][4], total[kTwoLevel ? MT : 1][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc[i][j][x] = 0.f;
        if constexpr (kTwoLevel) total[i][j][x] = 0.f;
      }

  auto load = [&](int s, int step) {
    const int r0 = r_begin + step * kBK;
    if constexpr (EPI == kDgrad)
      stage_k<BM>(ring.p[s], g.P, g.ldp, r0, r_end, i0, g.I);
    else
      stage<BM>(ring.p[s], g.P, g.ldp, r0, r_end, i0, g.I);
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
    for (int kk = 0; kk < kBK; kk += 8)
      mma_step<EPI, MT>(ring, s, kk, wi, wj, acc);
    if constexpr (kTwoLevel) {
      if ((step + 1) % kFlushSteps == 0 || step + 1 == steps) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              total[i][j][x] += acc[i][j][x];
              acc[i][j][x] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (kTwoLevel) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][j][x] = total[i][j][x];
  }

  float* base = e.out;
  if constexpr (EPI == kWgrad)
    base += (long long)blockIdx.z * g.I * g.J;
  const long long ld = EPI == kWgrad ? (long long)g.J : e.ldo;
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + 16 * MT * wi + 16 * mt + gq + 8 * h;
      if (row >= g.I) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = j0 + 32 * wj + 8 * nt + 2 * t;
        if (col >= g.J) continue;         // J % 4 == 0: a pair is whole
        float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if constexpr (EPI == kDgrad) {
          if (e.pre != nullptr) {
            const float2 x = *reinterpret_cast<const float2*>(
                e.pre + (long long)row * e.ldpre + col);
            v.x *= gelu_grad(x.x);
            v.y *= gelu_grad(x.y);
          }
        }
        *reinterpret_cast<float2*>(base + (long long)row * ld + col) = v;
      }
    }
  }
}

template <int EPI, int MT>
int run_gemm(const Gemm& g, const EpiArgs& e, int splits, cudaStream_t s) {
  constexpr int BM = 32 * MT;
  const dim3 grid((g.J + kBN - 1) / kBN, (g.I + BM - 1) / BM, splits);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  constexpr int bytes = (int)sizeof(Ring<EPI, BM>);
  static const int attr = (int)cudaFuncSetAttribute(
      gemm_f32_kernel<EPI, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr) return attr;
  gemm_f32_kernel<EPI, MT><<<grid, kThreads, bytes, s>>>(g, e);
  return (int)cudaGetLastError();
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// dgrad, wgrad or both of one f32 dY, behind at most one pre-pass. dY: dy
// (row stride ldy), alpha, the LeakyReLU sign source slope (f32, or null),
// the per-sample multiplier scale (or null). dgrad writes dY_eff @ W (x
// GELU'(pre), f32 pre or null) into out (f32); a null out skips it. wgrad
// writes dY_eff^T @ A into dW and the column sums of dY_eff into db; a null
// dW skips it. Scratch (f32): eff [M, lde] for dY_eff when dY is
// transformed (alpha != 1, slope or scale; else both read dy in place),
// wgrad's part [splits, N, K] and db_part [ceil(M / 32), N]. Every pointer
// 16-byte aligned, N, K and every row stride multiples of 4
// (kernels/rdg_gemm_bwd.py ``check_bwd_f32_layout``, ``gemm_bwd_f32_plan``).
extern "C" int adsr_rdg_gemm_grads_f32(
    const void* dy, long long ldy, float alpha, const void* slope,
    long long lds, const void* scale, long long scale_stride,
    int rows_per_scale, const void* W, long long ldw, const void* pre,
    long long ldp, void* out, long long ldo, const void* A, long long lda,
    void* eff, long long lde, void* part, void* db_part, int splits,
    int rows_per_split, void* dW, void* db, int M, int N, int K,
    void* stream) {
  const bool dgrad = out != nullptr, wgrad = dW != nullptr;
  const bool transform = alpha != 1.f || slope != nullptr || scale != nullptr;
  if ((!dgrad && !wgrad) || M < 0 || N <= 0 || K <= 0 || N % 4 || K % 4 ||
      ldy % 4 || ldy < N || misaligned(dy) ||
      (slope != nullptr && (lds % 4 || misaligned(slope))) ||
      (scale != nullptr && rows_per_scale <= 0) ||
      (transform && (eff == nullptr || lde % 4 || lde < N ||
                     misaligned(eff))) ||
      (dgrad && (W == nullptr || ldw % 4 || ldw < K || misaligned(W) ||
                 ldo % 4 || misaligned(out) ||
                 (pre != nullptr && (ldp % 4 || misaligned(pre))))) ||
      (wgrad && (A == nullptr || lda % 4 || lda < K || misaligned(A) ||
                 part == nullptr || db_part == nullptr || db == nullptr ||
                 splits <= 0 || rows_per_split <= 0 ||
                 rows_per_split % kBK ||
                 (long long)splits * rows_per_split < M ||
                 (long long)(splits - 1) * rows_per_split >= (M > 0 ? M : 1))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const DyArgs d{static_cast<const float*>(dy), ldy, alpha,
                 static_cast<const float*>(slope), lds,
                 static_cast<const float*>(scale), scale_stride,
                 rows_per_scale};
  float* const e = transform ? static_cast<float*>(eff) : nullptr;
  if (M > 0 && (transform || wgrad)) {
    const dim3 grid((N + kPrepRows - 1) / kPrepRows,
                    (M + kPrepRows - 1) / kPrepRows);
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    dy_prep_f32_kernel<<<grid, kPrepThreads, 0, s>>>(
        d, e, lde, wgrad ? static_cast<float*>(db_part) : nullptr, M, N);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  // dY_eff: the pre-pass's copy, or dy itself
  const float* const src = e != nullptr ? e : static_cast<const float*>(dy);
  const long long lds_eff = e != nullptr ? lde : ldy;
  if (dgrad && M > 0) {
    const Gemm g{src, lds_eff, static_cast<const float*>(W), ldw, M, K, N,
                 N};
    const EpiArgs ea{static_cast<float*>(out), ldo,
                     static_cast<const float*>(pre), ldp};
    const int rc = run_gemm<kDgrad, 2>(g, ea, 1, s);
    if (rc) return rc;
  }
  if (!wgrad) return 0;
  if (M > 0) {
    const Gemm g{src, lds_eff, static_cast<const float*>(A), lda, N, K, M,
                 rows_per_split};
    const EpiArgs ea{static_cast<float*>(part), 0, nullptr, 0};
    const int rc = run_gemm<kWgrad, 4>(g, ea, splits, s);
    if (rc) return rc;
  }
  const long long nk = (long long)N * K;
  return sum_partials(static_cast<const float*>(part), M > 0 ? splits : 0,
                      nk, static_cast<float*>(dW), nk, nullptr, s,
                      static_cast<const float*>(db_part),
                      (M + kPrepRows - 1) / kPrepRows, N,
                      static_cast<float*>(db));
}
