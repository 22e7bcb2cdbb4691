// rdg_gemm_bwd: the backward of the RDG's matmuls, out = A @ W^T + b.
//
//   dgrad: dA[M,K]  = dY[M,N] @ W[N,K]            (the NN layout)
//   wgrad: dW[N,K]  = dY^T @ A,  db[N] = colsum(dY)  (reduced over M rows)
//
// Replaces: the dW / dx matmuls of the Pallas backward kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770, called from _rdg_train_bwd
// :968) for qkv, proj, fc1, fc2 and the 1x1 adjust conv of each Swin block.
// Bound on H100: one RDG's 25 dgrad + 25 wgrad products at M = 16384 move
// ~1.0 GB (dY once, f32 where it is the residual-stream gradient, A and the
// outputs once) in 0.30 ms at 3.35 TB/s against 0.15 ms of bf16 tensor-core
// work: bytes, as the f32 dY reads and the adjust products (N = 32) are.
// Design: both products run on the pipelined wgmma mainloop of
// hopper_gemm.cuh (TMA into an mbarrier ring, a producer warpgroup, two
// consumer warpgroups, persistent blocks). dY_eff = alpha * dY *
// LeakyReLU'(sign of the saved concat) * the per-sample stochastic-depth
// multiplier is formed once per dY by dy_prep_kernel, which reads dY (f32 or
// bf16, any row stride), rounds dY_eff once to bf16 into a scratch buffer
// with 16-byte rows, and sums the f32 dY_eff of every 32 rows into a db
// partial: a bias gradient is a long sum whose terms often cancel, and bf16
// terms would leave ~2^-9 sqrt(M) of noise. A bf16 dY with no transform in
// 16-byte rows skips the copy and is read in place. One entry point,
// adsr_rdg_gemm_grads, runs dgrad, wgrad or both of one dY (the training
// backward asks for both: one pre-pass feeds the two products). The
// mainloop takes dY_eff as the K-major A of dgrad (W is its MN-major B) and
// as the MN-major A of wgrad (dY_eff^T; the activation is its MN-major B):
// wgmma's transpose bits do the transposes, so no operand is rewritten.
// dgrad's epilogue multiplies by GELU'(pre) for fc1 and writes f32 or bf16,
// 4 columns a lane, at any row stride that is a multiple of 4.
// wgrad is a reduction over M: a TPU grid runs in order and sums dW in
// place across its steps (fused_rdg_train.py:37-42), a CUDA grid does not.
// So the M rows are cut into S splits of 256 to thousands of rows (about one
// block per SM over the output tiles), each split streams its rows through
// the ring and writes an f32 partial, and partials.cuh's sum_partials adds
// the S dW partials and the db partials in a fixed order, in one launch: the
// result is bitwise reproducible, with no atomics.

#include "hopper_gemm.cuh"
#include "partials.cuh"

// this file's launches' operands by path, [TMA, cp.async] (read and reset
// through ctypes: kernels/_build.py ``operand_paths``)
extern "C" {
long long adsr_rdg_gemm_bwd_operands[2];
}

namespace {

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

__device__ __forceinline__ float gelu_grad(float x) {
  // d/dx [x * Phi(x)] = Phi(x) + x * phi(x), exact erf
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * __expf(-0.5f * x * x);
}

// ---- dY_eff pre-pass: one block per 32 rows -------------------------------
//
// Thread t takes column quad q = q0 + t % Qc (Qc = min(N / 4 - q0, 256)
// quads a pass) and rows g, g + G, ... of the block's 32 (g = t / Qc, G =
// 256 / Qc row groups), eight rows' loads in flight at a time; the G sums of
// a quad are added in order for the block's db partial row.

constexpr int kPrepRows = 32;
constexpr int kPrepThreads = 256;

__global__ void __launch_bounds__(kPrepThreads)
dy_prep_kernel(DyArgs d, __nv_bfloat16* __restrict__ eff, long long lde,
               float* __restrict__ db_part, int M, int N) {
  __shared__ float4 part[kPrepThreads];
  const int t = threadIdx.x, quads = N / 4;
  const int m0 = blockIdx.x * kPrepRows;
  for (int q0 = 0; q0 < quads; q0 += kPrepThreads) {
    const int qc = min(quads - q0, kPrepThreads), groups = kPrepThreads / qc;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < groups * qc) {
      const int n = 4 * (q0 + t % qc), g = t / qc;
      for (int r0 = g; r0 < kPrepRows; r0 += 8 * groups) {
        float4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r0 + j * groups;
          v[j] = r < kPrepRows && m0 + r < M
                     ? load_dy4(d, m0 + r, n)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r0 + j * groups;
          s.x += v[j].x; s.y += v[j].y; s.z += v[j].z; s.w += v[j].w;
          if (eff != nullptr && r < kPrepRows && m0 + r < M)
            store4(eff + (long long)(m0 + r) * lde + n, v[j]);
        }
      }
    }
    if (db_part == nullptr) continue;
    part[t] = s;
    __syncthreads();
    if (t < qc) {
      float4 a = part[t];
      for (int g = 1; g < groups; ++g) {            // in order
        const float4 b = part[g * qc + t];
        a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
      }
      *reinterpret_cast<float4*>(db_part + (long long)blockIdx.x * N
                                 + 4 * (q0 + t)) = a;
    }
    __syncthreads();
  }
}

int dy_prep(const DyArgs& d, __nv_bfloat16* eff, long long lde, float* db_part,
            int M, int N, cudaStream_t s) {
  const unsigned blocks = (unsigned)((M + kPrepRows - 1) / kPrepRows);
  dy_prep_kernel<<<blocks, kPrepThreads, 0, s>>>(d, eff, lde, db_part, M, N);
  return (int)cudaGetLastError();
}

// ---- dgrad ----------------------------------------------------------------

struct DgradEpi : ZeroInit {
  const __nv_bfloat16* pre;     // GELU' source, or null
  long long ldp;
  void* out;
  long long ldo;
  int out_f32;

  template <int BN>
  __device__ __forceinline__ void row(const float (&acc)[BN / 2], int h,
                                      int m, int, int n0, int N,
                                      bool valid) const {
    constexpr int J = BN / 16;
    uint2 gp[J];                  // the row's pre-activations, loaded first
    if (pre != nullptr) {
      const __nv_bfloat16* pr = pre + (long long)m * ldp;
#pragma unroll
      for (int jp = 0; jp < J; ++jp)
        gp[jp] = valid && n0 + 16 * jp < N
                     ? *reinterpret_cast<const uint2*>(pr + n0 + 16 * jp)
                     : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int jp = 0; jp < J; ++jp) {
      float4 v = row_vector<BN>(acc, h, jp);
      const int k = n0 + 16 * jp;
      if (!valid || k >= N) continue;
      if (pre != nullptr) {
        const float4 x = unpack4(gp[jp]);
        v = make_float4(v.x * gelu_grad(x.x), v.y * gelu_grad(x.y),
                        v.z * gelu_grad(x.z), v.w * gelu_grad(x.w));
      }
      const long long at = (long long)m * ldo + k;
      if (out_f32)
        *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = v;
      else
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at) =
            pack4(v);
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
dgrad_kernel(const Problem p, const DgradEpi epi,
             const __grid_constant__ TmaPair tm) {
  static_assert(BN % 64 == 0, "MN-major B needs whole 64-wide atoms");
  gemm_body<BN, false, true>(p, epi, tm);
}

// ---- wgrad: f32 partial of split s at part + s * N * K, row n, column k ----

struct WgradEpi : ZeroInit {
  float* part;
  int K;
  long long split_stride;       // N * K

  template <int BN>
  __device__ __forceinline__ void row(const float (&acc)[BN / 2], int h,
                                      int n, int split, int k0, int K_,
                                      bool valid) const {
    float* o = part + split * split_stride + (long long)n * K;
#pragma unroll
    for (int jp = 0; jp < BN / 16; ++jp) {
      const float4 v = row_vector<BN>(acc, h, jp);
      if (valid && k0 + 16 * jp < K_)
        *reinterpret_cast<float4*>(o + k0 + 16 * jp) = v;
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
wgrad_kernel(const Problem p, const WgradEpi epi,
             const __grid_constant__ TmaPair tm) {
  static_assert(BN % 64 == 0, "MN-major B needs whole 64-wide atoms");
  gemm_body<BN, true, true>(p, epi, tm);
}

DyArgs dy_args(const void* dy, long long ldy, int dy_f32, float alpha,
               const void* slope, long long lds, const void* scale,
               long long scale_stride, int rows_per_scale) {
  return DyArgs{dy, ldy, dy_f32, alpha,
                static_cast<const __nv_bfloat16*>(slope), lds,
                static_cast<const float*>(scale), scale_stride,
                rows_per_scale};
}

bool bad_dy(int M, int N, int K, long long ldy, int dy_f32, float alpha,
            const void* slope, long long lds, const void* scale,
            int rows_per_scale, const void* eff, long long lde) {
  return M < 0 || N <= 0 || K <= 0 || (N % 4) || (K % 4) || (ldy % 4) ||
         (slope != nullptr && (lds % 4)) ||
         (scale != nullptr && rows_per_scale <= 0) ||
         (eff == nullptr && (dy_f32 || alpha != 1.f || slope || scale)) ||
         (eff != nullptr && (lde % 8));
}

bool bad_dgrad(long long ldw, const void* pre, long long ldp, long long ldo,
               int K) {
  return (ldo % 4) || (ldw % 4) || ldw < K || (pre != nullptr && (ldp % 4));
}

bool bad_wgrad(long long lda, int splits, int rows_per_split, int M) {
  return (lda % 4) || splits <= 0 || rows_per_split <= 0 ||
         (rows_per_split % kBK) || (long long)splits * rows_per_split < M ||
         (long long)(splits - 1) * rows_per_split >= (M > 0 ? M : 1);
}

// dA = dY_eff @ W (dY_eff read from ``d``: the pre-pass's scratch or dY)
int run_dgrad(const Operand& d, const void* W, long long ldw, const void* pre,
              long long ldp, void* out, long long ldo, int out_f32, int M,
              int N, int K, int bn, cudaStream_t s) {
  const Problem p{d, operand(W, ldw), M, K, N, (M + kBM - 1) / kBM,
                  (K + bn - 1) / bn, 1, N};
  const DgradEpi epi{{}, static_cast<const __nv_bfloat16*>(pre), ldp, out,
                     ldo, out_f32};
  switch (bn) {
#define ADSR_DGRAD(BN)                                                  \
    case BN: return launch_gemm<dgrad_kernel<BN>, BN, false, true>(     \
        p, epi, s, adsr_rdg_gemm_bwd_operands);
    ADSR_DGRAD(64) ADSR_DGRAD(128) ADSR_DGRAD(192)
#undef ADSR_DGRAD
    default: return (int)cudaErrorInvalidValue;
  }
}

// dW = dY_eff^T @ A into split partials, then the fixed-order sums of those
// and of the pre-pass's db partials
int run_wgrad(const Operand& d, const void* A, long long lda, void* part,
              void* db_part, int splits, int rows_per_split, void* dW,
              void* db, int M, int N, int K, int bn, cudaStream_t s) {
  if (M > 0) {
    const Problem p{d, operand(A, lda), N, K, M, (N + kBM - 1) / kBM,
                    (K + bn - 1) / bn, splits, rows_per_split};
    const WgradEpi epi{{}, static_cast<float*>(part), K, (long long)N * K};
    int rc;
    switch (bn) {
#define ADSR_WGRAD(BN)                                                \
      case BN: rc = launch_gemm<wgrad_kernel<BN>, BN, true, true>(    \
          p, epi, s, adsr_rdg_gemm_bwd_operands); break;
      ADSR_WGRAD(64) ADSR_WGRAD(128) ADSR_WGRAD(192)
#undef ADSR_WGRAD
      default: rc = (int)cudaErrorInvalidValue;
    }
    if (rc) return rc;
  }
  const long long nk = (long long)N * K;
  return sum_partials(static_cast<const float*>(part), M > 0 ? splits : 0, nk,
                      static_cast<float*>(dW), nk, nullptr, s,
                      static_cast<const float*>(db_part),
                      (M + kPrepRows - 1) / kPrepRows, N,
                      static_cast<float*>(db));
}

}  // namespace

// dgrad, wgrad or both of one dY, with a single dY_eff pre-pass. dY: dy (f32
// or bf16, row stride ldy), alpha, the LeakyReLU sign source slope (or null),
// the per-sample multiplier scale (or null). dgrad writes dY_eff @ W (x
// GELU'(pre)) into out; a null out skips it. wgrad writes dY_eff^T @ A into
// dW and the column sums of the f32 dY_eff into db; a null dW skips it.
// Scratch: eff [M, lde] bf16 for dY_eff, or null when dY is bf16 with no
// transform (then the kernels read dY in place); wgrad's part [splits, N, K]
// and db_part [ceil(M / 32), N] f32. bn: the tile width over K (64, 128 or
// 192), the same for both products.
extern "C" int adsr_rdg_gemm_grads(
    const void* dy, long long ldy, int dy_f32, float alpha, const void* slope,
    long long lds, const void* scale, long long scale_stride,
    int rows_per_scale, const void* W, long long ldw, const void* pre,
    long long ldp, void* out, long long ldo, int out_f32, const void* A,
    long long lda, void* eff, long long lde, void* part, void* db_part,
    int splits, int rows_per_split, void* dW, void* db, int M, int N, int K,
    int bn, void* stream) {
  const bool dgrad = out != nullptr, wgrad = dW != nullptr;
  if ((!dgrad && !wgrad) ||
      bad_dy(M, N, K, ldy, dy_f32, alpha, slope, lds, scale, rows_per_scale,
             eff, lde) ||
      (dgrad && (W == nullptr || bad_dgrad(ldw, pre, ldp, ldo, K))) ||
      (wgrad && (A == nullptr || part == nullptr || db_part == nullptr ||
                 db == nullptr || bad_wgrad(lda, splits, rows_per_split, M))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const DyArgs d = dy_args(dy, ldy, dy_f32, alpha, slope, lds, scale,
                           scale_stride, rows_per_scale);
  const Operand dy_eff = eff != nullptr ? operand(eff, lde) : operand(dy, ldy);
  if (M > 0 && (eff != nullptr || wgrad)) {
    const int rc = dy_prep(d, static_cast<__nv_bfloat16*>(eff), lde,
                           wgrad ? static_cast<float*>(db_part) : nullptr, M,
                           N, s);
    if (rc) return rc;
  }
  if (dgrad) {
    const int rc = run_dgrad(dy_eff, W, ldw, pre, ldp, out, ldo, out_f32, M,
                             N, K, bn, s);
    if (rc) return rc;
  }
  return wgrad ? run_wgrad(dy_eff, A, lda, part, db_part, splits,
                           rows_per_split, dW, db, M, N, K, bn, s)
               : 0;
}
