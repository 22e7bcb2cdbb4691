// rdg_layernorm: row LayerNorm over the first C columns of a row-strided
// bf16 or f32 buffer (the RDG concat buffer's prefix, or a block's x1), f32
// two-pass statistics, eps, the affine applied unfolded, out in the input's
// type. One source, templated on the element type: the bf16 instances
// (adsr_rdg_layernorm) and the f32 ones (adsr_rdg_layernorm_f32, the fp32
// serving forward) share every line but the loads and stores of a piece.
//
// Replaces: the LayerNorm phases of the Pallas kernel _rdg_kernel_impl
// (adsr_tpu/ops/fused_rdg.py:708-714, 860), which fold the affine into the
// next matmul; here the affine is applied in place, unfolded, and the
// variance is the centred second pass, not the TPU kernel's one-pass form.
// Bound on H100: bytes (2 B in + 2 B out per element in bf16, 4 + 4 in f32,
// a few f32 ops each).
// Design: a group of lanes takes a row (a half-warp in pieces of 4 values,
// so a warp has two rows in flight; a warp in single values), in pieces of
// kVec values: 4 values (8-byte bf16x4, 16-byte float4) where both bases
// are aligned to the piece and C and both row strides are multiples of 4
// (every layout of the main path: the concat at its plain stride 308, x1
// contiguous, the outputs in 16-byte rows), single values otherwise (any
// C <= 320, any stride). Lane l holds
// pieces l, l + lanes, ...; statistics and stores stop at column C (a
// concat prefix has real columns past C, a contiguous out the next row).
// Each lane loads its columns' gamma and beta once, as float4 where both
// are 16-byte aligned, and keeps them in registers across its rows. A
// fixed grid (kernels/rdg_layernorm.py ``rdg_layernorm_plan``: what the
// card holds at once, as adsr_rdg_layernorm_blocks_per_sm reads it, or a
// block a step of rows where that spreads the rows over every SM) loops
// over the rows; a block that takes more than one step loads its group's
// next row while it normalises this one (kAhead), and the first row is
// loaded before gamma and beta. The row stays in registers as it sits in
// memory (at most 20 values a lane of a half-warp); the statistics are two
// passes over it in f32 (mean, then the centred sum of squares), each a
// pairwise sum a piece and a shuffle tree over the group. No shared
// memory, no atomics: bitwise repeatable for a given layout and plan;
// nothing survives a launch (graph-capturable).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxC = 320;
constexpr int kWarps = 4;                 // 128 threads a block
constexpr int kThreads = 32 * kWarps;
typedef __nv_bfloat16 bf16;

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

// blocks an SM must hold at once: the launch bounds cap the registers at
// 65,536 / (5 x 128) a thread in bf16, room for a half-warp lane's gamma
// and beta in f32 (40) and its row twice (20 words) without spilling
// (ptxas: chip_smoke.py's build phase); an f32 row twice is 40 words, so
// the f32 instances ask for 4 blocks (128 registers); the plan takes what
// the built kernel holds (adsr_rdg_layernorm_blocks_per_sm)
template <typename T>
constexpr int kMinBlocks = kF32<T> ? 4 : 5;

// lanes a row: a half-warp in pieces of 4 values, a warp in single values
// (20 a lane of a half-warp spill)
template <int kVec>
constexpr int kLanes = kVec == 4 ? 16 : 32;

// pieces a lane of a row of kMaxC values
template <int kVec>
constexpr int kPieces = (kMaxC / kVec + kLanes<kVec> - 1) / kLanes<kVec>;

// kVec values as they sit in memory: bf16 in 32-bit words (a single value
// in the low half), f32 as they are
template <typename T, int kVec>
struct Piece {
  uint32_t w[kF32<T> ? kVec : (kVec == 1 ? 1 : kVec / 2)];
};

template <typename T, int kVec>
__device__ __forceinline__ Piece<T, kVec> zero_piece() {
  Piece<T, kVec> r;
#pragma unroll
  for (auto& u : r.w) u = 0u;
  return r;
}

template <typename T, int kVec>
__device__ __forceinline__ Piece<T, kVec> load_piece(const T* p) {
  Piece<T, kVec> r;
  if constexpr (kF32<T> && kVec == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    r.w[0] = t.x, r.w[1] = t.y, r.w[2] = t.z, r.w[3] = t.w;
  } else if constexpr (kF32<T>) {
    r.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (kVec == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    r.w[0] = t.x, r.w[1] = t.y;
  } else {
    r.w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
  return r;
}

// value j of a piece in f32 (exact: bf16 is the top half of an f32)
template <typename T, int kVec>
__device__ __forceinline__ float value(const Piece<T, kVec>& r, int j) {
  if constexpr (kF32<T>) {
    return __uint_as_float(r.w[j]);
  } else {
    const uint32_t u = r.w[kVec == 1 ? 0 : j / 2];
    return __uint_as_float(kVec == 1 || j % 2 == 0 ? u << 16
                                                   : u & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T, int kVec>
__device__ __forceinline__ void store_piece(T* p, const float* o) {
  if constexpr (kF32<T> && kVec == 4)
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  else if constexpr (kF32<T>)
    *p = o[0];
  else if constexpr (kVec == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(o[0], o[1]),
                                              pack2(o[2], o[3]));
  else
    *p = __float2bfloat16(o[0]);
}

template <int kVec>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kLanes<kVec> / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of a piece's values (or of their squared distances to mu), as a
// pairwise tree: a short dependent chain, the same order every row
template <typename T, int kVec, bool kSquares>
__device__ __forceinline__ float piece_sum(const Piece<T, kVec>& r,
                                           float mu) {
  float t[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float d = value<T, kVec>(r, j) - mu;
    t[j] = kSquares ? d * d : d;
  }
#pragma unroll
  for (int h = 1; h < kVec; h *= 2) {
#pragma unroll
    for (int j = 0; j + h < kVec; j += 2 * h) t[j] += t[j + h];
  }
  return t[0];
}

// the first column of lane l's piece i
template <int kVec>
__device__ __forceinline__ int piece_col(int l, int i) {
  return kVec * (l + kLanes<kVec> * i);
}

// this lane's pieces of ``row`` (zeros past C and for rows past M)
template <typename T, int kVec>
__device__ __forceinline__ void load_row(
    Piece<T, kVec> (&dst)[kPieces<kVec>], const T* __restrict__ x,
    long long ldx, long long row, int M, int C, int l) {
  const T* xr = x + row * ldx;
#pragma unroll
  for (int i = 0; i < kPieces<kVec>; ++i) {
    const int c0 = piece_col<kVec>(l, i);
    dst[i] = row < M && c0 < C ? load_piece<T, kVec>(xr + c0)
                               : zero_piece<T, kVec>();
  }
}

template <typename T, int kVec, int kAhead>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
rdg_layernorm_kernel(const T* __restrict__ x, long long ldx,
                     const float* __restrict__ w, const float* __restrict__ b,
                     T* __restrict__ y, long long ldy, int M, int C,
                     float eps) {
  constexpr int kP = kPieces<kVec>;
  constexpr int kRowsPerStep = kThreads / kLanes<kVec>;
  const int lane = threadIdx.x & 31;
  const int l = lane % kLanes<kVec>;
  // this group's row of the block's first step, and the grid's step
  const long long first =
      (long long)blockIdx.x * kRowsPerStep + threadIdx.x / kLanes<kVec>;
  const long long stride = (long long)gridDim.x * kRowsPerStep;

  // the first row, then gamma and beta of this lane's columns, once
  // (float4 where both are 16-byte aligned: a piece is then one float4)
  Piece<T, kVec> next[kP];
  load_row<T, kVec>(next, x, ldx, first, M, C, l);
  float g[kP][kVec], be[kP][kVec];
  const bool wide = ((reinterpret_cast<uintptr_t>(w)
                      | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int c0 = piece_col<kVec>(l, i);
    if constexpr (kVec == 4) {
      if (c0 < C && wide) {
        const float4 gw = *reinterpret_cast<const float4*>(w + c0);
        const float4 gb = *reinterpret_cast<const float4*>(b + c0);
        g[i][0] = gw.x, g[i][1] = gw.y, g[i][2] = gw.z, g[i][3] = gw.w;
        be[i][0] = gb.x, be[i][1] = gb.y, be[i][2] = gb.z, be[i][3] = gb.w;
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (c0 < C) {
        g[i][j] = w[c0 + j];
        be[i][j] = b[c0 + j];
      } else {
        g[i][j] = be[i][j] = 0.f;
      }
    }
  }
  const float inv_c = 1.f / (float)C;

  // the warp's groups stay together: every lane runs every step
  for (long long row = first, base = first - lane / kLanes<kVec>; base < M;
       row += stride, base += stride) {
    Piece<T, kVec> cur[kP];
    if (kAhead || row == first) {
#pragma unroll
      for (int i = 0; i < kP; ++i) cur[i] = next[i];
      if (kAhead) load_row<T, kVec>(next, x, ldx, row + stride, M, C, l);
    } else {
      load_row<T, kVec>(cur, x, ldx, row, M, C, l);
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kP; ++i)              // zeros past C
      s += piece_sum<T, kVec, false>(cur[i], 0.f);
    const float mu = group_sum<kVec>(s) * inv_c;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kP; ++i)
      if (piece_col<kVec>(l, i) < C)
        q += piece_sum<T, kVec, true>(cur[i], mu);
    const float inv = rsqrtf(group_sum<kVec>(q) * inv_c + eps);
    if (row < M) {
      T* yr = y + row * ldy;
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const int c0 = piece_col<kVec>(l, i);
        if (c0 >= C) continue;
        float o[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          o[j] = (value<T, kVec>(cur[i], j) - mu) * inv * g[i][j]
                 + be[i][j];
        store_piece<T, kVec>(yr + c0, o);
      }
    }
  }
}

template <typename T>
struct Args {
  const T* x;
  long long ldx;
  const float* w;
  const float* b;
  T* y;
  long long ldy;
  int M, C, blocks;
  float eps;
  cudaStream_t stream;
};

template <typename T, int kVec, int kAhead>
int launch(const Args<T>& a) {
  rdg_layernorm_kernel<T, kVec, kAhead>
      <<<a.blocks, kThreads, 0, a.stream>>>(a.x, a.ldx, a.w, a.b, a.y, a.ldy,
                                            a.M, a.C, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, int kVec>
int by_ahead(int ahead, const Args<T>& a) {
  return ahead ? launch<T, kVec, 1>(a) : launch<T, kVec, 0>(a);
}

template <typename T, int kVec>
int blocks_per_sm(int* n) {
  const int rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, rdg_layernorm_kernel<T, kVec, 0>, kThreads, 0);
  if (rc) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n + 1, rdg_layernorm_kernel<T, kVec, 1>, kThreads, 0);
}

// the checks and launch of both entries: ``piece`` is the piece's bytes,
// 4 values (sizeof(T) * 4) or one (sizeof(T))
template <typename T>
int layernorm(const void* x, long long ldx, const void* w, const void* b,
              void* y, long long ldy, int M, int C, int piece, int ahead,
              int blocks, float eps, void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x)
                          | reinterpret_cast<uintptr_t>(y);
  const int wide = 4 * (int)sizeof(T);
  const bool fits =
      piece == wide ? C % 4 == 0 && bases % wide == 0 && (ldx | ldy) % 4 == 0
                    : piece == (int)sizeof(T) && bases % sizeof(T) == 0;
  if (!fits || C <= 0 || C > kMaxC || M < 0 || blocks < 1 ||
      (ahead != 0 && ahead != 1) || (M > 1 && (ldx < C || ldy < C)) ||
      (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b)) % 4)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const Args<T> a{(const T*)x, ldx, (const float*)w, (const float*)b, (T*)y,
                  ldy, M, C, blocks, eps, (cudaStream_t)stream};
  return piece == wide ? by_ahead<T, 4>(ahead, a) : by_ahead<T, 1>(ahead, a);
}

}  // namespace

// ``piece`` (bytes: 8 or 2), ``ahead`` (0 or 1 rows loaded ahead) and
// ``blocks`` are the caller's plan (kernels/rdg_layernorm.py
// ``check_ln_layout`` and ``rdg_layernorm_plan``); a piece the bases or
// strides do not allow is refused, never narrowed here.
extern "C" int adsr_rdg_layernorm(const void* x, long long ldx, const void* w,
                                  const void* b, void* y, long long ldy, int M,
                                  int C, int piece, int ahead, int blocks,
                                  float eps, void* stream) {
  return layernorm<bf16>(x, ldx, w, b, y, ldy, M, C, piece, ahead, blocks,
                         eps, stream);
}

// The f32 instances (x and y float32): ``piece`` 16 (float4) or 4 bytes
extern "C" int adsr_rdg_layernorm_f32(const void* x, long long ldx,
                                      const void* w, const void* b, void* y,
                                      long long ldy, int M, int C, int piece,
                                      int ahead, int blocks, float eps,
                                      void* stream) {
  return layernorm<float>(x, ldx, w, b, y, ldy, M, C, piece, ahead, blocks,
                          eps, stream);
}

// How many blocks of the kernel for ``piece`` bytes an SM holds at once,
// without and with a row loaded ahead, into out[0] and out[1]
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: the registers ptxas gave
// each instance): 8 and 2 the bf16 instances, 16 and 4 the f32 ones
extern "C" int adsr_rdg_layernorm_blocks_per_sm(int piece, void* out) {
  int* n = (int*)out;
  switch (piece) {
    case 8: return blocks_per_sm<bf16, 4>(n);
    case 2: return blocks_per_sm<bf16, 1>(n);
    case 16: return blocks_per_sm<float, 4>(n);
    case 4: return blocks_per_sm<float, 1>(n);
    default: return (int)cudaErrorInvalidValue;
  }
}
