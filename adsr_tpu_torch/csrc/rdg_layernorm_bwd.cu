// rdg_layernorm_bwd: backward of the row LayerNorm over the first C columns
// of a row-strided bf16 or f32 buffer (eps 1e-6, affine unfolded).
//
//   x^ = (x - mean) * inv,  dy^ = gamma * dy
//   dx += inv * (dy^ - mean(dy^) - x^ * mean(dy^ * x^))  [+ dres]
//   dgamma = sum_rows dy * x^,  dbeta = sum_rows dy
//
// Replaces: the LayerNorm backward phases of the Pallas kernel _bwd_kernel
// (adsr_tpu/ops/fused_rdg_train.py:405-770), which fold the affine into
// the next matmul and so need no dgamma/dbeta; the port keeps the affine
// unfolded and emits them. The float instance (adsr_rdg_layernorm_bwd_f32)
// is that kernel at dtype f32, for fp32 training.
// Bound on H100: bytes (x in bf16 or f32, dy, dres and dx in f32, read
// once, dx written once; a few f32 ops an element).
// Design: a half-warp per row, so each warp has two rows' loads in flight;
// a lane holds four columns of each 64 (C <= 320: five float4 a lane),
// loads x as 8-byte bf16x4 (the f32 instance as float4), dy, dres and dx
// as float4 (C and every row stride are multiples of 4), and reads gamma
// once for all its rows. Statistics are recomputed from x in f32, two passes (mean,
// then the centred sum of squares), so nothing of the forward is saved;
// the four row sums are half-warp shuffles. dx is ADDED into a strided f32
// buffer (the concat gradient's prefix dcat[:, :c_k], or the residual-stream
// gradient), with an optional second gradient dres added in the same pass.
// The grid is a fixed number of blocks (kernels/rdg_layernorm_bwd.py
// ``rdg_layernorm_bwd_plan``: enough to fill the card) looping over row
// pairs. dgamma/dbeta: each lane sums its columns over its rows, the two
// half-warps and then the eight warps are added in a fixed order into one
// partial row a block, and partials.cuh's column mode sums the rows in
// order over many blocks (eight rows' loads in flight a thread), so the
// result is bitwise reproducible with no atomics. Nothing is allocated here
// and no state survives a launch (graph-capturable).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "partials.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerStep = 2 * kWarps;   // a half-warp per row
constexpr int kVec = 5;                    // float4 a lane: C <= 16 * 4 * 5
constexpr int kMaxC = 64 * kVec;

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 load_bf16x4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p) {
  return load_bf16x4(p);
}

__device__ __forceinline__ float4 load_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float sum4(float4 v) {
  return v.x + v.y + v.z + v.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rdg_layernorm_bwd_kernel(const T* __restrict__ x, long long ldx,
                         const float* __restrict__ dy, long long ldy,
                         const float* __restrict__ w,
                         const float* __restrict__ dres, long long ldr,
                         float* dx, long long ldo, float* __restrict__ part,
                         int M, int C, float eps) {
  __shared__ float4 red[kWarps][2][kMaxC / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, l = lane & 15;
  const int C4 = C / 4;
  float4 wv[kVec], pg[kVec], pb[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int q = l + 16 * i;
    wv[i] = q < C4 ? reinterpret_cast<const float4*>(w)[q]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    pg[i] = pb[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (long long base = ((long long)blockIdx.x * kWarps + warp) * 2;
       base < M; base += (long long)gridDim.x * kRowsPerStep) {
    const long long row = base + half;
    const bool ok = row < M;              // both halves stay for the shuffles
    float4 v[kVec], g[kVec];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int q = l + 16 * i;
      const bool in = ok && q < C4;
      v[i] = in ? load_x4(x + row * ldx + 4 * q)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      g[i] = in ? *reinterpret_cast<const float4*>(dy + row * ldy + 4 * q)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      s += sum4(v[i]);
    }
    const float mu = half_sum(s) / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (l + 16 * i < C4) {
        const float a = v[i].x - mu, b = v[i].y - mu, c = v[i].z - mu,
                    d = v[i].w - mu;
        sq += a * a + b * b + c * c + d * d;
      }
    }
    const float inv = rsqrtf(half_sum(sq) / C + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (l + 16 * i < C4) {
        float4& xh = v[i];                // x^ in place
        xh.x = (xh.x - mu) * inv;
        xh.y = (xh.y - mu) * inv;
        xh.z = (xh.z - mu) * inv;
        xh.w = (xh.w - mu) * inv;
        const float4 gh = make_float4(g[i].x * wv[i].x, g[i].y * wv[i].y,
                                      g[i].z * wv[i].z, g[i].w * wv[i].w);
        s1 += sum4(gh);
        s2 += gh.x * xh.x + gh.y * xh.y + gh.z * xh.z + gh.w * xh.w;
        if (ok) {
          pg[i].x += g[i].x * xh.x;
          pg[i].y += g[i].y * xh.y;
          pg[i].z += g[i].z * xh.z;
          pg[i].w += g[i].w * xh.w;
          pb[i].x += g[i].x;
          pb[i].y += g[i].y;
          pb[i].z += g[i].z;
          pb[i].w += g[i].w;
        }
      }
    }
    const float m1 = half_sum(s1) / C, m2 = half_sum(s2) / C;
    if (!ok) continue;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int q = l + 16 * i;
      if (q >= C4) continue;
      float4 d = make_float4(
          inv * (g[i].x * wv[i].x - m1 - v[i].x * m2),
          inv * (g[i].y * wv[i].y - m1 - v[i].y * m2),
          inv * (g[i].z * wv[i].z - m1 - v[i].z * m2),
          inv * (g[i].w * wv[i].w - m1 - v[i].w * m2));
      if (dres != nullptr) {
        const float4 r = *reinterpret_cast<const float4*>(dres + row * ldr
                                                          + 4 * q);
        d.x += r.x;
        d.y += r.y;
        d.z += r.z;
        d.w += r.w;
      }
      float4* o = reinterpret_cast<float4*>(dx + row * ldo + 4 * q);
      float4 cur = *o;
      cur.x += d.x;
      cur.y += d.y;
      cur.z += d.z;
      cur.w += d.w;
      *o = cur;
    }
  }

  // the two half-warps (a + b == b + a: both halves hold the same sums),
  // then the warps in order, into this block's partial row [dgamma | dbeta]
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int q = l + 16 * i;
    float4 a = pg[i], b = pb[i];
    a.x += __shfl_xor_sync(0xffffffffu, a.x, 16);
    a.y += __shfl_xor_sync(0xffffffffu, a.y, 16);
    a.z += __shfl_xor_sync(0xffffffffu, a.z, 16);
    a.w += __shfl_xor_sync(0xffffffffu, a.w, 16);
    b.x += __shfl_xor_sync(0xffffffffu, b.x, 16);
    b.y += __shfl_xor_sync(0xffffffffu, b.y, 16);
    b.z += __shfl_xor_sync(0xffffffffu, b.z, 16);
    b.w += __shfl_xor_sync(0xffffffffu, b.w, 16);
    if (half == 0 && q < C4) {
      red[warp][0][q] = a;
      red[warp][1][q] = b;
    }
  }
  __syncthreads();
  float* p = part + (long long)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) {
    const int which = c >= C, col = c - which * C;
    const float* r = reinterpret_cast<const float*>(&red[0][which][0]) + col;
    float acc = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) acc += r[wi * 2 * kMaxC];
    p[c] = acc;
  }
}

template <typename T>
int run(const void* x, long long ldx, const void* dy, long long ldy,
        const void* w, const void* dres, long long ldr, void* dx,
        long long ldo, void* part, void* dgamma, void* dbeta, int M, int C,
        int blocks, float eps, void* stream) {
  if (C <= 0 || C > kMaxC || C % 4 || M <= 0 || blocks < 1 || ldx % 4 ||
      ldy % 4 || ldo % 4 || (dres != nullptr && ldr % 4) ||
      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) ||
      reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(dx) % 16 ||
      reinterpret_cast<uintptr_t>(dres) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  rdg_layernorm_bwd_kernel<T><<<blocks, kThreads, 0, s>>>(
      (const T*)x, ldx, (const float*)dy, ldy, (const float*)w,
      (const float*)dres, ldr, (float*)dx, ldo, (float*)part, M, C, eps);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return sum_partials(nullptr, 0, 0, nullptr, 0, nullptr, s,
                      (const float*)part, blocks, 2 * C, (float*)dgamma, C,
                      (float*)dbeta);
}

}  // namespace

// ``blocks`` is the grid the caller planned (kernels/rdg_layernorm_bwd.py
// ``rdg_layernorm_bwd_plan``); ``part`` holds blocks * 2 * C f32. x is
// bf16 with an 8-byte aligned base.
extern "C" int adsr_rdg_layernorm_bwd(const void* x, long long ldx,
                                      const void* dy, long long ldy,
                                      const void* w, const void* dres,
                                      long long ldr, void* dx, long long ldo,
                                      void* part, void* dgamma, void* dbeta,
                                      int M, int C, int blocks, float eps,
                                      void* stream) {
  return run<__nv_bfloat16>(x, ldx, dy, ldy, w, dres, ldr, dx, ldo, part,
                            dgamma, dbeta, M, C, blocks, eps, stream);
}

// The same on an f32 x (fp32 training) with a 16-byte aligned base.
extern "C" int adsr_rdg_layernorm_bwd_f32(const void* x, long long ldx,
                                          const void* dy, long long ldy,
                                          const void* w, const void* dres,
                                          long long ldr, void* dx,
                                          long long ldo, void* part,
                                          void* dgamma, void* dbeta, int M,
                                          int C, int blocks, float eps,
                                          void* stream) {
  return run<float>(x, ldx, dy, ldy, w, dres, ldr, dx, ldo, part, dgamma,
                    dbeta, M, C, blocks, eps, stream);
}
