// window_attention_f32.cuh: shifted-window multi-head self-attention in
// full f32 over 4x4, 8x8 and 16x16 windows (N = 16, 64 and 256 tokens),
// reading q, k, v straight from the raster-order f32 qkv buffer and writing
// the f32 context in place of the head's columns.
//
// Replaces: the attention phases of the Pallas kernel _rdg_kernel_impl
// (adsr_tpu/ops/fused_rdg.py:734-855) at dtype f32: per (window, head)
// scores with the relative-position bias and the shift mask, softmax,
// context, every product in f32.
// Bound on H100: bytes at N = 16 and 64 (each qkv row read once, each
// context row written once: ~0.1 ms an RDG at the flagship), operations at
// N = 256 (the two products of 256 x 256 per head in f32 FFMA).
// Design: one block of 256 threads per (image, window, head, query tile of
// R = min(N, 64) rows), one source templated on N and on the head dim
// padded to a multiple of 16. The block stages its R query rows, then
// walks the window's keys in tiles of R (one tile at N <= 64, four at N =
// 256) with FlashAttention's online softmax: scores of the tile into shared
// memory (a 4 x 4 register tile a thread at R = 64, float4 reads over the
// head dim), each row's running max and sum updated by 256 / R lanes (4
// at R = 64, 16 at R = 16), P = expf(S - max) kept in f32, the f32 context
// (a thread's rows and four head dims in registers) rescaled as the max
// grows, and divided by the row sum at the end. q, k and v of a head start on any 4-byte
// column (head dims 30, 53, 122, 46, 77 at the flagship): rows are read in
// the 16-byte pieces that hold the head's columns (qkv rows have a pitch
// that is a multiple of 4 floats), and the head is sliced out of them in
// registers into the shared planes, zero-padded; the context goes back in
// scalar stores to the head's own columns. The cyclic shift is index
// arithmetic on raster rows (as in window_attention.cu). The bias and mask
// come in the forms kernels/window_attention.py ``attn_operands`` gives: the
// full [nh, N, N] bias and [nW, N, N] mask at N = 16 and 64, the
// relative-position table [nh, 31 * 31] and the region labels [nW, 256]
// (int32, -100 between regions) at N = 256. At N = 256, for the training
// backward, it also writes each query row's softmax statistics (max, 1 /
// sum of exp(score - max)) into ``stats`` [B * nW, nh, N, 2] when given
// one, as the bf16 kernel does (kernel (f) reads them). No atomics:
// bitwise repeatable; nothing survives a launch (graph-capturable).
//
// The kernel and its launch live here; one source a window includes it
// (window_attention4_f32.cu, window_attention_f32.cu and
// window_attention16_f32.cu), so nvcc builds the three windows' instances
// in parallel. Its key-tile body (attend_scores, attend_pv) is also kernel
// (g) f32's attention (swin_block_f32.cuh).

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;
constexpr float kMaskOff = -100.f;        // between regions at N = 256

template <int N>
struct Geo {
  static constexpr int kWin = N == 16 ? 4 : (N == 64 ? 8 : 16);
  static constexpr int R = N < 64 ? N : 64;   // query rows, keys a tile
  static constexpr int kTiles = N / R;        // key tiles = query tiles
  static constexpr int kSP = R + 4;           // floats a row of S
};

// floats a row of the q, k and v planes: the padded head dim and 4 more, so
// eight consecutive rows start in eight different 16-byte bank groups
template <int HDP>
constexpr int kPitch = HDP + 4;

// shared memory: the q, k and v planes [R][HDP + 4], the scores [R][R + 4]
// and each row's running max, sum and rescale factor
template <int N, int HDP>
__host__ __device__ constexpr size_t smem_bytes() {
  return 4ull * (3 * Geo<N>::R * kPitch<HDP> + Geo<N>::R * Geo<N>::kSP
                 + 3 * Geo<N>::R);
}

template <int N>
__device__ __forceinline__ long long token_row(int b, int wi, int wj, int t,
                                               int H, int W, int shift) {
  constexpr int kWin = Geo<N>::kWin;
  const int r = t / kWin, s = t % kWin;
  const int row = (wi * kWin + r + shift) % H;
  const int col = (wj * kWin + s + shift) % W;
  return (long long)b * H * W + (long long)row * W + col;
}

// rows [t0, t0 + R) of the window's part ``part`` (0 q, 1 k, 2 v) into the
// plane: the 16-byte pieces of each row that hold the head's hd columns,
// each value kept where it falls in [0, hd)
template <int N, int HDP>
__device__ __forceinline__ void stage_rows(float* plane,
                                           const float* __restrict__ qkv,
                                           long long ldq, int b, int wi,
                                           int wj, int t0, int H, int W,
                                           int shift, int col, int hd) {
  constexpr int R = Geo<N>::R;
  const int lo = col & ~3;
  const int pieces = (col + hd - lo + 3) / 4;
  for (int i = threadIdx.x; i < R * pieces; i += kThreads) {
    const int r = i / pieces, k = i - r * pieces;
    const int c0 = lo + 4 * k;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        qkv + token_row<N>(b, wi, wj, t0 + r, H, W, shift) * ldq + c0));
    const float e[4] = {v.x, v.y, v.z, v.w};
    float* dst = plane + r * kPitch<HDP>;
    const int j0 = c0 - col;              // head dim of e[0]
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (j0 + x >= 0 && j0 + x < hd) dst[j0 + x] = e[x];
  }
}

// the additive term of query qi and key kj (window-local token indices)
template <int N>
__device__ __forceinline__ float attn_term(const float* __restrict__ bias,
                                           const void* __restrict__ mask,
                                           int h, int win, int qi, int kj) {
  if constexpr (N == 256) {
    constexpr int kW = Geo<N>::kWin, kT = 2 * kW - 1;
    const int idx = (qi / kW - kj / kW + kW - 1) * kT + (qi % kW - kj % kW)
                    + kW - 1;
    float t = __ldg(bias + h * kT * kT + idx);
    if (mask != nullptr) {
      const int* lab = static_cast<const int*>(mask) + (size_t)win * N;
      if (__ldg(lab + qi) != __ldg(lab + kj)) t += kMaskOff;
    }
    return t;
  } else {
    float t = __ldg(bias + ((size_t)h * N + qi) * N + kj);
    if (mask != nullptr)
      t += __ldg(static_cast<const float*>(mask) + ((size_t)win * N + qi) * N
                 + kj);
    return t;
  }
}

// The thread maps of the online-softmax core (attend_scores, attend_pv) for
// N keys a window and head dims padded to HDP, on a block of kThreads
// threads
template <int N, int HDP>
struct Attend {
  static constexpr int R = Geo<N>::R, SP = Geo<N>::kSP, P = kPitch<HDP>;
  // scores: a 16 x 16 grid of threads, SR x SR scores each
  static constexpr int SR = R / 16;
  // softmax: TPR lanes a row, KPT keys each
  static constexpr int TPR = kThreads / R, KPT = R / TPR;
  // P @ V: a thread takes four head dims (group dg of G4) of RPT rows RS
  // apart
  static constexpr int G4 = HDP / 4, RS = kThreads / G4;
  static constexpr int RPT = (R + RS - 1) / RS;
};

// One key tile of the online softmax, the core of kernel (c) f32 and of
// kernel (g) f32 (swin_block_f32.cuh), in two halves. attend_scores: the R
// query rows of ``qs`` (window tokens q0 ..) against the R keys of ``ks``
// (window tokens k0 ..), planes [R][P] zero past the head dim: S = scale q
// k^T + bias (+ mask) into ``ss`` as P = exp(S - max), each row's running
// max and sum updated and its rescale factor in ``row_alpha``. The caller
// has synchronised the block after filling the planes and setting row_max
// to -inf and row_sum to 0; this ends with a barrier, so ``ks`` may be
// refilled after it. attend_pv: the context ``o`` (this thread's rows and
// four head dims) rescaled and accumulated over the tile's values ``vs``;
// it ends with a barrier, so ``vs`` and ``ss`` may be refilled after it.
template <int N, int HDP>
__device__ __forceinline__ void attend_scores(
    const float* qs, const float* ks, float* ss, float* row_max,
    float* row_sum, float* row_alpha, const float* __restrict__ bias,
    const void* __restrict__ mask, int h, int win, int q0, int k0,
    float scale) {
  using A = Attend<N, HDP>;
  constexpr int SP = A::SP, P = A::P, SR = A::SR;
  constexpr int TPR = A::TPR, KPT = A::KPT;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;          // scores
  const int srow = tid / TPR, spart = tid % TPR;   // softmax

  // S = scale * q k^T + bias (+ mask)
  float s[SR][SR];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SR; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; d += 4) {
    float4 q4[SR], k4[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i)
      q4[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * P + d);
#pragma unroll
    for (int j = 0; j < SR; ++j)
      k4[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * P + d);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        float v = s[i][j];
        v = fmaf(q4[i].x, k4[j].x, v);
        v = fmaf(q4[i].y, k4[j].y, v);
        v = fmaf(q4[i].z, k4[j].z, v);
        s[i][j] = fmaf(q4[i].w, k4[j].w, v);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < SR; ++j) {
      const int c = tx + 16 * j;
      ss[r * SP + c] = s[i][j] * scale
                       + attn_term<N>(bias, mask, h, win, q0 + r, k0 + c);
    }
  }
  __syncthreads();

  // the online softmax of each row over this tile: TPR lanes a row
  {
    float* sr = ss + srow * SP;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) mx = fmaxf(mx, sr[spart + TPR * j]);
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = row_max[srow];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float e = expf(sr[spart + TPR * j] - m_new);
      sr[spart + TPR * j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
    if (spart == 0) {
      const float alpha = expf(m_old - m_new);    // 0 on the first tile
      row_alpha[srow] = alpha;
      row_sum[srow] = row_sum[srow] * alpha + sum;
      row_max[srow] = m_new;
    }
  }
  __syncthreads();
}

template <int N, int HDP>
__device__ __forceinline__ void attend_pv(
    const float* vs, const float* ss, const float* row_alpha,
    float (&o)[Attend<N, HDP>::RPT][4]) {
  using A = Attend<N, HDP>;
  constexpr int R = A::R, SP = A::SP, P = A::P, G4 = A::G4, RS = A::RS;
  constexpr int RPT = A::RPT;
  const int tid = threadIdx.x;
  const int dg = tid % G4, r0 = tid / G4;
  const bool pv = tid < RS * G4;

  // o = alpha o + P v over this tile's keys
  if (pv) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + RS * i;
      if (r < R) {
        const float alpha = row_alpha[r];
#pragma unroll
        for (int x = 0; x < 4; ++x) o[i][x] *= alpha;
      }
    }
#pragma unroll 4
    for (int k = 0; k < R; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(vs + k * P + 4 * dg);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = r0 + RS * i;
        if (r < R) {
          const float pk = ss[r * SP + k];
          o[i][0] = fmaf(pk, v.x, o[i][0]);
          o[i][1] = fmaf(pk, v.y, o[i][1]);
          o[i][2] = fmaf(pk, v.z, o[i][2]);
          o[i][3] = fmaf(pk, v.w, o[i][3]);
        }
      }
    }
  }
  __syncthreads();                        // before the next tile's loads
}

// a whole key tile: attend_scores, then attend_pv
template <int N, int HDP>
__device__ __forceinline__ void attend_tile(
    const float* qs, const float* ks, const float* vs, float* ss,
    float* row_max, float* row_sum, float* row_alpha,
    float (&o)[Attend<N, HDP>::RPT][4], const float* __restrict__ bias,
    const void* __restrict__ mask, int h, int win, int q0, int k0,
    float scale) {
  attend_scores<N, HDP>(qs, ks, ss, row_max, row_sum, row_alpha, bias, mask,
                        h, win, q0, k0, scale);
  attend_pv<N, HDP>(vs, ss, row_alpha, o);
}

template <int N, int HDP>
__global__ void __launch_bounds__(kThreads)
window_attention_f32_kernel(const float* __restrict__ qkv, long long ldq,
                            float* __restrict__ ctx, long long ldc,
                            const float* __restrict__ bias,
                            const void* __restrict__ mask,
                            float* __restrict__ stats, int H, int W,
                            int C, int nh, int hd, int shift, float scale) {
  using G = Geo<N>;
  using A = Attend<N, HDP>;
  constexpr int R = G::R, SP = G::kSP, P = kPitch<HDP>;
  constexpr int G4 = A::G4, RS = A::RS, RPT = A::RPT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + R * P;
  float* vs = ks + R * P;
  float* ss = vs + R * P;
  float* row_max = ss + R * SP;
  float* row_sum = row_max + R;
  float* row_alpha = row_sum + R;

  const int nww = W / G::kWin;
  const int nw = (H / G::kWin) * nww;
  int bid = blockIdx.x;
  const int qt = bid % G::kTiles;
  bid /= G::kTiles;
  const int h = bid % nh;
  bid /= nh;
  const int win = bid % nw;
  const int b = bid / nw;
  const int wi = win / nww, wj = win % nww;
  const int tid = threadIdx.x;

  // the padded head dims are zero in every plane, and stay so (the staged
  // rows write head dims below hd only)
  if (HDP > hd) {
    const int pad = HDP - hd;
    for (int i = tid; i < 3 * R * pad; i += kThreads) {
      const int row = i / pad;            // (plane, row)
      qs[row * P + hd + (i - row * pad)] = 0.f;
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    row_max[r] = -INFINITY;
    row_sum[r] = 0.f;
  }
  __syncthreads();
  const int col = h * hd;
  stage_rows<N, HDP>(qs, qkv, ldq, b, wi, wj, qt * R, H, W, shift, col, hd);

  const int dg = tid % G4, r0 = tid / G4;          // P @ V
  const bool pv = tid < RS * G4;
  float o[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[i][x] = 0.f;

  for (int kt = 0; kt < G::kTiles; ++kt) {
    stage_rows<N, HDP>(ks, qkv, ldq, b, wi, wj, kt * R, H, W, shift, C + col,
                       hd);
    stage_rows<N, HDP>(vs, qkv, ldq, b, wi, wj, kt * R, H, W, shift,
                       2 * C + col, hd);
    __syncthreads();
    attend_tile<N, HDP>(qs, ks, vs, ss, row_max, row_sum, row_alpha, o, bias,
                        mask, h, win, qt * R, kt * R, scale);
  }

  // each query row's (max, 1 / sum), the statistics kernel (f) reads
  if (stats != nullptr) {
    for (int r = tid; r < R; r += kThreads) {
      float2* st = reinterpret_cast<float2*>(stats)
                   + ((size_t)(b * nw + win) * nh + h) * N + qt * R + r;
      *st = make_float2(row_max[r], 1.f / row_sum[r]);
    }
  }
  // the context: this thread's rows, head dims 4 dg .. 4 dg + 3 below hd
  if (pv) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + RS * i;
      if (r >= R) continue;
      const float inv = 1.f / row_sum[r];
      float* dst = ctx + token_row<N>(b, wi, wj, qt * R + r, H, W, shift)
                   * ldc + col;
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (4 * dg + x < hd) dst[4 * dg + x] = o[i][x] * inv;
    }
  }
}

template <int N, int HDP>
int launch(const void* qkv, long long ldq, void* ctx, long long ldc,
           const void* bias, const void* mask, void* stats, int B, int H,
           int W, int C,
           int nh, int hd, int shift, long long smem, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<N, HDP>();
  static_assert(bytes <= kMaxSmem, "window_attention_f32: shared memory");
  if ((long long)bytes != smem) return (int)cudaErrorInvalidValue;
  static bool configured = false;         // per template instance
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_attention_f32_kernel<N, HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  constexpr int kWin = Geo<N>::kWin;
  const long long blocks =
      (long long)B * (H / kWin) * (W / kWin) * nh * Geo<N>::kTiles;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  window_attention_f32_kernel<N, HDP>
      <<<(unsigned)blocks, kThreads, bytes, stream>>>(
          (const float*)qkv, ldq, (float*)ctx, ldc, (const float*)bias, mask,
          (float*)stats, H, W, C, nh, hd, shift,
          (float)(1.0 / std::sqrt((double)hd)));
  return (int)cudaGetLastError();
}

template <int N>
int by_head(int hd, const void* qkv, long long ldq, void* ctx, long long ldc,
            const void* bias, const void* mask, void* stats, int B, int H,
            int W, int C, int nh, int shift, long long smem,
            cudaStream_t s) {
  switch ((hd + 15) / 16) {
#define ADSR_HDP(K) \
    case K: return launch<N, 16 * K>(qkv, ldq, ctx, ldc, bias, mask, stats, \
                                     B, H, W, C, nh, hd, shift, smem, s);
    ADSR_HDP(1) ADSR_HDP(2) ADSR_HDP(3) ADSR_HDP(4)
    ADSR_HDP(5) ADSR_HDP(6) ADSR_HDP(7) ADSR_HDP(8)
#undef ADSR_HDP
    default: return (int)cudaErrorInvalidValue;
  }
}


// The checks and launch of the C entry of window ``kWin`` (N = kWin^2):
// ``bias`` and ``mask`` in the forms above (``mask`` null at shift 0);
// ``smem`` the shared memory the caller planned
// (kernels/window_attention.py ``window_attention_f32_plan``): a launch
// whose plan differs from this file's layout is refused. qkv and ctx have
// 16-byte aligned bases and row strides that are multiples of 4 floats.
// ``stats`` (or null) takes the softmax statistics, at N = 256 only.
template <int kWin>
int entry(const void* qkv, long long ldq, void* ctx, long long ldc,
          const void* bias, const void* mask, void* stats, int B, int H,
          int W, int C, int nh, int win, int shift, long long smem,
          void* stream) {
  if (win != kWin || H % win || W % win || nh <= 0 || C % nh || C % 4 ||
      B < 0 || shift < 0 || shift >= win || (shift > 0) != (mask != nullptr) ||
      ldq % 4 || ldc % 4 || ldq < 3ll * C || ldc < C || C / nh > 128 ||
      (stats != nullptr && kWin != 16) ||
      reinterpret_cast<uintptr_t>(stats) % 8 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(ctx) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return by_head<kWin * kWin>(C / nh, qkv, ldq, ctx, ldc, bias, mask, stats,
                              B, H, W, C, nh, shift, smem,
                              (cudaStream_t)stream);
}

}  // namespace
