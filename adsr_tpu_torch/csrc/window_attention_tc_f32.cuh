// window_attention_tc_f32.cuh: shifted-window multi-head self-attention in
// full f32 over 4x4, 8x8 and 16x16 windows (N = 16, 64 and 256 tokens),
// every product f32-accurate as 3xTF32 on the tensor cores (mma.sync),
// reading q, k, v straight from the raster-order f32 qkv buffer and writing
// the f32 context into the head's columns of ``ctx``.
//
// Replaces: the attention phases of the Pallas kernel _rdg_kernel_impl
// (adsr_tpu/ops/fused_rdg.py:734-855) at dtype f32: per (window, head)
// scores with the relative-position bias and the shift mask, softmax,
// context, every product in f32.
// Bound on H100: bytes at N = 16 and 64 (each qkv row read once, each
// context row written once: ~0.1 ms an RDG at the flagship), operations at
// N = 256 (the two 256 x 256 x hd products a head: 82 GFLOP an RDG at
// 256px/x4, 0.50 ms as three TF32 products each at 495 TFLOP/s, 1.23 ms at
// the 67 TFLOP/s of f32 FFMA).
// Design: FlashAttention-2's forward, one source templated on N and on the
// head dim padded to a multiple of 16 (HDP). A block of R / 16 warps (R =
// min(N, 64): four warps at N = 64 and 256, one at N = 16) takes an
// (image, window, head, query tile of R rows); warp w owns query rows 16 w
// .. 16 w + 15 and never trades values with another warp. The block stages
// its query rows, then walks the window's keys in tiles of R (one tile at
// N <= 64, four at N = 256): S = Q K^T of its 16 rows x R keys on m16n8k8
// TF32 mma.sync (tf32_mma.cuh: each value split as its fragment loads into
// hi = x with its low 13 bits cleared and lo = x - hi, exact, of which the
// tensor cores read the top 19 bits; three products a pair), scaled, plus
// the bias and mask,
// in registers; the row's running max over the quad's lanes (two
// shuffles), P = expf(S - max) in f32 in place of S, the context's
// accumulators rescaled, and O += P V with S's accumulator tiles as the A
// operand in the paired order (frag_a_of_c / frag_b_cols) - P never
// touches shared memory. Each lane keeps a partial row sum; the quad adds
// them at the end. Rows are staged by cp.async in the 16-byte pieces that
// hold the head's columns, as they lie (head dim j at plane column j + (col
// & 3); every part of a head shares that offset, C % 4 == 0), two threads a
// row, into planes [R][HDP + 4] (the fragments' reads free of bank
// conflicts); q's and k's columns past the head dim are zeroed once a tile
// lands (v's only feed context columns that are never stored). At N = 256
// the next key tile lands while the softmax and P V run, and the next value
// tile while the next S runs: three planes, no double buffer. The context
// goes out a value at a time to the head's own columns (a head starts on
// any 4-byte column; head dims 30, 53, 122, 46, 77 at the flagship). The
// cyclic shift is index arithmetic on raster rows. The bias and mask come
// in the forms kernels/window_attention.py ``attn_operands`` gives: the
// full [nh, N, N] bias and [nW, N, N] mask at N = 16 and 64, the
// relative-position table [nh, 31 * 31] and the region labels [nW, 256]
// (int32, -100 between regions) at N = 256. At N = 256, for the training
// backward, it also writes each query row's softmax statistics (max, 1 /
// sum of exp(score - max)) into ``stats`` [B * nW, nh, N, 2] when given
// one (kernel (f) f32 reads them). No atomics: bitwise repeatable; nothing
// survives a launch (graph-capturable).
//
// One source a window includes this file (window_attention4_f32.cu,
// window_attention_f32.cu and window_attention16_f32.cu), so nvcc builds
// the three windows' instances in parallel. Kernel (g) f32
// (swin_block_f32.cuh) runs the same FlashAttention-2 core on its planes.

#pragma once

#include "tf32_mma.cuh"               // split, mma.sync, fragments, cp.async
#include "window_attention_f32.cuh"   // Geo, kPitch, token_row, attn_term

// switches of scripts/torch_attention_f32_sweep.py (TERM 0, STAGE 0 and the
// shared ATTN16_F32_X3 0 are timing only: such a variant computes something
// else)
#ifndef ATTN_F32_SPLIT
#define ATTN_F32_SPLIT 2          // 1: both rounded to nearest (tf32_mma.cuh)
#endif
#ifndef ATTN_F32_TERM
#define ATTN_F32_TERM 1           // 0: no bias / mask lookups and no exp
#endif
#ifndef ATTN_F32_STAGE
#define ATTN_F32_STAGE 1          // 0: no rows loaded (the planes stay 0)
#endif

namespace {

constexpr bool kTcTrunc = ATTN_F32_SPLIT == 2;

template <int N>
struct TcGeo {
  static constexpr int R = N < 64 ? N : 64;   // query rows, keys a tile
  static constexpr int kWarps = R / 16;
  static constexpr int kThreads = 32 * kWarps;  // two a staged row
  static constexpr int kTiles = N / R;          // key tiles = query tiles
  static constexpr int kKeyN8 = R / 8;          // n8 tiles of a key tile
};

// shared memory: the q, k and v planes [R][HDP + 4]
// (kernels/window_attention.py ``window_attention_f32_plan``)
template <int N, int HDP>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return 4ull * 3 * TcGeo<N>::R * kPitch<HDP>;
}

// blocks an SM asked of the registers: at N = 16 a thread within 128
// registers, at N >= 64 within 168 up to a head tile of 64 (128 spill
// there), else 255
template <int N, int HDP>
__host__ __device__ constexpr int tc_min_blocks() {
  return N == 16 ? 16 : (HDP <= 64 ? 3 : 2);
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// rows [t0, t0 + R) of a window's part (the head's hd columns from ``col``)
// into ``plane`` by cp.async, the 16-byte pieces as they lie: thread tid
// takes row tid / 2 and its pieces tid % 2, + 2, ..; one commit group
template <int N, int HDP>
__device__ __forceinline__ void tc_stage(float* plane,
                                         const float* __restrict__ qkv,
                                         long long ldq, int col, int b,
                                         int wi, int wj, int t0, int H,
                                         int W, int shift, int hd) {
  constexpr int P = kPitch<HDP>;
  const int r = threadIdx.x >> 1;
  const int pieces = ((col & 3) + hd + 3) / 4;
  const float* g = qkv + token_row<N>(b, wi, wj, t0 + r, H, W, shift) * ldq
                   + (col & ~3);
  for (int k = threadIdx.x & 1; ATTN_F32_STAGE && k < pieces; k += 2)
    cp_async_piece(plane + r * P + 4 * k, g + 4 * k);
  cp_async_commit_group();
}

// once this thread's copies into ``plane`` have landed: zero the columns
// past the head dim that its row's last piece brought (the thread that
// copied the piece; the caller synchronises the block before the plane is
// read)
template <int HDP>
__device__ __forceinline__ void tc_zero_tail(float* plane, int col, int hd) {
  constexpr int P = kPitch<HDP>;
  const int end = (col & 3) + hd, pieces = (end + 3) / 4;
  if (4 * pieces == end || (threadIdx.x & 1) != ((pieces - 1) & 1)) return;
  float* row = plane + (threadIdx.x >> 1) * P;
  for (int x = end; x < 4 * pieces; ++x) row[x] = 0.f;
}

template <int N, int HDP>
__global__ void __launch_bounds__(TcGeo<N>::kThreads,
                                  tc_min_blocks<N, HDP>())
window_attention_f32_kernel(const float* __restrict__ qkv, long long ldq,
                   float* __restrict__ ctx, long long ldc,
                   const float* __restrict__ bias,
                   const void* __restrict__ mask, float* __restrict__ stats,
                   int H, int W, int C, int nh, int hd, int shift,
                   float scale) {
  using G = TcGeo<N>;
  constexpr int R = G::R, P = kPitch<HDP>, KT = HDP / 8, KN = G::kKeyN8;
  constexpr int kTiles = G::kTiles, T = G::kThreads;
  static_assert(HDP % 16 == 0 && HDP <= 128 && T == 2 * R, "layout");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + R * P;
  float* vs = ks + R * P;

  const int nww = W / Geo<N>::kWin;
  const int nw = (H / Geo<N>::kWin) * nww;
  int bid = blockIdx.x;
  const int qt = bid % kTiles;
  bid /= kTiles;
  const int h = bid % nh;
  const int gw = bid / nh;                // image * nW + window
  const int b = gw / nw, win = gw % nw;
  const int wi = win / nww, wj = win % nww;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col = h * hd, sc = col & 3, t0 = qt * R;

  // the planes start zeroed: columns past a row's last piece stay zero
  for (int i = tid; i < 3 * R * P / 4; i += T)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  tc_stage<N, HDP>(qs, qkv, ldq, col, b, wi, wj, t0, H, W, shift, hd);
  tc_stage<N, HDP>(ks, qkv, ldq, C + col, b, wi, wj, 0, H, W, shift, hd);
  tc_stage<N, HDP>(vs, qkv, ldq, 2 * C + col, b, wi, wj, 0, H, W, shift, hd);
  cp_async_wait_group<1>();               // q and key tile 0
  tc_zero_tail<HDP>(qs, col, hd);
  tc_zero_tail<HDP>(ks, col, hd);
  __syncthreads();

  const int r0 = 16 * warp;               // the warp's rows of the tile
  const int qi[2] = {t0 + r0 + g, t0 + r0 + g + 8};   // window tokens
  // N = 256: the head's table centred at index 480 and the window's labels
  const float* tab = bias + h * 961 + 480;
  const int* lab = N == 256 && mask != nullptr
                       ? static_cast<const int*>(mask) + (size_t)win * N
                       : nullptr;
  int rel_q[2] = {0, 0}, lab_q[2] = {0, 0};
  if constexpr (N == 256) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      rel_q[x] = 31 * (qi[x] >> 4) + (qi[x] & 15);
      if (lab != nullptr) lab_q[x] = __ldg(lab + qi[x]);
    }
  }

  float o[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < kTiles; ++kt) {
    // S = Q K^T over the head dims: the warp's 16 rows x the tile's keys,
    // four n8 key tiles a round
    float s[KN][4];
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ah[4], al[4];
      frag_a<P, kTcTrunc>(qs + sc, r0, 8 * kk, ah, al);
#pragma unroll
      for (int j0 = 0; j0 < KN; j0 += 4) {
        constexpr int kJ = KN < 4 ? KN : 4;
        uint32_t bh[kJ][2], bl[kJ][2];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          frag_b_rows<P, kTcTrunc>(ks + sc, 8 * (j0 + j), 8 * kk, bh[j],
                                   bl[j]);
#if ATTN16_F32_X3
#pragma unroll
        for (int j = 0; j < kJ; ++j) mma_tf32(s[j0 + j], al, bh[j]);
#pragma unroll
        for (int j = 0; j < kJ; ++j) mma_tf32(s[j0 + j], ah, bl[j]);
#endif
#pragma unroll
        for (int j = 0; j < kJ; ++j) mma_tf32(s[j0 + j], ah, bh[j]);
      }
    }
    if (kt + 1 < kTiles) {
      __syncthreads();                    // every warp is done with k
      tc_stage<N, HDP>(ks, qkv, ldq, C + col, b, wi, wj, (kt + 1) * R, H, W,
                       shift, hd);
      cp_async_wait_group<1>();           // this tile's v (the next k may
    } else {                              // still be on its way)
      cp_async_wait_group<0>();
    }
    __syncthreads();

    // scale, bias (+ mask), the online softmax of each row over the tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KN; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = kt * R + 8 * j + 2 * t + c;
        if constexpr (!ATTN_F32_TERM) {
#pragma unroll
          for (int x = 0; x < 2; ++x) s[j][2 * x + c] *= scale;
        } else if constexpr (N == 256) {
          const int rel_k = 31 * (kj >> 4) + (kj & 15);
          const int lab_k = lab != nullptr ? __ldg(lab + kj) : 0;
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float term = __ldg(tab + rel_q[x] - rel_k);
            if (lab_k != lab_q[x]) term += kMaskOff;
            s[j][2 * x + c] = s[j][2 * x + c] * scale + term;
          }
        } else {
#pragma unroll
          for (int x = 0; x < 2; ++x)
            s[j][2 * x + c] = s[j][2 * x + c] * scale
                              + attn_term<N>(bias, mask, h, win, qi[x], kj);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) mx[x] = fmaxf(mx[x], s[j][2 * x + c]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      const float m_new = fmaxf(m_run[x], mx[x]);
      alpha[x] = expf(m_run[x] - m_new);  // 0 on the first tile
      m_run[x] = m_new;
      l_run[x] *= alpha[x];
    }
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ATTN_F32_TERM ? expf(s[j][e] - m_run[e >> 1])
                                      : s[j][e] - m_run[e >> 1];
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P V over the tile's keys, four n8 head-dim tiles a round
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      uint32_t ah[4], al[4];
      frag_a_of_c<kTcTrunc>(s[j][0], s[j][1], s[j][2], s[j][3], ah, al);
#pragma unroll
      for (int n0 = 0; n0 < KT; n0 += 4) {
        uint32_t bh[4][2], bl[4][2];      // (KT is even: n0 + 1 < KT)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n0 + n < KT)
            frag_b_cols<P, kTcTrunc>(vs + sc, 8 * j, 8 * (n0 + n), bh[n],
                                     bl[n]);
#if ATTN16_F32_X3
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n0 + n < KT) mma_tf32(o[n0 + n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n0 + n < KT) mma_tf32(o[n0 + n], ah, bl[n]);
#endif
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n0 + n < KT) mma_tf32(o[n0 + n], ah, bh[n]);
      }
    }
    if (kt + 1 < kTiles) {
      __syncthreads();                    // every warp is done with v
      tc_stage<N, HDP>(vs, qkv, ldq, 2 * C + col, b, wi, wj, (kt + 1) * R, H,
                       W, shift, hd);
      cp_async_wait_group<1>();           // the next tile's k
      tc_zero_tail<HDP>(ks, col, hd);
      __syncthreads();
    }
  }

  float inv[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float l = l_run[x];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[x] = 1.f / l;
  }
  // each query row's (max, 1 / sum), the statistics kernel (f) reads
  if (stats != nullptr && t == 0) {
    float2* st = reinterpret_cast<float2*>(stats)
                 + ((size_t)gw * nh + h) * N;
#pragma unroll
    for (int x = 0; x < 2; ++x) st[qi[x]] = make_float2(m_run[x], inv[x]);
  }
  // the context: rows g and g + 8 of the warp's, head dims 8 n + 2 t (+ 1)
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float* dst = ctx + token_row<N>(b, wi, wj, qi[x], H, W, shift) * ldc
                 + col;
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * n + 2 * t + c;
        if (d < hd) dst[d] = o[n][2 * x + c] * inv[x];
      }
  }
}

template <int N, int HDP>
int tc_launch(const void* qkv, long long ldq, void* ctx, long long ldc,
              const void* bias, const void* mask, void* stats, int B, int H,
              int W, int C, int nh, int hd, int shift, long long smem,
              cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<N, HDP>();
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
      (long long)B * (H / kWin) * (W / kWin) * nh * TcGeo<N>::kTiles;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  window_attention_f32_kernel<N, HDP>
      <<<(unsigned)blocks, TcGeo<N>::kThreads, bytes, stream>>>(
          (const float*)qkv, ldq, (float*)ctx, ldc, (const float*)bias, mask,
          (float*)stats, H, W, C, nh, hd, shift,
          (float)(1.0 / std::sqrt((double)hd)));
  return (int)cudaGetLastError();
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
  constexpr int N = kWin * kWin;
  const int hd = C / nh;
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
#define ADSR_HDP(K)                                                         \
    case K: return tc_launch<N, 16 * K>(qkv, ldq, ctx, ldc, bias, mask,     \
                                        stats, B, H, W, C, nh, hd, shift,   \
                                        smem, s);
    ADSR_HDP(1) ADSR_HDP(2) ADSR_HDP(3) ADSR_HDP(4)
    ADSR_HDP(5) ADSR_HDP(6) ADSR_HDP(7) ADSR_HDP(8)
#undef ADSR_HDP
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
