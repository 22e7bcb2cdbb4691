// window_attention at 16x16 windows (N = 256 tokens): kernel (c)'s second
// geometry (the 8x8 one is window_attention.cu), and the softmax statistics
// that kernel (f) at N = 256 (window_attention_bwd16.cu) reads.
//
// Replaces: the attention phases of the Pallas kernel _rdg_kernel_impl
// (adsr_tpu/ops/fused_rdg.py:734-855) at L = 4096: per (window, head)
// scores with the relative-position bias and the shift mask, softmax,
// context.
// Bound on H100: bytes. Each qkv row is read once and each context row
// written once; the two 256-key products are ~256 flop per byte of q, k, v,
// still below the bf16 ridge. The relative-position bias comes as its
// head's 961-entry table and the shift mask as the window's 256 region
// labels (attn16.cuh), both looked up in shared memory: their [256][256]
// f32 forms (0.25 MB each of L2 reads a (window, head)) are never read.
//
// Design: one block per (image, window, head), two consumer warpgroups.
// The window's K and V (four 64-key tiles each) are gathered once into
// swizzled tiles (attn16.cuh) and stay: tile kt + 1's raw pieces are
// cp.async-staged while the warpgroups run tile kt's products, then
// unpacked. Warpgroup w takes query tiles w and w + 2, one after the other
// (the first Q tile gathered straight from global memory, the second staged
// once the key tiles are in), and walks the four key tiles with
// FlashAttention-2's online softmax:
//   - S = Q K^T on wgmma m64n64k16 from shared memory;
//   - x = S * scale + bias (+ mask), the row max m grown to the tile's,
//     e = exp(x - m) in f32, the row sum l and the f32 context rescaled by
//     exp(m_old - m);
//   - e rounded once to bf16 is the register A of O += e V (wgmma
//     m64nHDPk16, V read MN-major from the same tile);
//   - O / l at the end, over the warpgroup's Q tile (swizzled), back to the
//     context's rows in 16-byte stores.
// With ``stats`` the block also writes each query row's (m, 1 / l) per head
// as float2 (the training backward's recompute passes it; serving passes
// null). The numerics are PR 7's N = 256 kernel's: P rounded to bf16
// unnormalised, normalised in f32 after P V, f32 statistics and
// accumulation. 256 threads a block; two blocks an SM up to a head tile of
// 64, one above (shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn16.cuh"

namespace {

constexpr int kWin = 16;
constexpr int N = kWin * kWin;            // tokens a window
constexpr int kKeyTiles = N / kTileRows;  // 4
constexpr int kGroups = 2;                // consumer warpgroups a block
constexpr int kThreads = 128 * kGroups;
constexpr bool kBias = true;              // the bias and mask terms at all
constexpr bool kStore = true;             // the context stores
constexpr size_t kMaxSmem = 232448;

typedef __nv_bfloat16 bf16;

// Shared memory of a block: 1024 bytes of alignment, the window's K and V
// (four tiles each) and two Q tiles, the staging of one K and one V tile
// (after the last key tile, each warpgroup's next Q tile), the head's
// relative-position table and the window's region labels
__host__ __device__ constexpr size_t smem16(int hdp) {
  return 1024 + (size_t)10 * swz_bytes(hdp) + (size_t)2 * stage_slots(hdp) * 16
         + kRelTableBytes + kLabelBytes;
}

__host__ __device__ constexpr int min_blocks16(int hdp) {
  return hdp <= 64 ? 2 : 1;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, min_blocks16(HDP))
window_attention16_kernel(const bf16* __restrict__ qkv, long long ldq,
                          bf16* __restrict__ ctx, long long ldc,
                          const float* __restrict__ table,
                          const int* __restrict__ labels,
                          float2* __restrict__ stats, int H, int W, int C,
                          int nh, int hd, int shift, float scale) {
  constexpr uint32_t TB = swz_bytes(HDP);
  constexpr uint32_t kStage = 16u * stage_slots(HDP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = swz_base(smem_raw);
  unsigned char* smem = smem_raw + (base - (uint32_t)__cvta_generic_to_shared(
                                               smem_raw));
  const uint32_t sk = base, sv = base + 4 * TB, sst = base + 10 * TB;

  const int nww = W / kWin;
  const int nw = (H / kWin) * nww;
  const int h = blockIdx.x % nh;
  const int win = (blockIdx.x / nh) % nw;
  const int b = blockIdx.x / (nh * nw);
  const int C3 = 3 * C, s0 = h * hd;
  const WinRows<kWin> rows{(long long)b * H * W, (win / nww) * kWin + shift,
                           (win % nww) * kWin + shift, H, W};
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int ok = (s0 + C) & 7, ov = (s0 + 2 * C) & 7;

  auto stage_kv = [&](int kt) {
    stage_raw<kWin>(sst, qkv, ldq, C3, s0 + C, hd, rows, kt * kTileRows, tid,
                    kThreads);
    stage_raw<kWin>(sst + kStage, qkv, ldq, C3, s0 + 2 * C, hd, rows,
                    kt * kTileRows, tid, kThreads);
    stage_commit();
  };
  stage_kv(0);

  constexpr int kPasses = kKeyTiles / kGroups;
  const uint32_t sq = base + (8 + wg) * TB;
  // a warpgroup's next Q tile, staged in its half of the staging area once
  // the window's K and V are unpacked
  const uint32_t sqs = sst + wg * kStage;
  const int oq = s0 & 7;
  auto stage_q = [&](int pass) {
    stage_raw<kWin>(sqs, qkv, ldq, C3, s0, hd, rows,
                    (wg + kGroups * pass) * kTileRows, wtid, 128);
    stage_commit();
  };
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* tab = reinterpret_cast<float*>(smem + 10 * TB + 2 * kStage);
  int* lab = reinterpret_cast<int*>(tab) + kRelTableBytes / 4;
  load_rel_table(tab, table + (size_t)h * kRelTable, tid, kThreads);
  const bool masked = kBias && labels != nullptr;
  if (masked)
    for (int i = tid; i < N; i += kThreads) lab[i] = labels[(size_t)win * N + i];

  for (int pass = 0; pass < kPasses; ++pass) {
    const int qt = wg + kGroups * pass;
    if (pass == 0) {
      load_swz<HDP, kWin>(sq, qkv, ldq, C3, s0, hd, rows, qt * kTileRows,
                          wtid, 128);
    } else {
      stage_wait_all();
      wg_sync(wg);
      unpack_swz<HDP>(sq, sqs, oq, hd, wtid, 128);
    }
    fence_async_smem();
    wg_sync(wg);
    if (pass > 0 && pass + 1 < kPasses) stage_q(pass + 1);
    const int r = qt * kTileRows + 16 * (wtid >> 5) + g;   // rows r, r + 8
    const int ar = rel_pos(r) + kRelCentre;                 // (r + 8: + 8)
    float mx0 = -INFINITY, mx1 = -INFINITY, sum0 = 0.f, sum1 = 0.f;
    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;

    for (int kt = 0; kt < kKeyTiles; ++kt) {
      if (pass == 0) {      // tile kt staged: into the window's K and V
        stage_wait_all();
        __syncthreads();
        unpack_swz<HDP>(sk + kt * TB, sst, ok, hd, tid, kThreads);
        unpack_swz<HDP>(sv + kt * TB, sst + kStage, ov, hd, tid, kThreads);
        fence_async_smem();
        __syncthreads();
        if (kt + 1 < kKeyTiles)
          stage_kv(kt + 1);   // lands meanwhile
        else if (kPasses > 1)
          stage_q(1);
      }
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wg_fence_acc(s);
      wg_fence();
      wg_scores<HDP>(s, sq, sk + kt * TB);
      wg_commit();
      wg_wait0();
      wg_fence_acc(s);
      // x = S * scale + bias (+ mask): the bias from the head's table
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int a = ar - rel_pos(kt * kTileRows + 8 * j + 2 * t);
        s[4 * j] = s[4 * j] * scale + (kBias ? tab[a] : 0.f);
        s[4 * j + 1] = s[4 * j + 1] * scale + (kBias ? tab[a - 1] : 0.f);
        s[4 * j + 2] = s[4 * j + 2] * scale + (kBias ? tab[a + 8] : 0.f);
        s[4 * j + 3] = s[4 * j + 3] * scale + (kBias ? tab[a + 7] : 0.f);
      }
      if (masked) {        // the mask from the window's region labels
        const int l0 = lab[r], l1 = lab[r + 8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = kt * kTileRows + 8 * j + 2 * t;
          const int k0 = lab[c], k1 = lab[c + 1];
          s[4 * j] += mask_term(l0, k0);
          s[4 * j + 1] += mask_term(l0, k1);
          s[4 * j + 2] += mask_term(l1, k0);
          s[4 * j + 3] += mask_term(l1, k1);
        }
      }
      float t0 = mx0, t1 = mx1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        t0 = fmaxf(t0, fmaxf(s[4 * j], s[4 * j + 1]));
        t1 = fmaxf(t1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, sh));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, sh));
      }
      const float a0 = expf(mx0 - t0), a1 = expf(mx1 - t1);  // 0 at tile 0
      mx0 = t0;
      mx1 = t1;
      float e0 = 0.f, e1 = 0.f;
      uint32_t p[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x0 = expf(s[4 * j] - t0), x1 = expf(s[4 * j + 1] - t0);
        const float x2 = expf(s[4 * j + 2] - t1);
        const float x3 = expf(s[4 * j + 3] - t1);
        e0 += x0 + x1;
        e1 += x2 + x3;
        p[j][0] = pack2(x0, x1);
        p[j][1] = pack2(x2, x3);
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        e0 += __shfl_xor_sync(0xffffffffu, e0, sh);
        e1 += __shfl_xor_sync(0xffffffffu, e1, sh);
      }
      sum0 = sum0 * a0 + e0;
      sum1 = sum1 * a1 + e1;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      wg_fence_acc(o);
      wg_fence();
      wg_pv<HDP>(o, p, sv + kt * TB);
      wg_commit();
      wg_wait0();
      wg_fence_acc(o);
    }

    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    if (stats != nullptr && t == 0) {
      float2* st = stats + ((size_t)(b * nw + win) * nh + h) * N + r;
      st[0] = make_float2(mx0, inv0);
      st[8] = make_float2(mx1, inv1);
    }
    // the context over the warpgroup's Q tile (its last product has read
    // it), then out
    acc_to_swz<HDP>(sq, o, inv0, inv1, wtid);
    wg_sync(wg);
    if (kStore)
      store_swz<kWin>(sq, ctx, ldc, C, s0, hd, rows, qt * kTileRows, wtid,
                      128);
    wg_sync(wg);            // the Q tile is free again
  }
}

template <int HDP>
int launch16(const void* qkv, long long ldq, void* ctx, long long ldc,
             const void* table, const void* labels, void* stats, int B, int H,
             int W, int C, int nh, int hd, int shift, long long smem,
             cudaStream_t stream) {
  const size_t bytes = smem16(HDP);
  if ((long long)bytes != smem || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;   // per template instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attention16_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long blocks = (long long)B * (H / kWin) * (W / kWin) * nh;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  window_attention16_kernel<HDP><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const bf16*)qkv, ldq, (bf16*)ctx, ldc, (const float*)table,
      (const int*)labels, (float2*)stats, H, W, C, nh, hd, shift,
      (float)(1.0 / std::sqrt((double)hd)));
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel (c) at 16x16 windows. ``smem`` is the shared memory the caller
// planned (kernels/window_attention.py ``window_attention_plan``, window
// 16); a launch whose plan differs from this file's layout is refused.
// ``table`` is the relative-position bias table [nh][961] f32 (the bias of
// query i and key j of a window is table[h][rel_pos(i) - rel_pos(j) +
// 480]), ``labels`` (null at shift 0) the shift mask as each window's
// region labels [nW][256] int32; ``stats`` (or null) receives B * nW * nh *
// 256 float2: each query row's (max, 1 / sum) of its scaled, biased,
// masked scores per head.
extern "C" int adsr_window_attention16(const void* qkv, long long ldq,
                                       void* ctx, long long ldc,
                                       const void* table, const void* labels,
                                       void* stats, int B, int H, int W,
                                       int C, int nh, int shift,
                                       long long smem, void* stream) {
  if (H % kWin || W % kWin || nh <= 0 || C % nh || C % 4 || B < 0 ||
      shift < 0 || shift >= kWin || (shift > 0) != (labels != nullptr) ||
      ldq % 8 || ldc % 8 || ldq < 3ll * C || ldc < C ||
      reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(ctx) % 16 ||
      reinterpret_cast<uintptr_t>(stats) % 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int hd = C / nh;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return launch16<16>(qkv, ldq, ctx, ldc, table, labels, stats, B, H, W, C, nh, hd, shift, smem, s);
    case 2: return launch16<32>(qkv, ldq, ctx, ldc, table, labels, stats, B, H, W, C, nh, hd, shift, smem, s);
    case 3: return launch16<48>(qkv, ldq, ctx, ldc, table, labels, stats, B, H, W, C, nh, hd, shift, smem, s);
    case 4: return launch16<64>(qkv, ldq, ctx, ldc, table, labels, stats, B, H, W, C, nh, hd, shift, smem, s);
    case 5: return launch16<80>(qkv, ldq, ctx, ldc, table, labels, stats, B, H, W, C, nh, hd, shift, smem, s);
    case 6: return launch16<96>(qkv, ldq, ctx, ldc, table, labels, stats, B, H, W, C, nh, hd, shift, smem, s);
    case 7: return launch16<112>(qkv, ldq, ctx, ldc, table, labels, stats, B, H, W, C, nh, hd, shift, smem, s);
    case 8: return launch16<128>(qkv, ldq, ctx, ldc, table, labels, stats, B, H, W, C, nh, hd, shift, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
