// swin_block16: kernel (g) swin_block at 16x16 windows (N = 256 tokens a
// window): one whole Swin block in one launch, a cluster of four thread
// blocks per (image, shifted window), each block owning one 64-row query
// tile of the window: LN1 -> qkv -> shifted-window multi-head attention
// over the window's 256 keys (relative-position bias + shift mask, online
// stabilised softmax) -> proj + residual -> LN2 -> fc1 + exact-erf GELU ->
// fc2 + residual.
//
// Replaces: the Pallas kernel fused_swin_block
// (adsr_tpu/ops/fused_swin_block.py:297, body _kernel :215, pallas_call
// :337) at window 16, the per-block program of the "block" serving mode
// (adsr_tpu/ops/fused_drct.py:168-189) of the 256px/x4 and 512/x8 models.
// Bound on H100: operations (the products and the attention on the tensor
// cores; the weights are read from L2 by every cluster).
// Design: the window's f32 residual stream (256 rows x up to 312 columns,
// ~315 KB) does not fit one block's shared memory, so the window is split
// by rows over a thread-block cluster of four (distributed shared memory):
//   - each block gathers its 64 token rows (WinRows<16>: the cyclic shift as
//     index arithmetic), keeps them in f32 in shared memory through the
//     whole block and runs LN1, every product, LN2 and the MLP on them on
//     the ring + wgmma path of swin_block_core.cuh, exactly as the 8x8
//     kernel (swin_block.cu) does for its window;
//   - per head, each block's qkv product writes its 64 rows of the head's
//     q, k and v planes; after a cluster barrier, each block's first
//     consumer warpgroup walks the window's four 64-key tiles with the
//     online softmax of kernel (c) at N = 256 (window_attn_core.cuh): its
//     own K/V tile from its own planes, the three others pulled from the
//     peer blocks' planes (ld.shared::cluster, 16 bytes a load, eight in
//     flight a thread) into a staging pair that overlays the context tile
//     (unused until the head's context is written); the context then goes
//     into the swizzled A tile and the head's share of proj accumulates
//     into the stream;
//   - two cluster barriers a head: one after the planes are written, one
//     (split: arrive after the last pull, wait before the next head's
//     planes are written, and before exit) before they are overwritten, so
//     no block exits while a peer may still read its shared memory. The
//     producer warp takes part in every cluster barrier: it arrives at a
//     barrier before it streams the first weight tile that the consumers
//     need after the next one, so the ring never waits on a barrier that
//     waits on the ring.
// No atomics: the output is bitwise repeatable. Numerics are the 8x8
// kernel's with kernel (c)'s online softmax: exp(S - running max) rounded
// once to bf16 for P V, the f32 context rescaled as the max grows and
// divided by the row sum after the last key tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "swin_block_core.cuh"   // ring, products, LayerNorm, launch arguments
#include "window_tiles.cuh"      // WinRows: the shifted window's raster rows

namespace {

constexpr int kWin16 = 16;
constexpr int kWinTok = kWin16 * kWin16;           // tokens a window (N)
constexpr int kCluster = kWinTok / kBlockRows;     // blocks a window
constexpr int kPullBatch = 8;                      // 16-byte loads in flight

// Shared memory of one block (byte offsets from the 1024-aligned base), for
// width C, head dim hd (tile HDP) and ``stages`` ring stages: the 8x8
// kernel's regions, with the context region widened to hold a staged K/V
// pair [2][64][hdp + 8] bf16 during the attention
//   ring   stages x 8 KB of weight tiles
//   y      the LayerNorm output as swizzled A atoms [kp / 64][64 x 64] bf16
//   ctx    one head's context as swizzled atoms (hk = ceil((hd + 7) / 64));
//          during the attention, a peer's K and V tiles; in the MLP, the
//          hidden chunk
//   x      the f32 residual stream [64][ldx]
//   qkv    this block's rows of one head's q, k, v planes [3][64][hdp + 8]
//          (the peers read the k and v planes)
//   bars   a full and an empty mbarrier a stage
struct Layout16 {
  int kp, hk, ldx, ldq;
  size_t y, ctx, x, qkv, bars, bytes;
};

__host__ __device__ inline Layout16 make_layout16(int C, int hd, int stages) {
  const int HDP = round16(hd);
  Layout16 L;
  L.kp = (C + 63) / 64 * 64;
  L.hk = (hd + 7 + 63) / 64;
  L.ldx = C + (24 - C % 16) % 16;
  L.ldq = HDP + 8;
  const size_t ctx = (size_t)L.hk * kAtomBytes;
  const size_t pair = (size_t)2 * kBlockRows * L.ldq * 2;
  size_t off = (size_t)stages * kStageBytes;
  L.y = off;   off += (size_t)L.kp / 64 * kAtomBytes;
  L.ctx = off; off += ctx > pair ? ctx : pair;
  L.x = off;   off += (size_t)kBlockRows * L.ldx * 4;
  L.qkv = off; off += (size_t)3 * kBlockRows * L.ldq * 2;
  L.bars = off; off += (size_t)16 * stages;
  L.bytes = 1024 + off;          // room to align the base to 1024 bytes
  return L;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier, split. Arrive has release and wait acquire
// semantics, so the shared-memory writes before an arrive are visible to
// every block of the cluster after its wait. Every thread of the cluster
// takes part; a warp arrives and waits as a whole (.aligned).
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ``bytes`` (a multiple of 16) from shared address ``src`` of cluster block
// ``rank`` (the same offset as in this block: the layouts are equal) into
// ``dst`` of this block, by the consumer threads
__device__ __forceinline__ void pull(unsigned char* dst, uint32_t src,
                                     uint32_t rank, int bytes) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(src), "r"(rank));
  const int n = bytes / 16;
  for (int base = threadIdx.x; base < n;
       base += kMathThreads * kPullBatch) {
    uint4 v[kPullBatch];
#pragma unroll
    for (int j = 0; j < kPullBatch; ++j) {
      const int i = base + j * kMathThreads;
      if (i < n)
        asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[j].x), "=r"(v[j].y), "=r"(v[j].z), "=r"(v[j].w)
                     : "r"(remote + 16u * i) : "memory");
    }
#pragma unroll
    for (int j = 0; j < kPullBatch; ++j) {
      const int i = base + j * kMathThreads;
      if (i < n) reinterpret_cast<uint4*>(dst)[i] = v[j];
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swin_block16_kernel(const __grid_constant__ Maps maps, const Args a) {
  const int C = a.C, F = a.F, hd = a.hd;
  const Layout16 L = make_layout16(C, hd, a.stages);
  extern __shared__ __align__(1024) unsigned char swin_smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(swin_smem);
  unsigned char* smem = swin_smem + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  RingState ring{sbase, sbase + (uint32_t)L.bars, a.stages, 0, 0u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(ring.full(s), 1);                  // the producer's arrival
      mbar_init(ring.empty(s), kMathThreads / 32); // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const uint32_t rank = cluster_rank();            // the block's query tile
  const int nww = a.W / kWin16;
  const int nw = (a.H / kWin16) * nww;
  const int cl = blockIdx.x / kCluster;            // the (image, window)
  const int win = cl % nw;
  const int b = cl / nw;
  const WinRows<kWin16> rows{(long long)b * a.H * a.W,
                             (win / nww) * kWin16 + a.shift,
                             (win % nww) * kWin16 + a.shift, a.H, a.W};
  const int t0 = (int)rank * kBlockRows;           // its first token
  const int ks = (C + 63) / 64;                    // 64-wide K steps over c
  const int hk = L.hk;                             // ... over a head's dims

  if (threadIdx.x >= kMathThreads) {
    // ---- producer warp: every weight tile, in the consumers' order ----
    // The consumers wait at cluster barriers 2h (head h's planes written)
    // and 2h + 1 (head h's planes read by the peers; waited before head
    // h + 1's qkv, the last one at exit), so their tiles fall into
    // segments: 2h = head h's qkv, 2h + 1 = its proj (and after the last
    // head the MLP). Before the tiles of segment s the warp has arrived at
    // barriers 0..s-1, waiting at each one but the last before arriving at
    // the next (a barrier's phases alternate), so its waits need only
    // tiles it has already issued.
    const bool leader = threadIdx.x == kMathThreads;
    int arrived = 0, waited = 0;
    auto sync_to = [&](int s) {
      while (arrived < s) {
        if (waited < arrived) {
          __syncwarp();
          cluster_wait();
          ++waited;
        }
        cluster_arrive();
        ++arrived;
      }
    };
    auto load = [&](const CUtensorMap* map, int row0, int n, int k0) {
      if (leader) {
        mbar_wait(ring.empty(ring.stage), ring.phase ^ 1);
        mbar_arrive_expect_tx(ring.full(ring.stage), n * 128);
        const uint32_t dst = sbase + ring.stage * kStageBytes;
        for (int i = 0; i < n; i += kBoxRows)
          tma_2d(dst + i * 128, map, k0, row0 + i, ring.full(ring.stage));
      }
      ring.advance();
    };
    for (int h = 0; h < a.nh; ++h) {
      sync_to(2 * h);
      for (int p = 0; p < 3; ++p)
        for (int n0 = 0; n0 < HDP; n0 += kStageRows)
          for (int s = 0; s < ks; ++s)
            load(&maps.qkv, p * C + h * hd + n0,
                 min(kStageRows, HDP - n0), 64 * s);
      sync_to(2 * h + 1);
      for (int n0 = 0; n0 < C; n0 += kStageRows)    // the head's proj share
        for (int s = 0; s < hk; ++s)
          load(&maps.proj, n0, tile_rows(C - n0), (h * hd & ~7) + 64 * s);
    }
    for (int f0 = 0; f0 < F; f0 += kStageRows) {
      for (int s = 0; s < ks; ++s)
        load(&maps.fc1, f0, tile_rows(F - f0), 64 * s);
      for (int n0 = 0; n0 < C; n0 += kStageRows)
        load(&maps.fc2, n0, tile_rows(C - n0), f0);
    }
    sync_to(2 * a.nh);
    __syncwarp();
    cluster_wait();
    return;
  }

  // ---- consumer warpgroups ----
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * (warp & 3), g = lane >> 2, tq = lane & 3;
  const int wg = tid >> 7;              // consumer warpgroup
  const int cb = kHalf * wg;            // its columns of every output tile
  const int ldx = L.ldx, ldq = L.ldq, kp = L.kp;
  float* X = reinterpret_cast<float*>(smem + L.x);
  bf16* Y = reinterpret_cast<bf16*>(smem + L.y);
  bf16* Cx = reinterpret_cast<bf16*>(smem + L.ctx);
  bf16* Hb = Cx;                        // the MLP's hidden chunk, after proj
  bf16* planes = reinterpret_cast<bf16*>(smem + L.qkv);
  const uint32_t s_y = sbase + (uint32_t)L.y, s_ctx = sbase + (uint32_t)L.ctx;
  const uint32_t s_q = sbase + (uint32_t)L.qkv;
  const uint32_t plane_bytes = 2u * kBlockRows * ldq;
  const uint32_t ldb = 2u * ldq;
  float acc[16];

  // gather the block's 64 rows into the f32 residual: every 8-byte copy in
  // flight at once, by cp.async into the Y region (LN1 overwrites it), then
  // widened
  const int q4 = C / 4;
  for (int i = tid; i < kBlockRows * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    cp_async<8>(s_y + 2u * (t * C + c), a.x + rows(t0 + t) * a.ldx + c, 8);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  math_barrier();
  for (int i = tid; i < kBlockRows * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    *reinterpret_cast<float4*>(X + t * ldx + c) =
        unpack4(*reinterpret_cast<const uint2*>(Y + t * C + c));
  }
  math_barrier();
  layer_norm(X, ldx, Y, C, kp, a.ln1_w, a.ln1_b, a.eps);
  fence_async_shared();
  math_barrier();

  // ---- attention and proj, one head at a time: X += ctx_h Wproj_h^T ----
  // the rows of the block's queries in the [N][N] bias and mask
  const size_t q0 = (size_t)t0 + r0;
  const float* mw = a.mask != nullptr
                        ? a.mask + ((size_t)win * kWinTok + q0) * kWinTok
                        : nullptr;
  float2 vec[4];
  for (int h = 0; h < a.nh; ++h) {
    if (h > 0) cluster_wait();         // the peers have read head h - 1
    for (int p = 0; p < 3; ++p) {      // q, k, v of head h into its plane
      bf16* plane = planes + p * kBlockRows * ldq;
      for (int n0 = 0; n0 < HDP; n0 += kStageRows) {
        const int n = min(kStageRows, HDP - n0);
        load_cols(vec, a.bqkv + p * C + h * hd, n0 + cb, n - cb, hd);
        mma_tile(ring, s_y, ks, acc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = n0 + cb + 8 * j + 2 * tq;
          if (cb + 8 * j < n) {        // zeros past the head dim
            const bool in0 = d < hd, in1 = d + 1 < hd;
            *reinterpret_cast<__nv_bfloat162*>(plane + (r0 + g) * ldq + d) =
                __floats2bfloat162_rn(in0 ? acc[4 * j] + vec[j].x : 0.f,
                                      in1 ? acc[4 * j + 1] + vec[j].y : 0.f);
            *reinterpret_cast<__nv_bfloat162*>(plane + (r0 + g + 8) * ldq
                                               + d) =
                __floats2bfloat162_rn(in0 ? acc[4 * j + 2] + vec[j].x : 0.f,
                                      in1 ? acc[4 * j + 3] + vec[j].y : 0.f);
          }
        }
      }
    }
    cluster_arrive();                  // every block's planes are whole
    cluster_wait();

    // the four key tiles, this block's own first, then the peers' in turn
    // through the staging pair (the consumers pull, the first warpgroup
    // runs the attention core on 16 query rows a warp)
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    float o[HDP / 8][4];
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
    const float* bias_r = a.bias + ((size_t)h * kWinTok + q0) * kWinTok;
    for (int i = 0; i < kCluster; ++i) {
      const uint32_t kt = (rank + i) % kCluster;
      uint32_t kv = s_q + plane_bytes;           // own k and v planes
      if (i > 0) {
        pull(smem + L.ctx, s_q + plane_bytes, kt, 2 * plane_bytes);
        if (i == kCluster - 1) cluster_arrive();  // done reading the peers
        math_barrier();                // the pair is whole
        kv = s_ctx;
      }
      if (wg == 0) {
        float s[8][4];
        qk_tile<HDP>(s_q, kv, ldb, r0, s);
        add_bias<kWinTok>(s, bias_r + kt * kBlockRows,
                          mw != nullptr ? mw + kt * kBlockRows : nullptr,
                          a.scale);
        online_softmax_tile<HDP>(s, kv + plane_bytes, ldb, mx, sum, o);
      }
      if (i > 0) math_barrier();       // the pair is read before it changes
    }

    // the context at columns oc + d of its tile, oc = (h hd) % 8: the
    // tile's column 0 is Wproj's column h hd - oc, 16-byte aligned; zeros
    // elsewhere (proj reduces over hk atoms; the staging pair was here)
    for (int i = tid; i < hk * kAtomBytes / 16; i += kMathThreads)
      reinterpret_cast<uint4*>(Cx)[i] = make_uint4(0u, 0u, 0u, 0u);
    math_barrier();
    const int oc = (h * hd) & 7;
    if (wg == 0) {
      const float inv0 = 1.f / sum[0], inv1 = 1.f / sum[1];
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int d = 8 * j + 2 * tq + x;
          if (d < hd) {
            Cx[swz(r0 + g, oc + d)] = __float2bfloat16(o[j][x] * inv0);
            Cx[swz(r0 + g + 8, oc + d)] = __float2bfloat16(o[j][2 + x] * inv1);
          }
        }
      }
    }
    fence_async_shared();
    math_barrier();                    // the context is whole
    for (int n0 = 0; n0 < C; n0 += kStageRows) {
      const int n = tile_rows(C - n0);
      load_cols(vec, h == 0 ? a.bproj : nullptr, n0 + cb, n - cb, C);
      mma_tile(ring, s_ctx, hk, acc);
      add_into_stream(X, ldx, n0 + cb, n - cb, C, acc, vec);
    }
    math_barrier();                    // the context is read before it changes
  }

  // ---- MLP: X += GELU(LN2(X) W1^T + b1) W2^T + b2, 64 hidden at a time ----
  layer_norm(X, ldx, Y, C, kp, a.ln2_w, a.ln2_b, a.eps);
  fence_async_shared();
  math_barrier();
  for (int f0 = 0; f0 < F; f0 += kStageRows) {
    const int n = tile_rows(F - f0);
    load_cols(vec, a.b1 + f0, cb, n - cb, F - f0);
    mma_tile(ring, s_y, ks, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {      // every column of the chunk, zeros
#pragma unroll                          // past F
      for (int x = 0; x < 2; ++x) {
        const int c = cb + 8 * j + 2 * tq + x;
        float u = 0.f, v = 0.f;
        if (cb + 8 * j < n && f0 + c < F) {
          const float bb = x ? vec[j].y : vec[j].x;
          u = acc[4 * j + x] + bb;
          v = acc[4 * j + 2 + x] + bb;
          u = 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
          v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
        }
        Hb[swz(r0 + g, c)] = __float2bfloat16(u);
        Hb[swz(r0 + g + 8, c)] = __float2bfloat16(v);
      }
    }
    fence_async_shared();
    math_barrier();
    for (int n0 = 0; n0 < C; n0 += kStageRows) {
      const int n2 = tile_rows(C - n0);
      load_cols(vec, f0 == 0 ? a.b2 : nullptr, n0 + cb, n2 - cb, C);
      mma_tile(ring, s_ctx, 1, acc);
      add_into_stream(X, ldx, n0 + cb, n2 - cb, C, acc, vec);
    }
    math_barrier();                    // the chunk is read before it changes
  }

  // ---- scatter the block's rows back ----
  for (int i = tid; i < kBlockRows * q4; i += kMathThreads) {
    const int t = i / q4, c = (i - t * q4) * 4;
    *reinterpret_cast<uint2*>(a.out + rows(t0 + t) * a.ldo + c) =
        pack4(*reinterpret_cast<const float4*>(X + t * ldx + c));
  }
  cluster_wait();                      // no peer reads this block any more
}

// The launch configuration: a cluster of kCluster blocks per window
struct Launch16 {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
};

inline void make_launch16(Launch16& l, long long blocks, size_t smem,
                          cudaStream_t stream) {
  l.cfg = cudaLaunchConfig_t{};
  l.cfg.gridDim = dim3((unsigned)blocks);
  l.cfg.blockDim = dim3(kThreads);
  l.cfg.dynamicSmemBytes = smem;
  l.cfg.stream = stream;
  l.attr.id = cudaLaunchAttributeClusterDimension;
  l.attr.val.clusterDim.x = kCluster;
  l.attr.val.clusterDim.y = 1;
  l.attr.val.clusterDim.z = 1;
  l.cfg.attrs = &l.attr;
  l.cfg.numAttrs = 1;
}

template <int HDP>
int configure16(size_t bytes) {
  static size_t configured = 0;   // per template instance
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        swin_block16_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  return 0;
}

template <int HDP>
int launch16(const Args& a, const Maps& maps, int B, long long smem,
             cudaStream_t stream) {
  const Layout16 L = make_layout16(a.C, a.hd, a.stages);
  if (a.stages < 2 || a.stages > kMaxStages || (long long)L.bytes != smem ||
      L.bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int rc = configure16<HDP>(L.bytes);
  if (rc) return rc;
  const long long blocks =
      (long long)B * (a.H / kWin16) * (a.W / kWin16) * kCluster;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  Launch16 l;
  make_launch16(l, blocks, L.bytes, stream);
  cudaError_t e = cudaLaunchKernelEx(&l.cfg, swin_block16_kernel<HDP>, maps, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int HDP>
int clusters16(long long smem, int* out) {
  int rc = configure16<HDP>((size_t)smem);
  if (rc) return rc;
  Launch16 l;
  make_launch16(l, 64 * kCluster, (size_t)smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, swin_block16_kernel<HDP>,
                                             &l.cfg);
}

}  // namespace

// The 16x16-window launch of kernel (g): the arguments of adsr_swin_block
// (swin_block.cu), ``win`` 16. ``stages`` and ``smem`` are the ring depth
// and shared-memory size the caller planned (kernels/fused_swin_block.py
// ``swin_block_plan``); a launch whose plan differs from this file's layout
// is refused.
extern "C" int adsr_swin_block16(
    const void* x, long long ldx, void* out, long long ldo, const void* ln1_w,
    const void* ln1_b, const void* wqkv, long long ld_qkv, const void* bqkv,
    const void* bias, const void* mask, const void* wproj, long long ld_proj,
    const void* bproj, const void* ln2_w, const void* ln2_b, const void* w1,
    long long ld1, const void* b1, const void* w2, long long ld2,
    const void* b2, int B, int H, int W, int C, int F, int nh, int win,
    int shift, int stages, float eps, long long smem, void* stream) {
  if (win != kWin16 || H % kWin16 || W % kWin16 || B < 0 || C <= 0 ||
      C > kMaxC || C % 4 || F <= 0 || F % 4 || nh <= 0 || C % nh ||
      ldx % 4 || ldo % 4 || ldx < C || ldo < C || shift < 0 ||
      shift >= kWin16 || (shift > 0) != (mask != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.x = (const bf16*)x; a.ldx = ldx; a.out = (bf16*)out; a.ldo = ldo;
  a.ln1_w = (const float*)ln1_w; a.ln1_b = (const float*)ln1_b;
  a.bqkv = (const float*)bqkv; a.bias = (const float*)bias;
  a.mask = (const float*)mask; a.bproj = (const float*)bproj;
  a.ln2_w = (const float*)ln2_w; a.ln2_b = (const float*)ln2_b;
  a.b1 = (const float*)b1; a.b2 = (const float*)b2;
  a.H = H; a.W = W; a.C = C; a.F = F; a.nh = nh; a.hd = C / nh;
  a.shift = shift; a.stages = stages; a.eps = eps;
  a.scale = (float)(1.0 / std::sqrt((double)a.hd));
  Maps maps;
  int rc = weight_map(&maps.qkv, wqkv, ld_qkv, 3 * C, C);
  if (!rc) rc = weight_map(&maps.proj, wproj, ld_proj, C, C);
  if (!rc) rc = weight_map(&maps.fc1, w1, ld1, F, C);
  if (!rc) rc = weight_map(&maps.fc2, w2, ld2, C, F);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((a.hd + 15) / 16) {
    case 1: return launch16<16>(a, maps, B, smem, s);
    case 2: return launch16<32>(a, maps, B, smem, s);
    case 3: return launch16<48>(a, maps, B, smem, s);
    case 4: return launch16<64>(a, maps, B, smem, s);
    case 5: return launch16<80>(a, maps, B, smem, s);
    case 6: return launch16<96>(a, maps, B, smem, s);
    case 7: return launch16<112>(a, maps, B, smem, s);
    case 8: return launch16<128>(a, maps, B, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of the 16x16-window kernel the card holds at once, for
// head dim ``hd`` and the planned shared memory ``smem``, into ``*out``
// (cudaOccupancyMaxActiveClusters: four blocks of one SM each, in one GPC)
extern "C" int adsr_swin_block16_clusters(int hd, long long smem, void* out) {
  int* n = (int*)out;
  switch ((hd + 15) / 16) {
    case 1: return clusters16<16>(smem, n);
    case 2: return clusters16<32>(smem, n);
    case 3: return clusters16<48>(smem, n);
    case 4: return clusters16<64>(smem, n);
    case 5: return clusters16<80>(smem, n);
    case 6: return clusters16<96>(smem, n);
    case 7: return clusters16<112>(smem, n);
    case 8: return clusters16<128>(smem, n);
    default: return (int)cudaErrorInvalidValue;
  }
}
