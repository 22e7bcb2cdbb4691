// window_attention_bwd16_f32.cu: kernel (f)'s f32 instances at 16x16
// windows (N = 256), on window_attention_bwd_f32.cuh (its notes say what
// the kernel replaces, its bound and its design).

#include "window_attention_bwd_f32.cuh"

// head tiles 72-128, built from window_attention_bwd16_f32_wide.cu with
// this entry's arguments
extern "C" int adsr_window_attention_bwd16_f32_wide(
    const void* qkv, long long ldq, const void* dout, long long ldg,
    const void* ctx, long long ldc, const void* table, const void* labels,
    const void* stats, void* dqkv, long long ldd, void* dsum, void* part,
    void* dbias, int B, int H, int W, int C, int nh, int shift, int group,
    long long smem_dq, long long smem_dkv, void* stream);

// adsr_window_attention_bwd16's arguments (window_attention_bwd16.cu) on
// f32 qkv, dout, ctx and dqkv: the forward's context ``ctx`` and softmax
// statistics ``stats`` (kernel (c) f32's), ``dsum`` a scratch of B * nW *
// nh * 256 f32 for each query row's D, ``group``, ``smem_dq`` and
// ``smem_dkv`` from kernels/window_attention_bwd.py
// ``window_attention_bwd_f32_plan``
extern "C" int adsr_window_attention_bwd16_f32(
    const void* qkv, long long ldq, const void* dout, long long ldg,
    const void* ctx, long long ldc, const void* table, const void* labels,
    const void* stats, void* dqkv, long long ldd, void* dsum, void* part,
    void* dbias, int B, int H, int W, int C, int nh, int shift, int group,
    long long smem_dq, long long smem_dkv, void* stream) {
  if (nh > 0 && C % nh == 0 && C / nh > 64 && C / nh <= 128)
    return adsr_window_attention_bwd16_f32_wide(
        qkv, ldq, dout, ldg, ctx, ldc, table, labels, stats, dqkv, ldd, dsum,
        part, dbias, B, H, W, C, nh, shift, group, smem_dq, smem_dkv,
        stream);
  const BwdArgs a{(const float*)qkv, ldq, (const float*)dout, ldg,
                  (const float*)ctx, ldc, (const float*)table, labels,
                  (const float*)stats, (float*)dqkv, ldd, (float*)dsum,
                  (float*)part, (float*)dbias, B, H, W, C, nh, shift, group,
                  smem_dkv, smem_dq};
  return bwd_entry<16>(a, stream);
}
