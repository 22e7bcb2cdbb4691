// window_attention_bwd16_f32_wide.cu: kernel (f)'s f32 instances at 16x16
// windows (N = 256) for head tiles 72-128, on window_attention_bwd_f32.cuh
// (its notes say what the kernel replaces, its bound and its design); a
// source of their own so that nvcc builds them beside the head tiles up to
// 64 (window_attention_bwd16_f32.cu, whose entry calls this one).

#define ADSR_BWD16_WIDE 1
#include "window_attention_bwd_f32.cuh"

// adsr_window_attention_bwd16_f32's arguments, at head dims 65-128
extern "C" int adsr_window_attention_bwd16_f32_wide(
    const void* qkv, long long ldq, const void* dout, long long ldg,
    const void* ctx, long long ldc, const void* table, const void* labels,
    const void* stats, void* dqkv, long long ldd, void* dsum, void* part,
    void* dbias, int B, int H, int W, int C, int nh, int shift, int group,
    long long smem_dq, long long smem_dkv, void* stream) {
  const BwdArgs a{(const float*)qkv, ldq, (const float*)dout, ldg,
                  (const float*)ctx, ldc, (const float*)table, labels,
                  (const float*)stats, (float*)dqkv, ldd, (float*)dsum,
                  (float*)part, (float*)dbias, B, H, W, C, nh, shift, group,
                  smem_dkv, smem_dq};
  return bwd_entry<16>(a, stream);
}
