// window_attention_bwd_f32.cu: kernel (f)'s f32 instances at 8x8 windows
// (N = 64), on window_attention_bwd_f32.cuh (its notes say what the kernel
// replaces, its bound and its design).

#include "window_attention_bwd_f32.cuh"

// adsr_window_attention_bwd's arguments (window_attention_bwd.cu) on f32
// qkv, dout and dqkv; ``win`` must be 8, ``group`` and ``smem`` from
// kernels/window_attention_bwd.py ``window_attention_bwd_f32_plan``
extern "C" int adsr_window_attention_bwd_f32(
    const void* qkv, long long ldq, const void* dout, long long ldg,
    const void* bias, const void* mask, void* dqkv, long long ldd,
    void* part, void* dbias, int B, int H, int W, int C, int nh, int win,
    int shift, int group, long long smem, void* stream) {
  if (win != 8) return (int)cudaErrorInvalidValue;
  const BwdArgs a{(const float*)qkv, ldq, (const float*)dout, ldg, nullptr,
                  0, (const float*)bias, mask, nullptr, (float*)dqkv, ldd,
                  nullptr, (float*)part, (float*)dbias, B, H, W, C, nh,
                  shift, group, smem, 0};
  return bwd_entry<8>(a, stream);
}
