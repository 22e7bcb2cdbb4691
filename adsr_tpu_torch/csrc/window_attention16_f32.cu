// window_attention16_f32.cu: kernel (c)'s f32 instances at 16x16 windows
// (N = 256), on window_attention_tc_f32.cuh (its notes say what the kernel
// replaces, its bound and its design).

#include "window_attention_tc_f32.cuh"

// adsr_window_attention16's arguments (window_attention16.cu: those of
// adsr_window_attention with the softmax statistics ``stats`` after
// ``mask``, null for none) on f32 qkv and ctx; ``win`` must be 16
extern "C" int adsr_window_attention16_f32(
    const void* qkv, long long ldq, void* ctx, long long ldc,
    const void* bias, const void* mask, void* stats, int B, int H, int W,
    int C, int nh, int win, int shift, long long smem, void* stream) {
  return entry<16>(qkv, ldq, ctx, ldc, bias, mask, stats, B, H, W, C, nh,
                   win, shift, smem, stream);
}
