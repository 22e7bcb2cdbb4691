// window_attention4_f32.cu: kernel (c)'s f32 instances at 4x4 windows
// (N = 16), on window_attention_tc_f32.cuh (its notes say what the kernel
// replaces, its bound and its design).

#include "window_attention_tc_f32.cuh"

// adsr_window_attention's arguments (window_attention.cu) on f32 qkv and
// ctx; ``win`` must be 4
extern "C" int adsr_window_attention4_f32(
    const void* qkv, long long ldq, void* ctx, long long ldc,
    const void* bias, const void* mask, int B, int H, int W, int C, int nh,
    int win, int shift, long long smem, void* stream) {
  return entry<4>(qkv, ldq, ctx, ldc, bias, mask, nullptr, B, H, W, C, nh,
                  win, shift, smem, stream);
}
