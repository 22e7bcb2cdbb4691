// swin_block4_f32.cu: kernel (g)'s f32 instances at 4x4 windows
// (N = 16), on swin_block_f32.cuh (its notes say what the kernel replaces,
// its bound and its design).

#include "swin_block_f32.cuh"

// adsr_swin_block16's arguments (swin_block16.cu) on f32 x, out and
// weights; ``win`` must be 4
extern "C" int adsr_swin_block4_f32(
    const void* x, long long ldx, void* out, long long ldo, const void* ln1_w,
    const void* ln1_b, const void* wqkv, long long ld_qkv, const void* bqkv,
    const void* bias, const void* mask, const void* wproj, long long ld_proj,
    const void* bproj, const void* ln2_w, const void* ln2_b, const void* w1,
    long long ld1, const void* b1, const void* w2, long long ld2,
    const void* b2, int B, int H, int W, int C, int F, int nh, int win,
    int shift, int stages, int cluster, float eps, long long smem,
    void* stream) {
  return swin_entry_f32<4>(x, ldx, out, ldo, ln1_w, ln1_b, wqkv, ld_qkv,
                             bqkv, bias, mask, wproj, ld_proj, bproj, ln2_w,
                             ln2_b, w1, ld1, b1, w2, ld2, b2, B, H, W, C, F,
                             nh, win, shift, stages, cluster, eps, smem,
                             stream);
}
