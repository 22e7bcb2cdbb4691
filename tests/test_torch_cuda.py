"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA card with nvcc (sm_90a build) and skip elsewhere. The
card's machine has no JAX, so run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels import rdg_gemm_bwd as gb
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.kernels.fused_rdg import prepack_rdg_stack
from adsr_tpu_torch.kernels.fused_rdg_train import (fused_rdg_train,
                                                    rdg_train_plain)
from adsr_tpu_torch.kernels.fused_swin_block import (fused_swin_block,
                                                     fused_swin_block_plain)
from adsr_tpu_torch.kernels.rdg_gemm import pitched, rdg_gemm, rdg_gemm_plain
from adsr_tpu_torch.kernels.rdg_layernorm import (rdg_layernorm,
                                                  rdg_layernorm_plain)
from adsr_tpu_torch.kernels.rdg_layernorm_bwd import (rdg_layernorm_bwd,
                                                      rdg_layernorm_bwd_plain)
from adsr_tpu_torch.kernels.window_attention import (full_bias, full_mask,
                                                     softmax_stats,
                                                     window_attention,
                                                     window_attention_plain)
from adsr_tpu_torch.kernels.window_attention_bwd import (
    window_attention_bwd, window_attention_bwd_plain)
from adsr_tpu_torch.models.drct import shift_attn_mask, shift_region_labels
from adsr_tpu_torch.models.factory import init_sr_params, make_model

pytestmark = pytest.mark.cuda

# window 8 (the kernel's), embed 12: dims 12..28, head dims 6..14
CFG = DRCTModelConfig(upscale=2, img_size=16, window_size=8, in_chans=1,
                      embed_dim=12, num_layers=2, num_heads=2, gc=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, atol):
    err = (got.float() - want).abs()
    assert bool((err <= atol + 2.0 ** -7 * want.abs()).all()), err.max()


def test_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    m, c, nh = 2 * 32 * 32, 212, 4
    cat = torch.randn(m, 308, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(c, generator=g, device=dev)
    b = torch.randn(c, generator=g, device=dev)
    out = torch.empty(m, c, dtype=torch.bfloat16, device=dev)
    n0 = rdg_layernorm.launches
    rdg_layernorm(cat[:, :c], w, b, out)
    assert rdg_layernorm.launches == n0 + 1
    _close(out, rdg_layernorm_plain(cat[:, :c].float(), w, b), 1e-4)

    wt = (0.05 * torch.randn(32, c, generator=g, device=dev)).to(torch.bfloat16)
    bias = torch.randn(32, generator=g, device=dev)
    dst = cat.clone()
    rdg_gemm(cat[:, :c], wt, bias, dst[:, c:c + 32], "leaky_relu")
    _close(dst[:, c:c + 32], rdg_gemm_plain(cat[:, :c].float(), wt.float(),
                                            bias, "leaky_relu"), 1e-3)
    assert torch.equal(dst[:, :c], cat[:, :c])     # other columns untouched

    qkv = pitched(m, 3 * c, device=dev)          # 16-byte rows
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    tb = torch.randn(nh, 64, 64, generator=g, device=dev)
    mask = torch.as_tensor(shift_attn_mask(32, 32, 8, 4), device=dev)
    ctx = pitched(m, c, device=dev)
    window_attention(qkv, ctx, tb, mask, 32, 32, nh, 8, 4)
    atol = 2.0 ** -8 * qkv[:, 2 * c:].float().abs().max().item()
    _close(ctx, window_attention_plain(qkv.float(), tb, mask, 32, 32, nh, 8,
                                       4), atol)


@pytest.mark.parametrize("c,f", [(180, 360), (212, 424), (308, 308)])
def test_gemm_training_epilogues_match_plain(dev, c, f):
    # proj / fc2 of the training forward: residual + m[row // L] * acc with
    # m a strided [B] column of a drop-path tensor (zeros and 1/keep); fc1 of
    # the backward's recompute: GELU into out, the pre-activation into aux;
    # adjust 5 in place over its residual (out aliases residual). M is not a
    # multiple of the kernel's 128-row tile, K = c is 4 past a multiple of 16
    g = torch.Generator(device=dev).manual_seed(4)
    b = 4
    m = b * 1014
    a = torch.randn(m, c, generator=g, device=dev).to(torch.bfloat16)
    res = torch.randn(m, c, generator=g, device=dev).to(torch.bfloat16)
    wt = (0.05 * torch.randn(c, c, generator=g, device=dev)).to(torch.bfloat16)
    w1 = (0.05 * torch.randn(f, c, generator=g, device=dev)).to(torch.bfloat16)
    bias, b1 = (torch.randn(n, generator=g, device=dev) for n in (c, f))
    dp = torch.full((b, 10), 1.0 / 0.9, device=dev)
    dp[1, 3] = dp[3, 3] = 0.0
    out = torch.empty(m, c, dtype=torch.bfloat16, device=dev)
    rdg_gemm(a, wt, bias, out, "drop_residual", res, row_scale=dp[:, 3])
    _close(out, rdg_gemm_plain(a, wt, bias, "drop_residual", res, dp[:, 3]),
           1e-3)
    rows = slice(m // b, 2 * m // b)         # sample 1: the branch dropped
    assert torch.equal(out[rows], res[rows])
    hid, pre = (torch.empty(m, f, dtype=torch.bfloat16, device=dev)
                for _ in range(2))
    rdg_gemm(a, w1, b1, hid, "gelu_aux", aux=pre)
    _close(hid, rdg_gemm_plain(a, w1, b1, "gelu_aux"), 1e-3)
    _close(pre, rdg_gemm_plain(a, w1, b1), 1e-3)
    cat = torch.randn(m, 308, generator=g, device=dev).to(torch.bfloat16)
    w5 = (0.05 * torch.randn(180, c, generator=g, device=dev)).to(
        torch.bfloat16)
    want = rdg_gemm_plain(a, w5, bias[:180], "scaled_residual", cat[:, :180])
    rdg_gemm(a, w5, bias[:180].contiguous(), cat[:, :180], "scaled_residual",
             cat[:, :180])
    _close(cat[:, :180], want, 1e-3)


def test_fused_forward_counts_launches_and_tracks_eager(dev):
    sd, _ = init_sr_params(CFG, torch.Generator().manual_seed(0), device=dev)
    packed = prepack_drct(sd, CFG, 16, 16, dtype=torch.bfloat16, device=dev)
    x = 255 * torch.rand(2, 16, 16, 1, device=dev)
    for fn in (rdg_layernorm, rdg_gemm, window_attention):
        fn.launches = 0
    with torch.no_grad():
        got = fused_drct_apply(packed, CFG, x)
        model = make_model(CFG, device=dev)
        model.load_state_dict(sd)
        want = model(x)
    torch.cuda.synchronize()
    per_rdg = (10, 25, 5)
    assert [rdg_layernorm.launches, rdg_gemm.launches,
            window_attention.launches] == [n * CFG.num_layers for n in per_rdg]
    rel = (got - want).norm() / want.norm()
    assert rel < 5e-2, rel


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_swin_block_kernel_matches_plain(dev, k):
    # one flagship block per case (embed 180, gc 32: c 180..308, heads
    # 6/4/2/6/4, shift 0/4), batch 2, 32x32 tokens; chip_smoke.py states the
    # bound's reason
    cfg = DRCTModelConfig(upscale=4, img_size=32, window_size=8, in_chans=1,
                          embed_dim=180, num_layers=1, num_heads=6, gc=32)
    sd, _ = init_sr_params(cfg, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(k)
    sd = {n: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
          for n, v in sd.items()}
    packed = prepack_rdg_stack(sd, cfg, 32, 32, torch.bfloat16, dev)
    blk = packed["rdgs"][0][k]          # the packed dict, as block mode
    c = (180, 212, 244, 276, 308)[k]
    x = torch.randn(2 * 1024, 308, generator=gen).to(dev).to(torch.bfloat16)
    out = torch.empty(2 * 1024, c, dtype=torch.bfloat16, device=dev)
    n0 = fused_swin_block.launches
    fused_swin_block(x[:, :c], blk, packed["masks"], cfg, 32, 32, k, out)
    assert fused_swin_block.launches == n0 + 1
    want = fused_swin_block_plain(x[:, :c], blk, packed["masks"], cfg, 32,
                                  32, k)
    _close(out, want, 4e-2)


def test_block_mode_forward_tracks_rdg_mode(dev):
    sd, _ = init_sr_params(CFG, torch.Generator().manual_seed(0), device=dev)
    packed = prepack_drct(sd, CFG, 16, 16, dtype=torch.bfloat16, device=dev,
                          mode="block")
    x = 255 * torch.rand(2, 16, 16, 1, device=dev)
    for fn in (rdg_layernorm, rdg_gemm, window_attention, fused_swin_block):
        fn.launches = 0
    with torch.no_grad():
        block = fused_drct_apply(packed, CFG, x)
        torch.cuda.synchronize()
        counts = [fn.launches for fn in (rdg_layernorm, rdg_gemm,
                                         window_attention, fused_swin_block)]
        rdg = fused_drct_apply(packed, CFG, x, mode="rdg")
    assert counts == [0, 5 * CFG.num_layers, 0, 5 * CFG.num_layers]
    rel = (block - rdg).norm() / rdg.norm()
    assert rel < 5e-2, rel


def test_fp32_on_the_card_raises(dev):
    x = torch.zeros(64, 12, device=dev)
    with pytest.raises(NotImplementedError, match="fp32 serving kernels"):
        rdg_layernorm(x, torch.ones(12, device=dev), torch.zeros(12, device=dev),
                      torch.empty_like(x))
    assert _build.library() is not None


def _within(got, want, bound):
    """Elementwise |got - want| <= bound, bound a tensor or a float."""
    err = (got.float() - want).abs()
    assert bool((err <= bound).all()), (err - bound).max()


@pytest.mark.parametrize("n,k", [(32, 180), (96, 212), (924, 308),
                                 (180, 360), (180, 308)])
def test_gemm_bwd_kernels_match_plain(dev, n, k):
    # products of the flagship's shapes (adjust 1-4, a narrow one, qkv of
    # block 5, fc2 of block 1, adjust 5) at an M that is not a multiple of
    # the 128-row tile, dY an f32 column slice of a wider buffer. dY rounds
    # to bf16 once (relative 2^-9 a term) and a bf16 output rounds once
    # more: |err| <= 2^-8 (|dY_eff| @ |W| + |ref|)
    g = torch.Generator(device=dev).manual_seed(1)
    b = 2
    m = b * 1004
    wide = torch.randn(m, n + 44, generator=g, device=dev)     # f32 "dcat"
    src = torch.randn(m, n + 44, generator=g, device=dev).to(torch.bfloat16)
    w = (0.05 * torch.randn(n, k, generator=g, device=dev)).to(torch.bfloat16)
    a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    pre = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    scale = torch.tensor([[1.1, 0.0], [0.0, 1.1]], device=dev)[:, 1]
    dy, slope = wide[:, 40:40 + n], src[:, 40:40 + n]          # strided
    for kw in ({}, {"slope_src": slope}, {"alpha": 0.2},
               {"row_scale": scale}, {"row_scale": scale, "gelu_pre": pre},
               {"bf16": True}):
        d = dy.to(torch.bfloat16) if kw.pop("bf16", False) else dy
        for out_dtype in (torch.float32, torch.bfloat16):
            out = torch.empty(m, k, dtype=out_dtype, device=dev)
            gb.rdg_gemm_dgrad(d, w, out, **kw)
            want = gb.rdg_gemm_dgrad_plain(d, w, **kw)
            eff = gb.dy_effective(d, kw.get("alpha", 1.0),
                                  kw.get("slope_src"), kw.get("row_scale"))
            bound = eff.abs() @ w.float().abs()
            if "gelu_pre" in kw:
                bound = bound * gb.gelu_grad(pre).abs()
            _within(out, want, 2.0 ** -8 * (bound + want.abs()) + 1e-6)
        kw.pop("gelu_pre", None)
        dw = torch.empty(n, k, device=dev)
        db = torch.empty(n, device=dev)
        gb.rdg_gemm_wgrad(d, a, dw, db, **kw)
        want_w, want_b = gb.rdg_gemm_wgrad_plain(d, a, **kw)
        eff = gb.dy_effective(d, kw.get("alpha", 1.0), kw.get("slope_src"),
                              kw.get("row_scale"))
        _within(dw, want_w, 2.0 ** -8 * (eff.abs().t() @ a.float().abs())
                + 1e-5)
        _within(db, want_b, 2.0 ** -8 * eff.abs().sum(0) + 1e-5)
        dw2, db2 = torch.empty_like(dw), torch.empty_like(db)
        gb.rdg_gemm_wgrad(d, a, dw2, db2, **kw)
        assert torch.equal(dw, dw2) and torch.equal(db, db2)   # deterministic
        # the training backward's call: one pre-pass, the same two products
        out = torch.empty(m, k, dtype=torch.bfloat16, device=dev)
        gb.rdg_gemm_dgrad(d, w, out, **kw)
        both = (torch.empty_like(out), torch.empty_like(dw),
                torch.empty_like(db))
        gb.rdg_gemm_grads(d, w, a, *both, **kw)
        assert all(torch.equal(x, y) for x, y in zip(both, (out, dw, db)))


def test_layernorm_bwd_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    m, c = 2 * 1024, 244
    cat = (1 + 2 * torch.randn(m, 308, generator=g, device=dev)).to(
        torch.bfloat16)
    w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    dy = torch.randn(m, c, generator=g, device=dev)
    res = torch.randn(m, c, generator=g, device=dev)
    dcat = torch.randn(m, 308, generator=g, device=dev)
    before = dcat.clone()
    dw, db = torch.empty(c, device=dev), torch.empty(c, device=dev)
    n0 = rdg_layernorm_bwd.launches
    rdg_layernorm_bwd(cat[:, :c], dy, w, dcat[:, :c], dw, db, residual=res)
    assert rdg_layernorm_bwd.launches == n0 + 1
    gx, gw, gbias = rdg_layernorm_bwd_plain(cat[:, :c], dy, w)
    _within(dcat[:, :c], before[:, :c] + gx + res,
            1e-4 * (gx.abs().max() + res.abs().max()))
    assert torch.equal(dcat[:, c:], before[:, c:])
    _within(dw, gw, 1e-4 * gw.abs().max())
    _within(db, gbias, 1e-4 * gbias.abs().max())
    # a second call repeats the first bitwise (fixed-order partial sums)
    again = before.clone()
    dw2, db2 = torch.empty_like(dw), torch.empty_like(db)
    rdg_layernorm_bwd(cat[:, :c], dy, w, again[:, :c], dw2, db2, residual=res)
    assert torch.equal(again, dcat) and torch.equal(dw2, dw) \
        and torch.equal(db2, db)


@pytest.mark.parametrize("c,nh,shift,b,h", [
    (180, 6, 0, 2, 32), (212, 4, 4, 2, 32), (244, 2, 0, 2, 32),
    (308, 4, 4, 2, 32), (180, 6, 4, 5, 40), (276, 6, 0, 5, 40)])
def test_window_attention_bwd_kernel_matches_plain(dev, c, nh, shift, b, h):
    # P and dS round to bf16 before the three output products: 2^-7 of each
    # output's largest magnitude. qkv, dout and dqkv in 16-byte rows, as the
    # training backward lays them out; at batch 5 on 40 x 40 tokens (125
    # windows) the plan groups 2 windows a block, the last group short
    g = torch.Generator(device=dev).manual_seed(3)
    m = b * h * h
    qkv = pitched(m, 3 * c, device=dev)
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    dout = pitched(m, c, device=dev)
    dout.copy_(torch.randn(m, c, generator=g, device=dev))
    bias = 0.5 * torch.randn(nh, 64, 64, generator=g, device=dev)
    mask = torch.as_tensor(shift_attn_mask(h, h, 8, shift), device=dev) \
        if shift else None
    dqkv = pitched(m, 3 * c, device=dev)
    dbias = torch.empty(nh, 64, 64, device=dev)
    n0 = window_attention_bwd.launches
    window_attention_bwd(qkv, dout, bias, mask, h, h, nh, 8, shift, dqkv,
                         dbias)
    assert window_attention_bwd.launches == n0 + 1
    want_q, want_b = window_attention_bwd_plain(qkv, dout, bias, mask, h, h,
                                                nh, 8, shift)
    for i in range(3):
        part = want_q[:, i * c:(i + 1) * c]
        _within(dqkv[:, i * c:(i + 1) * c], part,
                2.0 ** -7 * (part.abs().max() + part.abs()))
    _within(dbias, want_b, 2.0 ** -8 * want_b.abs().max())
    dq2, db2 = pitched(m, 3 * c, device=dev), torch.empty_like(dbias)
    window_attention_bwd(qkv, dout, bias, mask, h, h, nh, 8, shift, dq2, db2)
    assert torch.equal(dqkv, dq2) and torch.equal(dbias, db2)


def test_rdg_train_grads_track_eager_autograd(dev):
    # one RDG at the flagship's widths (embed 180, window 8, 32x32 tokens),
    # batch 4: bf16 kernels against the eager f32 RDG under autograd,
    # relative L2 per tensor; chip_smoke.py states the limit's reason
    cfg = DRCTModelConfig(upscale=4, img_size=32, window_size=8, in_chans=1,
                          embed_dim=180, num_layers=1, num_heads=6, gc=32)
    sd, _ = init_sr_params(cfg, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(1)
    sd = {k: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
          for k, v in sd.items()}
    model = make_model(cfg, device=dev)
    model.load_state_dict(sd)
    h = w = cfg.img_size
    x = torch.randn(4 * h * w, cfg.embed_dim, generator=gen).to(dev)
    dp = torch.full((4, 10), 1.0 / 0.9, device=dev)
    dp[1, 2] = dp[3, 9] = 0.0
    g = torch.randn(4 * h * w, cfg.embed_dim, generator=gen).to(dev)
    params = dict(model.named_parameters())
    packed = prepack_rdg_stack(params, cfg, h, w, torch.bfloat16, dev,
                               detach=False)
    xk = x.to(torch.bfloat16).requires_grad_(True)
    out = fused_rdg_train(xk, packed["rdgs"][0], packed["masks"], cfg, h, w,
                          dp)
    torch.autograd.backward(out, g.to(torch.bfloat16))
    got = {k: p.grad.clone() for k, p in params.items() if p.grad is not None}
    gx = xk.grad.float()
    model.zero_grad()
    xp = x.clone().requires_grad_(True)
    ref = rdg_train_plain(model.layers[0], xp, h, w, dp)
    torch.autograd.backward(ref, g)
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()

    assert rel(out, ref.detach()) < 1e-1
    assert rel(gx, xp.grad) < 1e-1
    assert len(got) == 75                 # 15 tensors in each of 5 blocks
    for k, v in got.items():
        assert rel(v, params[k].grad) < 1e-1, k


@pytest.mark.parametrize("c,nh,shift,b", [(180, 6, 0, 3), (212, 4, 4, 1),
                                          (244, 2, 0, 2), (276, 6, 4, 1),
                                          (308, 4, 4, 2)])
def test_window_attention_kernel_matches_plain_at_every_head_dim(dev, c, nh,
                                                                  shift, b):
    # the flagship's five blocks (hd 30/53/122/46/77), qkv and ctx column
    # slices of wider 16-byte-row buffers; columns past c are untouched.
    # P rounds to bf16 before P @ V: 2^-8 max|v|
    g = torch.Generator(device=dev).manual_seed(5)
    m, h = b * 1024, 32
    qkv = pitched(m, 3 * c + 8, device=dev)[:, :3 * c]
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    tb = 0.5 * torch.randn(nh, 64, 64, generator=g, device=dev)
    mask = torch.as_tensor(shift_attn_mask(h, h, 8, shift), device=dev) \
        if shift else None
    wide = torch.zeros(m, 320, dtype=torch.bfloat16, device=dev)
    n0 = window_attention.launches
    window_attention(qkv, wide[:, :c], tb, mask, h, h, nh, 8, shift)
    assert window_attention.launches == n0 + 1
    atol = 2.0 ** -8 * qkv[:, 2 * c:].float().abs().max().item()
    _close(wide[:, :c], window_attention_plain(qkv, tb, mask, h, h, nh, 8,
                                               shift), atol)
    assert not wide[:, c:].any()


def test_attention_kernels_refuse_rows_that_are_not_16_bytes(dev):
    m, c = 1024, 180
    qkv = torch.zeros(m, 3 * c, dtype=torch.bfloat16, device=dev)  # 1080 B
    out = pitched(m, c, device=dev)
    tb = torch.zeros(6, 64, 64, device=dev)
    n0 = window_attention.launches
    with pytest.raises(ValueError, match="16-byte rows"):
        window_attention(qkv, out, tb, None, 32, 32, 6, 8, 0)
    assert window_attention.launches == n0
    # kernel (f): dout (360-byte rows) and dqkv (1080) as they were once
    # allocated, contiguous
    n0 = window_attention_bwd.launches
    good = pitched(m, 3 * c, device=dev)
    for dout, dqkv in ((torch.zeros(m, c, dtype=torch.bfloat16, device=dev),
                        good),
                       (out, torch.zeros(m, 3 * c, dtype=torch.bfloat16,
                                         device=dev))):
        with pytest.raises(ValueError, match="16-byte rows"):
            window_attention_bwd(good, dout, tb, None, 32, 32, 6, 8, 0, dqkv,
                                 torch.empty(6, 64, 64, device=dev))
    assert window_attention_bwd.launches == n0


# 16x16 windows (N = 256): the 256px model's five blocks (hd 30/53/122/46/77)
# at shifts 0 and 8 on 32 x 32 tokens (4 windows an image)
W16_BLOCKS = [(180, 6, 0), (212, 4, 8), (244, 2, 0), (276, 6, 8), (308, 4, 0)]


@pytest.mark.parametrize("c,nh,shift", W16_BLOCKS)
def test_window_attention_kernel_matches_plain_at_window16(dev, c, nh, shift):
    # exp(S - max) rounds to bf16 once before P @ V (the online softmax over
    # four key tiles): 2^-8 max|v|; qkv and ctx column slices of wider
    # 16-byte-row buffers. The softmax statistics against the plain
    # version's f32 ones: the scores are f32 sums of the same bf16 products
    # in another order, so the max within 1e-4 and 1 / sum within 1e-4
    # relative; a second launch bitwise equal
    g = torch.Generator(device=dev).manual_seed(6)
    b, h = 2, 32
    m = b * h * h
    qkv = pitched(m, 3 * c + 8, device=dev)[:, :3 * c]
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    # the bias as the kernel takes it at 16x16 windows: its relative-
    # position table [nh, 31 * 31] (the plain version gathers it)
    tb = 0.5 * torch.randn(nh, 961, generator=g, device=dev)
    # and the shift mask as each window's region labels [nW, 256]
    mask = torch.as_tensor(shift_region_labels(h, h, 16, shift),
                           device=dev) if shift else None
    wide = torch.zeros(m, 320, dtype=torch.bfloat16, device=dev)
    stats = softmax_stats(qkv, h, h, nh, 16)
    n0 = window_attention.launches
    window_attention(qkv, wide[:, :c], tb, mask, h, h, nh, 16, shift, stats)
    assert window_attention.launches == n0 + 1
    atol = 2.0 ** -8 * qkv[:, 2 * c:].float().abs().max().item()
    want_st = torch.empty_like(stats)
    _close(wide[:, :c], window_attention_plain(qkv, tb, mask, h, h, nh, 16,
                                               shift, want_st), atol)
    assert not wide[:, c:].any()
    _within(stats[..., 0], want_st[..., 0], 1e-4 * (1 + want_st[..., 0].abs()))
    _within(stats[..., 1], want_st[..., 1], 1e-4 * want_st[..., 1].abs())
    again, st2 = torch.zeros_like(wide), torch.empty_like(stats)
    window_attention(qkv, again[:, :c], tb, mask, h, h, nh, 16, shift, st2)
    assert torch.equal(again, wide) and torch.equal(st2, stats)
    # serving passes no statistics: the same context
    window_attention(qkv, again[:, :c], tb, mask, h, h, nh, 16, shift)
    assert torch.equal(again, wide)


@pytest.mark.parametrize("c,nh,shift,b", [blk + (2,) for blk in W16_BLOCKS]
                         + [(180, 6, 8, 11)])
def test_window_attention_bwd_kernel_matches_plain_at_window16(dev, c, nh,
                                                               shift, b):
    # the two launches (dq, then dkv over groups of windows) and the partial
    # sums, fed kernel (c)'s own context and softmax statistics as the
    # training backward feeds them: 2^-7 of each output's largest magnitude,
    # d(bias) 2^-8, against the plain f32 backward of the same qkv (its own
    # softmax and D); at batch 11 (44 windows, 6 heads) the plan groups 3
    # windows a block, the last group short; a second call bitwise equal
    g = torch.Generator(device=dev).manual_seed(7)
    h = 32
    m = b * h * h
    qkv = pitched(m, 3 * c, device=dev)
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    dout = pitched(m, c, device=dev)
    dout.copy_(torch.randn(m, c, generator=g, device=dev))
    bias = 0.5 * torch.randn(nh, 961, generator=g, device=dev)   # the table
    mask = torch.as_tensor(shift_region_labels(h, h, 16, shift),
                           device=dev) if shift else None      # the labels
    ctx = pitched(m, c, device=dev)
    stats = softmax_stats(qkv, h, h, nh, 16)
    window_attention(qkv, ctx, bias, mask, h, h, nh, 16, shift, stats)
    dqkv = pitched(m, 3 * c, device=dev)
    dbias = torch.empty(nh, 256, 256, device=dev)
    n0 = window_attention_bwd.launches
    window_attention_bwd(qkv, dout, bias, mask, h, h, nh, 16, shift, dqkv,
                         dbias, ctx, stats)
    assert window_attention_bwd.launches == n0 + 2
    want_q, want_b = window_attention_bwd_plain(qkv, dout, bias, mask, h, h,
                                                nh, 16, shift)
    for i in range(3):
        part = want_q[:, i * c:(i + 1) * c]
        _within(dqkv[:, i * c:(i + 1) * c], part,
                2.0 ** -7 * (part.abs().max() + part.abs()))
    _within(dbias, want_b, 2.0 ** -8 * want_b.abs().max())
    dq2, db2 = pitched(m, 3 * c, device=dev), torch.empty_like(dbias)
    window_attention_bwd(qkv, dout, bias, mask, h, h, nh, 16, shift, dq2, db2,
                         ctx, stats)
    assert torch.equal(dqkv, dq2) and torch.equal(dbias, db2)
    # without the forward's statistics, or with the bias gathered, the card
    # refuses at window 16
    with pytest.raises(ValueError, match="softmax statistics"):
        window_attention_bwd(qkv, dout, bias, mask, h, h, nh, 16, shift, dq2,
                             db2)
    with pytest.raises(NotImplementedError, match="relative-position"):
        window_attention_bwd(qkv, dout, full_bias(bias, 16), mask, h, h, nh,
                             16, shift, dq2, db2, ctx, stats)
    if shift:      # nor the [nW, N, N] mask
        with pytest.raises(NotImplementedError, match="region labels"):
            window_attention_bwd(qkv, dout, bias, full_mask(mask, 16), h, h,
                                 nh, 16, shift, dq2, db2, ctx, stats)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_swin_block_kernel_matches_plain_at_window16(dev, k):
    # the 256px model's five blocks (c 180..308, heads 6/4/2/6/4, hd
    # 30/53/122/46/77, shifts 0/8) at 16x16 windows, batch 2 on 32x32
    # tokens (4 windows an image, a cluster of 4 blocks a window); the
    # bound of the 8x8 case above
    cfg = DRCTModelConfig(upscale=4, img_size=32, window_size=16, in_chans=1,
                          embed_dim=180, num_layers=1, num_heads=6, gc=32)
    sd, _ = init_sr_params(cfg, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(k)
    sd = {n: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
          for n, v in sd.items()}
    packed = prepack_rdg_stack(sd, cfg, 32, 32, torch.bfloat16, dev)
    blk = packed["rdgs"][0][k]
    c = (180, 212, 244, 276, 308)[k]
    x = torch.randn(2 * 1024, 308, generator=gen).to(dev).to(torch.bfloat16)
    out = torch.empty(2 * 1024, c, dtype=torch.bfloat16, device=dev)
    n0 = fused_swin_block.launches
    fused_swin_block(x[:, :c], blk, packed["masks"], cfg, 32, 32, k, out)
    assert fused_swin_block.launches == n0 + 1
    want = fused_swin_block_plain(x[:, :c], blk, packed["masks"], cfg, 32,
                                  32, k)
    _close(out, want, 4e-2)
    again = torch.empty_like(out)      # no atomics: bitwise repeatable
    fused_swin_block(x[:, :c], blk, packed["masks"], cfg, 32, 32, k, again)
    assert torch.equal(out, again)


def test_block_mode_forward_tracks_rdg_mode_at_window16(dev):
    cfg = DRCTModelConfig(upscale=2, img_size=32, window_size=16, in_chans=1,
                          embed_dim=12, num_layers=2, num_heads=2, gc=4)
    sd, _ = init_sr_params(cfg, torch.Generator().manual_seed(0), device=dev)
    packed = prepack_drct(sd, cfg, 32, 32, dtype=torch.bfloat16, device=dev,
                          mode="block")
    x = 255 * torch.rand(2, 32, 32, 1, device=dev)
    for fn in (rdg_layernorm, rdg_gemm, window_attention, fused_swin_block):
        fn.launches = 0
    with torch.no_grad():
        block = fused_drct_apply(packed, cfg, x)
        torch.cuda.synchronize()
        counts = [fn.launches for fn in (rdg_layernorm, rdg_gemm,
                                         window_attention, fused_swin_block)]
        rdg = fused_drct_apply(packed, cfg, x, mode="rdg")
    assert counts == [0, 5 * cfg.num_layers, 0, 5 * cfg.num_layers]
    rel = (block - rdg).norm() / rdg.norm()
    assert rel < 5e-2, rel
