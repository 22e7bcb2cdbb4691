"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA card with nvcc (sm_90a build) and skip elsewhere. The
card's machine has no JAX, so run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from adsr_tpu_torch.core.config import DataConfig, DRCTModelConfig, Experiment
from adsr_tpu_torch.core.graphs import CapturedCall
from adsr_tpu_torch.eval.serving import AnomalyServer
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
                                                     window_attention_plain,
                                                     window_attention_plan)
from adsr_tpu_torch.kernels.window_attention_bwd import (
    window_attention_bwd, window_attention_bwd_f32_plan,
    window_attention_bwd_plain, window_attention_bwd_plan)
from adsr_tpu_torch.models.drct import shift_attn_mask, shift_region_labels
from adsr_tpu_torch.metrics import _LUMA_COEFFS, to_luma
from adsr_tpu_torch.models.factory import init_sr_params, make_model
from adsr_tpu_torch.train.trainer import (make_serving_forward,
                                          make_tiled_serving_forward)

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
    # kernel (a)'s other pieces: the 4x4-window geometry's M (4,096 rows,
    # one step a block) from 16-byte rows into the unaligned contiguous
    # [m, 180] out (8-byte rows), and the 2-byte path (c = 178, a base
    # 4 bytes past alignment), each twice, bitwise equal
    wide = pitched(16 * 256, 312, device=dev)
    wide.copy_(torch.randn(16 * 256, 312, generator=g, device=dev))
    for x in (wide[:, :180], wide[:, :178], wide[:, 2:182]):
        wc, bc = w[:x.shape[1]].contiguous(), b[:x.shape[1]].contiguous()
        got = [torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
               for _ in range(2)]
        for o in got:
            rdg_layernorm(x, wc, bc, o)
        _close(got[0], rdg_layernorm_plain(x.float(), wc, bc), 1e-4)
        assert torch.equal(got[0], got[1])

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


def test_fp16_on_the_card_raises(dev):
    # kernels (a)-(c) take bf16 or f32; fp16 raises before any launch
    x = torch.zeros(64, 12, dtype=torch.float16, device=dev)
    n0 = rdg_layernorm.launches, rdg_layernorm.launches_f32
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        rdg_layernorm(x, torch.ones(12, device=dev), torch.zeros(12, device=dev),
                      torch.empty_like(x))
    assert (rdg_layernorm.launches, rdg_layernorm.launches_f32) == n0
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


def test_block_mode_forward_tracks_rdg_mode_at_window4(dev):
    # a tiny model at 4x4 windows (head dims 6-14, widths 12-28: the
    # kernels' narrow-head and 4-column-tail paths), both modes through
    # kernels (c) and (g) at N = 16
    cfg = DRCTModelConfig(upscale=2, img_size=16, window_size=4, in_chans=1,
                          embed_dim=12, num_layers=2, num_heads=2, gc=4)
    sd, _ = init_sr_params(cfg, torch.Generator().manual_seed(0), device=dev)
    packed = prepack_drct(sd, cfg, 16, 16, dtype=torch.bfloat16, device=dev,
                          mode="block")
    x = 255 * torch.rand(3, 16, 16, 1, device=dev)
    for fn in (rdg_layernorm, rdg_gemm, window_attention, fused_swin_block):
        fn.launches = 0
    with torch.no_grad():
        block = fused_drct_apply(packed, cfg, x)
        torch.cuda.synchronize()
        counts = [fn.launches for fn in (rdg_layernorm, rdg_gemm,
                                         window_attention, fused_swin_block)]
        rdg = fused_drct_apply(packed, cfg, x, mode="rdg")
        model = make_model(cfg, device=dev)
        model.load_state_dict(sd)
        eager = model(x)
    assert counts == [0, 5 * cfg.num_layers, 0, 5 * cfg.num_layers]
    assert window_attention.launches == 5 * cfg.num_layers
    for got in (block, rdg):
        rel = (got - eager).norm() / eager.norm()
        assert rel < 1.5e-2, rel


# ---- serving through CUDA graphs (core/graphs.py) ----

WINDOW16 = DRCTModelConfig(upscale=2, img_size=32, window_size=16,
                           in_chans=1, embed_dim=12, num_layers=2,
                           num_heads=2, gc=4)
COUNTED = (rdg_layernorm, rdg_gemm, window_attention, fused_swin_block)


def _launches():
    return [fn.launches for fn in COUNTED]


def _experiment(cfg):
    hr = cfg.img_size * cfg.upscale
    return Experiment(model=cfg, data=DataConfig(
        resolution=hr, patch_size=hr, scale=(cfg.upscale,),
        n_colors=cfg.in_chans, batch_size=4), precision="bf16")


@pytest.mark.parametrize("window16,mode", [(False, "rdg"), (False, "block"),
                                           (True, "rdg"), (True, "block")])
def test_serving_replay_equals_launched_bitwise(dev, window16, mode):
    cfg = WINDOW16 if window16 else CFG
    sd, _ = init_sr_params(cfg, torch.Generator().manual_seed(0), device=dev)
    graphed = make_serving_forward(_experiment(cfg), sd, dev, mode=mode)
    launched = make_serving_forward(_experiment(cfg), sd, dev, mode=mode,
                                    graphs=False)
    side = cfg.img_size
    xs = [255 * torch.rand(2, side, side, 1, device=dev) for _ in range(4)]
    n0 = _launches()
    outs = [graphed(xs[0])]                          # warm-up
    per_call = [a - b for a, b in zip(_launches(), n0)]
    outs += [graphed(x) for x in xs[1:]]             # capture, replays
    torch.cuda.synchronize()
    assert sum(per_call) > 0 and graphed.captured() == 1
    # the capture counts one call's launches, a replay none
    assert [a - b for a, b in zip(_launches(), n0)] == \
        [2 * n for n in per_call]
    for x, got in zip(xs, outs):     # earlier results survive later replays
        assert torch.equal(got, launched(x))


def test_tiled_replay_equals_launched_and_each_shape_has_a_graph(dev):
    sd, _ = init_sr_params(CFG, torch.Generator().manual_seed(0), device=dev)
    exp = _experiment(CFG)
    graphed = make_tiled_serving_forward(exp, sd, overlap=4, device=dev)
    launched = make_tiled_serving_forward(exp, sd, overlap=4, device=dev,
                                          graphs=False)
    xs = [255 * torch.rand(2, 40, 40, 1, device=dev) for _ in range(3)] \
        + [255 * torch.rand(3, 24, 40, 1, device=dev) for _ in range(3)]
    outs = [graphed(x) for x in xs]
    assert graphed.captured() == 2 and len(graphed.signatures()) == 2
    assert graphed.reserved_bytes() > 0
    for x, got in zip(xs, outs):
        assert torch.equal(got, launched(x))


def test_server_replay_equals_launched_scores(dev):
    sd, _ = init_sr_params(CFG, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.RandomState(0)
    lr = rng.randint(0, 256, (11, 16, 16, 1), np.uint8)   # 4 + 4 + 3 (tail)
    hr = rng.randint(0, 256, (11, 32, 32, 1), np.uint8)
    scores = []
    for graphs in (True, False):
        server = AnomalyServer(batch_size=4, ssim_window=7, device=dev,
                               graphs=graphs)
        server.register("grid", _experiment(CFG), sd, mode="rdg")
        scores.append(server.score("grid", lr, hr))
        scores.append(server.score("grid", lr, hr))
    assert scores[0].shape == (11, 3) and np.isfinite(scores[0]).all()
    for got in scores[:3]:
        np.testing.assert_array_equal(got, scores[3])


def test_to_luma_is_the_channel_sum_on_the_card(dev):
    x = torch.rand(4, 33, 17, 3, device=dev)
    coeffs = torch.tensor(_LUMA_COEFFS, device=dev)
    assert torch.equal(to_luma(x), (x * coeffs).sum(-1, keepdim=True))


def test_capture_of_a_host_sync_raises(dev):
    cc = CapturedCall(lambda x: x * x.sum().item(), dev)
    x = torch.ones(4, device=dev)
    assert torch.equal(cc(x), x * 4)                # the warm-up launches
    for _ in range(2):                              # and never again
        with pytest.raises(RuntimeError):
            cc(x)
    assert cc.captured() == 0


# ---- 4x4 windows (N = 16): the 64/x4 model's blocks (hd 30/53/122/46/77,
# shifts 0 and 2); (c) and (f) take every head of a window a block: one
# window a block at batch 2 and 16 on 16 x 16 tokens and at batch 5 on 20 x
# 20 (125 windows), a persistent grid of staged windows at batch 128 (2,048
# windows, the route of the tiled CLI's crops) ----

W4_CASES = [(212, 4, 2, 2, 16), (244, 2, 0, 2, 16), (180, 6, 2, 5, 20),
            (308, 4, 0, 16, 16), (276, 6, 2, 16, 16), (244, 2, 2, 128, 16),
            (180, 6, 0, 128, 16)]


def _w4_route(plan, b):
    """The route the window-4 plan took: staged windows on a persistent
    grid at batch 128, one window a block below."""
    assert (plan["stages"] > 1) == (b == 128), plan
    assert plan["grid"] == min(plan["windows"],
                               plan["blocks_per_sm"] * _build.sm_count(
                                   torch.device("cuda")))


@pytest.mark.parametrize("c,nh,shift,b,h", W4_CASES)
def test_window_attention_kernel_matches_plain_at_window4(dev, c, nh, shift,
                                                          b, h):
    # P rounds to bf16 once before P @ V: 2^-8 max|v| (the N = 64 bound);
    # qkv and ctx column slices of wider 16-byte-row buffers, the context
    # not written past its columns; a second launch bitwise equal
    _w4_route(window_attention_plan(c, nh, b, h, h, window=4,
                                    sms=_build.sm_count(dev)), b)
    g = torch.Generator(device=dev).manual_seed(8)
    m = b * h * h
    qkv = pitched(m, 3 * c + 8, device=dev)[:, :3 * c]
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    bias = 0.5 * torch.randn(nh, 16, 16, generator=g, device=dev)
    mask = torch.as_tensor(shift_attn_mask(h, h, 4, shift), device=dev) \
        if shift else None
    wide = torch.zeros(m, 320, dtype=torch.bfloat16, device=dev)
    n0 = window_attention.launches
    window_attention(qkv, wide[:, :c], bias, mask, h, h, nh, 4, shift)
    assert window_attention.launches == n0 + 1
    atol = 2.0 ** -8 * qkv[:, 2 * c:].float().abs().max().item()
    _close(wide[:, :c], window_attention_plain(qkv, bias, mask, h, h, nh, 4,
                                               shift), atol)
    assert not wide[:, c:].any()
    again = torch.zeros_like(wide)
    window_attention(qkv, again[:, :c], bias, mask, h, h, nh, 4, shift)
    assert torch.equal(again, wide)
    assert window_attention.launches == n0 + 2


@pytest.mark.parametrize("c,nh,shift,b,h", W4_CASES)
def test_window_attention_bwd_kernel_matches_plain_at_window4(dev, c, nh,
                                                              shift, b, h):
    # one launch and the partial sums: 2^-7 of each output's largest
    # magnitude, d(bias) 2^-8 (the N = 64 bounds); a second call bitwise
    # equal
    _w4_route(window_attention_bwd_plan(c, nh, b, h, h,
                                        _build.sm_count(dev), 4), b)
    g = torch.Generator(device=dev).manual_seed(9)
    m = b * h * h
    qkv = pitched(m, 3 * c, device=dev)
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    dout = pitched(m, c, device=dev)
    dout.copy_(torch.randn(m, c, generator=g, device=dev))
    bias = 0.5 * torch.randn(nh, 16, 16, generator=g, device=dev)
    mask = torch.as_tensor(shift_attn_mask(h, h, 4, shift), device=dev) \
        if shift else None
    dqkv = pitched(m, 3 * c, device=dev)
    dbias = torch.empty(nh, 16, 16, device=dev)
    n0 = window_attention_bwd.launches
    window_attention_bwd(qkv, dout, bias, mask, h, h, nh, 4, shift, dqkv,
                         dbias)
    assert window_attention_bwd.launches == n0 + 1
    want_q, want_b = window_attention_bwd_plain(qkv, dout, bias, mask, h, h,
                                                nh, 4, shift)
    for i in range(3):
        part = want_q[:, i * c:(i + 1) * c]
        _within(dqkv[:, i * c:(i + 1) * c], part,
                2.0 ** -7 * (part.abs().max() + part.abs()))
    _within(dbias, want_b, 2.0 ** -8 * want_b.abs().max())
    dq2, db2 = pitched(m, 3 * c, device=dev), torch.empty_like(dbias)
    window_attention_bwd(qkv, dout, bias, mask, h, h, nh, 4, shift, dq2, db2)
    assert torch.equal(dqkv, dq2) and torch.equal(dbias, db2)
    assert window_attention_bwd.launches == n0 + 2


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("b,side", [(2, 16), (5, 20), (16, 32)])
def test_swin_block_kernel_matches_plain_at_window4(dev, k, b, side):
    # the 64/x4 model's five blocks at 4x4 windows, four windows a group: a
    # cluster of two blocks a group at 2 x 16 x 16 and 5 x 20 x 20 (there
    # the last group holds one window), one block a group at 16 x 32 x 32
    # (256 groups fill the card); the bound of the 8x8 case
    cfg = DRCTModelConfig(upscale=4, img_size=side, window_size=4,
                          in_chans=1, embed_dim=180, num_layers=1,
                          num_heads=6, gc=32)
    sd, _ = init_sr_params(cfg, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(k)
    sd = {n: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
          for n, v in sd.items()}
    packed = prepack_rdg_stack(sd, cfg, side, side, torch.bfloat16, dev)
    blk = packed["rdgs"][0][k]
    c = (180, 212, 244, 276, 308)[k]
    m = b * side * side
    x = torch.randn(m, 308, generator=gen).to(dev).to(torch.bfloat16)
    out = torch.empty(m, c, dtype=torch.bfloat16, device=dev)
    n0 = fused_swin_block.launches
    fused_swin_block(x[:, :c], blk, packed["masks"], cfg, side, side, k, out)
    assert fused_swin_block.launches == n0 + 1
    want = fused_swin_block_plain(x[:, :c], blk, packed["masks"], cfg, side,
                                  side, k)
    _close(out, want, 4e-2)
    again = torch.empty_like(out)      # no atomics: bitwise repeatable
    fused_swin_block(x[:, :c], blk, packed["masks"], cfg, side, side, k,
                     again)
    assert torch.equal(out, again)


# ---- the f32 instances of (a)-(c) (fp32 serving) ----
#
# Each against its plain f32 version on the same inputs on the card (TF32
# off in the fixture): both sum exact f32 products in f32 in another order,
# ~1e-7 relative a value; the limits are relative L2 1e-5 and a max-abs
# of 1e-5 of the largest reference value (attention, LayerNorm) or of the
# sum of |products| (GEMM).


def _rel_l2(got, want):
    return ((got.float() - want).norm() / want.norm()).item()


def _f32_close(got, want, scale=None):
    scale = want.abs().max() if scale is None else scale
    assert torch.isfinite(got).all()
    assert _rel_l2(got, want) <= 1e-5
    _within(got, want, 1e-5 * scale)


@pytest.mark.parametrize("c,stride,off", [(180, 308, 0), (212, 308, 0),
                                          (308, 308, 0), (178, 308, 1),
                                          (244, 244, 0)])
def test_f32_layernorm_matches_plain(dev, c, stride, off):
    # the concat prefix at stride 308 (16-byte pieces), a contiguous x1, and
    # the 4-byte path (c = 178 from a base one float past alignment)
    g = torch.Generator(device=dev).manual_seed(c)
    m = 2 * 1024 + 7
    cat = 2 * torch.randn(m, stride + off, generator=g, device=dev) + 0.5
    x = cat[:, off:off + c]
    w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    out = pitched(m, c, dtype=torch.float32, device=dev)
    n0 = rdg_layernorm.launches, rdg_layernorm.launches_f32
    rdg_layernorm(x, w, b, out)
    assert (rdg_layernorm.launches, rdg_layernorm.launches_f32) == \
        (n0[0], n0[1] + 1)
    _f32_close(out, rdg_layernorm_plain(x, w, b))
    again = torch.empty_like(out)
    rdg_layernorm(x, w, b, again)
    assert torch.equal(out, again)


@pytest.mark.parametrize("n,k", [(32, 180), (540, 180), (180, 360),
                                 (924, 308), (308, 616), (180, 308)])
@pytest.mark.parametrize("epi", ["none", "residual", "gelu", "leaky_relu",
                                 "scaled_residual", "drop_residual",
                                 "gelu_aux"])
def test_f32_gemm_matches_plain(dev, n, k, epi):
    # the flagship's product shapes at an M that is not a multiple of the
    # 128-row tile, A a column prefix of a wider buffer, out a column slice
    # at an odd stride, residual aliased by out where the epilogue reads it
    g = torch.Generator(device=dev).manual_seed(n + k)
    b = 3
    m = b * 1004
    wide = torch.randn(m, k + 12, generator=g, device=dev)
    a = wide[:, :k]
    w = pitched(n, k, dtype=torch.float32, device=dev)
    w.copy_(0.05 * torch.randn(n, k, generator=g, device=dev))
    bias = 0.05 * torch.randn(n, generator=g, device=dev)
    dst = torch.randn(m, n + 9, generator=g, device=dev)
    out = dst[:, 5:5 + n]
    res = out.clone() if epi in ("residual", "scaled_residual",
                                 "drop_residual") else None
    scale = torch.tensor([1.1, 0.0, 1.1], device=dev) if \
        epi == "drop_residual" else None
    aux = torch.empty(m, n, device=dev) if epi == "gelu_aux" else None
    want = rdg_gemm_plain(a, w, bias, epi, res, scale)
    before = dst.clone()
    n0 = rdg_gemm.launches, rdg_gemm.launches_f32
    rdg_gemm(a, w, bias, out, epi, out if res is not None else None, scale,
             aux)
    assert (rdg_gemm.launches, rdg_gemm.launches_f32) == (n0[0], n0[1] + 1)
    size = (a.abs() @ w.abs().t()).max()
    _f32_close(out, want, size + want.abs().max())
    if aux is not None:
        _f32_close(aux, rdg_gemm_plain(a, w, bias), size)
    # columns outside the slice are untouched
    assert torch.equal(dst[:, :5], before[:, :5])
    assert torch.equal(dst[:, 5 + n:], before[:, 5 + n:])


@pytest.mark.parametrize("m", [4096, 16384, 65536])
@pytest.mark.parametrize("n,k,epi", [(540, 180, "none"),
                                     (180, 360, "residual"),
                                     (32, 180, "leaky_relu")])
def test_f32_gemm_tile_widths_match_plain(dev, m, n, k, epi):
    # the 3xTF32 kernel at one RDG's token rows at windows 4, 8 and 16,
    # where its tile width changes with M (kernels/rdg_gemm.py
    # f32_tile_width): qkv, fc2 (out aliasing residual) and adjust, all in
    # 16-byte rows as the main path lays them out, twice bitwise
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    a = pitched(m, k, dtype=torch.float32, device=dev)
    a.copy_(torch.randn(m, k, generator=g, device=dev))
    w = pitched(n, k, dtype=torch.float32, device=dev)
    w.copy_(0.05 * torch.randn(n, k, generator=g, device=dev))
    bias = 0.05 * torch.randn(n, generator=g, device=dev)
    res = pitched(m, n, dtype=torch.float32, device=dev)
    res.copy_(torch.randn(m, n, generator=g, device=dev))
    want = rdg_gemm_plain(a, w, bias, epi,
                          res if epi == "residual" else None)
    outs = []
    for _ in range(2):
        out = res.clone() if epi == "residual" else \
            pitched(m, n, dtype=torch.float32, device=dev)
        n0 = rdg_gemm.launches_f32
        rdg_gemm(a, w, bias, out, epi, out if epi == "residual" else None)
        assert rdg_gemm.launches_f32 == n0 + 1
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    _f32_close(outs[0], want, (a.abs() @ w.abs().t()).max()
               + want.abs().max())


F32_ATTN = [(180, 6), (212, 4), (244, 2), (276, 6), (308, 4)]


@pytest.mark.parametrize("win", [4, 8, 16])
@pytest.mark.parametrize("c,nh", F32_ATTN)
def test_f32_attention_matches_plain(dev, win, c, nh):
    # the flagship's five block geometries (head dims 30/53/122/46/77) at
    # windows 4, 8 and 16, shift 0 and half the window, in the forms
    # attn_operands gives (the table and region labels at window 16); at
    # window 16 also the softmax statistics the training recompute asks for
    g = torch.Generator(device=dev).manual_seed(win * c)
    side = 2 * win if win == 16 else 4 * win
    b = 2
    m = b * side * side
    n = win * win
    qkv = pitched(m, 3 * c, dtype=torch.float32, device=dev)
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    if win == 16:
        bias = 0.5 * torch.randn(nh, 961, generator=g, device=dev)
    else:
        bias = 0.5 * torch.randn(nh, n, n, generator=g, device=dev)
    for shift in (0, win // 2):
        mask = None
        if shift and win == 16:
            mask = torch.as_tensor(shift_region_labels(side, side, win, shift),
                                   device=dev)
        elif shift:
            mask = torch.as_tensor(shift_attn_mask(side, side, win, shift),
                                   device=dev)
        out = pitched(m, c, dtype=torch.float32, device=dev)
        n0 = window_attention.launches, window_attention.launches_f32
        window_attention(qkv, out, bias, mask, side, side, nh, win, shift)
        assert (window_attention.launches, window_attention.launches_f32) \
            == (n0[0], n0[1] + 1)
        want = window_attention_plain(qkv, bias, mask, side, side, nh, win,
                                      shift)
        _f32_close(out, want)
        again = pitched(m, c, dtype=torch.float32, device=dev)
        window_attention(qkv, again, bias, mask, side, side, nh, win, shift)
        assert torch.equal(out, again)
    if win == 16:       # with a buffer, each query row's (max, 1 / sum)
        stats = softmax_stats(qkv, side, side, nh, win)
        want_s = torch.empty_like(stats)
        window_attention(qkv, out, bias, mask, side, side, nh, win, shift,
                         stats)
        want = window_attention_plain(qkv, bias, mask, side, side, nh, win,
                                      shift, want_s)
        _f32_close(out, want)
        for i in range(2):
            _f32_close(stats[..., i], want_s[..., i])


@pytest.mark.parametrize("win,side", [(4, 20), (8, 40), (16, 32)])
@pytest.mark.parametrize("c,nh", F32_ATTN)
def test_f32_attention_batch5_matches_plain(dev, win, side, c, nh):
    # batch 5 on windows that do not fill a power of two (20 x 20, 40 x 40
    # and 32 x 32 tokens), both shifts, twice bitwise; at window 16 the
    # statistics too
    g = torch.Generator(device=dev).manual_seed(win * c + 5)
    m, n = 5 * side * side, win * win
    qkv = pitched(m, 3 * c, dtype=torch.float32, device=dev)
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    bias = 0.5 * (torch.randn(nh, 961, generator=g, device=dev) if win == 16
                  else torch.randn(nh, n, n, generator=g, device=dev))
    for shift in (0, win // 2):
        mask = None
        if shift:
            mask = torch.as_tensor(
                (shift_region_labels if win == 16 else shift_attn_mask)(
                    side, side, win, shift), device=dev)
        stats = softmax_stats(qkv, side, side, nh, win)
        want_s = None if stats is None else torch.empty_like(stats)
        outs = [pitched(m, c, dtype=torch.float32, device=dev)
                for _ in range(2)]
        for out in outs:
            window_attention(qkv, out, bias, mask, side, side, nh, win, shift,
                             stats)
        assert torch.equal(outs[0], outs[1])
        want = window_attention_plain(qkv, bias, mask, side, side, nh, win,
                                      shift, want_s)
        _f32_close(outs[0], want)
        if stats is not None:
            for i in range(2):
                _f32_close(stats[..., i], want_s[..., i])


@pytest.mark.parametrize("win", [4, 8, 16])
@pytest.mark.parametrize("c,nh", [(64, 8), (96, 4), (176, 2), (120, 1),
                                  (256, 2)])
def test_f32_attention_head_tiles_match_plain(dev, win, c, nh):
    # head dims the flagship does not use (8, 24, 88, 120, 128: head tiles
    # 16, 32, 96, 128 and a whole 128), at shift half the window
    g = torch.Generator(device=dev).manual_seed(win + c * nh)
    side, n = 2 * win, win * win
    m = 2 * side * side
    qkv = pitched(m, 3 * c, dtype=torch.float32, device=dev)
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    bias = 0.5 * (torch.randn(nh, 961, generator=g, device=dev) if win == 16
                  else torch.randn(nh, n, n, generator=g, device=dev))
    shift = win // 2
    mask = torch.as_tensor(
        (shift_region_labels if win == 16 else shift_attn_mask)(
            side, side, win, shift), device=dev)
    out = pitched(m, c, dtype=torch.float32, device=dev)
    window_attention(qkv, out, bias, mask, side, side, nh, win, shift)
    _f32_close(out, window_attention_plain(qkv, bias, mask, side, side, nh,
                                           win, shift))


# ---- the f32 instances of (d)-(f) (fp32 training) ----
#
# The limits of the f32 forward kernels above: both sides sum exact f32
# products in f32 in another order.


@pytest.mark.parametrize("n,k", [(32, 180), (96, 212), (924, 308),
                                 (180, 360), (180, 308)])
def test_f32_gemm_bwd_matches_plain(dev, n, k):
    # products of the flagship's shapes (adjust 1-4, a narrow one, qkv of
    # block 5, fc2 of block 1, adjust 5) at an M that is not a multiple of
    # the 128-row tile, dY and the LeakyReLU source f32 column slices of
    # wider buffers; every dY transform of the training backward
    g = torch.Generator(device=dev).manual_seed(n + k)
    f32 = torch.float32
    m = 2 * 1004
    wide = torch.randn(m, n + 44, generator=g, device=dev)
    src = torch.randn(m, n + 44, generator=g, device=dev)
    w = pitched(n, k, dtype=f32, device=dev)
    w.copy_(0.05 * torch.randn(n, k, generator=g, device=dev))
    a = pitched(m, k, dtype=f32, device=dev)
    a.copy_(torch.randn(m, k, generator=g, device=dev))
    pre = torch.randn(m, k, generator=g, device=dev)
    scale = torch.tensor([1.1, 0.0], device=dev)
    dy, slope = wide[:, 40:40 + n], src[:, 40:40 + n]
    for kw in ({}, {"slope_src": slope}, {"alpha": 0.2},
               {"row_scale": scale}, {"row_scale": scale, "gelu_pre": pre}):
        wkw = {key: v for key, v in kw.items() if key != "gelu_pre"}
        runs = []
        for _ in range(2):          # twice: bitwise equal
            got = (torch.empty(m, k, device=dev), torch.empty(n, k, device=dev),
                   torch.empty(n, device=dev))
            n0 = [(fn.launches, fn.launches_f32)
                  for fn in (gb.rdg_gemm_dgrad, gb.rdg_gemm_wgrad)]
            gb.rdg_gemm_grads(dy, w, a, *got, **kw)
            assert [(fn.launches, fn.launches_f32)
                    for fn in (gb.rdg_gemm_dgrad, gb.rdg_gemm_wgrad)] == \
                [(x, y + 1) for x, y in n0]
            runs.append(got)
        (out, dw, db), again = runs
        assert all(torch.equal(x, y) for x, y in zip(again, (out, dw, db)))
        eff = gb.dy_effective(dy, kw.get("alpha", 1.0), kw.get("slope_src"),
                              kw.get("row_scale"))
        want = gb.rdg_gemm_dgrad_plain(dy, w, **kw)
        bound = eff.abs() @ w.abs()
        if "gelu_pre" in kw:
            bound = bound * gb.gelu_grad(pre).abs()
        _f32_close(out, want, bound.max() + want.abs().max())
        want_w, want_b = gb.rdg_gemm_wgrad_plain(dy, a, **wkw)
        _f32_close(dw, want_w, (eff.abs().t() @ a.abs()).max())
        _f32_close(db, want_b, eff.abs().sum(0).max())
        # dgrad and wgrad alone: the same products
        alone = torch.empty_like(out)
        gb.rdg_gemm_dgrad(dy, w, alone, **kw)
        dw2, db2 = torch.empty_like(dw), torch.empty_like(db)
        gb.rdg_gemm_wgrad(dy, a, dw2, db2, **wkw)
        assert torch.equal(alone, out) and torch.equal(dw2, dw) \
            and torch.equal(db2, db)


@pytest.mark.parametrize("m", [4096, 65536])
@pytest.mark.parametrize("n,k,kw", [(32, 180, "slope"), (540, 180, "none"),
                                    (360, 180, "gelu"), (180, 360, "scale"),
                                    (180, 308, "alpha")])
def test_f32_gemm_bwd_long_reductions_match_plain(dev, m, n, k, kw):
    # one RDG's token rows at windows 4 and 16 (M = 65,536: wgrad's splits
    # reduce over thousands of rows each, summed in two levels): adjust's
    # N = 32 with the LeakyReLU, qkv, fc1's dgrad with GELU', fc2 with the
    # drop-path multipliers, adjust 5 with its 0.2; dY and A in 16-byte
    # rows, twice bitwise
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    f32 = torch.float32
    dy = pitched(m, n, dtype=f32, device=dev)
    dy.copy_(torch.randn(m, n, generator=g, device=dev))
    w = pitched(n, k, dtype=f32, device=dev)
    w.copy_(0.05 * torch.randn(n, k, generator=g, device=dev))
    a = pitched(m, k, dtype=f32, device=dev)
    a.copy_(torch.randn(m, k, generator=g, device=dev))
    args = {"none": {}, "alpha": {"alpha": 0.2},
            "slope": {"slope_src": torch.randn(m, n, generator=g,
                                               device=dev)},
            "gelu": {"gelu_pre": torch.randn(m, k, generator=g, device=dev)},
            "scale": {"row_scale": torch.tensor([1.1, 0.0, 1.1, 1.1],
                                                device=dev)}}[kw]
    runs = []
    for _ in range(2):
        got = (torch.empty(m, k, device=dev), torch.empty(n, k, device=dev),
               torch.empty(n, device=dev))
        gb.rdg_gemm_grads(dy, w, a, *got, **args)
        runs.append(got)
    (out, dw, db), again = runs
    assert all(torch.equal(x, y) for x, y in zip(again, (out, dw, db)))
    wkw = {key: v for key, v in args.items() if key != "gelu_pre"}
    eff = gb.dy_effective(dy, args.get("alpha", 1.0), args.get("slope_src"),
                          args.get("row_scale"))
    want = gb.rdg_gemm_dgrad_plain(dy, w, **args)
    bound = eff.abs() @ w.abs()
    if "gelu_pre" in args:
        bound = bound * gb.gelu_grad(args["gelu_pre"]).abs()
    _f32_close(out, want, bound.max() + want.abs().max())
    want_w, want_b = gb.rdg_gemm_wgrad_plain(dy, a, **wkw)
    _f32_close(dw, want_w, (eff.abs().t() @ a.abs()).max())
    _f32_close(db, want_b, eff.abs().sum(0).max())


@pytest.mark.parametrize("c,stride", [(180, 308), (244, 308), (308, 308),
                                      (212, 212)])
def test_f32_layernorm_bwd_matches_plain(dev, c, stride):
    # the concat prefix at stride 308 and a contiguous x1, accumulating into
    # the strided f32 concat gradient, with and without a second gradient
    g = torch.Generator(device=dev).manual_seed(c + stride)
    m = 2 * 1024 + 7
    cat = 1 + 2 * torch.randn(m, stride, generator=g, device=dev)
    w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    dy = torch.randn(m, c, generator=g, device=dev)
    res = torch.randn(m, c, generator=g, device=dev)
    dcat = torch.randn(m, 308, generator=g, device=dev)
    x = cat[:, :c]
    gx, gw, gbias = rdg_layernorm_bwd_plain(x, dy, w)
    for residual in (res, None):
        runs = []
        for _ in range(2):          # twice: bitwise equal
            acc = dcat.clone()
            dw, db = torch.empty(c, device=dev), torch.empty(c, device=dev)
            n0 = rdg_layernorm_bwd.launches, rdg_layernorm_bwd.launches_f32
            rdg_layernorm_bwd(x, dy, w, acc[:, :c], dw, db, residual=residual)
            assert (rdg_layernorm_bwd.launches,
                    rdg_layernorm_bwd.launches_f32) == (n0[0], n0[1] + 1)
            runs.append((acc, dw, db))
        assert all(torch.equal(p, q) for p, q in zip(*runs))
        acc, dw, db = runs[0]
        want = dcat[:, :c] + gx + (0.0 if residual is None else residual)
        _f32_close(acc[:, :c], want)
        assert torch.equal(acc[:, c:], dcat[:, c:])
        _f32_close(dw, gw)
        _f32_close(db, gbias)


F32_BWD_CASES = [(win, c, nh, 2) for win in (4, 8, 16)
                 for c, nh in F32_ATTN] + [(8, 180, 6, 5), (4, 212, 4, 5)]


@pytest.mark.parametrize("win,c,nh,b", F32_BWD_CASES)
def test_f32_attention_bwd_matches_plain(dev, win, c, nh, b):
    # the flagship's five block geometries at windows 4, 8 and 16, shift 0
    # and half the window, qkv, dO and dqkv in 16-byte rows as the training
    # backward lays them out; at window 16 fed kernel (c) f32's own context
    # and softmax statistics; at batch 5 on 40 x 40 (window 8) and 20 x 20
    # (window 4) tokens the plan's last group of windows is short
    g = torch.Generator(device=dev).manual_seed(win * c + b)
    f32 = torch.float32
    side = 2 * win if win == 16 else (4 * win if b == 2 else 5 * win)
    m = b * side * side
    n = win * win
    qkv = pitched(m, 3 * c, dtype=f32, device=dev)
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    dout = pitched(m, c, dtype=f32, device=dev)
    dout.copy_(torch.randn(m, c, generator=g, device=dev))
    if win == 16:
        bias = 0.5 * torch.randn(nh, 961, generator=g, device=dev)
    else:
        bias = 0.5 * torch.randn(nh, n, n, generator=g, device=dev)
    plan = window_attention_bwd_f32_plan(c, nh, b, side, side, win,
                                         _build.sm_count(dev))
    assert plan["groups"] * plan["group"] >= plan["windows"]
    for shift in (0, win // 2):
        mask = None
        if shift and win == 16:
            mask = torch.as_tensor(shift_region_labels(side, side, win, shift),
                                   device=dev)
        elif shift:
            mask = torch.as_tensor(shift_attn_mask(side, side, win, shift),
                                   device=dev)
        fwd = ()
        if win == 16:
            ctx = pitched(m, c, dtype=f32, device=dev)
            stats = softmax_stats(qkv, side, side, nh, win)
            window_attention(qkv, ctx, bias, mask, side, side, nh, win, shift,
                             stats)
            fwd = (ctx, stats)
        runs = []
        for _ in range(2):          # twice: bitwise equal
            dqkv = pitched(m, 3 * c, dtype=f32, device=dev)
            dbias = torch.empty(nh, n, n, device=dev)
            n0 = window_attention_bwd.launches, \
                window_attention_bwd.launches_f32
            window_attention_bwd(qkv, dout, bias, mask, side, side, nh, win,
                                 shift, dqkv, dbias, *fwd)
            assert (window_attention_bwd.launches,
                    window_attention_bwd.launches_f32) == \
                (n0[0], n0[1] + plan["launches"])
            runs.append((dqkv, dbias))
        assert all(torch.equal(p, q) for p, q in zip(*runs))
        dqkv, dbias = runs[0]
        want_q, want_b = window_attention_bwd_plain(
            qkv, dout, bias, mask, side, side, nh, win, shift, *fwd)
        for i in range(3):
            _f32_close(dqkv[:, i * c:(i + 1) * c],
                       want_q[:, i * c:(i + 1) * c])
        _f32_close(dbias, want_b)


@pytest.mark.parametrize("c,nh", [(64, 8), (96, 4), (160, 4), (176, 2),
                                  (216, 2), (120, 1)])
def test_f32_attention_bwd16_head_tiles_match_plain(dev, c, nh):
    # the N = 256 tensor-core kernel at head tiles the flagship does not
    # use (head dims 8, 24, 40, 88, 108 and 120: both dkv shared-memory
    # layouts, every head-dim split of dq's two warps), both shifts, fed
    # kernel (c) f32's context and statistics, twice bitwise
    g = torch.Generator(device=dev).manual_seed(c * nh)
    f32, side, b, n = torch.float32, 32, 2, 256
    m = b * side * side
    qkv = pitched(m, 3 * c, dtype=f32, device=dev)
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    dout = pitched(m, c, dtype=f32, device=dev)
    dout.copy_(torch.randn(m, c, generator=g, device=dev))
    bias = 0.5 * torch.randn(nh, 961, generator=g, device=dev)
    for shift in (0, 8):
        mask = torch.as_tensor(shift_region_labels(side, side, 16, shift),
                               device=dev) if shift else None
        ctx = pitched(m, c, dtype=f32, device=dev)
        stats = softmax_stats(qkv, side, side, nh, 16)
        window_attention(qkv, ctx, bias, mask, side, side, nh, 16, shift,
                         stats)
        runs = []
        for _ in range(2):
            dqkv = pitched(m, 3 * c, dtype=f32, device=dev)
            dbias = torch.empty(nh, n, n, device=dev)
            window_attention_bwd(qkv, dout, bias, mask, side, side, nh, 16,
                                 shift, dqkv, dbias, ctx, stats)
            runs.append((dqkv, dbias))
        assert all(torch.equal(p, q) for p, q in zip(*runs))
        dqkv, dbias = runs[0]
        want_q, want_b = window_attention_bwd_plain(
            qkv, dout, bias, mask, side, side, nh, 16, shift, ctx, stats)
        for i in range(3):
            _f32_close(dqkv[:, i * c:(i + 1) * c],
                       want_q[:, i * c:(i + 1) * c])
        _f32_close(dbias, want_b)


def _f32_experiment(cfg):
    hr = cfg.img_size * cfg.upscale
    return Experiment(model=cfg, data=DataConfig(
        resolution=hr, patch_size=hr, scale=(cfg.upscale,),
        n_colors=cfg.in_chans, batch_size=4), precision="fp32")


@pytest.mark.parametrize("cfg", [CFG, WINDOW16], ids=["window8", "window16"])
def test_f32_forward_tracks_eager_and_launches_only_f32(dev, cfg):
    sd, _ = init_sr_params(cfg, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(1)
    sd = {k: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
          for k, v in sd.items()}
    side = cfg.img_size
    packed = prepack_drct(sd, cfg, side, side, dtype=torch.float32,
                          device=dev, mode="rdg")
    g = torch.Generator(device=dev).manual_seed(2)
    x = 255 * torch.rand(2, side, side, 1, generator=g, device=dev)
    fns = (rdg_layernorm, rdg_gemm, window_attention, fused_swin_block)
    with torch.no_grad():
        model = make_model(cfg, device=dev)
        model.load_state_dict(sd)
        want = model(x)
        per = cfg.num_layers
        # rdg mode: (a)-(c) f32; block mode: (g) f32 and the adjust on (b)
        for mode, launches in (
                ("rdg", [(0, 10 * per), (0, 25 * per), (0, 5 * per), (0, 0)]),
                ("block", [(0, 0), (0, 5 * per), (0, 0), (0, 5 * per)])):
            n0 = [(fn.launches, fn.launches_f32) for fn in fns]
            got = fused_drct_apply(packed, cfg, x, mode=mode)
            torch.cuda.synchronize()
            counts = [(fn.launches - a, fn.launches_f32 - b)
                      for fn, (a, b) in zip(fns, n0)]
            assert counts == launches, mode
            assert _rel_l2(got, want) <= 1e-5, mode


@pytest.mark.parametrize("mode", ["rdg", "block"])
def test_f32_serving_replay_equals_launched_bitwise(dev, mode):
    sd, _ = init_sr_params(CFG, torch.Generator().manual_seed(0), device=dev)
    exp = _f32_experiment(CFG)
    graphed = make_serving_forward(exp, sd, dev, mode=mode)
    launched = make_serving_forward(exp, sd, dev, mode=mode, graphs=False)
    g = torch.Generator(device=dev).manual_seed(3)
    xs = [255 * torch.rand(2, 16, 16, 1, generator=g, device=dev)
          for _ in range(4)]
    outs = [graphed(x) for x in xs]
    assert graphed.captured() == 1
    for x, got in zip(xs, outs):
        assert torch.equal(got, launched(x))


# ---- the f32 instance of (g) (fp32 block mode) ----


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("win,b,side", [(8, 2, 32), (16, 2, 32), (4, 2, 16),
                                        (4, 5, 20), (16, 5, 32)])
def test_f32_swin_block_matches_plain(dev, k, win, b, side):
    # the flagship's five blocks (c 180..308, heads 6/4/2/6/4, hd
    # 30/53/122/46/77) at each window: a block a window at 8x8, a cluster
    # of four a window at 16x16, four windows a block at 4x4 (at 5 x 20 x
    # 20 the last block holds one window); f32 throughout, twice bitwise
    cfg = DRCTModelConfig(upscale=4, img_size=side, window_size=win,
                          in_chans=1, embed_dim=180, num_layers=1,
                          num_heads=6, gc=32)
    sd, _ = init_sr_params(cfg, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(k)
    sd = {n: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
          for n, v in sd.items()}
    packed = prepack_rdg_stack(sd, cfg, side, side, torch.float32, dev)
    blk = packed["rdgs"][0][k]
    c = (180, 212, 244, 276, 308)[k]
    m = b * side * side
    x = torch.randn(m, 308, generator=gen).to(dev)
    outs = [torch.empty(m, c, device=dev) for _ in range(2)]
    n0 = (fused_swin_block.launches, fused_swin_block.launches_f32)
    for out in outs:
        fused_swin_block(x[:, :c], blk, packed["masks"], cfg, side, side, k,
                         out)
    assert (fused_swin_block.launches, fused_swin_block.launches_f32) == \
        (n0[0], n0[1] + 2)
    want = fused_swin_block_plain(x[:, :c], blk, packed["masks"], cfg, side,
                                  side, k)
    _f32_close(outs[0], want)
    assert torch.equal(outs[0], outs[1])


# ---- f32 (g) and (f) f32 at N = 16 / 64 on the tensor cores (3xTF32) ----

F32_BLOCKS = [(180, 6, 360), (212, 4, 424), (244, 2, 488), (276, 6, 276),
              (308, 4, 308)]


def _lone_block(k, win, side, dev, seed):
    """Block ``k`` of a flagship-width RDG (random weights from ``seed``) as
    a lone block: a config whose blocks 1 and 2 (unshifted, shifted) have
    its width, heads and hidden width, its packed f32 dict and the masks."""
    cfg = DRCTModelConfig(upscale=4, img_size=side, window_size=win,
                          in_chans=1, embed_dim=180, num_layers=1,
                          num_heads=6, gc=32)
    sd, _ = init_sr_params(cfg, torch.Generator().manual_seed(seed),
                           device=dev)
    gen = torch.Generator().manual_seed(seed + 1)
    sd = {n: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
          for n, v in sd.items()}
    packed = prepack_rdg_stack(sd, cfg, side, side, torch.float32, dev)
    c, nh, f = F32_BLOCKS[k]
    lone = DRCTModelConfig(upscale=4, img_size=side, window_size=win,
                           in_chans=1, embed_dim=c, num_layers=1,
                           num_heads=nh, gc=0, mlp_ratio=f / c)
    return lone, packed["rdgs"][0][k], packed["masks"]


@pytest.mark.parametrize("win,b,side", [(8, 2, 32), (4, 2, 16), (16, 2, 32),
                                        (4, 5, 20), (16, 5, 32)])
@pytest.mark.parametrize("k", range(5))
def test_f32_swin_block_tc_both_shifts_match_plain(dev, k, win, b, side):
    # every flagship block width (c, heads, hidden) at both shifts and the
    # three windows (at 5 x 20 x 20 a short last group of four windows, at
    # 5 x 32 x 32 twenty clusters), twice bitwise: the 3xTF32 products' two
    # levels, the two key halves' merge and LN2 staged from the output rows
    cfg, blk, masks = _lone_block(k, win, side, dev, 40 + k + win)
    c = F32_BLOCKS[k][0]
    g = torch.Generator(device=dev).manual_seed(c * win + b)
    m = b * side * side
    x = pitched(m, c, dtype=torch.float32, device=dev)
    x.copy_(torch.randn(m, c, generator=g, device=dev))
    for kk in (0, 1):
        outs = [torch.empty(m, c, device=dev) for _ in range(2)]
        for out in outs:
            fused_swin_block(x, blk, masks, cfg, side, side, kk, out)
        want = fused_swin_block_plain(x, blk, masks, cfg, side, side, kk)
        _f32_close(outs[0], want)
        assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("win,side", [(8, 32), (4, 16), (16, 32)])
def test_f32_swin_block_in_place_matches_plain(dev, win, side):
    # out aliasing x: the kernel writes the stream after proj into the
    # output rows for fc1's LN2 and reads each row of x only before that
    cfg, blk, masks = _lone_block(4, win, side, dev, 7 + win)
    c = F32_BLOCKS[4][0]
    g = torch.Generator(device=dev).manual_seed(win)
    m = 2 * side * side
    for k in (0, 1):
        x = torch.randn(m, c, generator=g, device=dev)
        want = fused_swin_block_plain(x, blk, masks, cfg, side, side, k)
        fused_swin_block(x, blk, masks, cfg, side, side, k, x)
        _f32_close(x, want)


def _attention_bwd_case(dev, win, c, nh, b, side, seed):
    """(f) f32 at 4x4 or 8x8 windows against its plain version at both
    shifts, twice bitwise, qkv, dO and dqkv in 16-byte rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    m, n = b * side * side, win * win
    qkv = pitched(m, 3 * c, dtype=f32, device=dev)
    qkv.copy_(torch.randn(m, 3 * c, generator=g, device=dev))
    dout = pitched(m, c, dtype=f32, device=dev)
    dout.copy_(torch.randn(m, c, generator=g, device=dev))
    bias = 0.5 * torch.randn(nh, n, n, generator=g, device=dev)
    for shift in (0, win // 2):
        mask = None if not shift else torch.as_tensor(
            shift_attn_mask(side, side, win, shift), device=dev)
        runs = []
        for _ in range(2):
            dqkv = pitched(m, 3 * c, dtype=f32, device=dev)
            dqkv.fill_(7.0)               # every head's columns are written
            dbias = torch.empty(nh, n, n, device=dev)
            window_attention_bwd(qkv, dout, bias, mask, side, side, nh, win,
                                 shift, dqkv, dbias)
            runs.append((dqkv, dbias))
        assert all(torch.equal(p, q) for p, q in zip(*runs))
        dqkv, dbias = runs[0]
        want_q, want_b = window_attention_bwd_plain(
            qkv, dout, bias, mask, side, side, nh, win, shift)
        for i in range(3):
            _f32_close(dqkv[:, i * c:(i + 1) * c],
                       want_q[:, i * c:(i + 1) * c])
        _f32_close(dbias, want_b)


@pytest.mark.parametrize("win,b,side", [(4, 5, 20), (8, 5, 40), (4, 16, 16),
                                        (8, 3, 32)])
@pytest.mark.parametrize("c,nh", F32_ATTN)
def test_f32_attention_bwd_tc_match_plain(dev, win, b, side, c, nh):
    # (f) f32 at N = 16 and 64 at the five flagship widths: batch 5 (a short
    # last set of four 4x4 windows, a short last group), batch 16 on 16 x
    # 16 (the 64/x4 training shape) and 3 x 32 x 32
    _attention_bwd_case(dev, win, c, nh, b, side, 17 * c + side)


@pytest.mark.parametrize("win", [4, 8])
@pytest.mark.parametrize("c,nh", [(64, 8), (96, 4), (176, 2), (120, 1)])
def test_f32_attention_bwd_tc_head_tiles_match_plain(dev, win, c, nh):
    # head tiles the flagship does not use (hd 8, 24, 88, 120 -> 16, 32, 96,
    # 128): one and two sets of planes, one and two blocks an SM
    _attention_bwd_case(dev, win, c, nh, 2, 4 * win, 5 * c + win)
