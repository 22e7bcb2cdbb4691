"""The port's training forward and backward on CPU tensors, where every
kernel wrapper runs its plain PyTorch version: the drop-path schedule, the
eager model's gradients against ``jax.grad`` of the flax model, the RDG
Function against eager autograd, and each backward kernel's plain version
against autograd of its forward's plain version. The whole training forward
against the JAX fused training forward is in test_torch_train_forward.py."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from adsr_tpu.models.drct import DRCT as JaxDRCT
from adsr_tpu.ops import fused_rdg_train as jfrt

from adsr_tpu_torch.kernels import fused_rdg_train as frt
from adsr_tpu_torch.kernels import rdg_gemm_bwd as gb
from adsr_tpu_torch.kernels import rdg_layernorm_bwd as lb
from adsr_tpu_torch.kernels import window_attention_bwd as ab
from adsr_tpu_torch.kernels.fused_rdg import prepack_rdg_stack
from adsr_tpu_torch.kernels.rdg_gemm import rdg_gemm_plain
from adsr_tpu_torch.kernels.rdg_layernorm import rdg_layernorm_plain
from adsr_tpu_torch.kernels.window_attention import window_attention_plain
from adsr_tpu_torch.io.convert import drct_state_dict_from_jax
from adsr_tpu_torch.models.drct import (drop_path_mults, relative_position_bias,
                                        shift_attn_mask)
from adsr_tpu_torch.models.factory import make_model

from torch_port_util import jax_params, lr_input, port_state_dict

BWD_WRAPPERS = (gb.rdg_gemm_dgrad, gb.rdg_gemm_wgrad, lb.rdg_layernorm_bwd,
                ab.window_attention_bwd)


def _model(name):
    model = make_model(jax_params(name)[1], device="cpu")
    model.load_state_dict(port_state_dict(name))
    return model


def _hr(cfg, batch=2, seed=7):
    side = cfg.img_size * cfg.upscale
    return (np.random.RandomState(seed).rand(batch, side, side, cfg.in_chans)
            * 255).astype(np.float32)


def _assert_grads_close(got, want, names, atol_rel=2e-3, rtol=2e-2):
    """The JAX suite's scale-relative gradient tolerance
    (tests/test_fused_rdg_train.py:79-83)."""
    for k in names:
        a, b = want[k].numpy(), got[k].numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=atol_rel * scale, rtol=rtol,
                                   err_msg=k)


def test_drop_path_mults_schedule():
    _, cfg, _ = jax_params("tiny")                  # num_layers 2
    ones = drop_path_mults(torch.Generator().manual_seed(0), cfg, 4, True)
    assert ones.shape == (2, 4, 10) and bool((ones == 1).all())
    m = drop_path_mults(torch.Generator().manual_seed(1), cfg, 256, False)
    assert m.shape == (2, 256, 10) and m.dtype == torch.float32
    assert bool((m[0] == 1).all())                  # RDG 0: rate 0
    keep = 1.0 - 0.1 * 6 / (6 * cfg.num_layers - 1)
    vals = np.unique(m[1].numpy()).tolist()
    assert vals == pytest.approx([0.0, 1.0 / keep], rel=1e-6)
    drop = float((m[1] == 0).float().mean())
    assert abs(drop - (1 - keep)) < 0.02            # 2560 draws at rate 0.055
    # the JAX schedule and layout
    jm = np.asarray(jfrt.drop_path_mults(jax.random.key(1),
                                         jax_params("tiny")[0], 256, False))
    assert jm.shape == tuple(m.shape)
    assert np.unique(jm[1]).tolist() == pytest.approx(vals)


def test_drop_path_scales_branches_per_sample():
    model = _model("tiny")
    _, cfg, _ = jax_params("tiny")
    x = torch.from_numpy(lr_input(cfg, batch=3))
    with torch.no_grad():
        base = model(x)
        ones = model(x, dp=torch.ones(cfg.num_layers, 3, 10))
        dp = torch.ones(cfg.num_layers, 3, 10)
        dp[:, 1] = 0.0                               # every branch of image 1
        dropped = model(x, dp=dp)
    torch.testing.assert_close(ones, base, rtol=0, atol=0)
    torch.testing.assert_close(dropped[0], base[0], rtol=0, atol=0)
    assert not torch.allclose(dropped[1], base[1], atol=1e-3)


@pytest.mark.parametrize("name", ["tiny", "rgb"])
def test_eager_grads_match_jax_grad(name):
    jcfg, pcfg, params = jax_params(name)
    x, hr = lr_input(jcfg), _hr(jcfg)
    model = JaxDRCT(jcfg)

    def loss(p):
        return jnp.mean(jnp.abs(model.apply({"params": p}, x) - hr))

    jl, jg = jax.value_and_grad(loss)(params)
    want = drct_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg),
                                    pcfg)
    pm = _model(name)
    pl = (pm(torch.from_numpy(x)) - torch.from_numpy(hr)).abs().mean()
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    _assert_grads_close(got, want, sorted(want))


@pytest.mark.parametrize("name", ["tiny", "fixup", "window8", "rgb",
                                  "heads18"])
def test_rdg_function_matches_eager_autograd(name):
    """The fused path (plain kernel versions on the CPU) against the eager
    model under autograd, with drop-path zeros on some branches."""
    _, cfg, _ = jax_params(name)
    x = torch.from_numpy(lr_input(cfg, batch=3))
    hr = torch.from_numpy(_hr(cfg, batch=3))
    dp = drop_path_mults(torch.Generator().manual_seed(3), cfg, 3, False)
    dp[0, 0, 3] = dp[0, 2, 0] = dp[-1, 1, 9] = 0.0
    grads = []
    for fused in (True, False):
        model = _model(name)
        params = dict(model.named_parameters())
        sr = (frt.fused_drct_train_forward(params, cfg, x, dp,
                                           dtype=torch.float32)
              if fused else model(x, dp=dp))
        (sr - hr).abs().mean().backward()
        grads.append({k: p.grad for k, p in params.items()})
    _assert_grads_close(grads[0], grads[1], sorted(grads[1]), atol_rel=1e-5,
                        rtol=1e-4)


def test_rdg_train_plain_is_the_eager_rdg():
    _, cfg, _ = jax_params("window8")
    model = _model("window8")
    h = w = cfg.img_size
    x = torch.randn(2 * h * w, cfg.embed_dim,
                    generator=torch.Generator().manual_seed(0))
    dp = torch.ones(2, 10)
    dp[1, 4] = 0.0
    packed = prepack_rdg_stack(dict(model.named_parameters()), cfg, h, w,
                               torch.float32, "cpu", detach=False)
    got = frt.fused_rdg_train(x, packed["rdgs"][0], packed["masks"], cfg, h,
                              w, dp)
    want = frt.rdg_train_plain(model.layers[0], x, h, w, dp)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------- #
# each backward kernel's plain version against autograd of its forward
# --------------------------------------------------------------------------- #

def _rand(*shape, seed=0, scale=1.0):
    return torch.from_numpy((np.random.RandomState(seed).randn(*shape)
                             * scale).astype(np.float32))


def _vjp(fn, inputs, g):
    inputs = [t.clone().requires_grad_(True) for t in inputs]
    torch.autograd.backward(fn(*inputs), g)
    return [t.grad for t in inputs]


GEMM_CASES = {   # epilogue of the forward product -> the dY transform
    "none": {}, "leaky_relu": {"slope": True}, "scaled_residual":
    {"alpha": 0.2}, "drop_residual": {"scale": True}}


@pytest.mark.parametrize("epilogue", sorted(GEMM_CASES))
def test_gemm_bwd_plain_matches_autograd(epilogue):
    m, n, k = 24, 10, 12
    a, wt, bias = _rand(m, k, seed=1), _rand(n, k, seed=2), _rand(n, seed=3)
    res, g = _rand(m, n, seed=4), _rand(m, n, seed=5)
    scale = torch.tensor([1.25, 0.0, 0.5])
    row = scale if epilogue == "drop_residual" else None
    needs_res = epilogue in ("scaled_residual", "drop_residual")

    def fwd(a_, w_, b_):
        return rdg_gemm_plain(a_, w_, b_, epilogue,
                              res if needs_res else None, row)

    da, dw, db = _vjp(fwd, (a, wt, bias), g)
    spec = GEMM_CASES[epilogue]
    kw = dict(alpha=spec.get("alpha", 1.0), row_scale=row,
              slope_src=fwd(a, wt, bias) if spec.get("slope") else None)
    out = torch.full((m, k), float("nan"))
    gb.rdg_gemm_dgrad(g, wt, out, **kw)
    torch.testing.assert_close(out, da, atol=1e-5, rtol=1e-5)
    gw, gbias = torch.empty(n, k), torch.empty(n)
    gb.rdg_gemm_wgrad(g, a, gw, gbias, **kw)
    torch.testing.assert_close(gw, dw, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gbias, db, atol=1e-5, rtol=1e-5)


def test_gemm_dgrad_gelu_pre_and_strided_dy_match_autograd():
    # fc2's dgrad through the GELU of fc1: d(pre) = (dY @ W2) * GELU'(pre),
    # with dY read as a column slice of a wider f32 buffer
    m, f, c = 16, 12, 8
    pre, w2, b2 = _rand(m, f, seed=6, scale=2.0), _rand(c, f, seed=7), \
        _rand(c, seed=8)
    wide = _rand(m, c + 5, seed=9)
    g = wide[:, 3:3 + c]
    (dpre,) = _vjp(lambda p: rdg_gemm_plain(F.gelu(p), w2, b2), (pre,), g)
    out = torch.empty(m, f)
    gb.rdg_gemm_dgrad(g, w2, out, gelu_pre=pre)
    torch.testing.assert_close(out, dpre, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_residual", [False, True])
def test_layernorm_bwd_plain_matches_autograd_into_strided_slice(
        with_residual):
    m, c, width = 20, 14, 23
    wide = _rand(m, width, seed=10, scale=3.0) + 1.0
    x = wide[:, :c]                                  # a concat prefix
    w, bias, g = _rand(c, seed=11) + 1.0, _rand(c, seed=12), \
        _rand(m, c, seed=13)
    dx, dw, db = _vjp(lambda x_, w_, b_: rdg_layernorm_plain(x_, w_, b_),
                      (x, w, bias), g)
    acc = _rand(m, width, seed=14)                   # an f32 concat gradient
    before = acc.clone()
    residual = _rand(m, c, seed=15) if with_residual else None
    gw, gbias = torch.empty(c), torch.empty(c)
    lb.rdg_layernorm_bwd(x, g, w, acc[:, :c], gw, gbias, residual=residual)
    want = before[:, :c] + dx + (residual if with_residual else 0.0)
    torch.testing.assert_close(acc[:, :c], want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(acc[:, c:], before[:, c:], rtol=0, atol=0)
    torch.testing.assert_close(gw, dw, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gbias, db, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h,win,shift,c,nh", [
    (8, 4, 0, 12, 2), (8, 4, 2, 12, 3), (16, 8, 0, 16, 2), (16, 8, 4, 20, 1),
    (16, 8, 4, 28, 2)])
def test_window_attention_bwd_plain_matches_autograd(h, win, shift, c, nh):
    b, n = 2, win * win
    qkv = _rand(b * h * h, 3 * c, seed=16)
    table = _rand((2 * win - 1) ** 2, nh, seed=17)
    bias = relative_position_bias(table, win).contiguous()
    mask = torch.from_numpy(shift_attn_mask(h, h, win, shift)) if shift \
        else None
    g = _rand(b * h * h, c, seed=18)
    dqkv, dbias = _vjp(lambda q_, b_: window_attention_plain(
        q_, b_, mask, h, h, nh, win, shift), (qkv, bias), g)
    got_q, got_b = torch.empty(b * h * h, 3 * c), torch.empty(nh, n, n)
    ab.window_attention_bwd(qkv, g, bias, mask, h, h, nh, win, shift, got_q,
                            got_b)
    torch.testing.assert_close(got_q, dqkv, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got_b, dbias, atol=1e-5, rtol=1e-4)


def test_wgrad_splits_cover_the_rows():
    for m, n, k in [(16384, 924, 308), (16384, 32, 180), (16384, 180, 180),
                    (100, 8, 8), (1, 4, 4)]:
        s, rows = gb.wgrad_splits(m, n, k)
        assert rows % 32 == 0 and s * rows >= m > (s - 1) * rows
        assert s <= 65535


def test_bwd_wrappers_raise_rather_than_fall_back_off_the_cpu():
    meta = dict(device="meta")
    dy = torch.empty(16, 8, **meta)
    with pytest.raises(ValueError):
        gb.rdg_gemm_dgrad(dy, torch.empty(8, 4, **meta),
                          torch.empty(16, 4, **meta))
    with pytest.raises(ValueError):
        gb.rdg_gemm_wgrad(dy, torch.empty(16, 4, **meta),
                          torch.empty(8, 4, **meta), torch.empty(8, **meta))
    with pytest.raises(ValueError):
        lb.rdg_layernorm_bwd(dy, dy, torch.empty(8, **meta), dy,
                             torch.empty(8, **meta), torch.empty(8, **meta))
    assert [fn.launches for fn in BWD_WRAPPERS[:3]] == [0, 0, 0]


def test_fp32_train_step_on_cuda_is_refused():
    from adsr_tpu_torch.core.config import drct_experiment
    from adsr_tpu_torch.train.trainer import check_serving_precision
    exp = dataclasses.replace(drct_experiment(run_tag="t"), precision="fp32")
    with pytest.raises(NotImplementedError, match="fp32"):
        check_serving_precision(exp, torch.device("cuda"))
