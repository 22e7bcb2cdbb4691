"""The port's eager DRCT (adsr_tpu_torch/models/drct.py) against the JAX
model, with weights carried by drct_state_dict_from_jax (f32, CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.models import drct as jdrct

from adsr_tpu_torch.models import drct as pdrct
from adsr_tpu_torch.models.factory import init_sr_params, make_model

from torch_port_util import (ATOL, RTOL, CONFIGS, jax_apply, jax_params,
                             lr_input, port_state_dict)


@pytest.mark.parametrize("window", [2, 4, 8])
def test_relative_position_index_equal(window):
    np.testing.assert_array_equal(pdrct.relative_position_index(window),
                                  jdrct.relative_position_index(window))


@pytest.mark.parametrize("h,w,win,shift", [(8, 8, 4, 2), (16, 16, 8, 4),
                                           (32, 32, 8, 4), (16, 32, 8, 4)])
def test_shift_attn_mask_equal(h, w, win, shift):
    np.testing.assert_array_equal(pdrct.shift_attn_mask(h, w, win, shift),
                                  jdrct.shift_attn_mask(h, w, win, shift))


def _port_model(name):
    model = make_model(jax_params(name)[1], device="cpu")
    model.load_state_dict(port_state_dict(name))
    return model.eval()


def _rdg0(params):
    """Layer 0 of the scan-stacked RDG params."""
    return jax.tree_util.tree_map(lambda a: a[0], params["rdgs"]["rdg"])


@pytest.mark.parametrize("name", ["tiny", "fixup"])
def test_window_attention_and_swin_block_match_jax(name):
    jcfg, pcfg, params = jax_params(name)
    model = _port_model(name)
    rdg = _rdg0(params)
    h = w = jcfg.img_size
    win, shift = jcfg.window_size, jcfg.window_size // 2
    rng = np.random.RandomState(3)
    for k in (1, 2):                       # unshifted and shifted blocks
        c = jcfg.embed_dim + (k - 1) * jcfg.gc
        heads = getattr(model.layers[0], f"swin{k}").attn.num_heads
        blk = rdg[f"swin{k}"]
        # window attention on [B*nW, N, C] windows, with the shift mask
        xw = rng.randn(2 * (h // win) * (w // win), win * win, c) \
            .astype(np.float32)
        mask = jdrct.shift_attn_mask(h, w, win, shift)
        attn = jdrct.WindowAttention(dim=c, window_size=win, num_heads=heads)
        want = jax.jit(attn.apply)({"params": blk["attn"]}, xw, mask)
        with torch.no_grad():
            got = getattr(model.layers[0], f"swin{k}").attn(
                torch.from_numpy(xw), torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
        # the whole block, with the block's own shift
        x = rng.randn(2, h * w, c).astype(np.float32)
        swin = jdrct.SwinBlock(dim=c, input_resolution=(h, w),
                               num_heads=heads, window_size=win,
                               shift_size=0 if k == 1 else shift,
                               mlp_ratio=jcfg.mlp_ratio)
        want = jax.jit(lambda p, t: swin.apply({"params": p}, t, (h, w)))(
            blk, x)
        with torch.no_grad():
            got = getattr(model.layers[0], f"swin{k}")(torch.from_numpy(x),
                                                       (h, w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["tiny", "window8"])
def test_rdg_matches_jax(name):
    jcfg, _, params = jax_params(name)
    model = _port_model(name)
    h = w = jcfg.img_size
    x = np.random.RandomState(4).randn(2, h * w, jcfg.embed_dim) \
        .astype(np.float32)
    rdg = jdrct.RDG(dim=jcfg.embed_dim, input_resolution=(h, w),
                    num_heads=jcfg.num_heads, window_size=jcfg.window_size,
                    mlp_ratio=jcfg.mlp_ratio, gc=jcfg.gc)
    want = jax.jit(lambda p, t: rdg.apply({"params": p}, t, (h, w)))(
        _rdg0(params), x)
    with torch.no_grad():
        got = model.layers[0](torch.from_numpy(x), (h, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_drct_forward_matches_jax(name):
    jcfg, _, params = jax_params(name)
    x = lr_input(jcfg)
    want = np.asarray(jax_apply(name)({"params": params}, x))
    with torch.no_grad():
        got = _port_model(name)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, jcfg.img_size * jcfg.upscale,
                         jcfg.img_size * jcfg.upscale, jcfg.in_chans)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_layernorm_eps_is_flax_default():
    model = make_model(jax_params("tiny")[1], device="cpu")
    eps = {m.eps for m in model.modules() if isinstance(m, torch.nn.LayerNorm)}
    assert eps == {1e-6}


def test_seeded_init_is_deterministic_and_shaped_like_jax():
    from adsr_tpu.io.torch_convert import convert_drct, stack_scan_layers
    jcfg, pcfg, params = jax_params("tiny")
    a, _ = init_sr_params(pcfg, torch.Generator().manual_seed(7), device="cpu")
    b, _ = init_sr_params(pcfg, torch.Generator().manual_seed(7), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    tree = stack_scan_layers(convert_drct(
        {k: v.numpy() for k, v in a.items()}), jcfg.num_layers)
    got = {jax.tree_util.keystr(p): np.shape(v) for p, v in
           jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = {jax.tree_util.keystr(p): np.shape(v) for p, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    assert got == want
    # the distributions of the JAX package: trunc-normal(0.02) Linear weights
    w = a["layers.0.swin1.attn.qkv.weight"]
    assert w.abs().max() <= 0.04 + 1e-7 and 0.01 < w.std() < 0.02
    assert float(a["layers.0.swin1.attn.qkv.bias"].abs().max()) == 0.0
    assert float(a["norm.weight"].min()) == 1.0


@pytest.mark.slow
def test_full_size_param_count_and_names():
    from adsr_tpu.io.torch_convert import convert_drct, stack_scan_layers
    from adsr_tpu.core.config import drct_experiment as jax_experiment
    from adsr_tpu_torch.core.config import drct_experiment
    cfg = drct_experiment("grid", 128, 4, run_tag="t").model
    model = make_model(cfg, device="cpu")
    sd = model.state_dict()
    n = sum(v.numel() for v in sd.values())
    assert 27.0e6 < n < 27.8e6, n
    jcfg = jax_experiment("grid", 128, 4, run_tag="t").model
    shapes = jax.eval_shape(
        jdrct.DRCT(jcfg).init, jax.random.key(0),
        jnp.zeros((1, 32, 32, 1)))["params"]
    tree = stack_scan_layers(convert_drct({k: v.numpy()
                                           for k, v in sd.items()}), 12)
    got = {jax.tree_util.keystr(p): np.shape(v) for p, v in
           jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert got == want
