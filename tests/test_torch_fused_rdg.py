"""The port's fused serving path on CPU tensors, where every kernel wrapper
runs its plain PyTorch version: against the eager model and the JAX package
(f32), plain kernel versions against their JAX counterparts, and the launch
counters."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from adsr_tpu.models import drct as jdrct
from adsr_tpu.ops import fused_swin_block as jfsb
from adsr_tpu.ops.window_attention import window_attention_xla

from adsr_tpu_torch.core.config import drct_experiment
from adsr_tpu_torch.kernels import rdg_gemm as gemm_mod
from adsr_tpu_torch.kernels import rdg_layernorm as ln_mod
from adsr_tpu_torch.kernels import window_attention as attn_mod
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.kernels.fused_rdg import (fused_rdg, prepack_rdg_stack,
                                              rdg_flops, rdg_geometry,
                                              rdg_workspace)
from adsr_tpu_torch.models.drct import relative_position_bias
from adsr_tpu_torch.models.factory import make_model

from torch_port_util import (ATOL, RTOL, jax_apply, jax_params, lr_input,
                             port_state_dict)

WRAPPERS = (ln_mod.rdg_layernorm, gemm_mod.rdg_gemm, attn_mod.window_attention)


def _packed(name):
    _, pcfg, _ = jax_params(name)
    return pcfg, prepack_drct(port_state_dict(name), pcfg, pcfg.img_size,
                              pcfg.img_size, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("name", ["tiny", "fixup", "window8", "rgb"])
def test_fused_drct_matches_eager_and_jax(name):
    jcfg, pcfg, params = jax_params(name)
    cfg, packed = _packed(name)
    x = lr_input(jcfg)
    for fn in WRAPPERS:
        fn.launches = 0
    taps = []
    with torch.no_grad():
        got = fused_drct_apply(packed, cfg, torch.from_numpy(x), taps=taps)
        model = make_model(cfg, device="cpu")
        model.load_state_dict(port_state_dict(name))
        eager_taps = []
        eager = model(torch.from_numpy(x), taps=eager_taps)
    want = np.asarray(jax_apply(name)({"params": params}, x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), atol=ATOL,
                               rtol=RTOL)
    assert len(taps) == len(eager_taps) == cfg.num_layers
    for t, e in zip(taps, eager_taps):
        np.testing.assert_allclose(t.numpy(), e.numpy(), atol=1e-4, rtol=1e-4)
    # CPU tensors take the plain versions: no kernel was launched
    assert [fn.launches for fn in WRAPPERS] == [0, 0, 0]


def test_fused_rdg_in_place_matches_eager_rdg():
    _, pcfg, _ = jax_params("window8")
    sd = port_state_dict("window8")
    h = w = pcfg.img_size
    packed = prepack_rdg_stack(sd, pcfg, h, w, dtype=torch.float32,
                               device="cpu")
    model = make_model(pcfg, device="cpu")
    model.load_state_dict(sd)
    x = torch.from_numpy(np.random.RandomState(5).randn(
        3, h * w, pcfg.embed_dim).astype(np.float32))
    g = rdg_geometry(pcfg)
    m = 3 * h * w
    cat = torch.full((m, g["cat_width"]), float("nan"))   # stale columns
    cat[:, :pcfg.embed_dim] = x.reshape(m, -1)
    fused_rdg(cat, packed["rdgs"][0], packed["masks"], pcfg, h, w,
              rdg_workspace(m, pcfg, torch.float32, "cpu"))
    with torch.no_grad():
        want = model.layers[0](x, (h, w))
    np.testing.assert_allclose(cat[:, :pcfg.embed_dim].reshape(3, h * w, -1)
                               .numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


def test_layernorm_plain_matches_flax():
    rng = np.random.RandomState(0)
    x = (rng.randn(64, 40) * 3 + 1).astype(np.float32)
    s, b = rng.randn(40).astype(np.float32), rng.randn(40).astype(np.float32)
    want = nn.LayerNorm().apply({"params": {"scale": s, "bias": b}}, x)
    wide = torch.from_numpy(np.concatenate([x, rng.randn(64, 8)], 1)
                            .astype(np.float32))
    out = torch.empty(64, 40)
    ln_mod.rdg_layernorm(wide[:, :40], torch.from_numpy(s),
                         torch.from_numpy(b), out)   # strided concat prefix
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("epilogue", list(gemm_mod.EPILOGUES))
def test_gemm_plain_epilogues_match_jax(epilogue):
    rng = np.random.RandomState(1)
    a = rng.randn(32, 20).astype(np.float32)
    w = (rng.randn(20, 12) * 0.3).astype(np.float32)      # flax Dense [I, O]
    bias = rng.randn(12).astype(np.float32)
    res = rng.randn(32, 12).astype(np.float32)
    scale = np.asarray([1.25, 0.0, 0.5, 1.0], np.float32)   # 8 rows a sample
    y = jnp.asarray(a) @ w + bias
    want = {"none": y, "residual": y + res,
            "gelu": jax.nn.gelu(y, approximate=False),
            "leaky_relu": jax.nn.leaky_relu(y, 0.2),
            "scaled_residual": 0.2 * y + res,
            "drop_residual": res + np.repeat(scale, 8)[:, None] * y,
            "gelu_aux": jax.nn.gelu(y, approximate=False)}[epilogue]
    needs = epilogue in ("residual", "scaled_residual", "drop_residual")
    out, aux = torch.empty(32, 12), torch.empty(32, 12)
    gemm_mod.rdg_gemm(torch.from_numpy(a), torch.from_numpy(w.T.copy()),
                      torch.from_numpy(bias), out, epilogue,
                      torch.from_numpy(res) if needs else None,
                      torch.from_numpy(scale)
                      if epilogue == "drop_residual" else None,
                      aux if epilogue == "gelu_aux" else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if epilogue == "gelu_aux":          # the pre-activation, for GELU'
        np.testing.assert_allclose(aux.numpy(), np.asarray(y), atol=1e-5,
                                   rtol=1e-5)


def _jax_shifted_attention(qkv, bias, mask, b, h, w, nh, win, shift):
    """JAX reference: roll, window partition, window_attention_xla, reverse."""
    c = qkv.shape[-1] // 3
    hd = c // nh
    x = jnp.asarray(qkv).reshape(b, h, w, 3 * c)
    if shift:
        x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
    xw = jdrct.window_partition(x, win)
    q, k, v = xw.reshape(-1, win * win, 3, nh, hd).transpose(2, 0, 3, 1, 4)
    o = window_attention_xla(q * hd ** -0.5, k, v, jnp.asarray(bias),
                             None if mask is None else jnp.asarray(mask))
    o = jdrct.window_reverse(o.transpose(0, 2, 1, 3).reshape(-1, win * win, c),
                             win, h, w)
    if shift:
        o = jnp.roll(o, (shift, shift), axis=(1, 2))
    return np.asarray(o).reshape(b * h * w, c)


@pytest.mark.parametrize("h,win,shift,c,nh", [(8, 4, 0, 12, 2), (8, 4, 2, 12, 2),
                                              (16, 8, 4, 20, 1),
                                              (16, 8, 0, 18, 3)])
def test_window_attention_plain_matches_jax(h, win, shift, c, nh):
    rng = np.random.RandomState(2)
    b, n = 2, win * win
    qkv = rng.randn(b * h * h, 3 * c).astype(np.float32)
    table = rng.randn((2 * win - 1) ** 2, nh).astype(np.float32)
    bias = relative_position_bias(torch.from_numpy(table), win)
    mask = jdrct.shift_attn_mask(h, h, win, shift) if shift else None
    want = _jax_shifted_attention(qkv, bias.numpy(), mask, b, h, h, nh, win,
                                  shift)
    out = torch.empty(b * h * h, c)
    attn_mod.window_attention(torch.from_numpy(qkv), out, bias,
                              None if mask is None else torch.from_numpy(mask),
                              h, h, nh, win, shift)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)
    assert attn_mod.window_attention.launches == 0


def test_bias_gather_and_attn_term_match_jax():
    rng = np.random.RandomState(3)
    win, nh, h = 4, 3, 8
    table = rng.randn((2 * win - 1) ** 2, nh).astype(np.float32)
    swin_params = {
        "attn": {"qkv": {"kernel": np.zeros((6, 18), np.float32),
                         "bias": np.zeros(18, np.float32)},
                 "proj": {"kernel": np.zeros((6, 6), np.float32),
                          "bias": np.zeros(6, np.float32)},
                 "relative_position_bias_table": table},
        "mlp": {"fc1": {"kernel": np.zeros((6, 12), np.float32),
                        "bias": np.zeros(12, np.float32)},
                "fc2": {"kernel": np.zeros((12, 6), np.float32),
                        "bias": np.zeros(6, np.float32)}},
        "norm1": {"scale": np.ones(6, np.float32), "bias": np.zeros(6, np.float32)},
        "norm2": {"scale": np.ones(6, np.float32), "bias": np.zeros(6, np.float32)},
    }
    want_bias = np.asarray(jfsb.pack_swin_weights_jnp(swin_params, 6, nh, win)
                           ["bias"])
    bias = relative_position_bias(torch.from_numpy(table), win)
    np.testing.assert_array_equal(bias.numpy(), want_bias)
    mask = jdrct.shift_attn_mask(h, h, win, win // 2)
    want = np.asarray(jfsb.build_attn_term(want_bias, h, h, win, nh, mask,
                                           group=1))
    got = attn_mod.build_attn_term(bias, h, h, win, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_raise_rather_than_fall_back_off_the_cpu():
    a = torch.empty(16, 8, device="meta")
    w = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError):
        gemm_mod.rdg_gemm(a, w, torch.empty(4, device="meta"),
                          torch.empty(16, 4, device="meta"))
    with pytest.raises(ValueError):
        ln_mod.rdg_layernorm(a, torch.empty(8), torch.empty(8),
                             torch.empty(16, 8, device="meta"))
    assert gemm_mod.rdg_gemm.launches == 0 and ln_mod.rdg_layernorm.launches == 0


def test_flagship_rdg_flops_match_the_shape_arithmetic():
    cfg = drct_experiment("grid", 128, 4, run_tag="t").model
    # ~2.36M multiply-adds per token per RDG (matmuls + attention)
    assert rdg_flops(cfg, 1) / 2 == pytest.approx(2.362e6, rel=1e-3)
    g = rdg_geometry(cfg)
    assert g["feats"] == (180, 212, 244, 276, 308)
    assert g["heads"] == (6, 4, 2, 6, 4)
    assert [c // nh for c, nh in zip(g["feats"], g["heads"])] == \
        [30, 53, 122, 46, 77]
    assert g["hidden"] == (360, 424, 488, 276, 308)
    assert g["cat_width"] == 308


@pytest.mark.slow
def test_matches_jax_fused_drct_interpret(monkeypatch):
    from adsr_tpu.ops import fused_rdg as jfr
    from adsr_tpu.ops.fused_drct import fused_drct_apply as jax_fused
    from adsr_tpu.ops.fused_drct import prepack_drct as jax_prepack
    monkeypatch.setattr(jfr, "_INTERPRET", True)
    jcfg, _, params = jax_params("tiny")
    cfg, packed = _packed("tiny")
    x = lr_input(jcfg)
    jp = jax_prepack(params, jcfg, jcfg.img_size, jcfg.img_size,
                     dtype=jnp.float32, mode="rdg")
    want = np.asarray(jax_fused(jp, jcfg, x, dtype=jnp.float32))
    with torch.no_grad():
        got = fused_drct_apply(packed, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
