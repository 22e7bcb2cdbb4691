"""Shared fixtures of the port's parity tests: tiny configs, JAX params made
from a seed and carried into the port's state_dict (numpy in between)."""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from adsr_tpu.core.config import DRCTModelConfig as JaxConfig
from adsr_tpu.models.drct import DRCT as JaxDRCT
from adsr_tpu.models.drct import SwinBlock
from adsr_tpu.models.factory import fast_init

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.io.convert import drct_state_dict_from_jax

# tiny configs: the JAX suite's tiny one, its heads config (embed 18, gc 6,
# heads 3), one whose head count really changes per block (dims
# 12/16/20/24/28 -> heads 3/2/1/3/2), window 8, RGB, window 16 (N = 256: 4
# windows an image, shift 8) and window 16 with the x8 tail (three pixel
# shuffles)
CONFIGS = {
    "tiny": dict(upscale=2, img_size=8, window_size=4, in_chans=1,
                 embed_dim=12, num_layers=2, num_heads=2, gc=4),
    "heads18": dict(upscale=2, img_size=8, window_size=4, in_chans=1,
                    embed_dim=18, num_layers=1, num_heads=3, gc=6),
    "fixup": dict(upscale=2, img_size=8, window_size=4, in_chans=1,
                  embed_dim=12, num_layers=1, num_heads=3, gc=4),
    "window8": dict(upscale=2, img_size=16, window_size=8, in_chans=1,
                    embed_dim=12, num_layers=1, num_heads=2, gc=4),
    "rgb": dict(upscale=2, img_size=8, window_size=4, in_chans=3,
                embed_dim=12, num_layers=1, num_heads=2, gc=4),
    "window16": dict(upscale=2, img_size=32, window_size=16, in_chans=1,
                     embed_dim=12, num_layers=1, num_heads=2, gc=4),
    "window16x8": dict(upscale=8, img_size=32, window_size=16, in_chans=1,
                       embed_dim=12, num_layers=1, num_heads=2, gc=4),
}

ATOL, RTOL = 2e-3, 1e-3        # the JAX suite's f32 forward tolerance


@functools.lru_cache(maxsize=None)
def jax_params(name: str, scan_layers: bool = True, seed: int = 0):
    """(jax cfg, port cfg, numpy param tree) with every leaf perturbed by a
    seeded N(0, 0.02) so biases and LayerNorm affines are not trivial."""
    kw = CONFIGS[name]
    jcfg = JaxConfig(**kw, scan_layers=scan_layers)
    x = jnp.zeros((1, jcfg.img_size, jcfg.img_size, jcfg.in_chans))
    params = fast_init(JaxDRCT(jcfg).init, jax.random.key(seed), x)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.02 * rng.randn(*np.shape(a)).astype(np.float32)),
        params)
    return jcfg, DRCTModelConfig(**kw, scan_layers=scan_layers), params


def port_state_dict(name: str, scan_layers: bool = True, seed: int = 0):
    _, pcfg, params = jax_params(name, scan_layers, seed)
    return drct_state_dict_from_jax(params, pcfg)


@functools.lru_cache(maxsize=None)
def jax_apply(name: str):
    jcfg = jax_params(name)[0]
    return jax.jit(JaxDRCT(jcfg).apply)


def jax_window_attention(qkv, bias, mask, b, h, w, nh, win, shift):
    """The JAX model's shifted-window attention on a raster-order qkv
    [B*h*w, 3c] (jnp): roll, window partition, ``window_attention_xla``,
    reverse. Returns the context [B*h*w, c]."""
    from adsr_tpu.models import drct as jdrct
    from adsr_tpu.ops.window_attention import window_attention_xla
    c = qkv.shape[-1] // 3
    hd = c // nh
    x = qkv.reshape(b, h, w, 3 * c)
    if shift:
        x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
    xw = jdrct.window_partition(x, win)
    q, k, v = xw.reshape(-1, win * win, 3, nh, hd).transpose(2, 0, 3, 1, 4)
    o = window_attention_xla(q * hd ** -0.5, k, v, bias,
                             None if mask is None else jnp.asarray(mask))
    o = jdrct.window_reverse(o.transpose(0, 2, 1, 3).reshape(-1, win * win, c),
                             win, h, w)
    if shift:
        o = jnp.roll(o, (shift, shift), axis=(1, 2))
    return o.reshape(b * h * w, c)


def lr_input(cfg, batch: int = 2, seed: int = 1) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, cfg.img_size, cfg.img_size, cfg.in_chans)
            * 255).astype(np.float32)


def lone_block_cfg(c, nh, win, mlp_ratio=2.0):
    """A config whose block 2 (k=1: shifted) and block 1 (k=0: not) are a
    lone Swin block's geometry: gc 0 keeps every block at width c."""
    return DRCTModelConfig(upscale=2, img_size=8, window_size=win,
                           in_chans=1, embed_dim=c, num_layers=1,
                           num_heads=nh, gc=0, mlp_ratio=mlp_ratio)


def jax_swin_block_case(c, nh, win, shift, h, seed=0):
    """A JAX ``SwinBlock`` of width ``c`` on ``h`` x ``h`` tokens, its params
    (seeded init plus a seeded N(0, 0.02) on every leaf, so biases,
    LayerNorm affines and the table matter) and an input [2, h*h, c] f32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h * h, c).astype(np.float32)
    blk = SwinBlock(dim=c, input_resolution=(h, h), num_heads=nh,
                    window_size=win, shift_size=shift, mlp_ratio=2.0)
    params = fast_init(blk.init, jax.random.key(seed), jnp.asarray(x),
                       (h, h))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.randn(*np.shape(a)).astype(np.float32), params)
    return blk, params, x
