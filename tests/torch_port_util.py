"""Shared fixtures of the port's parity tests: tiny configs, JAX params made
from a seed and carried into the port's state_dict (numpy in between)."""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from adsr_tpu.core.config import DRCTModelConfig as JaxConfig
from adsr_tpu.models.drct import DRCT as JaxDRCT
from adsr_tpu.models.factory import fast_init

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.io.convert import drct_state_dict_from_jax

# tiny configs: the JAX suite's tiny one, its heads config (embed 18, gc 6,
# heads 3), one whose head count really changes per block (dims
# 12/16/20/24/28 -> heads 3/2/1/3/2), window 8 and RGB
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


def lr_input(cfg, batch: int = 2, seed: int = 1) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, cfg.img_size, cfg.img_size, cfg.in_chans)
            * 255).astype(np.float32)
