"""Kernel (g)'s plain path (CPU tensors) against the JAX package's Pallas
``fused_swin_block`` in interpret mode, on the same numpy weights and inputs
(f32), and its packing against the RDG packer's."""

import os

os.environ["ADSR_TPU_PALLAS_INTERPRET"] = "1"

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.models.drct import shift_attn_mask
from adsr_tpu.ops.fused_swin_block import fused_swin_block as jax_block
from adsr_tpu.ops.fused_swin_block import pack_swin_weights as jax_pack

from adsr_tpu_torch.kernels import fused_swin_block as fsb
from adsr_tpu_torch.kernels.fused_rdg import _pack_block, rdg_geometry

from torch_port_util import (jax_params, jax_swin_block_case,
                             lone_block_cfg, port_state_dict)


# the JAX suite's case (tests/test_fused_swin_block.py:19-22), and one whose
# head dim (20) is not a multiple of 16, the kernel's padding case
@pytest.mark.parametrize("c,nh,shift", [(12, 2, 0), (12, 2, 2), (20, 1, 2)])
def test_plain_block_matches_jax_fused_swin_block(c, nh, shift):
    h, win = 8, 4
    _, params, x = jax_swin_block_case(c, nh, win, shift, h)
    mask = shift_attn_mask(h, h, win, shift) if shift else None
    packed = {k: jnp.asarray(v) for k, v in
              jax_pack(params, c, nh, win).items()}
    want = np.asarray(jax_block(jnp.asarray(x), packed, h, h, win, shift, nh,
                                c, mask=mask))
    cfg = lone_block_cfg(c, nh, win)
    k = 1 if shift else 0
    assert fsb.block_geometry(cfg, k) == {"c": c, "heads": nh,
                                          "hidden": 2 * c, "shift": shift}
    p = fsb.pack_swin_weights(params, c, win)
    masks = {shift: torch.from_numpy(mask)} if shift else {}
    xt = torch.from_numpy(x.reshape(-1, c))
    out = torch.empty_like(xt)
    fsb.fused_swin_block.launches = 0
    fsb.fused_swin_block(xt, p, masks, cfg, h, h, k, out)
    np.testing.assert_allclose(out.numpy().reshape(want.shape), want,
                               atol=3e-5, rtol=1e-4)
    assert fsb.fused_swin_block.launches == 0       # CPU: the plain path


def test_strided_concat_prefix_input():
    # the block reads cat[:, :c] at the concat buffer's row stride
    c, nh, win, h = 12, 2, 4, 8
    _, params, x = jax_swin_block_case(c, nh, win, 0, h, seed=3)
    cfg = lone_block_cfg(c, nh, win)
    p = fsb.pack_swin_weights(params, c, win)
    xt = torch.from_numpy(x.reshape(-1, c))
    wide = torch.cat([xt, torch.full((xt.shape[0], 8), float("nan"))], 1)
    a, b = torch.empty_like(xt), torch.empty_like(xt)
    fsb.fused_swin_block(wide[:, :c], p, {}, cfg, h, h, 0, a)
    fsb.fused_swin_block(xt, p, {}, cfg, h, h, 0, b)
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_packing_from_a_jax_tree_equals_the_rdg_packer():
    # the block dict carried over from a JAX SwinBlock tree is the one
    # _pack_block builds from the port's state_dict for the same weights
    _, pcfg, params = jax_params("tiny")
    sd = port_state_dict("tiny")
    g = rdg_geometry(pcfg)
    for k in range(5):
        tree = jax.tree_util.tree_map(
            lambda a: np.asarray(a)[1], params["rdgs"]["rdg"][f"swin{k + 1}"])
        got = fsb.pack_swin_weights(tree, g["feats"][k], pcfg.window_size)
        want = _pack_block(sd, 1, k + 1, g["feats"][k], pcfg.window_size,
                           torch.float32, "cpu")
        assert set(want) - set(got) == {"wadj", "badj"}
        for name, t in got.items():
            assert torch.equal(t, want[name]), (k, name)


def test_shape_errors_raise():
    cfg = lone_block_cfg(12, 2, 4)
    p = fsb.pack_swin_weights(jax_swin_block_case(12, 2, 4, 0, 8)[1], 12, 4)
    x = torch.zeros(2 * 64, 12)
    with pytest.raises(ValueError):
        fsb.fused_swin_block(x, p, {}, cfg, 8, 8, 0, torch.empty(128, 10))
    with pytest.raises(ValueError):           # shifted block without a mask
        fsb.fused_swin_block(x, p, {}, cfg, 8, 8, 1, torch.empty_like(x))
