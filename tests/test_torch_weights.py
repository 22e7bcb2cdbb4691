"""drct_state_dict_from_jax is the inverse of the JAX package's
convert_drct + stack_scan_layers: the round trip gives the tree back bit for
bit, from the scan-stacked and the unrolled layouts alike."""

import numpy as np
import pytest
import torch

import jax

from adsr_tpu.io.torch_convert import convert_drct, stack_scan_layers

from adsr_tpu_torch.io.convert import drct_state_dict_from_jax
from adsr_tpu_torch.models.factory import make_model

from torch_port_util import jax_params


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["tiny", "rgb"])
def test_roundtrip_scan_stacked_bit_for_bit(name):
    _, pcfg, params = jax_params(name)
    sd = drct_state_dict_from_jax(params, pcfg)
    back = stack_scan_layers(convert_drct({k: v.numpy() for k, v in sd.items()}),
                             pcfg.num_layers)
    want, got = _flat(params), _flat(back)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_unrolled_layout_gives_the_same_state_dict():
    _, pcfg, stacked = jax_params("tiny")
    unrolled = {k: v for k, v in stacked.items() if k != "rdgs"}
    for i in range(pcfg.num_layers):
        unrolled[f"rdg_{i}"] = jax.tree_util.tree_map(
            lambda a, i=i: a[i], stacked["rdgs"]["rdg"])
    a = drct_state_dict_from_jax(stacked, pcfg)
    b = drct_state_dict_from_jax(unrolled, pcfg)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_state_dict_loads_strictly_with_the_conversions():
    _, pcfg, params = jax_params("tiny")
    sd = drct_state_dict_from_jax(params, pcfg)
    make_model(pcfg, device="cpu").load_state_dict(sd, strict=True)
    rdg = params["rdgs"]["rdg"]
    # Dense [I, O] -> Linear [O, I]; HWIO -> OIHW; 1x1 adjust -> Conv2d
    np.testing.assert_array_equal(sd["layers.1.swin2.attn.qkv.weight"].numpy(),
                                  rdg["swin2"]["attn"]["qkv"]["kernel"][1].T)
    np.testing.assert_array_equal(
        sd["conv_first.weight"].numpy(),
        params["conv_first"]["kernel"].transpose(3, 2, 0, 1))
    assert sd["layers.0.adjust5.weight"].shape == (12, 28, 1, 1)
    np.testing.assert_array_equal(sd["patch_embed.norm.weight"].numpy(),
                                  params["patch_norm"]["scale"])


def test_unmapped_param_raises():
    _, pcfg, params = jax_params("tiny")
    with pytest.raises(KeyError):
        drct_state_dict_from_jax({**params, "mystery": {"kernel": np.zeros(2)}},
                                 pcfg)
