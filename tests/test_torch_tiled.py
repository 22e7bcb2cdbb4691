"""The port's tiled serving (``eval/tiled.py``, ``make_tiled_serving_forward``)
against the JAX package's on the same numpy inputs (f32, CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adsr_tpu.eval import tiled as jtiled
from adsr_tpu.train.trainer import make_tiled_serving_forward as jax_tiled

from adsr_tpu_torch.eval import tiled as ptiled
from adsr_tpu_torch.train.trainer import make_tiled_serving_forward

from torch_port_util import ATOL, RTOL
from test_torch_serving import _experiments, _weights


@pytest.mark.parametrize("size,tile,overlap", [
    (8, 8, 2), (16, 8, 2), (16, 8, 8), (128, 32, 8), (100, 32, 8),
    (33, 32, 0), (20, 6, 5)])
def test_tile_starts_and_mask_match_jax(size, tile, overlap):
    assert ptiled.tile_starts(size, tile, overlap) == \
        jtiled.tile_starts(size, tile, overlap)
    np.testing.assert_array_equal(ptiled.feather_mask(tile * 4, overlap * 4),
                                  jtiled.feather_mask(tile * 4, overlap * 4))


def test_flagship_eval_geometry_is_25_tiles():
    # 512 px HR at x4: a 128 px LR image in 32 px tiles overlapping by 8
    assert len(ptiled.tile_starts(128, 32, 8)) ** 2 == 25


def _stand_in(scale):
    """A fixed tile forward: nearest upsample plus a term that depends on
    the crop's position (its first pixel), so misplaced tiles show."""
    def fwd(crops, xp):
        up = xp.repeat(xp.repeat(crops, scale, axis=1), scale, axis=2)
        return up * 1.5 + xp.sin(up) + crops[:, :1, :1, :]
    return fwd


@pytest.mark.parametrize("h,w,tile,overlap", [(16, 16, 8, 2), (20, 12, 8, 3),
                                              (8, 8, 8, 2)])
def test_tiled_forward_matches_jax(h, w, tile, overlap):
    rng = np.random.RandomState(0)
    lr = rng.rand(2, h, w, 1).astype(np.float32) * 255
    fwd = _stand_in(2)
    want = np.asarray(jtiled.tiled_sr_forward(lambda c: fwd(c, jnp), jnp.asarray(lr),
                                              tile, overlap, 2))

    class T:                  # numpy-style repeat for torch tensors
        @staticmethod
        def repeat(x, n, axis):
            return x.repeat_interleave(n, dim=axis)
        sin = staticmethod(torch.sin)

    got = ptiled.tiled_sr_forward(lambda c: fwd(c, T), torch.from_numpy(lr),
                                  tile, overlap, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * 255, rtol=1e-6)


def test_tiled_serving_matches_jax():
    jexp, pexp = _experiments()
    params, sd = _weights()
    rng = np.random.RandomState(1)
    lr = (rng.rand(3, 16, 16, 1) * 255).astype(np.float32)   # 2x2 tiles of 8
    want = np.asarray(jax_tiled(jexp, params, tile=8, overlap=2,
                                quantize_out=False)(jnp.asarray(lr)))
    got = make_tiled_serving_forward(pexp, sd, tile=8, overlap=2,
                                     quantize_out=False, device="cpu")(
        torch.from_numpy(lr)).numpy()
    assert got.shape == (3, 32, 32, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # quantised output: the 0-255 grid
    q = make_tiled_serving_forward(pexp, sd, tile=8, overlap=2,
                                   device="cpu")(torch.from_numpy(lr))
    torch.testing.assert_close(q, torch.round(q))


def test_tile_must_be_a_window_multiple():
    _, pexp = _experiments()          # window 4
    _, sd = _weights()
    with pytest.raises(ValueError, match="multiple of the model's window"):
        make_tiled_serving_forward(pexp, sd, tile=6, device="cpu")
    with pytest.raises(ValueError, match="multiple of the model's window"):
        make_tiled_serving_forward(pexp, sd, tile=2, device="cpu")
