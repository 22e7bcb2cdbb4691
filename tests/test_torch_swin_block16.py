"""Kernel (g) ``swin_block`` at 16x16 windows (N = 256) on the CPU: its
plain version against the JAX package's Pallas ``fused_swin_block`` in
interpret mode at window 16, on the same numpy weights and inputs (f32);
its launch plan at the 256px model's five blocks (a cluster of four blocks
a window, one 64-row query tile each); and the window-16 token map the
kernels compute (``csrc/window_tiles.cuh`` ``WinRows``) against the plain
version's roll. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import os

os.environ["ADSR_TPU_PALLAS_INTERPRET"] = "1"

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adsr_tpu.models.drct import shift_attn_mask
from adsr_tpu.ops.fused_swin_block import fused_swin_block as jax_block
from adsr_tpu.ops.fused_swin_block import pack_swin_weights as jax_pack

from adsr_tpu_torch.core.config import drct_experiment
from adsr_tpu_torch.kernels import fused_swin_block as fsb
from adsr_tpu_torch.kernels import window_attention as wa
from adsr_tpu_torch.kernels.fused_rdg import rdg_geometry
from adsr_tpu_torch.models.drct import window_partition

from torch_port_util import ATOL, RTOL, jax_swin_block_case, lone_block_cfg

WIN, SIDE = 16, 32                    # 4 windows an image, 2 images


# the lone block at window 16, both shifts, and hd 20 (not a multiple of
# 16: the kernel's head-tile padding case)
@pytest.mark.parametrize("c,nh,shift", [(12, 2, 0), (12, 2, 8), (20, 1, 8)])
def test_plain_block_matches_jax_fused_swin_block_at_window16(c, nh, shift):
    _, params, x = jax_swin_block_case(c, nh, WIN, shift, SIDE, seed=16)
    mask = shift_attn_mask(SIDE, SIDE, WIN, shift) if shift else None
    packed = {k: jnp.asarray(v) for k, v in
              jax_pack(params, c, nh, WIN).items()}
    want = np.asarray(jax_block(jnp.asarray(x), packed, SIDE, SIDE, WIN,
                                shift, nh, c, mask=mask))
    cfg = lone_block_cfg(c, nh, WIN)
    k = 1 if shift else 0
    p = fsb.pack_swin_weights(params, c, WIN)
    assert p["attn_bias"].shape == (nh, 256, 256)
    masks = {shift: torch.from_numpy(mask)} if shift else {}
    xt = torch.from_numpy(x.reshape(-1, c))
    out = torch.empty_like(xt)
    n0 = fsb.fused_swin_block.launches
    fsb.fused_swin_block(xt, p, masks, cfg, SIDE, SIDE, k, out)
    np.testing.assert_allclose(out.numpy().reshape(want.shape), want,
                               atol=ATOL, rtol=RTOL)
    assert fsb.fused_swin_block.launches == n0      # CPU: the plain path


# drct_experiment("grid", 256, 4): (c, hidden, heads) of the five blocks
BLOCKS_256 = [(180, 360, 6), (212, 424, 4), (244, 488, 2), (276, 276, 6),
              (308, 308, 4)]


def test_256px_blocks_match_the_shipped_config():
    g = rdg_geometry(drct_experiment("grid", 256, 4).model)
    assert list(zip(g["feats"], g["hidden"], g["heads"])) == BLOCKS_256


@pytest.mark.parametrize("c,f,nh", BLOCKS_256)
@pytest.mark.parametrize("b", [16, 5])
def test_swin_block_plan_at_window16(c, f, nh, b):
    p = fsb.swin_block_plan(c, f, nh, b, 64, 64, window=WIN)
    assert 2 <= p["stages"] <= fsb.MAX_STAGES
    assert p["smem_bytes"] <= wa.BLOCK_SHARED_MAX
    assert p["stages"] == fsb.MAX_STAGES or \
        p["smem_bytes"] + fsb.STAGE_BYTES + 16 > wa.BLOCK_SHARED_MAX
    # the 8x8 kernel's regions, the context region widened to the staged
    # K and V tiles of a peer block ([2][64][hdp + 8] bf16)
    kp = -(-c // 64) * 64
    hk = -(-(c // nh + 7) // 64)
    staging = 2 * 64 * (p["hdp"] + 8) * 2
    assert p["staging_bytes"] == staging
    assert p["smem_bytes"] == (1024 + p["stages"] * (fsb.STAGE_BYTES + 16)
                               + kp * 128 + max(hk * 8192, staging)
                               + 64 * p["ldx"] * 4
                               + 3 * 64 * (p["hdp"] + 8) * 2)
    assert 1024 + sum(p["regions"].values()) == p["smem_bytes"]
    assert p["regions"]["ctx"] >= staging
    # every block of a cluster streams every weight tile of the block
    assert p["window_weight_tiles"] == 4 * p["weight_tiles"]
    # a cluster of 4 blocks a window: the grid is a multiple of the
    # cluster, and decoded as the source does (the query tile is the rank
    # in the cluster, then window, then image) every (image, window, query
    # tile) comes once
    assert p["cluster"] == fsb.CLUSTER == 4 and p["windows"] == b * 16
    assert p["blocks"] % p["cluster"] == 0
    seen = {(i // (4 * 16), (i // 4) % 16, i % 4) for i in range(p["blocks"])}
    assert len(seen) == p["blocks"] == b * 16 * 4
    assert {s[0] for s in seen} == set(range(b))
    assert p["threads"] == 288
    # the 8x8 plan is the window argument's default, without staging
    p8 = fsb.swin_block_plan(c, f, nh, b, 64, 64)
    assert p8 == fsb.swin_block_plan(c, f, nh, b, 64, 64, window=8)
    assert p8["cluster"] == 1 and p8["staging_bytes"] == 0


def test_swin_block_plan_refuses_other_windows():
    # windows 4, 8 and 16 have plans; window 2 has none
    with pytest.raises(ValueError, match="window 2"):
        fsb.swin_block_plan(180, 360, 6, 16, 64, 64, window=2)


def _win_rows(b, h, w, win, shift):
    """[b * nW, win * win] raster rows of each shifted window's tokens, the
    kernels' map: token t of window (wi, wj) of image img is row
    ((wi win + t // win + shift) mod h) * w + (wj win + t % win + shift)
    mod w of the image, the wrap taken once."""
    rows = []
    for img in range(b):
        for wi in range(h // win):
            for wj in range(w // win):
                r = wi * win + np.arange(win * win) // win + shift
                c = wj * win + np.arange(win * win) % win + shift
                r = np.where(r >= h, r - h, r)
                c = np.where(c >= w, c - w, c)
                rows.append(img * h * w + r * w + c)
    return np.stack(rows)


@pytest.mark.parametrize("shift", [0, 8])
def test_window16_token_map_is_the_plain_roll(shift):
    b, h = 2, 64
    rows = _win_rows(b, h, h, WIN, shift)
    assert sorted(rows.ravel().tolist()) == list(range(b * h * h))
    # the plain version: roll by -shift, then window_partition
    ids = torch.arange(b * h * h, dtype=torch.float32).reshape(b, h, h, 1)
    if shift:
        ids = torch.roll(ids, (-shift, -shift), dims=(1, 2))
    want = window_partition(ids, WIN).reshape(-1, WIN * WIN)
    np.testing.assert_array_equal(rows, want.long().numpy())
