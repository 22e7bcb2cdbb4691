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
    assert 7 <= p["stages"] <= fsb.MAX_STAGES
    assert p["smem_bytes"] <= wa.BLOCK_SHARED_MAX
    assert p["stages"] == fsb.MAX_STAGES or \
        p["smem_bytes"] + fsb.STAGE_BYTES + 16 > wa.BLOCK_SHARED_MAX
    # q, k and v transposed (hdp rows of 64 tokens, 128 bytes), the context
    # over q (its dims from row (h hd) % 8: ctx_ksteps rows of 16), a peer's
    # K or V tile in the slot, which also holds the merge's scratch (half
    # the head dims of 64 rows in f32) and with q the 128-wide hidden chunk;
    # the head's table, the window's labels, both warpgroups' (max, sum)
    hd, hdp, kk = c // nh, p["hdp"], p["ctx_ksteps"]
    assert kk == -(-max((h * hd) % 8 + hd for h in range(nh)) // 16)
    assert hdp // 16 <= kk <= hdp // 16 + 1      # the source's two paths
    r, tile = p["regions"], hdp * 128
    assert (r["k"], r["v"]) == (tile, tile)
    assert r["q"] == max(hdp, 16 * kk) * 128
    assert r["slot"] >= tile >= 64 * (hdp // 2) * 4
    assert r["q"] + r["slot"] >= 2 * 8192
    assert (r["tab"], r["lab"], r["ml"]) == (wa.REL_TABLE_BYTES,
                                             wa.LABEL_BYTES, 2 * 64 * 8)
    kp = -(-c // 64) * 64
    assert (r["ln"], r["x"]) == (kp * 128, 64 * p["ldx"] * 4)
    assert 1024 + sum(r.values()) == p["smem_bytes"]
    # one block's ring stages: q/k/v of a head as one product of 3 hdp
    # columns, proj over the context's k-steps, the MLP in chunks of 128
    ks = nc = kp // 64
    mlp = sum(-(-min(128, f - f0) // 64) * (ks + nc)
              for f0 in range(0, f, 128))
    assert p["weight_tiles"] == nh * (-(-3 * hdp // 64) * ks
                                      + nc * -(-kk // 4)) + mlp
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
    # the 8x8 plan is the window argument's default: one block a window,
    # its own layout
    p8 = fsb.swin_block_plan(c, f, nh, b, 64, 64)
    assert p8 == fsb.swin_block_plan(c, f, nh, b, 64, 64, window=8)
    assert p8["cluster"] == 1 and set(p8["regions"]) == {
        "ring", "ln", "ctx", "x", "qkv", "bars"}


def _kernel_terms(table, labels):
    """The bias [nh, 256, 256] and mask [nW, 256, 256] the 16x16 kernel (g)
    adds to its scores, as numpy: the bias of query i and key j looked up in
    the head's table at rel_pos(i) - rel_pos(j) + 480, rel_pos(i) = 31 (i //
    16) + i % 16, and -100 between tokens of different region labels
    (``csrc/swin_block16.cu`` with attn16.cuh's ``rel_pos`` and
    ``mask_term``)."""
    i = np.arange(256)
    rel = 31 * (i // 16) + i % 16
    bias = table[:, rel[:, None] - rel[None, :] + 480]
    mask = None if labels is None else np.where(
        labels[:, :, None] != labels[:, None, :], -100.0, 0.0)
    return bias, mask


# the 256px model's (heads, shift) of blocks 1-5 (the widths do not enter)
@pytest.mark.parametrize("nh,shift", [(6, 0), (4, 8), (2, 0), (6, 8), (4, 0)])
def test_window16_table_and_labels_are_the_plain_bias_and_mask(nh, shift):
    c = 24
    _, params, _ = jax_swin_block_case(c, nh, WIN, shift, SIDE, seed=nh)
    p = fsb.pack_swin_weights(params, c, WIN)
    masks = {shift: torch.from_numpy(shift_attn_mask(64, 64, WIN, shift))} \
        if shift else {}
    table, labels = wa.attn_operands(p, masks, 64, 64, shift, WIN)
    assert table.shape == (nh, 961) and table.is_contiguous()
    assert (labels is None) == (shift == 0)
    bias, mask = _kernel_terms(table.numpy(),
                               None if labels is None else labels.numpy())
    np.testing.assert_array_equal(bias, p["attn_bias"].numpy())
    if shift:
        assert labels.dtype == torch.int32 and labels.shape == (16, 256)
        np.testing.assert_array_equal(mask, masks[shift].numpy())


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
