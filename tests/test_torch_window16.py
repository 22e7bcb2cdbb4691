"""The window-16 geometry (16x16 windows, N = 256 keys a window) on the CPU:
the plain versions of kernels (c) ``window_attention`` and (f)
``window_attention_bwd`` against the JAX attention and its ``jax.vjp``, the
eager DRCT and the fused forward (plain versions, both serving modes)
against the JAX DRCT, one RDG's training forward and backward against JAX
autodiff, and the x8 tail (three pixel shuffles) against the JAX model. The
JAX side runs its plain (XLA) path. The kernels themselves run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.models import drct as jdrct
from adsr_tpu.models.drct import DRCT as JaxDRCT

from adsr_tpu_torch.io.convert import drct_state_dict_from_jax
from adsr_tpu_torch.kernels import fused_rdg_train as frt
from adsr_tpu_torch.kernels import window_attention as wa
from adsr_tpu_torch.kernels import window_attention_bwd as wab
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.kernels.fused_rdg import rdg_geometry
from adsr_tpu_torch.models.drct import relative_position_bias
from adsr_tpu_torch.models.factory import make_model

from torch_port_util import (ATOL, RTOL, jax_apply, jax_params,
                             jax_window_attention, lr_input, port_state_dict)

WIN, SIDE, BATCH = 16, 32, 2          # 4 windows an image, 8 a call
N = WIN * WIN


def _case(c, nh, shift, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(BATCH * SIDE * SIDE, 3 * c).astype(np.float32)
    table = rng.randn((2 * WIN - 1) ** 2, nh).astype(np.float32)
    bias = relative_position_bias(torch.from_numpy(table), WIN).contiguous()
    mask = jdrct.shift_attn_mask(SIDE, SIDE, WIN, shift) if shift else None
    return qkv, bias, mask


def _mask_t(mask):
    return None if mask is None else torch.from_numpy(mask)


@pytest.mark.parametrize("c,nh", [(20, 2), (36, 3)])
@pytest.mark.parametrize("shift", [0, 8])
def test_plain_attention_matches_jax_at_window16(c, nh, shift):
    qkv, bias, mask = _case(c, nh, shift, seed=41)
    assert bias.shape == (nh, N, N)
    want = np.asarray(jax_window_attention(
        jnp.asarray(qkv), jnp.asarray(bias.numpy()), mask, BATCH, SIDE, SIDE,
        nh, WIN, shift))
    out = torch.empty(BATCH * SIDE * SIDE, c)
    n0 = wa.window_attention.launches
    wa.window_attention(torch.from_numpy(qkv), out, bias, _mask_t(mask), SIDE,
                        SIDE, nh, WIN, shift)
    assert wa.window_attention.launches == n0            # the CPU: plain
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("c,nh", [(20, 2), (36, 3)])
@pytest.mark.parametrize("shift", [0, 8])
def test_plain_attention_bwd_matches_jax_vjp_at_window16(c, nh, shift):
    qkv, bias, mask = _case(c, nh, shift, seed=42)
    g = np.random.RandomState(43).randn(BATCH * SIDE * SIDE, c) \
        .astype(np.float32)
    _, vjp = jax.vjp(lambda q, bb: jax_window_attention(
        q, bb, mask, BATCH, SIDE, SIDE, nh, WIN, shift),
        jnp.asarray(qkv), jnp.asarray(bias.numpy()))
    want_q, want_b = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    got_q = torch.empty(BATCH * SIDE * SIDE, 3 * c)
    got_b = torch.empty(nh, N, N)
    n0 = wab.window_attention_bwd.launches
    wab.window_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(g), bias,
                             _mask_t(mask), SIDE, SIDE, nh, WIN, shift, got_q,
                             got_b)
    assert wab.window_attention_bwd.launches == n0       # the CPU: plain
    np.testing.assert_allclose(got_q.numpy(), want_q, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["window16", "window16x8"])
@pytest.mark.parametrize("mode", ["rdg", "block"])
def test_eager_and_fused_forward_match_jax_at_window16(name, mode):
    jcfg, pcfg, params = jax_params(name)
    assert pcfg.window_size == WIN
    assert rdg_geometry(pcfg)["shifts"] == (0, 8, 0, 8, 0)
    x = lr_input(jcfg)
    want = np.asarray(jax_apply(name)({"params": params}, x))
    side = jcfg.img_size * jcfg.upscale
    assert want.shape == (2, side, side, jcfg.in_chans)
    packed = prepack_drct(port_state_dict(name), pcfg, pcfg.img_size,
                          pcfg.img_size, dtype=torch.float32, device="cpu",
                          mode=mode)
    assert all(m.shape == (4, N, N) for m in packed["masks"].values())
    model = make_model(pcfg, device="cpu")
    model.load_state_dict(port_state_dict(name))
    with torch.no_grad():
        got = fused_drct_apply(packed, pcfg, torch.from_numpy(x)).numpy()
        eager = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(eager, want, atol=ATOL, rtol=RTOL)


def test_rdg_training_grads_match_jax_autodiff_at_window16():
    # the training forward (one RDG Function, the kernels' plain versions on
    # the CPU, drop path off) and its backward against jax.value_and_grad of
    # the JAX model, with the JAX suite's scale-relative gradient tolerance
    jcfg, pcfg, params = jax_params("window16")
    x = lr_input(jcfg)
    hr = (np.random.RandomState(7).rand(2, 64, 64, 1) * 255).astype(np.float32)
    model = JaxDRCT(jcfg)

    def loss(p):
        return jnp.mean(jnp.abs(model.apply({"params": p}, x) - hr))

    jl, jg = jax.value_and_grad(loss)(params)
    want = drct_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg),
                                    pcfg)
    pm = make_model(pcfg, device="cpu")
    pm.load_state_dict(port_state_dict("window16"))
    named = dict(pm.named_parameters())
    dp = torch.ones(pcfg.num_layers, 2, 10)
    sr = frt.fused_drct_train_forward(named, pcfg, torch.from_numpy(x), dp,
                                      dtype=torch.float32)
    pl = (sr - torch.from_numpy(hr)).abs().mean()
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    assert set(named) == set(want)
    for k in sorted(want):
        a, b = want[k].numpy(), named[k].grad.numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=2e-3 * scale, rtol=2e-2,
                                   err_msg=k)
    # the relative-position bias tables carry gradients of all 961 offsets
    table = named["layers.0.swin2.attn.relative_position_bias_table"]
    assert table.shape == ((2 * WIN - 1) ** 2, 2)
    assert bool((table.grad != 0).all())


# --------------------------------------------------------------------------
# Launch plans of (c) and (f) at the 256px model's five blocks (batch 16,
# 64 x 64 tokens: 16 windows an image, 256 a call) and the card's refusals
# --------------------------------------------------------------------------

# drct_experiment("grid", 256, 4): (c, heads, shift) of the five blocks
BLOCKS_256 = [(180, 6, 0), (212, 4, 8), (244, 2, 0), (276, 6, 8), (308, 4, 0)]
SMS = 132


def test_256px_blocks_match_the_shipped_config():
    from adsr_tpu_torch.core.config import drct_experiment
    cfg = drct_experiment("grid", 256, 4).model
    g = rdg_geometry(cfg)
    assert (cfg.img_size, cfg.window_size) == (64, WIN)
    assert list(zip(g["feats"], g["heads"], g["shifts"])) == BLOCKS_256


@pytest.mark.parametrize("c,nh,shift", BLOCKS_256)
@pytest.mark.parametrize("b", [16, 5])
def test_window_attention_plan_at_window16(c, nh, shift, b):
    p = wa.window_attention_plan(c, nh, b, 64, 64, window=WIN)
    hd = c // nh
    assert p["hdp"] % 16 == 0 and hd <= p["hdp"] < hd + 16
    # swizzled tiles hold whole 64-column atoms
    assert p["tile_cols"] % 64 == 0 and p["hdp"] <= p["tile_cols"] \
        < p["hdp"] + 64
    assert wa.swizzle_bytes(p["hdp"]) == 64 * p["tile_cols"] * 2
    # the window's K and V (4 tiles each), a Q tile a warpgroup, the
    # staging of one K and one V tile's pieces (later each warpgroup's
    # second Q tile), the head's 961-entry bias table, the window's 256
    # region labels and the 1024-byte alignment
    assert (wa.REL_TABLE_BYTES, wa.LABEL_BYTES) == (3856, 1024)
    assert p["smem_bytes"] == 1024 + 10 * wa.swizzle_bytes(p["hdp"]) \
        + 2 * 64 * (p["hdp"] // 8 + 1) * 16 + 3856 + 1024 \
        <= wa.BLOCK_SHARED_MAX
    assert (p["threads"], p["warpgroups"]) == (256, 2)
    # two blocks an SM up to a head tile of 64 (by shared memory too), one
    # above (blocks 3 and 5)
    assert p["blocks_per_sm"] == (2 if p["hdp"] <= 64 else 1)
    assert p["blocks_per_sm"] * (p["smem_bytes"] + wa.BLOCK_RESERVED) \
        <= wa.SM_SHARED_BYTES
    assert (p["tokens"], p["key_tiles"]) == (N, 4)
    # the grid: one block per (image, window, head), each once, decoded as
    # the source does (head fastest, then window)
    nw = 16
    seen = set()
    for bid in range(p["blocks"]):
        h, win, img = bid % nh, (bid // nh) % nw, bid // (nh * nw)
        seen.add((img, win, h))
    assert len(seen) == p["blocks"] == b * nw * nh
    assert {s[0] for s in seen} == set(range(b))
    assert p["stats_bytes"] == b * nw * nh * N * 8
    # the N = 64 plan is unchanged by the window argument's default
    assert wa.window_attention_plan(c, nh, 16, 32, 32) \
        == wa.window_attention_plan(c, nh, 16, 32, 32, window=8)


@pytest.mark.parametrize("c,nh,shift", BLOCKS_256)
@pytest.mark.parametrize("b", [16, 5])
def test_window_attention_bwd_plan_at_window16(c, nh, shift, b):
    p = wab.window_attention_bwd_plan(c, nh, b, 64, 64, SMS, WIN)
    windows = b * 16
    assert p["windows"] == windows and p["launches"] == 2
    tile = wa.swizzle_bytes(p["hdp"])
    # dq: alignment, Q, dO, K, V tiles, the next K and V tiles' staging, D,
    # the bias table
    assert p["smem_dq_bytes"] == 1024 + 4 * tile \
        + 2 * wa.stage_bytes(p["hdp"]) + 64 * 4 + wa.REL_TABLE_BYTES \
        + wa.LABEL_BYTES
    # dkv: alignment, K and V, each warpgroup's Q, dO and row statistics,
    # the f32 d(bias) tile; where it fits each warpgroup's staging of its
    # next Q, dO and statistics, and then the next window's K and V staging
    unstaged = 1024 + 6 * tile + 2 * 64 * 16 + N * 64 * 4 \
        + wa.REL_TABLE_BYTES + wa.LABEL_BYTES
    staged = unstaged + 2 * (2 * wa.stage_bytes(p["hdp"]) + 64 * 16)
    kv = staged + 2 * wa.stage_bytes(p["hdp"])
    assert p["dkv_staged"] == (staged <= wa.BLOCK_SHARED_MAX)
    assert p["dkv_kv_staged"] == (p["dkv_staged"]
                                  and kv <= wa.BLOCK_SHARED_MAX)
    assert p["smem_bytes"] == (kv if p["dkv_kv_staged"] else staged
                               if p["dkv_staged"] else unstaged)
    assert p["smem_bytes"] <= wa.BLOCK_SHARED_MAX
    assert (p["threads"], p["dq_threads"]) == (256, 128)
    assert p["blocks_per_sm"] >= 1 and p["dq_blocks_per_sm"] >= 1
    # d(bias) partials: one [nh][256][256] f32 per group, at most 32 MiB
    assert p["partial_bytes"] == p["groups"] * nh * N * N * 4
    assert p["partial_bytes"] <= 32 << 20
    # the fewest windows a group within that bound
    if p["group"] > 1:
        assert -(-windows // (p["group"] - 1)) * nh * N * N * 4 > 32 << 20
    assert p["stats_bytes"] == windows * nh * N * 16
    # dkv grid: (group, head, key tile), each group's windows in order, the
    # last group possibly short; every (window, head, key tile) once
    g = p["group"]
    dkv = []
    for bid in range(p["blocks"]):
        kt, h, grp = bid % 4, (bid // 4) % nh, bid // (4 * nh)
        dkv += [(wi, h, kt) for wi in range(grp * g, min(windows,
                                                          (grp + 1) * g))]
    assert sorted(dkv) == [(wi, h, kt) for wi in range(windows)
                           for h in range(nh) for kt in range(4)]
    assert p["last_group"] == windows - (p["groups"] - 1) * g >= 1
    # dq grid: (window, head, query tile), each once
    dq = {(bid // (4 * nh), (bid // 4) % nh, bid % 4)
          for bid in range(p["dq_blocks"])}
    assert len(dq) == p["dq_blocks"] == windows * nh * 4


def test_window16_bwd_plans_at_batch_16():
    plans = [wab.window_attention_bwd_plan(c, nh, 16, 64, 64, SMS, WIN)
             for c, nh, _ in BLOCKS_256]
    # 256 windows: at most 21 groups of 6 heads fit 32 MiB, so 13 windows a
    # group (20 groups, the last of 9); 32 groups of 4 heads (8 windows),
    # 64 of 2 heads (4)
    assert [p["group"] for p in plans] == [13, 8, 4, 13, 8]
    assert [p["last_group"] for p in plans] == [9, 8, 4, 9, 8]
    # one dkv block (two warpgroups) an SM; dq three up to a head tile of
    # 64, else two
    assert [p["blocks_per_sm"] for p in plans] == [1, 1, 1, 1, 1]
    assert [p["dq_blocks_per_sm"] for p in plans] == [3, 3, 2, 3, 2]
    # dkv stages each warpgroup's next Q and dO tiles but at head tile 128
    # (block 3), and the next window's K and V up to a head tile of 64
    assert [p["dkv_staged"] for p in plans] == [True, True, False, True,
                                                True]
    assert [p["dkv_kv_staged"] for p in plans] == [True, True, False, True,
                                                   False]
    assert max(p["partial_bytes"] for p in plans) <= 32 << 20


META = dict(device="meta", dtype=torch.bfloat16)


def _attn_meta(win, c=24, nh=2, side=32, b=2):
    m = b * side * side
    n = win * win
    qkv = torch.empty(m, 3 * c, **META)
    out = torch.empty(m, c, **META)
    bias = torch.empty(nh, n, n, device="meta")
    return qkv, out, bias, side, m, n


@pytest.mark.parametrize("win", [4, 32])
def test_card_route_refuses_windows_other_than_8_and_16(win):
    qkv, out, bias, side, m, n = _attn_meta(win)
    with pytest.raises(NotImplementedError, match="8x8 windows or 16x16"):
        wa.window_attention(qkv, out, bias, None, side, side, 2, win, 0)
    with pytest.raises(NotImplementedError, match="8x8 windows or 16x16"):
        wab.window_attention_bwd(qkv, out, bias, None, side, side, 2, win, 0,
                                 torch.empty(m, qkv.shape[1], **META),
                                 torch.empty(2, n, n, device="meta"))
    assert wa.window_attention.launches == 0
    assert wab.window_attention_bwd.launches == 0


def test_card_route_takes_window16_to_the_device_check():
    # window 16 passes the kernels' geometry rule and stops at the device
    # check (a meta tensor is not CUDA), before any launch
    qkv, out, bias, side, m, n = _attn_meta(WIN)
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        wa.window_attention(qkv, out, bias, None, side, side, 2, WIN, 0)
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        wab.window_attention_bwd(qkv, out, bias, None, side, side, 2, WIN, 0,
                                 torch.empty(m, qkv.shape[1], **META),
                                 torch.empty(2, n, n, device="meta"))
    assert wa.window_attention.launches == 0
    assert wab.window_attention_bwd.launches == 0


def _block_meta(win, c=12, side=32):
    """Kernel (g)'s arguments at ``win`` as meta tensors (no card): a
    window-16 test config at that window, the concat prefix and output, and
    the block dict's matrices."""
    from adsr_tpu_torch.core.config import DRCTModelConfig
    from adsr_tpu_torch.kernels import fused_swin_block as fsb
    from torch_port_util import CONFIGS
    cfg = DRCTModelConfig(**{**CONFIGS["window16"], "window_size": win})
    m = 2 * side * side
    p = {n: torch.empty(c, c, **META) for n in fsb._MATRICES}
    return fsb, cfg, torch.empty(m, c, **META), p, torch.empty(m, c, **META)


def test_block_mode_takes_window16_to_the_device_check():
    # window 16 passes kernel (g)'s geometry rule and stops at the device
    # check (a meta tensor is not CUDA), before any launch
    fsb, cfg, x, p, out = _block_meta(WIN)
    n0 = fsb.fused_swin_block.launches
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        fsb.fused_swin_block(x, p, {}, cfg, 32, 32, 0, out)
    assert fsb.fused_swin_block.launches == n0


@pytest.mark.parametrize("win", [4, 32])
def test_block_mode_refuses_windows_other_than_8_and_16(win):
    fsb, cfg, x, p, out = _block_meta(win)
    n0 = fsb.fused_swin_block.launches
    with pytest.raises(NotImplementedError, match="8x8 or 16x16 windows"):
        fsb.fused_swin_block(x, p, {}, cfg, 32, 32, 0, out)
    assert fsb.fused_swin_block.launches == n0
