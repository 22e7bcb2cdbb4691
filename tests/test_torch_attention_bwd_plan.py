"""The host side of the backward kernels (e) ``rdg_layernorm_bwd`` and (f)
``window_attention_bwd`` on the CPU: their launch plans at the flagship's
five blocks and at the test configs, the 16-byte-row buffers the training
backward hands (f), the layout rules both wrappers enforce before any card
route, and the plain versions on strided buffers against ``jax.vjp`` of the
JAX functions. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from adsr_tpu.models import drct as jdrct
from adsr_tpu.ops.window_attention import window_attention_xla

from adsr_tpu_torch.core.config import DRCTModelConfig, drct_experiment
from adsr_tpu_torch.kernels import rdg_layernorm_bwd as lb
from adsr_tpu_torch.kernels import window_attention as wa
from adsr_tpu_torch.kernels import window_attention_bwd as wab
from adsr_tpu_torch.kernels.fused_rdg import (attention_grad_buffers,
                                              rdg_geometry)
from adsr_tpu_torch.kernels.rdg_gemm import row_pitch
from adsr_tpu_torch.models.drct import relative_position_bias

from torch_port_util import ATOL, CONFIGS, RTOL

# the flagship's five blocks: (c, heads, shift)
FLAGSHIP = [(180, 6, 0), (212, 4, 4), (244, 2, 0), (276, 6, 4), (308, 4, 0)]
SMS = 132


def _blocks(name):
    g = rdg_geometry(DRCTModelConfig(**CONFIGS[name]))
    return list(zip(g["feats"], g["heads"], g["shifts"]))


# the tiny and head-fix-up test configs' blocks (widths 12..28)
SMALL = _blocks("tiny") + _blocks("fixup")


def _cover(plan):
    """Each group's windows [g * G, min((g + 1) * G, windows)), as the
    kernel walks them."""
    g, n = plan["group"], plan["windows"]
    return [list(range(i * g, min((i + 1) * g, n)))
            for i in range(plan["groups"])]


@pytest.mark.parametrize("c,nh,shift", FLAGSHIP + SMALL)
def test_window_attention_bwd_plan(c, nh, shift):
    hd = c // nh
    p = wab.window_attention_bwd_plan(c, nh, 16, 32, 32)
    assert p["hdp"] % 16 == 0 and hd <= p["hdp"] < hd + 16
    assert p["ld"] == p["hdp"] + 8 and p["ld"] * 2 % 32 == 16
    # q, k, v, dO planes and the bf16 P and dS tiles [2][64][72], no f32
    # score tile
    assert p["smem_bytes"] == 4 * 64 * p["ld"] * 2 + 2 * 64 * 72 * 2
    assert p["smem_bytes"] <= wa.BLOCK_SHARED_MAX
    assert p["threads"] == 128 and p["windows"] == 16 * 16
    assert 1 <= p["group"] <= wab.MAX_GROUP
    windows = [wi for grp in _cover(p) for wi in grp]
    assert windows == list(range(p["windows"]))      # each once, in order
    assert p["blocks"] == nh * p["groups"] >= SMS
    # one wave: every block resident at once, which one window fewer a
    # block would not be
    per_sm = min(wa.SM_SHARED_BYTES // (p["smem_bytes"] + wa.BLOCK_RESERVED),
                 wab.min_blocks(p["hdp"]))
    assert p["blocks_per_sm"] == per_sm
    assert p["blocks"] <= per_sm * SMS
    if p["group"] > 1:
        assert nh * -(-p["windows"] // (p["group"] - 1)) > per_sm * SMS
    assert p["partial_bytes"] == p["groups"] * nh * 64 * 64 * 4
    assert p["threads"] * p["blocks_per_sm"] * p["max_registers"] \
        <= wa.REGISTERS
    assert wab.window_attention_bwd_plan(c, nh, 16, 32, 32) is p   # cached


def test_flagship_bwd_plans_group_windows():
    cfg = drct_experiment("grid", 128, 4).model
    g = rdg_geometry(cfg)
    assert list(zip(g["feats"], g["heads"], g["shifts"])) == FLAGSHIP
    plans = [wab.window_attention_bwd_plan(c, nh, 16, 32, 32)
             for c, nh, _ in FLAGSHIP]
    # block 3 has two heads, so G <= 2 there to keep every SM busy; the
    # others cut the d(bias) partials by 3-4; blocks 2 and 5 end on a
    # group of one window (256 = 85 * 3 + 1)
    assert [p["group"] for p in plans] == [4, 3, 2, 4, 3]
    assert [p["last_group"] for p in plans] == [4, 1, 2, 4, 1]
    assert [p["blocks"] for p in plans] == [384, 344, 256, 384, 344]
    assert all(p["blocks"] >= SMS for p in plans)
    # shared memory from about 39 KB (hd 30) to about 88 KB (hd 122)
    assert [p["smem_bytes"] for p in plans] == [38912, 55296, 88064, 47104,
                                                63488]


@pytest.mark.parametrize("side,b", [(40, 5), (48, 9)])
def test_window_attention_bwd_plan_short_last_group(side, b):
    short = 0
    for c, nh, _ in FLAGSHIP:
        p = wab.window_attention_bwd_plan(c, nh, b, side, side)
        groups = _cover(p)
        assert [wi for grp in groups for wi in grp] == list(range(
            p["windows"]))
        assert len(groups[-1]) == p["last_group"] >= 1
        assert all(len(grp) == p["group"] for grp in groups[:-1])
        short += p["last_group"] < p["group"]
    assert short >= 1              # some block's last group is short


@pytest.mark.parametrize("c", [12, 16, 20, 28, 180, 212, 244, 276, 308])
@pytest.mark.parametrize("m", [16 * 1024, 2 * 64, 37])
def test_rdg_layernorm_bwd_plan(c, m):
    p = lb.rdg_layernorm_bwd_plan(m, c)
    steps = -(-m // lb.ROWS_PER_STEP)
    assert p["threads"] == 256 and lb.ROWS_PER_STEP == 2 * 256 // 32
    assert 1 <= p["blocks"] <= min(steps, lb.BLOCKS_PER_SM * SMS)
    assert p["blocks"] * p["steps_per_block"] >= steps
    assert p["partial_bytes"] == p["blocks"] * 2 * c * 4
    if m == 16 * 1024:             # the flagship fills the card
        assert p["blocks"] >= SMS


@pytest.mark.parametrize("k", range(5))
def test_attention_grad_buffers_have_16_byte_rows(k):
    cfg = drct_experiment("grid", 128, 4).model
    c = rdg_geometry(cfg)["feats"][k]
    m = 2 * 64
    bufs = attention_grad_buffers(m, c, torch.bfloat16, "cpu")
    assert bufs["dctx"].shape == (m, c) and bufs["dqkv"].shape == (m, 3 * c)
    wa.check_rows16("attention_grad_buffers", *bufs.values())
    assert bufs["dctx"].stride(0) == row_pitch(c)
    assert bufs["dqkv"].stride(0) == row_pitch(3 * c)
    # every row a multiple of 16 bytes where the flagship's plain widths
    # (360-616 and 1080-1848 bytes) are not
    assert c * 2 % 16 and 3 * c * 2 % 16


def _pitched_view(arr: np.ndarray) -> torch.Tensor:
    """``arr`` [m, n] as a view with 16-byte rows over a NaN-filled flat
    buffer: the pads between rows hold NaN, so a read of them shows."""
    m, n = arr.shape
    flat = torch.full((m * row_pitch(n),), float("nan"))
    t = flat.as_strided((m, n), (row_pitch(n), 1))
    t.copy_(torch.from_numpy(arr))
    return t


def _jax_attention(qkv, bias, mask, b, h, w, nh, win, shift):
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


@pytest.mark.parametrize("c,nh", [(20, 2), (36, 3)])
@pytest.mark.parametrize("shift", [0, 4])
def test_plain_attention_bwd_on_pitched_dout_dqkv_matches_jax(c, nh, shift):
    # dout and dqkv as the training backward allocates them: 16-byte rows
    # (c = 20 and 36 give 40- and 72-byte rows, padded to 48 and 80)
    h, win, b = 16, 8, 2
    rng = np.random.RandomState(31)
    qkv = rng.randn(b * h * h, 3 * c).astype(np.float32)
    g = rng.randn(b * h * h, c).astype(np.float32)
    table = rng.randn((2 * win - 1) ** 2, nh).astype(np.float32)
    bias = relative_position_bias(torch.from_numpy(table), win).contiguous()
    mask = jdrct.shift_attn_mask(h, h, win, shift) if shift else None
    _, vjp = jax.vjp(lambda q, bb: _jax_attention(q, bb, mask, b, h, h, nh,
                                                  win, shift),
                     jnp.asarray(qkv), jnp.asarray(bias.numpy()))
    want_q, want_b = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    dqkv = _pitched_view(np.zeros((b * h * h, 3 * c), np.float32))
    dbias = torch.empty(nh, 64, 64)
    n0 = wab.window_attention_bwd.launches
    wab.window_attention_bwd(_pitched_view(qkv), _pitched_view(g), bias,
                             None if mask is None else torch.from_numpy(mask),
                             h, h, nh, win, shift, dqkv, dbias)
    assert wab.window_attention_bwd.launches == n0        # the CPU: plain
    np.testing.assert_allclose(dqkv.numpy(), want_q, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dbias.numpy(), want_b, atol=ATOL, rtol=RTOL)
    pads = dqkv.as_strided((b * h * h, row_pitch(3 * c) - 3 * c),
                           (row_pitch(3 * c), 1), 3 * c)
    assert torch.isnan(pads).all()                        # pads untouched


@pytest.mark.parametrize("c", [180, 212, 244, 276, 308])
def test_plain_layernorm_bwd_into_strided_slice_matches_jax(c):
    # the LayerNorm of the JAX model (flax, eps 1e-6) at each flagship
    # width, its input a prefix of a wider concat and its input gradient
    # accumulated into a prefix of the f32 concat gradient, with the
    # residual-stream gradient added in the same pass
    m, width = 24, 308 + 8
    rng = np.random.RandomState(c)
    wide = (1.0 + 2.0 * rng.randn(m, width)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    shift = (0.1 * rng.randn(c)).astype(np.float32)
    dy = rng.randn(m, c).astype(np.float32)
    res = rng.randn(m, c).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-6)

    def f(x, s, b_):
        return ln.apply({"params": {"scale": s, "bias": b_}}, x)

    _, vjp = jax.vjp(f, jnp.asarray(wide[:, :c]), jnp.asarray(scale),
                     jnp.asarray(shift))
    want_x, want_s, want_b = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    acc = torch.from_numpy(rng.randn(m, width).astype(np.float32))
    before = acc.clone()
    dw, db = torch.empty(c), torch.empty(c)
    lb.rdg_layernorm_bwd(torch.from_numpy(wide)[:, :c], torch.from_numpy(dy),
                         torch.from_numpy(scale), acc[:, :c], dw, db,
                         residual=torch.from_numpy(res))
    assert lb.rdg_layernorm_bwd.launches == 0             # the CPU: plain
    np.testing.assert_allclose(acc[:, :c].numpy(),
                               before[:, :c].numpy() + want_x + res,
                               atol=ATOL, rtol=RTOL)
    assert torch.equal(acc[:, c:], before[:, c:])
    np.testing.assert_allclose(dw.numpy(), want_s, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(db.numpy(), want_b, atol=ATOL, rtol=RTOL)


META = dict(device="meta", dtype=torch.bfloat16)


def _attn_args(qkv_cols=540, dout_cols=180, dqkv_cols=540, c=180):
    """Meta tensors of block 1's shapes ([2 * 1024] rows), each a column
    prefix of a buffer ``*_cols`` wide (so its row stride)."""
    m = 2 * 1024
    return (torch.empty(m, qkv_cols, **META)[:, :3 * c],
            torch.empty(m, dout_cols, **META)[:, :c],
            torch.empty(6, 64, 64, device="meta"), None, 32, 32, 6, 8, 0,
            torch.empty(m, dqkv_cols, **META)[:, :3 * c],
            torch.empty(6, 64, 64, device="meta"))


@pytest.mark.parametrize("kw", [dict(qkv_cols=540), dict(dout_cols=180),
                                dict(dqkv_cols=540), dict(dout_cols=186)])
def test_attention_bwd_refuses_rows_that_are_not_16_bytes(kw):
    # contiguous dout (360-byte rows) or dqkv (1080) as the training
    # backward allocated them before; a meta tensor takes the card's route,
    # where the layout is checked on metadata before any launch
    base = dict(qkv_cols=544, dout_cols=184, dqkv_cols=544)
    with pytest.raises(ValueError, match="16-byte rows"):
        wab.window_attention_bwd(*_attn_args(**{**base, **kw}))
    assert wab.window_attention_bwd.launches == 0


def test_attention_bwd_takes_16_byte_rows_to_the_device_check():
    # the same call with 16-byte rows passes the layout rule and stops at
    # the device check (meta is not CUDA)
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        wab.window_attention_bwd(*_attn_args(544, 184, 544))
    assert wab.window_attention_bwd.launches == 0


def _ln_args(c=180, x_off=0, x_cols=308, dy_cols=None, dx_cols=308,
             res_cols=None):
    m = 64
    x = torch.empty(m, x_cols + x_off, **META)[:, x_off:x_off + c]
    f32 = dict(device="meta")
    dy = torch.empty(m, dy_cols or c, **f32)[:, :c]
    dx = torch.empty(m, dx_cols, **f32)[:, :c]
    res = torch.empty(m, res_cols, **f32)[:, :c] if res_cols else None
    return (x, dy, torch.empty(c, **f32), dx, torch.empty(c, **f32),
            torch.empty(c, **f32)), res


@pytest.mark.parametrize("kw,match", [
    (dict(x_off=2), "aligned"),              # x 4-byte aligned, not 8
    (dict(dy_cols=182), "row stride"),       # f32 rows of 728 bytes
    (dict(dx_cols=310), "row stride"),
    (dict(res_cols=181), "row stride"),
    (dict(c=182, x_cols=308, dx_cols=308), "multiples of 4"),
    (dict(c=324, x_cols=324, dx_cols=324), "multiples of 4"),
])
def test_layernorm_bwd_refuses_layouts_the_kernel_does_not_take(kw, match):
    args, res = _ln_args(**kw)
    with pytest.raises(ValueError, match=match):
        lb.rdg_layernorm_bwd(*args, residual=res)
    assert lb.rdg_layernorm_bwd.launches == 0


def test_layernorm_bwd_takes_the_training_layouts_to_the_device_check():
    # x a prefix of the bf16 concat (616-byte rows), dx a prefix of the f32
    # concat gradient (1232-byte rows), dy and the residual contiguous
    args, res = _ln_args(c=180, res_cols=180)
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        lb.rdg_layernorm_bwd(*args, residual=res)
    assert lb.rdg_layernorm_bwd.launches == 0
