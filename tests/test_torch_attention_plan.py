"""The host side of the attention kernels (c) ``window_attention`` and (g)
``swin_block`` on the CPU: their launch plans at the flagship's five blocks
and at the test configs, the 16-byte row rule both follow, the buffers the
main paths hand them, and the plain versions on 16-byte-row (pitched)
buffers against the JAX functions. The kernels themselves run only on the
card (``tests/test_torch_cuda.py``)."""

import os

os.environ["ADSR_TPU_PALLAS_INTERPRET"] = "1"

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.models import drct as jdrct
from adsr_tpu.ops.fused_drct import fused_drct_apply as jax_apply
from adsr_tpu.ops.fused_drct import prepack_drct as jax_prepack
from adsr_tpu.ops.window_attention import window_attention_xla

from adsr_tpu_torch.core.config import DRCTModelConfig, drct_experiment
from adsr_tpu_torch.kernels import fused_swin_block as fsb
from adsr_tpu_torch.kernels import window_attention as wa
from adsr_tpu_torch.kernels import window_attention_bwd as wab
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.kernels.fused_rdg import (block_buffers, rdg_geometry,
                                              rdg_workspace)
from adsr_tpu_torch.kernels.rdg_gemm import row_pitch
from adsr_tpu_torch.models.drct import relative_position_bias

from torch_port_util import (ATOL, CONFIGS, RTOL, jax_params, lr_input,
                             port_state_dict)

# the flagship's five blocks: (c, f, heads, shift)
FLAGSHIP = [(180, 360, 6, 0), (212, 424, 4, 4), (244, 488, 2, 0),
            (276, 276, 6, 4), (308, 308, 4, 0)]


def _blocks(name):
    g = rdg_geometry(DRCTModelConfig(**CONFIGS[name]))
    return list(zip(g["feats"], g["hidden"], g["heads"], g["shifts"]))


# the tiny and head-fix-up test configs' blocks (widths 12..28, heads
# 2/2/2/2/2 and 3/2/1/3/2)
SMALL = _blocks("tiny") + _blocks("fixup")
ALL_BLOCKS = FLAGSHIP + SMALL


@pytest.mark.parametrize("c,f,nh,shift", ALL_BLOCKS)
def test_window_attention_plan(c, f, nh, shift):
    hd = c // nh
    p = wa.window_attention_plan(c, nh, 16, 32, 32)
    assert p["hdp"] % 16 == 0 and hd <= p["hdp"] < hd + 16
    assert p["ld"] * 2 % 32 == 16            # conflict-free ldmatrix rows
    # one head's q/k/v planes, several blocks an SM
    assert p["smem_bytes"] == 3 * 64 * p["ld"] * 2 <= wa.BLOCK_SHARED_MAX
    assert p["blocks_per_sm"] >= 4
    assert p["blocks"] == 16 * 16 * nh and p["threads"] == 128
    assert p["threads"] * p["blocks_per_sm"] * p["max_registers"] \
        <= wa.REGISTERS
    assert wa.window_attention_plan(c, nh, 16, 32, 32) is p     # cached


@pytest.mark.parametrize("c,f,nh,shift", ALL_BLOCKS)
def test_swin_block_plan(c, f, nh, shift):
    p = fsb.swin_block_plan(c, f, nh, 16, 32, 32)
    kp = -(-c // 64) * 64
    assert 2 <= p["stages"] <= fsb.MAX_STAGES
    assert p["smem_bytes"] <= wa.BLOCK_SHARED_MAX
    # one more stage would not fit, unless the ring is at its most
    assert p["stages"] == fsb.MAX_STAGES or \
        p["smem_bytes"] + fsb.STAGE_BYTES + 16 > wa.BLOCK_SHARED_MAX
    # alignment room, ring, the LayerNorm output and one head's context as
    # swizzled A operands, the f32 stream, one head's planes, the barriers
    hk = -(-(c // nh + 7) // 64)      # a head's context from column hd % 8
    assert p["smem_bytes"] == (1024 + p["stages"] * (fsb.STAGE_BYTES + 16)
                               + (kp + 64 * hk) * 128 + 64 * p["ldx"] * 4
                               + 3 * 64 * (p["hdp"] + 8) * 2)
    assert p["ldx"] >= c and p["ldx"] % 16 == 8
    assert p["hdp"] % 16 == 0 and p["hdp"] <= 128
    assert p["threads"] == 288 and p["blocks"] == 256
    assert p["threads"] * p["max_registers"] <= wa.REGISTERS
    # qkv per head and part, proj per head over its dims, then per 64
    # hidden columns fc1 (over c) and fc2 (one step per 64 output columns)
    ks, nc = kp // 64, -(-c // 64)
    assert p["weight_tiles"] == (3 * nh * hk * ks + nh * nc * hk
                                 + -(-f // 64) * (ks + nc))


def test_flagship_plans_match_the_shipped_config():
    cfg = drct_experiment("grid", 128, 4).model
    g = rdg_geometry(cfg)
    assert list(zip(g["feats"], g["hidden"], g["heads"], g["shifts"])) \
        == FLAGSHIP
    # every block's (g) keeps at least a 4-stage ring at the flagship
    assert min(fsb.swin_block_plan(c, f, nh)["stages"]
               for c, f, nh, _ in FLAGSHIP) >= 4


@pytest.mark.parametrize("make,ok", [
    (lambda: torch.empty(64, 540, dtype=torch.bfloat16), False),  # 1080 B
    (lambda: torch.empty(64, 544, dtype=torch.bfloat16)[:, :540], True),
    (lambda: torch.empty(64, 544, dtype=torch.bfloat16)[:, 8:548 - 8], True),
    (lambda: torch.empty(64, 544, dtype=torch.bfloat16)[:, 4:544], False),
    (lambda: torch.empty(540, 64, dtype=torch.bfloat16).t(), False),
    (lambda: torch.empty(64 * 544, dtype=torch.bfloat16)
     .as_strided((64, 540), (544, 1)), True),
])
def test_rows16_rule(make, ok):
    t = make()
    if ok:
        wa.check_rows16("test", t)
    else:
        with pytest.raises(ValueError, match="16-byte rows"):
            wa.check_rows16("test", t)


@pytest.mark.parametrize("k", range(5))
def test_block_buffers_have_16_byte_rows(k):
    # every buffer a kernel loads in 16-byte pieces: the GEMM operands, qkv
    # (read whole by kernel (c)) and the context (its 16-byte stores)
    cfg = drct_experiment("grid", 128, 4).model
    g = rdg_geometry(cfg)
    m = 2 * 64
    work = rdg_workspace(m, cfg, torch.bfloat16, "cpu")
    c, f = g["feats"][k], g["hidden"][k]
    bufs = block_buffers(work, m, c, f)
    for name in ("ln1", "ln2", "qkv", "ctx", "hid", "x2"):
        t = bufs[name]
        wa.check_rows16(name, t)
        base = work[next(n for n, w in work.items()
                         if w.untyped_storage().data_ptr()
                         == t.untyped_storage().data_ptr())]
        # the last row ends inside its flat buffer
        assert t.storage_offset() + (m - 1) * t.stride(0) + t.shape[1] \
            <= base.numel()
    assert bufs["qkv"].stride(0) == row_pitch(3 * c)
    assert bufs["ctx"].stride(0) == row_pitch(c)


def _jax_attention(qkv, bias, mask, b, h, w, nh, win, shift):
    """JAX reference on jnp arrays: roll, window partition,
    window_attention_xla, reverse."""
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


def _pitched_view(arr: np.ndarray) -> torch.Tensor:
    """``arr`` [m, n] as a view with 16-byte rows over a NaN-filled flat
    buffer: the pads between rows hold NaN, so a read of them shows."""
    m, n = arr.shape
    flat = torch.full((m * row_pitch(n),), float("nan"))
    t = flat.as_strided((m, n), (row_pitch(n), 1))
    t.copy_(torch.from_numpy(arr))
    return t


def _case(c, nh, shift, seed):
    h, win, b = 16, 8, 2
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b * h * h, 3 * c).astype(np.float32)
    table = rng.randn((2 * win - 1) ** 2, nh).astype(np.float32)
    bias = relative_position_bias(torch.from_numpy(table), win).contiguous()
    mask = jdrct.shift_attn_mask(h, h, win, shift) if shift else None
    return h, win, b, qkv, bias, mask


@pytest.mark.parametrize("c,nh", [(20, 2), (36, 3)])
@pytest.mark.parametrize("shift", [0, 4])
def test_plain_attention_on_pitched_buffers_matches_jax(c, nh, shift):
    h, win, b, qkv, bias, mask = _case(c, nh, shift, seed=21)
    want = np.asarray(_jax_attention(jnp.asarray(qkv), jnp.asarray(bias),
                                     mask, b, h, h, nh, win, shift))
    out = _pitched_view(np.zeros((b * h * h, c), np.float32))
    n0 = wa.window_attention.launches
    wa.window_attention(_pitched_view(qkv), out, bias,
                        None if mask is None else torch.from_numpy(mask),
                        h, h, nh, win, shift)
    assert wa.window_attention.launches == n0          # the CPU: plain
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=RTOL)
    pads = out.as_strided((b * h * h, row_pitch(c) - c), (row_pitch(c), 1),
                          c)
    assert torch.isnan(pads).all()                     # pads untouched


@pytest.mark.parametrize("c,nh", [(20, 2), (36, 3)])
@pytest.mark.parametrize("shift", [0, 4])
def test_plain_attention_bwd_on_pitched_qkv_matches_jax(c, nh, shift):
    h, win, b, qkv, bias, mask = _case(c, nh, shift, seed=22)
    g = np.random.RandomState(23).randn(b * h * h, c).astype(np.float32)
    _, vjp = jax.vjp(lambda q, bb: _jax_attention(q, bb, mask, b, h, h, nh,
                                                  win, shift),
                     jnp.asarray(qkv), jnp.asarray(bias))
    want_q, want_b = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    got_q, got_b = torch.empty(b * h * h, 3 * c), torch.empty(nh, 64, 64)
    wab.window_attention_bwd(_pitched_view(qkv), torch.from_numpy(g), bias,
                             None if mask is None else torch.from_numpy(mask),
                             h, h, nh, win, shift, got_q, got_b)
    np.testing.assert_allclose(got_q.numpy(), want_q, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, atol=ATOL, rtol=RTOL)


def test_wrappers_refuse_wrong_shapes():
    bias = torch.zeros(2, 64, 64)
    qkv = torch.zeros(2 * 256, 60)
    with pytest.raises(ValueError, match="window_attention"):
        wa.window_attention(qkv, torch.empty(2 * 256, 24), bias, None, 16,
                            16, 2, 8, 0)
    with pytest.raises(ValueError, match="window_attention"):     # no mask
        wa.window_attention(qkv, torch.empty(2 * 256, 20), bias, None, 16,
                            16, 2, 8, 4)
    with pytest.raises(ValueError, match="window_attention_bwd"):
        wab.window_attention_bwd(qkv, torch.zeros(2 * 256, 20), bias, None,
                                 16, 16, 2, 8, 0, torch.empty(2 * 256, 20),
                                 torch.empty(2, 64, 64))
    cfg = DRCTModelConfig(**CONFIGS["window8"])
    with pytest.raises(ValueError, match="fused_swin_block"):
        fsb.fused_swin_block(torch.zeros(256, 16), {}, {}, cfg, 16, 16, 0,
                             torch.empty(256, 12))
    assert wa.window_attention.launches == 0
    assert fsb.fused_swin_block.launches == 0


def test_wrappers_refuse_the_card_route_for_unsupported_geometry():
    # what the kernels cannot take raises before any launch, on tensor
    # metadata (a "meta" tensor is not on the CPU, so it takes the card's
    # route)
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="8x8 windows"):
        wa.window_attention(torch.empty(512, 36, **meta),
                            torch.empty(512, 12, **meta),
                            torch.empty(2, 16, 16, device="meta"), None, 16,
                            16, 2, 4, 0)
    with pytest.raises(NotImplementedError, match="head dims"):
        wa.window_attention(torch.empty(256, 3 * 136, **meta),
                            torch.empty(256, 136, **meta),
                            torch.empty(1, 64, 64, device="meta"), None, 16,
                            16, 1, 8, 0)
    assert wa.window_attention.launches == 0


@pytest.mark.parametrize("name", ["fixup", "window8"])
def test_block_mode_matches_jax_block_mode(name):
    # kernel (g)'s plain path over the packed 16-byte-row weights, block by
    # block, against the JAX block mode (Pallas in interpret mode)
    jcfg, pcfg, params = jax_params(name)
    packed = prepack_drct(port_state_dict(name), pcfg, pcfg.img_size,
                          pcfg.img_size, dtype=torch.float32, device="cpu",
                          mode="block")
    assert all(p["wqkv"].stride(0) % 8 == 0
               for blocks in packed["rdgs"] for p in blocks)
    x = lr_input(jcfg)
    jp = jax_prepack(params, jcfg, jcfg.img_size, jcfg.img_size,
                     dtype=jnp.float32, mode="block")
    want = np.asarray(jax_apply(jp, jcfg, x, dtype=jnp.float32))
    with torch.no_grad():
        got = fused_drct_apply(packed, pcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
