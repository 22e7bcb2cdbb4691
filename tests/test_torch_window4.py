"""The window-4 geometry (4x4 windows, N = 16 keys a window: the 64/x4,
128/x8 and 32/x2 models) on the CPU: the plain versions of kernels (c)
``window_attention`` and (f) ``window_attention_bwd`` at the five blocks'
widths against the JAX attention and its ``jax.vjp``, the eager DRCT and
the fused forward (plain versions, both serving modes) at full width
against the JAX DRCT, the shipped configs, the launch plans of (c), (f) and
(g) at window 4, a numpy model of (c)'s and (f)'s work map, the kernels'
row maps ((c) and (f) a window at a time, (g) a group of four) against the
JAX package's roll, window partition and shift-mask regions, and the card
route's device check.
The JAX side runs its plain (XLA) path. The kernels themselves run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.models import drct as jdrct

from adsr_tpu_torch.core.config import drct_experiment
from adsr_tpu_torch.kernels import fused_swin_block as fsb
from adsr_tpu_torch.kernels import window_attention as wa
from adsr_tpu_torch.kernels import window_attention_bwd as wab
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.kernels.fused_rdg import rdg_geometry
from adsr_tpu_torch.models.drct import relative_position_bias
from adsr_tpu_torch.models.factory import make_model

from torch_port_util import (ATOL, RTOL, jax_apply, jax_params,
                             jax_window_attention, lr_input, port_state_dict)

WIN, SIDE, BATCH = 4, 16, 2           # 16 windows an image, 32 a call
N = WIN * WIN
# drct_experiment("grid", 64, 4) (and 128/x8, 32/x2): (c, heads, shift) of
# the five blocks, head dims 30/53/122/46/77
BLOCKS = [(180, 6, 0), (212, 4, 2), (244, 2, 0), (276, 6, 2), (308, 4, 0)]
PAIRS = [(c, nh) for c, nh, _ in BLOCKS]
SMS = 132


def _case(c, nh, shift, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(BATCH * SIDE * SIDE, 3 * c).astype(np.float32)
    table = rng.randn((2 * WIN - 1) ** 2, nh).astype(np.float32)
    bias = relative_position_bias(torch.from_numpy(table), WIN).contiguous()
    mask = jdrct.shift_attn_mask(SIDE, SIDE, WIN, shift) if shift else None
    return qkv, bias, mask


def _mask_t(mask):
    return None if mask is None else torch.from_numpy(mask)


@pytest.mark.parametrize("c,nh", PAIRS)
@pytest.mark.parametrize("shift", [0, 2])
def test_plain_attention_matches_jax_at_window4(c, nh, shift):
    qkv, bias, mask = _case(c, nh, shift, seed=51)
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


@pytest.mark.parametrize("c,nh", PAIRS)
@pytest.mark.parametrize("shift", [0, 2])
def test_plain_attention_bwd_matches_jax_vjp_at_window4(c, nh, shift):
    qkv, bias, mask = _case(c, nh, shift, seed=52)
    g = np.random.RandomState(53).randn(BATCH * SIDE * SIDE, c) \
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


@pytest.mark.parametrize("mode", ["rdg", "block"])
def test_eager_and_fused_forward_match_jax_at_window4(mode):
    # embed 180, gc 32, heads 6 (the 64/x4 model's widths), one RDG, LR 16
    jcfg, pcfg, params = jax_params("window4")
    assert pcfg.window_size == WIN
    assert rdg_geometry(pcfg)["shifts"] == (0, 2, 0, 2, 0)
    x = lr_input(jcfg)
    want = np.asarray(jax_apply("window4")({"params": params}, x))
    assert want.shape == (2, 64, 64, 1)
    packed = prepack_drct(port_state_dict("window4"), pcfg, SIDE, SIDE,
                          dtype=torch.float32, device="cpu", mode=mode)
    assert all(m.shape == (16, N, N) for m in packed["masks"].values())
    model = make_model(pcfg, device="cpu")
    model.load_state_dict(port_state_dict("window4"))
    with torch.no_grad():
        got = fused_drct_apply(packed, pcfg, torch.from_numpy(x)).numpy()
        eager = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(eager, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("res,scale", [(64, 4), (128, 8), (32, 2)])
def test_window4_models_match_the_shipped_configs(res, scale):
    cfg = drct_experiment("grid", res, scale).model
    g = rdg_geometry(cfg)
    assert (cfg.img_size, cfg.window_size, cfg.upscale) == (16, WIN, scale)
    assert (cfg.embed_dim, cfg.num_layers) == (180, 12)
    assert list(zip(g["feats"], g["heads"], g["shifts"])) == BLOCKS
    assert [c // nh for c, nh, _ in BLOCKS] == [30, 53, 122, 46, 77]


# --------------------------------------------------------------------------
# Launch plans of (c), (f) and (g) at the five blocks: batch 16 on 16 x 16
# tokens (256 windows, 64 groups of 4) and batch 5 on 20 x 20 (125 windows:
# the last group holds one)
# --------------------------------------------------------------------------

GEOMETRIES = [(16, 16), (5, 20)]


# (c) and (f) also at the 64/x4 CLI's tiled forward: 1,024 crops of 16 x 16
# tokens (16,384 windows), where the grid is persistent
ATTN_GEOMETRIES = GEOMETRIES + [(1024, 16)]


def _check_plan4(p, c, nh, b, side, bwd):
    """What (c)'s and (f)'s window-4 plans promise (kernels/window_attention
    ``plan4``): a block of 8 warps takes every head of one window at a time,
    walking windows over a grid that the card holds at once; one stage
    where that grid gives every window a block, else a persistent grid of
    2 or 3 stages."""
    windows = b * (side // WIN) ** 2
    hdp = p["hdp"]
    assert hdp % 16 == 0 and c // nh <= hdp < c // nh + 16
    assert (p["tokens"], p["group"], p["windows"]) == (N, 1, windows)
    assert (p["warps"], p["threads"]) == (8, 256)
    # the shared memory of the sources' layout (csrc/attn4.cuh)
    pitch = lambda width: -(-width // 16) * 16 + 8
    stage = 1024 + 32 * (pitch(3 * c) + (pitch(c) if bwd else 0))
    # (f): the output rows and each head slot's P and dS tiles
    slot = 2 * N * 24 * 2 if bwd else 0
    out = 32 * pitch(3 * c) if bwd else 0
    assert p["smem_bytes"] == (2 if bwd else 1) * nh * 1024 \
        + p["stages"] * stage + out + min(nh, 8) * slot \
        <= wa.BLOCK_SHARED_MAX
    per_sm = p["blocks_per_sm"]
    # by shared memory, and by registers at the sources' 128 a thread
    assert per_sm >= 1 and per_sm * (p["smem_bytes"] + wa.BLOCK_RESERVED) \
        <= wa.SM_SHARED_BYTES and per_sm * p["threads"] * 128 <= 65536
    # a grid the 132-SM card holds at once; one window a block where it can
    assert p["grid"] == p["blocks"] == min(windows, per_sm * SMS)
    if windows <= per_sm * SMS:
        assert p["stages"] == 1 and p["windows_per_block"] == 1
    else:
        assert p["stages"] in (2, 3) and p["grid"] == per_sm * SMS
        assert p["windows_per_block"] == -(-windows // p["grid"]) > 1
    if bwd:     # one d(bias) partial a block, under the 32 MiB cap
        assert p["partial_bytes"] == p["grid"] * nh * N * N * 4 \
            <= wab.MAX_PARTIAL_BYTES


@pytest.mark.parametrize("c,nh,shift", BLOCKS)
@pytest.mark.parametrize("b,side", ATTN_GEOMETRIES)
def test_window_attention_plan_at_window4(c, nh, shift, b, side):
    p = wa.window_attention_plan(c, nh, b, side, side, window=WIN)
    _check_plan4(p, c, nh, b, side, bwd=False)
    assert "partial_bytes" not in p
    # a block for every window at batch 16 and batch 5, a persistent grid of
    # staged windows at the CLI's 1,024 crops
    assert (p["stages"] == 1) == (b < 1024)
    assert p["grid"] == {16: 256, 5: 125}.get(b, p["grid"])


@pytest.mark.parametrize("c,nh,shift", BLOCKS)
@pytest.mark.parametrize("b,side", ATTN_GEOMETRIES)
def test_window_attention_bwd_plan_at_window4(c, nh, shift, b, side):
    p = wab.window_attention_bwd_plan(c, nh, b, side, side, SMS, WIN)
    assert p.get("launches", 1) == 1
    _check_plan4(p, c, nh, b, side, bwd=True)
    assert (p["stages"] == 1) == (b < 1024)
    assert p["grid"] == {16: 256, 5: 125}.get(b, p["grid"])


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("b,side", GEOMETRIES)
def test_swin_block_plan_at_window4(k, b, side):
    geo = fsb.block_geometry(drct_experiment("grid", 64, 4).model, k)
    c, f, nh = geo["c"], geo["hidden"], geo["heads"]
    p = fsb.swin_block_plan(c, f, nh, b, side, side, window=WIN)
    windows = b * (side // WIN) ** 2
    groups = -(-windows // 4)
    # both geometries leave half the card idle at one block a group: a
    # cluster of two blocks shares each group
    assert (p["group"], p["groups"], p["cluster"]) == (4, groups, 2)
    assert p["blocks"] == 2 * groups <= SMS
    assert p["last_group"] == (4 if b == 16 else 1)
    # the 8x8 kernel's regions, the context region two atoms at least (the
    # MLP's 128-wide hidden chunk)
    p8 = fsb.swin_block_plan(c, f, nh, b, 4 * side, 4 * side, window=8)
    hk = -(-(c // nh + 7) // 64)
    assert p["regions"]["ctx"] == max(hk, 2) * 8192
    for name in ("ln", "x", "qkv"):
        assert p["regions"][name] == p8["regions"][name]
    assert 1024 + sum(p["regions"].values()) == p["smem_bytes"]
    assert p["smem_bytes"] <= wa.BLOCK_SHARED_MAX and p["stages"] >= 7
    assert p["stages"] == fsb.MAX_STAGES or \
        p["smem_bytes"] + fsb.STAGE_BYTES + 16 > wa.BLOCK_SHARED_MAX


def test_window4_plans_at_batch_16():
    g = rdg_geometry(drct_experiment("grid", 64, 4).model)
    fwd = [wa.window_attention_plan(c, nh, 16, 16, 16, window=WIN)
           for c, nh, _ in BLOCKS]
    bwd = [wab.window_attention_bwd_plan(c, nh, 16, 16, 16, SMS, WIN)
           for c, nh, _ in BLOCKS]
    # 256 windows, one a block: at least 132 blocks, every head of a window
    # in one block, two blocks an SM
    for plans in (fwd, bwd):
        assert [p["grid"] for p in plans] == [256] * 5
        assert [p["stages"] for p in plans] == [1] * 5
    assert [p["blocks_per_sm"] for p in fwd + bwd] == [2] * 10
    # the tiled CLI's 1,024 crops: a persistent grid of whole waves of the
    # card, each block walking 21-63 windows
    tiled = [wa.window_attention_plan(c, nh, 1024, 16, 16, window=WIN)
             for c, nh, _ in BLOCKS]
    assert all(p["stages"] > 1 and p["grid"] % SMS == 0 for p in tiled)
    assert [p["windows_per_block"] for p in tiled] == [
        -(-16384 // p["grid"]) for p in tiled]
    # (g): 64 groups of four windows, two blocks each: 128 of the card's
    # 132 SMs
    assert {fsb.swin_block_plan(c, f, nh, 16, 16, 16, window=WIN)["blocks"]
            for c, f, nh in zip(g["feats"], g["hidden"], g["heads"])} == {128}


def _window_rows(b, h, w, shift):
    """[windows, 16] raster rows of each window's tokens as
    ``csrc/attn4.cuh`` ``Win4`` computes them: window fw over the flat
    (image, window) index, token t at ((wi * 4 + t // 4 + shift) mod h,
    (wj * 4 + t % 4 + shift) mod w), the wrap a subtraction."""
    nww, nw = w // WIN, (h // WIN) * (w // WIN)
    fw = np.arange(b * nw)
    img, win = fw // nw, fw % nw
    wi, wj = win // nww, win % nww
    t = np.arange(N)
    r = (wi * WIN + shift)[:, None] + t // WIN
    s = (wj * WIN + shift)[:, None] + t % WIN
    r = np.where(r >= h, r - h, r)
    s = np.where(s >= w, s - w, s)
    return (img * h * w)[:, None] + r * w + s


def _attn4_map(p, rows, width):
    """A numpy model of (c)'s and (f)'s work map at 4x4 windows
    (``csrc/window_attention4.cu``, ``window_attention_bwd4.cu``): block
    ``blk`` of ``grid`` takes windows blk, blk + grid, ...; its warp w
    computes heads w, w + warps, ... of each; it stages the window's 16
    rows and stores each row's ``width`` columns in pieces of 8 elements
    (the last 4 where ``width`` is 4 past a multiple of 8). Returns how
    often each (window, head) is computed, each token row gathered and each
    (row, piece) stored, and the block of each row's stores."""
    windows, nh = rows.shape[0], p["heads"]
    pieces = -(-width // 8)
    units = np.zeros((windows, nh), int)
    gathered = np.zeros(rows.max() + 1, int)
    stored = np.zeros((rows.max() + 1, pieces), int)
    owner = np.full(rows.max() + 1, -1)
    widths = [min(8, width - 8 * k) for k in range(pieces)]
    assert sum(widths) == width and set(widths) <= {4, 8}
    for blk in range(p["grid"]):
        for fw in range(blk, windows, p["grid"]):
            for warp in range(p["warps"]):
                for h in range(warp, nh, p["warps"]):
                    units[fw, h] += 1
            gathered[rows[fw]] += 1
            stored[rows[fw]] += 1
            owner[rows[fw]] = blk
    return units, gathered, stored, owner


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("b,side,shift", [(16, 16, 0), (16, 16, 2),
                                          (5, 20, 2), (64, 16, 2)])
def test_window4_attention_map_computes_and_stores_everything_once(k, b, side,
                                                                   shift):
    c, nh, _ = BLOCKS[k]
    rows = _window_rows(b, side, side, shift)
    for p, width in ((wa.window_attention_plan(c, nh, b, side, side,
                                               window=WIN), c),
                     (wab.window_attention_bwd_plan(c, nh, b, side, side,
                                                    SMS, WIN), 3 * c)):
        units, gathered, stored, owner = _attn4_map(p, rows, width)
        # every (window, head) once; every token row gathered by one block
        # a launch and every 16-byte piece of every output row stored once,
        # by that block (the short last wave of 125 windows included)
        assert (units == 1).all()
        assert (gathered == 1).all() and len(gathered) == b * side * side
        assert (stored == 1).all() and (owner >= 0).all()


@pytest.mark.parametrize("b,side,shift", [(2, 16, 0), (2, 16, 2),
                                          (5, 20, 2), (1, 8, 2)])
def test_window4_rows_match_jax_partition_and_mask_regions(b, side, shift):
    rows = _window_rows(b, side, side, shift)
    idx = jnp.arange(b * side * side).reshape(b, side, side, 1)
    if shift:
        idx = jnp.roll(idx, (-shift, -shift), axis=(1, 2))
    want = np.asarray(jdrct.window_partition(idx, WIN)).reshape(-1, N)
    np.testing.assert_array_equal(rows, want)
    if not shift:
        return
    # the mask row the kernels read for window fw (fw mod nW) separates the
    # tokens of its rows by the region of their place in the rolled image
    mask = np.asarray(jdrct.shift_attn_mask(side, side, WIN, shift))
    nw = mask.shape[0]
    r, s = rows % (side * side) // side, rows % side
    rr, ss = (r - shift) % side, (s - shift) % side

    def region(x):
        return (x >= side - WIN).astype(int) + (x >= side - shift)

    label = 3 * region(rr) + region(ss)
    got = np.where(label[:, :, None] != label[:, None, :], -100.0, 0.0)
    np.testing.assert_array_equal(got, mask[np.arange(len(rows)) % nw])


@pytest.mark.parametrize("b,side,sms,split", [
    (16, 16, SMS, 2),      # the 64/x4 forward: 64 groups
    (2, 16, SMS, 2),       # 8 groups
    (16, 24, SMS, 1),      # 144 groups: one block a group already fills
    (1024, 16, SMS, 1),    # the 64/x4 CLI's tiled forward: 4,096 groups
    (16, 16, 100, 1),      # a card of 100 SMs: 128 blocks would not fit
])
def test_window4_plan_splits_where_the_groups_leave_half_the_card(b, side,
                                                                  sms, split):
    p = fsb.swin_block_plan(180, 360, 6, b, side, side, window=WIN, sms=sms)
    groups = -(-b * (side // WIN) ** 2 // 4)
    assert (p["cluster"], p["blocks"]) == (split, groups * split)
    assert (split == 2) == (2 * groups <= sms)


def _split_counts(b, side, nh, f, c, split):
    """How often the 4x4 kernel's blocks (csrc/swin_block4.cu) compute each
    (group, head), each (group, hidden chunk of 128) and store each output
    element, as a numpy model of its map: block bid is rank r = bid % split
    of group bid // split; it takes heads r, r + split, ..., hidden chunks
    starting at 128 r, 128 (r + split), ..., and stores rows [32 r, 32 r +
    32) of the group (all 64 without a peer) where they hold a token
    (:func:`_group_rows`), every column."""
    rows = _group_rows(b, side, side, 0).reshape(-1, 64)
    groups = rows.shape[0]
    heads = np.zeros((groups, nh), int)
    chunks = np.zeros((groups, -(-f // 128)), int)
    out = np.zeros((b * side * side, c), int)
    for bid in range(groups * split):
        r, grp = bid % split, bid // split
        for h in range(r, nh, split):
            heads[grp, h] += 1
        for f0 in range(128 * r, f, 128 * split):
            chunks[grp, f0 // 128] += 1
        lo, n = (32 * r, 32) if split > 1 else (0, 64)
        live = rows[grp, lo:lo + n]
        out[live[live >= 0]] += 1
    return heads, chunks, out


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("b,side", [(16, 16), (5, 20), (16, 24)])
def test_window4_split_computes_and_stores_everything_once(k, b, side):
    geo = fsb.block_geometry(drct_experiment("grid", 64, 4).model, k)
    c, f, nh = geo["c"], geo["hidden"], geo["heads"]
    p = fsb.swin_block_plan(c, f, nh, b, side, side, window=WIN)
    heads, chunks, out = _split_counts(b, side, nh, f, c, p["cluster"])
    assert heads.shape[0] == p["groups"]
    # every head and hidden chunk of every group once, every output element
    # of every image once (the short last group of 5 x 20 x 20 included)
    assert (heads == 1).all() and (chunks == 1).all() and (out == 1).all()


# --------------------------------------------------------------------------
# Kernel (g)'s group row map (csrc/swin_block4.cu ``token_row``) against the
# JAX package's roll and window partition
# --------------------------------------------------------------------------

def _group_rows(b, h, w, shift):
    """Raster row of row t of group g, -1 past the last window: window fw =
    4 g + t // 16 over the flat (image, window) index, token tt = t % 16 at
    ((wi * 4 + tt // 4 + shift) % h, (wj * 4 + tt % 4 + shift) % w), as the
    sources compute it."""
    nww, nw = w // WIN, (h // WIN) * (w // WIN)
    windows = b * nw
    rows = []
    for g in range(-(-windows // 4)):
        for t in range(64):
            fw = 4 * g + t // N
            if fw >= windows:
                rows.append(-1)
                continue
            img, win = divmod(fw, nw)
            wi, wj = divmod(win, nww)
            tt = t % N
            r = (wi * WIN + tt // WIN + shift) % h
            s = (wj * WIN + tt % WIN + shift) % w
            rows.append(img * h * w + r * w + s)
    return np.array(rows)


@pytest.mark.parametrize("b,side,shift", [(2, 16, 0), (2, 16, 2),
                                          (5, 20, 2), (1, 8, 2)])
def test_group_row_map_matches_jax_roll_and_partition(b, side, shift):
    idx = jnp.arange(b * side * side).reshape(b, side, side, 1)
    if shift:
        idx = jnp.roll(idx, (-shift, -shift), axis=(1, 2))
    want = np.asarray(jdrct.window_partition(idx, WIN)).reshape(-1)
    got = _group_rows(b, side, side, shift)
    windows = b * (side // WIN) ** 2
    assert len(got) == 64 * -(-windows // 4)
    np.testing.assert_array_equal(got[:windows * N], want)
    assert (got[windows * N:] == -1).all()      # the short last group


# --------------------------------------------------------------------------
# The card route at window 4 reaches the device check (a meta tensor is not
# CUDA) before any launch, for (c), (f) and (g)
# --------------------------------------------------------------------------

META = dict(device="meta", dtype=torch.bfloat16)


def test_attention_takes_window4_to_the_device_check():
    c, nh, m = 24, 2, 2 * SIDE * SIDE
    qkv = torch.empty(m, 3 * c, **META)
    bias = torch.empty(nh, N, N, device="meta")
    n0, n1 = wa.window_attention.launches, wab.window_attention_bwd.launches
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        wa.window_attention(qkv, torch.empty(m, c, **META), bias, None, SIDE,
                            SIDE, nh, WIN, 0)
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        wab.window_attention_bwd(qkv, torch.empty(m, c, **META), bias, None,
                                 SIDE, SIDE, nh, WIN, 0,
                                 torch.empty(m, 3 * c, **META),
                                 torch.empty(nh, N, N, device="meta"))
    assert wa.window_attention.launches == n0
    assert wab.window_attention_bwd.launches == n1


def test_block_mode_takes_window4_to_the_device_check():
    from adsr_tpu_torch.core.config import DRCTModelConfig
    cfg = DRCTModelConfig(upscale=4, img_size=SIDE, window_size=WIN,
                          in_chans=1, embed_dim=12, num_layers=1,
                          num_heads=2, gc=4)
    m, c = 2 * SIDE * SIDE, 12
    p = {n: torch.empty(c, c, **META) for n in fsb._MATRICES}
    n0 = fsb.fused_swin_block.launches
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        fsb.fused_swin_block(torch.empty(m, c, **META), p, {}, cfg, SIDE,
                             SIDE, 0, torch.empty(m, c, **META))
    assert fsb.fused_swin_block.launches == n0
