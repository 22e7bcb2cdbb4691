"""Kernels (c) and (f) at 16x16 windows as the redesigned card route calls
them, on the CPU: kernel (c)'s softmax statistics, kernel (f) fed the
forward's context and statistics (D from dO and O), the compact forms of
the bias (its relative-position table) and of the shift mask (region
labels) that both kernels read at N = 256, their launch plans at the
flagship's and the 256px model's blocks, and the training backward's route
that threads the statistics and the context from the recompute to (f).
The JAX side is the JAX package's XLA attention and its ``jax.vjp``; the
kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.models import drct as jdrct

from adsr_tpu_torch.kernels import fused_rdg_train as frt
from adsr_tpu_torch.kernels import window_attention as wa
from adsr_tpu_torch.kernels import window_attention_bwd as wab
from adsr_tpu_torch.kernels.fused_rdg import shift_masks

from torch_port_util import (ATOL, RTOL, jax_params, jax_window_attention,
                             lr_input, port_state_dict)

WIN, SIDE, BATCH = 16, 32, 2          # 4 windows an image, 8 a call
N, T = WIN * WIN, (2 * WIN - 1) ** 2
# (width, heads): head dims 10 and 12, neither a multiple of 8
CASES = [(20, 2), (36, 3)]


def _case(c, nh, shift, seed):
    """Raster qkv, the bias as a relative-position table [nh, 961] and the
    shift mask as region labels [nW, 256] (the card's forms), and both
    gathered as the JAX package builds them (its relative_position_index
    and shift_attn_mask)."""
    rng = np.random.RandomState(seed)
    qkv = rng.randn(BATCH * SIDE * SIDE, 3 * c).astype(np.float32)
    table = rng.randn(T, nh).astype(np.float32)
    idx = jdrct.relative_position_index(WIN).reshape(-1)
    bias = table[idx].reshape(N, N, nh).transpose(2, 0, 1)
    mask = jdrct.shift_attn_mask(SIDE, SIDE, WIN, shift) if shift else None
    labels = (wa.shift_labels(SIDE, SIDE, WIN, shift, torch.device("cpu"))
              if shift else None)
    return qkv, torch.from_numpy(np.ascontiguousarray(table.T)), bias, mask, \
        labels


def _scores64(qkv, bias, mask, c, nh, shift):
    """f64 scores [B*nW, nh, N, N] of the raster qkv, numpy only."""
    hd = c // nh
    x = qkv.astype(np.float64).reshape(BATCH, SIDE, SIDE, 3 * c)
    x = np.roll(x, (-shift, -shift), axis=(1, 2))
    x = x.reshape(BATCH, SIDE // WIN, WIN, SIDE // WIN, WIN, 3 * c)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, N, 3, nh, hd)
    q, k = x[:, :, 0].transpose(0, 2, 1, 3), x[:, :, 1].transpose(0, 2, 1, 3)
    s = q @ k.transpose(0, 1, 3, 2) * hd ** -0.5 + bias[None]
    if mask is not None:
        s = (s.reshape(BATCH, -1, nh, N, N) + mask[None, :, None]) \
            .reshape(s.shape)
    return s


@pytest.mark.parametrize("c,nh", CASES)
@pytest.mark.parametrize("shift", [0, 8])
def test_plain_attention_stats_match_f64_scores_at_window16(c, nh, shift):
    # the context is the JAX package's, and each query row's (max, 1 / sum
    # of exp(score - max)) that of the f64 scores: the plain version's f32
    # scores and sums of 256 exponentials read at most 1.3e-6 off here (max)
    # and 1.0e-6 relative (1 / sum), so 1e-5, relative to each value
    qkv, table, bias, mask, labels = _case(c, nh, shift, seed=51)
    want = np.asarray(jax_window_attention(
        jnp.asarray(qkv), jnp.asarray(bias), mask, BATCH, SIDE, SIDE, nh,
        WIN, shift))
    q = torch.from_numpy(qkv)
    stats = wa.softmax_stats(q, SIDE, SIDE, nh, WIN)
    assert stats.shape == (BATCH * 4, nh, N, 2)
    out = torch.empty(BATCH * SIDE * SIDE, c)
    n0 = wa.window_attention.launches
    wa.window_attention(q, out, table, labels, SIDE, SIDE, nh, WIN, shift,
                        stats)
    assert wa.window_attention.launches == n0              # the CPU: plain
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=RTOL)
    s = _scores64(qkv, bias, mask, c, nh, shift)
    mx = s.max(-1)
    inv = 1.0 / np.exp(s - mx[..., None]).sum(-1)
    np.testing.assert_allclose(stats[..., 0].numpy(), mx, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(stats[..., 1].numpy(), inv, rtol=1e-5)
    # the full forms give the same context and statistics
    again, st2 = torch.empty_like(out), torch.empty_like(stats)
    wa.window_attention(q, again, torch.from_numpy(bias),
                        None if mask is None else torch.from_numpy(mask),
                        SIDE, SIDE, nh, WIN, shift, st2)
    torch.testing.assert_close(again, out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(st2, stats, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("c,nh", CASES)
@pytest.mark.parametrize("shift", [0, 8])
def test_plain_attention_bwd_with_forward_stats_matches_jax_vjp(c, nh,
                                                                 shift):
    # (f) fed the forward's context and statistics, as the training
    # backward feeds the card (P from the statistics, D = rowsum(dO o O)),
    # against jax.vjp of the JAX attention at its f32 tolerance; the
    # inputs of test_plain_attention_bwd_matches_jax_vjp_at_window16
    qkv, table, bias, mask, labels = _case(c, nh, shift, seed=42)
    g = np.random.RandomState(43).randn(BATCH * SIDE * SIDE, c) \
        .astype(np.float32)
    _, vjp = jax.vjp(lambda q, bb: jax_window_attention(
        q, bb, mask, BATCH, SIDE, SIDE, nh, WIN, shift),
        jnp.asarray(qkv), jnp.asarray(bias))
    want_q, want_b = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    q = torch.from_numpy(qkv)
    ctx = torch.empty(BATCH * SIDE * SIDE, c)
    stats = wa.softmax_stats(q, SIDE, SIDE, nh, WIN)
    wa.window_attention(q, ctx, table, labels, SIDE, SIDE, nh, WIN, shift,
                        stats)
    got_q = torch.empty(BATCH * SIDE * SIDE, 3 * c)
    got_b = torch.empty(nh, N, N)
    n0 = wab.window_attention_bwd.launches
    wab.window_attention_bwd(q, torch.from_numpy(g), table, labels, SIDE,
                             SIDE, nh, WIN, shift, got_q, got_b, ctx, stats)
    assert wab.window_attention_bwd.launches == n0       # the CPU: plain
    np.testing.assert_allclose(got_q.numpy(), want_q, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, atol=ATOL, rtol=RTOL)
    # the statistics and the context are given together or not at all
    with pytest.raises(ValueError, match="ctx and stats"):
        wab.window_attention_bwd(q, torch.from_numpy(g), table, labels, SIDE,
                                 SIDE, nh, WIN, shift, got_q, got_b, ctx)


@pytest.mark.parametrize("side,win,shift", [(64, 16, 8), (32, 16, 8),
                                            (32, 8, 4), (40, 8, 4)])
def test_compact_forms_expand_to_the_jax_bias_and_mask(side, win, shift):
    # the relative-position table gathers to the JAX package's index and
    # the region labels expand to its shift mask, bit for bit
    rng = np.random.RandomState(win + side)
    nh, t = 3, (2 * win - 1) ** 2
    table = rng.randn(t, nh).astype(np.float32)
    idx = jdrct.relative_position_index(win).reshape(-1)
    want_b = table[idx].reshape(win * win, win * win, nh).transpose(2, 0, 1)
    table_t = torch.from_numpy(np.ascontiguousarray(table.T))
    got_b = wa.full_bias(table_t, win)
    assert np.array_equal(got_b.numpy(), want_b)
    masks = shift_masks(side, side, win, (0, shift), torch.device("cpu"))
    labels = wa.shift_labels(side, side, win, shift, torch.device("cpu"))
    assert labels.dtype == torch.int32
    assert labels.shape == ((side // win) ** 2, win * win)
    want_m = jdrct.shift_attn_mask(side, side, win, shift)
    assert np.array_equal(wa.full_mask(labels, win).numpy(), want_m)
    assert np.array_equal(masks[shift].numpy(), want_m)
    # attn_operands: the table and the labels at 16x16 windows, the full
    # bias and mask at 8x8
    p = {"attn_bias": got_b, "attn_table": table_t}
    bias, got = wa.attn_operands(p, masks, side, side, shift, win)
    assert bias is (table_t if win == 16 else got_b)
    assert got is (labels if win == 16 else masks[shift])
    assert wa.attn_operands(p, masks, side, side, 0, win)[1] is None
    # the statistics buffer (max, 1 / sum) a query row, at 16x16 windows
    st = wa.softmax_stats(torch.empty(2 * side * side, 9), side, side, 3, win)
    if win == 16:
        assert st.shape == (2 * (side // win) ** 2, 3, win * win, 2)
        assert st.dtype == torch.float32
    else:
        assert st is None


# (c, heads) of the flagship's and the 256px model's five blocks
BLOCKS = [(180, 6), (212, 4), (244, 2), (276, 6), (308, 4)]


@pytest.mark.parametrize("c,nh", BLOCKS)
def test_window16_plans_fit_the_card_at_batch_16(c, nh):
    # 256px at batch 16 (64 x 64 tokens): every plan within a block's
    # 232,448 bytes of shared memory, with the blocks an SM the design
    # gives: (c) two warpgroups a block, two blocks an SM up to a head tile
    # of 64; (f)'s dq one warpgroup, three blocks an SM up to 64 and two
    # above; dkv two warpgroups, one block an SM
    pc = wa.window_attention_plan(c, nh, 16, 64, 64, window=WIN)
    pf = wab.window_attention_bwd_plan(c, nh, 16, 64, 64, 132, WIN)
    small = pc["hdp"] <= 64
    assert pc["smem_bytes"] <= wa.BLOCK_SHARED_MAX
    assert pf["smem_bytes"] <= wa.BLOCK_SHARED_MAX
    assert pf["smem_dq_bytes"] <= wa.BLOCK_SHARED_MAX
    assert (pc["threads"], pc["blocks_per_sm"]) == (256, 2 if small else 1)
    assert (pf["dq_threads"], pf["dq_blocks_per_sm"]) == \
        (128, 3 if small else 2)
    assert (pf["threads"], pf["blocks_per_sm"]) == (256, 1)
    assert pc["blocks"] == 16 * 16 * nh
    assert pf["dq_blocks"] == 16 * 16 * nh * 4
    assert pf["partial_bytes"] <= wab.MAX_PARTIAL_BYTES
    assert pc["stats_bytes"] == 16 * 16 * nh * N * 8
    # the flagship's 8x8-window plans are the N = 64 kernels' (unchanged)
    p8 = wa.window_attention_plan(c, nh, 16, 32, 32)
    assert (p8["threads"], p8["key_tiles"]) == (128, 1)
    assert p8["smem_bytes"] == 3 * 64 * (p8["hdp"] + 8) * 2
    assert "stats_bytes" not in p8


@pytest.mark.parametrize("name", ["window16", "window8"])
def test_training_backward_threads_the_forward_stats_to_f(name,
                                                          monkeypatch):
    # one RDG's training backward on the CPU: at 16x16 windows every (f)
    # call gets the bias table, the region labels and the recompute's
    # context and statistics; at 8x8 windows the full forms and neither
    _, pcfg, _ = jax_params(name)
    win = pcfg.window_size
    seen = []
    real = frt.window_attention_bwd

    def spy(qkv, dout, bias, mask, h, w, nh, window, shift, dqkv, dbias,
            ctx=None, stats=None):
        seen.append((bias.dim(), None if mask is None else mask.dim(),
                     ctx is not None, stats is not None))
        if stats is not None:       # the recompute's context and statistics
            want = torch.empty_like(stats)
            wa.window_attention_plain(qkv, bias, mask, h, w, nh, window,
                                      shift, want)
            torch.testing.assert_close(stats, want)
            assert ctx.shape == dout.shape
        return real(qkv, dout, bias, mask, h, w, nh, window, shift, dqkv,
                    dbias, ctx, stats)

    monkeypatch.setattr(frt, "window_attention_bwd", spy)
    from adsr_tpu_torch.models.factory import make_model
    pm = make_model(pcfg, device="cpu")
    pm.load_state_dict(port_state_dict(name))
    named = dict(pm.named_parameters())
    x = torch.from_numpy(lr_input(pcfg))
    dp = torch.ones(pcfg.num_layers, x.shape[0], 10)
    sr = frt.fused_drct_train_forward(named, pcfg, x, dp,
                                      dtype=torch.float32)
    sr.abs().mean().backward()
    assert len(seen) == 5 * pcfg.num_layers
    shifted = [s for s in seen if s[1] is not None]
    assert shifted and len(shifted) < len(seen)
    if win == 16:
        assert all(s[0] == 2 and s[2] and s[3] for s in seen)
        assert all(s[1] == 2 for s in shifted)
    else:
        assert all(s[0] == 3 and not s[2] and not s[3] for s in seen)
        assert all(s[1] == 3 for s in shifted)
    # the bias table takes no gradient of its own: its parameter's comes
    # through the gathered bias
    table = named["layers.0.swin2.attn.relative_position_bias_table"]
    assert table.grad is not None and bool((table.grad != 0).any())
