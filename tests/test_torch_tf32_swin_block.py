"""The 3xTF32 arithmetic of f32 (g) (``csrc/swin_block_f32.cuh``) and of (f)
f32 at 4x4 and 8x8 windows (``csrc/window_attention_bwd_f32.cuh``), the f32
kernels on the tensor cores through ``mma.sync``, emulated on the CPU, and
their launch plans.

Both split each f32 operand as hi = x with its low 13 bits cleared and lo =
x - hi, of which the tensor cores read the top 19 bits (``torch_port_util``
``tf32_split_trunc``). (g) sums every product of K = c in two levels (each
128 of K apart, then in order), adds fc2's 128-wide hidden chunks into the
stream in order (fc2's bias with the first), and runs each head's attention
as two halves of every key tile of min(N, 64) keys, each an online softmax,
merged at the end. (f) recomputes the softmax over both key halves, D =
rowsum(P o dP), dS = P o (dP - D), and dQ, dK, dV as 3xTF32 products, the
d(bias) partial summed window by window.

Each result is held to f64 at 1e-6 relative L2, a tenth of the card's limit
against the plain f32 versions (``chip_smoke.py`` ``F32_REL_L2``), and to
the JAX package's f32 function on the same numpy inputs at precision
HIGHEST: its ``SwinBlock`` (LayerNorms, window attention, MLP) and
``jax.vjp`` of ``window_attention_xla``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

from adsr_tpu.models.drct import SwinBlock
from adsr_tpu.models.factory import fast_init
from adsr_tpu.ops.window_attention import window_attention_xla

from adsr_tpu_torch.core import config as pc
from adsr_tpu_torch.kernels import fused_swin_block as fsb
from adsr_tpu_torch.kernels import window_attention_bwd as ab
from adsr_tpu_torch.kernels.rdg_layernorm import EPS
from adsr_tpu_torch.kernels.window_attention import (BLOCK_RESERVED,
                                                     BLOCK_SHARED_MAX,
                                                     REGISTERS,
                                                     SM_SHARED_BYTES)
from adsr_tpu_torch.models.drct import (shift_attn_mask, window_partition,
                                        window_reverse)

from torch_port_util import matmul_3xtf32

LIMIT = 1e-6
CHUNK = 128              # two-level sums: every 128 of K; MLP chunks
F32_BLOCKS = [(180, 6, 360), (212, 4, 424), (244, 2, 488), (276, 6, 276),
              (308, 4, 308)]


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(t, dtype=np.float64) for t in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _windows(x, h, win, shift):
    """[B, h*h, c] -> [B*nW, N, c] in the kernel's row map (the cyclic shift
    rolls first)."""
    b, _, c = x.shape
    t = torch.from_numpy(np.ascontiguousarray(x)).reshape(b, h, h, c)
    if shift:
        t = torch.roll(t, (-shift, -shift), dims=(1, 2))
    return window_partition(t, win).numpy()


def _unwindows(xw, b, h, win, shift):
    t = window_reverse(torch.from_numpy(np.ascontiguousarray(xw)), win, h, h)
    if shift:
        t = torch.roll(t, (shift, shift), dims=(1, 2))
    return t.reshape(b, h * h, -1).numpy()


def _layer_norm(x, g, b, f64=False):
    """Two-pass statistics and the kernel's (x - mean) * 1/std * g + b."""
    dt = np.float64 if f64 else np.float32
    x = x.astype(dt)
    mu = x.mean(-1, keepdims=True, dtype=dt)
    var = np.square(x - mu).mean(-1, keepdims=True, dtype=dt)
    rs = (dt(1) / np.sqrt(var + dt(EPS))).astype(dt)
    return ((x - mu) * rs * g.astype(dt) + b.astype(dt)).astype(dt)


def _gelu(v):
    out = 0.5 * v.astype(np.float64) * (1 + erf(v.astype(np.float64)
                                                 / np.sqrt(2.0)))
    return out.astype(v.dtype)


def _mm(a, w, chunk=CHUNK, f64=False):
    """a [M, K] @ w [N, K]^T: the kernel's product (3xTF32, each ``chunk``
    of K summed apart, then in order), or f64."""
    if f64:
        return a.astype(np.float64) @ w.T.astype(np.float64)
    return matmul_3xtf32(a, np.ascontiguousarray(w.T), "trunc", chunk)


def _attend(q, k, v, term, f64=False):
    """One (window, head)'s context: f64 softmax, or the kernel's two key
    halves of every tile of min(N, 64) keys, each an online softmax over its
    tiles (3xTF32 S and P V), merged."""
    n, hd = q.shape
    scale = 1.0 / np.sqrt(np.float64(hd))
    if f64:
        s = q.astype(np.float64) @ k.T.astype(np.float64) * scale + term
        e = np.exp(s - s.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True) @ v.astype(np.float64)
    scale = np.float32(scale)
    r = min(n, 64)
    half = r // 2
    parts = []
    for h0 in (0, half):
        m = np.full((n, 1), -np.inf, np.float32)
        l = np.zeros((n, 1), np.float32)
        o = np.zeros((n, hd), np.float32)
        for t0 in range(0, n, r):
            ks = slice(t0 + h0, t0 + h0 + half)
            s = matmul_3xtf32(q, np.ascontiguousarray(k[ks].T), "trunc") \
                * scale + term[:, ks]
            m_new = np.maximum(m, s.max(-1, keepdims=True))
            alpha = np.exp(m - m_new)
            p = np.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)
            o = o * alpha + matmul_3xtf32(p, v[ks], "trunc")
            m = m_new
        parts.append((m, l, o))
    (m0, l0, o0), (m1, l1, o1) = parts
    m = np.maximum(m0, m1)
    a0, a1 = np.exp(m0 - m), np.exp(m1 - m)
    return (o0 * a0 + o1 * a1) * (np.float32(1) / (l0 * a0 + l1 * a1))


def _block(x, p, mask, h, win, shift, nh, f64=False):
    """The Swin block as the kernel computes it (or in f64): LN1, qkv,
    attention a (window, head), proj + residual, LN2, fc1 + GELU and fc2
    a hidden chunk of 128 at a time, added into the stream in order."""
    b, _, c = x.shape
    hd, n = c // nh, win * win
    dt = np.float64 if f64 else np.float32
    xw = _windows(x, h, win, shift).astype(dt)
    nwin = xw.shape[0]
    rows = xw.reshape(-1, c)
    qkv = (_mm(_layer_norm(rows, p["ln1_w"], p["ln1_b"], f64), p["wqkv"],
               f64=f64) + p["bqkv"]).reshape(nwin, n, 3, nh, hd)
    ctx = np.zeros((nwin, n, c), dt)
    nw = (h // win) ** 2
    for w in range(nwin):
        for hh in range(nh):
            term = p["attn_bias"][hh] + (mask[w % nw] if mask is not None
                                         else 0)
            q, k, v = (qkv[w, :, i, hh] for i in range(3))
            ctx[w, :, hh * hd:(hh + 1) * hd] = _attend(q, k, v, term, f64)
    x1 = _mm(ctx.reshape(-1, c), p["wproj"], f64=f64) + p["bproj"] + rows
    ln2 = _layer_norm(x1, p["ln2_w"], p["ln2_b"], f64)
    y = x1
    f = p["w1"].shape[0]
    for f0 in range(0, f, CHUNK):
        hid = _gelu(_mm(ln2, p["w1"][f0:f0 + CHUNK], f64=f64)
                    + p["b1"][f0:f0 + CHUNK])
        part = _mm(hid, p["w2"][:, f0:f0 + CHUNK], chunk=0, f64=f64)
        y = y + (part + p["b2"] if f0 == 0 else part)
    return _unwindows(y.reshape(nwin, n, c), b, h, win, shift)


def _jax_block(c, nh, f, win, shift, h, seed):
    """A JAX ``SwinBlock`` (width c, nh heads, hidden f) on h x h tokens,
    its params (seeded init plus a seeded N(0, 0.02) on every leaf) and an
    input [1, h*h, c] f32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(1, h * h, c).astype(np.float32)
    blk = SwinBlock(dim=c, input_resolution=(h, h), num_heads=nh,
                    window_size=win, shift_size=shift, mlp_ratio=f / c)
    params = fast_init(blk.init, jax.random.key(seed), jnp.asarray(x),
                       (h, h))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.randn(*np.shape(a)).astype(np.float32), params)
    return blk, params, x


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("win", [4, 8, 16])
@pytest.mark.parametrize("c,nh,f", F32_BLOCKS)
def test_3xtf32_swin_block_within_1e6_of_f64_and_jax(c, nh, f, win, shift):
    # each flagship block's width, heads and hidden width (head dims 30,
    # 53, 122, 46, 77; hidden 360-488, and 276 / 308 whose last chunk is
    # short) at windows 4, 8 and 16 on 2 x 2 windows, unshifted and at half
    # the window, the block's weights carried from the JAX module
    h, sh = 2 * win, shift * win // 2
    blk, params, x = _jax_block(c, nh, f, win, sh, h, c + win + shift)
    p = {k: v.numpy() for k, v in
         fsb.pack_swin_weights(params, c, win).items()}
    assert p["w1"].shape == (f, c) and p["attn_bias"].shape == (
        nh, win * win, win * win)
    mask = shift_attn_mask(h, h, win, sh) if sh else None
    got = _block(x, p, mask, h, win, sh, nh)
    want = _block(x, p, mask, h, win, sh, nh, f64=True)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(blk.apply({"params": params}, jnp.asarray(x),
                                   (h, h)))
    assert got.dtype == np.float32
    assert _rel_l2(got, want) <= LIMIT
    assert _rel_l2(got, ref) <= LIMIT
    # the block's own contribution, without the residual input
    assert _rel_l2(got - x, want - x) <= LIMIT


def _attention_bwd(q, k, v, do, term, f64=False):
    """One (window, head)'s (dq, dk, dv, ds) as (f) f32 computes them at N
    = 16 and 64 (3xTF32 products, the softmax over both key halves, D =
    rowsum(P o dP)), or in f64."""
    n, hd = q.shape
    scale = 1.0 / np.sqrt(np.float64(hd))
    if f64:
        q, k, v, do = (t.astype(np.float64) for t in (q, k, v, do))
        s = q @ k.T * scale + term
        e = np.exp(s - s.max(-1, keepdims=True))
        pr = e / e.sum(-1, keepdims=True)
        dp = do @ v.T
        ds = pr * (dp - (pr * dp).sum(-1, keepdims=True))
        return ds @ k * scale, ds.T @ q * scale, pr.T @ do, ds
    scale = np.float32(scale)
    half = n // 2

    def mm(a, b):
        return matmul_3xtf32(np.ascontiguousarray(a), np.ascontiguousarray(b),
                             "trunc")

    s = mm(q, k.T) * scale + term
    dp = mm(do, v.T)
    halves = (slice(0, half), slice(half, n))
    mx = np.maximum(*(s[:, hs].max(-1, keepdims=True) for hs in halves))
    e = np.exp(s - mx)
    inv = np.float32(1) / (e[:, halves[0]].sum(-1, keepdims=True,
                                                dtype=np.float32)
                           + e[:, halves[1]].sum(-1, keepdims=True,
                                                 dtype=np.float32))
    pr = e * inv
    d = sum((pr[:, hs] * dp[:, hs]).sum(-1, keepdims=True, dtype=np.float32)
            for hs in halves)
    ds = pr * (dp - d)
    return mm(ds, k) * scale, mm(ds.T, q) * scale, mm(pr.T, do), ds


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("win", [4, 8])
@pytest.mark.parametrize("c,nh", [(c, nh) for c, nh, _ in F32_BLOCKS])
def test_3xtf32_attention_bwd_within_1e6_of_f64_and_jax(c, nh, win, shift):
    # one head of each flagship block's head dim over the four windows of
    # a 2W x 2W token grid (at 4x4 windows one set of four, at 8x8 four
    # sets of one), unshifted and at half the window: dQ, dK, dV and the
    # d(bias) summed window by window, against f64 and jax.vjp of
    # window_attention_xla (the JAX package's attention, fed scale q)
    hd, n, h = c // nh, win * win, 2 * win
    sh = shift * win // 2
    rng = np.random.default_rng(hd * win + shift)
    q, k, v, do = (rng.standard_normal((4, n, hd)).astype(np.float32)
                   for _ in range(4))
    bias = (0.5 * rng.standard_normal((n, n))).astype(np.float32)
    mask = np.asarray(shift_attn_mask(h, h, win, sh), np.float32) if sh \
        else np.zeros((4, n, n), np.float32)
    got = [_attention_bwd(q[w], k[w], v[w], do[w], bias + mask[w])
           for w in range(4)]
    want = [_attention_bwd(q[w], k[w], v[w], do[w], bias + mask[w], True)
            for w in range(4)]
    db = np.zeros((n, n), np.float32)
    for g in got:                         # the partial, window by window
        db = db + g[3]
    scale = np.float32(1.0 / np.sqrt(np.float64(hd)))
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(
            lambda a, b, c_, d: window_attention_xla(a, b, c_, d,
                                                     jnp.asarray(mask)),
            jnp.asarray(q * scale)[:, None], jnp.asarray(k)[:, None],
            jnp.asarray(v)[:, None], jnp.asarray(bias)[None])
        dqs, dk, dv, dbias = vjp(jnp.asarray(do)[:, None])
    ref = {"dq": np.asarray(dqs)[:, 0] * scale, "dk": np.asarray(dk)[:, 0],
           "dv": np.asarray(dv)[:, 0], "dbias": np.asarray(dbias)[0]}
    for i, name in enumerate(("dq", "dk", "dv")):
        mine = np.stack([g[i] for g in got])
        assert mine.dtype == np.float32
        assert _rel_l2(mine, np.stack([w[i] for w in want])) <= LIMIT, name
        assert _rel_l2(mine, ref[name]) <= LIMIT, name
    assert _rel_l2(db, sum(w[3] for w in want)) <= LIMIT
    assert _rel_l2(db, ref["dbias"]) <= LIMIT


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("hr,batch", [(128, 16), (128, 5), (256, 16),
                                      (256, 5), (64, 16), (64, 5)])
def test_tensor_core_plans_fit_the_card(hr, batch, k):
    # f32 (g) and (f) f32 at every block of the flagship (window 8),
    # 256px/x4 (16) and 64/x4 (4) models at batch 16 and 5 (on 20 x 20
    # tokens at window 4: a short last group): each block's shared memory
    # within 227 KB, the blocks an SM their plans name by shared memory and
    # the sources' launch bounds, registers within the SM's
    cfg = pc.drct_experiment("grid", hr, 4, run_tag="t").model
    geo = fsb.block_geometry(cfg, k)
    c, f, nh, win = geo["c"], geo["hidden"], geo["heads"], cfg.window_size
    side = 20 if (win == 4 and batch == 5) else cfg.img_size
    sp = fsb.swin_block_f32_plan(c, f, nh, batch, side, side, win)
    assert sp["smem_bytes"] <= BLOCK_SHARED_MAX
    assert SM_SHARED_BYTES // (sp["smem_bytes"] + BLOCK_RESERVED) >= 1
    # one block of 256 threads an SM: 255 registers a thread fit
    assert sp["threads"] * 255 <= REGISTERS
    windows = batch * (side // win) ** 2
    assert sp["blocks"] == (-(-windows // 4) if win == 4
                            else windows * sp["cluster"])
    ap = ab.window_attention_bwd_f32_plan(c, nh, batch, side, side, win, 132)
    assert ap["smem_bytes"] <= BLOCK_SHARED_MAX
    most = ab.bwd_f32_min_blocks(ap["hdp"]) if win != 16 \
        else ab.bwd16_f32_min_blocks(ap["hdp"])[1]
    assert 1 <= ap["blocks_per_sm"] <= most
    assert ap["blocks_per_sm"] * (ap["smem_bytes"] + BLOCK_RESERVED) \
        <= SM_SHARED_BYTES
    assert ap["threads"] * (REGISTERS // (ap["threads"] * most)) * most \
        <= REGISTERS
    # every window in one group, the last one possibly short
    assert (ap["groups"] - 1) * ap["group"] + ap["last_group"] == windows
    assert 1 <= ap["last_group"] <= ap["group"]


@pytest.mark.parametrize("c,nh", [(12, 2), (16, 2), (20, 2), (28, 2),
                                  (180, 6)])
def test_swin_block_f32_act_region_holds_the_hidden_chunk(c, nh):
    # act holds the context [64][ldc] and then the MLP's hidden chunk
    # [64][136]: at widths below 128 the chunk is the larger (embed 12's
    # blocks 12..28 wide), and the union's stream y keeps its own ldc
    plan = fsb.swin_block_f32_plan(c, 2 * c, nh, 2, 16, 16, 8)
    ldc = -(-c // 32) * 32 + 8
    assert plan["ldc"] == ldc
    assert plan["regions"]["act"] == 4 * 64 * max(ldc, 136) >= 4 * 64 * 136
    assert plan["y"] == 4 * 64 * ldc
    assert plan["smem_bytes"] == sum(plan["regions"].values())
