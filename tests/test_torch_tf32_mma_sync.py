"""The 3xTF32 arithmetic of (c) f32 (``csrc/window_attention_tc_f32.cuh``)
and (d) f32 (``csrc/rdg_gemm_bwd_f32.cu``), the f32 kernels on the tensor
cores through ``mma.sync``, emulated on the CPU, and their launch plans.

Both split each f32 operand as hi = x with its low 13 bits cleared and lo =
x - hi, of which the tensor cores read the top 19 bits
(``torch_port_util`` ``tf32_split_trunc``); (d) sums each 128 of a
reduction apart before adding them (two levels), wgrad's splits of the M
rows in a fixed order; (c) runs the online softmax over key tiles of
min(N, 64) with P @ V from the f32 probabilities. Each product is held to
the f64 one at 1e-6 relative L2, a tenth of the card's limit against the
plain f32 versions (``chip_smoke.py`` ``F32_REL_L2``), and to the JAX
package's f32 function on the same numpy inputs at precision HIGHEST: the
JAX backward's products (``adsr_tpu/ops/fused_rdg_train.py`` ``_mm``,
``_mm_at_b``, ``_gelu_grad``) and its window attention
(``adsr_tpu/ops/window_attention.py`` ``window_attention_xla``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsr_tpu.ops import fused_rdg_train as jax_train
from adsr_tpu.ops.window_attention import window_attention_xla

from adsr_tpu_torch.core import config as pc
from adsr_tpu_torch.kernels import rdg_gemm_bwd as gb
from adsr_tpu_torch.kernels import window_attention as attn_mod
from adsr_tpu_torch.kernels.fused_rdg import rdg_geometry
from adsr_tpu_torch.kernels.window_attention import full_bias, full_mask
from adsr_tpu_torch.models.drct import shift_attn_mask, shift_region_labels

from torch_port_util import matmul_3xtf32, tf32_split_trunc, tf32_truncate

FLAGSHIP = pc.drct_experiment("grid", 128, 4, run_tag="t").model
LIMIT = 1e-6
CHUNK = 128           # (d)'s two-level sums: 8 steps of 16
F32_HEADS = [(180, 6), (212, 4), (244, 2), (276, 6), (308, 4)]


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(t, dtype=np.float64) for t in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e3, 1e20])
def test_trunc_split_parts_are_tf32_and_within_2e20(scale):
    # hi and lo (as the tensor cores read it) have their low 13 mantissa
    # bits zero; x - hi is exact in f32; hi + lo is within 2^-20 of |x|
    rng = np.random.default_rng(25)
    x = (scale * rng.standard_normal(4096)).astype(np.float32)
    hi, lo = tf32_split_trunc(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.array_equal(tf32_truncate(hi), hi)
    assert np.array_equal(hi + (x - hi), x)
    assert (np.abs(hi) <= np.abs(x)).all()        # truncation: toward zero
    err = np.abs(x.astype(np.float64) - hi - lo.astype(np.float64))
    assert (err <= 2.0 ** -20 * np.abs(x.astype(np.float64))).all()


def _products(k):
    """Block k's five backward products as (name, N, K, transform) of dY
    [M, N] and W [N, K], with the training backward's dY transforms."""
    g = rdg_geometry(FLAGSHIP)
    c, f, a = g["feats"][k], g["hidden"][k], g["adj_out"][k]
    return [("adjust", a, c, "alpha" if k == 4 else "slope"),
            ("fc2", c, f, "scale_gelu"), ("fc1", f, c, None),
            ("proj", c, c, "scale"), ("qkv", 3 * c, c, None)]


def _case(rng, m, n, kk, transform):
    """(dy, w, a, kwargs of the wrappers) for one product, numpy f32."""
    dy = rng.standard_normal((m, n)).astype(np.float32)
    w = (0.05 * rng.standard_normal((n, kk))).astype(np.float32)
    a = rng.standard_normal((m, kk)).astype(np.float32)
    kw = {}
    if transform == "alpha":
        kw["alpha"] = 0.2
    if transform == "slope":
        kw["slope_src"] = torch.from_numpy(
            rng.standard_normal((m, n)).astype(np.float32))
    if transform in ("scale", "scale_gelu"):
        kw["row_scale"] = torch.tensor([1.0 / 0.9, 0.0], dtype=torch.float32)
    if transform == "scale_gelu":
        kw["gelu_pre"] = torch.from_numpy(
            rng.standard_normal((m, kk)).astype(np.float32))
    return dy, w, a, kw


def _dy_eff(dy, kw) -> np.ndarray:
    """f32 dY_eff as the pre-pass forms it (``dy_effective``)."""
    return gb.dy_effective(torch.from_numpy(dy), kw.get("alpha", 1.0),
                           kw.get("slope_src"), kw.get("row_scale")).numpy()


@pytest.mark.parametrize("k", range(5))
def test_3xtf32_dgrad_within_1e6_of_f64_and_jax(k):
    # dA = dY_eff @ W (x GELU'(pre) for fc2's dgrad, the fc1 activation's
    # gradient) of block k + 1's five products at 256 token rows of two
    # images, reduced over N in chunks of 128 as the kernel's two levels
    rng = np.random.default_rng(250 + k)
    m = 256
    for name, n, kk, transform in _products(k):
        dy, w, a, kw = _case(rng, m, n, kk, transform)
        eff = _dy_eff(dy, kw)
        got = matmul_3xtf32(eff, w, "trunc", CHUNK)
        want = eff.astype(np.float64) @ w.astype(np.float64)
        with jax.default_matmul_precision("highest"):
            ref = jax_train._mm(jnp.asarray(eff), jnp.asarray(w))
            if "gelu_pre" in kw:
                grad = jax_train._gelu_grad(jnp.asarray(kw["gelu_pre"]))
                ref = ref * grad
        if "gelu_pre" in kw:
            gelu = gb.gelu_grad(kw["gelu_pre"]).numpy()
            got = got * gelu
            want = want * gelu.astype(np.float64)
        assert got.dtype == np.float32
        assert _rel_l2(got, want) <= LIMIT, name
        assert _rel_l2(got, np.asarray(ref)) <= LIMIT, name


@pytest.mark.parametrize("k", range(5))
def test_3xtf32_wgrad_in_two_levels_within_1e6_of_f64_and_jax(k):
    # dW = dY_eff^T @ A over 2,048 token rows cut into the plan's splits,
    # each summed in chunks of 128 rows, the split partials added in order;
    # db the column sums of 32-row partials in order
    rng = np.random.default_rng(260 + k)
    m = 2048
    for name, n, kk, transform in _products(k):
        dy, w, a, kw = _case(rng, m, n, kk, transform)
        eff = _dy_eff(dy, kw)
        plan = gb.gemm_bwd_f32_plan(m, n, kk)
        rows = plan["rows_per_split"]
        got = np.zeros((n, kk), np.float32)
        for r in range(0, m, rows):
            got = got + matmul_3xtf32(eff[r:r + rows].T, a[r:r + rows],
                                      "trunc", CHUNK)
        db = np.zeros(n, np.float32)
        for r in range(0, m, 32):
            db = db + eff[r:r + 32].sum(0, dtype=np.float32)
        want = eff.T.astype(np.float64) @ a.astype(np.float64)
        with jax.default_matmul_precision("highest"):
            ref = jax_train._mm_at_b(jnp.asarray(eff), jnp.asarray(a))
        assert plan["splits"] == -(-m // rows)
        assert _rel_l2(got, want) <= LIMIT, name
        assert _rel_l2(got, np.asarray(ref)) <= LIMIT, name
        assert _rel_l2(db, eff.astype(np.float64).sum(0)) <= LIMIT, name


def _window_operands(rng, window, shift, nh):
    """Head 0's bias [N, N] and the shift mask [N, N] (zeros at shift 0) of
    the last window of a 2W x 2W token grid, in the forms the kernel reads
    converted to the full ones (``full_bias``, ``full_mask``)."""
    n = window * window
    if window in attn_mod.TILED_WINDOWS:
        table = torch.from_numpy(
            (0.5 * rng.standard_normal((nh, 961))).astype(np.float32))
        bias = full_bias(table, window)[0].numpy()
        labels = torch.as_tensor(shift_region_labels(2 * window, 2 * window,
                                                     window, shift))
        mask = full_mask(labels, window)[-1].numpy()
    else:
        bias = (0.5 * rng.standard_normal((n, n))).astype(np.float32)
        mask = np.asarray(shift_attn_mask(2 * window, 2 * window, window,
                                          shift), np.float32)[-1]
    if not shift:
        mask = np.zeros_like(mask)
    return bias, mask


def _emulate_attention(q, k, v, term, hdp):
    """(c) f32's algorithm for one (window, head): planes zero-padded to
    hdp, key tiles of min(N, 64), S = 3xTF32(q k^T) scale + term, the
    online softmax in f32, O += 3xTF32(P V); returns (O / sum, max, 1 /
    sum)."""
    n, hd = q.shape
    r = min(n, 64)
    scale = np.float32(1.0 / np.sqrt(np.float64(hd)))

    def pad(t):
        out = np.zeros((n, hdp), np.float32)
        out[:, :hd] = t
        return out

    qp, kp, vp = pad(q), pad(k), pad(v)
    m_run = np.full((n, 1), -np.inf, np.float32)
    l_run = np.zeros((n, 1), np.float32)
    o = np.zeros((n, hdp), np.float32)
    for t0 in range(0, n, r):
        s = matmul_3xtf32(qp, kp[t0:t0 + r].T, "trunc") * scale \
            + term[:, t0:t0 + r]
        m_new = np.maximum(m_run, s.max(-1, keepdims=True))
        alpha = np.exp(m_run - m_new)
        p = np.exp(s - m_new)
        l_run = l_run * alpha + p.sum(-1, keepdims=True, dtype=np.float32)
        o = o * alpha + matmul_3xtf32(p, vp[t0:t0 + r], "trunc")
        m_run = m_new
    return (o / l_run)[:, :hd], m_run[:, 0], (1 / l_run)[:, 0]


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("window", [4, 8, 16])
@pytest.mark.parametrize("c,nh", F32_HEADS)
def test_3xtf32_attention_within_1e6_of_f64_and_jax(c, nh, window, shift):
    # one window of one head of each flagship block's head dim (30, 53, 122,
    # 46, 77, padded to the plan's multiple of 16) at windows 4, 8 and 16,
    # unshifted and at half the window (the last window: every region), the
    # bias and mask in the forms attn_operands gives; at N = 256 also the
    # softmax statistics (max, 1 / sum)
    hd, n = c // nh, window * window
    hdp = attn_mod.window_attention_f32_plan(c, nh, 1, 2 * window,
                                             2 * window, window)["hdp"]
    assert hdp == -(-hd // 16) * 16
    rng = np.random.default_rng(hd * window + shift)
    q, k, v = (rng.standard_normal((n, hd)).astype(np.float32)
               for _ in range(3))
    bias, mask = _window_operands(rng, window, shift * window // 2, nh)
    term = bias + mask
    got, mx, inv = _emulate_attention(q, k, v, term, hdp)

    scale = 1.0 / np.sqrt(np.float64(hd))
    s64 = q.astype(np.float64) @ k.T.astype(np.float64) * scale + term
    m64 = s64.max(-1, keepdims=True)
    e64 = np.exp(s64 - m64)
    want = (e64 / e64.sum(-1, keepdims=True)) @ v.astype(np.float64)
    with jax.default_matmul_precision("highest"):
        ref = window_attention_xla(
            jnp.asarray(q * np.float32(scale))[None, None],
            jnp.asarray(k)[None, None], jnp.asarray(v)[None, None],
            jnp.asarray(bias)[None], jnp.asarray(mask)[None])[0, 0]
    assert got.dtype == np.float32
    assert _rel_l2(got, want) <= LIMIT
    assert _rel_l2(got, np.asarray(ref)) <= LIMIT
    if window in attn_mod.TILED_WINDOWS:
        assert _rel_l2(mx, m64[:, 0]) <= LIMIT
        assert _rel_l2(inv, 1 / e64.sum(-1)) <= LIMIT


@pytest.mark.parametrize("m,n,k", [(2008, 32, 180), (4096, 924, 308),
                                   (65536, 180, 360), (65536, 32, 212),
                                   (16, 180, 4), (1, 540, 180)])
def test_gemm_bwd_f32_plan_covers_ragged_shapes(m, n, k):
    # M not a multiple of either tile, adjust's N = 32 at window 16's M,
    # a K of one piece and a single row: every output tile launched once,
    # every row in exactly one split, the scratch regions 256-byte aligned
    # and disjoint, dgrad's 64-row and wgrad's 128-row tiles
    for prep in (False, True):
        p = gb.gemm_bwd_f32_plan(m, n, k, 132, True, True, prep)
        (dm, dn), (wm, wn) = p["dgrad_tile"], p["wgrad_tile"]
        assert (dm, wm) == (64, 128) and dn == wn == 64
        assert p["dgrad_grid"] == (-(-k // 64), -(-m // 64), 1)
        assert p["wgrad_grid"][:2] == (-(-k // 64), -(-n // 128))
        rows, splits = p["rows_per_split"], p["splits"]
        assert rows % gb.F32_BK == 0 and splits * rows >= m
        assert (splits - 1) * rows < max(m, 1)
        assert p["prep_grid"] == (-(-n // 32), -(-m // 32))
        regions = [(0, m * n * 4 if prep else 0),
                   (p["part"], splits * n * k * 4),
                   (p["db_part"], -(-m // 32) * n * 4)]
        for (start, size), (nxt, _) in zip(regions, regions[1:]):
            assert start % 256 == 0 and start + size <= nxt
        assert p["bytes"] == regions[-1][0] + regions[-1][1]
        blocks = p["wgrad_grid"][0] * p["wgrad_grid"][1] * splits
        assert blocks <= 132 * gb.F32_WGRAD_BLOCKS_PER_SM or \
            rows == max(256, gb.F32_BK)
    # dgrad alone, no transform: no pre-pass at all
    alone = gb.gemm_bwd_f32_plan(m, n, k, 132, True, False, False)
    assert alone["prep_grid"] is None and alone["bytes"] == 0
