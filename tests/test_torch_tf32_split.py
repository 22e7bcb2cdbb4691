"""The 3xTF32 arithmetic of the f32 kernels that run on the tensor cores,
emulated on the CPU: (b) f32 (``csrc/rdg_gemm_f32.cu``) and (f) f32 at 16x16
windows (``csrc/window_attention_bwd_f32.cuh``).

Each f32 operand is split as hi = tf32(x), lo = tf32(x - hi) and a product
sums a_lo b_hi + a_hi b_lo + a_hi b_hi in f32 (``torch_port_util``
``matmul_3xtf32``). Held to the f64 product at 1e-6 relative L2, a tenth of
the card's limit against the plain f32 versions (1e-5, ``chip_smoke.py``
``F32_REL_L2``): the split must be as good as f32 itself, or the design is
wrong.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adsr_tpu_torch.core import config as pc
from adsr_tpu_torch.kernels import rdg_gemm as gemm_mod
from adsr_tpu_torch.kernels import window_attention_bwd as ab
from adsr_tpu_torch.kernels.fused_rdg import rdg_geometry
from adsr_tpu_torch.kernels.window_attention import full_bias, full_mask
from adsr_tpu_torch.models.drct import shift_region_labels

from torch_port_util import matmul_3xtf32, tf32_round, tf32_split

FLAGSHIP = pc.drct_experiment("grid", 128, 4, run_tag="t").model
LIMIT = 1e-6


def _rel_l2(got, want) -> float:
    got, want = (torch.as_tensor(np.asarray(t), dtype=torch.float64)
                 for t in (got, want))
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e3, 1e20])
def test_split_is_exact_in_f32_and_both_parts_are_tf32(scale):
    # hi and lo have their low 13 mantissa bits zero; x - hi is exact in
    # f32, so hi + (x - hi) == x bit for bit; lo rounds x - hi (up to 13
    # significant bits) to TF32's 11, so hi + lo is within 2^-22 of |x|
    rng = np.random.default_rng(7)
    x = (scale * rng.standard_normal(4096)).astype(np.float32)
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.array_equal(hi + (x - hi), x)
    assert np.array_equal(tf32_round(hi), hi)
    err = np.abs(x.astype(np.float64) - hi - lo.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()
    # ties go to even: 1 + 2^-11 lies half-way between two TF32 values
    tie = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11], np.float32)
    assert np.array_equal(tf32_round(tie), np.array([1.0, 1 + 2.0 ** -9],
                                                    np.float32))


def _epilogue(y, epi, res, row_scale):
    """``rdg_gemm_plain``'s epilogue on ``y`` (a @ w^T + bias) in its own
    dtype."""
    if epi == "residual":
        return y + res
    if epi == "drop_residual":
        return res + gemm_mod.per_row(row_scale, y.shape[0]).to(y.dtype) * y
    if epi in ("gelu", "gelu_aux"):
        return F.gelu(y)
    if epi == "leaky_relu":
        return F.leaky_relu(y, 0.2)
    if epi == "scaled_residual":
        return 0.2 * y + res
    return y


@pytest.mark.parametrize("epi", list(gemm_mod.EPILOGUES))
@pytest.mark.parametrize("k", range(5))
def test_3xtf32_gemm_within_1e6_of_f64(k, epi):
    # block k + 1's five products of the flagship (qkv, proj, fc1, fc2,
    # adjust) at 64 token rows of two images, each epilogue
    g = rdg_geometry(FLAGSHIP)
    c, f, a = g["feats"][k], g["hidden"][k], g["adj_out"][k]
    rng = np.random.default_rng(10 * k + list(gemm_mod.EPILOGUES).index(epi))
    m = 64
    for n_out, kk in ((3 * c, c), (c, c), (f, c), (c, f), (a, c)):
        x = rng.standard_normal((m, kk)).astype(np.float32)
        w = (0.05 * rng.standard_normal((n_out, kk))).astype(np.float32)
        bias = (0.05 * rng.standard_normal(n_out)).astype(np.float32)
        res = rng.standard_normal((m, n_out)).astype(np.float32)
        row_scale = torch.tensor([1.1, 0.0])
        pre64 = torch.from_numpy(x).double() @ torch.from_numpy(w).double().T \
            + torch.from_numpy(bias).double()
        pre = torch.from_numpy(matmul_3xtf32(x, w.T) + bias)
        want = _epilogue(pre64, epi, torch.from_numpy(res).double(), row_scale)
        got = _epilogue(pre, epi, torch.from_numpy(res), row_scale)
        assert got.dtype == torch.float32
        assert _rel_l2(got, want) <= LIMIT, (n_out, kk)
        if epi == "gelu_aux":          # the pre-activation it keeps
            assert _rel_l2(pre, pre64) <= LIMIT, (n_out, kk)


F32_HEADS = [(180, 6), (212, 4), (244, 2), (276, 6), (308, 4)]


@pytest.mark.parametrize("shift", [0, 8])
@pytest.mark.parametrize("c,nh", F32_HEADS)
def test_3xtf32_attention_bwd16_within_1e6_of_f64(c, nh, shift):
    # one 16x16 window (N = 256) and one head of each flagship block's head
    # dim (30, 53, 122, 46, 77, zero-padded to the plan's multiple of 8), at
    # shift 0 and 8 (four regions, -100 between them): the kernel's
    # algorithm with every product in 3xTF32, P from the forward's
    # statistics and D = rowsum(dO o O) from its context (the f64 ones
    # rounded to f32), against the f64 backward
    hd = c // nh
    hdp = ab.window_attention_bwd_f32_plan(c, nh, 1, 16, 16, 16)["hdp"]
    assert hdp == -(-hd // 8) * 8
    rng = np.random.default_rng(hd + shift)
    q, k, v, do = (rng.standard_normal((256, hd)).astype(np.float32)
                   for _ in range(4))
    table = torch.from_numpy(
        (0.5 * rng.standard_normal((1, 961))).astype(np.float32))
    term = full_bias(table, 16)[0]
    if shift:
        labels = torch.as_tensor(shift_region_labels(16, 16, 16, shift))
        term = term + full_mask(labels, 16)[0]
    term = term.numpy()
    scale = np.float32(hd ** -0.5)

    # f64 reference
    q64, k64, v64, do64 = (t.astype(np.float64) for t in (q, k, v, do))
    s64 = q64 @ k64.T * float(scale) + term
    mx = s64.max(-1, keepdims=True)
    e = np.exp(s64 - mx)
    p64 = e / e.sum(-1, keepdims=True)
    o64 = p64 @ v64
    dp64 = do64 @ v64.T
    ds64 = p64 * (dp64 - (do64 * o64).sum(-1, keepdims=True))
    want = {"dq": ds64 @ k64 * float(scale), "dk": ds64.T @ q64 * float(scale),
            "dv": p64.T @ do64, "dbias": ds64}

    # the kernel's arithmetic, planes zero-padded to hdp
    def pad(t):
        out = np.zeros((256, hdp), np.float32)
        out[:, :hd] = t
        return out

    qp, kp, vp, dop, op = (pad(t) for t in (q, k, v, do,
                                             o64.astype(np.float32)))
    row_max = mx.astype(np.float32)
    row_inv = (1.0 / e.sum(-1, keepdims=True)).astype(np.float32)
    s = matmul_3xtf32(qp, kp.T)
    p = np.exp(s * scale + term - row_max) * row_inv
    d = (dop * op).sum(-1, keepdims=True, dtype=np.float32)
    ds = p * (matmul_3xtf32(dop, vp.T) - d)
    got = {"dq": matmul_3xtf32(ds, kp) * scale,
           "dk": matmul_3xtf32(ds.T, qp) * scale,
           "dv": matmul_3xtf32(p.T, dop), "dbias": ds}
    for name, ref in want.items():
        assert got[name].dtype == np.float32
        assert _rel_l2(got[name][:, :ref.shape[1]], ref) <= LIMIT, name
