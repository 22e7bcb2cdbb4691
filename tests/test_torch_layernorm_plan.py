"""The host side of kernel (a) ``rdg_layernorm`` on the CPU: its launch plan
(a numpy model of the rows each block, warp and lane group takes, at the
three geometries' M and at ragged ones), the layout rule that picks its
piece width or refuses a layout before any card route, and the wrapper's
plain route on a wide concat prefix against flax's LayerNorm. The kernel
itself runs only on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from flax import linen as nn

from adsr_tpu_torch.kernels import rdg_layernorm as ln
from adsr_tpu_torch.kernels.rdg_gemm import pitched

from torch_port_util import ATOL, RTOL

SMS = 132


def _rows_taken(plan: dict, m: int) -> np.ndarray:
    """Every row the kernel's loop visits, in the order of
    ``csrc/rdg_layernorm.cu``: block b's warp w takes 32 / lanes rows (one
    a lane group) at b * rows_per_step + w * (32 / lanes), then steps by the
    grid's rows a step while its warp's first row is below m."""
    per_warp = 32 // plan["lanes"]
    block = np.arange(plan["blocks"])[:, None, None, None]
    warp = np.arange(plan["threads"] // 32)[None, :, None, None]
    group = np.arange(per_warp)[None, None, :, None]
    step = np.arange(plan["steps_per_block"])[None, None, None, :]
    rows = (block * plan["rows_per_step"] + warp * per_warp + group
            + step * plan["blocks"] * plan["rows_per_step"])
    return rows[rows < m]


# blocks an SM holds of the instance without and with a row ahead: the
# H100's reading for 8-byte pieces, and a card that holds more of the
# instance that keeps no row ahead
@pytest.mark.parametrize("per_sm", [(5, 5), (8, 6)])
@pytest.mark.parametrize("piece", [8, 2])
@pytest.mark.parametrize("c", [12, 180, 308])
@pytest.mark.parametrize("m", [1, 7, 4096, 4056, 16384, 65536])
def test_rdg_layernorm_plan_covers_every_row_once(m, c, piece, per_sm):
    p = ln.rdg_layernorm_plan(m, c, SMS, piece, per_sm)
    assert p["piece"] == piece and p["lanes"] == ln.LANES[piece]
    assert p["threads"] == ln.THREADS
    assert p["rows_per_step"] == p["threads"] // p["lanes"]
    rows = _rows_taken(p, m)
    assert len(rows) == m and np.array_equal(np.sort(rows), np.arange(m))
    # one wave of the instance it launches: no block waits
    assert 1 <= p["blocks"] <= SMS * per_sm[p["ahead"]]
    steps = -(-m // p["rows_per_step"])
    if steps >= SMS:                          # every SM has rows
        assert p["blocks"] >= SMS
    # a block of one step loads nothing ahead; a looping one its next row
    assert p["ahead"] == (0 if p["steps_per_block"] == 1 else 1)


def _buffer(m, n, dtype=torch.bfloat16):
    return torch.zeros(m, n, dtype=dtype)


@pytest.mark.parametrize("case,want", [
    ("pitched x1 into pitched out", 8),
    ("concat prefix at stride 312", 8),
    ("concat prefix at stride 308 (the main path's)", 8),
    ("contiguous x1 at c = 180 (the main path's)", 8),
    ("pitched x1 into a contiguous [m, 180] out", 8),
    ("a base 4 bytes past alignment", 2),
    ("c = 178, not a multiple of 4", 2),
    ("an odd row stride", 2),
])
def test_check_ln_layout_picks_the_piece(case, want):
    m, c = 40, 180
    cat312, cat308 = pitched(m, 308), _buffer(m, 308)
    x1p, outp = pitched(m, c), pitched(m, c)
    x, out = {
        "pitched x1 into pitched out": (x1p, outp),
        "concat prefix at stride 312": (cat312[:, :c], outp),
        "concat prefix at stride 308 (the main path's)": (cat308[:, :c],
                                                          outp),
        "contiguous x1 at c = 180 (the main path's)": (_buffer(m, c), outp),
        "pitched x1 into a contiguous [m, 180] out": (x1p, _buffer(m, c)),
        "a base 4 bytes past alignment": (cat312[:, 2:2 + c], outp),
        "c = 178, not a multiple of 4": (cat312[:, :178],
                                         pitched(m, 178)),
        "an odd row stride": (_buffer(m, 181)[:, :c], outp),
    }[case]
    assert cat312.stride(0) == 312 and x.data_ptr() % 2 == 0
    assert ln.check_ln_layout("t", x, out) == want


@pytest.mark.parametrize("case,match", [
    ("row stride below c", "row stride of at least"),
    ("c above 320", "widths from 1 to 320"),
    ("no columns", "widths from 1 to 320"),
    ("column stride 2", "unit column stride"),
])
def test_check_ln_layout_refuses_what_the_kernel_does_not_take(case, match):
    flat = torch.zeros(64 * 400, dtype=torch.bfloat16)
    x = {"row stride below c": flat.as_strided((40, 180), (176, 1)),
         "c above 320": flat.as_strided((40, 324), (324, 1)),
         "no columns": flat.as_strided((40, 0), (8, 1)),
         "column stride 2": flat.as_strided((40, 180), (400, 2))}[case]
    with pytest.raises(ValueError, match=match):
        ln.check_ln_layout("rdg_layernorm", x, torch.empty(x.shape,
                                                            dtype=x.dtype))


@pytest.mark.parametrize("m", [1, 37, 64])
@pytest.mark.parametrize("c", [12, 180, 308])
def test_wide_prefix_matches_flax(c, m):
    # the concat prefix at its buffer's stride, NaN past column c: the
    # plain route reads only the prefix, as the kernel stops at column c
    rng = np.random.RandomState(c + m)
    x = (rng.randn(m, c) * 3 + 1).astype(np.float32)
    s, b = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    want = nn.LayerNorm(epsilon=ln.EPS).apply(
        {"params": {"scale": s, "bias": b}}, x)
    wide = np.full((m, 312), np.nan, np.float32)
    wide[:, :c] = x
    out = torch.empty(m, c)
    ln.rdg_layernorm.launches = 0
    ln.rdg_layernorm(torch.from_numpy(wide)[:, :c], torch.from_numpy(s),
                     torch.from_numpy(b), out)
    assert ln.rdg_layernorm.launches == 0          # the CPU: plain
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
