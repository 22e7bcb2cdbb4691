"""The Python side of the Hopper GEMM kernels (b) and (d), on the CPU: the
output tile width per product, wgrad's reduction splits, its scratch layout,
and the layout checkers that refuse operands the kernels cannot take. The
kernels themselves run only on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from adsr_tpu_torch.kernels import rdg_gemm as rg
from adsr_tpu_torch.kernels import rdg_gemm_bwd as gb

# the flagship's five blocks: (c, f)
BLOCKS = [(180, 360), (212, 424), (244, 488), (276, 276), (308, 308)]


@pytest.mark.parametrize("c,f", BLOCKS)
def test_forward_tile_width_per_product(c, f):
    # qkv, proj, fc1, fc2, adjust 1-4, adjust 5
    got = [rg.n_tile(n) for n in (3 * c, c, f, c, 32, 180)]
    assert got[4] == 32                     # exactly m64n32 for adjust 1-4
    assert got[5] == 192                    # one 192-wide tile for adjust 5
    assert min(got[:4]) >= 128              # wide tiles for the rest


@pytest.mark.parametrize("n", [4, 12, 32, 96, 180, 212, 540, 924, 1000])
def test_tile_width_wastes_less_than_a_tile(n):
    for widths in ((192, 128, 64, 32), gb._MN_WIDTHS):
        w = rg.n_tile(n, widths)
        assert w in widths
        assert -(-n // w) * w - n < w
        # no other width does less padded work at the same tile cost
        cost = -(-n // w) * (w + rg._TILE_COST)
        assert all(cost <= -(-n // v) * (v + rg._TILE_COST) for v in widths)


@pytest.mark.parametrize("m,n,k", [(16384, 924, 308), (16384, 32, 180),
                                   (16384, 180, 308), (16384, 488, 244),
                                   (512, 96, 212), (300, 8, 8), (1, 4, 4),
                                   (100000, 32, 12)])
def test_wgrad_splits_plan(m, n, k):
    s, rows = gb.wgrad_splits(m, n, k)
    assert rows % 64 == 0 and rows >= 64
    assert s * rows >= m > (s - 1) * rows          # every split has rows
    tiles = -(-n // 128) * -(-k // rg.n_tile(k, gb._MN_WIDTHS))
    assert s == 1 or s * tiles <= 132               # one block per SM at most
    assert s == 1 or rows >= 256                    # long M ranges a block


def test_wgrad_splits_fill_the_card_at_the_flagship():
    for c, f in BLOCKS:
        for n, k in ((3 * c, c), (c, c), (f, c), (c, f), (32, c)):
            s, rows = gb.wgrad_splits(16384, n, k)
            tiles = -(-n // 128) * -(-k // rg.n_tile(k, gb._MN_WIDTHS))
            # half the SMs at least, unless the splits are at their least
            assert s * tiles > 132 // 2 or rows == 256, (n, k, s, tiles)


@pytest.mark.parametrize("wgrad", [True, False])
@pytest.mark.parametrize("prep", [True, False])
@pytest.mark.parametrize("m,n,k", [(16384, 924, 308), (300, 36, 12)])
def test_wgrad_scratch_layout(m, n, k, prep, wgrad):
    # splits 0: dgrad alone, which needs only dY_eff
    s = gb.wgrad_splits(m, n, k)[0] if wgrad else 0
    part, db_part, end, lde = gb.wgrad_scratch(m, n, k, s, prep)
    assert lde % 8 == 0 and n <= lde < n + 8        # 16-byte dY_eff rows
    assert part % 256 == 0 and db_part % 256 == 0
    assert part >= (m * lde * 2 if prep else 0)     # dY_eff fits before
    assert db_part - part >= s * n * k * 4          # the dW partials
    # one db row per 32 rows
    assert end - db_part == (-(-m // 32) * n * 4 if wgrad else 0)
    if not wgrad:
        assert end == part == (-(-m * lde * 2 // 256) * 256 if prep else 0)


@pytest.mark.parametrize("dtype,width,kw,want", [
    (torch.bfloat16, 8, {}, False),
    (torch.bfloat16, 12, {}, True),                 # rows not 16-byte aligned
    (torch.float32, 8, {}, True),
    (torch.bfloat16, 8, {"alpha": 0.2}, True),
    (torch.bfloat16, 8, {"slope_src": torch.zeros(4, 8)}, True),
    (torch.bfloat16, 8, {"row_scale": torch.ones(2)}, True)])
def test_needs_prep(dtype, width, kw, want):
    dy = torch.zeros(4, width, dtype=dtype)
    assert gb.needs_prep(dy, kw.get("alpha", 1.0), kw.get("slope_src"),
                         kw.get("row_scale")) is want


def _bf(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def test_gemm_layout_takes_the_flagship_operands():
    cat = _bf(64, 308)
    for c in (180, 212, 308):
        rg.check_gemm_layout("t", c, cat[:, :c], _bf(32, c), cat[:, c:c + 32])
        # W as a column prefix of a buffer with 16-byte rows
        rg.check_gemm_layout("t", c, cat[:, :c], _bf(3 * c, c + 4)[:, :c],
                             _bf(64, 3 * c))
        rg.check_gemm_layout("t", c, cat[:, :c], _bf(180, c), cat[:, :180],
                             cat[:, :180])


@pytest.mark.parametrize("case", ["k", "lda", "w", "n", "ldo", "col", "base"])
def test_gemm_layout_refuses(case):
    a, w, out = _bf(16, 64), _bf(32, 64), _bf(16, 32)
    if case == "k":
        a, w = _bf(16, 66), _bf(32, 66)
    elif case == "lda":
        a = _bf(16, 70)[:, :64]
    elif case == "w":
        w = _bf(64, 32).t()
    elif case == "n":
        w, out = _bf(30, 64), _bf(16, 30)
    elif case == "ldo":
        out = _bf(16, 34)[:, :32]
    elif case == "col":
        out = _bf(32, 16).t()
    else:
        out = _bf(16, 40)[:, 1:33]
    with pytest.raises(ValueError):
        rg.check_gemm_layout("t", a.shape[1], a, w, out)


def test_bwd_layout_takes_the_flagship_operands():
    dcat = torch.zeros(64, 308)
    cat = _bf(64, 308)
    gb.check_bwd_layout("t", dcat[:, 212:244], 212, _bf(32, 212),
                        cat[:, 212:244], out=torch.zeros(64, 212))
    gb.check_bwd_layout("t", dcat[:, :180], 360, _bf(180, 360),
                        out=_bf(64, 360))


@pytest.mark.parametrize("case", ["dtype", "n", "ldy", "k", "out_ld",
                                  "out_dtype", "out_base", "dy_base"])
def test_bwd_layout_refuses(case):
    dy, w, out, k = torch.zeros(16, 32), _bf(32, 64), torch.zeros(16, 64), 64
    if case == "dtype":
        dy = torch.zeros(16, 32, dtype=torch.float16)
    elif case == "n":
        dy, w = torch.zeros(16, 30), _bf(30, 64)
    elif case == "ldy":
        dy = torch.zeros(16, 34)[:, :32]
    elif case == "k":
        k, w, out = 62, _bf(32, 62), torch.zeros(16, 62)
    elif case == "out_ld":
        out = torch.zeros(16, 66)[:, :64]
    elif case == "out_dtype":
        out = torch.zeros(16, 64, dtype=torch.float16)
    elif case == "out_base":
        out = torch.zeros(16, 68)[:, 2:66]              # f32 needs 16 bytes
    else:
        dy = torch.zeros(16, 36)[:, 2:34]           # f32 needs 16 bytes
    with pytest.raises(ValueError):
        gb.check_bwd_layout("t", dy, k, w, out=out)


def test_forward_wrapper_raises_off_the_cpu():
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        rg.rdg_gemm(torch.empty(16, 8, **meta), torch.empty(4, 8, **meta),
                    torch.empty(4, device="meta"), torch.empty(16, 4, **meta))
    assert rg.rdg_gemm.launches == 0


@pytest.mark.parametrize("kw", [{}, {"alpha": 0.2}, {"row_scale": "scale"},
                                {"gelu_pre": "pre"}])
def test_grads_is_dgrad_and_wgrad(kw):
    # the combined call of the training backward computes both products
    g = torch.Generator().manual_seed(0)
    m, n, k = 64, 12, 20
    dy, w, a = (torch.randn(*s, generator=g) for s in ((m, n), (n, k), (m, k)))
    kw = {key: {"scale": torch.tensor([1.1, 0.0]),
                "pre": torch.randn(m, k, generator=g)}.get(v, v)
          for key, v in kw.items()}
    out, dw, db = torch.empty(m, k), torch.empty(n, k), torch.empty(n)
    assert gb.rdg_gemm_grads(dy, w, a, out, dw, db, **kw) is out
    torch.testing.assert_close(out, gb.rdg_gemm_dgrad_plain(dy, w, **kw))
    kw.pop("gelu_pre", None)
    want_w, want_b = gb.rdg_gemm_wgrad_plain(dy, a, **kw)
    torch.testing.assert_close(dw, want_w)
    torch.testing.assert_close(db, want_b)
