"""Kernel (d) ``rdg_gemm_bwd``: the backward of ``rdg_gemm``'s products.

Three wrappers, for ``out = a @ w.T + b`` with ``w`` [N, K], over one C
entry point (``adsr_rdg_gemm_grads``):

- ``rdg_gemm_dgrad``: ``da = dy_eff @ w`` [M, K] (times GELU'(pre) for
  fc1), written f32 or bf16 at any row stride;
- ``rdg_gemm_wgrad``: ``dw = dy_eff.T @ a`` [N, K] and ``db = dy_eff.sum(0)``
  in f32, reduced over the M = B*L token rows in S splits plus a second,
  deterministic pass (no atomics);
- ``rdg_gemm_grads``: both of one dY in one call (one pre-pass), which the
  training backward uses.

``dy_eff = alpha * dy * leaky'(slope_src) * m[row // L]``: the adjust
convs' LeakyReLU(0.2) derivative is read from the sign of the saved concat
columns (``slope_src``, the activation keeps the sign), adjust 5 carries its
0.2, and proj / fc2 their per-sample stochastic-depth multiplier
(``row_scale`` [B]). ``dy`` may be f32 or bf16, a column slice of a wider
buffer.

Replaces the dW / dx matmuls of the Pallas backward kernel ``_bwd_kernel``
(``adsr_tpu/ops/fused_rdg_train.py:405-770``, called from
``_rdg_train_bwd`` ``:968``). Source: ``adsr_tpu_torch/csrc/rdg_gemm_bwd.cu``
on the mainloop of ``csrc/hopper_gemm.cuh``. Bound on the H100: bytes (one
RDG's 50 products move ~1.0 GB, 0.30 ms at 3.35 TB/s, against 0.15 ms of
bf16 tensor-core work). Design: a pre-pass forms ``dy_eff`` once per call
(one for both products in ``rdg_gemm_grads``), rounds it once to bf16 into
scratch with 16-byte rows and sums its f32 values into db partials of 32
rows; the products then run the pipelined wgmma mainloop (TMA into an
mbarrier ring, persistent blocks), dgrad with dY_eff as the K-major A and W
as the MN-major B, wgrad with dY_eff^T and the activation both MN-major
(wgmma's transpose bits). wgrad cuts M into ``wgrad_splits`` of 256 rows or
more, about one block per SM over the output tiles; a fixed-order pass sums
the partials.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
the call raises.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.rdg_gemm import n_tile, per_row

_BM, _BK = 128, 64           # the mainloop's output rows and reduction step
_PREP_ROWS = 32              # rows of one db partial (dy_prep_kernel)
_SMS = 132                   # the H100's SMs
_MN_WIDTHS = (192, 128, 64)  # tile widths of an MN-major B (whole atoms)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact-erf GELU, x * Phi(x)."""
    x = x.float()
    return 0.5 * (1.0 + torch.erf(x * math.sqrt(0.5))) \
        + x * torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def dy_effective(dy: torch.Tensor, alpha: float = 1.0,
                 slope_src: Optional[torch.Tensor] = None,
                 row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 ``alpha * dy * leaky'(slope_src) * row_scale[row // L]``."""
    g = dy.float() * alpha
    if slope_src is not None:
        g = torch.where(slope_src.float() > 0, g, 0.2 * g)
    if row_scale is not None:
        g = g * per_row(row_scale, g.shape[0])
    return g


def rdg_gemm_dgrad_plain(dy, w, alpha=1.0, slope_src=None, row_scale=None,
                         gelu_pre=None) -> torch.Tensor:
    """f32 ``dy_eff @ w`` (x GELU'(gelu_pre))."""
    da = dy_effective(dy, alpha, slope_src, row_scale) @ w.float()
    return da * gelu_grad(gelu_pre) if gelu_pre is not None else da


def rdg_gemm_wgrad_plain(dy, a, alpha=1.0, slope_src=None, row_scale=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (``dy_eff.T @ a``, ``dy_eff.sum(0)``)."""
    g = dy_effective(dy, alpha, slope_src, row_scale)
    return g.t() @ a.float(), g.sum(0)


@functools.lru_cache(maxsize=None)
def wgrad_splits(m: int, n: int, k: int, sms: int = _SMS
                 ) -> Tuple[int, int]:
    """(splits S, rows per split) of wgrad's reduction over the M rows:
    about one persistent block per SM over the ceil(N / 128) x ceil(K /
    n_tile(K)) output tiles, each split at least 256 rows and a multiple of
    the 64-row reduction step."""
    tiles = -(-n // _BM) * -(-k // n_tile(k, _MN_WIDTHS))
    s = max(1, min(sms // tiles, m // 256))
    rows = -(-(-(-m // s)) // _BK) * _BK
    return max(1, -(-m // rows)), rows


def needs_prep(dy: torch.Tensor, alpha: float, slope_src, row_scale) -> bool:
    """dY goes through the dY_eff pre-pass unless it is bf16, untouched and
    in 16-byte rows (then the GEMM reads it in place, by TMA)."""
    return dy.dtype != torch.bfloat16 or alpha != 1.0 \
        or slope_src is not None or row_scale is not None \
        or dy.stride(0) % 8 != 0 or dy.data_ptr() % 16 != 0


def wgrad_scratch(m: int, n: int, k: int, splits: int, prep: bool
                  ) -> Tuple[int, int, int, int]:
    """Byte offsets (part, db_part, end) of the scratch of one call and the
    bf16 row pitch of dY_eff (16-byte rows); dY_eff, when ``prep``, starts
    at 0. ``splits`` 0: no wgrad, so no partials. Every region starts
    256-byte aligned."""
    def up(x):
        return -(-x // 256) * 256
    lde = -(-n // 8) * 8
    part = up(m * lde * 2) if prep else 0
    db_part = part + up(splits * n * k * 4)
    return (part, db_part,
            db_part + (-(-m // _PREP_ROWS) * n * 4 if splits else 0), lde)


def check_bwd_layout(name: str, dy: torch.Tensor, k: int,
                     *bf16: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> None:
    """The kernels' layout rules, on tensor metadata only (no card needed):
    dY f32 or bf16 with unit column stride and a 16-byte (f32) or 8-byte
    (bf16) aligned base; the bf16 operands with unit column stride and an
    8-byte aligned base; N, K and every row stride multiples of 4 (4-wide
    loads, 8-byte cp.async rows); ``out`` f32 or bf16 with unit column
    stride, a row stride that is a multiple of 4 and a base aligned to the
    4 elements a lane stores (16 bytes f32, 8 bytes bf16)."""
    if dy.dtype not in (torch.float32, torch.bfloat16) \
            or dy.stride(-1) != 1 or dy.data_ptr() % (4 * dy.element_size()):
        raise ValueError(f"{name}: dy must be f32 or bf16 with unit column "
                         f"stride and an aligned base, got {dy.dtype}")
    for t in bf16:
        if t.stride(-1) != 1 or t.data_ptr() % 8:
            raise ValueError(f"{name}: needs unit column stride and an "
                             "8-byte aligned base pointer")
    if dy.shape[1] % 4 or k % 4 or \
            any(t.stride(0) % 4 for t in (dy,) + bf16):
        raise ValueError(f"{name}: N, K and every row stride must be "
                         "multiples of 4")
    if out is not None and (out.dtype not in (torch.float32, torch.bfloat16)
                            or out.stride(-1) != 1 or out.stride(0) % 4
                            or out.data_ptr() % (4 * out.element_size())):
        raise ValueError(f"{name}: out must be f32 or bf16 with unit column "
                         "stride, a row stride that is a multiple of 4 and "
                         "a 4-element aligned base")


def _check(name: str, dy, slope_src, row_scale, k: int, *bf16, out=None):
    """The device and type rules, then :func:`check_bwd_layout`."""
    if dy.device.type != "cuda" or \
            (out is not None and out.device.type != "cuda"):
        raise ValueError(f"{name}: dy and out must be on CUDA, got "
                         f"{dy.device}")
    operands = bf16 + ((slope_src,) if slope_src is not None else ())
    _build.require_bf16_cuda(name, *operands, layout=False)
    check_bwd_layout(name, dy, k, *operands, out=out)
    if row_scale is not None:
        _build.require_f32_cuda(name, row_scale, contiguous=False)


def _check_shapes(name, dy, slope_src, row_scale):
    m, n = dy.shape
    if slope_src is not None and slope_src.shape != (m, n):
        raise ValueError(f"{name}: slope_src {tuple(slope_src.shape)} vs dy "
                         f"{(m, n)}")
    if row_scale is not None and (row_scale.dim() != 1
                                  or m % row_scale.shape[0]):
        raise ValueError(f"{name}: row_scale must be [B] with B dividing {m}")


def _dgrad_shapes(name, dy, w, out, gelu_pre):
    m, n = dy.shape
    k = w.shape[1]
    if w.shape != (n, k) or out.shape != (m, k) or \
            (gelu_pre is not None and gelu_pre.shape != (m, k)):
        raise ValueError(f"{name}: dy {tuple(dy.shape)}, w {tuple(w.shape)}, "
                         f"out {tuple(out.shape)}")


def _wgrad_shapes(name, dy, a, dw, db):
    m, n = dy.shape
    k = a.shape[1]
    if a.shape[0] != m or dw.shape != (n, k) or db.shape != (n,):
        raise ValueError(f"{name}: dy {tuple(dy.shape)}, a {tuple(a.shape)}, "
                         f"dw {tuple(dw.shape)}, db {tuple(db.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _ld(t: Optional[torch.Tensor]) -> int:
    return t.stride(0) if t is not None else 0


def _launch(name: str, dy, alpha, slope_src, row_scale, w=None, out=None,
            gelu_pre=None, a=None, dw=None, db=None) -> None:
    """The card's route of the three wrappers: dgrad when ``out`` is given,
    wgrad when ``dw`` is, through the one C entry point."""
    m, n = dy.shape
    k = (w if out is not None else a).shape[1]
    _check(name, dy, slope_src, row_scale, k,
           *(t for t in (w, gelu_pre, a) if t is not None), out=out)
    if dw is not None:
        _build.require_f32_cuda(name, dw, db)
    splits, rows = (wgrad_splits(m, n, k, _build.sm_count(dy.device))
                    if dw is not None else (0, 0))
    prep = needs_prep(dy, alpha, slope_src, row_scale)
    global dy_eff_copies
    dy_eff_copies += prep
    part, db_part, size, lde = wgrad_scratch(m, n, k, splits, prep)
    scratch = torch.empty(size, dtype=torch.uint8, device=dy.device)
    base = scratch.data_ptr()
    rc = _build.library().adsr_rdg_gemm_grads(
        dy.data_ptr(), dy.stride(0), int(dy.dtype == torch.float32),
        float(alpha), _ptr(slope_src), _ld(slope_src), _ptr(row_scale),
        row_scale.stride(0) if row_scale is not None else 0,
        m // row_scale.shape[0] if row_scale is not None else 0,
        _ptr(w), _ld(w), _ptr(gelu_pre), _ld(gelu_pre), _ptr(out), _ld(out),
        int(out is not None and out.dtype == torch.float32), _ptr(a), _ld(a),
        base if prep else None, lde, base + part if splits else None,
        base + db_part if splits else None, splits, rows, _ptr(dw), _ptr(db),
        m, n, k, n_tile(k, _MN_WIDTHS), _build.stream_ptr(dy))
    _build.check_rc(name, rc)


def rdg_gemm_dgrad(dy: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                   alpha: float = 1.0,
                   slope_src: Optional[torch.Tensor] = None,
                   row_scale: Optional[torch.Tensor] = None,
                   gelu_pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write ``dy_eff @ w`` (x GELU'(gelu_pre)) into ``out`` [M, K], f32 or
    bf16, any row stride. ``dy`` [M, N], ``w`` [N, K]."""
    _dgrad_shapes("rdg_gemm_dgrad", dy, w, out, gelu_pre)
    _check_shapes("rdg_gemm_dgrad", dy, slope_src, row_scale)
    if dy.device.type == "cpu":
        out.copy_(rdg_gemm_dgrad_plain(dy, w, alpha, slope_src, row_scale,
                                       gelu_pre))
        return out
    _launch("rdg_gemm_dgrad", dy, alpha, slope_src, row_scale, w=w, out=out,
            gelu_pre=gelu_pre)
    rdg_gemm_dgrad.launches += 1
    return out


def rdg_gemm_wgrad(dy: torch.Tensor, a: torch.Tensor, dw: torch.Tensor,
                   db: torch.Tensor, alpha: float = 1.0,
                   slope_src: Optional[torch.Tensor] = None,
                   row_scale: Optional[torch.Tensor] = None) -> None:
    """Write ``dy_eff.T @ a`` into ``dw`` [N, K] and ``dy_eff.sum(0)`` into
    ``db`` [N], both f32 contiguous. ``dy`` [M, N], ``a`` [M, K]."""
    _wgrad_shapes("rdg_gemm_wgrad", dy, a, dw, db)
    _check_shapes("rdg_gemm_wgrad", dy, slope_src, row_scale)
    if dy.device.type == "cpu":
        gw, gb = rdg_gemm_wgrad_plain(dy, a, alpha, slope_src, row_scale)
        dw.copy_(gw)
        db.copy_(gb)
        return
    _launch("rdg_gemm_wgrad", dy, alpha, slope_src, row_scale, a=a, dw=dw,
            db=db)
    rdg_gemm_wgrad.launches += 1


def rdg_gemm_grads(dy: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                   out: torch.Tensor, dw: torch.Tensor, db: torch.Tensor,
                   alpha: float = 1.0,
                   slope_src: Optional[torch.Tensor] = None,
                   row_scale: Optional[torch.Tensor] = None,
                   gelu_pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`rdg_gemm_dgrad` into ``out`` and :func:`rdg_gemm_wgrad` into
    ``dw``, ``db`` of one dY in one call: on the card one dY_eff pre-pass
    feeds both kernels (one launch of each, counted on each wrapper).
    Returns ``out``."""
    _dgrad_shapes("rdg_gemm_grads", dy, w, out, gelu_pre)
    _wgrad_shapes("rdg_gemm_grads", dy, a, dw, db)
    _check_shapes("rdg_gemm_grads", dy, slope_src, row_scale)
    if dy.device.type == "cpu":
        rdg_gemm_wgrad(dy, a, dw, db, alpha, slope_src, row_scale)
        return rdg_gemm_dgrad(dy, w, out, alpha, slope_src, row_scale,
                              gelu_pre)
    _launch("rdg_gemm_grads", dy, alpha, slope_src, row_scale, w=w, out=out,
            gelu_pre=gelu_pre, a=a, dw=dw, db=db)
    rdg_gemm_dgrad.launches += 1
    rdg_gemm_wgrad.launches += 1
    return out


rdg_gemm_dgrad.launches = 0
rdg_gemm_wgrad.launches = 0
# card calls whose dY went through the dY_eff pre-pass into a bf16 copy
# (:func:`needs_prep`), as opposed to being read in place; settable to 0
dy_eff_copies = 0
