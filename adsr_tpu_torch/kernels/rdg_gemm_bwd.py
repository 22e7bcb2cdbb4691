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

f32 operands (fp32 training: the TPU kernel at dtype f32, whose staging is
f32 with f32 accumulators) go to a kernel of their own,
``adsr_tpu_torch/csrc/rdg_gemm_bwd_f32.cu`` (C entry
``adsr_rdg_gemm_grads_f32``): the same function with every product
f32-accurate as 3xTF32 on the tensor cores (``mma.sync`` m16n8k8; each
value split into hi = x with its low 13 bits cleared and lo = x - hi,
three products a pair; dY_eff kept f32). Bound on the H100: operations (one flagship RDG's
50 products are ~145 GFLOP, ~0.88 ms as three TF32 products at 495
TFLOP/s). Design: a pre-pass writes dY_eff where dY is transformed and
the db partials where wgrad runs; then one GEMM reads dY_eff, W and the
activation as they lie, dY_eff K-major for dgrad and every other operand
reduction-major (TF32 ``wgmma`` takes only K-major operands from shared
memory, ``mma.sync``'s fragments load from either layout, so nothing is
transposed), 64 x 64 (dgrad) and 128 x 64 (wgrad) output tiles of four
warps, a 3-stage ``cp.async`` ring of 32-row steps, sums in two levels
(every 128 of the reduction into an f32 total), wgrad in splits of M
added in a fixed order (:func:`gemm_bwd_f32_plan`). Its launches count in
``launches_f32`` on ``rdg_gemm_dgrad`` and ``rdg_gemm_wgrad``, the bf16 ones
in ``launches``.

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
_PREP_ROWS = 32              # rows of one db partial (both pre-passes; the
                             # f32 one's blocks take 32 x 32 of dY)
_SMS = 132                   # the H100's SMs
_MN_WIDTHS = (192, 128, 64)  # tile widths of an MN-major B (whole atoms)
# the f32 kernel (csrc/rdg_gemm_bwd_f32.cu): dgrad's and wgrad's output
# tiles (two and four m16 tiles a warp), threads, the reduction rows a
# stage, blocks an SM of dgrad and of wgrad (their __launch_bounds__: the
# two-level sums take registers), dynamic shared memory of each (a 3-stage
# ring: dgrad's K-major [64][32 + 4] and [32][64 + 8] tiles, wgrad's
# [32][128 + 8] and [32][64 + 8])
F32_DGRAD_TILE = (64, 64)
F32_WGRAD_TILE = (128, 64)
F32_THREADS = 128
F32_BK = 32
F32_DGRAD_BLOCKS_PER_SM = 4
F32_WGRAD_BLOCKS_PER_SM = 2
F32_SMEM_BYTES = (3 * (64 * (F32_BK + 4) + F32_BK * (64 + 8)) * 4,
                  3 * F32_BK * (128 + 8 + 64 + 8) * 4)


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


def check_bwd_f32_layout(name: str, dy: torch.Tensor, k: int,
                         *f32: torch.Tensor,
                         out: Optional[torch.Tensor] = None) -> None:
    """The f32 kernel's layout rules, on tensor metadata only (no card
    needed): dY, every operand (W, A, the GELU and LeakyReLU sources) and
    ``out``, all f32, with unit column stride, a row stride that is a
    multiple of 4 and a 16-byte aligned base (16-byte loads and stores);
    N and K multiples of 4."""
    for t in (dy,) + f32 + ((out,) if out is not None else ()):
        if t.dtype != torch.float32 or t.stride(-1) != 1 \
                or t.stride(0) % 4 or t.data_ptr() % 16:
            raise ValueError(f"{name}: the f32 kernel needs f32 tensors with "
                             "unit column stride, a row stride that is a "
                             "multiple of 4 and a 16-byte aligned base, got "
                             f"{t.dtype} strides {tuple(t.stride())}")
    if dy.shape[1] % 4 or k % 4:
        raise ValueError(f"{name}: N and K must be multiples of 4")


def _check(name: str, dy, slope_src, row_scale, k: int, *operands,
           out=None) -> bool:
    """The device and type rules, then the layout of the route the
    operands' dtype picks; True for the f32 kernel."""
    if dy.device.type != "cuda" or \
            (out is not None and out.device.type != "cuda"):
        raise ValueError(f"{name}: dy and out must be on CUDA, got "
                         f"{dy.device}")
    operands = operands + ((slope_src,) if slope_src is not None else ())
    f32 = _build.require_cuda(name, _build.BF16_F32, *operands,
                              layout=False) == torch.float32
    if f32:
        check_bwd_f32_layout(name, dy, k, *operands, out=out)
    else:
        check_bwd_layout(name, dy, k, *operands, out=out)
    if row_scale is not None:
        _build.require_f32_cuda(name, row_scale, contiguous=False)
    return f32


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


@functools.lru_cache(maxsize=None)
def gemm_bwd_f32_plan(m: int, n: int, k: int, sms: int = _SMS,
                      dgrad: bool = True, wgrad: bool = True,
                      prep: bool = True) -> dict:
    """What the f32 kernel (``csrc/rdg_gemm_bwd_f32.cu``) launches for dY
    [m, n] and W [n, k]: the pre-pass, a block per 32 x 32 tile of dY
    (``prep_grid``), where dY is transformed (``prep``: it writes dY_eff)
    or wgrad runs (it sums the db partials), else none; dgrad, a block of
    ``F32_THREADS`` a 64 x 64 tile of dA [m, k] (``dgrad_grid``); wgrad,
    a block a 128 x 64 tile of dW [n, k] and a split of the m rows
    (``wgrad_grid``: about ``F32_WGRAD_BLOCKS_PER_SM`` blocks an SM over
    the output tiles, each split at least 256 rows and a multiple of the
    32-row step). Its scratch, in byte offsets (each region 256-byte
    aligned): dY_eff [m, n] f32 when ``prep`` from 0, the split partials
    [splits, n, k] at ``part`` and the db partials [ceil(m / 32), n] at
    ``db_part`` when ``wgrad``; ``bytes`` in all; ``min_blocks`` the blocks
    an SM dgrad and wgrad ask of the registers, ``smem_bytes`` their
    shared memory. Read only (cached)."""
    def up(x):
        return -(-x // 256) * 256
    dm, _ = F32_DGRAD_TILE
    bm, bn = F32_WGRAD_TILE
    tiles = -(-n // bm) * -(-k // bn)
    s = max(1, min(sms * F32_WGRAD_BLOCKS_PER_SM // tiles, m // 256))
    rows = -(-(-(-m // s)) // F32_BK) * F32_BK if m else F32_BK
    splits = max(1, -(-m // rows)) if wgrad else 0
    part = up(m * n * 4) if prep else 0
    db_part = part + (up(splits * n * k * 4) if wgrad else 0)
    end = db_part + (-(-m // _PREP_ROWS) * n * 4 if wgrad else 0)
    return {"dgrad_tile": F32_DGRAD_TILE, "wgrad_tile": F32_WGRAD_TILE,
            "threads": F32_THREADS, "smem_bytes": F32_SMEM_BYTES,
            "min_blocks": (F32_DGRAD_BLOCKS_PER_SM, F32_WGRAD_BLOCKS_PER_SM),
            "prep_grid": (-(-n // _PREP_ROWS), -(-m // _PREP_ROWS))
            if prep or wgrad else None,
            "dgrad_grid": (-(-k // bn), -(-m // dm), 1) if dgrad else None,
            "wgrad_grid": (-(-k // bn), -(-n // bm), splits) if wgrad
            else None,
            "splits": splits, "rows_per_split": rows if wgrad else 0,
            "part": part, "db_part": db_part, "bytes": end,
            "flops": 2 * m * n * k * (int(dgrad) + int(wgrad))}


def _launch(name: str, dy, alpha, slope_src, row_scale, w=None, out=None,
            gelu_pre=None, a=None, dw=None, db=None) -> bool:
    """The card's route of the three wrappers: dgrad when ``out`` is given,
    wgrad when ``dw`` is, through the one C entry point of the operands'
    dtype. True for the f32 kernel."""
    m, n = dy.shape
    k = (w if out is not None else a).shape[1]
    f32 = _check(name, dy, slope_src, row_scale, k,
                 *(t for t in (w, gelu_pre, a) if t is not None), out=out)
    if dw is not None:
        _build.require_f32_cuda(name, dw, db)
    if f32:
        _launch_f32(name, dy, alpha, slope_src, row_scale, w, out, gelu_pre,
                    a, dw, db)
        return True
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
    return False


def _launch_f32(name, dy, alpha, slope_src, row_scale, w, out, gelu_pre, a,
                dw, db) -> None:
    """The f32 kernel's launch (``adsr_rdg_gemm_grads_f32``)."""
    m, n = dy.shape
    k = (w if out is not None else a).shape[1]
    prep = alpha != 1.0 or slope_src is not None or row_scale is not None
    plan = gemm_bwd_f32_plan(m, n, k, _build.sm_count(dy.device),
                             out is not None, dw is not None, prep)
    scratch = torch.empty(plan["bytes"], dtype=torch.uint8, device=dy.device)
    base = scratch.data_ptr()
    wgrad = dw is not None
    rc = _build.library().adsr_rdg_gemm_grads_f32(
        dy.data_ptr(), dy.stride(0), float(alpha), _ptr(slope_src),
        _ld(slope_src), _ptr(row_scale),
        row_scale.stride(0) if row_scale is not None else 0,
        m // row_scale.shape[0] if row_scale is not None else 0,
        _ptr(w), _ld(w), _ptr(gelu_pre), _ld(gelu_pre), _ptr(out), _ld(out),
        _ptr(a), _ld(a), base if prep else None, n,
        base + plan["part"] if wgrad else None,
        base + plan["db_part"] if wgrad else None, plan["splits"],
        plan["rows_per_split"], _ptr(dw), _ptr(db), m, n, k,
        _build.stream_ptr(dy))
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
    f32 = _launch("rdg_gemm_dgrad", dy, alpha, slope_src, row_scale, w=w,
                  out=out, gelu_pre=gelu_pre)
    _count(rdg_gemm_dgrad, f32)
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
    f32 = _launch("rdg_gemm_wgrad", dy, alpha, slope_src, row_scale, a=a,
                  dw=dw, db=db)
    _count(rdg_gemm_wgrad, f32)


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
    f32 = _launch("rdg_gemm_grads", dy, alpha, slope_src, row_scale, w=w,
                  out=out, gelu_pre=gelu_pre, a=a, dw=dw, db=db)
    _count(rdg_gemm_dgrad, f32)
    _count(rdg_gemm_wgrad, f32)
    return out


def _count(wrapper, f32: bool) -> None:
    if f32:
        wrapper.launches_f32 += 1
    else:
        wrapper.launches += 1


rdg_gemm_dgrad.launches = rdg_gemm_dgrad.launches_f32 = 0
rdg_gemm_wgrad.launches = rdg_gemm_wgrad.launches_f32 = 0
# bf16 card calls whose dY went through the dY_eff pre-pass into a bf16
# copy (:func:`needs_prep`), as opposed to being read in place; settable to
# 0 (the f32 kernel's calls are not counted: its pre-pass always runs)
dy_eff_copies = 0
