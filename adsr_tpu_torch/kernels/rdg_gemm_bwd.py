"""Kernel (d) ``rdg_gemm_bwd``: the backward of ``rdg_gemm``'s products.

Two entry points, for ``out = a @ w.T + b`` with ``w`` [N, K]:

- ``rdg_gemm_dgrad``: ``da = dy_eff @ w`` [M, K] (times GELU'(pre) for
  fc1), written f32 or bf16 at any row stride;
- ``rdg_gemm_wgrad``: ``dw = dy_eff.T @ a`` [N, K] and ``db = dy_eff.sum(0)``
  in f32, reduced over the M = B*L token rows in S splits plus a second,
  deterministic pass (no atomics).

``dy_eff = alpha * dy * leaky'(slope_src) * m[row // L]``: the adjust
convs' LeakyReLU(0.2) derivative is read from the sign of the saved concat
columns (``slope_src``, the activation keeps the sign), adjust 5 carries its
0.2, and proj / fc2 their per-sample stochastic-depth multiplier
(``row_scale`` [B]). ``dy`` may be f32 or bf16, a column slice of a wider
buffer.

Replaces the dW / dx matmuls of the Pallas backward kernel ``_bwd_kernel``
(``adsr_tpu/ops/fused_rdg_train.py:405-770``, called from
``_rdg_train_bwd`` ``:968``). Source: ``adsr_tpu_torch/csrc/rdg_gemm_bwd.cu``.
Bound on the H100: bytes for the adjust products and the f32 dY reads, near
the bf16 ridge for the large ones. Design: WMMA bf16 tiles with f32
accumulation, the dY transform applied while loading (see the source).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
the call raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.rdg_gemm import per_row

_TILE = 64


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


def wgrad_splits(m: int, n: int, k: int) -> Tuple[int, int]:
    """(splits S, rows per split): about two blocks per SM of the card's
    132 over the ceil(N/64) x ceil(K/64) output tiles, at least 256 rows a
    split, a multiple of the kernel's 32-row step."""
    tiles = -(-n // _TILE) * -(-k // _TILE)
    s = max(1, min(-(-264 // tiles), -(-m // 256)))
    per_split = -(-m // s)
    rows = -(-per_split // 32) * 32
    return -(-m // rows), rows


def _check(name: str, dy, slope_src, row_scale, k: int, *bf16):
    """The kernel's layout rules: dY f32 or bf16 with unit column stride, a
    16-byte (f32) or 8-byte (bf16) aligned base, and N, K and every row
    stride multiples of 4 (its 4-wide loads)."""
    if dy.device.type != "cuda" or dy.dtype not in (torch.float32,
                                                    torch.bfloat16) \
            or dy.stride(-1) != 1 or dy.data_ptr() % (4 * dy.element_size()):
        raise ValueError(f"{name}: dy must be f32 or bf16 on CUDA with unit "
                         f"column stride and an aligned base, got {dy.dtype} "
                         f"on {dy.device}")
    operands = bf16 + ((slope_src,) if slope_src is not None else ())
    _build.require_bf16_cuda(name, *operands)
    if dy.shape[1] % 4 or k % 4 or \
            any(t.stride(0) % 4 for t in (dy,) + operands):
        raise ValueError(f"{name}: N, K and every row stride must be "
                         "multiples of 4")
    if row_scale is not None:
        _build.require_f32_cuda(name, row_scale, contiguous=False)


def _dy_args(dy, alpha, slope_src, row_scale):
    m = dy.shape[0]
    return (dy.data_ptr(), dy.stride(0), int(dy.dtype == torch.float32),
            float(alpha),
            slope_src.data_ptr() if slope_src is not None else None,
            slope_src.stride(0) if slope_src is not None else 0,
            row_scale.data_ptr() if row_scale is not None else None,
            row_scale.stride(0) if row_scale is not None else 0,
            m // row_scale.shape[0] if row_scale is not None else 0)


def _check_shapes(name, dy, slope_src, row_scale):
    m, n = dy.shape
    if slope_src is not None and slope_src.shape != (m, n):
        raise ValueError(f"{name}: slope_src {tuple(slope_src.shape)} vs dy "
                         f"{(m, n)}")
    if row_scale is not None and (row_scale.dim() != 1
                                  or m % row_scale.shape[0]):
        raise ValueError(f"{name}: row_scale must be [B] with B dividing {m}")


def rdg_gemm_dgrad(dy: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                   alpha: float = 1.0,
                   slope_src: Optional[torch.Tensor] = None,
                   row_scale: Optional[torch.Tensor] = None,
                   gelu_pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write ``dy_eff @ w`` (x GELU'(gelu_pre)) into ``out`` [M, K], f32 or
    bf16, any row stride. ``dy`` [M, N], ``w`` [N, K]."""
    m, n = dy.shape
    k = w.shape[1]
    if w.shape != (n, k) or out.shape != (m, k) or \
            (gelu_pre is not None and gelu_pre.shape != (m, k)):
        raise ValueError(f"rdg_gemm_dgrad: dy {tuple(dy.shape)}, w "
                         f"{tuple(w.shape)}, out {tuple(out.shape)}")
    _check_shapes("rdg_gemm_dgrad", dy, slope_src, row_scale)
    if dy.device.type == "cpu":
        out.copy_(rdg_gemm_dgrad_plain(dy, w, alpha, slope_src, row_scale,
                                       gelu_pre))
        return out
    _check("rdg_gemm_dgrad", dy, slope_src, row_scale, k, w,
           *((gelu_pre,) if gelu_pre is not None else ()))
    if not w.is_contiguous() or out.stride(-1) != 1 or \
            out.dtype not in (torch.float32, torch.bfloat16) or \
            out.device.type != "cuda":
        raise ValueError("rdg_gemm_dgrad: needs a contiguous w and an f32 or "
                         "bf16 CUDA out with unit column stride")
    rc = _build.library().adsr_rdg_gemm_dgrad(
        *_dy_args(dy, alpha, slope_src, row_scale), w.data_ptr(),
        gelu_pre.data_ptr() if gelu_pre is not None else None,
        gelu_pre.stride(0) if gelu_pre is not None else 0,
        out.data_ptr(), out.stride(0), int(out.dtype == torch.float32),
        m, n, k, _build.stream_ptr(dy))
    _build.check_rc("rdg_gemm_dgrad", rc)
    rdg_gemm_dgrad.launches += 1
    return out


def rdg_gemm_wgrad(dy: torch.Tensor, a: torch.Tensor, dw: torch.Tensor,
                   db: torch.Tensor, alpha: float = 1.0,
                   slope_src: Optional[torch.Tensor] = None,
                   row_scale: Optional[torch.Tensor] = None) -> None:
    """Write ``dy_eff.T @ a`` into ``dw`` [N, K] and ``dy_eff.sum(0)`` into
    ``db`` [N], both f32 contiguous. ``dy`` [M, N], ``a`` [M, K]."""
    m, n = dy.shape
    k = a.shape[1]
    if a.shape[0] != m or dw.shape != (n, k) or db.shape != (n,):
        raise ValueError(f"rdg_gemm_wgrad: dy {tuple(dy.shape)}, a "
                         f"{tuple(a.shape)}, dw {tuple(dw.shape)}, db "
                         f"{tuple(db.shape)}")
    _check_shapes("rdg_gemm_wgrad", dy, slope_src, row_scale)
    if dy.device.type == "cpu":
        gw, gb = rdg_gemm_wgrad_plain(dy, a, alpha, slope_src, row_scale)
        dw.copy_(gw)
        db.copy_(gb)
        return
    _check("rdg_gemm_wgrad", dy, slope_src, row_scale, k, a)
    _build.require_f32_cuda("rdg_gemm_wgrad", dw, db)
    splits, rows = wgrad_splits(m, n, k)
    part = torch.empty(splits * (n * k + n), dtype=torch.float32,
                       device=dy.device)
    rc = _build.library().adsr_rdg_gemm_wgrad(
        *_dy_args(dy, alpha, slope_src, row_scale), a.data_ptr(),
        a.stride(0), part.data_ptr(), splits, rows, dw.data_ptr(),
        db.data_ptr(), m, n, k, _build.stream_ptr(dy))
    _build.check_rc("rdg_gemm_wgrad", rc)
    rdg_gemm_wgrad.launches += 1


rdg_gemm_dgrad.launches = 0
rdg_gemm_wgrad.launches = 0
