"""Kernel (e) ``rdg_layernorm_bwd``: LayerNorm backward over a prefix of the
concat buffer.

``dx += inv * (dy^ - mean(dy^) - x^ * mean(dy^ * x^))`` with ``dy^ = gamma *
dy`` and the f32 statistics recomputed from ``x`` as the forward computes
them (eps 1e-6); ``dgamma = sum(dy * x^)`` and ``dbeta = sum(dy)`` over the
rows, in a deterministic two-pass reduction. An optional second gradient
``residual`` is added into ``dx`` in the same pass.

Replaces the LayerNorm backward phases of the Pallas kernel ``_bwd_kernel``
(``adsr_tpu/ops/fused_rdg_train.py:405-770``); the TPU kernel folds the LN
affine into the next matmul and needs no dgamma / dbeta, the port keeps the
affine unfolded and emits them. Source:
``adsr_tpu_torch/csrc/rdg_layernorm_bwd.cu``. Bound on the H100: bytes.
Design: one warp per row, the row in registers; dx is accumulated in place
into a strided f32 buffer (a column prefix of the concat gradient).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
the call raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.rdg_layernorm import EPS

_ROWS_PER_BLOCK = 64


def rdg_layernorm_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                            weight: torch.Tensor, eps: float = EPS
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """f32 (dx, dweight, dbias) of ``layer_norm(x) * weight + bias``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mu) * inv
    g = dy.float()
    gh = g * weight.float()
    dx = inv * (gh - gh.mean(-1, keepdim=True)
                - xhat * (gh * xhat).mean(-1, keepdim=True))
    return dx, (g * xhat).sum(0), g.sum(0)


def rdg_layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                      dx: torch.Tensor, dweight: torch.Tensor,
                      dbias: torch.Tensor,
                      residual: Optional[torch.Tensor] = None,
                      eps: float = EPS) -> None:
    """``dx`` [M, c] (f32, any row stride) += the input gradient (+
    ``residual`` [M, c] f32); ``dweight``, ``dbias`` [c] f32 are written.
    ``x`` [M, c] is the forward's input (bf16 on CUDA, any row stride),
    ``dy`` [M, c] f32 the output's gradient."""
    m, c = x.shape
    if dy.shape != (m, c) or dx.shape != (m, c) or weight.shape != (c,) \
            or dweight.shape != (c,) or dbias.shape != (c,) or \
            (residual is not None and residual.shape != (m, c)):
        raise ValueError(f"rdg_layernorm_bwd: shapes x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, dx {tuple(dx.shape)}")
    if x.device.type == "cpu":
        gx, gw, gb = rdg_layernorm_bwd_plain(x, dy, weight, eps)
        dx.add_(gx if residual is None else gx + residual)
        dweight.copy_(gw)
        dbias.copy_(gb)
        return
    _build.require_bf16_cuda("rdg_layernorm_bwd", x)
    _build.require_f32_cuda("rdg_layernorm_bwd", weight, dweight, dbias)
    strided = (dy, dx) + ((residual,) if residual is not None else ())
    _build.require_f32_cuda("rdg_layernorm_bwd", *strided, contiguous=False)
    if any(t.stride(-1) != 1 for t in strided):
        raise ValueError("rdg_layernorm_bwd: dy, dx and residual need unit "
                         "column stride")
    part = torch.empty(-(-m // _ROWS_PER_BLOCK) * 2 * c, dtype=torch.float32,
                       device=x.device)
    rc = _build.library().adsr_rdg_layernorm_bwd(
        x.data_ptr(), x.stride(0), dy.data_ptr(), dy.stride(0),
        weight.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        residual.stride(0) if residual is not None else 0,
        dx.data_ptr(), dx.stride(0), part.data_ptr(), dweight.data_ptr(),
        dbias.data_ptr(), m, c, eps, _build.stream_ptr(x))
    _build.check_rc("rdg_layernorm_bwd", rc)
    rdg_layernorm_bwd.launches += 1


rdg_layernorm_bwd.launches = 0
