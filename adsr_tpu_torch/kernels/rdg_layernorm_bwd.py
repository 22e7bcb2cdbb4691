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
Design: a half-warp per row (two rows in flight a warp), x as 8-byte bf16x4
and the f32 tensors as float4 loads, gamma read once a thread, a grid of
:func:`rdg_layernorm_bwd_plan`'s blocks looping over the rows; dx is
accumulated in place into a strided f32 buffer (a column prefix of the
concat gradient); dgamma/dbeta as one fixed-order partial row a block, summed
by a second pass spread over many blocks (:func:`check_ln_bwd_layout` states
the layouts the kernel takes).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
the call raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.rdg_layernorm import EPS

THREADS = 256          # 8 warps, a half-warp per row: 16 rows a step
ROWS_PER_STEP = 16
MAX_C = 320            # five float4 a lane of a half-warp
BLOCKS_PER_SM = 2
_SMS = 132             # the H100's SMs


@functools.lru_cache(maxsize=None)
def rdg_layernorm_bwd_plan(m: int, c: int, sms: int = _SMS) -> dict:
    """What kernel (e) launches for ``m`` rows of width ``c``: blocks of
    ``THREADS`` that loop over steps of ``ROWS_PER_STEP`` rows, as many as
    ``BLOCKS_PER_SM`` a streaming multiprocessor holds (or one per step, if
    fewer), and one dgamma/dbeta partial row [2c] f32 a block. Read only
    (cached)."""
    steps = -(-m // ROWS_PER_STEP)
    blocks = max(1, min(steps, sms * BLOCKS_PER_SM))
    return {"threads": THREADS, "blocks": blocks,
            "steps_per_block": -(-steps // blocks),
            "partial_bytes": blocks * 2 * c * 4}


def check_ln_bwd_layout(name: str, x: torch.Tensor, dy: torch.Tensor,
                        dx: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        weight: Optional[torch.Tensor] = None) -> None:
    """The kernel's layout rules, on tensor metadata only (no card needed):
    c a multiple of 4 up to ``MAX_C``; every tensor with unit column stride
    and a row stride that is a multiple of 4; ``x`` (bf16) with an 8-byte
    aligned base, ``dy``, ``dx``, ``residual`` and ``weight`` (f32) with a
    16-byte aligned base (4-wide loads and stores)."""
    c = x.shape[1]
    if c % 4 or c > MAX_C:
        raise ValueError(f"{name}: the kernel takes widths that are "
                         f"multiples of 4 up to {MAX_C}, got {c}")
    f32 = (dy, dx) + tuple(t for t in (residual, weight) if t is not None)
    for t, align in ((x, 8),) + tuple((t, 16) for t in f32):
        if t.stride(-1) != 1 or (t.dim() > 1 and t.stride(0) % 4) \
                or t.data_ptr() % align:
            raise ValueError(f"{name}: needs unit column stride, a row "
                             "stride that is a multiple of 4 and an aligned "
                             f"base ({align} bytes), got strides "
                             f"{tuple(t.stride())}")


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
    """``dx`` [M, c] (f32) += the input gradient (+ ``residual`` [M, c]
    f32); ``dweight``, ``dbias`` [c] f32 are written. ``x`` [M, c] is the
    forward's input (bf16 on CUDA), ``dy`` [M, c] f32 the output's
    gradient. Any strides on the CPU; on the card the rows of
    :func:`check_ln_bwd_layout`."""
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
    check_ln_bwd_layout("rdg_layernorm_bwd", x, dy, dx, residual, weight)
    _build.require_bf16_cuda("rdg_layernorm_bwd", x)
    _build.require_f32_cuda("rdg_layernorm_bwd", weight, dweight, dbias)
    strided = (dy, dx) + ((residual,) if residual is not None else ())
    _build.require_f32_cuda("rdg_layernorm_bwd", *strided, contiguous=False)
    plan = rdg_layernorm_bwd_plan(m, c, _build.sm_count(x.device))
    part = torch.empty(plan["blocks"] * 2 * c, dtype=torch.float32,
                       device=x.device)
    rc = _build.library().adsr_rdg_layernorm_bwd(
        x.data_ptr(), x.stride(0), dy.data_ptr(), dy.stride(0),
        weight.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        residual.stride(0) if residual is not None else 0,
        dx.data_ptr(), dx.stride(0), part.data_ptr(), dweight.data_ptr(),
        dbias.data_ptr(), m, c, plan["blocks"], eps, _build.stream_ptr(x))
    _build.check_rc("rdg_layernorm_bwd", rc)
    rdg_layernorm_bwd.launches += 1


rdg_layernorm_bwd.launches = 0
