"""Kernel (a) ``rdg_layernorm``: LayerNorm over a prefix of the concat buffer.

Replaces the LayerNorm phases of the Pallas kernel ``_rdg_kernel_impl``
(``adsr_tpu/ops/fused_rdg.py:708-714, 860``). Source:
``adsr_tpu_torch/csrc/rdg_layernorm.cu``. Bound on the H100: bytes (one bf16
read and one bf16 write per element). Design: one warp per row, the row in
registers, two-pass f32 statistics, reading the concat prefix in place at its
row stride (see the source for details).

``rdg_layernorm`` dispatches by device: a CPU tensor goes to
``rdg_layernorm_plain``, a CUDA tensor to the kernel (or the call raises).
"""

from __future__ import annotations

import torch

from adsr_tpu_torch.kernels import _build

EPS = 1e-6


def rdg_layernorm_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """[M, c] (any row stride) -> f32 LayerNorm over the last axis."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()


def rdg_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  out: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """LayerNorm of ``x`` [M, c] (row stride >= c) into ``out`` [M, c]."""
    m, c = x.shape
    if out.shape != (m, c) or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"rdg_layernorm: shapes x {tuple(x.shape)}, "
                         f"out {tuple(out.shape)}, weight {tuple(weight.shape)}")
    if x.device.type == "cpu":
        out.copy_(rdg_layernorm_plain(x, weight, bias, eps))
        return out
    _build.require_bf16_cuda("rdg_layernorm", x, out)
    _build.require_f32_cuda("rdg_layernorm", weight, bias)
    rc = _build.library().adsr_rdg_layernorm(
        x.data_ptr(), x.stride(0), weight.data_ptr(), bias.data_ptr(),
        out.data_ptr(), out.stride(0), m, c, eps, _build.stream_ptr(x))
    _build.check_rc("rdg_layernorm", rc)
    rdg_layernorm.launches += 1
    return out


rdg_layernorm.launches = 0
