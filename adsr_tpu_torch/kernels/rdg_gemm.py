"""Kernel (b) ``rdg_gemm``: ``epilogue(A @ W^T + bias)`` for the RDG's matmuls.

Replaces the five matmuls of each Swin block inside the Pallas kernels
``_rdg_kernel_impl`` (``adsr_tpu/ops/fused_rdg.py:731, 858, 861, 887-892``)
and ``_fwd_kernel`` (``adsr_tpu/ops/fused_rdg_train.py:266``): qkv, proj,
fc1, fc2 and the 1x1 adjust conv. Source:
``adsr_tpu_torch/csrc/rdg_gemm.cu``. Bound on the H100: the large products sit
near the bf16 ridge (K <= 308), the N = 32 adjust products are bound by the
bytes of A. Design: WMMA bf16 tiles with f32 accumulation; the epilogue writes
at any row stride, so adjust 1-4 land straight in their concat columns and
adjust 5 lands in place over the RDG input (see the source).

Epilogues (the TPU kernels', unfolded): ``none`` (qkv), ``residual`` (proj,
fc2), ``gelu`` (fc1, exact erf), ``leaky_relu`` (adjust 1-4, slope 0.2),
``scaled_residual`` (adjust 5: ``0.2 * acc + x_in``, fused_rdg.py:934-938),
and for training ``drop_residual`` (proj, fc2: ``residual + m[row // L] *
acc``, the per-sample stochastic-depth multiplier, fused_rdg_train.py:295-296,
367, 372) and ``gelu_aux`` (fc1 in the backward's recompute: ``gelu(acc)``
into ``out`` and the pre-activation ``acc`` into ``aux``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from adsr_tpu_torch.kernels import _build

EPILOGUES = {"none": 0, "residual": 1, "gelu": 2, "leaky_relu": 3,
             "scaled_residual": 4, "drop_residual": 5, "gelu_aux": 6}
_NEEDS_RESIDUAL = ("residual", "scaled_residual", "drop_residual")


def per_row(scale: torch.Tensor, m: int) -> torch.Tensor:
    """[B] per-sample values -> [M, 1] per token row (M = B * L rows)."""
    return scale.float().repeat_interleave(m // scale.shape[0])[:, None]


def rdg_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   epilogue: str = "none",
                   residual: Optional[torch.Tensor] = None,
                   row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 ``epilogue(a @ w.T + bias)``; ``w`` is [N, K] (torch Linear).
    ``gelu_aux`` returns the GELU output (its pre-activation is the
    ``none`` result)."""
    y = a.float() @ w.float().t() + bias.float()
    if epilogue == "residual":
        return y + residual.float()
    if epilogue == "drop_residual":
        return residual.float() + per_row(row_scale, y.shape[0]) * y
    if epilogue in ("gelu", "gelu_aux"):
        return F.gelu(y)
    if epilogue == "leaky_relu":
        return F.leaky_relu(y, 0.2)
    if epilogue == "scaled_residual":
        return 0.2 * y + residual.float()
    return y


def rdg_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             out: torch.Tensor, epilogue: str = "none",
             residual: Optional[torch.Tensor] = None,
             row_scale: Optional[torch.Tensor] = None,
             aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write ``epilogue(a @ w.T + bias)`` into ``out`` [M, N].

    ``a`` [M, K], ``out``, ``residual`` and ``aux`` [M, N] may be column
    slices of a wider buffer (unit column stride); ``out`` may alias
    ``residual``. ``row_scale`` [B] f32 (any stride, B dividing M) is the
    per-sample multiplier of ``drop_residual``; ``aux`` receives the
    pre-activation of ``gelu_aux``."""
    m, k = a.shape
    n = w.shape[0]
    if epilogue not in EPILOGUES:
        raise ValueError(f"rdg_gemm: unknown epilogue {epilogue!r}")
    if w.shape != (n, k) or bias.shape != (n,) or out.shape != (m, n):
        raise ValueError(f"rdg_gemm: shapes a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)}, out "
                         f"{tuple(out.shape)}")
    needs_res = epilogue in _NEEDS_RESIDUAL
    if needs_res != (residual is not None) or \
            (needs_res and residual.shape != (m, n)):
        raise ValueError(f"rdg_gemm: epilogue {epilogue!r} and residual "
                         f"{None if residual is None else tuple(residual.shape)}")
    drop = epilogue == "drop_residual"
    if drop != (row_scale is not None) or \
            (drop and (row_scale.dim() != 1 or m % row_scale.shape[0])):
        raise ValueError(f"rdg_gemm: epilogue {epilogue!r} needs a [B] "
                         f"row_scale with B dividing {m}")
    if (epilogue == "gelu_aux") != (aux is not None) or \
            (aux is not None and aux.shape != (m, n)):
        raise ValueError(f"rdg_gemm: epilogue {epilogue!r} and aux")
    if a.device.type == "cpu":
        if aux is not None:
            aux.copy_(rdg_gemm_plain(a, w, bias))
        out.copy_(rdg_gemm_plain(a, w, bias, epilogue, residual, row_scale))
        return out
    tensors = (a, w, out) + ((residual,) if needs_res else ()) \
        + ((aux,) if aux is not None else ())
    _build.require_bf16_cuda("rdg_gemm", *tensors)
    _build.require_f32_cuda("rdg_gemm", bias)
    if drop:
        _build.require_f32_cuda("rdg_gemm", row_scale, contiguous=False)
    if not w.is_contiguous() or k % 4 or a.stride(0) % 4:
        raise ValueError("rdg_gemm: needs a contiguous W, K % 4 == 0 and a "
                         "row stride of A that is a multiple of 4")
    rc = _build.library().adsr_rdg_gemm(
        a.data_ptr(), a.stride(0), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), out.stride(0),
        residual.data_ptr() if needs_res else None,
        residual.stride(0) if needs_res else 0,
        row_scale.data_ptr() if drop else None,
        row_scale.stride(0) if drop else 0,
        m // row_scale.shape[0] if drop else 0,
        aux.data_ptr() if aux is not None else None,
        aux.stride(0) if aux is not None else 0,
        m, n, k, EPILOGUES[epilogue], _build.stream_ptr(a))
    _build.check_rc("rdg_gemm", rc)
    rdg_gemm.launches += 1
    return out


rdg_gemm.launches = 0
