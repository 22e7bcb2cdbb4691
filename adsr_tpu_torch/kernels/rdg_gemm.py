"""Kernel (b) ``rdg_gemm``: ``epilogue(A @ W^T + bias)`` for the RDG's matmuls.

Replaces the five matmuls of each Swin block inside the Pallas kernel
``_rdg_kernel_impl`` (``adsr_tpu/ops/fused_rdg.py:731, 858, 861, 887-892``):
qkv, proj, fc1, fc2 and the 1x1 adjust conv. Source:
``adsr_tpu_torch/csrc/rdg_gemm.cu``. Bound on the H100: the large products sit
near the bf16 ridge (K <= 308), the N = 32 adjust products are bound by the
bytes of A. Design: WMMA bf16 tiles with f32 accumulation; the epilogue writes
at any row stride, so adjust 1-4 land straight in their concat columns and
adjust 5 lands in place over the RDG input (see the source).

Epilogues (the TPU kernel's, unfolded): ``none`` (qkv), ``residual`` (proj,
fc2), ``gelu`` (fc1, exact erf), ``leaky_relu`` (adjust 1-4, slope 0.2) and
``scaled_residual`` (adjust 5: ``0.2 * acc + x_in``, fused_rdg.py:934-938).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from adsr_tpu_torch.kernels import _build

EPILOGUES = {"none": 0, "residual": 1, "gelu": 2, "leaky_relu": 3,
             "scaled_residual": 4}
_NEEDS_RESIDUAL = ("residual", "scaled_residual")


def rdg_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   epilogue: str = "none",
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 ``epilogue(a @ w.T + bias)``; ``w`` is [N, K] (torch Linear)."""
    y = a.float() @ w.float().t() + bias.float()
    if epilogue == "residual":
        return y + residual.float()
    if epilogue == "gelu":
        return F.gelu(y)
    if epilogue == "leaky_relu":
        return F.leaky_relu(y, 0.2)
    if epilogue == "scaled_residual":
        return 0.2 * y + residual.float()
    return y


def rdg_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             out: torch.Tensor, epilogue: str = "none",
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write ``epilogue(a @ w.T + bias)`` into ``out`` [M, N].

    ``a`` [M, K], ``out`` and ``residual`` [M, N] may be column slices of a
    wider buffer (unit column stride); ``out`` may alias ``residual``."""
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
    if a.device.type == "cpu":
        out.copy_(rdg_gemm_plain(a, w, bias, epilogue, residual))
        return out
    tensors = (a, w, out) + ((residual,) if needs_res else ())
    _build.require_bf16_cuda("rdg_gemm", *tensors)
    _build.require_f32_cuda("rdg_gemm", bias)
    if not w.is_contiguous() or k % 4 or a.stride(0) % 4:
        raise ValueError("rdg_gemm: needs a contiguous W, K % 4 == 0 and a "
                         "row stride of A that is a multiple of 4")
    rc = _build.library().adsr_rdg_gemm(
        a.data_ptr(), a.stride(0), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), out.stride(0),
        residual.data_ptr() if needs_res else None,
        residual.stride(0) if needs_res else 0,
        m, n, k, EPILOGUES[epilogue], _build.stream_ptr(a))
    _build.check_rc("rdg_gemm", rc)
    rdg_gemm.launches += 1
    return out


rdg_gemm.launches = 0
