"""Kernel (b) ``rdg_gemm``: ``epilogue(A @ W^T + bias)`` for the RDG's matmuls.

Replaces the five matmuls of each Swin block inside the Pallas kernels
``_rdg_kernel_impl`` (``adsr_tpu/ops/fused_rdg.py:731, 858, 861, 887-892``)
and ``_fwd_kernel`` (``adsr_tpu/ops/fused_rdg_train.py:266``): qkv, proj,
fc1, fc2 and the 1x1 adjust conv. Source: ``adsr_tpu_torch/csrc/rdg_gemm.cu``
on the mainloop of ``csrc/hopper_gemm.cuh``. Bound on the H100: bytes (one
RDG's 25 products at 16384 token rows move ~0.58 GB, 0.17 ms at 3.35 TB/s,
against 0.07 ms of bf16 tensor-core work). Design: persistent blocks over
128 x ``n_tile(N)`` output tiles, operands by TMA (16-byte rows: the port
keeps its GEMM operands in buffers from :func:`pitched`; other rows fall back
to 8-byte cp.async) into an mbarrier ring, two consumer warpgroups on
wgmma; the epilogue runs from the accumulator registers and writes 4 bf16 a
lane at any row stride that is a multiple of 4, so adjust 1-4 land straight
in their concat columns and adjust 5 lands in place over the RDG input (see
the source).

Epilogues (the TPU kernels', unfolded): ``none`` (qkv), ``residual`` (proj,
fc2), ``gelu`` (fc1, exact erf), ``leaky_relu`` (adjust 1-4, slope 0.2),
``scaled_residual`` (adjust 5: ``0.2 * acc + x_in``, fused_rdg.py:934-938),
and for training ``drop_residual`` (proj, fc2: ``residual + m[row // L] *
acc``, the per-sample stochastic-depth multiplier, fused_rdg_train.py:295-296,
367, 372) and ``gelu_aux`` (fc1 in the backward's recompute: ``gelu(acc)``
into ``out`` and the pre-activation ``acc`` into ``aux``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from adsr_tpu_torch.kernels import _build

EPILOGUES = {"none": 0, "residual": 1, "gelu": 2, "leaky_relu": 3,
             "scaled_residual": 4, "drop_residual": 5, "gelu_aux": 6}
_NEEDS_RESIDUAL = ("residual", "scaled_residual", "drop_residual")
# a tile's fixed cost (A re-read, its epilogue's row setup) in output columns
_TILE_COST = 32


@functools.lru_cache(maxsize=None)
def n_tile(n: int, widths: tuple = (192, 128, 64, 32)) -> int:
    """The output tile width for ``n`` columns: the least padded work,
    ceil(n / w) tiles of ``w + _TILE_COST`` columns each, the wider tile on a
    tie (the N = 32 adjust products take 32, N = 180..308 take 192)."""
    return min(widths, key=lambda w: (-(-n // w) * (w + _TILE_COST), -w))


def check_gemm_layout(name: str, k: int, a: torch.Tensor, w: torch.Tensor,
                      *outs: torch.Tensor) -> None:
    """The kernel's layout rules, on tensor metadata only (no card needed):
    K and the row strides of A and W multiples of 4 (8-byte cp.async rows),
    and ``outs`` (out, residual, aux) with N and their row strides
    multiples of 4 (the epilogue moves 4 bf16 a lane); every operand with
    unit column stride and an 8-byte aligned base. W may be a column
    prefix of a wider buffer (its row stride a multiple of 4)."""
    for t in (a, w) + outs:
        if t.stride(-1) != 1 or t.data_ptr() % 8:
            raise ValueError(f"{name}: needs unit column stride and an 8-byte "
                             "aligned base pointer")
    if k % 4 or a.stride(0) % 4 or w.stride(0) % 4:
        raise ValueError(f"{name}: needs K % 4 == 0 and row strides of A "
                         "and W that are multiples of 4")
    if w.shape[0] % 4 or any(t.stride(0) % 4 for t in outs):
        raise ValueError(f"{name}: needs N and the row strides of out, "
                         "residual and aux to be multiples of 4")


def row_pitch(n: int) -> int:
    """Elements a bf16 row of ``n`` takes in a buffer the kernels read by
    TMA: a multiple of 8 (16-byte rows)."""
    return -(-n // 8) * 8


def pitched(m: int, n: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """An uninitialised [m, n] tensor whose rows start every
    ``row_pitch(n)`` elements (16-byte aligned rows). Not a view: an
    in-place copy into it costs autograd no more than a cast does."""
    return torch.empty_strided((m, n), (row_pitch(n), 1), dtype=dtype,
                               device=device)


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
    _build.require_bf16_cuda("rdg_gemm", *tensors, layout=False)
    _build.require_f32_cuda("rdg_gemm", bias)
    if drop:
        _build.require_f32_cuda("rdg_gemm", row_scale, contiguous=False)
    check_gemm_layout("rdg_gemm", k, a, w, *tensors[2:])
    rc = _build.library().adsr_rdg_gemm(
        a.data_ptr(), a.stride(0), w.data_ptr(), w.stride(0), bias.data_ptr(),
        out.data_ptr(), out.stride(0),
        residual.data_ptr() if needs_res else None,
        residual.stride(0) if needs_res else 0,
        row_scale.data_ptr() if drop else None,
        row_scale.stride(0) if drop else 0,
        m // row_scale.shape[0] if drop else 0,
        aux.data_ptr() if aux is not None else None,
        aux.stride(0) if aux is not None else 0,
        m, n, k, EPILOGUES[epilogue], n_tile(n), _build.stream_ptr(a))
    _build.check_rc("rdg_gemm", rc)
    rdg_gemm.launches += 1
    return out


rdg_gemm.launches = 0
