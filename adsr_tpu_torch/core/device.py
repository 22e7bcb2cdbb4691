"""Device and dtype selection for the port's entry points.

Entry points default to ``device="cuda"``. A CUDA request on a machine with
no card raises: nothing moves to the CPU unless the caller asks for it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def compute_dtype(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == "bf16" else torch.float32


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """f32 convolutions and matmuls in full f32 inside the block: TF32 off
    for cuDNN and cuBLAS, the previous settings restored on exit (the JAX
    package's f32 is f32, and its bicubic einsums run at HIGHEST)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def deterministic_f32() -> Iterator[None]:
    """:func:`full_f32`, and cuDNN's deterministic algorithms inside the
    block (the previous setting restored on exit): the fused fp32 train
    step, whose kernels sum in a fixed order, so that its whole backward
    repeats bitwise (cuDNN's f32 filter gradients may otherwise sum with
    atomics)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with full_f32():
            yield
    finally:
        torch.backends.cudnn.deterministic = saved
