"""Device and dtype selection for the port's entry points.

Entry points default to ``device="cuda"``. A CUDA request on a machine with
no card raises: nothing moves to the CPU unless the caller asks for it.
"""

from __future__ import annotations

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
