"""Serving forward bound to fixed params (the serving part of
``adsr_tpu/train/trainer.py``; training waits for a later slice).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from adsr_tpu_torch.core.config import DRCTModelConfig, Experiment
from adsr_tpu_torch.core.device import compute_dtype, resolve_device
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.metrics import quantize


def check_serving_precision(exp: Experiment, device: torch.device) -> None:
    """The CUDA kernels are bf16; fp32 runs only on the CPU plain path."""
    if not isinstance(exp.model, DRCTModelConfig):
        raise NotImplementedError(
            f"the port serves DRCT only so far, not {type(exp.model).__name__}")
    if device.type == "cuda" and exp.precision != "bf16":
        raise NotImplementedError(
            f"precision {exp.precision!r} on CUDA: the kernels are bf16 only; "
            "fp32 kernels are ROADMAP.md Queue 4 item 1, 'fp32 serving "
            "kernels' (on the CPU, fp32 runs the plain path)")


def make_serving_forward(exp: Experiment,
                         params: Mapping[str, torch.Tensor],
                         device="cuda", quantize_out: bool = True
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fixed-params inference: LR batch NHWC float -> SR batch (quantized to
    the 0-255 grid unless ``quantize_out=False``).

    ``params`` is the port's state_dict. Packing (weights in the working type,
    the bias gather, the shift masks) runs ONCE here, as the JAX version's
    ``prepack_drct`` does (adsr_tpu/train/trainer.py:400-457)."""
    dev = resolve_device(device)
    check_serving_precision(exp, dev)
    img = exp.model.img_size
    packed = prepack_drct(params, exp.model, img, img,
                          dtype=compute_dtype(exp.precision), device=dev)

    @torch.no_grad()
    def forward(lr) -> torch.Tensor:
        sr = fused_drct_apply(packed, exp.model, torch.as_tensor(lr, device=dev))
        return quantize(sr, exp.data.rgb_range) if quantize_out else sr

    return forward
