"""Shared model pieces: dataset mean and seeded initialisers.

The JAX package's NHWC ``pixel_shuffle`` (models/common.py:51) has torch's
channel order (c, i, j), which ``F.pixel_shuffle`` / ``nn.PixelShuffle`` on
NCHW already have, so the port uses those directly.

The initialisers reproduce the JAX package's distributions with a
``torch.Generator`` (the bits differ from ``jax.random``; tests carry weights
across with ``io/convert.py`` instead of re-initialising).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# Dataset channel statistics used by MeanShift (reference src/drn.py:176-185).
RGB_MEAN = (0.4488, 0.4371, 0.4040)


def torch_conv_init(weight: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-b, b) with b = 1/sqrt(fan_in): torch's Conv2d default, which the JAX
    package writes as variance_scaling(1/3, fan_in, uniform)."""
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return weight.uniform_(-bound, bound, generator=generator)


def trunc_normal_init(weight: torch.Tensor, std: float = 0.02,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """timm-style truncated normal in [-2, 2] std units."""
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(weight, std=std, a=-2.0 * std,
                                           b=2.0 * std, generator=generator)
