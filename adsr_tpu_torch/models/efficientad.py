"""EfficientAD's patch description networks and autoencoder, eager PyTorch
in f32 (NCHW; the port of ``adsr_tpu/models/efficientad.py``, reference
src/efficientAD.py:32-127).

Both are ``nn.Sequential`` stacks at the reference's indices, so a reference
teacher ``.pth`` loads as it is and the JAX package's ``convert_pdn`` /
``convert_autoencoder`` (``adsr_tpu/io/torch_convert.py:193, 219``) map the
port's ``state_dict`` with no unmapped key: PDN convolutions at 0/3/6/8
(small) and 0/3/6/8/10/12 (medium); autoencoder convolutions at
0/2/4/6/8/10 (encoder), 12/16/20/24/28/32 (decoder, each after a resize),
36 and 38.

The decoder's resizes are bilinear with half-pixel centres
(``align_corners=False``), as ``jax.image.resize(..., "bilinear")``. That
call antialiases a downsample, and so does ``Resize``: the last step
(127 -> 56) runs with ``antialias=True``, the upsamples without (the
reference's ``nn.Upsample`` has none at any step, so its 127 -> 56 differs
from the JAX package's, which the port follows). The ``Dropout(0.2)`` layers keep their
indices; the JAX package runs the autoencoder deterministically in training
and scoring, and the port's trainer keeps it in eval mode.

Weights take :func:`init_efficientad_`: torch's Conv2d default
(``models/common.py`` ``torch_conv_init``) from a ``torch.Generator``, and
zero biases, as flax's default.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from adsr_tpu_torch.models.common import torch_conv_init


class Resize(nn.Module):
    """Bilinear resize to ``size`` x ``size`` (half-pixel centres;
    antialiased where it downsamples, as ``jax.image.resize`` does)."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, size=(self.size, self.size), mode="bilinear",
                             align_corners=False,
                             antialias=self.size < x.shape[-1])


def _pool(pad: int) -> nn.AvgPool2d:
    """torch AvgPool2d(k=2, s=2, padding=pad, count_include_pad=True): the
    JAX ``_avg_pool``."""
    return nn.AvgPool2d(2, 2, padding=pad, count_include_pad=True)


class PDN(nn.Sequential):
    """Patch description network, "small" or "medium"
    (src/efficientAD.py:90-127)."""

    def __init__(self, out_channels: int = 384, size: str = "small",
                 padding: bool = False):
        p = 1 if padding else 0
        if size == "small":
            layers = [nn.Conv2d(3, 128, 4, padding=3 * p), nn.ReLU(),
                      _pool(p),
                      nn.Conv2d(128, 256, 4, padding=3 * p), nn.ReLU(),
                      _pool(p),
                      nn.Conv2d(256, 256, 3, padding=p), nn.ReLU(),
                      nn.Conv2d(256, out_channels, 4)]
        elif size == "medium":
            layers = [nn.Conv2d(3, 256, 4, padding=3 * p), nn.ReLU(),
                      _pool(p),
                      nn.Conv2d(256, 512, 4, padding=3 * p), nn.ReLU(),
                      _pool(p),
                      nn.Conv2d(512, 512, 1), nn.ReLU(),
                      nn.Conv2d(512, 512, 3, padding=p), nn.ReLU(),
                      nn.Conv2d(512, out_channels, 4), nn.ReLU(),
                      nn.Conv2d(out_channels, out_channels, 1)]
        else:
            raise ValueError(f"unknown PDN size: {size}")
        super().__init__(*layers)


class Autoencoder(nn.Sequential):
    """Conv autoencoder over 256 px inputs (src/efficientAD.py:32-88):
    five k4/s2/p1 convs and a k8 valid conv, then a bilinear-resize ladder
    (3, 8, 15, 32, 63, 127) of k4/p2 convs with dropout, a resize to 56 and
    two k3/p1 convs."""

    def __init__(self, out_channels: int = 384):
        layers = []
        width = 3
        for w in (32, 32, 64, 64, 64):
            layers += [nn.Conv2d(width, w, 4, stride=2, padding=1), nn.ReLU()]
            width = w
        layers.append(nn.Conv2d(64, 64, 8))
        for size in (3, 8, 15, 32, 63, 127):
            layers += [Resize(size), nn.Conv2d(64, 64, 4, padding=2),
                       nn.ReLU(), nn.Dropout(0.2)]
        layers += [Resize(56), nn.Conv2d(64, 64, 3, padding=1), nn.ReLU(),
                   nn.Conv2d(64, out_channels, 3, padding=1)]
        super().__init__(*layers)


def init_efficientad_(module: nn.Module,
                      generator: Optional[torch.Generator] = None
                      ) -> nn.Module:
    """Every convolution of ``module``: torch's default kernel init from
    ``generator``, zero bias (flax's ``torch_conv_init`` and zeros)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            torch_conv_init(m.weight, generator)
            with torch.no_grad():
                m.bias.zero_()
    return module
