"""Shared model pieces: dataset means, seeded initialisers and the DRN-L
building blocks (NCHW inside; the port of ``adsr_tpu/models/common.py``).

The JAX package's NHWC ``pixel_shuffle`` (models/common.py:51) has torch's
channel order (c, i, j), which ``F.pixel_shuffle`` / ``nn.PixelShuffle`` on
NCHW already have, so the port uses those directly.

The initialisers reproduce the JAX package's distributions with a
``torch.Generator`` (the bits differ from ``jax.random``; tests carry weights
across with ``io/convert.py`` instead of re-initialising).

The DRN-L blocks keep the reference torch module names (reference
src/drn.py:44-158), which the JAX package's ``convert_drn`` reads. Their
convolutions are :class:`Conv2d`, which runs in its input's dtype: a bf16
activation takes bf16 weights and accumulates in f32 (the JAX modules'
``dtype=bf16``), while the parameters stay f32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

# Dataset channel statistics used by MeanShift (reference src/drn.py:176-185).
RGB_MEAN = (0.4488, 0.4371, 0.4040)
GRAY_MEAN = (0.4440,)


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


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: weights and bias are cast to the
    activation's dtype for the product, the parameters stay as they are."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv(in_channels: int, out_channels: int, kernel_size: int,
         stride: int = 1, bias: bool = True) -> Conv2d:
    """The reference's ``default_conv``: torch padding ``kernel_size // 2``
    (src/drn.py:29-32; the JAX ``conv`` helper, common.py:40)."""
    return Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=kernel_size // 2, bias=bias)


class MeanShift(Conv2d):
    """1x1 conv initialised to the identity with bias ``sign * rgb_range *
    mean``. The reference sets ``requires_grad=False`` on the module, which
    torch ignores, so the parameters train; the JAX package keeps that quirk
    and so does the port (src/drn.py:44-52)."""

    def __init__(self, n_channels: int, rgb_range: float,
                 mean: Sequence[float], sign: int = -1):
        super().__init__(n_channels, n_channels, 1)
        self.init_bias = sign * rgb_range * torch.tensor(mean,
                                                         dtype=torch.float32)
        self.reset_shift()

    def reset_shift(self) -> None:
        c = self.out_channels
        with torch.no_grad():
            self.weight.copy_(torch.eye(c).view(c, c, 1, 1))
            self.bias.copy_(self.init_bias)


class CALayer(nn.Module):
    """Squeeze-excite channel attention (src/drn.py:123-139); the reduced
    width is ``max(1, channel // reduction)`` as in the JAX package."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        mid = max(1, channel // reduction)
        self.conv_du = nn.Sequential(Conv2d(channel, mid, 1), nn.ReLU(),
                                     Conv2d(mid, channel, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv_du(x.mean(dim=(2, 3), keepdim=True))


class RCAB(nn.Module):
    """Residual channel-attention block (src/drn.py:143-158)."""

    def __init__(self, n_feat: int, kernel_size: int = 3,
                 reduction: int = 16):
        super().__init__()
        self.body = nn.Sequential(conv(n_feat, n_feat, kernel_size),
                                  nn.ReLU(),
                                  conv(n_feat, n_feat, kernel_size),
                                  CALayer(n_feat, reduction))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class Upsampler(nn.Sequential):
    """conv -> PixelShuffle(2) per 2x factor (src/drn.py:55-81)."""

    def __init__(self, scale: int, n_feats: int):
        if scale & (scale - 1):
            raise NotImplementedError("only power-of-two scales")
        layers = []
        for _ in range(scale.bit_length() - 1):
            layers += [conv(n_feats, 4 * n_feats, 3), nn.PixelShuffle(2)]
        super().__init__(*layers)


def _cubic(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    at = t.abs()
    return torch.where(
        at <= 1, (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1,
        torch.where(at < 2, a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a,
                    torch.zeros_like(at)))


def bicubic_matrix(n_in: int, factor: int, device=None) -> torch.Tensor:
    """[n_in*factor, n_in] f32 row-stochastic matrix of 1-D bicubic
    upsampling, torch's kernel: a = -0.75, align_corners=False, border
    replicated (the JAX ``_bicubic_matrix``, common.py:157, summed in f64 in
    the same order). Built on ``device`` from ``arange``: no host data, so
    a CUDA graph can capture it."""
    f64 = torch.float64
    n_out = n_in * factor
    src = (torch.arange(n_out, dtype=f64, device=device) + 0.5) / factor - 0.5
    i0 = torch.floor(src) - 1
    cols = torch.arange(n_in, dtype=f64, device=device)
    mat = torch.zeros(n_out, n_in, dtype=f64, device=device)
    for k in range(4):
        idx = (i0 + k).clamp(0, n_in - 1)
        mat = mat + _cubic(src - (i0 + k))[:, None] * (
            idx[:, None] == cols[None, :])
    return mat.float()


def upsample_bicubic(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW f32 bicubic upsample by an integer factor, torch-kernel exact:
    two products with :func:`bicubic_matrix`, rows then columns (the JAX
    ``upsample_bicubic``, common.py:171). The caller keeps TF32 off
    (``core.device.full_f32``)."""
    mh = bicubic_matrix(x.shape[2], factor, x.device)
    mw = bicubic_matrix(x.shape[3], factor, x.device)
    return torch.matmul(torch.matmul(mh, x), mw.t())
