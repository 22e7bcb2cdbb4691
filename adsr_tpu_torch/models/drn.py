"""DRN-L dual-regression super-resolution network, eager PyTorch (NHWC at
the edges, NCHW inside; the port of ``adsr_tpu/models/drn.py``).

Bicubic-upsample the LR input to HR size, U-Net-style strided-conv down
phases with skip copies, RCAB + Upsampler up phases, and a 3x3 tail
emitting an SR image at every scale ``[H/2^phase ... H]``
(reference src/drn.py:160-270). ``DownBlock`` is both the internal down
block and the dual-regression model mapping SR back to LR
(src/model.py:78-82, src/drn.py:83-119).

The ``state_dict`` keeps the reference torch module names, which the JAX
package's ``convert_drn`` (``adsr_tpu/io/torch_convert.py:119``) reads:
``sub_mean`` / ``add_mean``, ``head``, ``down.{p}.dual_module.{0.0, 1}``,
``up_blocks.{i}.{j}.body.{0,2}`` and ``.body.3.conv_du.{0,2}`` for RCAB j,
``up_blocks.{i}.{n_blocks}.{2k}`` for the upsampler, ``up_blocks.{i}.
{n_blocks+1}`` for the 1x1 projection, ``tail.{idx}``. A dual model's
names are ``dual_module.{0.0, 1}``. So reference ``.pt`` files load as they
are.

``forward(x, dtype)`` runs the network in ``dtype`` (the JAX module's
``dtype``): the bicubic upsample in f32, then every convolution in
``dtype`` on f32 parameters; f32 runs with TF32 off. DRN has no stochastic
layer.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from adsr_tpu_torch.core.config import DRNModelConfig
from adsr_tpu_torch.core.device import full_f32
from adsr_tpu_torch.models.common import (GRAY_MEAN, RGB_MEAN, RCAB, Conv2d,
                                          MeanShift, Upsampler, conv,
                                          upsample_bicubic)


class DownBlock(nn.Module):
    """Stride-2 convs without bias, each followed by LeakyReLU(negval), then
    a 3x3 projection without bias (src/drn.py:83-119); also the dual
    model."""

    def __init__(self, scale: int, n_feat: int, in_channels: int,
                 out_channels: int, negval: float = 0.2):
        super().__init__()
        layers = [nn.Sequential(
            Conv2d(in_channels, n_feat, 3, stride=2, padding=1, bias=False),
            nn.LeakyReLU(negval))]
        for _ in range(1, scale.bit_length() - 1):
            layers.append(nn.Sequential(
                Conv2d(n_feat, n_feat, 3, stride=2, padding=1, bias=False),
                nn.LeakyReLU(negval)))
        layers.append(Conv2d(n_feat, out_channels, 3, padding=1, bias=False))
        self.dual_module = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dual_module(x)


class DRN(nn.Module):
    """LR [B, h, w, C] -> list of SR [B, h*2^p, w*2^p, C] for p = 0..phase,
    lowest resolution first."""

    def __init__(self, cfg: DRNModelConfig):
        super().__init__()
        self.cfg = cfg
        phase = len(cfg.scale)
        f, c = cfg.n_feats, cfg.n_colors
        mean = GRAY_MEAN if c == 1 else RGB_MEAN
        self.sub_mean = MeanShift(c, cfg.rgb_range, mean, sign=-1)
        self.head = conv(c, f, 3)
        self.down = nn.ModuleList(
            DownBlock(2, f * 2 ** p, f * 2 ** p, f * 2 ** (p + 1), cfg.negval)
            for p in range(phase))
        # widths per up phase (src/drn.py:199-223; the JAX drn.py:98-107):
        # RCAB bodies, upsamplers, 1x1 projections
        body = ([f * 2 ** phase, f * 2 ** phase]
                + [f * 2 ** p for p in range(phase - 1, 1, -1)])[:phase]
        up = [f * 2 ** phase] + [2 * f * 2 ** p
                                 for p in range(phase - 1, 0, -1)]
        proj = [f * 2 ** p for p in range(phase - 1, -1, -1)]
        self.up_blocks = nn.ModuleList(
            nn.Sequential(*[RCAB(body[i]) for _ in range(cfg.n_blocks)],
                          Upsampler(2, up[i]), conv(up[i], proj[i], 1))
            for i in range(phase))
        self.add_mean = MeanShift(c, cfg.rgb_range, mean, sign=1)
        self.tail = nn.ModuleList(
            conv(w, c, 3) for w in [f * 2 ** phase]
            + [f * 2 ** p for p in range(phase, 0, -1)])

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
        """x: LR NHWC float; returns the SRs in ``dtype``, NHWC."""
        phase = len(self.cfg.scale)
        with full_f32():
            x = upsample_bicubic(x.permute(0, 3, 1, 2).float(),
                                 self.cfg.max_scale).to(dtype)
            x = self.head(self.sub_mean(x))
            copies = []
            for down in self.down:
                copies.append(x)
                x = down(x)
            results = [self.add_mean(self.tail[0](x))]
            for idx, up in enumerate(self.up_blocks):
                # U-Net concat of the skip copy (src/drn.py:263)
                x = torch.cat([up(x), copies[phase - idx - 1]], dim=1)
                results.append(self.add_mean(self.tail[idx + 1](x)))
        return [r.permute(0, 2, 3, 1) for r in results]


def make_dual_models(cfg: DRNModelConfig) -> nn.ModuleList:
    """One x2 ``DownBlock`` per scale entry, mapping SR -> LR
    (src/model.py:78-82). Dual i takes ``sr[i - len(scale)]`` (NCHW)."""
    return nn.ModuleList(
        DownBlock(2, cfg.n_feats, cfg.n_colors, cfg.n_colors, cfg.negval)
        for _ in cfg.scale)


def apply_dual(dual: DownBlock, sr: torch.Tensor) -> torch.Tensor:
    """A dual model on an NHWC SR, in f32 (the JAX duals are f32 modules,
    so a bf16 SR is promoted): NHWC LR out."""
    with full_f32():
        return dual(sr.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
