"""PSNR / SSIM / MSE metric primitives for anomaly scoring (NHWC tensors).

Anomaly scores ARE metric values (1-SSIM, MSE, -PSNR), so these reproduce the
JAX package's device metrics (``adsr_tpu/metrics.py``): uniform box kernel,
*reflect* padding, BT.601 luma with no offset, data range 1.0.

The box filters run in float32 as separable ``avg_pool2d`` passes over the
reflect-padded image: a pooling sum never goes through TF32, so this is the
counterpart of the JAX package's ``Precision.HIGHEST`` depthwise convolutions
(``adsr_tpu/metrics.py:127,130``) whatever the cuDNN TF32 setting.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# BT.601 luma coefficients as used by the reference (metrics.py:37, 93):
# weighted sum only — no +16 offset.
_LUMA_COEFFS = (65.738 / 256.0, 129.057 / 256.0, 25.064 / 256.0)


def _uniform_filter_nchw(x: torch.Tensor, win: int) -> torch.Tensor:
    """win x win mean filter over H, W of an NCHW f32 tensor, reflect pad."""
    pad = win // 2
    xp = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    y = F.avg_pool2d(xp, (win, 1), stride=1)
    return F.avg_pool2d(y, (1, win), stride=1)


def to_luma(x: torch.Tensor) -> torch.Tensor:
    """NHWC with C==3 -> NHW1 luma; C==1 passthrough."""
    if x.shape[-1] == 1:
        return x
    coeffs = torch.tensor(_LUMA_COEFFS, dtype=x.dtype, device=x.device)
    return (x[..., :3] * coeffs).sum(dim=-1, keepdim=True)


def ssim_map(a: torch.Tensor, b: torch.Tensor, win: int,
             c1: float, c2: float) -> torch.Tensor:
    """Per-pixel SSIM map for single-channel NHWC inputs (reflect padding)."""
    a = a.permute(0, 3, 1, 2)
    b = b.permute(0, 3, 1, 2)
    mu1 = _uniform_filter_nchw(a, win)
    mu2 = _uniform_filter_nchw(b, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _uniform_filter_nchw(a * a, win) - mu1_sq
    sigma2_sq = _uniform_filter_nchw(b * b, win) - mu2_sq
    sigma12 = _uniform_filter_nchw(a * b, win) - mu1_mu2
    m = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return m.permute(0, 2, 3, 1)


def ssim_eval(ref: torch.Tensor, out: torch.Tensor,
              win_size: int = 11) -> torch.Tensor:
    """Batched mean SSIM: NHWC [0,1] inputs -> [B]; luma for 3 channels."""
    a = to_luma(ref.float())
    b = to_luma(out.float())
    return ssim_map(a, b, win_size, 0.01 ** 2, 0.03 ** 2).mean(dim=(1, 2, 3))


def mse_eval(ref: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Batched per-image MSE: NHWC -> [B]."""
    diff = ref.float() - out.float()
    return (diff * diff).mean(dim=(1, 2, 3))


def psnr_eval(ref: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Batched PSNR at data range 1: NHWC -> [B] (inf where identical)."""
    mse = mse_eval(ref, out)
    psnr = 10.0 * torch.log10(1.0 / mse.clamp_min(1e-38))
    return torch.where(mse == 0, torch.full_like(mse, float("inf")), psnr)


def quantize(img: torch.Tensor, rgb_range: float) -> torch.Tensor:
    """Round-trip an image to the 0-255 grid (reference trainer.py:45-47)."""
    pixel_range = 255.0 / rgb_range
    return torch.round(torch.clamp(img * pixel_range, 0.0, 255.0)) / pixel_range
