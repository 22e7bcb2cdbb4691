"""PSNR / SSIM / MSE metric primitives (NHWC tensors).

Anomaly scores ARE metric values (1-SSIM, MSE, -PSNR), so these reproduce the
JAX package's device metrics (``adsr_tpu/metrics.py``): uniform box kernel,
*reflect* padding, BT.601 luma with no offset, data range 1.0. The training
side's validation metrics (``psnr_shave4``, ``ssim_shave4``, metrics.py:182-217)
shave a 4-px border and pad the SSIM box filter with zeros. ``psnr_np`` is
the host (numpy) PSNR of the disk sweeps (``eval/disk.py``).

The box filters run in float32 as separable ``avg_pool2d`` passes over the
reflect-padded image: a pooling sum never goes through TF32, so this is the
counterpart of the JAX package's ``Precision.HIGHEST`` depthwise convolutions
(``adsr_tpu/metrics.py:127,130``) whatever the cuDNN TF32 setting.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# BT.601 luma coefficients as used by the reference (metrics.py:37, 93):
# weighted sum only — no +16 offset.
_LUMA_COEFFS = (65.738 / 256.0, 129.057 / 256.0, 25.064 / 256.0)


def psnr_np(img_ref: np.ndarray, img: np.ndarray,
            data_range: Optional[float] = None) -> float:
    """PSNR between two host arrays (the JAX ``psnr_np``, parity with the
    reference's psnr_numpy, metrics.py:15-23): f32, ``data_range`` 1.0 when
    not given (the reference checks the dtype after its f32 cast), inf where
    the arrays are equal."""
    ref = np.asarray(img_ref, dtype=np.float32)
    out = np.asarray(img, dtype=np.float32)
    if data_range is None:
        data_range = 1.0
    mse = float(np.mean((ref - out) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * float(np.log10((data_range ** 2) / mse))


def _uniform_filter_nchw(x: torch.Tensor, win: int,
                         padding: str = "reflect") -> torch.Tensor:
    """win x win mean filter over H, W of an NCHW f32 tensor; ``padding``
    'reflect' or 'zero' (torch ``F.conv2d`` with padding=win//2)."""
    pad = win // 2
    mode = "reflect" if padding == "reflect" else "constant"
    xp = F.pad(x, (pad, pad, pad, pad), mode=mode)
    y = F.avg_pool2d(xp, (win, 1), stride=1)
    return F.avg_pool2d(y, (1, win), stride=1)


def to_luma(x: torch.Tensor) -> torch.Tensor:
    """NHWC with C==3 -> NHW1 luma; C==1 passthrough. Each channel times
    its coefficient as a scalar, so no coefficient tensor is made from host
    data (the scoring call is captured in a CUDA graph); the products are
    summed by the same reduction as ``(x * coeffs).sum(-1)``, bit for bit
    on the card too."""
    if x.shape[-1] == 1:
        return x
    return torch.stack([x[..., i] * c for i, c in enumerate(_LUMA_COEFFS)],
                       dim=-1).sum(dim=-1, keepdim=True)


def ssim_map(a: torch.Tensor, b: torch.Tensor, win: int,
             c1: float, c2: float, padding: str = "reflect") -> torch.Tensor:
    """Per-pixel SSIM map for single-channel NHWC inputs."""
    if padding not in ("reflect", "zero"):
        raise ValueError(f"ssim_map: padding {padding!r}, not reflect|zero")
    a = a.permute(0, 3, 1, 2)
    b = b.permute(0, 3, 1, 2)

    def box(t):
        return _uniform_filter_nchw(t, win, padding)

    mu1 = box(a)
    mu2 = box(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = box(a * a) - mu1_sq
    sigma2_sq = box(b * b) - mu2_sq
    sigma12 = box(a * b) - mu1_mu2
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


def _shave(x: torch.Tensor, shave: int) -> torch.Tensor:
    return x[:, shave:-shave, shave:-shave, :] if x.shape[2] > 2 * shave else x


def psnr_shave4(sr: torch.Tensor, hr: torch.Tensor,
                rgb_range: float) -> torch.Tensor:
    """Validation PSNR (the JAX ``psnr_shave4``, metrics.py:182-193): NHWC ->
    [B], divided by ``rgb_range``, a 4-px border shaved when W > 8."""
    diff = _shave((sr.float() - hr.float()) / rgb_range, 4)
    mse = (diff * diff).mean(dim=(1, 2, 3))
    psnr = 10.0 * torch.log10(1.0 / mse.clamp_min(1e-38))
    return torch.where(mse == 0, torch.full_like(mse, float("inf")), psnr)


def ssim_shave4(sr: torch.Tensor, hr: torch.Tensor, rgb_range: float,
                win_size: int = 11) -> torch.Tensor:
    """Validation SSIM (the JAX ``ssim_shave4``, metrics.py:196-217): NHWC ->
    [B]. Crops sr to hr, clips to [0, 1], shaves 4 px, luma, zero padding,
    and C1/C2 on the 255 scale applied to the [0, 1] signal (a quirk of the
    reference that the JAX package keeps)."""
    h, w = hr.shape[1], hr.shape[2]
    a = _shave((sr[:, :h, :w].float() / rgb_range).clamp(0.0, 1.0), 4)
    b = _shave((hr.float() / rgb_range).clamp(0.0, 1.0), 4)
    m = ssim_map(to_luma(a), to_luma(b), win_size, (0.01 * 255.0) ** 2,
                 (0.03 * 255.0) ** 2, "zero")
    return m.mean(dim=(1, 2, 3))


def quantize(img: torch.Tensor, rgb_range: float) -> torch.Tensor:
    """Round-trip an image to the 0-255 grid (reference trainer.py:45-47)."""
    pixel_range = 255.0 / rgb_range
    return torch.round(torch.clamp(img * pixel_range, 0.0, 255.0)) / pixel_range
