"""Loss factory for 'w1*L1+w2*MSE'-style specs (the port of
``adsr_tpu/train/losses.py:27-91``, reference src/loss.py:72-121).

Components:
- L1   — mean absolute error;
- MSE  — mean squared error;
- PSNR — ``-10*log10(255^2 / (mse + 1e-8))``, 255 hard-coded whatever
  ``rgb_range`` is (src/loss.py:63-70);
- SSIM — ``(1 - ssim_map).sum() / batch_size`` with shave = scale+6 (else
  1 px), luma, a zero-padded 11x11 box kernel and C1/C2 on the 255 scale
  (src/loss.py:9-52).

``make_loss`` returns ``fn(sr, hr) -> (total, {name: weighted value})``; every
term is computed in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from adsr_tpu_torch.metrics import ssim_map, to_luma

LossFn = Callable[[torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
TERMS = ("L1", "MSE", "PSNR", "SSIM")


def _l1(sr, hr):
    return (sr - hr).abs().mean()


def _mse(sr, hr):
    return (sr - hr).square().mean()


def _psnr_loss(sr, hr):
    return -10.0 * torch.log10(255.0 ** 2 / (_mse(sr, hr) + 1e-8))


def _ssim_loss(sr: torch.Tensor, hr: torch.Tensor, batch_size: int,
               scale: int, rgb_range: float) -> torch.Tensor:
    h, w = hr.shape[1], hr.shape[2]
    sr = (sr[:, :h, :w] / rgb_range).clamp(0.0, 1.0)
    hr = (hr / rgb_range).clamp(0.0, 1.0)
    shave = scale + 6 if sr.shape[2] > 2 * (scale + 6) else 1
    sr = sr[:, shave:-shave, shave:-shave]
    hr = hr[:, shave:-shave, shave:-shave]
    m = ssim_map(to_luma(sr), to_luma(hr), 11, (0.01 * 255.0) ** 2,
                 (0.03 * 255.0) ** 2, "zero")
    return (1.0 - m).sum() / batch_size


def parse_loss_spec(spec: str) -> List[Tuple[float, str]]:
    out = []
    for term in spec.split("+"):
        weight, name = term.split("*")
        if name not in TERMS:
            raise ValueError(f"Unsupported loss type: {name}")
        out.append((float(weight), name))
    return out


def make_loss(spec: str, batch_size: int = 1, scale: int = 4,
              rgb_range: float = 255.0) -> LossFn:
    terms = parse_loss_spec(spec)
    fns = {"L1": _l1, "MSE": _mse, "PSNR": _psnr_loss,
           "SSIM": lambda sr, hr: _ssim_loss(sr, hr, batch_size, scale,
                                             rgb_range)}

    def loss_fn(sr: torch.Tensor, hr: torch.Tensor):
        sr, hr = sr.float(), hr.float()
        comps: Dict[str, torch.Tensor] = {}
        for weight, name in terms:
            comps[name] = weight * fns[name](sr, hr)
        return sum(comps.values()), comps

    return loss_fn
