"""Multi-class batched anomaly-scoring service (port of
``adsr_tpu/eval/serving.py``).

Per registered class: uint8 LR/HR batch -> channel conversion + pixel scaling
(the prep pipeline's math, reference data.py:11-19/52-65) -> SR forward
(``make_serving_forward``: a DRCT class packed once at registration, its
RDGs through the hand-written kernels on CUDA; a DRN-L class, RGB
included, its eager module on the registered weights and its full-scale
output) -> uint8 quantisation round-trip -> per-image anomaly scores (1-SSIM
at a configured window, MSE, -PSNR, reference evaluate.py:250-261). Tail
batches are padded to the configured batch size, so each class has one
input shape. On the card the whole scoring call of each class, DRCT or
DRN, runs as one CUDA graph (``core/graphs.py``), as the JAX ``register``
jits it: the uint8 requests are copied into its static inputs and the
[B, 3] scores come back with one device-to-host copy. ``graphs=False``
launches every kernel from Python on every call.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from adsr_tpu_torch.core.config import Experiment
from adsr_tpu_torch.core.device import resolve_device
from adsr_tpu_torch.core.graphs import CapturedCall
from adsr_tpu_torch.metrics import mse_eval, psnr_eval, quantize, ssim_eval
from adsr_tpu_torch.train.trainer import make_serving_forward


class AnomalyServer:
    """Registry of per-class scoring functions on one device."""

    def __init__(self, batch_size: int = 16, ssim_window: int = 11,
                 device="cuda", graphs: bool = True):
        self.batch_size = batch_size
        self.ssim_window = ssim_window
        self.device = resolve_device(device)
        self.graphs = graphs
        self._entries: Dict[str, CapturedCall] = {}

    def register(self, name: str, exp: Experiment,
                 params: Mapping[str, torch.Tensor],
                 mode: Optional[str] = None) -> None:
        """Prepare ``params`` once for class ``name`` (DRCT: packed; DRN:
        loaded into its module); ``mode`` is DRCT's fused forward's
        (``"rdg"`` or ``"block"``; ``None`` reads ``ADSR_TPU_RDG``, as the
        JAX ``register`` does through ``prepack_drct``)."""
        forward = make_serving_forward(exp, params, device=self.device,
                                       quantize_out=False, mode=mode,
                                       graphs=False)
        rgb_range = exp.data.rgb_range
        n_colors = exp.data.n_colors
        win = self.ssim_window

        @torch.no_grad()
        def score(lr_u8: torch.Tensor, hr_u8: torch.Tensor) -> torch.Tensor:
            lr = _prep(lr_u8, n_colors, rgb_range)
            hr = _prep(hr_u8, n_colors, rgb_range)
            sr = forward(lr)[:, :hr.shape[1], :hr.shape[2], :]
            sr = quantize(sr, rgb_range)
            # uint8 round-trip to [0,1] for scoring parity (evaluate.py:243)
            sr01 = torch.floor(torch.clamp(sr * (255.0 / rgb_range), 0, 255)) / 255.0
            hr01 = torch.floor(torch.clamp(hr * (255.0 / rgb_range), 0, 255)) / 255.0
            return torch.stack([1.0 - ssim_eval(hr01, sr01, win),
                                mse_eval(sr01, hr01),
                                -psnr_eval(hr01, sr01)], dim=-1)

        self._entries[name] = CapturedCall(score, self.device,
                                           capture=self.graphs)

    def classes(self) -> List[str]:
        return list(self._entries)

    def score(self, name: str, lr_u8: np.ndarray, hr_u8: np.ndarray
              ) -> np.ndarray:
        """[N,h,w,c] uint8 LR + [N,H,W,c] uint8 HR -> [N,3] scores
        (1-SSIM, MSE, -PSNR)."""
        fn = self._entries[name]
        n = lr_u8.shape[0]
        b = self.batch_size
        outs = []
        for i in range(0, n, b):
            lr = lr_u8[i:i + b]
            hr = hr_u8[i:i + b]
            pad = b - lr.shape[0]
            if pad:
                lr = np.concatenate([lr, np.repeat(lr[-1:], pad, 0)])
                hr = np.concatenate([hr, np.repeat(hr[-1:], pad, 0)])
            s = fn(lr, hr).cpu().numpy()
            outs.append(s[:s.shape[0] - pad] if pad else s)
        return np.concatenate(outs)


def _prep(img_u8: torch.Tensor, n_colors: int, rgb_range: float) -> torch.Tensor:
    """uint8 NHWC -> float32, channel rule + rgb_range scaling on device
    (the data-pipeline luma, WITH the +16 offset)."""
    x = img_u8.float()
    c = x.shape[-1]
    if n_colors == 1 and c >= 3:
        x = (16.0 + (65.481 * x[..., 0] + 128.553 * x[..., 1]
                     + 24.966 * x[..., 2]) / 255.0)[..., None]
    elif n_colors == 3 and c == 1:
        x = torch.cat([x] * 3, dim=-1)
    return x * (rgb_range / 255.0)
