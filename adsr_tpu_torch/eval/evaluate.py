"""Anomaly evaluation: SR reconstruction error -> ROC-AUC (port of
``adsr_tpu/eval/evaluate.py``).

Forward over each split -> crop -> TRUNCATING uint8 conversion (the
reference's ``.byte()``, evaluate.py:214) -> per-image SSIM at every window
size of the sweep (odd sizes 3, 13, ... up to min_dim-3, evaluate.py:233-248)
plus MSE and PSNR on the device -> ROC-AUC per score on the host.

``evaluate_anomaly_arrays`` is the array core (no files, so ``chip_smoke.py``
drives it); ``evaluate_anomaly`` loads the test split from disk (PIL, CPU)
and calls it. Specificity reports, heatmaps and tiled serving wait for later
slices.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from adsr_tpu_torch.core.config import Experiment
from adsr_tpu_torch.core.device import resolve_device
from adsr_tpu_torch.data.pipeline import load_sr_dataset
from adsr_tpu_torch.eval.auc import roc_auc
from adsr_tpu_torch.metrics import mse_eval, psnr_eval, ssim_map, to_luma
from adsr_tpu_torch.train.trainer import make_serving_forward


def _forward_split(forward: Callable, exp: Experiment, lr: np.ndarray,
                   hr: np.ndarray, batch: int, device: torch.device
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """SR over one split; returns (sr_u8, hr_u8) as [N,H,W,C] uint8.
    ``lr`` / ``hr`` are float arrays in [0, rgb_range]; the tail is padded to
    ``batch`` with the last image, as the JAX version does."""
    n = lr.shape[0]
    outs = []
    for i in range(0, n, batch):
        chunk = lr[i:i + batch]
        pad = batch - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        sr = forward(torch.as_tensor(chunk, device=device)).cpu().numpy()
        outs.append(sr[:sr.shape[0] - pad] if pad else sr)
    sr = np.concatenate(outs)
    h, w = hr.shape[1], hr.shape[2]
    sr = sr[:, :h, :w, :]
    # truncating byte conversion, as the reference's .byte() (evaluate.py:214)
    scale = 255.0 / exp.data.rgb_range
    sr_u8 = np.clip(sr * scale, 0, 255).astype(np.uint8)
    hr_u8 = np.clip(hr * scale, 0, 255).astype(np.uint8)
    return sr_u8, hr_u8


def window_size_candidates(min_dim: int) -> List[int]:
    """Odd sizes 3, 13, 23, ... up to min_dim-3 (evaluate.py:233-236)."""
    max_w = max(3, min_dim - 3)
    return [w for w in range(3, max_w + 1, 10) if w % 2 == 1] or [3]


@torch.no_grad()
def sweep_best_window(sr_u8: np.ndarray, hr_u8: np.ndarray,
                      y_true: Sequence[int],
                      window_sizes: Optional[Sequence[int]] = None,
                      device="cuda") -> Tuple[int, float, Dict[int, np.ndarray]]:
    """SSIM at every window size on the device; AUC per size on the host."""
    dev = resolve_device(device)
    if window_sizes is None:
        window_sizes = window_size_candidates(min(hr_u8.shape[1], hr_u8.shape[2]))
    a = to_luma(torch.as_tensor(hr_u8, device=dev).float() / 255.0)
    b = to_luma(torch.as_tensor(sr_u8, device=dev).float() / 255.0)
    best_ws, best_auc = window_sizes[0], -1.0
    per_ws: Dict[int, np.ndarray] = {}
    for ws in window_sizes:
        ssim = ssim_map(a, b, ws, 0.01 ** 2, 0.03 ** 2).mean(dim=(1, 2, 3))
        scores = 1.0 - ssim.cpu().numpy()
        per_ws[ws] = scores
        auc = roc_auc(y_true, scores)
        if auc > best_auc:
            best_auc, best_ws = auc, ws
    return best_ws, best_auc, per_ws


def evaluate_anomaly_arrays(exp: Experiment, params: Mapping[str, torch.Tensor],
                            lr_good: np.ndarray, hr_good: np.ndarray,
                            lr_bad: np.ndarray, hr_bad: np.ndarray,
                            batch: int = 8, device="cuda",
                            log=print) -> Dict[str, object]:
    """The array core of :func:`evaluate_anomaly`: LR/HR float arrays in
    [0, rgb_range] (NHWC) for the good and defective test images ->
    AUCs, best SSIM window and per-image scores."""
    dev = resolve_device(device)
    if len(lr_good) == 0 or len(lr_bad) == 0:
        raise ValueError("AUCs need good and defective test images "
                         f"({len(lr_good)} good, {len(lr_bad)} defective)")
    # raw float SR: the uint8 conversion TRUNCATES like the reference's
    # .byte(); serving's quantize() rounds
    forward = make_serving_forward(exp, params, device=dev, quantize_out=False)
    sr_g, hr_g = _forward_split(forward, exp, lr_good, hr_good, batch, dev)
    sr_b, hr_b = _forward_split(forward, exp, lr_bad, hr_bad, batch, dev)
    sr_u8 = np.concatenate([sr_g, sr_b])
    hr_u8 = np.concatenate([hr_g, hr_b])
    y_true = [0] * len(sr_g) + [1] * len(sr_b)

    best_ws, _, per_ws = sweep_best_window(sr_u8, hr_u8, y_true, device=dev)

    hr_f = torch.as_tensor(hr_u8, device=dev).float() / 255.0
    sr_f = torch.as_tensor(sr_u8, device=dev).float() / 255.0
    scores_ssim = per_ws[best_ws]
    scores_mse = mse_eval(sr_f, hr_f).cpu().numpy()
    scores_psnr = psnr_eval(hr_f, sr_f).cpu().numpy()

    auc_ssim = roc_auc(y_true, scores_ssim)
    auc_mse = roc_auc(y_true, scores_mse)
    auc_psnr = roc_auc(y_true, [-p for p in scores_psnr])
    log(f"Test AUCs - SSIM(best ws={best_ws}): {auc_ssim:.4f}, "
        f"MSE: {auc_mse:.4f}, PSNR: {auc_psnr:.4f}")
    return {
        "auc_ssim": auc_ssim, "auc_mse": auc_mse, "auc_psnr": auc_psnr,
        "best_ws": best_ws, "y_true": y_true,
        "scores_ssim": scores_ssim.tolist(),
        "scores_mse": scores_mse.tolist(),
        "scores_psnr": scores_psnr.tolist(),
    }


def evaluate_anomaly(exp: Experiment, params: Mapping[str, torch.Tensor],
                     data_root: str, classe: str, batch: int = 8,
                     device="cuda", log=print) -> Dict[str, object]:
    """Full anomaly pass over ``{data_root}/{classe}/test/{good,bad}``
    (reference evaluate.py:138-267); file loading runs on the CPU."""
    scale = max(exp.data.scale)

    def load(split: str):
        return load_sr_dataset(f"{data_root}/{classe}/test/{split}",
                               (scale,), exp.data.n_colors,
                               exp.data.rgb_range)

    ds_good, ds_bad = load("good"), load("bad")
    out = evaluate_anomaly_arrays(exp, params, ds_good.lrs[0], ds_good.hr,
                                  ds_bad.lrs[0], ds_bad.hr, batch=batch,
                                  device=device, log=log)
    out["filenames"] = ds_good.filenames + ds_bad.filenames
    out["splits"] = ["good"] * ds_good.n + ["bad"] * ds_bad.n
    return out
