"""Disk-based research analysis pipelines (the port of
``adsr_tpu/eval/disk.py``; reference src/helpers.py:158-434 and
src/recall_1.py:365-435).

These operate on *saved* SR/HR image folders (the evaluator's PNG export,
read with the port's ``io/png.py``) rather than a live model: the window-size
sweep over saved reconstructions (on the card unless the caller asks for the
CPU), patch-grouped part scoring, and specificity at the perfect-recall
threshold (also what ``evaluate_anomaly`` returns).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from adsr_tpu_torch.eval.auc import (perfect_recall_threshold, roc_auc,
                                     specificity_at)
from adsr_tpu_torch.io.png import read_png
from adsr_tpu_torch.metrics import psnr_np


def _load_pairs(sr_dir: str, hr_dir: str
                ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """The SR PNGs of ``sr_dir`` that have a namesake in ``hr_dir``, both
    stacked [N, H, W, C] uint8 (a grey SR makes both [..., None]), and their
    stems; ``FileNotFoundError`` when ``sr_dir`` holds no PNG."""
    sr_files = sorted(Path(sr_dir).glob("*.png"))
    if not sr_files:
        raise FileNotFoundError(f"no PNGs in {sr_dir}")
    srs, hrs, names = [], [], []
    for f in sr_files:
        hr_f = Path(hr_dir) / f.name
        if not hr_f.exists():
            continue
        sr, hr = read_png(f), read_png(hr_f)
        if sr.ndim == 2:
            sr, hr = sr[..., None], hr[..., None]
        srs.append(sr)
        hrs.append(hr)
        names.append(f.stem)
    return np.stack(srs), np.stack(hrs), names


def analyze_window_sizes(good_sr: str, good_hr: str, bad_sr: str,
                         bad_hr: str,
                         window_sizes: Optional[Sequence[int]] = None,
                         group_div: Optional[int] = None,
                         device="cuda") -> Dict[str, object]:
    """Window-size sweep + final AUCs over saved image folders
    (helpers.py:158-319), the SSIM sweep on ``device``. group_div enables
    patch-grouped part scoring."""
    from adsr_tpu_torch.eval.evaluate import (grouped_max_scores,
                                              sweep_best_window)
    sr_g, hr_g, names_g = _load_pairs(good_sr, good_hr)
    sr_b, hr_b, names_b = _load_pairs(bad_sr, bad_hr)
    sr = np.concatenate([sr_g, sr_b])
    hr = np.concatenate([hr_g, hr_b])
    y_true = [0] * len(sr_g) + [1] * len(sr_b)
    names = names_g + names_b

    best_ws, best_auc, per_ws = sweep_best_window(sr, hr, y_true,
                                                  window_sizes, device=device)
    scores_ssim = per_ws[best_ws]
    sr_f = sr.astype(np.float32) / 255.0
    hr_f = hr.astype(np.float32) / 255.0
    scores_mse = [float(np.mean((a - b) ** 2)) for a, b in zip(sr_f, hr_f)]
    scores_psnr = [psnr_np(b, a) for a, b in zip(sr_f, hr_f)]

    if group_div:
        y_true_g, scores_ssim_g = grouped_max_scores(names, scores_ssim,
                                                     y_true, group_div)
        _, scores_mse_g = grouped_max_scores(names, scores_mse, y_true,
                                             group_div)
        _, scores_negpsnr_g = grouped_max_scores(
            names, [-p for p in scores_psnr], y_true, group_div)
        return {
            "best_ws": best_ws,
            "auc_ssim": roc_auc(y_true_g, scores_ssim_g),
            "auc_mse": roc_auc(y_true_g, scores_mse_g),
            "auc_psnr": roc_auc(y_true_g, scores_negpsnr_g),
            "grouped": True, "n_groups": len(y_true_g),
        }

    return {
        "best_ws": best_ws,
        "auc_ssim": roc_auc(y_true, scores_ssim),
        "auc_mse": roc_auc(y_true, scores_mse),
        "auc_psnr": roc_auc(y_true, [-p for p in scores_psnr]),
        "y_true": y_true, "names": names,
        "scores_ssim": list(map(float, scores_ssim)),
        "scores_mse": scores_mse, "scores_psnr": scores_psnr,
    }


def specificity_report(y_true: Sequence[int],
                       scores: Dict[str, Sequence[float]]
                       ) -> Dict[str, Dict[str, float]]:
    """Per metric: the lowest score of a defective image (the threshold at
    which every defective image is flagged) and the share of good images
    below it (recall_1.py:419-435)."""
    out = {}
    for name, s in scores.items():
        thr = perfect_recall_threshold(y_true, s)
        out[name] = {"threshold": thr,
                     "specificity": specificity_at(y_true, s, thr)}
    return out
