"""Anomaly evaluation: SR reconstruction error -> ROC-AUC (port of
``adsr_tpu/eval/evaluate.py``).

Forward over each split (tiled when the test LR exceeds the model's input
size: DRCT's ``img_size``, a DRN's train-crop LR) -> crop -> TRUNCATING
uint8 conversion (the reference's ``.byte()``, evaluate.py:214) ->
per-image SSIM at every window size of the sweep (odd sizes 3, 13, ... up
to min_dim-3, evaluate.py:233-248, optionally capped to ``sweep_windows``
evenly spaced sizes) plus MSE and PSNR on the device ->
ROC-AUC per score and the specificity at the perfect-recall threshold on the
host. Over a device mesh the forward is batch-parallel: each data rank runs
its rows of every batch and the SR rows are gathered (evaluate.py:33-63). On
the card the forward serves through one CUDA graph per LR shape (the tail is
padded, so one graph an evaluation; ``graphs=False`` launches
it), and the SSIM of every window size comes back in one transfer, as the
JAX version's one compiled sweep does.

``evaluate_anomaly_arrays`` is the array core (no files); ``evaluate_anomaly``
loads ``test/good`` and ``test/bad`` with the port's PNG decoder, calls it,
writes the SR images when asked and, with an ``out_dir``, the ROC curves and
the heatmaps (``eval/visual.py``, as the JAX version does).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from adsr_tpu_torch.core.config import DRCTModelConfig, Experiment
from adsr_tpu_torch.core.device import resolve_device
from adsr_tpu_torch.core.mesh import Mesh, ShardedCall
from adsr_tpu_torch.data.pipeline import load_sr_dataset
from adsr_tpu_torch.eval.auc import roc_auc
from adsr_tpu_torch.eval.disk import specificity_report
from adsr_tpu_torch.eval.visual import save_heatmaps, save_roc_curves
from adsr_tpu_torch.io.png import write_png
from adsr_tpu_torch.metrics import mse_eval, psnr_eval, ssim_map, to_luma
from adsr_tpu_torch.train.trainer import (make_serving_forward,
                                          make_tiled_serving_forward)


def _forward_split(forward: Callable, exp: Experiment, lr: np.ndarray,
                   hr: np.ndarray, batch: int, mesh: Optional[Mesh] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """SR over one split; returns (sr_u8, hr_u8) as [N,H,W,C] uint8.
    ``lr`` / ``hr`` are float arrays in [0, rgb_range]; the tail is padded to
    ``batch`` with the last image, as the JAX version does. With a ``mesh``
    each chunk is split over the data ranks (``batch`` must divide by
    ``n_data``), each runs its rows through ``forward`` (an unsharded
    forward) and the SR rows are gathered (evaluate.py:33-63)."""
    if mesh is not None:
        if batch % mesh.n_data:
            raise ValueError(f"evaluation batch {batch} does not divide by "
                             f"the mesh's {mesh.n_data} data ranks")
        forward = ShardedCall(forward, mesh)
    n = lr.shape[0]
    outs = []
    for i in range(0, n, batch):
        chunk = lr[i:i + batch]
        pad = batch - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        sr = forward(chunk).cpu().numpy()
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


def capped_candidates(min_dim: int, sweep_windows: int = 0,
                      log=print) -> List[int]:
    """The window ladder, evenly subsampled to ``sweep_windows`` sizes when
    that is > 0 and shorter (evaluate.py:186-197)."""
    cands = window_size_candidates(min_dim)
    if sweep_windows and len(cands) > sweep_windows:
        idx = np.linspace(0, len(cands) - 1, sweep_windows).round()
        cands = [cands[int(i)] for i in idx]
        log(f"Window sweep capped to {len(cands)} sizes: {cands}")
    return cands


@torch.no_grad()
def sweep_best_window(sr_u8: np.ndarray, hr_u8: np.ndarray,
                      y_true: Sequence[int],
                      window_sizes: Optional[Sequence[int]] = None,
                      device="cuda") -> Tuple[int, float, Dict[int, np.ndarray]]:
    """SSIM at every window size on the device, brought to the host in one
    transfer (the JAX ``_ssim_sweep_graph``, evaluate.py:78-90); AUC per
    size on the host."""
    dev = resolve_device(device)
    if window_sizes is None:
        window_sizes = window_size_candidates(min(hr_u8.shape[1], hr_u8.shape[2]))
    a = to_luma(torch.as_tensor(hr_u8, device=dev).float() / 255.0)
    b = to_luma(torch.as_tensor(sr_u8, device=dev).float() / 255.0)
    all_ssim = torch.stack([
        ssim_map(a, b, ws, 0.01 ** 2, 0.03 ** 2).mean(dim=(1, 2, 3))
        for ws in window_sizes]).cpu().numpy()
    best_ws, best_auc = window_sizes[0], -1.0
    per_ws: Dict[int, np.ndarray] = {}
    for ws, ssim in zip(window_sizes, all_ssim):
        scores = 1.0 - ssim
        per_ws[ws] = scores
        auc = roc_auc(y_true, scores)
        if auc > best_auc:
            best_auc, best_ws = auc, ws
    return best_ws, best_auc, per_ws


def make_split_forward(exp: Experiment, params: Mapping[str, torch.Tensor],
                       lr_size: int, device, tile: int = 0,
                       tile_overlap: int = 8, mode: Optional[str] = None,
                       log=print, graphs: bool = True) -> Callable:
    """The raw-float SR forward of an evaluation: tiled when ``tile > 0`` or
    when the LR input (``lr_size``) exceeds the model's tile, DRCT's
    ``img_size`` or a DRN's train-crop LR ``patch_size // scale``
    (evaluate.py:143-165), else the whole-image serving forward; on the card
    a CUDA graph per LR shape unless ``graphs=False``."""
    if isinstance(exp.model, DRCTModelConfig):
        train_tile = exp.model.img_size
    else:
        train_tile = max(1, exp.data.patch_size // max(exp.data.scale))
    if tile > 0 or lr_size > train_tile:
        log(f"Tiled serving: tile={tile or train_tile} "
            f"overlap={tile_overlap} for {lr_size}px LR input")
        return make_tiled_serving_forward(exp, params, tile or train_tile,
                                          overlap=tile_overlap,
                                          quantize_out=False, device=device,
                                          mode=mode, graphs=graphs)
    # raw float SR: the uint8 conversion TRUNCATES like the reference's
    # .byte(); serving's quantize() rounds
    return make_serving_forward(exp, params, device=device,
                                quantize_out=False, mode=mode, graphs=graphs)


def _evaluate(exp, params, lr_good, hr_good, lr_bad, hr_bad, batch, device,
              log, tile, tile_overlap, sweep_windows, mode, graphs, mesh
              ) -> Tuple[Dict[str, object], np.ndarray, np.ndarray]:
    dev = resolve_device(device)
    if len(lr_good) == 0 or len(lr_bad) == 0:
        raise ValueError("AUCs need good and defective test images "
                         f"({len(lr_good)} good, {len(lr_bad)} defective)")
    lr_size = max(lr_good.shape[1], lr_good.shape[2])
    forward = make_split_forward(exp, params, lr_size, dev, tile,
                                 tile_overlap, mode, log, graphs)
    sr_g, hr_g = _forward_split(forward, exp, lr_good, hr_good, batch, mesh)
    sr_b, hr_b = _forward_split(forward, exp, lr_bad, hr_bad, batch, mesh)
    sr_u8 = np.concatenate([sr_g, sr_b])
    hr_u8 = np.concatenate([hr_g, hr_b])
    y_true = [0] * len(sr_g) + [1] * len(sr_b)

    cands = capped_candidates(min(hr_u8.shape[1], hr_u8.shape[2]),
                              sweep_windows, log)
    best_ws, _, per_ws = sweep_best_window(sr_u8, hr_u8, y_true, cands,
                                           device=dev)

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
    # specificity at the perfect-recall threshold (recall_1.py:419-435)
    spec = specificity_report(y_true, {
        "ssim": list(map(float, scores_ssim)),
        "mse": list(map(float, scores_mse)),
        "psnr": [-float(p) for p in scores_psnr],
    })
    return {
        "specificity": spec,
        "auc_ssim": auc_ssim, "auc_mse": auc_mse, "auc_psnr": auc_psnr,
        "best_ws": best_ws, "y_true": y_true,
        "scores_ssim": scores_ssim.tolist(),
        "scores_mse": scores_mse.tolist(),
        "scores_psnr": scores_psnr.tolist(),
    }, sr_u8, hr_u8


def evaluate_anomaly_arrays(exp: Experiment, params: Mapping[str, torch.Tensor],
                            lr_good: np.ndarray, hr_good: np.ndarray,
                            lr_bad: np.ndarray, hr_bad: np.ndarray,
                            batch: int = 8, device="cuda", log=print,
                            tile: int = 0, tile_overlap: int = 8,
                            sweep_windows: int = 0,
                            mode: Optional[str] = None,
                            graphs: bool = True,
                            mesh: Optional[Mesh] = None) -> Dict[str, object]:
    """The array core of :func:`evaluate_anomaly`: LR/HR float arrays in
    [0, rgb_range] (NHWC) for the good and defective test images ->
    AUCs, best SSIM window, per-image scores and the specificity report."""
    return _evaluate(exp, params, lr_good, hr_good, lr_bad, hr_bad, batch,
                     device, log, tile, tile_overlap, sweep_windows, mode,
                     graphs, mesh)[0]


def evaluate_anomaly(exp: Experiment, params: Mapping[str, torch.Tensor],
                     data_root: str, classe: str,
                     out_dir: Optional[str] = None, save_images: bool = True,
                     batch: int = 8, device="cuda", log=print, tile: int = 0,
                     tile_overlap: int = 8, sweep_windows: int = 0,
                     mode: Optional[str] = None,
                     graphs: bool = True,
                     mesh: Optional[Mesh] = None) -> Dict[str, object]:
    """Full anomaly pass over ``{data_root}/{classe}/test/{good,bad}``
    (reference evaluate.py:138-267). ``tile > 0`` forces tiled serving with
    that LR tile; 0 tiles when the test LR exceeds the model's input size.
    ``sweep_windows > 0`` caps the SSIM window sweep; ``mode`` picks the
    fused forward (``"rdg"`` / ``"block"``; ``None`` reads
    ``ADSR_TPU_RDG``). On the card the forward serves through a CUDA graph
    per LR shape; ``graphs=False`` launches it. With ``out_dir`` and
    ``save_images`` the uint8 SR images go to
    ``out_dir/{good,bad}/x{scale}/{name}.png``; with ``out_dir`` alone,
    ``out_dir/roc_curve.pdf`` (1-SSIM, MSE, -PSNR) and the heatmaps
    ``out_dir/heatmaps/{split}/{name}.png`` at the best window, and
    ``figures_s``, the seconds that took, in the result. With a ``mesh``
    (every rank calls it, on the mesh's device) each batch is split over
    the data ranks and gathered, so every rank scores the whole split, and
    rank 0 alone writes the files; ``batch`` must divide by ``n_data``."""
    scale = max(exp.data.scale)

    def load(split: str):
        return load_sr_dataset(f"{data_root}/{classe}/test/{split}",
                               (scale,), exp.data.n_colors,
                               exp.data.rgb_range)

    ds_good, ds_bad = load("good"), load("bad")
    dev = resolve_device(device if mesh is None else mesh.device)
    out, sr_u8, hr_u8 = _evaluate(exp, params, ds_good.lrs[0], ds_good.hr,
                                  ds_bad.lrs[0], ds_bad.hr, batch, dev, log,
                                  tile, tile_overlap, sweep_windows, mode,
                                  graphs, mesh)
    out["filenames"] = ds_good.filenames + ds_bad.filenames
    out["splits"] = ["good"] * ds_good.n + ["bad"] * ds_bad.n
    if mesh is not None and mesh.rank != 0:
        return out          # rank 0 writes the files
    if save_images and out_dir:
        for img, name, split in zip(sr_u8, out["filenames"], out["splits"]):
            d = Path(out_dir) / split / f"x{scale}"
            d.mkdir(parents=True, exist_ok=True)
            write_png(d / f"{name}.png", img)
    if out_dir:
        # ROC curves + difference/SSIM heatmaps (helpers.py:436-451;
        # notebooks/test.ipynb cells 11-21)
        t0 = time.perf_counter()
        save_roc_curves(str(Path(out_dir) / "roc_curve.pdf"), out["y_true"], {
            "1-SSIM": out["scores_ssim"],
            "MSE": out["scores_mse"],
            "-PSNR": [-p for p in out["scores_psnr"]],
        })
        n = save_heatmaps(out_dir, hr_u8, sr_u8, out["filenames"],
                          out["splits"], window=out["best_ws"], device=dev)
        out["figures_s"] = time.perf_counter() - t0
        log(f"Saved ROC curve and {n} heatmap figures to {out_dir}")
    return out


def grouped_max_scores(filenames: Sequence[str], scores: Sequence[float],
                       y_true: Sequence[int], group_div: int = 14
                       ) -> Tuple[List[int], List[float]]:
    """Patch-grouped scoring: group by int(name.split('_')[0]) // group_div and
    take the max patch score per physical part (src/helpers.py:232-319)."""
    groups: Dict[Tuple[int, int], float] = {}
    for name, score, label in zip(filenames, scores, y_true):
        try:
            gid = int(name.split("_")[0]) // group_div
        except ValueError:
            gid = hash(name.split("_")[0]) % (2 ** 31)
        key = (gid, label)
        groups[key] = max(groups.get(key, -np.inf), float(score))
    labels = [k[1] for k in groups]
    return labels, [groups[k] for k in groups]
