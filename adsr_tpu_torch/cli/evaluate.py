"""Evaluation entry point, the port of ``adsr_tpu/cli/evaluate.py``
(reference src/evaluate.py:20-45, 270-344):

    python -m adsr_tpu_torch.cli.evaluate --run-dir workspace/experiment/drct/mvtec_grid_128_X4...

Infers model (DRCT or DRN-L, with the capacity its config.txt records) /
class / resolution / scale from the run dir (name pattern, then config.txt),
resolves ``model_best.pt`` then ``model_latest.pt``, and runs the
anomaly AUC pass over ``test/good`` + ``test/bad`` (tiled when the test
images are larger than the model's input). Writes ``scores.txt`` (and
``--json-out``) and, unless ``--no-save-images``, the SR images. Runs on the
card unless ``--device cpu``, in ``--precision fp32`` unless asked
otherwise, as the JAX CLI (DRCT's f32 kernels); ``ADSR_TPU_RDG=0`` selects
DRCT's per-block serving mode (kernel (g), in either precision), as in
the JAX package. A DRN-L run auto-tiles at its
train-crop LR (``patch_size // scale``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    pre_args, _ = pre.parse_known_args(argv)

    p = argparse.ArgumentParser(description="Evaluation entrypoint",
                                parents=[pre])
    p.add_argument("--model-type", type=str, default="drct",
                   choices=["drct", "drn-l"])
    p.add_argument("--dataset", type=str, default="mvtec",
                   choices=["mvtec", "gkd", "gkd_large"])
    p.add_argument("--classe", type=str, default="grid")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda (default) runs the hand-written kernels; cpu "
                        "runs the plain PyTorch path. Nothing falls back.")
    p.add_argument("--data-root", type=str, default="auto")
    p.add_argument("--run-dir", type=str, default="")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--output-dir", type=str, default="")
    p.add_argument("--save-images", action="store_true", default=True)
    p.add_argument("--no-save-images", dest="save_images",
                   action="store_false")
    p.add_argument("--json-out", type=str, default="")
    p.add_argument("--group-div", type=int, default=0,
                   help="patch-grouped part scoring: group filenames by "
                        "int(name.split('_')[0]) // group-div and take the "
                        "max score per part (GKD workflow, helpers.py:232-319)")
    p.add_argument("--precision", type=str, default="fp32",
                   choices=["bf16", "fp32"],
                   help="fp32 (default, as the JAX CLI): DRCT scores through "
                        "the f32 kernels on the card (kernels (a)-(c) in "
                        "rdg mode, kernel (g) in block mode, ADSR_TPU_RDG=0) "
                        "or the plain path on the CPU; bf16 through the "
                        "bf16 kernels; DRN-L takes both anywhere")
    p.add_argument("--workers", type=int, default=0)  # compat; unused
    p.add_argument("--tile", type=int, default=0,
                   help="LR tile size for overlapped-tile serving; 0 = "
                        "auto (tiles only when input exceeds train size)")
    p.add_argument("--tile-overlap", type=int, default=8,
                   help="LR-pixel overlap between serving tiles")
    p.add_argument("--sweep-windows", type=int, default=0,
                   help="cap the SSIM window sweep to N sizes (evenly "
                        "subsampled); 0 = the reference's full 3..min-3 "
                        "ladder")

    if pre_args.config and os.path.isfile(pre_args.config):
        import yaml
        with open(pre_args.config) as f:
            cfg = yaml.safe_load(f) or {}
        p.set_defaults(**{k.replace("-", "_"): v for k, v in cfg.items()})
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    from adsr_tpu_torch.core.config import drct_experiment, drn_experiment
    from adsr_tpu_torch.core.device import resolve_device
    from adsr_tpu_torch.eval.auc import roc_auc
    from adsr_tpu_torch.eval.evaluate import (evaluate_anomaly,
                                              grouped_max_scores)
    from adsr_tpu_torch.eval.rundir import (infer_from_run_dir,
                                            resolve_checkpoint)
    from adsr_tpu_torch.io.journal import load_state_dict

    model_type, ds = args.model_type, args.dataset
    classe, resolution, scale = args.classe, args.resolution, args.scale

    inf = {}
    if args.run_dir:
        inf = infer_from_run_dir(args.run_dir)
        model_type = inf.get("model_type") or model_type
        ds = inf.get("dataset") or ds
        classe = inf.get("classe") or classe
        resolution = inf.get("resolution") or resolution
        scale = inf.get("scale") or scale

    data_root = args.data_root
    if data_root == "auto":
        # the train CLI's per-dataset convention (core/config.py
        # _dataset_paths); the pass reads {root}/{classe}/test/{good,bad}
        data_root = (f"data/mvtec_{resolution}" if ds == "mvtec"
                     else f"workspace/{ds}")

    if model_type == "drn-l":
        capacity = {k: inf[k] for k in ("n_blocks", "n_feats") if k in inf}
        exp = drn_experiment(classe=classe, resolution=resolution,
                             scale=scale, data_root=data_root,
                             precision=args.precision, **capacity)
    else:
        capacity = {k: inf[k] for k in ("embed_dim", "num_layers",
                                        "num_heads", "gc") if k in inf}
        exp = drct_experiment(classe=classe, resolution=resolution,
                              scale=scale, data_root=data_root,
                              precision=args.precision, **capacity)

    dev = resolve_device(args.device)
    ckpt = resolve_checkpoint(args.run_dir, args.checkpoint)
    params = load_state_dict(ckpt, dev)

    out_dir = (args.output_dir or
               (os.path.join(args.run_dir, "eval_results") if args.run_dir
                else "./workspace/eval_results"))

    result = evaluate_anomaly(exp, params, data_root, classe,
                              out_dir=out_dir, save_images=args.save_images,
                              batch=args.batch_size, device=dev,
                              tile=args.tile, tile_overlap=args.tile_overlap,
                              sweep_windows=args.sweep_windows)
    result["checkpoint"] = ckpt
    if args.group_div and "filenames" in result:
        grouped = {}
        for metric in ("ssim", "mse", "psnr"):
            scores = result[f"scores_{metric}"]
            if metric == "psnr":
                scores = [-s for s in scores]
            y_g, s_g = grouped_max_scores(result["filenames"], scores,
                                          result["y_true"], args.group_div)
            grouped[f"auc_{metric}_grouped"] = roc_auc(y_g, s_g)
        result.update(grouped)
        print("Grouped AUCs - " + ", ".join(
            f"{k}: {v:.4f}" for k, v in grouped.items()))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f)
    if "filenames" in result:
        # per-image score log (helpers.py:102-105, 363-365 scores.txt parity)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "scores.txt"), "w") as f:
            for name, split, s_ssim, s_mse, s_psnr in zip(
                    result["filenames"], result["splits"],
                    result["scores_ssim"], result["scores_mse"],
                    result["scores_psnr"]):
                f.write(f"{split}/{name}\tssim_score={s_ssim:.6f}\t"
                        f"mse={s_mse:.6f}\tpsnr={s_psnr:.4f}\n")
    return result


if __name__ == "__main__":
    main()
