"""EfficientAD entry point, the port of ``adsr_tpu/cli/efficientad.py``
(reference src/efficientAD.py:352-659):

    python -m adsr_tpu_torch.cli.efficientad --dataset-path data/mvtec \
        --subdataset grid --train-steps 1000 --teacher scratch

The JAX CLI's flow: a seeded 90/10 train/val split, random batches from
``RandomState(seed + 1)``, teacher channel normalisation, the hard-feature,
autoencoder and student-autoencoder losses, an AUC evaluation every
``--eval-every`` steps after ``--eval-after`` with plateau early stopping,
then map normalisation, the final AUC and the threshold metrics in
``final_metrics.json``. The teacher comes from ``--teacher-weights`` (a
``.pt`` / ``.pth`` state_dict in the reference's names), from
``--teacher scratch`` (distilled from a frozen random oracle,
``train/distill.py``) or starts random (flagged: the reference's AUC numbers
assume a pretrained teacher). Checkpoints are ``.pt`` state_dicts at the
JAX package's stems (``teacher_distilled.pt``, ``student_tmp.pt``,
``autoencoder_tmp.pt``, ``{teacher,student,autoencoder}_final.pt``) under
``--output-dir/<subdataset>_<train-steps>``. The dataset's images are PNG
files. ``--device cuda`` (the default) runs on the card and fails without
one; ``--device cpu`` runs on the CPU. Nothing falls back.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from adsr_tpu_torch.core.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EfficientAD baseline")
    p.add_argument("--dataset-path", type=str, default="data/mvtec")
    p.add_argument("--subdataset", type=str, default="grid")
    p.add_argument("--train-steps", type=int, default=70000)
    p.add_argument("--batch-size", type=int, default=12)
    p.add_argument("--model-size", type=str, default="small",
                   choices=["small", "medium"])
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--teacher-weights", type=str, default="",
                   help="a .pt / .pth teacher state_dict in the reference's "
                        "names")
    p.add_argument("--teacher", type=str, default="auto",
                   choices=["auto", "random", "scratch"],
                   help="teacher source: 'auto' = --teacher-weights if "
                        "given else random-init; 'scratch' = distill the "
                        "teacher from a frozen random feature oracle over "
                        "the train images (train/distill.py), AUC caveat "
                        "applies (the reference requires pretrained "
                        "weights, src/efficientAD.py:429-444)")
    p.add_argument("--distill-steps", type=int, default=2000,
                   help="feature-regression steps for --teacher scratch")
    p.add_argument("--imagenet-train-path", type=str, default="none",
                   help="folder of ImageNet(-like) PNG images for the "
                        "optional pretraining penalty; 'none' disables it "
                        "(reference efficientAD.py:362-364). A "
                        "deterministic sample of --penalty-max-images files "
                        "is decoded into a device-resident float32 pool "
                        "(~0.75 MB per 256px image)")
    p.add_argument("--penalty-max-images", type=int, default=4096,
                   help="cap on decoded penalty images (<=0 = no cap)")
    p.add_argument("--output-dir", type=str,
                   default="workspace/experiment/efficientad")
    p.add_argument("--patience", type=int, default=3)
    p.add_argument("--min-delta", type=float, default=0.004)
    p.add_argument("--eval-after", type=int, default=700)
    p.add_argument("--eval-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda (default) runs on the card; cpu on the CPU. "
                        "Nothing falls back.")
    p.add_argument("--group-div", type=int, default=0,
                   help="patch-grouped part scoring (GKD workflow, "
                        "efficientAD.py:218-290); 0 = per-image scoring")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    dev = resolve_device(args.device)

    from adsr_tpu_torch.io.journal import save_state_dict
    from adsr_tpu_torch.train.efficientad import (
        EADConfig, EarlyStopping, EfficientADTrainer, StepDraws,
        final_metrics, load_image_folder, load_penalty_folder)

    pretrain_penalty = args.imagenet_train_path != "none"
    cfg = EADConfig(train_steps=args.train_steps, batch_size=args.batch_size,
                    model_size=args.model_size, image_size=args.image_size,
                    patience=args.patience, min_delta=args.min_delta,
                    eval_after=args.eval_after, eval_every=args.eval_every,
                    seed=args.seed, pretrain_penalty=pretrain_penalty)
    out_dir = Path(args.output_dir) / f"{args.subdataset}_{args.train_steps}"
    out_dir.mkdir(parents=True, exist_ok=True)

    root = Path(args.dataset_path) / args.subdataset
    train_imgs, _, _ = load_image_folder(str(root / "train"), cfg.image_size)
    test_imgs, test_labels, test_paths = load_image_folder(
        str(root / "test"), cfg.image_size)
    # 90/10 train/val split, seeded (efficientAD.py:384-392)
    rng = np.random.RandomState(cfg.seed)
    perm = rng.permutation(len(train_imgs))
    n_val = max(1, len(train_imgs) - int(0.9 * len(train_imgs)))
    val_imgs = train_imgs[perm[:n_val]]
    tr_imgs = train_imgs[perm[n_val:]]
    print(f"train={len(tr_imgs)} val={len(val_imgs)} test={len(test_imgs)} "
          f"device={dev}")

    trainer = EfficientADTrainer(cfg, device=dev)
    if args.teacher == "scratch":
        from adsr_tpu_torch.train.distill import distill_teacher
        print(f"Distilling scratch teacher ({args.distill_steps} steps, "
              "frozen random medium-PDN oracle)...")
        teacher_sd, dloss = distill_teacher(
            cfg.out_channels, cfg.model_size, tr_imgs,
            steps=args.distill_steps, seed=cfg.seed, device=dev)
        trainer.teacher.load_state_dict(teacher_sd)
        save_state_dict(out_dir / "teacher_distilled.pt", teacher_sd)
        print(f"Distilled teacher saved (final MSE {dloss:.4f}). NOTE: "
              "scratch-distilled (random-oracle) teacher — AUC will not "
              "match the reference's pretrained-teacher numbers")
    elif args.teacher_weights and os.path.isfile(args.teacher_weights):
        trainer.load_teacher(args.teacher_weights)
    else:
        print("WARNING: no pretrained teacher weights — random-init teacher "
              "(use --teacher scratch for a distilled zero-artifact "
              "substitute); AUC will not match the reference's "
              "pretrained-teacher numbers")

    print("Computing teacher channel normalization...")
    trainer.teacher_normalization(tr_imgs)

    stopper = EarlyStopping(cfg.patience, cfg.min_delta)
    data_rng = np.random.RandomState(cfg.seed + 1)
    gen = torch.Generator().manual_seed(cfg.seed + 2)
    tr_dev = torch.as_tensor(tr_imgs, device=dev)

    penalty_imgs = None
    if pretrain_penalty:
        penalty_imgs = torch.as_tensor(load_penalty_folder(
            args.imagenet_train_path, cfg.image_size,
            max_images=args.penalty_max_images, seed=cfg.seed), device=dev)
        print(f"pretraining penalty on ({len(penalty_imgs)} images)")

    def score():
        q = trainer.map_normalization(val_imgs)
        if args.group_div:
            return trainer.test_auc_grouped(test_imgs, test_labels,
                                            test_paths, q, args.group_div)
        return trainer.test_auc(test_imgs, test_labels, q)

    t0 = time.time()
    for step in range(cfg.train_steps):
        idx = torch.from_numpy(data_rng.randint(0, len(tr_imgs),
                                                cfg.batch_size))
        batch = tr_dev[idx.to(dev)]
        pen = None
        if penalty_imgs is not None:
            pidx = torch.from_numpy(data_rng.randint(0, len(penalty_imgs),
                                                     cfg.batch_size))
            pen = penalty_imgs[pidx.to(dev)]
        draws = StepDraws.sample(cfg.batch_size, gen, penalty=pen is not None)
        metrics = trainer.train_step(batch, batch, draws, pen)
        if step % 1000 == 0:
            print(f"[{step}/{cfg.train_steps}] loss={metrics['total']:.4f} "
                  f"(hard={metrics['hard']:.4f} ae={metrics['ae']:.4f} "
                  f"stae={metrics['stae']:.4f})")
            save_state_dict(out_dir / "student_tmp.pt",
                            trainer.student.state_dict())
            save_state_dict(out_dir / "autoencoder_tmp.pt",
                            trainer.autoencoder.state_dict())
        if step % cfg.eval_every == 0 and step > cfg.eval_after:
            auc, _, _ = score()
            print(f"Current AUC: {auc:.4f}")
            if stopper.should_stop(auc):
                print(f"Early stopping triggered at iteration {step}")
                break

    for name, module in (("teacher", trainer.teacher),
                         ("student", trainer.student),
                         ("autoencoder", trainer.autoencoder)):
        save_state_dict(out_dir / f"{name}_final.pt", module.state_dict())

    auc, y_true, y_score = score()
    print(f"Final image auc: {auc:.2f}")
    fm = final_metrics(y_true, y_score)
    for k in ("threshold", "accuracy", "precision", "recall", "f1"):
        print(f"{k.capitalize()}: {fm[k]:.2f}")
    with open(out_dir / "final_metrics.json", "w") as f:
        json.dump({"auc": auc, **fm,
                   "train_time_h": (time.time() - t0) / 3600}, f)
    return auc


if __name__ == "__main__":
    main()
