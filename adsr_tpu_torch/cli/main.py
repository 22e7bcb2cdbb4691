"""Train entry point, the port of ``adsr_tpu/cli/main.py`` (the reference's
flag surface, src/main.py:207-241):

    python -m adsr_tpu_torch.cli.main --model-type drct --classe grid \
        --resolution 128 --scale 4 --epochs 2 --batch-size 16

Writes a run dir (``io/journal.py``): log, config dump, per-epoch metrics,
``model_latest.pt`` / ``model_best.pt`` and the full train state every
``--ckpt-every`` epochs, for ``--resume``. SIGTERM / SIGINT finish the epoch,
checkpoint and stop resumable. After training, the model is tested on
``val/good`` (PSNR/SSIM). Runs on the card (``--device cuda``, the default)
or, for small configurations, on the CPU with the plain PyTorch path.

DRCT only: ``--model-type drn-l`` (ROADMAP.md Queue 1 item 10), ``--dp`` /
``--tp`` > 1 (Queue 1 item 11) and ``--remat-policy dots`` (Queue 1 item 9)
raise ``NotImplementedError``. ``--workers`` is accepted and ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import time
from typing import List, Optional

import torch

from adsr_tpu_torch.core.config import Experiment, MeshConfig, drct_experiment
from adsr_tpu_torch.core.device import resolve_device

PRETRAINED = "workspace/pretrained_model_weights/drct_latest.pt"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    pre_args, _ = pre.parse_known_args(argv)

    p = argparse.ArgumentParser(description="Training/Evaluation entrypoint",
                                parents=[pre])
    p.add_argument("--model-type", type=str, default="drct",
                   choices=["drct", "drn-l"])
    p.add_argument("--dataset", type=str, default="mvtec",
                   choices=["mvtec", "gkd", "gkd_large"])
    p.add_argument("--classe", type=str, default="grid")
    p.add_argument("--scale", type=int, default=4, choices=[2, 4, 8])
    p.add_argument("--resolution", type=int, default=128,
                   choices=[32, 64, 128, 256, 512])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda (default) runs the hand-written kernels; cpu "
                        "runs the plain PyTorch path. Nothing falls back.")
    p.add_argument("--data-root", type=str, default="auto")
    p.add_argument("--save-dir", type=str, default="./workspace/experiment")
    p.add_argument("--pretrain", action="store_true",
                   help=f"start from {PRETRAINED} (a reference .pt)")
    p.add_argument("--test-only", action="store_true")
    p.add_argument("--workers", type=int, default=0)  # compat; unused
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["bf16", "fp32"],
                   help="bf16 (default): the card's kernels are bf16 only "
                        "(fp32 kernels are ROADMAP.md Queue 1 item 8); fp32 "
                        "runs on the CPU")
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="resume params+optimizer+step from the run dir")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="epochs between full-train-state checkpoints "
                        "(0 = end of training only)")
    p.add_argument("--run-tag", type=str, default=None)
    p.add_argument("--embed-dim", type=int, default=180)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-heads", type=int, default=6)
    p.add_argument("--remat-policy", type=str, default="full",
                   choices=["full", "dots"],
                   help="backward recompute granularity: 'full' (each RDG "
                        "recomputes from its saved concat buffer)")

    if pre_args.config is not None and os.path.isfile(pre_args.config):
        import yaml
        with open(pre_args.config) as f:
            cfg = yaml.safe_load(f) or {}
        p.set_defaults(**{k.replace("-", "_"): v for k, v in cfg.items()})

    return p.parse_args(argv)


def build_experiment(args: argparse.Namespace) -> Experiment:
    if args.model_type == "drn-l":
        raise NotImplementedError(
            "--model-type drn-l: DRN-L waits for ROADMAP.md Queue 1 item 10 "
            "(DRN-L with dual models)")
    if args.dp > 1 or args.tp > 1:
        raise NotImplementedError(
            f"--dp {args.dp} --tp {args.tp}: the port trains on one card; "
            "data parallel is ROADMAP.md Queue 1 item 11")
    if args.remat_policy != "full":
        raise NotImplementedError(
            f"--remat-policy {args.remat_policy}: ROADMAP.md Queue 1 item 9 "
            "(the port's backward recomputes each RDG from its concat)")
    pre = PRETRAINED if args.pretrain else "."
    exp = drct_experiment(
        dataset=args.dataset, classe=args.classe, resolution=args.resolution,
        scale=args.scale, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, data_root=args.data_root, save_dir=args.save_dir,
        no_augment=args.no_augment, seed=args.seed,
        mesh=MeshConfig(dp=args.dp, tp=args.tp), precision=args.precision,
        run_tag=args.run_tag, pre_train=pre, embed_dim=args.embed_dim,
        num_layers=args.num_layers, num_heads=args.num_heads,
        remat_policy=args.remat_policy)
    exp = dataclasses.replace(exp, ckpt_every=args.ckpt_every)
    if args.test_only:
        exp = dataclasses.replace(exp, test_only=True)
    return exp


def _device_summary(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def train(exp: Experiment, resume: bool = False, device="cuda") -> str:
    """Train ``exp`` into its run dir; returns the run dir."""
    from adsr_tpu_torch.data.pipeline import load_sr_dataset
    from adsr_tpu_torch.io.journal import Journal, load_state_dict
    from adsr_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device)
    journal = Journal(exp)
    journal.write_log(f"Using devices: {_device_summary(dev)}")

    train_ds = None
    if not exp.test_only:
        train_ds = load_sr_dataset(exp.data.data_dir, exp.data.scale,
                                   exp.data.n_colors, exp.data.rgb_range)
    trainer = Trainer(exp, train_ds, None, journal=journal, device=dev)
    n_params = sum(p.numel() for p in trainer.state.model.parameters())
    journal.write_log(f"The number of parameters is {n_params / 1e6:.2f}M")

    if exp.pre_train != "." and os.path.isfile(exp.pre_train):
        journal.write_log(f"Loading model from {exp.pre_train}")
        trainer.state.model.load_state_dict(load_state_dict(exp.pre_train,
                                                            dev))
    if resume:
        try:
            trainer.load_train_state()
            journal.write_log(f"Resumed at step {trainer.state.step} "
                              f"(epoch {trainer.epoch})")
        except FileNotFoundError:
            journal.write_log("No train state to resume; starting fresh")

    # preemption: SIGTERM/SIGINT finish the current epoch, save the full
    # train state and exit resumable
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        preempted["flag"] = True
        journal.write_log(f"Signal {signum}: will checkpoint and stop after "
                          "this epoch")

    old_handlers = {s: signal.signal(s, _on_signal)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        ck = exp.ckpt_every
        start = time.time()
        while not trainer.terminate():
            trainer.train_one_epoch()
            if (ck and trainer.epoch % ck == 0) or preempted["flag"]:
                trainer.save_train_state()
            journal.log_metrics({"epoch": trainer.epoch,
                                 "step": trainer.state.step,
                                 **trainer.loss_history[-1]})
            if preempted["flag"]:
                journal.write_log("Preempted: state saved; resume with "
                                  "--resume")
                journal.done()
                return str(journal.dir)
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    journal.write_log(
        f"Total Training Time: {(time.time() - start) / 3600:.2f}")

    # post-train PSNR/SSIM eval on val/good (src/main.py:317-332, 368-383)
    try:
        val_dir = f"{exp.data.data_root}/{exp.data.classe}/val/good"
        val_ds = load_sr_dataset(val_dir, exp.data.scale, exp.data.n_colors,
                                 exp.data.rgb_range)
        trainer.exp = dataclasses.replace(
            exp, data=dataclasses.replace(exp.data, data_test="mvtec_val_good"))
        trainer.test(val_ds,
                     save_results_fn=(
                         lambda name, sr: journal.save_result_image(
                             name, sr, max(exp.data.scale), "mvtec_val_good"))
                     if exp.save_results else None)
    except Exception as e:  # parity: evaluation failures are non-fatal
        journal.write_log(f"Evaluation skipped due to error: {e}")

    journal.write_log("Skipping anomaly AUC on validation (good-only split)")
    journal.save(trainer, is_best=True)
    journal.done()
    return str(journal.dir)


def main(argv: Optional[List[str]] = None) -> str:
    args = parse_args(argv)
    print(f"Model: {args.model_type}")
    print(f"Dataset: {args.dataset}")
    print(f"Class: {args.classe}")
    print(f"Resolution: {args.resolution}")
    print(f"Scale: {args.scale}")
    exp = build_experiment(args)
    return train(exp, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
