"""Train entry point, the port of ``adsr_tpu/cli/main.py`` (the reference's
flag surface, src/main.py:207-241):

    python -m adsr_tpu_torch.cli.main --model-type drct --classe grid \
        --resolution 128 --scale 4 --epochs 2 --batch-size 16
    python -m adsr_tpu_torch.cli.main --model-type drn-l --classe carpet \
        --resolution 128 --scale 4 --epochs 2 --batch-size 16

Writes a run dir (``io/journal.py``): log, config dump, per-epoch metrics,
``model_latest.pt`` / ``model_best.pt`` (DRN-L: ``dual_model_latest.pt`` /
``dual_model_best.pt`` too) and the full train state every
``--ckpt-every`` epochs, for ``--resume``. SIGTERM / SIGINT finish the epoch,
checkpoint and stop resumable. After training, the model is tested on
``val/good`` (PSNR/SSIM). Runs on the card (``--device cuda``, the default)
or, for small configurations, on the CPU with the plain PyTorch path.
DRCT trains through the card's kernels in bf16, or with ``--precision
fp32`` through their f32 instances, the head and tail convs in f32 with
TF32 off; ``--device cuda`` on a machine without a card fails before any
data is read and never falls back to the CPU. DRN-L (``drn_experiment``)
through cuDNN convolutions in bf16 or, with ``--precision fp32``, in f32
with TF32 off; ``--n-blocks`` / ``--n-feats`` shrink it for a small CPU run.
``--pretrain`` starts from ``workspace/pretrained_model_weights/``
(``drct_latest.pt``; ``DRNL{s}x.pt`` and ``DRNL{s}x_dual.pt``, reference
``.pt`` files, read when present).

``--dp`` / ``--tp`` > 1 (and ``MeshConfig.dcn``) train over a device mesh
(``core/mesh.py``): under ``torchrun`` (``WORLD_SIZE`` in the environment)
each process joins its group, otherwise this command spawns dcn * dp * tp
ranks itself (``parallel/launch.py``), over NCCL on the cards (``cuda:0``,
``cuda:1``, ...) or gloo with ``--device cpu``. The batch is split over the
data ranks (the batch size must divide by dcn * dp), DRCT's heads and MLP
width over the tp ranks; rank 0 writes the run dir, in the same layout as
one card's. ``--remat-policy dots`` (ROADMAP.md Queue 1 item 9) raises
``NotImplementedError``. ``--workers`` is accepted and ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import time
from typing import List, Optional

from pathlib import Path

import torch
import torch.distributed as dist

from adsr_tpu_torch.core.config import (Experiment, MeshConfig,
                                        drct_experiment, drn_experiment)
from adsr_tpu_torch.core.device import resolve_device
from adsr_tpu_torch.core.mesh import (Mesh, explicit_mesh, make_mesh,
                                      mesh_layout)
from adsr_tpu_torch.parallel.launch import (TRAIN_GROUP_TIMEOUT,
                                            join_torchrun, run_ranks,
                                            under_torchrun)

PRETRAINED_DIR = "workspace/pretrained_model_weights"
PRETRAINED = f"{PRETRAINED_DIR}/drct_latest.pt"


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
                   help=f"start from {PRETRAINED} (DRN-L: DRNL<s>x.pt and "
                        "DRNL<s>x_dual.pt there; reference .pt files)")
    p.add_argument("--test-only", action="store_true")
    p.add_argument("--workers", type=int, default=0)  # compat; unused
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["bf16", "fp32"],
                   help="bf16 (default) or fp32: DRCT trains on the card "
                        "through the kernels' bf16 or f32 instances, on the "
                        "CPU through the plain path; DRN-L through cuDNN "
                        "(fp32 with TF32 off)")
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
    p.add_argument("--n-blocks", type=int, default=None,
                   help="DRN-L RCABs an up phase (default: the scale's "
                        "table, 40 at x4)")
    p.add_argument("--n-feats", type=int, default=None,
                   help="DRN-L base width (default: the scale's table, 20 "
                        "at x4)")

    if pre_args.config is not None and os.path.isfile(pre_args.config):
        import yaml
        with open(pre_args.config) as f:
            cfg = yaml.safe_load(f) or {}
        p.set_defaults(**{k.replace("-", "_"): v for k, v in cfg.items()})

    return p.parse_args(argv)


def build_experiment(args: argparse.Namespace) -> Experiment:
    if args.dp > 1 and args.batch_size % args.dp:
        raise ValueError(
            f"--batch-size {args.batch_size} does not divide by the mesh's "
            f"{args.dp} data ranks (--dp)")
    if args.remat_policy != "full":
        raise NotImplementedError(
            f"--remat-policy {args.remat_policy}: ROADMAP.md Queue 1 item 9 "
            "(the port's backward recomputes each RDG from its concat)")
    common = dict(
        dataset=args.dataset, classe=args.classe, resolution=args.resolution,
        scale=args.scale, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, data_root=args.data_root, save_dir=args.save_dir,
        no_augment=args.no_augment, seed=args.seed,
        mesh=MeshConfig(dp=args.dp, tp=args.tp), precision=args.precision,
        run_tag=args.run_tag)
    if args.model_type == "drn-l":
        pre = f"{PRETRAINED_DIR}/DRNL{args.scale}x"
        exp = drn_experiment(
            pre_train=f"{pre}.pt" if args.pretrain else ".",
            pre_train_dual=f"{pre}_dual.pt" if args.pretrain else ".",
            n_blocks=args.n_blocks, n_feats=args.n_feats, **common)
    else:
        exp = drct_experiment(
            pre_train=PRETRAINED if args.pretrain else ".",
            embed_dim=args.embed_dim, num_layers=args.num_layers,
            num_heads=args.num_heads, remat_policy=args.remat_policy,
            **common)
    exp = dataclasses.replace(exp, ckpt_every=args.ckpt_every)
    if args.test_only:
        exp = dataclasses.replace(exp, test_only=True)
    return exp


def _device_summary(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def train(exp: Experiment, resume: bool = False, device="cuda",
          mesh: Optional[Mesh] = None) -> str:
    """Train ``exp`` into its run dir; returns the run dir. On a ``mesh``
    every rank calls it and rank 0 alone writes the run dir."""
    from adsr_tpu_torch.data.pipeline import load_sr_dataset
    from adsr_tpu_torch.io.journal import Journal, load_state_dict
    from adsr_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device if mesh is None else mesh.device)
    journal = Journal(exp) if mesh is None or mesh.rank == 0 else None

    def log(msg: str) -> None:
        if journal is not None:
            journal.write_log(msg)

    summary = _device_summary(dev)
    if mesh is not None:
        summary += (f" x {mesh.world_size} ranks, mesh "
                    f"{mesh.layout} over {mesh.backend}")
    log(f"Using devices: {summary}")

    train_ds = None
    if not exp.test_only:
        train_ds = load_sr_dataset(exp.data.data_dir, exp.data.scale,
                                   exp.data.n_colors, exp.data.rgb_range)
    trainer = Trainer(exp, train_ds, None, journal=journal, device=dev,
                      mesh=mesh)
    state = trainer.state
    n_params = sum(v.numel() for v in trainer.model_state_dict().values())
    if state.duals is not None:
        n_params += sum(p.numel() for p in state.duals.parameters())
    log(f"The number of parameters is {n_params / 1e6:.2f}M")

    if exp.pre_train != "." and os.path.isfile(exp.pre_train):
        log(f"Loading model from {exp.pre_train}")
        trainer.load_model_state_dict(load_state_dict(exp.pre_train, dev))
    if (exp.pre_train_dual != "." and os.path.isfile(exp.pre_train_dual)
            and state.duals is not None):
        # the reference's dual_model_*.pt: a list of state_dicts
        log(f"Loading dual model from {exp.pre_train_dual}")
        for dual, sd in zip(state.duals,
                            load_state_dict(exp.pre_train_dual, dev)):
            dual.load_state_dict(sd)
    if resume:
        if mesh is not None:
            mesh.barrier()      # rank 0 made the run dir
        try:
            trainer.load_train_state()
            log(f"Resumed at step {trainer.state.step} "
                f"(epoch {trainer.epoch})")
        except FileNotFoundError:
            log("No train state to resume; starting fresh")

    # preemption: SIGTERM/SIGINT finish the current epoch, save the full
    # train state and exit resumable
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        preempted["flag"] = True
        log(f"Signal {signum}: will checkpoint and stop after this epoch")

    old_handlers = {s: signal.signal(s, _on_signal)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        ck = exp.ckpt_every
        start = time.time()
        while not trainer.terminate():
            trainer.train_one_epoch()
            if mesh is not None:     # every rank stops after the same epoch
                preempted["flag"] = mesh.any(preempted["flag"])
            if (ck and trainer.epoch % ck == 0) or preempted["flag"]:
                trainer.save_train_state()
            if journal is not None:
                journal.log_metrics({"epoch": trainer.epoch,
                                     "step": trainer.state.step,
                                     **trainer.loss_history[-1]})
            if preempted["flag"]:
                log("Preempted: state saved; resume with --resume")
                if journal is not None:
                    journal.done()
                return str(Path(exp.save))
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    log(f"Total Training Time: {(time.time() - start) / 3600:.2f}")

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
                     if exp.save_results and journal is not None else None)
    except Exception as e:  # parity: evaluation failures are non-fatal
        log(f"Evaluation skipped due to error: {e}")

    log("Skipping anomaly AUC on validation (good-only split)")
    full = trainer.checkpoint_state()
    if journal is not None:
        journal.save(trainer, is_best=True, state=full)
        journal.done()
    return str(Path(exp.save))


def mesh_world(cfg: MeshConfig, device: str) -> int:
    """The ranks this command trains on: on the cards, every card
    (``mesh_layout`` raises when the sizes do not cover them, as the JAX
    mesh does); on the CPU, dcn * dp * tp with dp = -1 as one."""
    if torch.device(device).type == "cpu":
        return max(1, cfg.dcn) * max(1, cfg.dp) * max(1, cfg.tp)
    mesh_layout(cfg, torch.cuda.device_count())
    return torch.cuda.device_count()


def train_rank(exp: Experiment, resume: bool, device: str) -> str:
    """One rank's part of ``train`` on the initialised process group: its
    mesh (``cuda:<local rank>``, or the CPU) and the epochs."""
    devices = ["cpu"] * dist.get_world_size() \
        if torch.device(device).type == "cpu" else None
    mesh = make_mesh(exp.mesh, devices=devices)
    return train(exp, resume, mesh.device, mesh)


def _spawned_rank(rank: int, exp: Experiment, resume: bool,
                  device: str) -> str:
    return train_rank(exp, resume, device)


def main(argv: Optional[List[str]] = None) -> str:
    args = parse_args(argv)
    print(f"Model: {args.model_type}")
    print(f"Dataset: {args.dataset}")
    print(f"Class: {args.classe}")
    print(f"Resolution: {args.resolution}")
    print(f"Scale: {args.scale}")
    exp = build_experiment(args)
    from adsr_tpu_torch.train.trainer import check_training_precision
    check_training_precision(exp, torch.device(args.device))
    resolve_device(args.device)    # no card: fail here, before any data
    if under_torchrun():
        dev = join_torchrun(args.device)
        # one run dir for every rank: rank 0's timestamped path
        box = [exp]
        dist.broadcast_object_list(box, src=0)
        try:
            return train_rank(box[0], args.resume, dev)
        finally:
            dist.destroy_process_group()
    if explicit_mesh(exp.mesh):
        world = mesh_world(exp.mesh, args.device)
        devices = ["cpu"] * world if args.device == "cpu" \
            else [f"cuda:{i}" for i in range(world)]
        # a training run has no deadline; SIGTERM / SIGINT reach every
        # rank, which checkpoints after its epoch and stops resumable
        return run_ranks(_spawned_rank, world, devices, None, exp,
                         args.resume, args.device, timeout=None,
                         group_timeout=TRAIN_GROUP_TIMEOUT)[0]
    return train(exp, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
