"""Scratch-teacher distillation for EfficientAD, the port of
``adsr_tpu/train/distill.py``.

The reference needs pretrained PDN teacher weights (src/efficientAD.py:
429-444), which no one ships here. This distils the teacher from a FROZEN
RANDOM feature oracle instead: a random medium PDN (wider and deeper than
the small teacher, the same output geometry), channel-normalised by one
statistics pass over the train images, regressed by the teacher over
flipped and rotated train images. The AUC it gives does not match the
reference's pretrained-teacher numbers.

The networks run in f32 with TF32 off on ``device`` (the card unless the
caller asks for the CPU). The batch indices come from
``np.random.RandomState(seed + 1)``, the same stream as the JAX package's;
the width flip and the 180-degree rotation (each p = 0.5 per image) from a
``torch.Generator``: the same distributions as ``jax.random``'s, not the
same bits.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from adsr_tpu_torch.core.device import full_f32, resolve_device
from adsr_tpu_torch.models.efficientad import PDN, init_efficientad_
from adsr_tpu_torch.train.efficientad import normalize_imagenet


def augment(x: torch.Tensor, flip: torch.Tensor,
            rot: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] images: those where ``flip`` is true mirrored along the
    width, then those where ``rot`` is true rotated by 180 degrees."""
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    return torch.where(rot[:, None, None, None], x.flip(1, 2), x)


def distill_teacher(out_channels: int, model_size: str,
                    train_imgs: np.ndarray, steps: int = 2000,
                    batch: int = 8, lr: float = 1e-3, seed: int = 0,
                    log: Callable = print, device="cuda"
                    ) -> Tuple[Dict[str, torch.Tensor], float]:
    """Distil a ``model_size`` PDN teacher from a frozen random medium-PDN
    oracle over ``train_imgs`` ([N, H, W, 3] float32 in [0, 1]).

    Returns (the teacher's ``state_dict``, the last step's loss). The
    oracle's features are channel-normalised so the teacher regresses O(1)
    targets; the trainer's ``teacher_normalization`` then standardises the
    teacher's own outputs, as with loaded weights."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    oracle = init_efficientad_(PDN(out_channels, "medium"), gen).to(dev)
    teacher = init_efficientad_(PDN(out_channels, model_size), gen).to(dev)
    oracle.requires_grad_(False)
    imgs = torch.as_tensor(train_imgs, dtype=torch.float32, device=dev)

    def nchw(x):
        return normalize_imagenet(x).permute(0, 3, 1, 2)

    with full_f32(), torch.no_grad():
        # channel statistics of the oracle's features over the train set
        sums = sqs = 0.0
        count = 0
        for i in range(0, len(imgs), batch):
            f = oracle(nchw(imgs[i:i + batch]))
            sums = sums + f.sum(dim=(0, 2, 3))
            sqs = sqs + (f * f).sum(dim=(0, 2, 3))
            count += f.shape[0] * f.shape[2] * f.shape[3]
        mean = sums / count
        std = torch.sqrt(torch.clamp(sqs / count - mean * mean, min=1e-12))
        mean, std = mean[None, :, None, None], std[None, :, None, None]

    opt = torch.optim.Adam(teacher.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    data_rng = np.random.RandomState(seed + 1)
    loss = float("nan")
    for it in range(steps):
        idx = torch.from_numpy(data_rng.randint(0, len(imgs), batch))
        flip = torch.rand(batch, generator=gen) < 0.5
        rot = torch.rand(batch, generator=gen) < 0.5
        x = nchw(augment(imgs[idx.to(dev)], flip.to(dev), rot.to(dev)))
        with full_f32():
            with torch.no_grad():
                target = (oracle(x) - mean) / std
            loss_dev = ((teacher(x) - target) ** 2).mean()
            opt.zero_grad(set_to_none=True)
            loss_dev.backward()
            opt.step()
        if it % max(steps // 10, 1) == 0:
            loss = float(loss_dev.detach())
            log(f"[distill {it}/{steps}] feature-regression MSE {loss:.4f}")
    if steps:
        loss = float(loss_dev.detach())
    return {k: v.detach() for k, v in teacher.state_dict().items()}, loss
