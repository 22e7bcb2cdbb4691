"""EfficientAD student-teacher training, the port of
``adsr_tpu/train/efficientad.py`` (reference src/efficientAD.py):

- data: a raw MVTec-style tree (``train/good``, ``test/<defect>``) of PNG
  files, each converted to RGB and resized to the image size with Pillow's
  BILINEAR filter (``data/prepare.py`` ``resize_bilinear``, byte for byte),
  then divided by 255 in f32; ImageNet normalisation on the device. The
  port reads PNG only (``io/png.py``: the card's machine has no PIL); any
  other image file raises an error that names it;
- the autoencoder branch sees a colour-jittered copy: per image one of
  brightness / contrast / saturation with a factor in [0.8, 1.2)
  (efficientAD.py:694-698); the penalty images a per-image
  RandomGrayscale(0.3). Each is a draw from a ``torch.Generator``
  (:class:`StepDraws`) and a pure function of the images and the draws, so
  a test can feed it ``jax.random``'s draws;
- teacher channel normalisation: the mean of per-batch channel means, then
  the mean of per-batch mean squared deviations from it
  (efficientAD.py:152-178; a short last batch weighs as much as a full
  one);
- the step (efficientAD.py:460-496): the hard-feature loss over the
  elements at or above the 0.999 quantile of (teacher - student)^2, the
  optional penalty (student features on out-of-domain images pushed to
  zero), the autoencoder and student-autoencoder losses; one
  ``torch.optim.Adam(weight_decay=1e-5)`` over student and autoencoder
  (coupled L2, eps 1e-8: optax's ``add_decayed_weights`` then
  ``scale_by_adam``), the learning rate x0.1 from step
  ``int(0.95 * train_steps)``;
- map normalisation from the 0.9 / 0.995 quantiles of validation maps
  (efficientAD.py:311-333); combined map 0.5 st + 0.5 ae; image score its
  max; AUC-plateau early stopping and the threshold metrics
  (efficientAD.py:335-350, 644-659).

The quantile of the hard loss is :func:`hard_quantile`, not
``torch.quantile``, which refuses inputs above 2^24 elements (batch 16 at
256 px has 19.3M). Every network runs in f32 with TF32 off
(``core/device.py`` ``full_f32``): the JAX package's EfficientAD is f32
only. The autoencoder stays in eval mode (its dropout off), as the JAX
package applies it with ``deterministic=True`` in training and scoring.

Images cross the API as [N, H, W, 3] float arrays in [0, 1] (numpy or
tensors), as in the JAX package; the networks run NCHW.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from adsr_tpu_torch.core.device import full_f32, resolve_device
from adsr_tpu_torch.data.prepare import resize_bilinear
from adsr_tpu_torch.eval.auc import min_distance_threshold, roc_auc
from adsr_tpu_torch.io.journal import load_state_dict
from adsr_tpu_torch.io.png import read_png_rgb
from adsr_tpu_torch.models.efficientad import (PDN, Autoencoder,
                                               init_efficientad_)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)
HARD_QUANTILE = 0.999
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
PENALTY_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp")


@dataclasses.dataclass(frozen=True)
class EADConfig:
    train_steps: int = 70000
    batch_size: int = 12
    lr: float = 1e-4
    weight_decay: float = 1e-5
    out_channels: int = 384
    image_size: int = 256
    model_size: str = "small"
    patience: int = 3
    min_delta: float = 0.004
    eval_every: int = 10        # intermediate eval cadence after warmup
    eval_after: int = 700
    seed: int = 1
    # opt-in ImageNet pretraining penalty: student features on out-of-domain
    # images are pushed to zero (efficientAD.py:362-364, 475-480)
    pretrain_penalty: bool = False


# --------------------------------------------------------------------------- #
# Data
# --------------------------------------------------------------------------- #

def _read_resized(path: Path, size: int) -> np.ndarray:
    """A PNG as RGB, resized to ``size`` x ``size`` by Pillow's BILINEAR,
    [size, size, 3] float32 in [0, 1]."""
    if path.suffix.lower() != ".png":
        raise ValueError(f"{path}: the port reads PNG only (io/png.py); "
                         "convert the file to PNG")
    img = resize_bilinear(read_png_rgb(path), size, size)
    return img.astype(np.float32) / np.float32(255.0)


def load_image_folder(root: str, image_size: int
                      ) -> Tuple[np.ndarray, List[str], List[str]]:
    """Every image under root/<subdir>/ as [N, H, W, 3] float32 in [0, 1].

    Returns (images, subdir_labels, paths) sorted for determinism."""
    files = sorted(p for p in Path(root).glob("*/*")
                   if p.suffix.lower() in IMAGE_SUFFIXES)
    if not files:
        raise FileNotFoundError(f"no images under {root}/*/")
    imgs = [_read_resized(f, image_size) for f in files]
    return (np.stack(imgs), [f.parent.name for f in files],
            [str(f) for f in files])


def load_penalty_folder(root: str, image_size: int, max_images: int = 4096,
                        seed: int = 0) -> np.ndarray:
    """ImageNet-penalty images: Resize(2s) + CenterCrop(s)
    (efficientAD.py:402-410), [N, s, s, 3] float32; a deterministic sample
    of ``max_images`` files (the seeded permutation of the sorted list) is
    decoded, ``max_images <= 0`` decodes all. The per-draw
    RandomGrayscale(0.3) runs in the step (:func:`random_grayscale`)."""
    files = sorted(p for p in Path(root).rglob("*")
                   if p.suffix.lower() in PENALTY_SUFFIXES)
    if not files:
        raise FileNotFoundError(f"no penalty images under {root}")
    if max_images and max_images > 0 and len(files) > max_images:
        files = list(np.random.RandomState(seed)
                     .permutation(np.asarray(files, dtype=object))
                     [:max_images])
    s = image_size
    return np.stack([_read_resized(f, 2 * s)[s // 2:s // 2 + s,
                                             s // 2:s // 2 + s]
                     for f in files])


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] images in [0, 1] -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _gray(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H, W, 1] luma (0.299, 0.587, 0.114)."""
    w = torch.tensor(GRAY_WEIGHTS, dtype=x.dtype, device=x.device)
    return torch.tensordot(x, w, dims=([3], [0]))[..., None]


def color_jitter(x: torch.Tensor, choice: torch.Tensor,
                 factor: torch.Tensor) -> torch.Tensor:
    """Per image: brightness (``choice`` 0), contrast (1) or saturation (2)
    by ``factor``, clipped to [0, 1], on [B, H, W, 3] images in [0, 1]
    (efficientAD.py:694-698)."""
    f = factor.to(x)[:, None, None, None]
    gray = _gray(x)
    brightness = torch.clamp(x * f, 0.0, 1.0)
    mean_gray = gray.mean(dim=(1, 2, 3), keepdim=True)
    contrast = torch.clamp((x - mean_gray) * f + mean_gray, 0.0, 1.0)
    saturation = torch.clamp(gray + (x - gray) * f, 0.0, 1.0)
    c = choice.to(x.device)[:, None, None, None]
    return torch.where(c == 0, brightness,
                       torch.where(c == 1, contrast, saturation))


def random_grayscale(x: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
    """The images where ``pick`` is true replaced by their luma in all
    three channels (torchvision's RandomGrayscale, efficientAD.py:404-410)."""
    p = pick.to(x.device)[:, None, None, None]
    return torch.where(p, _gray(x).expand_as(x), x)


@dataclasses.dataclass
class StepDraws:
    """One step's random draws, made on the host: the jitter's ``choice``
    (int64 [B] in {0, 1, 2}) and ``factor`` (f32 [B] in [0.8, 1.2)), and
    the penalty's grayscale ``pick`` (bool [B], p = 0.3) or None."""
    choice: torch.Tensor
    factor: torch.Tensor
    pick: Optional[torch.Tensor] = None

    @classmethod
    def sample(cls, batch: int, generator: torch.Generator,
               penalty: bool = False, p_gray: float = 0.3) -> "StepDraws":
        choice = torch.randint(0, 3, (batch,), generator=generator)
        factor = 0.8 + 0.4 * torch.rand(batch, generator=generator)
        pick = (torch.rand(batch, generator=generator) < p_gray
                if penalty else None)
        return cls(choice, factor, pick)


def hard_quantile(d: torch.Tensor, q: float = HARD_QUANTILE) -> torch.Tensor:
    """``jnp.quantile(d.reshape(-1), q)`` (linear), detached, at any size:
    the two order statistics around the position from one ``topk`` of the
    largest elements, interpolated. The position ``q * (n - 1)`` and the
    weights are f32, as ``jnp.quantile`` computes them."""
    flat = d.detach().reshape(-1)
    n = flat.numel()
    pos = np.float32(q) * np.float32(n - 1)
    low = min(max(int(np.floor(pos)), 0), n - 1)
    high = min(max(int(np.ceil(pos)), 0), n - 1)
    high_w = np.float32(pos - np.float32(np.floor(pos)))
    low_w = np.float32(1.0) - high_w
    # the n - low largest elements, descending: position i ascending is
    # index n - 1 - i
    top = torch.topk(flat, n - low, largest=True, sorted=True).values
    return top[n - 1 - low] * float(low_w) + top[n - 1 - high] * float(high_w)


# --------------------------------------------------------------------------- #
# Trainer
# --------------------------------------------------------------------------- #

ImageBatch = Union[np.ndarray, torch.Tensor]


class EfficientADTrainer:
    """Teacher, student (twice the teacher's channels) and autoencoder on
    ``device`` (the card unless the caller asks for the CPU), initialised
    from ``torch.Generator().manual_seed(cfg.seed)`` in that order."""

    def __init__(self, cfg: EADConfig, log=print, device="cuda"):
        self.cfg = cfg
        self.log = log
        self.device = dev = resolve_device(device)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.teacher = init_efficientad_(
            PDN(cfg.out_channels, cfg.model_size), gen).to(dev).eval()
        self.student = init_efficientad_(
            PDN(2 * cfg.out_channels, cfg.model_size), gen).to(dev)
        self.autoencoder = init_efficientad_(
            Autoencoder(cfg.out_channels), gen).to(dev).eval()
        self.teacher.requires_grad_(False)
        self.optimizer = torch.optim.Adam(
            list(self.student.parameters())
            + list(self.autoencoder.parameters()),
            lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.step = 0
        c = cfg.out_channels
        self.teacher_mean = torch.zeros(1, c, 1, 1, device=dev)
        self.teacher_std = torch.ones(1, c, 1, 1, device=dev)

    # ------------------------------------------------------------------ #

    def load_teacher(self, path: str) -> None:
        """Teacher weights from a ``.pt`` / ``.pth`` state_dict in the
        reference's names (the port's own or a reference file)."""
        if Path(path).suffix.lower() not in (".pt", ".pth"):
            raise ValueError(
                f"{path}: the port reads teacher weights as a torch "
                ".pt / .pth state_dict in the reference's names; a flax "
                "msgpack file would need flax")
        self.teacher.load_state_dict(load_state_dict(path, self.device))
        self.log(f"Loaded teacher weights from {path}")

    def _nchw(self, img: ImageBatch) -> torch.Tensor:
        """[B, H, W, 3] images in [0, 1] -> normalised NCHW f32 on the
        device."""
        x = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        return normalize_imagenet(x).permute(0, 3, 1, 2)

    def _teacher_out(self, x: torch.Tensor) -> torch.Tensor:
        return (self.teacher(x) - self.teacher_mean) / self.teacher_std

    @torch.no_grad()
    def teacher_normalization(self, train_imgs: ImageBatch,
                              batch: int = 8) -> None:
        """Channel mean / std of teacher features over the train set
        (efficientAD.py:152-178)."""
        def outs():
            for i in range(0, len(train_imgs), batch):
                yield self.teacher(self._nchw(train_imgs[i:i + batch]))

        with full_f32():
            mean = torch.stack([o.mean(dim=(0, 2, 3)) for o in outs()]) \
                .mean(0)[None, :, None, None]
            dev = torch.stack([((o - mean) ** 2).mean(dim=(0, 2, 3))
                               for o in outs()]).mean(0)
        self.teacher_mean = mean
        self.teacher_std = torch.sqrt(dev)[None, :, None, None]

    def step_lr(self, step: int) -> float:
        cfg = self.cfg
        return cfg.lr * (0.1 if step >= int(0.95 * cfg.train_steps) else 1.0)

    def train_step(self, img_st: ImageBatch, img_ae: ImageBatch,
                   draws: StepDraws,
                   img_penalty: Optional[ImageBatch] = None
                   ) -> Dict[str, float]:
        """One step on the step's random ``draws`` (``pick`` set when there
        is a penalty batch). Returns the loss terms: total, hard, ae, stae
        (and penalty with a penalty batch)."""
        c = self.cfg.out_channels
        with full_f32():
            with torch.no_grad():
                t_st = self._teacher_out(self._nchw(img_st))
                ae_in = torch.as_tensor(img_ae, dtype=torch.float32,
                                        device=self.device)
                ae_in = self._nchw(color_jitter(ae_in, draws.choice,
                                                draws.factor))
                t_ae = self._teacher_out(ae_in)
                if img_penalty is not None:
                    pen = torch.as_tensor(img_penalty, dtype=torch.float32,
                                          device=self.device)
                    pen = self._nchw(random_grayscale(pen, draws.pick))

            d_st = (t_st - self.student(self._nchw(img_st))[:, :c]) ** 2
            # the gradient reaches the loss only through the mask's choice
            mask = d_st >= hard_quantile(d_st)
            loss_hard = torch.where(mask, d_st, 0.0).sum() \
                / mask.sum().clamp_min(1)
            metrics = {"hard": loss_hard}
            loss_st = loss_hard
            if img_penalty is not None:
                loss_penalty = (self.student(pen)[:, :c] ** 2).mean()
                loss_st = loss_hard + loss_penalty
                metrics["penalty"] = loss_penalty
            ae_out = self.autoencoder(ae_in)
            s_ae = self.student(ae_in)
            loss_ae = ((t_ae - ae_out) ** 2).mean()
            loss_stae = ((ae_out - s_ae[:, c:]) ** 2).mean()
            total = loss_st + loss_ae + loss_stae
            metrics.update(total=total, ae=loss_ae, stae=loss_stae)

            self.optimizer.zero_grad(set_to_none=True)
            total.backward()
            for group in self.optimizer.param_groups:
                group["lr"] = self.step_lr(self.step)
            self.optimizer.step()
        self.step += 1
        return {k: float(v.detach()) for k, v in metrics.items()}

    @torch.no_grad()
    def predict_maps(self, img: ImageBatch
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw st / ae maps [B, H', W'] of a batch (efficientAD.py:292-309)."""
        c = self.cfg.out_channels
        with full_f32():
            x = self._nchw(img)
            t_out = self._teacher_out(x)
            s_out = self.student(x)
            ae_out = self.autoencoder(x)
            map_st = ((t_out - s_out[:, :c]) ** 2).mean(dim=1)
            map_ae = ((ae_out - s_out[:, c:]) ** 2).mean(dim=1)
        return map_st, map_ae

    def map_normalization(self, val_imgs: ImageBatch, batch: int = 8
                          ) -> Tuple[float, float, float, float]:
        """0.9 / 0.995 quantiles of validation maps (efficientAD.py:311-333)."""
        sts, aes = [], []
        for i in range(0, len(val_imgs), batch):
            m_st, m_ae = self.predict_maps(val_imgs[i:i + batch])
            sts.append(m_st.cpu().numpy())
            aes.append(m_ae.cpu().numpy())
        st = np.concatenate(sts).ravel()
        aev = np.concatenate(aes).ravel()
        return (float(np.quantile(st, 0.9)), float(np.quantile(st, 0.995)),
                float(np.quantile(aev, 0.9)), float(np.quantile(aev, 0.995)))

    def predict_combined(self, imgs: ImageBatch, quantiles, batch: int = 8
                         ) -> np.ndarray:
        """Combined anomaly maps [N, H', W'] (efficientAD.py:292-309)."""
        q_st_start, q_st_end, q_ae_start, q_ae_end = quantiles
        outs = []
        for i in range(0, len(imgs), batch):
            m_st, m_ae = self.predict_maps(imgs[i:i + batch])
            m_st = 0.1 * (m_st - q_st_start) / max(q_st_end - q_st_start,
                                                   1e-12)
            m_ae = 0.1 * (m_ae - q_ae_start) / max(q_ae_end - q_ae_start,
                                                   1e-12)
            outs.append((0.5 * m_st + 0.5 * m_ae).cpu().numpy())
        return np.concatenate(outs)

    def test_auc(self, test_imgs: ImageBatch, labels: List[str],
                 quantiles) -> Tuple[float, List[int], List[float]]:
        """Image AUC: max of the combined map (efficientAD.py:180-216)."""
        maps = self.predict_combined(test_imgs, quantiles)
        y_true = [0 if lab == "good" else 1 for lab in labels]
        y_score = [float(m.max()) for m in maps]
        return roc_auc(y_true, y_score), y_true, y_score

    def test_auc_grouped(self, test_imgs: ImageBatch, labels: List[str],
                         paths: List[str], quantiles, group_div: int = 14
                         ) -> Tuple[float, List[int], List[float]]:
        """Patch-grouped part AUC (efficientAD.py:218-290): group by
        int(basename.split('_')[0]) // group_div, take the max patch score
        per part, then score with 1 - max (the reference's inversion at
        efficientAD.py:288 is reproduced)."""
        maps = self.predict_combined(test_imgs, quantiles)
        groups: Dict[Tuple[int, int], float] = {}
        for m, lab, path in zip(maps, labels, paths):
            name = os.path.basename(path)
            try:
                gid = int(name.split("_")[0]) // group_div
            except ValueError:
                gid = hash(name.split("_")[0]) % (2 ** 31)
            key = (gid, 0 if lab == "good" else 1)
            groups[key] = max(groups.get(key, -np.inf), float(m.max()))
        y_true = [k[1] for k in groups]
        if len(set(y_true)) < 2:
            raise ValueError("Only one class present in grouped labels")
        y_score = [1.0 - groups[k] for k in groups]
        return roc_auc(y_true, y_score), y_true, y_score


class EarlyStopping:
    """AUC-plateau stopping (efficientAD.py:335-350)."""

    def __init__(self, patience: int = 10, min_delta: float = 0.01,
                 best_auc: float = 0.98):
        self.patience = patience
        self.min_delta = min_delta
        self.best_auc = best_auc
        self.counter = 0

    def should_stop(self, current_auc: float) -> bool:
        if current_auc >= (self.best_auc - self.min_delta):
            self.counter += 1
        else:
            self.counter = 0
        return self.counter >= self.patience


def final_metrics(y_true: List[int], y_score: List[float]) -> Dict[str, float]:
    """Optimal threshold + acc/precision/recall/F1 (efficientAD.py:644-659)."""
    thr = min_distance_threshold(y_true, y_score)
    y = np.asarray(y_true)
    pred = (np.asarray(y_score) >= thr).astype(int)
    tp = int(np.sum((pred == 1) & (y == 1)))
    fp = int(np.sum((pred == 1) & (y == 0)))
    fn = int(np.sum((pred == 0) & (y == 1)))
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"threshold": float(thr),
            "accuracy": float(np.mean(pred == y)),
            "precision": precision, "recall": recall, "f1": f1}
