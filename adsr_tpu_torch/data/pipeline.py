"""Dataset loading and the training sampler (``adsr_tpu/data/pipeline.py``).

Reference semantics reproduced:
- filesystem scan candidates ``LR_bicubic/X{s}/{name}x{s}.png`` |
  ``LR_{s}/{name}.png`` | ``LR/{name}.png`` (reference data.py:109-134);
- channel rule: n_colors=1 converts RGB via the BT.601 YCbCr luma used by
  skimage (Y = 16 + 65.481R + 128.553G + 24.966B on [0,1] inputs);
  n_colors=3 repeats gray channels (data.py:52-65);
- pixel scaling ``* rgb_range / 255`` (data.py:11-19);
- test-time HR crop to ``lr_size * scale`` (data.py:176-181);
- LR list in *descending* scale order: lrs[0] is the model input.

PNG decode is the port's own (``io/png.py``, numpy + zlib), so file loading
runs on the card's machine too, which has no PIL. An ``SRDataset`` is equally
built straight from arrays.

Training batches (``sample_batch``, ``EpochSampler``, pipeline.py:149-233):
the epoch order is the reference's wraparound plus random tail, drawn from
numpy ``RandomState((seed * 9973 + epoch) % 2**31)`` exactly as the JAX
sampler draws it; crops and flips are drawn from a ``torch.Generator``, so
they follow the same distribution as the JAX ``jax.random`` stream, not its
bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from adsr_tpu_torch.core.device import resolve_device
from adsr_tpu_torch.io.png import read_png


def rgb_to_ycbcr_y(img: np.ndarray) -> np.ndarray:
    """uint8 HxWx3 -> float32 HxW luma in [16, 235] (skimage rgb2ycbcr Y)."""
    x = img.astype(np.float32) / 255.0
    return 16.0 + 65.481 * x[..., 0] + 128.553 * x[..., 1] + 24.966 * x[..., 2]


def set_channel(img: np.ndarray, n_colors: int) -> np.ndarray:
    """Reference channel handling (data.py:52-65); returns float32 HxWxC."""
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[2]
    if n_colors == 1 and c >= 3:
        img = rgb_to_ycbcr_y(img[..., :3])[..., None]
    elif n_colors == 3 and c == 1:
        img = np.concatenate([img] * 3, axis=2)
    elif c == 4:
        img = img[..., :3]
    return np.ascontiguousarray(img, dtype=np.float32)


def _scan(data_dir: Path, scales_desc: Sequence[int]
          ) -> Tuple[List[Path], List[List[Path]]]:
    hr_files = sorted((data_dir / "HR").glob("*.png"))
    if not hr_files:
        raise FileNotFoundError(f"no HR images under {data_dir}/HR")
    lr_files: List[List[Path]] = [[] for _ in scales_desc]
    for f in hr_files:
        stem = f.stem
        for si, s in enumerate(scales_desc):
            cands = [
                data_dir / "LR_bicubic" / f"X{s}" / f"{stem}x{s}.png",
                data_dir / f"LR_{s}" / f"{stem}.png",
                data_dir / "LR" / f"{stem}.png",
            ]
            for cand in cands:
                if cand.exists():
                    lr_files[si].append(cand)
                    break
            else:
                raise FileNotFoundError(
                    f"LR image not found for {stem} at scale {s}: tried {cands}")
    return hr_files, lr_files


@dataclass
class SRDataset:
    """One split fully loaded: hr [N,H,W,C]; lrs[i] [N,H/s_i,W/s_i,C],
    scales_desc descending (lrs[0] = model input)."""
    hr: np.ndarray
    lrs: List[np.ndarray]
    scales_desc: Tuple[int, ...]
    filenames: List[str]
    rgb_range: float = 255.0

    @property
    def n(self) -> int:
        return self.hr.shape[0]

    def device_arrays(self, device) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(lrs, hr) as float32 tensors on ``device``."""
        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return [put(lr) for lr in self.lrs], put(self.hr)


def load_sr_dataset(data_dir: str, scales: Sequence[int], n_colors: int,
                    rgb_range: float = 255.0) -> SRDataset:
    """Load a split directory (test/good, test/bad, ...) with the port's
    PNG decoder (``io/png.py``)."""
    scales_desc = tuple(sorted(set(int(s) for s in scales), reverse=True))
    hr_files, lr_files = _scan(Path(data_dir), scales_desc)
    pixel_scale = rgb_range / 255.0
    hr = np.stack([set_channel(read_png(f), n_colors) for f in hr_files])
    hr *= pixel_scale
    max_s = scales_desc[0]
    lrs = []
    for si in range(len(scales_desc)):
        arr = np.stack([set_channel(read_png(f), n_colors)
                        for f in lr_files[si]])
        arr *= pixel_scale
        lrs.append(arr)
    lh, lw = lrs[0].shape[1], lrs[0].shape[2]
    hr = hr[:, :lh * max_s, :lw * max_s]
    return SRDataset(hr=hr, lrs=lrs, scales_desc=scales_desc,
                     filenames=[f.stem for f in hr_files],
                     rgb_range=rgb_range)


# --------------------------------------------------------------------------- #
# Training batches: aligned crops and flips, on the device
# --------------------------------------------------------------------------- #

def _augment(img: torch.Tensor, hflip: bool, vflip: bool,
             rot: bool) -> torch.Tensor:
    """[H, W, C]: W reversed, then H reversed, then H and W swapped."""
    if hflip:
        img = img.flip(1)
    if vflip:
        img = img.flip(0)
    return img.transpose(0, 1) if rot else img


def sample_batch(hr: torch.Tensor, lrs: Sequence[torch.Tensor],
                 idx: Sequence[int], generator: torch.Generator,
                 patch_size: int, scales_desc: Tuple[int, ...],
                 augment: bool) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Gather images ``idx``, crop each at a random offset aligned to the
    largest scale (the same region of HR and of every LR), and apply one
    hflip / vflip / transpose draw to all of them. ``hr`` and ``lrs`` lie on
    the device; the draws come from ``generator`` (a CPU generator).
    Returns (LR batches in descending scale, HR batch), float32."""
    th, tw = hr.shape[1], hr.shape[2]
    tp = patch_size
    align = scales_desc[0]
    b = len(idx)
    tx = torch.randint(0, tw - tp + 1, (b,), generator=generator).tolist()
    ty = torch.randint(0, th - tp + 1, (b,), generator=generator).tolist()
    flips = torch.randint(0, 2, (b, 3), generator=generator).bool().tolist()
    hr_out, lr_out = [], [[] for _ in lrs]
    for i, n in enumerate(idx):
        x0, y0 = tx[i] - tx[i] % align, ty[i] - ty[i] % align
        aug = flips[i] if augment else (False, False, False)
        hr_out.append(_augment(hr[n, y0:y0 + tp, x0:x0 + tp], *aug))
        for out, lr, s in zip(lr_out, lrs, scales_desc):
            crop = lr[n, y0 // s:(y0 + tp) // s, x0 // s:(x0 + tp) // s]
            out.append(_augment(crop, *aug))
    return [torch.stack(o) for o in lr_out], torch.stack(hr_out)


class EpochSampler:
    """The reference's epoch indexing and shuffling over a device-resident
    dataset (on the card unless ``device="cpu"``). Deterministic given
    (seed, epoch)."""

    def __init__(self, dataset: SRDataset, batch_size: int, test_every: int,
                 patch_size: int, no_augment: bool, seed: int = 1,
                 device="cuda"):
        self.ds = dataset
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.augment = not no_augment
        self.seed = seed
        self.dataset_length = test_every * batch_size
        self.random_border = dataset.n * (self.dataset_length // dataset.n)
        self._lrs, self._hr = dataset.device_arrays(resolve_device(device))

    @property
    def batches_per_epoch(self) -> int:
        return self.dataset_length // self.batch_size

    def order(self, epoch_idx: int) -> np.ndarray:
        """The epoch's image order: every image ``repeat`` times, a random
        tail, shuffled (numpy, as the JAX sampler draws it)."""
        n = self.ds.n
        rng = np.random.RandomState((self.seed * 9973 + epoch_idx) % (2 ** 31))
        base = np.arange(self.random_border) % n
        tail = rng.randint(0, n, size=self.dataset_length - self.random_border)
        order = np.concatenate([base, tail])
        rng.shuffle(order)
        return order

    def epoch(self, epoch_idx: int
              ) -> Iterator[Tuple[List[torch.Tensor], torch.Tensor]]:
        order = self.order(epoch_idx)
        gen = torch.Generator().manual_seed(
            (self.seed * 9973 + epoch_idx) % (2 ** 63))
        for b in range(self.batches_per_epoch):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size].tolist()
            yield sample_batch(self._hr, self._lrs, idx, gen, self.patch_size,
                               self.ds.scales_desc, self.augment)
