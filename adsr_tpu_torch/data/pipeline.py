"""Host-side dataset loading for evaluation (the loading part of
``adsr_tpu/data/pipeline.py``; the training sampler waits for a later slice).

Reference semantics reproduced:
- filesystem scan candidates ``LR_bicubic/X{s}/{name}x{s}.png`` |
  ``LR_{s}/{name}.png`` | ``LR/{name}.png`` (reference data.py:109-134);
- channel rule: n_colors=1 converts RGB via the BT.601 YCbCr luma used by
  skimage (Y = 16 + 65.481R + 128.553G + 24.966B on [0,1] inputs);
  n_colors=3 repeats gray channels (data.py:52-65);
- pixel scaling ``* rgb_range / 255`` (data.py:11-19);
- test-time HR crop to ``lr_size * scale`` (data.py:176-181);
- LR list in *descending* scale order: lrs[0] is the model input.

PNG decode uses PIL, imported inside ``load_sr_dataset``: file loading runs on
the CPU only (the card's machine has no PIL).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


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


def load_sr_dataset(data_dir: str, scales: Sequence[int], n_colors: int,
                    rgb_range: float = 255.0) -> SRDataset:
    """Load a split directory (test/good, test/bad, ...) with PIL."""
    from PIL import Image

    scales_desc = tuple(sorted(set(int(s) for s in scales), reverse=True))
    hr_files, lr_files = _scan(Path(data_dir), scales_desc)

    def read(path: Path) -> np.ndarray:
        with Image.open(path) as im:
            return np.asarray(im)

    pixel_scale = rgb_range / 255.0
    hr = np.stack([set_channel(read(f), n_colors) for f in hr_files])
    hr *= pixel_scale
    max_s = scales_desc[0]
    lrs = []
    for si in range(len(scales_desc)):
        arr = np.stack([set_channel(read(f), n_colors) for f in lr_files[si]])
        arr *= pixel_scale
        lrs.append(arr)
    lh, lw = lrs[0].shape[1], lrs[0].shape[2]
    hr = hr[:, :lh * max_s, :lw * max_s]
    return SRDataset(hr=hr, lrs=lrs, scales_desc=scales_desc,
                     filenames=[f.stem for f in hr_files],
                     rgb_range=rgb_range)
