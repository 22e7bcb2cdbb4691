"""Offline MVTec -> SR-layout converter, the port of
``adsr_tpu/data/prepare.py`` (reference scripts/prepare_mvtec_data.py):

- every image is converted to RGB and resized to the HR size with Pillow's
  LANCZOS filter; LR = HR // s by the same filter
  (prepare_mvtec_data.py:22-33);
- train/val split: RandomState(seed).shuffle, the first ``val_ratio``
  fraction is val (at least 1) (prepare_mvtec_data.py:70-75);
- test: good -> test/good; every defect dir merged into test/bad with
  ``{defect}_{name}.png`` names (prepare_mvtec_data.py:132-152);
- progressive LR: always LR_2; scale 8 adds LR_4
  (prepare_mvtec_data.py:286-291).

Output layout per class:
    <target>/<classe>/{train,val}/good/{HR,LR_s}/*.png
    <target>/<classe>/test/{good,bad}/{HR,LR_s}/*.png

Prep is host work in numpy: the card's machine has no PIL, so the files are
read and written with ``io/png.py`` and resized by :func:`resize_lanczos`,
which gives Pillow's LANCZOS output byte for byte.
"""

from __future__ import annotations

import functools
import math
import shutil
from pathlib import Path
from typing import Iterable, Sequence, Tuple

import numpy as np

from adsr_tpu_torch.io.png import read_png_rgb, write_png

PRECISION_BITS = 22          # Pillow's 8-bit resampler: 32 - 8 - 2 bits
LANCZOS_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -LANCZOS_SUPPORT <= x < LANCZOS_SUPPORT:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


@functools.lru_cache(maxsize=64)
def lanczos_taps(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's fixed-point LANCZOS coefficients (``Resample.c``
    ``precompute_coeffs`` then ``normalize_coeffs_8bpc``) for ``in_size`` ->
    ``out_size`` as a dense read-only float64 [out, in] matrix of integer
    taps. Each output pixel's weights are computed in Pillow's order, in
    doubles (Python floats are C doubles and ``math.sin`` is the C library's),
    summed one after another, normalised and rounded to 22-bit fixed point."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ss = 1.0 / filterscale
    taps = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [_lanczos((x - center + 0.5) * ss) for x in range(xmin, xmax)]
        ww = 0.0
        for v in w:                  # in order: no compensated sum()
            ww += v
        for i, v in enumerate(w):
            if ww != 0.0:
                v = v / ww
            v = v * (1 << PRECISION_BITS)
            taps[xx, xmin + i] = int(v - 0.5) if v < 0 else int(v + 0.5)
    taps.flags.writeable = False
    return taps


def _to_uint8(acc: np.ndarray) -> np.ndarray:
    """Pillow's ``clip8``: (acc + 2^21) >> 22, clipped to [0, 255]. Every
    ``acc`` is an integer below 2^53, so the float64 division is exact."""
    half = float(1 << (PRECISION_BITS - 1))
    return np.clip(np.floor((acc + half) / float(1 << PRECISION_BITS)),
                   0, 255)


def resize_lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's ``Image.resize((width, height), Image.LANCZOS)`` of a uint8
    [H, W] or [H, W, 3] image, byte for byte: the horizontal pass rounded
    to uint8, then the vertical pass; a dimension that keeps its size skips
    its pass, as in Pillow. The taps are integers and every partial sum of
    a pass stays below 2^53, so float64 BLAS products are exact."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (
            a.ndim == 3 and a.shape[2] != 3):
        raise ValueError(f"resize_lanczos takes uint8 [H, W] or [H, W, 3], "
                         f"got {a.dtype} {a.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"resize_lanczos: target size {width} x {height}")
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else 3
    x = a.reshape(h, w, c).astype(np.float64)
    if w != width:                   # [h, c, w] rows times the taps
        rows = x.transpose(0, 2, 1).reshape(h * c, w)
        x = _to_uint8(rows @ lanczos_taps(w, width).T) \
            .reshape(h, c, width).transpose(0, 2, 1)
    if h != height:
        x = _to_uint8(lanczos_taps(h, height) @ x.reshape(h, -1)) \
            .reshape(height, width, c)
    return x.astype(np.uint8).reshape((height, width) + a.shape[2:])


def resize_image(path: Path, target: Tuple[int, int]) -> np.ndarray:
    """The file at ``path`` as RGB, resized to ``target`` = (width, height)."""
    return resize_lanczos(read_png_rgb(path), target[0], target[1])


def lr_from_hr(hr: np.ndarray, scale: int) -> np.ndarray:
    return resize_lanczos(hr, hr.shape[1] // scale, hr.shape[0] // scale)


def expand_scales(user_scales: Iterable[int]) -> Tuple[int, ...]:
    """Progressive-LR rule: always LR_2; 8 implies 4
    (prepare_mvtec_data.py:286-291)."""
    scales = set(int(s) for s in user_scales)
    scales.add(2)
    if 8 in scales:
        scales.add(4)
    return tuple(sorted(scales))


def _save_pairs(files: Sequence[Path], base: Path, scales: Sequence[int],
                target_hr: Tuple[int, int], rename=None) -> None:
    for f in files:
        name = rename(f) if rename else f.name
        hr = resize_image(f, target_hr)
        (base / "HR").mkdir(parents=True, exist_ok=True)
        write_png(base / "HR" / name, hr)
        for s in scales:
            (base / f"LR_{s}").mkdir(parents=True, exist_ok=True)
            write_png(base / f"LR_{s}" / name, lr_from_hr(hr, s))


def prepare_mvtec_dataset(source_base: str = "data/mvtec",
                          target_base: str = "data/mvtec_128",
                          classes: Sequence[str] = ("carpet", "grid"),
                          scale_factors: Sequence[int] = (2, 4),
                          target_hr: Tuple[int, int] = (128, 128),
                          val_ratio: float = 0.1, seed: int = 42,
                          clean: bool = True,
                          layout: str = "mvtec") -> None:
    """Write the SR layout of ``classes`` from the raw MVTec tree at
    ``source_base`` to ``target_base`` (wiped first when ``clean``).

    ``layout='gkd'`` writes the train split under the GKD path convention
    the train CLI derives for ``--dataset gkd`` —
    ``{classe}/train/HR_{resolution}/{HR,LR_s}`` (core/config.py
    _dataset_paths). val/test keep the shared {split}/{good,bad} convention
    every evaluator reads."""
    src, dst = Path(source_base), Path(target_base)
    if clean and dst.exists():
        shutil.rmtree(dst)

    for classe in classes:
        train_src = src / classe / "train" / "good"
        test_src = src / classe / "test"

        if train_src.exists():
            files = sorted(train_src.glob("*.png"))
            rng = np.random.RandomState(seed)
            rng.shuffle(files)
            val_size = int(len(files) * float(val_ratio))
            if len(files) > 1 and val_ratio > 0:
                val_size = max(1, val_size)
            val_files, train_files = files[:val_size], files[val_size:]
            train_dst = (dst / classe / "train" / "good"
                         if layout == "mvtec"
                         else dst / classe / "train" / f"HR_{target_hr[0]}")
            _save_pairs(train_files, train_dst, scale_factors, target_hr)
            _save_pairs(val_files, dst / classe / "val" / "good",
                        scale_factors, target_hr)

        if test_src.exists():
            good = sorted((test_src / "good").glob("*.png")) \
                if (test_src / "good").exists() else []
            _save_pairs(good, dst / classe / "test" / "good",
                        scale_factors, target_hr)
            defect_dirs = sorted(d for d in test_src.iterdir()
                                 if d.is_dir() and d.name != "good")
            for d in defect_dirs:
                _save_pairs(sorted(d.glob("*.png")),
                            dst / classe / "test" / "bad",
                            scale_factors, target_hr,
                            rename=lambda f, dn=d.name: f"{dn}_{f.name}")


def verify_dataset_structure(base_dir: str,
                             classes: Sequence[str] = ("carpet", "grid"),
                             layout: str = "mvtec",
                             hr_size: int = 128) -> dict:
    """Count images per split; returns {classe: {split: count}}."""
    base = Path(base_dir)
    train_split = ("train/good" if layout == "mvtec"
                   else f"train/HR_{hr_size}")
    report = {}
    for classe in classes:
        counts = {}
        for split in (train_split, "val/good", "test/good", "test/bad"):
            hr = base / classe / split / "HR"
            counts[split] = len(list(hr.glob("*.png"))) if hr.exists() else 0
        report[classe] = counts
    return report
