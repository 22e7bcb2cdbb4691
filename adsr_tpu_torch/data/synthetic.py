"""Procedural MVTec-like fixtures, the port of ``adsr_tpu/data/synthetic.py``,
so the full prepare -> train -> evaluate pipeline runs hermetically, with no
real (non-redistributable) MVTec data and no PIL.

``generate_synthetic_mvtec`` writes a source tree shaped like the raw MVTec AD
layout the prep tool consumes (reference
scripts/prepare_mvtec_data.py:161-203):

    <root>/<classe>/train/good/*.png
    <root>/<classe>/test/good/*.png
    <root>/<classe>/test/<defect>/*.png

'grid' is two sine lattices plus speckle, 'carpet' low-pass colored noise;
defects are blobs, scratches, tears or faint blobs that an SR model trained
only on good textures reconstructs poorly. The textures also feed
``chip_smoke.py``'s in-memory inputs.
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import Sequence

import numpy as np

from adsr_tpu_torch.io.png import write_png


def grid_texture(rng: np.random.RandomState, size: int) -> np.ndarray:
    """Woven-grid texture: two sine lattices + speckle, uint8 HxWx3."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    period = max(8, size // 12)
    phase_x, phase_y = rng.uniform(0, period, 2)
    lines = (np.sin((x + phase_x) * 2 * np.pi / period) ** 8
             + np.sin((y + phase_y) * 2 * np.pi / period) ** 8)
    base = 40 + 140 * np.clip(lines, 0, 1)
    base += rng.normal(0, 6, base.shape)
    img = np.clip(base, 0, 255).astype(np.uint8)
    return np.stack([img] * 3, axis=-1)


def carpet_texture(rng: np.random.RandomState, size: int) -> np.ndarray:
    """Low-pass filtered colored noise, uint8 HxWx3."""
    out = np.empty((size, size, 3), np.uint8)
    base_color = rng.uniform(60, 180, 3)
    for c in range(3):
        noise = rng.normal(0, 1, (size, size))
        f = np.fft.rfft2(noise)
        fy = np.fft.fftfreq(size)[:, None]
        fx = np.fft.rfftfreq(size)[None, :]
        f *= np.exp(-((fx ** 2 + fy ** 2) / (2 * 0.05 ** 2)))
        tex = np.fft.irfft2(f, s=(size, size))
        tex = tex / (np.abs(tex).max() + 1e-9)
        out[..., c] = np.clip(base_color[c] + 60 * tex
                              + rng.normal(0, 4, (size, size)), 0, 255)
    return out


def inject_defect(rng: np.random.RandomState, img: np.ndarray,
                  kind: str) -> np.ndarray:
    img = img.copy()
    size = img.shape[0]
    if kind == "blob":
        cy, cx = rng.randint(size // 4, 3 * size // 4, 2)
        r = rng.randint(size // 16, size // 6)
        y, x = np.ogrid[:size, :size]
        m = (y - cy) ** 2 + (x - cx) ** 2 <= r ** 2
        img[m] = np.clip(img[m].astype(int) + rng.choice([-1, 1])
                         * rng.randint(60, 120), 0, 255)
    elif kind == "scratch":
        x0, y0 = rng.randint(0, size, 2)
        angle = rng.uniform(0, np.pi)
        length = rng.randint(size // 3, size)
        thickness = rng.randint(1, max(2, size // 48))
        for t in range(length):
            yy = int(y0 + t * np.sin(angle))
            xx = int(x0 + t * np.cos(angle))
            if 0 <= yy < size and 0 <= xx < size:
                img[max(0, yy - thickness):yy + thickness,
                    max(0, xx - thickness):xx + thickness] = rng.randint(0, 50)
    elif kind == "tear":
        x0 = rng.randint(size // 8, 7 * size // 8)
        width = rng.randint(2, max(3, size // 24))
        img[:, x0:x0 + width] = np.clip(
            img[:, x0:x0 + width].astype(int) + 90, 0, 255)
    elif kind == "faint":
        # low-contrast small blob, comparable to the texture's own speckle
        cy, cx = rng.randint(size // 4, 3 * size // 4, 2)
        r = rng.randint(size // 20, size // 10)
        y, x = np.ogrid[:size, :size]
        m = (y - cy) ** 2 + (x - cx) ** 2 <= r ** 2
        img[m] = np.clip(img[m].astype(int) + rng.choice([-1, 1])
                         * rng.randint(8, 14), 0, 255)
    return img


# defect kinds per class; the 'hard' variants carry only the faint
# low-contrast defect, so detectors do not saturate at AUC 1.0
DEFECTS = {"grid": ("blob", "scratch"), "carpet": ("blob", "tear"),
           "grid-hard": ("faint",), "carpet-hard": ("faint",)}


def class_offset(classe: str) -> int:
    """The per-class seed offset. The JAX package adds ``hash(classe) %
    1000``, which Python salts per process; a CRC of the name gives every
    process the same tree for one seed."""
    return zlib.crc32(classe.encode()) % 1000


def generate_synthetic_mvtec(root: str,
                             classes: Sequence[str] = ("grid", "carpet"),
                             n_train: int = 24, n_test_good: int = 6,
                             n_test_bad_per_defect: int = 3, size: int = 256,
                             seed: int = 0) -> None:
    """Write a synthetic MVTec-style source tree under ``root``, drawing each
    class's images in the JAX package's order from
    ``RandomState(seed + class_offset(classe))``."""
    for classe in classes:
        rng = np.random.RandomState(seed + class_offset(classe))
        tex = grid_texture if classe.startswith("grid") else carpet_texture

        def save(img: np.ndarray, rel: str) -> None:
            p = Path(root) / classe / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            write_png(p, img)

        for i in range(n_train):
            save(tex(rng, size), f"train/good/{i:03d}.png")
        for i in range(n_test_good):
            save(tex(rng, size), f"test/good/{i:03d}.png")
        for defect in DEFECTS.get(classe, ("blob",)):
            for i in range(n_test_bad_per_defect):
                save(inject_defect(rng, tex(rng, size), defect),
                     f"test/{defect}/{i:03d}.png")
