"""Image score-map utilities (reference src/helpers.py:136-156), numpy as in
``adsr_tpu/utils/image.py``."""

from __future__ import annotations

import numpy as np


def min_max_scaling(x: np.ndarray) -> np.ndarray:
    """Scale to [0, 1] (helpers.py:136-141); a constant input gives zeros."""
    x = np.asarray(x, dtype=np.float32)
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-12:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def histogram_equalization(img: np.ndarray, n_bins: int = 256) -> np.ndarray:
    """Equalise a grayscale uint8/float image (helpers.py:143-156)."""
    arr = np.asarray(img)
    flat = arr.ravel()
    if arr.dtype != np.uint8:
        flat = (min_max_scaling(flat) * 255).astype(np.uint8)
    hist, bins = np.histogram(flat, n_bins, [0, 256])
    cdf = hist.cumsum()
    cdf_masked = np.ma.masked_equal(cdf, 0)
    cdf_masked = (cdf_masked - cdf_masked.min()) * 255 / (
        cdf_masked.max() - cdf_masked.min())
    lut = np.ma.filled(cdf_masked, 0).astype(np.uint8)
    return lut[flat].reshape(arr.shape)
