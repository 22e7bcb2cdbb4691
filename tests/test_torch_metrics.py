"""The port's metrics, AUC and SSIM window sweep against the JAX package on
seeded arrays (f32, CPU)."""

import numpy as np
import pytest
import torch

from adsr_tpu import metrics as jm
from adsr_tpu.eval import auc as jauc
from adsr_tpu.eval import evaluate as jev

from adsr_tpu_torch import metrics as pm
from adsr_tpu_torch.eval import auc as pauc
from adsr_tpu_torch.eval import evaluate as pev

ATOL = 1e-5


def _pair(channels, seed=0, n=4, size=24):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, size, size, channels).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("win", [3, 5, 7, 11, 13])
@pytest.mark.parametrize("channels", [1, 3])
def test_ssim_eval_matches_jax(win, channels):
    a, b = _pair(channels, seed=win)
    want = np.asarray(jm.ssim_eval(a, b, win))
    got = pm.ssim_eval(torch.from_numpy(a), torch.from_numpy(b), win).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("channels", [1, 3])
def test_psnr_mse_luma_match_jax(channels):
    a, b = _pair(channels, seed=7)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(pm.mse_eval(ta, tb).numpy(),
                               np.asarray(jm.mse_eval(a, b)), atol=ATOL)
    np.testing.assert_allclose(pm.psnr_eval(ta, tb).numpy(),
                               np.asarray(jm.psnr_eval(a, b)), atol=1e-4)
    np.testing.assert_allclose(pm.to_luma(ta).numpy(),
                               np.asarray(jm.to_luma(a)), atol=ATOL)
    # identical images: PSNR is +inf in both
    assert np.isinf(pm.psnr_eval(ta, ta).numpy()).all()
    assert np.isinf(np.asarray(jm.psnr_eval(a, a))).all()


@pytest.mark.parametrize("rgb_range", [1.0, 255.0])
def test_quantize_matches_jax(rgb_range):
    rng = np.random.RandomState(2)
    x = (rng.rand(3, 8, 8, 1) * 1.2 - 0.1).astype(np.float32) * rgb_range
    np.testing.assert_allclose(pm.quantize(torch.from_numpy(x), rgb_range).numpy(),
                               np.asarray(jm.quantize(x, rgb_range)),
                               atol=ATOL * rgb_range)


def test_roc_auc_and_thresholds_match_jax():
    rng = np.random.RandomState(3)
    y = rng.randint(0, 2, 50)
    s = np.round(rng.rand(50), 1)               # ties exercise average ranks
    assert pauc.roc_auc(y, s) == jauc.roc_auc(y, s)
    for fn in ("youden_threshold", "min_distance_threshold",
               "perfect_recall_threshold"):
        assert getattr(pauc, fn)(y, s) == getattr(jauc, fn)(y, s)
    assert pauc.specificity_at(y, s, 0.5) == jauc.specificity_at(y, s, 0.5)


@pytest.mark.parametrize("min_dim", [16, 32, 128, 256])
def test_window_size_candidates_equal(min_dim):
    assert pev.window_size_candidates(min_dim) == \
        jev.window_size_candidates(min_dim)


def test_sweep_best_window_matches_jax():
    rng = np.random.RandomState(4)
    hr = rng.randint(0, 256, (10, 32, 32, 1)).astype(np.uint8)
    sr = hr.astype(np.int32)
    y = [0] * 5 + [1] * 5
    # defective images carry a local blob the SR does not reproduce
    sr[5:, 8:20, 8:20] = 255 - sr[5:, 8:20, 8:20]
    sr = np.clip(sr + rng.randint(-20, 21, sr.shape), 0, 255).astype(np.uint8)
    ws_j, auc_j, per_j = jev.sweep_best_window(sr, hr, y)
    ws_p, auc_p, per_p = pev.sweep_best_window(sr, hr, y, device="cpu")
    assert ws_p == ws_j and auc_p == pytest.approx(auc_j, abs=1e-12)
    assert sorted(per_p) == sorted(per_j)
    for ws in per_j:
        np.testing.assert_allclose(per_p[ws], per_j[ws], atol=ATOL)
