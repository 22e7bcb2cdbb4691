"""The port's disk sweeps (``eval/disk.py`` ``analyze_window_sizes`` and
``_load_pairs``) against the JAX package on the same PNG folders (CPU):
grey and RGB, ungrouped and patch-grouped, a given ladder and the default
one."""

import numpy as np
import pytest

from adsr_tpu.eval.disk import analyze_window_sizes as jax_analyze

from adsr_tpu_torch.eval.disk import _load_pairs, analyze_window_sizes
from adsr_tpu_torch.io.png import write_png


@pytest.fixture(scope="module", params=[1, 3], ids=["gray", "rgb"])
def saved_images(request, tmp_path_factory):
    """Good pairs near-identical, bad pairs far apart; 40 px, so the default
    ladder is 3, 13, 23, 33; names '<part>_<patch>' for grouping."""
    channels = request.param
    root = tmp_path_factory.mktemp(f"disk{channels}")
    rng = np.random.RandomState(channels)
    for split, n, noise in (("good", 6, 4), ("bad", 6, 40)):
        for kind in ("sr", "hr"):
            (root / f"{split}_{kind}").mkdir()
        for i in range(n):
            shape = (40, 40) if channels == 1 else (40, 40, 3)
            hr = rng.randint(40, 200, shape).astype(np.uint8)
            sr = np.clip(hr.astype(int) + rng.randint(-noise, noise + 1,
                                                      shape), 0, 255
                         ).astype(np.uint8)
            name = f"{i // 2}_{i:03d}.png"
            write_png(root / f"{split}_hr" / name, hr)
            write_png(root / f"{split}_sr" / name, sr)
    # an SR without its HR is skipped
    write_png(root / "bad_sr" / "9_999.png", sr)
    return root


def _folders(root):
    return [str(root / f) for f in ("good_sr", "good_hr", "bad_sr", "bad_hr")]


@pytest.mark.parametrize("window_sizes", [[3, 13], None],
                         ids=["ladder_3_13", "default_ladder"])
@pytest.mark.parametrize("group_div", [None, 2], ids=["ungrouped", "grouped"])
def test_analyze_window_sizes_matches_jax(saved_images, window_sizes,
                                          group_div):
    kw = dict(window_sizes=window_sizes, group_div=group_div)
    want = jax_analyze(*_folders(saved_images), **kw)
    got = analyze_window_sizes(*_folders(saved_images), device="cpu", **kw)
    assert set(got) == set(want)
    assert got["best_ws"] == want["best_ws"]
    for key in ("auc_ssim", "auc_mse", "auc_psnr"):
        assert abs(got[key] - want[key]) <= 1e-6, key
    if group_div:
        assert got["grouped"] and got["n_groups"] == want["n_groups"]
        return
    assert got["names"] == want["names"] and got["y_true"] == want["y_true"]
    assert len(got["names"]) == 12
    for key in ("scores_mse", "scores_psnr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    # 1 - SSIM comes from the f32 mean of a map near 1, summed in another
    # order on each side: they differ by a few f32 steps at 1.0 (1.2e-7
    # each; 3 seen), up to 2e-4 of a good pair's score of 1.8e-3
    np.testing.assert_allclose(got["scores_ssim"], want["scores_ssim"],
                               rtol=1e-5, atol=1e-6)


def test_load_pairs_needs_pngs(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no PNGs in"):
        _load_pairs(str(tmp_path / "empty"), str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="no PNGs in"):
        analyze_window_sizes(str(tmp_path / "empty"), str(tmp_path),
                             str(tmp_path), str(tmp_path), device="cpu")


def test_load_pairs_shapes(saved_images):
    sr, hr, names = _load_pairs(str(saved_images / "bad_sr"),
                                str(saved_images / "bad_hr"))
    assert sr.shape == hr.shape and sr.shape[:3] == (6, 40, 40)
    assert sr.dtype == np.uint8 and sr.shape[3] in (1, 3)
    assert names == [f"{i // 2}_{i:03d}" for i in range(6)]


def test_analyze_window_sizes_defaults_to_the_card(saved_images):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze_window_sizes(*_folders(saved_images), window_sizes=[3])
