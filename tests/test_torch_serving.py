"""The port's AnomalyServer and evaluate_anomaly against the JAX package on
the same weights and inputs (f32, CPU): DRCT classes, and a DRN-L carpet
class beside a DRCT grid class on one server; a DRN evaluation auto-tiles at
its train-crop LR."""

import numpy as np
import pytest
import torch

from adsr_tpu.core import config as jc
from adsr_tpu.eval.evaluate import evaluate_anomaly as jax_evaluate
from adsr_tpu.eval.serving import AnomalyServer as JaxServer

from adsr_tpu_torch.core import config as pc
from adsr_tpu_torch.eval.evaluate import evaluate_anomaly, evaluate_anomaly_arrays
from adsr_tpu_torch.eval.serving import AnomalyServer
from adsr_tpu_torch.io.convert import (drct_state_dict_from_jax,
                                       drn_state_dict_from_jax)
from adsr_tpu_torch.train.trainer import (check_serving_precision,
                                          check_training_precision)

from torch_port_util import CONFIGS, drn_jax_params, jax_params

# conv_last's bias lifts the SR off 0 in both trees, so the uint8 round trip
# and the quantisation are exercised rather than clipped away
SR_OFFSET = 100.0


def _experiments(batch=4):
    kw = dict(resolution=16, patch_size=16, scale=(2,), n_colors=1,
              batch_size=batch, test_every=1)
    model_kw = CONFIGS["tiny"]
    return (jc.Experiment(model=jc.DRCTModelConfig(**model_kw),
                          data=jc.DataConfig(**kw), precision="fp32"),
            pc.Experiment(model=pc.DRCTModelConfig(**model_kw),
                          data=pc.DataConfig(**kw), precision="fp32"))


def _weights():
    _, pcfg, params = jax_params("tiny")
    params = dict(params)
    params["conv_last"] = dict(params["conv_last"])
    params["conv_last"]["bias"] = params["conv_last"]["bias"] + SR_OFFSET
    return params, drct_state_dict_from_jax(params, pcfg)


def test_anomaly_server_scores_match_jax_with_padded_tail():
    jexp, pexp = _experiments()
    params, sd = _weights()
    rng = np.random.RandomState(0)
    lr = rng.randint(0, 256, (5, 8, 8, 3), np.uint8)     # 5 = 4 + padded tail
    hr = rng.randint(0, 256, (5, 16, 16, 3), np.uint8)
    theirs = JaxServer(batch_size=4, ssim_window=5)
    theirs.register("grid", jexp, params)
    ours = AnomalyServer(batch_size=4, ssim_window=5, device="cpu")
    ours.register("grid", pexp, sd)
    want = theirs.score("grid", lr, hr)
    got = ours.score("grid", lr, hr)
    assert got.shape == (5, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert ours.classes() == ["grid"]


def _write_split(root, split, n, rng, defect):
    from PIL import Image
    base = root / "grid" / "test" / split
    (base / "HR").mkdir(parents=True)
    (base / "LR_bicubic" / "X2").mkdir(parents=True)
    for i in range(n):
        hr = rng.randint(60, 200, (16, 16, 3)).astype(np.uint8)
        if defect:
            hr[4:12, 4:12] = 255 - hr[4:12, 4:12]
        lr = hr.reshape(8, 2, 8, 2, 3).mean(axis=(1, 3)).astype(np.uint8)
        Image.fromarray(hr).save(base / "HR" / f"{i:03d}.png")
        Image.fromarray(lr).save(base / "LR_bicubic" / "X2" / f"{i:03d}x2.png")


def test_evaluate_anomaly_matches_jax(tmp_path):
    jexp, pexp = _experiments()
    params, sd = _weights()
    rng = np.random.RandomState(1)
    _write_split(tmp_path, "good", 6, rng, defect=False)
    _write_split(tmp_path, "bad", 5, rng, defect=True)
    want = jax_evaluate(jexp, params, str(tmp_path), "grid", out_dir=None,
                        save_images=False, batch=4, log=lambda s: None)
    got = evaluate_anomaly(pexp, sd, str(tmp_path), "grid", batch=4,
                           device="cpu", log=lambda s: None)
    assert got["best_ws"] == want["best_ws"]
    assert got["y_true"] == want["y_true"]
    assert got["filenames"] == want["filenames"]
    # scores agree to f32 noise; one swapped rank pair would move an AUC by
    # 1 / (n_good * n_bad) and no more
    swap = 1.0 / (6 * 5)
    for key in ("auc_ssim", "auc_mse", "auc_psnr"):
        assert abs(got[key] - want[key]) <= swap, key
    for key in ("scores_ssim", "scores_mse", "scores_psnr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4)


def test_evaluate_core_needs_both_classes():
    _, pexp = _experiments()
    _, sd = _weights()
    lr = np.zeros((2, 8, 8, 1), np.float32)
    hr = np.zeros((2, 16, 16, 1), np.float32)
    with pytest.raises(ValueError, match="good and defective"):
        evaluate_anomaly_arrays(pexp, sd, lr, hr, lr[:0], hr[:0], batch=4,
                                device="cpu", log=lambda s: None)


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        AnomalyServer()
    _, pexp = _experiments()
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_anomaly_arrays(pexp, {}, None, None, None, None)


def test_fp32_on_cuda_is_accepted_in_both_modes():
    # fp32 serves on the card in rdg mode (the f32 instances of (a)-(c))
    # and in block mode (the f32 instance of (g)), and trains there (the
    # f32 instances of (a)-(f))
    _, pexp = _experiments()
    cuda = torch.device("cuda")
    check_serving_precision(pexp, cuda, mode="rdg")
    check_serving_precision(pexp, cuda, mode="block")
    check_training_precision(pexp, cuda)
    for mode in ("rdg", "block"):                      # plain path: fine
        check_serving_precision(pexp, torch.device("cpu"), mode=mode)
    check_training_precision(pexp, torch.device("cpu"))


def _drn_carpet(patch=16, batch=4):
    """A tiny DRN-L x4 carpet class (RGB, scales (2, 4)) for both packages,
    its add_mean bias lifted like ``SR_OFFSET``."""
    jcfg, pcfg, params, _ = drn_jax_params((2, 4), 3)
    params = dict(params)
    params["add_mean"] = {"shift": dict(params["add_mean"]["shift"])}
    params["add_mean"]["shift"]["bias"] = \
        params["add_mean"]["shift"]["bias"] + SR_OFFSET
    kw = dict(classe="carpet", resolution=patch, patch_size=patch,
              scale=(2, 4), n_colors=3, batch_size=batch, test_every=1)
    return (jc.Experiment(model=jcfg, data=jc.DataConfig(**kw),
                          precision="fp32"),
            pc.Experiment(model=pcfg, data=pc.DataConfig(**kw),
                          precision="fp32"),
            params, drn_state_dict_from_jax(params, pcfg))


def test_anomaly_server_serves_a_drn_carpet_beside_a_drct_grid():
    """One server, a DRCT grid class (gray, x2) and a DRN-L carpet class
    (RGB, x4), each scored against the JAX server's class (5 requests: a
    padded tail)."""
    jexp, pexp = _experiments()
    params, sd = _weights()
    jexp_d, pexp_d, params_d, sd_d = _drn_carpet()
    rng = np.random.RandomState(6)
    requests = {"grid": (rng.randint(0, 256, (5, 8, 8, 3), np.uint8),
                         rng.randint(0, 256, (5, 16, 16, 3), np.uint8)),
                "carpet": (rng.randint(0, 256, (5, 4, 4, 3), np.uint8),
                           rng.randint(0, 256, (5, 16, 16, 3), np.uint8))}
    theirs = JaxServer(batch_size=4, ssim_window=5)
    theirs.register("grid", jexp, params)
    theirs.register("carpet", jexp_d, params_d)
    ours = AnomalyServer(batch_size=4, ssim_window=5, device="cpu")
    ours.register("grid", pexp, sd)
    ours.register("carpet", pexp_d, sd_d)
    assert ours.classes() == ["grid", "carpet"]
    for name, (lr, hr) in requests.items():
        want = theirs.score(name, lr, hr)
        got = ours.score(name, lr, hr)
        assert got.shape == (5, 3) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def test_evaluate_anomaly_auto_tiles_a_drn(tmp_path):
    """A DRN trained on 16 px crops serves 32 px test images (LR 8 at x4)
    in tiles of its train-crop LR, 16 // 4 = 4 px, as the JAX
    ``evaluate_anomaly`` does; scores against the JAX pass."""
    from PIL import Image
    jexp, pexp, params, sd = _drn_carpet()
    rng = np.random.RandomState(7)
    for split, n in (("good", 5), ("bad", 4)):
        base = tmp_path / "carpet" / "test" / split
        (base / "HR").mkdir(parents=True)
        (base / "LR_bicubic" / "X4").mkdir(parents=True)
        for i in range(n):
            hr = rng.randint(60, 200, (32, 32, 3)).astype(np.uint8)
            if split == "bad":
                hr[8:24, 8:24] = 255 - hr[8:24, 8:24]
            lr = hr.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3)).astype(np.uint8)
            Image.fromarray(hr).save(base / "HR" / f"{i:03d}.png")
            Image.fromarray(lr).save(base / "LR_bicubic" / "X4" /
                                     f"{i:03d}x4.png")
    want = jax_evaluate(jexp, params, str(tmp_path), "carpet", out_dir=None,
                        save_images=False, batch=4, log=lambda s: None,
                        tile_overlap=2)
    from adsr_tpu_torch.data.pipeline import load_sr_dataset
    good, bad = (load_sr_dataset(str(tmp_path / "carpet" / "test" / split),
                                 (4,), 3) for split in ("good", "bad"))
    logs = []
    got = evaluate_anomaly_arrays(pexp, sd, good.lrs[0], good.hr, bad.lrs[0],
                                  bad.hr, batch=4, device="cpu",
                                  log=logs.append, tile_overlap=2)
    assert "Tiled serving: tile=4 overlap=2 for 8px LR input" in logs
    assert got["best_ws"] == want["best_ws"]
    assert got["y_true"] == want["y_true"]
    swap = 1.0 / (5 * 4)
    for key in ("auc_ssim", "auc_mse", "auc_psnr"):
        assert 0.0 <= got[key] <= 1.0
        assert abs(got[key] - want[key]) <= swap, key
    for key in ("scores_ssim", "scores_mse", "scores_psnr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4)
