"""The port's AnomalyServer and evaluate_anomaly against the JAX package on
the same weights and inputs (f32, CPU)."""

import numpy as np
import pytest
import torch

from adsr_tpu.core import config as jc
from adsr_tpu.eval.evaluate import evaluate_anomaly as jax_evaluate
from adsr_tpu.eval.serving import AnomalyServer as JaxServer

from adsr_tpu_torch.core import config as pc
from adsr_tpu_torch.eval.evaluate import evaluate_anomaly, evaluate_anomaly_arrays
from adsr_tpu_torch.eval.serving import AnomalyServer
from adsr_tpu_torch.io.convert import drct_state_dict_from_jax
from adsr_tpu_torch.train.trainer import check_serving_precision

from torch_port_util import CONFIGS, jax_params

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


def test_fp32_on_cuda_is_not_implemented():
    _, pexp = _experiments()
    with pytest.raises(NotImplementedError, match="fp32 serving kernels"):
        check_serving_precision(pexp, torch.device("cuda"))
    check_serving_precision(pexp, torch.device("cpu"))   # plain path: fine
