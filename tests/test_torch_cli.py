"""The port's train and evaluate CLIs end to end on the CPU (tiny DRCT, f32,
a synthetic data root written with the port's PNG writer), and the evaluate
pass against the JAX package's ``evaluate_anomaly`` on the same checkpoint
and data root."""

import json

import numpy as np
import pytest

import jax

from adsr_tpu.core import config as jc
from adsr_tpu.eval.evaluate import evaluate_anomaly as jax_evaluate
from adsr_tpu.io.torch_convert import convert_drct, stack_scan_layers

from adsr_tpu_torch.cli import evaluate as cli_eval
from adsr_tpu_torch.cli import main as cli_main
from adsr_tpu_torch.data.synthetic import grid_texture, inject_defect
from adsr_tpu_torch.io.journal import load_state_dict
from adsr_tpu_torch.io.png import write_png

# DRCT x4 at 32 px HR (LR 8, window 2), embed 12, one RDG; test images of
# 64 px HR (LR 16) are served in 8 px tiles overlapping by 2 (3 x 3 tiles)
TINY = ["--resolution", "32", "--scale", "4", "--embed-dim", "12",
        "--num-layers", "1", "--num-heads", "2"]


def _split(base, n, hr, rng, defect=False):
    (base / "HR").mkdir(parents=True)
    (base / "LR_bicubic" / "X4").mkdir(parents=True)
    for i in range(n):
        img = grid_texture(rng, hr)
        if defect:
            img = inject_defect(rng, img, ("blob", "scratch")[i % 2])
        lr = img.reshape(hr // 4, 4, hr // 4, 4, 3).astype(np.float64) \
            .mean(axis=(1, 3)).round().astype(np.uint8)
        write_png(base / "HR" / f"{i:03d}.png", img)
        write_png(base / "LR_bicubic" / "X4" / f"{i:03d}x4.png", lr)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    root = tmp / "data"
    rng = np.random.RandomState(0)
    _split(root / "grid" / "train" / "good", 6, 32, rng)
    _split(root / "grid" / "val" / "good", 3, 32, rng)
    _split(root / "grid" / "test" / "good", 5, 64, rng)
    _split(root / "grid" / "test" / "bad", 4, 64, rng, defect=True)
    run_dir = cli_main.main(TINY + [
        "--epochs", "1", "--batch-size", "8", "--data-root", str(root),
        "--save-dir", str(tmp / "runs"), "--run-tag", "t", "--device", "cpu",
        "--precision", "fp32"])
    return tmp, root, run_dir


def test_train_cli_writes_a_run_dir(run):
    tmp, _, run_dir = run
    assert run_dir == str(tmp / "runs" / "drct" / "mvtec_grid_32_X4t")
    files = {p.name for p in (tmp / "runs" / "drct" / "mvtec_grid_32_X4t")
             .iterdir()}
    assert {"log.txt", "config.txt", "metrics.jsonl", "loss_log.json",
            "psnr_ssim_log.json", "model", "results"} <= files
    model = {p.name for p in (tmp / "runs" / "drct" / "mvtec_grid_32_X4t" /
                              "model").iterdir()}
    assert model == {"model_best.pt", "model_latest.pt",
                     "train_state_latest.pt"}
    log = open(f"{run_dir}/log.txt").read()
    assert "[Epoch 1]" in log and "[mvtec_val_good x4]" in log
    assert len(json.load(open(f"{run_dir}/psnr_ssim_log.json"))) == 1
    assert len(list((tmp / "runs" / "drct" / "mvtec_grid_32_X4t" / "results"
                     / "mvtec_val_good" / "x4").iterdir())) == 3


def test_evaluate_cli_matches_jax_evaluate_anomaly(run):
    tmp, root, run_dir = run
    out = tmp / "eval"
    got = cli_eval.main(["--run-dir", run_dir, "--data-root", str(root),
                         "--device", "cpu", "--precision", "fp32",
                         "--tile-overlap", "2", "--output-dir", str(out),
                         "--json-out", str(tmp / "r.json")])
    assert got["checkpoint"].endswith("model_best.pt")
    assert json.load(open(tmp / "r.json"))["auc_mse"] == got["auc_mse"]
    lines = (out / "scores.txt").read_text().splitlines()
    assert len(lines) == 9 and lines[0].startswith("good/000\tssim_score=")
    assert set(got["specificity"]) == {"ssim", "mse", "psnr"}
    assert len(list((out / "bad" / "x4").iterdir())) == 4

    sd = load_state_dict(got["checkpoint"])
    params = jax.tree_util.tree_map(np.asarray, stack_scan_layers(
        convert_drct({k: v.numpy() for k, v in sd.items()}), 1))
    jexp = jc.drct_experiment(classe="grid", resolution=32, scale=4,
                              data_root=str(root), precision="fp32",
                              embed_dim=12, num_layers=1, num_heads=2)
    want = jax_evaluate(jexp, params, str(root), "grid", out_dir=None,
                        save_images=False, batch=8, log=lambda s: None,
                        tile_overlap=2)
    assert got["best_ws"] == want["best_ws"]
    assert got["y_true"] == want["y_true"]
    assert got["filenames"] == want["filenames"]
    # The SR agrees to f32 noise, but the truncating uint8 conversion can
    # move a pixel lying within that noise of an integer one grey level:
    # a flip moves an image's MSE by at most (2*255+1)/255^2 of one pixel's
    # share. Allowing 1% of the 64x64 pixels to flip: MSE 8e-5, PSNR (10
    # log10 of a ratio moved by that) 0.05 dB; 1-SSIM at window 3 moves by
    # at most ~1/255 per flipped pixel's share: 4e-5. A swapped rank pair
    # moves an AUC by 1/(5*4).
    np.testing.assert_allclose(got["scores_mse"], want["scores_mse"],
                               atol=8e-5, rtol=0)
    np.testing.assert_allclose(got["scores_psnr"], want["scores_psnr"],
                               atol=5e-2, rtol=0)
    np.testing.assert_allclose(got["scores_ssim"], want["scores_ssim"],
                               atol=4e-5, rtol=0)
    for key in ("auc_ssim", "auc_mse", "auc_psnr"):
        assert abs(got[key] - want[key]) <= 1.0 / 20, key
    for metric, rep in want["specificity"].items():
        assert got["specificity"][metric]["specificity"] == \
            pytest.approx(rep["specificity"], abs=1.0 / 5)


def test_train_cli_resume_continues_from_the_checkpoint(run, capsys):
    tmp, root, run_dir = run
    again = cli_main.main(TINY + [
        "--epochs", "2", "--batch-size", "8", "--data-root", str(root),
        "--save-dir", str(tmp / "runs"), "--run-tag", "t", "--device", "cpu",
        "--precision", "fp32", "--resume"])
    assert again == run_dir
    log = open(f"{run_dir}/log.txt").read()
    assert "Resumed at step 32 (epoch 1)" in log and "[Epoch 2]" in log
    assert len(open(f"{run_dir}/metrics.jsonl").read().splitlines()) == 2


@pytest.mark.parametrize("flags,item", [
    (["--model-type", "drn-l"], "Queue 1 item 10"),
    (["--dp", "2"], "Queue 1 item 11"),
    (["--remat-policy", "dots"], "Queue 1 item 9")])
def test_train_cli_refuses_what_the_port_lacks(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        cli_main.build_experiment(cli_main.parse_args(flags))


def test_evaluate_cli_defaults_to_the_card():
    args = cli_eval.parse_args([])
    assert args.device == "cuda" and args.precision == "bf16"
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        cli_eval.main(["--model-type", "drn-l", "--device", "cpu"])
