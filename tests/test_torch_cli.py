"""The port's train and evaluate CLIs end to end on the CPU (tiny DRCT and
tiny DRN-L, f32, a synthetic data root written with the port's PNG
writer), and the evaluate pass against the JAX package's
``evaluate_anomaly`` on the same checkpoint and data root."""

import dataclasses
import json

import numpy as np
import pytest
import torch

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


def _split(base, n, hr, rng, defect=False, scales=(4,)):
    (base / "HR").mkdir(parents=True)
    for s in scales:
        (base / "LR_bicubic" / f"X{s}").mkdir(parents=True)
    for i in range(n):
        img = grid_texture(rng, hr)
        if defect:
            img = inject_defect(rng, img, ("blob", "scratch")[i % 2])
        write_png(base / "HR" / f"{i:03d}.png", img)
        for s in scales:
            lr = img.reshape(hr // s, s, hr // s, s, 3).astype(np.float64) \
                .mean(axis=(1, 3)).round().astype(np.uint8)
            write_png(base / "LR_bicubic" / f"X{s}" / f"{i:03d}x{s}.png", lr)


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


@pytest.mark.parametrize("flags,error,match", [
    # a batch that does not divide by the mesh's data ranks, before any
    # rank starts
    (["--dp", "3", "--batch-size", "4"], ValueError, "data ranks"),
    (["--remat-policy", "dots"], NotImplementedError, "Queue 1 item 9")])
def test_train_cli_refuses_what_the_port_lacks(flags, error, match):
    with pytest.raises(error, match=match):
        cli_main.build_experiment(cli_main.parse_args(flags))


# DRN-L x4 at 32 px HR (LR 8), one RCAB an up phase at 8 features; test
# images of 64 px HR (LR 16) are served in tiles of the train crop's LR,
# 32 // 4 = 8 px
DRN_TINY = ["--model-type", "drn-l", "--resolution", "32", "--scale", "4",
            "--n-blocks", "1", "--n-feats", "8"]


@pytest.fixture(scope="module")
def drn_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drn_cli")
    root = tmp / "data"
    rng = np.random.RandomState(1)
    _split(root / "grid" / "train" / "good", 6, 32, rng, scales=(2, 4))
    _split(root / "grid" / "val" / "good", 3, 32, rng, scales=(2, 4))
    _split(root / "grid" / "test" / "good", 5, 64, rng)
    _split(root / "grid" / "test" / "bad", 4, 64, rng, defect=True)
    run_dir = cli_main.main(DRN_TINY + [
        "--epochs", "1", "--batch-size", "8", "--data-root", str(root),
        "--save-dir", str(tmp / "runs"), "--run-tag", "t", "--device", "cpu",
        "--precision", "fp32"])
    return tmp, root, run_dir


def test_drn_train_cli_writes_dual_checkpoints(drn_run):
    tmp, _, run_dir = drn_run
    assert run_dir == str(tmp / "runs" / "drn-l" / "mvtec_grid_32_X4t")
    model = {p.name for p in (tmp / "runs" / "drn-l" / "mvtec_grid_32_X4t" /
                              "model").iterdir()}
    assert model == {"model_best.pt", "model_latest.pt",
                     "dual_model_best.pt", "dual_model_latest.pt",
                     "train_state_latest.pt"}
    log = open(f"{run_dir}/log.txt").read()
    assert "[Epoch 1]" in log and "[mvtec_val_good x4]" in log
    assert "[primary: " in log and "[dual: " in log
    cfg = open(f"{run_dir}/config.txt").read()
    assert "model_name: drn-l" in cfg and "n_feats: 8" in cfg
    duals = load_state_dict(f"{run_dir}/model/dual_model_best.pt")
    assert [sorted(d) for d in duals] == [
        ["dual_module.0.0.weight", "dual_module.1.weight"]] * 2


@pytest.mark.parametrize("argv", [
    ["--model-type", "drn-l"],
    ["--model-type", "drn-l", "--classe", "carpet", "--scale", "8",
     "--resolution", "256", "--lr", "1e-3", "--batch-size", "16",
     "--precision", "fp32", "--pretrain"]])
def test_build_experiment_drn_equals_jax(argv):
    """``--model-type drn-l`` is ``drn_experiment``'s model, data and optim,
    as the JAX CLI builds them; ``--pretrain`` names the reference's
    ``DRNL{s}x.pt`` and ``DRNL{s}x_dual.pt``."""
    from adsr_tpu.cli import main as jax_cli_main
    argv = argv + ["--run-tag", "t"]
    ours = cli_main.build_experiment(cli_main.parse_args(argv))
    theirs = jax_cli_main.build_experiment(jax_cli_main.parse_args(argv))
    for section in ("model", "data", "optim"):
        assert dataclasses.asdict(getattr(ours, section)) == \
            dataclasses.asdict(getattr(theirs, section)), section
    if "--pretrain" in argv:
        assert ours.pre_train == \
            "workspace/pretrained_model_weights/DRNL8x.pt"
        assert ours.pre_train_dual == \
            "workspace/pretrained_model_weights/DRNL8x_dual.pt"
        assert theirs.pre_train_dual.endswith("DRNL8x_dual.msgpack")


def test_drn_pretrain_loads_reference_pt_files(drn_run, tmp_path,
                                               monkeypatch):
    """``--pretrain`` reads ``workspace/pretrained_model_weights/DRNL4x.pt``
    and ``DRNL4x_dual.pt`` (a state_dict and the list of the duals'), here
    files this test writes; at ``--lr 0`` the epoch leaves them as they
    are, so the run dir's checkpoints equal them."""
    _, root, run_dir = drn_run
    primal = load_state_dict(f"{run_dir}/model/model_best.pt")
    duals = load_state_dict(f"{run_dir}/model/dual_model_best.pt")
    primal = {k: v + 0.5 for k, v in primal.items()}
    duals = [{k: v - 0.5 for k, v in d.items()} for d in duals]
    weights = tmp_path / "workspace" / "pretrained_model_weights"
    weights.mkdir(parents=True)
    torch.save(primal, weights / "DRNL4x.pt")
    torch.save(duals, weights / "DRNL4x_dual.pt")
    monkeypatch.chdir(tmp_path)
    out = cli_main.main(DRN_TINY + [
        "--epochs", "1", "--batch-size", "8", "--data-root", str(root),
        "--save-dir", str(tmp_path / "runs"), "--run-tag", "p", "--device",
        "cpu", "--precision", "fp32", "--pretrain", "--lr", "0"])
    log = open(f"{out}/log.txt").read()
    assert "Loading model from workspace/pretrained_model_weights/" \
        "DRNL4x.pt" in log
    assert "Loading dual model from workspace/pretrained_model_weights/" \
        "DRNL4x_dual.pt" in log
    got = load_state_dict(f"{out}/model/model_latest.pt")
    assert all(torch.equal(got[k], v) for k, v in primal.items())
    got_duals = load_state_dict(f"{out}/model/dual_model_latest.pt")
    for got_d, want_d in zip(got_duals, duals):
        assert all(torch.equal(got_d[k], v) for k, v in want_d.items())


def test_evaluate_cli_defaults_to_the_card(drn_run):
    """The card is the default, in fp32 as the JAX CLI (DRCT's f32
    kernels); ``--device cpu`` evaluates a DRN-L run dir (its model type
    and capacity read from the run dir, the 64 px test images tiled at the
    train crop's LR), against the JAX pass."""
    args = cli_eval.parse_args([])
    assert args.device == "cuda" and args.precision == "fp32"
    tmp, root, run_dir = drn_run
    got = cli_eval.main(["--run-dir", run_dir, "--data-root", str(root),
                         "--device", "cpu", "--precision", "fp32",
                         "--tile-overlap", "2", "--no-save-images"])
    assert got["checkpoint"].endswith("model_best.pt")
    sd = load_state_dict(got["checkpoint"])
    from adsr_tpu.io.torch_convert import convert_drn, stack_drn_rcabs
    params = jax.tree_util.tree_map(np.asarray, stack_drn_rcabs(
        convert_drn({k: v.numpy() for k, v in sd.items()}, 2, 1), 2, 1))
    jexp = jc.drn_experiment(classe="grid", resolution=32, scale=4,
                             data_root=str(root), precision="fp32")
    jexp = dataclasses.replace(jexp, model=dataclasses.replace(
        jexp.model, n_blocks=1, n_feats=8))
    want = jax_evaluate(jexp, params, str(root), "grid", out_dir=None,
                        save_images=False, batch=8, log=lambda s: None,
                        tile_overlap=2)
    assert got["y_true"] == want["y_true"] == [0] * 5 + [1] * 4
    # the truncating uint8 conversion, as in the DRCT case above
    np.testing.assert_allclose(got["scores_mse"], want["scores_mse"],
                               atol=8e-5, rtol=0)
    for key in ("auc_ssim", "auc_mse", "auc_psnr"):
        assert 0.0 <= got[key] <= 1.0
        assert abs(got[key] - want[key]) <= 1.0 / 20, key
