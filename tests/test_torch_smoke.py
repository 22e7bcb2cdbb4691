"""The port's end-to-end smoke CLI on the CPU: ``python -m
adsr_tpu_torch.cli.smoke --device cpu`` prepares a synthetic grid tree,
trains a tiny DRCT through ``cli.main`` and scores it through
``cli.evaluate``, each a process of its own, and ends with ``SMOKE OK``;
``--device cuda`` without a card fails at the train step (nothing falls back
to the CPU); ``--model-type drn-l`` builds the full-width DRN-L train and
evaluate commands (their steps stubbed here: a full-width DRN epoch is the
card's work, ``chip_smoke.py``'s ``[drn]`` phase). The subprocesses run on
one thread: the tiny model's operations are too small to share."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from adsr_tpu_torch.cli import smoke

REPO = Path(__file__).resolve().parent.parent


def test_smoke_cli_on_the_cpu_ends_with_smoke_ok(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "adsr_tpu_torch.cli.smoke", "--device", "cpu",
         "--resolution", "32", "--epochs", "1", "--workdir", str(tmp_path)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    m = re.fullmatch(r"SMOKE OK  auc_ssim=(\S+) auc_mse=(\S+) auc_psnr=(\S+)",
                     last)
    assert m, last
    assert all(0.0 <= float(v) <= 1.0 for v in m.groups())
    # the prepared tree (LR_2 always, LR_4 for the x4 model) and the run dir
    data = tmp_path / "data" / "mvtec_32" / "grid"
    for split, n in (("train/good", 22), ("val/good", 2), ("test/good", 6),
                     ("test/bad", 6)):
        for sub in ("HR", "LR_2", "LR_4"):
            assert len(list((data / split / sub).glob("*.png"))) == n
    run_dir = tmp_path / "workspace" / "experiment" / "drct" / \
        "mvtec_grid_32_X4smoke"
    assert (run_dir / "model" / "model_best.pt").exists()
    result = json.loads((tmp_path / "smoke_eval.json").read_text())
    assert f"auc_ssim={result['auc_ssim']:.3f}" in last
    assert len(result["scores_ssim"]) == 12


def test_smoke_cli_fails_at_the_train_step_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: --device cuda would train")
    with pytest.raises(SystemExit, match="step failed .*cli.main"):
        smoke.main(["--resolution", "32", "--epochs", "1",
                    "--workdir", str(tmp_path)])
    assert (tmp_path / "data" / "mvtec_32" / "grid" / "train").exists()
    assert not (tmp_path / "smoke_eval.json").exists()


def test_smoke_cli_builds_the_drn_l_commands(tmp_path, monkeypatch):
    """``--model-type drn-l`` passes through to both CLIs at full width (no
    DRCT capacity flags), reads the newest run dir under ``drn-l/`` and
    reports the evaluation's AUCs; the steps are stubbed."""
    cmds = []

    def fake_run(cmd, cwd, env):
        cmds.append(cmd)
        if "adsr_tpu_torch.cli.main" in cmd:
            run_dir = Path(cwd) / "workspace" / "experiment" / "drn-l" / \
                "mvtec_grid_128_X4smoke"
            (run_dir / "model").mkdir(parents=True)
        if "adsr_tpu_torch.cli.evaluate" in cmd:
            out = Path(cmd[cmd.index("--json-out") + 1])
            out.write_text(json.dumps({"auc_ssim": 0.5, "auc_mse": 0.75,
                                       "auc_psnr": 1.0}))
        return 0.0

    monkeypatch.setattr(smoke, "run", fake_run)
    res = smoke.main(["--model-type", "drn-l", "--resolution", "128",
                      "--epochs", "1", "--workdir", str(tmp_path)])
    prepare, train, evaluate = cmds
    assert prepare[2] == "adsr_tpu_torch.cli.prepare"
    assert prepare[prepare.index("--scales") + 1] == "4"   # LR_2 and LR_4
    assert train[2] == "adsr_tpu_torch.cli.main"
    assert train[train.index("--model-type") + 1] == "drn-l"
    assert train[train.index("--device") + 1] == "cuda"
    assert "--embed-dim" not in train and "--precision" not in train
    assert evaluate[2] == "adsr_tpu_torch.cli.evaluate"
    assert evaluate[evaluate.index("--run-dir") + 1] == res["run_dir"]
    assert res["run_dir"].endswith("drn-l/mvtec_grid_128_X4smoke")
    assert (res["auc_ssim"], res["auc_mse"], res["auc_psnr"]) == \
        (0.5, 0.75, 1.0)
