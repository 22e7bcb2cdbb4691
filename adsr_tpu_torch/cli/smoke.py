"""End-to-end smoke test, the port of ``adsr_tpu/cli/smoke.py`` (reference
scripts/smoke_test.py:36-152 equivalent):

prepare (synthetic grid) -> train through ``cli.main`` -> the newest run dir
-> evaluate through ``cli.evaluate``, each step a subprocess of the real CLI
with ``PYTHONPATH`` set to the repo, so the whole flag surface is exercised
across process boundaries. Everything is written under ``--workdir``.

    python -m adsr_tpu_torch.cli.smoke --workdir workspace/smoke --full-size
    python -m adsr_tpu_torch.cli.smoke --device cpu     # tiny DRCT, f32

    python -m adsr_tpu_torch.cli.smoke --model-type drn-l --resolution 128

``--device cuda`` (the default) trains and serves through the card (DRCT
through its kernels) and fails without a card, each CLI at its default
precision as the JAX smoke: ``cli.main`` trains in bf16 and
``cli.evaluate`` scores in fp32 (DRCT's f32 kernels); ``--device cpu``
runs the plain PyTorch path in f32 (``--precision fp32`` to both CLIs). Without
``--full-size`` a DRCT is a tiny one (embed 24, one RDG, two heads); DRN-L
always runs at full width, as in the JAX smoke (its run dir also holds
``dual_model_latest.pt``). A failed step exits non-zero. The last line is
``SMOKE OK`` with the three AUCs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

TINY = ["--embed-dim", "24", "--num-layers", "1", "--num-heads", "2"]


def run(cmd, cwd, env) -> float:
    """Run one step; returns its wall seconds, exits on a failure."""
    print("+", " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=cwd, env=env)
    if proc.returncode != 0:
        raise SystemExit(f"step failed ({proc.returncode}): {' '.join(cmd)}")
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="prepare -> train -> evaluate "
                                            "through the port's CLIs")
    p.add_argument("--workdir", type=str, default="workspace/smoke")
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda (default) runs the hand-written kernels; cpu "
                        "runs the plain PyTorch path in f32. Nothing falls "
                        "back.")
    p.add_argument("--model-type", type=str, default="drct",
                   choices=["drct", "drn-l"])
    p.add_argument("--full-size", action="store_true",
                   help="use reference-size DRCT instead of the tiny smoke one")
    args = p.parse_args(argv)

    wd = Path(args.workdir).absolute()
    wd.mkdir(parents=True, exist_ok=True)
    py = sys.executable
    repo = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        part for part in (repo, env.get("PYTHONPATH")) if part)
    precision = ["--precision", "fp32"] if args.device == "cpu" else []
    walls = {}

    # 1. prepare synthetic grid data
    walls["prepare"] = run(
        [py, "-m", "adsr_tpu_torch.cli.prepare", "--hr-size",
         str(args.resolution), "--scales", "4", "--classes", "grid",
         "--synthetic"], wd, env)

    # 2. train
    train_cmd = [py, "-m", "adsr_tpu_torch.cli.main", "--model-type",
                 args.model_type, "--classe", "grid", "--resolution",
                 str(args.resolution), "--scale", "4", "--epochs",
                 str(args.epochs), "--batch-size", "4", "--device",
                 args.device, "--run-tag", "smoke"] + precision
    if args.model_type == "drct" and not args.full_size:
        train_cmd += TINY
    walls["train"] = run(train_cmd, wd, env)

    # 3. newest run dir
    exp_root = wd / "workspace" / "experiment" / args.model_type
    run_dirs = sorted(exp_root.glob("mvtec_grid_*"), key=os.path.getmtime)
    if not run_dirs:
        raise SystemExit(f"no run dir under {exp_root}")
    run_dir = run_dirs[-1]
    print(f"run dir: {run_dir}")

    # 4. evaluate
    json_out = wd / "smoke_eval.json"
    walls["evaluate"] = run(
        [py, "-m", "adsr_tpu_torch.cli.evaluate", "--run-dir", str(run_dir),
         "--device", args.device, "--json-out", str(json_out)] + precision,
        wd, env)

    result = json.loads(json_out.read_text())
    print("step walls: " + ", ".join(f"{k} {v:.1f} s"
                                     for k, v in walls.items()))
    print(f"SMOKE OK  auc_ssim={result['auc_ssim']:.3f} "
          f"auc_mse={result['auc_mse']:.3f} auc_psnr={result['auc_psnr']:.3f}")
    return {"walls_s": walls, "run_dir": str(run_dir),
            **{k: result[k] for k in ("auc_ssim", "auc_mse", "auc_psnr")}}


if __name__ == "__main__":
    main()
