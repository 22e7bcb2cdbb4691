#!/usr/bin/env python3
"""What a serving user waits for, through the port's entry points as a
version of the repo ships them, on one CUDA card: the serving forward, the
request latency, tiled serving and the evaluate CLI, at the flagship DRCT
x4 @128px (8x8 windows) and at 256px/x4 (16x16 windows), random weights
from a seed, bf16, batch 16.

    python3 scripts/torch_serving_ab.py [--root DIR] [--calls N]

``--root`` is a checkout (or ``git archive``) of the repo whose
``adsr_tpu_torch`` is measured (default: this one), so two versions can be
compared on one card in one chip call, in turns (parent, change, change,
parent). Each entry point is called with its defaults only: a version that
serves through CUDA graphs does so here, an older one launches. Per
geometry, each a median over ``--calls`` calls after two warm calls (host
clock, every call ended by a synchronize), with the least and most call:

- ``forward_ms``: ``make_serving_forward(...)(lr)``, rdg mode, an LR batch
  of 16 on the card;
- ``request_ms``: ``AnomalyServer.score`` of 16 uint8 requests (numpy in,
  numpy out);
- ``tiled_img_per_s``: ``make_tiled_serving_forward`` on 16 LR images of a
  512 px HR (the flagship: 25 tiles of 32 LR px an image, overlap 8; 256px:
  4 tiles of 64, overlap 0, as ``chip_smoke.py``'s CLI phase);
- ``cli_evaluate_s``: ``cli.evaluate --checkpoint`` on a synthetic
  ``test/{good,bad}`` split of 8 + 8 PNGs of 512 px (LR by 4x4 block
  averaging), the 9-window sweep, the SR images written (a third of
  ``--calls`` calls, at least 2).

Writes the data and the checkpoints under ``<root>/workspace/serving_ab/``
and prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCH, SEED, TEST_HR, SCALE, N_TEST = 16, 0, 512, 4, 8
GEOMETRIES = {"128": 8, "256": 0}      # HR px -> the CLI's tile overlap


def host_ms(fn, calls: int) -> dict:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def write_split(base: Path, rng, n: int, defect: bool, write_png,
                grid_texture, inject_defect) -> None:
    (base / "HR").mkdir(parents=True)
    (base / "LR_bicubic" / f"X{SCALE}").mkdir(parents=True)
    s = TEST_HR // SCALE
    for i in range(n):
        img = grid_texture(rng, TEST_HR)
        if defect:
            img = inject_defect(rng, img, ("blob", "scratch")[i % 2])
        lr = img.reshape(s, SCALE, s, SCALE, 3).astype(np.float64) \
            .mean(axis=(1, 3)).round().astype(np.uint8)
        write_png(base / "HR" / f"{i:03d}.png", img)
        write_png(base / "LR_bicubic" / f"X{SCALE}" / f"{i:03d}x{SCALE}.png",
                  lr)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_ab: needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from adsr_tpu_torch.cli import evaluate as cli_eval
    from adsr_tpu_torch.core.config import drct_experiment
    from adsr_tpu_torch.data.synthetic import grid_texture, inject_defect
    from adsr_tpu_torch.eval.serving import AnomalyServer
    from adsr_tpu_torch.io.journal import save_state_dict
    from adsr_tpu_torch.io.png import write_png
    from adsr_tpu_torch.models.factory import init_sr_params
    from adsr_tpu_torch.train.trainer import (make_serving_forward,
                                              make_tiled_serving_forward)

    dev = torch.device("cuda")
    work = root / "workspace" / "serving_ab"
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.RandomState(SEED)
    data = work / "data"
    for split, defect in (("good", False), ("bad", True)):
        write_split(data / "grid" / "test" / split, rng, N_TEST, defect,
                    write_png, grid_texture, inject_defect)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "geometries": {}}
    for hr_px, overlap in GEOMETRIES.items():
        exp = drct_experiment("grid", int(hr_px), SCALE, precision="bf16",
                              batch_size=BATCH)
        cfg = exp.model
        params, _ = init_sr_params(cfg, torch.Generator().manual_seed(SEED),
                                   device=dev)
        ckpt = work / f"model_{hr_px}.pt"
        save_state_dict(ckpt, params)
        side = cfg.img_size
        lr_u8 = rng.randint(0, 256, (BATCH, side, side, 1), np.uint8)
        hr_u8 = rng.randint(0, 256, (BATCH, side * SCALE, side * SCALE, 1),
                            np.uint8)
        lr = torch.as_tensor(lr_u8, device=dev).float()
        lr_t = torch.as_tensor(
            rng.randint(0, 256, (BATCH, TEST_HR // SCALE, TEST_HR // SCALE,
                                 1)), device=dev).float()
        res = {}
        fwd = make_serving_forward(exp, params, device=dev,
                                   quantize_out=False, mode="rdg")
        res["forward_ms"] = host_ms(lambda: fwd(lr), args.calls)
        del fwd
        server = AnomalyServer(batch_size=BATCH, ssim_window=11, device=dev)
        server.register("grid", exp, params, mode="rdg")
        res["request_ms"] = host_ms(
            lambda: server.score("grid", lr_u8, hr_u8), args.calls)
        del server
        tiled = make_tiled_serving_forward(exp, params, overlap=overlap,
                                           quantize_out=False, device=dev,
                                           mode="rdg")
        ms = host_ms(lambda: tiled(lr_t), max(2, args.calls // 3))
        res["tiled_img_per_s"] = {"median": BATCH * 1e3 / ms["median"],
                                  "min": BATCH * 1e3 / ms["max"],
                                  "max": BATCH * 1e3 / ms["min"]}
        del tiled
        argv = ["--checkpoint", str(ckpt), "--data-root", str(data),
                "--resolution", hr_px, "--scale", str(SCALE),
                "--sweep-windows", "9", "--tile-overlap", str(overlap),
                "--output-dir", str(work / f"eval_{hr_px}")]
        ms = host_ms(lambda: cli_eval.main(argv), max(2, args.calls // 3))
        res["cli_evaluate_s"] = {k: v / 1e3 for k, v in ms.items()}
        out["geometries"][hr_px] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
