"""Data prep entry point, the port of ``adsr_tpu/cli/prepare.py`` (reference
scripts/prepare_mvtec_data.py:258-312 parity):

    python -m adsr_tpu_torch.cli.prepare --hr-size 128 --scales 4
    python -m adsr_tpu_torch.cli.prepare --hr-size 32 --scales 4 --synthetic

--synthetic generates a procedural MVTec-like source tree first, so the full
pipeline runs without the (non-redistributable) real dataset. Runs on the
host in numpy (``data/prepare.py``), with no PIL: its LANCZOS resizes give
Pillow's bytes, so the tree equals the JAX CLI's default (PIL) output.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description="MVTec AD dataset preparation")
    # 512 is a superset of the reference tool's 256/128/64/32
    # (scripts/prepare_mvtec_data.py:6): BASELINE.md's best grid row is
    # 512px/x8, which the reference feeds from a pre-sized tree instead
    p.add_argument("--hr-size", type=int, default=128,
                   choices=[512, 256, 128, 64, 32])
    p.add_argument("--scales", type=str, default="4",
                   help="Comma-separated downscale factors: 4,8")
    p.add_argument("--val-ratio", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--source", type=str, default="data/mvtec")
    p.add_argument("--target", type=str, default="")
    p.add_argument("--classes", type=str, default="carpet,grid")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic source tree first")
    p.add_argument("--synthetic-train", type=int, default=24)
    p.add_argument("--use-native", action="store_true",
                   help="accepted and ignored: the port has one resampler, "
                        "numpy, and it gives Pillow's bytes")
    p.add_argument("--no-clean", action="store_true",
                   help="keep existing target classes (default wipes the "
                        "target dir, matching the reference prep tool)")
    p.add_argument("--layout", type=str, default="mvtec",
                   choices=["mvtec", "gkd"],
                   help="'gkd' writes train under "
                        "{classe}/train/HR_{hr-size} — the path the train "
                        "CLI derives for --dataset gkd (core/config.py); "
                        "val/test keep the shared good/bad convention")
    args = p.parse_args(argv)

    from adsr_tpu_torch.data.prepare import (expand_scales,
                                             prepare_mvtec_dataset,
                                             verify_dataset_structure)

    classes = tuple(c.strip() for c in args.classes.split(",") if c.strip())
    try:
        user_scales = sorted({int(s) for s in args.scales.split(",") if s.strip()})
    except ValueError:
        p.error("Invalid --scales. Use comma-separated integers from {4,8}")
    for s in user_scales:
        if s not in (2, 4, 8):
            p.error("Only scales 2, 4 and/or 8 are supported")

    if args.synthetic:
        from adsr_tpu_torch.data.synthetic import generate_synthetic_mvtec
        missing = tuple(c for c in classes
                        if not (Path(args.source) / c / "train").exists())
        if missing:
            print(f"Generating synthetic MVTec-like source for {missing} "
                  f"at {args.source}")
            generate_synthetic_mvtec(args.source, classes=missing,
                                     n_train=args.synthetic_train)
    if not Path(args.source).exists():
        print(f"ERROR: Source data not found at {args.source}")
        return 1

    target = args.target or (f"data/mvtec_{args.hr_size}"
                             if args.layout == "mvtec" else "workspace/gkd")
    scale_factors = expand_scales(user_scales)
    print(f"Preparing {classes} at HR {args.hr_size} with LR scales "
          f"{scale_factors} -> {target} ({args.layout} layout)")
    prepare_mvtec_dataset(args.source, target, classes=classes,
                          scale_factors=scale_factors,
                          target_hr=(args.hr_size, args.hr_size),
                          val_ratio=args.val_ratio, seed=args.seed,
                          clean=not args.no_clean, layout=args.layout)
    report = verify_dataset_structure(target, classes=classes,
                                      layout=args.layout,
                                      hr_size=args.hr_size)
    for classe, counts in report.items():
        print(f"  {classe}: " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    print("Dataset preparation complete!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
