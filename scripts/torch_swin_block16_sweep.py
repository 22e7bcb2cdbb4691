#!/usr/bin/env python3
"""Where kernel (g) ``swin_block`` spends its time at 16x16 windows
(N = 256), on one CUDA card at the 256px/x4 shapes (batch 16, 64 x 64
tokens, the five Swin blocks of one RDG, a cluster of four blocks a window).

    python3 scripts/torch_swin_block16_sweep.py

Builds variants of ``adsr_tpu_torch/csrc/swin_block16.cu`` by text edits
into ``build/swin_block16_sweep/`` (one shared library each, nvcc in
parallel) and times one RDG's five launches of each through its C entry
point (CUDA events over 20 launches):

- ``kernel``: the source as it is, checked against the plain version, at
  the plan's ring depth and at 2 and 4 stages;
- ``no_pull``: the peers' K and V tiles not pulled into the staging pair
  (the attention reads stale tiles; timing only);
- ``no_attention``: the attention core left out (the context is not a
  number; timing only);
- ``no_pull_no_attention``: both.

Prints ptxas's registers and spills of each variant, then one line per
variant and block, and one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from adsr_tpu_torch.core.config import drct_experiment  # noqa: E402
from adsr_tpu_torch.kernels import _build  # noqa: E402
from adsr_tpu_torch.kernels.fused_rdg import rdg_geometry  # noqa: E402
from adsr_tpu_torch.kernels.fused_swin_block import (  # noqa: E402
    STAGE_BYTES, fused_swin_block_plain, swin_block_plan)
from adsr_tpu_torch.kernels.rdg_gemm import pitched  # noqa: E402
from adsr_tpu_torch.kernels.rdg_layernorm import EPS  # noqa: E402
from adsr_tpu_torch.models.drct import shift_attn_mask  # noqa: E402

SRC = _build.CSRC / "swin_block16.cu"
OUT = ROOT / "build" / "swin_block16_sweep"
BATCH, SIDE, WIN = 16, 64, 16
PULL = "        pull(smem + L.ctx, s_q + plane_bytes, kt, 2 * plane_bytes);"
CORE = "      if (wg == 0) {\n        float s[8][4];"
VARIANTS = {
    "kernel": [],
    "no_pull": [(PULL, "        if (a.nh < 0) " + PULL.lstrip())],
    "no_attention": [(CORE, CORE.replace("wg == 0", "wg == 0 && a.nh < 0"))],
    "no_pull_no_attention": [
        (PULL, "        if (a.nh < 0) " + PULL.lstrip()),
        (CORE, CORE.replace("wg == 0", "wg == 0 && a.nh < 0"))],
}
STAGES = (2, 4)          # besides the plan's, for the unedited kernel


def build() -> dict:
    """{variant: ctypes entry point}, each built from the edited source."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            src = src.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line and "Used" in line]
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line]
        print(f"[ptxas] {name}: " + " | ".join(
            f"{r}; {s}" for r, s in zip(regs, spills)), flush=True)
        fn = ctypes.CDLL(str(so)).adsr_swin_block16
        fn.argtypes = _build.SIGNATURES["adsr_swin_block16"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = drct_experiment("grid", 256, 4).model
    g = rdg_geometry(cfg)
    m = BATCH * SIDE * SIDE
    masks = {8: torch.as_tensor(shift_attn_mask(SIDE, SIDE, WIN, 8),
                                device=dev)}
    cat = torch.randn(m, g["cat_width"], generator=gen,
                      device=dev).to(torch.bfloat16)

    def randn(*shape, std, bf16=False):
        t = torch.randn(*shape, generator=gen, device=dev) * std
        if not bf16:
            return t
        out = pitched(*shape, device=dev)
        out.copy_(t)
        return out

    cases = []
    for k in range(5):
        c, f, nh = g["feats"][k], g["hidden"][k], g["heads"][k]
        p = {"ln1_w": 1 + randn(c, std=0.1), "ln1_b": randn(c, std=0.1),
             "ln2_w": 1 + randn(c, std=0.1), "ln2_b": randn(c, std=0.1),
             "wqkv": randn(3 * c, c, std=0.05, bf16=True),
             "bqkv": randn(3 * c, std=0.05),
             "wproj": randn(c, c, std=0.05, bf16=True),
             "bproj": randn(c, std=0.05),
             "w1": randn(f, c, std=0.05, bf16=True), "b1": randn(f, std=0.05),
             "w2": randn(c, f, std=0.05, bf16=True), "b2": randn(c, std=0.05),
             "attn_bias": randn(nh, 256, 256, std=0.5)}
        cases.append({"k": k, "c": c, "f": f, "nh": nh,
                      "shift": g["shifts"][k], "p": p,
                      "plan": swin_block_plan(c, f, nh, BATCH, SIDE, SIDE,
                                              window=WIN),
                      "out": torch.empty(m, c, dtype=torch.bfloat16,
                                         device=dev)})
    fns = build()

    def launch(fn, case, stages):
        p, c, x, out = case["p"], case["c"], cat, case["out"]
        mask = masks.get(case["shift"])
        smem = case["plan"]["smem_bytes"] \
            + (stages - case["plan"]["stages"]) * (STAGE_BYTES + 16)
        rc = fn(x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
                p["ln1_w"].data_ptr(), p["ln1_b"].data_ptr(),
                p["wqkv"].data_ptr(), p["wqkv"].stride(0),
                p["bqkv"].data_ptr(), p["attn_bias"].data_ptr(),
                None if mask is None else mask.data_ptr(),
                p["wproj"].data_ptr(), p["wproj"].stride(0),
                p["bproj"].data_ptr(), p["ln2_w"].data_ptr(),
                p["ln2_b"].data_ptr(), p["w1"].data_ptr(), p["w1"].stride(0),
                p["b1"].data_ptr(), p["w2"].data_ptr(), p["w2"].stride(0),
                p["b2"].data_ptr(), BATCH, SIDE, SIDE, c, case["f"],
                case["nh"], WIN, case["shift"], stages, EPS, smem,
                _build.stream_ptr(x))
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    result = {}
    for name, fn in fns.items():
        total = 0.0
        for case in cases:
            s0 = case["plan"]["stages"]
            if name == "kernel":
                launch(fn, case, s0)
                torch.cuda.synchronize()
                want = fused_swin_block_plain(cat[:, :case["c"]], case["p"],
                                              masks, cfg, SIDE, SIDE,
                                              case["k"])
                err = (case["out"].float() - want).abs()
                if bool((err > 4e-2 + 2.0 ** -7 * want.abs()).any()):
                    raise AssertionError(f"c={case['c']}: beyond the "
                                         "tolerance of chip_smoke.py")
            stages = sorted({s0, *(s for s in STAGES if s < s0)}) \
                if name == "kernel" else [s0]
            ms = {s: cuda_ms(lambda: launch(fn, case, s)) for s in stages}
            total += ms[s0]
            result.setdefault(name, {})[case["c"]] = ms
            print(f"[sweep] {name:20s} c={case['c']} heads={case['nh']}: "
                  f"plan {s0} stages {ms[s0]:.4f} ms; " + " ".join(
                      f"{s} stages {v:.4f}" for s, v in ms.items()),
                  flush=True)
        result.setdefault("rdg_ms_at_plan", {})[name] = total
        print(f"[sweep] {name:20s} one RDG at the plan's stages: "
              f"{total:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
