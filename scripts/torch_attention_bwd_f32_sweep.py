#!/usr/bin/env python3
"""Where the f32 instance of kernel (f) spends its time at 4x4 and 8x8
windows (N = 16 and 64), and how close it comes to the plain f32 backward:
one flagship RDG's five calls (head dims 30, 53, 122, 46, 77, each block at
its own shift) at batch 16 on 32 x 32 tokens (window 8) and 16 x 16
(window 4), on one CUDA card.

    python3 scripts/torch_attention_bwd_f32_sweep.py

Builds variants of ``adsr_tpu_torch/csrc/window_attention_bwd_f32.cu`` and
``window_attention_bwd4_f32.cu`` (on ``window_attention_bwd_f32.cuh``)
with its switches set on nvcc's command line, one shared library a variant
and window (nvcc in parallel) under ``build/attention_bwd_f32_sweep/``,
and times each through the port's wrapper (``window_attention_bwd`` on f32
tensors, the variant's libraries in place of the package's), the five
calls captured as a CUDA graph and replayed 10 times between CUDA events;
then, for the kernel as it is, the largest relative L2 of dqkv and d(bias)
against the plain f32 version over the five:

- ``kernel``: the source as it is (checked bitwise against the package's
  build);
- ``x1`` (``ATTN16_F32_X3=0``: one TF32 product of three), ``no_term``
  (``ATTN_BWD_F32_TERM=0``: no bias and mask lookups, no exp), ``no_stage``
  (``ATTN_BWD_F32_STAGE=0``: no rows loaded), ``no_store``
  (``ATTN_BWD_F32_STORE=0``: dQ, dK and dV not written) and
  ``no_stage_no_store`` (both: the products, softmax and barriers alone):
  timing only, their outputs are not the gradient.

Prints ptxas's registers and spills of each variant, one line a variant
and window, and one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from adsr_tpu_torch.kernels import _build  # noqa: E402
from adsr_tpu_torch.kernels import window_attention_bwd as ab  # noqa: E402
from adsr_tpu_torch.kernels.rdg_gemm import pitched  # noqa: E402
from adsr_tpu_torch.models.drct import shift_attn_mask  # noqa: E402

OUT = ROOT / "build" / "attention_bwd_f32_sweep"
SOURCES = {8: "window_attention_bwd_f32.cu", 4: "window_attention_bwd4_f32.cu"}
VARIANTS = {"kernel": [], "x1": ["ATTN16_F32_X3=0"],
            "no_term": ["ATTN_BWD_F32_TERM=0"],
            "no_stage": ["ATTN_BWD_F32_STAGE=0"],
            "no_store": ["ATTN_BWD_F32_STORE=0"],
            "no_stage_no_store": ["ATTN_BWD_F32_STAGE=0",
                                  "ATTN_BWD_F32_STORE=0"]}
FEATS, HEADS = (180, 212, 244, 276, 308), (6, 4, 2, 6, 4)
GEOMETRIES = {"w8": (8, 32), "w4": (4, 16)}


def build() -> dict:
    """{variant: namespace with the two C entries}, each window's source
    compiled with the variant's defines into a shared library of its own."""
    nvcc = _build._nvcc()
    procs = {}
    for name, defines in VARIANTS.items():
        for win, src in SOURCES.items():
            out = OUT / name
            out.mkdir(parents=True, exist_ok=True)
            procs[name, win] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, *[f"-D{d}" for d in defines],
                 "-I", str(_build.CSRC), "-shared", str(_build.CSRC / src),
                 "-o", str(out / f"libattn_bwd{win}.so")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {name: {} for name in VARIANTS}
    for (name, win), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {win}:\n{log}")
        regs = [int(line.split("Used", 1)[1].split()[0])
                for line in log.splitlines() if "Used" in line]
        spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                     for line in log.splitlines() if "spill stores" in line)
        print(f"[ptxas] {name} window {win}: {len(regs)} kernels, "
              f"{min(regs)}-{max(regs)} registers, {spills} spill bytes",
              flush=True)
        entry = ab.F32_ENTRIES[win]
        lib = ctypes.CDLL(str(OUT / name / f"libattn_bwd{win}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs[name][entry] = fn
    return {name: types.SimpleNamespace(**fns) for name, fns in libs.items()}


def graph_ms(fn, iters: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def calls(win: int, side: int, dev, gen) -> list:
    """One RDG's five (f) f32 calls at batch 16 on ``side`` x ``side``
    tokens: (qkv, dout, bias, mask, heads, shift, dqkv, dbias)."""
    m, n = 16 * side * side, win * win
    out = []
    for k, (c, nh) in enumerate(zip(FEATS, HEADS)):
        shift = (k % 2) * win // 2
        qkv = pitched(m, 3 * c, torch.float32, dev)
        qkv.copy_(torch.randn(m, 3 * c, generator=gen, device=dev))
        dout = pitched(m, c, torch.float32, dev)
        dout.copy_(torch.randn(m, c, generator=gen, device=dev))
        bias = 0.5 * torch.randn(nh, n, n, generator=gen, device=dev)
        mask = (torch.as_tensor(shift_attn_mask(side, side, win, shift),
                                device=dev) if shift else None)
        out.append((qkv, dout, bias, mask, nh, shift,
                    pitched(m, 3 * c, torch.float32, dev),
                    torch.empty(nh, n, n, device=dev)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    libs = build()
    package_library = _build.library
    results = {}
    for tag, (win, side) in GEOMETRIES.items():
        cases = calls(win, side, dev, gen)

        def run():
            for qkv, dout, bias, mask, nh, shift, dqkv, dbias in cases:
                ab.window_attention_bwd(qkv, dout, bias, mask, side, side,
                                        nh, win, shift, dqkv, dbias)

        run()
        want = [(c[6].clone(), c[7].clone()) for c in cases]
        plain = [ab.window_attention_bwd_plain(qkv, dout, bias, mask, side,
                                               side, nh, win, shift)
                 for qkv, dout, bias, mask, nh, shift, _, _ in cases]
        try:
            for name, lib in libs.items():
                _build.library = lambda lib=lib: lib
                run()
                row = {"ms": graph_ms(run)}
                if name == "kernel":
                    if not all(torch.equal(c[6], q) and torch.equal(c[7], d)
                               for c, (q, d) in zip(cases, want)):
                        raise AssertionError("the sweep's kernel build "
                                             "differs from the package's")
                    row["rel_l2"] = max(
                        max(((c[6] - q).norm() / q.norm()).item(),
                            ((c[7] - d).norm() / d.norm()).item())
                        for c, (q, d) in zip(cases, plain))
                results[f"{name}_{tag}"] = row
                print(f"{tag} {name:18s} " + " ".join(
                    f"{k} {v:.4f}" if k == "ms" else f"{k} {v:.2e}"
                    for k, v in row.items()), flush=True)
        finally:
            _build.library = package_library
        del cases, want, plain
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
