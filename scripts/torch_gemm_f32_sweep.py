#!/usr/bin/env python3
"""Where the f32 instance of kernel (b) spends its time: one flagship RDG's
25 f32 products (qkv, proj, fc1, fc2 and adjust of the five blocks, their
main-path epilogues) at 16,384 (window 8), 4,096 (window 4) and 65,536
(window 16) token rows, on one CUDA card.

    python3 scripts/torch_gemm_f32_sweep.py

Builds variants of ``adsr_tpu_torch/csrc/rdg_gemm_f32.cu`` with its
ablation switches set on nvcc's command line, one shared library a variant
(nvcc in parallel) under ``build/gemm_f32_sweep/``, and times each through
the port's wrapper (``rdg_gemm`` on f32 tensors, the variant's library in
place of the package's), the 25 products captured as a CUDA graph and
replayed 10 times between CUDA events:

- ``kernel``: the source as it is (checked bitwise against the package's
  build);
- ``no_split``: ``RDG_F32_SPLIT=0``, the split warps pass each stage on
  untouched;
- ``x1``: ``RDG_F32_X3=0``, one TF32 product a k8 step instead of three;
- ``none``: both: the TMA ring, one product and the epilogue.

Prints ptxas's registers of each variant, one line a variant and window,
and one JSON line with the card's name and power limit. Timing only: the
ablated variants' outputs are not the product.
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
from adsr_tpu_torch.kernels.rdg_gemm import pitched, rdg_gemm  # noqa: E402

OUT = ROOT / "build" / "gemm_f32_sweep"
SOURCE = "rdg_gemm_f32.cu"
ENTRY = "adsr_rdg_gemm_f32"
VARIANTS = {"kernel": [], "no_split": ["RDG_F32_SPLIT=0"],
            "x1": ["RDG_F32_X3=0"],
            "none": ["RDG_F32_SPLIT=0", "RDG_F32_X3=0"]}
FEATS, HIDDEN = (180, 212, 244, 276, 308), (360, 424, 488, 276, 308)
ROWS = {"w8": 16384, "w4": 4096, "w16": 65536}


def build() -> dict:
    """{variant: namespace with the variant's C entry}, each the source
    compiled with the variant's defines into a shared library of its own."""
    nvcc = _build._nvcc()
    procs = {}
    for name, defines in VARIANTS.items():
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *[f"-D{d}" for d in defines], "-I",
             str(_build.CSRC), "-shared", str(_build.CSRC / SOURCE), "-o",
             str(out / "libgemm_f32.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [int(line.split("Used", 1)[1].split()[0]) for line in
                log.splitlines() if "Used" in line]
        print(f"[ptxas] {name}: {len(regs)} kernels, {min(regs)}-"
              f"{max(regs)} registers; C7520 {'C7520' in log}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "libgemm_f32.so"))
        fn = getattr(lib, ENTRY)
        fn.argtypes = _build.SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        libs[name] = types.SimpleNamespace(**{ENTRY: fn})
    return libs


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


def products(m: int, dev, gen) -> list:
    """One flagship RDG's 25 products at ``m`` token rows: (a, w, bias,
    out, epilogue, residual), every operand in 16-byte rows."""
    def rand(r, c, std=1.0):
        t = pitched(r, c, torch.float32, dev)
        t.copy_(std * torch.randn(r, c, generator=gen, device=dev))
        return t

    cases = []
    for k, (c, f) in enumerate(zip(FEATS, HIDDEN)):
        x, ctx, hid = rand(m, c), rand(m, c), rand(m, f)
        for n, src, epi in ((3 * c, x, "none"), (c, ctx, "residual"),
                            (f, x, "gelu"), (c, hid, "residual"),
                            (180 if k == 4 else 32, x,
                             "scaled_residual" if k == 4 else "leaky_relu")):
            res = rand(m, n) if "residual" in epi else None
            cases.append((src, rand(n, src.shape[1], 0.05),
                          0.05 * torch.randn(n, generator=gen, device=dev),
                          rand(m, n), epi, res))
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    libs = build()
    package_library = _build.library
    results = {}
    for tag, m in ROWS.items():
        cases = products(m, dev, gen)

        def run():
            for a, w, bias, out, epi, res in cases:
                rdg_gemm(a, w, bias, out, epi, res)

        run()
        want = [c[3].clone() for c in cases]
        try:
            for name, lib in libs.items():
                _build.library = lambda lib=lib: lib
                run()
                if name == "kernel" and not all(
                        torch.equal(c[3], w) for c, w in zip(cases, want)):
                    raise AssertionError("the kernel variant differs from "
                                         "the package's build")
                results[f"{name}_{tag}"] = graph_ms(run)
                print(f"[sweep] {tag} {name:8s} one RDG: "
                      f"{results[f'{name}_{tag}']:.4f} ms", flush=True)
        finally:
            _build.library = package_library
        del cases, want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
