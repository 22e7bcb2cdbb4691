#!/usr/bin/env python3
"""Where the f32 instance of kernel (d) spends its time, and how close each
variant comes to the plain f32 products: one flagship RDG's 25 dgrad and 25
wgrad products (adjust, fc2, fc1, proj and qkv of the five blocks, with the
training backward's dY transforms) at 16,384 (window 8), 4,096 (window 4)
and 65,536 (window 16) token rows, on one CUDA card.

    python3 scripts/torch_gemm_bwd_f32_sweep.py

Builds variants of ``adsr_tpu_torch/csrc/rdg_gemm_bwd_f32.cu`` with its
switches set on nvcc's command line, one shared library a variant (nvcc in
parallel) under ``build/gemm_bwd_f32_sweep/``, and times each through the
port's wrappers (the variant's library in place of the package's): both
products of each call (``rdg_gemm_grads``), dgrad alone and wgrad alone
(each with its pre-pass), the 25 calls captured as a CUDA graph and
replayed 10 times between CUDA events; then the largest relative L2 of dA
and of dW against the plain f32 products (TF32 off) over the 25:

- ``kernel``: the source as it is (checked bitwise against the package's
  build);
- ``rna``: ``RDG_BWD_F32_SPLIT=1``, hi and lo both rounded to nearest
  (tf32_mma.cuh) in place of the source's truncated hi and raw lo;
- ``one_level``: ``RDG_BWD_F32_TWO_LEVEL=0``, each product's sums in one
  level (three blocks an SM);
- ``no_split`` (``RDG_BWD_F32_SPLIT=0``) and ``x1`` (``RDG_BWD_F32_X3=0``):
  no split arithmetic, one TF32 product: timing only, their outputs are
  not the product.

Prints ptxas's registers and spills of each variant, one line a variant and
window, and one JSON line with the card's name and power limit.
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
from adsr_tpu_torch.kernels import rdg_gemm_bwd as gb  # noqa: E402
from adsr_tpu_torch.kernels.rdg_gemm import pitched  # noqa: E402

OUT = ROOT / "build" / "gemm_bwd_f32_sweep"
SOURCE = "rdg_gemm_bwd_f32.cu"
ENTRY = "adsr_rdg_gemm_grads_f32"
VARIANTS = {"kernel": [], "rna": ["RDG_BWD_F32_SPLIT=1"],
            "one_level": ["RDG_BWD_F32_TWO_LEVEL=0"],
            "no_split": ["RDG_BWD_F32_SPLIT=0"], "x1": ["RDG_BWD_F32_X3=0"]}
EXACT = ("kernel", "rna", "one_level")
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
             str(out / "libgemm_bwd_f32.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = [line for line in log.splitlines()
                 if "Used" in line or "spill stores" in line]
        print(f"[ptxas] {name}: " + " | ".join(x.split(":", 1)[-1].strip()
                                              for x in lines), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "libgemm_bwd_f32.so"))
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
    """One flagship RDG's 25 backward products at ``m`` token rows: (dy, w,
    a, kwargs, dA, dW, db), the operands in 16-byte rows."""
    def rand(r, c, std=1.0):
        t = pitched(r, c, torch.float32, dev)
        t.copy_(std * torch.randn(r, c, generator=gen, device=dev))
        return t

    scale = torch.ones(16, device=dev)
    scale[1] = 0.0
    cases = []
    for k, (c, f) in enumerate(zip(FEATS, HIDDEN)):
        a = 180 if k == 4 else 32
        act, hid, ctx = rand(m, c), rand(m, f), rand(m, c)
        adj = {"alpha": 0.2} if k == 4 else {"slope_src": rand(m, a)}
        for n, src, kw in ((a, act, adj),
                           (c, hid, {"row_scale": scale,
                                     "gelu_pre": rand(m, f)}),
                           (f, act, {}), (c, ctx, {"row_scale": scale}),
                           (3 * c, act, {})):
            kk = src.shape[1]
            cases.append((rand(m, n), rand(n, kk, 0.05), src, kw,
                          torch.empty(m, kk, device=dev),
                          torch.empty(n, kk, device=dev),
                          torch.empty(n, device=dev)))
    return cases


def rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm()).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    libs = build()
    package_library = _build.library
    results = {}
    for tag, m in ROWS.items():
        cases = products(m, dev, gen)

        def both():
            for dy, w, a, kw, da, dw, db in cases:
                gb.rdg_gemm_grads(dy, w, a, da, dw, db, **kw)

        def dgrad():
            for dy, w, a, kw, da, dw, db in cases:
                gb.rdg_gemm_dgrad(dy, w, da, **kw)

        def wgrad():
            for dy, w, a, kw, da, dw, db in cases:
                gb.rdg_gemm_wgrad(dy, a, dw, db, **{
                    key: v for key, v in kw.items() if key != "gelu_pre"})

        both()
        want = [(c[4].clone(), c[5].clone()) for c in cases]
        plain = [(gb.rdg_gemm_dgrad_plain(dy, w, **kw),
                  gb.rdg_gemm_wgrad_plain(dy, a, **{
                      key: v for key, v in kw.items()
                      if key != "gelu_pre"})[0])
                 for dy, w, a, kw, *_ in cases]
        try:
            for name, lib in libs.items():
                _build.library = lambda lib=lib: lib
                both()
                if name == "kernel" and not all(
                        torch.equal(c[4], x) and torch.equal(c[5], y)
                        for c, (x, y) in zip(cases, want)):
                    raise AssertionError("the sweep's kernel build differs "
                                         "from the package's")
                err = {}
                if name in EXACT:
                    err = {"dA": max(rel_l2(c[4], p[0])
                                     for c, p in zip(cases, plain)),
                           "dW": max(rel_l2(c[5], p[1])
                                     for c, p in zip(cases, plain))}
                row = {"both_ms": graph_ms(both), "dgrad_ms": graph_ms(dgrad),
                       "wgrad_ms": graph_ms(wgrad), **err}
                results[f"{name}_{tag}"] = row
                print(f"{tag} {name:15s} " + " ".join(
                    f"{k} {v:.4f}" if k.endswith("ms") else f"{k} {v:.2e}"
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
