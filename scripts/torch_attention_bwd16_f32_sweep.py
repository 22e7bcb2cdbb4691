#!/usr/bin/env python3
"""Where the f32 instance of kernel (f) at 16x16 windows spends its time:
one RDG's five calls (dq and dkv launches, each block at its own shift) at
the 256px/x4 geometry (batch 16 on 64 x 64 tokens), on one CUDA card.

    python3 scripts/torch_attention_bwd16_f32_sweep.py

Builds variants of ``adsr_tpu_torch/csrc/window_attention_bwd16_f32.cu``
(and its ``_wide`` half) with the ablation switches of ``window_attention_bwd_f32.cuh`` set on
nvcc's command line, one shared library a variant (nvcc in parallel) under
``build/attention_bwd16_f32_sweep/``, and times each through the port's
wrapper (``window_attention_bwd`` on f32 tensors, the variant's library in
place of the package's), the five calls captured as a CUDA graph and
replayed 10 times between CUDA events (the kernel's also block by block):

- ``kernel``: the sources as they are (checked bitwise against the
  package's build);
- ``no_stage``: ``ATTN16_F32_STAGE=0``, the tiles' rows not loaded;
- ``x1``: ``ATTN16_F32_X3=0``, one TF32 product and no lo parts;
- ``no_term``: ``ATTN16_F32_TERM=0``, no bias / mask lookups and no exp;
- ``none``: the last three together: what is left is the barriers, the
  exchange, d(bias), D and the stores.

Prints ptxas's registers and spills of each variant, one line a variant,
and one JSON line with the card's name and power limit. Timing only: the
ablated variants' outputs are not the gradient.
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
from adsr_tpu_torch.kernels import window_attention_bwd as wab  # noqa: E402
from adsr_tpu_torch.kernels.rdg_gemm import pitched  # noqa: E402
from adsr_tpu_torch.kernels.window_attention import (  # noqa: E402
    softmax_stats, window_attention)
from adsr_tpu_torch.models.drct import shift_region_labels  # noqa: E402

OUT = ROOT / "build" / "attention_bwd16_f32_sweep"
# the entry and its head tiles past 64
SOURCES = ("window_attention_bwd16_f32.cu",
           "window_attention_bwd16_f32_wide.cu")
ENTRY = wab.F32_ENTRIES[16]
VARIANTS = {"kernel": [], "no_stage": ["ATTN16_F32_STAGE=0"], "x1": ["ATTN16_F32_X3=0"],
            "no_term": ["ATTN16_F32_TERM=0"],
            "none": ["ATTN16_F32_STAGE=0", "ATTN16_F32_X3=0",
                     "ATTN16_F32_TERM=0"]}
# (c, heads, shift) of the five blocks at 16x16 windows
BLOCKS = ((180, 6, 0), (212, 4, 8), (244, 2, 0), (276, 6, 8), (308, 4, 0))
SIDE, BATCH, WIN = 64, 16, 16


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
             str(_build.CSRC), "-shared",
             *[str(_build.CSRC / src) for src in SOURCES], "-o",
             str(out / "libattn16_f32.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.split("Used", 1)[1].strip() for line in
                log.splitlines() if "Used" in line]
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line and
                  "0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"[ptxas] {name}: {len(regs)} kernels, max "
              f"{max(int(r.split()[0]) for r in regs)} registers; "
              f"{len(spills)} with spills {spills[:4]}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "libattn16_f32.so"))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    m = BATCH * SIDE * SIDE
    calls = []
    for c, nh, shift in BLOCKS:
        qkv = pitched(m, 3 * c, torch.float32, dev)
        qkv.copy_(torch.randn(m, 3 * c, generator=gen, device=dev))
        dout = pitched(m, c, torch.float32, dev)
        dout.copy_(torch.randn(m, c, generator=gen, device=dev))
        bias = 0.5 * torch.randn(nh, 961, generator=gen, device=dev)
        mask = (torch.as_tensor(shift_region_labels(SIDE, SIDE, WIN, shift),
                                device=dev) if shift else None)
        ctx = pitched(m, c, torch.float32, dev)
        stats = softmax_stats(qkv, SIDE, SIDE, nh, WIN)
        window_attention(qkv, ctx, bias, mask, SIDE, SIDE, nh, WIN, shift,
                         stats)
        calls.append((qkv, dout, bias, mask, nh, shift,
                      pitched(m, 3 * c, torch.float32, dev),
                      torch.empty(nh, 256, 256, device=dev), ctx, stats))

    def run():
        for qkv, dout, bias, mask, nh, shift, dqkv, dbias, ctx, stats \
                in calls:
            wab.window_attention_bwd(qkv, dout, bias, mask, SIDE, SIDE, nh,
                                     WIN, shift, dqkv, dbias, ctx, stats)

    run()
    want = [(x[6].clone(), x[7].clone()) for x in calls]
    libs = build()
    package_library = _build.library
    results = {}
    try:
        for name, lib in libs.items():
            _build.library = lambda lib=lib: lib
            run()
            if name == "kernel" and not all(
                    torch.equal(x[6], w[0]) and torch.equal(x[7], w[1])
                    for x, w in zip(calls, want)):
                raise AssertionError("the kernel variant differs from the "
                                     "package's build")
            results[name] = graph_ms(run)
            print(f"[sweep] {name:8s} one RDG: {results[name]:.4f} ms",
                  flush=True)
            if name == "kernel":        # each block's call alone
                for (c, nh, shift), call in zip(BLOCKS, calls):
                    one = graph_ms(lambda call=call: wab.window_attention_bwd(
                        call[0], call[1], call[2], call[3], SIDE, SIDE, nh,
                        WIN, shift, call[6], call[7], call[8], call[9]))
                    results[f"kernel_c{c}"] = one
                    print(f"[sweep] kernel   c={c} heads={nh} hd={c // nh}: "
                          f"{one:.4f} ms", flush=True)
    finally:
        _build.library = package_library
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
