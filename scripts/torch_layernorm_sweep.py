#!/usr/bin/env python3
"""Where kernel (a) ``rdg_layernorm`` spends its time, on one CUDA card at
the three token geometries: 64/x4 (4x4 windows, M = 4,096 rows at batch
16), the flagship (8x8, M = 16,384) and 256px/x4 (16x16, M = 65,536), each
one RDG's ten launches (LN1 over the concat prefix ``cat[:, :c]`` and LN2
over ``x1`` at the five block widths 180-308, every output into one
scratch) replayed as a CUDA graph, as ``chip_smoke.py``'s timing phase
takes them.

    python3 scripts/torch_layernorm_sweep.py [--root DIR]

``--root`` takes the package and the sources of another tree (a ``git
archive`` of the parent unpacked under ``workspace/``), so one script
times both sides of a change. Builds variants of the tree's
``csrc/rdg_layernorm.cu`` by text edits into
``build/layernorm_sweep/<tree>/`` (one shared library each, nvcc in
parallel) and calls each through the tree's own wrapper with the wrapper's
library swapped for the variant's (and, on a tree with
``rdg_layernorm_plan``, the plan's lanes a row and the blocks an SM holds
read from the variant). Variants:

- ``kernel``: the source as it is;
- ``no_load``: without the loads of the rows (values made in registers);
  ``no_store``: without the stores of the outputs (kept live by a test
  that never holds); ``no_compute`` (the redesign): each row stored as it
  came (a copy in the kernel's own loads and stores). Wrong outputs,
  timing only;
- the redesign's other plans and pieces: ``lanes32`` (a warp a row in
  8-byte pieces), ``ahead0`` / ``ahead1`` (every launch without / with a
  row loaded ahead, whatever M), ``16B`` (16-byte pieces, a half-warp a
  row, the pitched layout only; ``16B_4`` the same with the registers of
  four blocks an SM, not five), and ``2B`` (the source as it is, made to
  take 2-byte pieces).

Every variant but the three ablations is first checked against the plain
version (``chip_smoke.py``'s limits: 1e-4 + 2^-7 relative). Two layouts:
``main``, the main path's (the concat buffer at its plain stride 308 and
``x1`` contiguous, both 8-byte rows; outputs in 16-byte rows), and
``pitched`` (the concat at stride 312 and ``x1`` in 16-byte rows, where
16-byte pieces fit); ``kernel`` also on the main layout into packed [m, c]
outputs (no row ends short of a 16-byte row). Beside them what the memory
gives as many bytes (one contiguous device-to-device copy, ``memcpy``) and
the launch floor: an empty kernel launched ten times in the same graph
harness, at the plan's grid at each M and at one block.

Prints ptxas's registers and spills of each variant's instances and one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

WIDTHS = (180, 212, 244, 276, 308)
CAT = 308
GEOMETRIES = (("4x4", 4096), ("8x8", 16384), ("16x16", 65536))
LN_ATOL, RTOL = 1e-4, 2.0 ** -7
# variants timed only (their outputs are wrong by design)
ABLATIONS = ("no_load", "no_store", "no_compute")

EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int adsr_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""

# the redesign's 16-byte pieces (bf16x8) for ``piece`` 8, a half-warp a
# row: 16-byte bases and row strides a multiple of 8; a row of C = 4 mod 8
# ends in a half piece, loaded and stored as 8 bytes, its 4 zeros past C
# taken out of the centred sum (each added mu^2)
WIDE16 = [
    ("constexpr int kLanes = kVec == 4 ? 16 : 32;",
     "constexpr int kLanes = kVec >= 4 ? 16 : 32;"),
    ("""  if constexpr (kVec == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);""",
     """  if constexpr (kVec == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    r.w[0] = t.x, r.w[1] = t.y, r.w[2] = t.z, r.w[3] = t.w;
  } else if constexpr (kVec == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);"""),
    ("""  if constexpr (kVec == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(""",
     """  if constexpr (kVec == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]),
        pack2(o[6], o[7]));
  else if constexpr (kVec == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2("""),
    ("""    dst[i] = row < M && c0 < C ? load_piece<kVec>(xr + c0)""",
     """    if constexpr (kVec == 8) {
      if (row < M && c0 < C && c0 + 8 > C) {
        const Piece<4> h = load_piece<4>(xr + c0);
        dst[i] = zero_piece<kVec>();
        dst[i].w[0] = h.w[0], dst[i].w[1] = h.w[1];
        continue;
      }
    }
    dst[i] = row < M && c0 < C ? load_piece<kVec>(xr + c0)"""),
    ("q += piece_sum<kVec, true>(cur[i], mu);",
     "q += piece_sum<kVec, true>(cur[i], mu) - (float)max(0, "
     "piece_col<kVec>(l, i) + kVec - C) * mu * mu;"),
    ("""      if (c0 < C) {
        g[i][j] = w[c0 + j];""", """      if (c0 + j < C) {
        g[i][j] = w[c0 + j];"""),
    ("store_piece<kVec>(yr + c0, o);",
     "if (kVec == 8 && c0 + 8 > C) store_piece<4>(yr + c0, o); "
     "else store_piece<kVec>(yr + c0, o);"),
    ("piece == 8 ? C % 4 == 0 && bases % 8 == 0 && (ldx | ldy) % 4 == 0",
     "piece == 8 ? C % 4 == 0 && bases % 16 == 0 && (ldx | ldy) % 8 == 0"),
    ("by_ahead<4>(ahead, a)", "by_ahead<8>(ahead, a)"),
    ("return blocks_per_sm<4>(n);", "return blocks_per_sm<8>(n);"),
]


def variants(src: str) -> dict:
    """The text edits of each variant. The redesign: the ablations, other
    plans (a warp a row in 8-byte pieces, ``lanes32``; every launch with or
    without a row ahead, ``ahead1`` / ``ahead0``) and 16-byte pieces
    (``16B``). The parent: its per-element loads and stores behind
    conditions the compiler cannot decide (the computation stays)."""
    if "adsr_rdg_layernorm_blocks_per_sm" in src:
        return {
            "kernel": [],
            # values made in registers, no reads
            "no_load": [("? load_piece<kVec>(xr + c0)",
                         "? Piece<kVec>{{0x3f803f80u + (uint32_t)(row & 7)}}")],
            # the outputs kept live by a test that never holds
            "no_store": [("store_piece<kVec>(yr + c0, o);",
                          "{ float t = 0.f; for (int j = 0; j < kVec; ++j) "
                          "t += o[j]; if (t == 1.25e-38f) "
                          "store_piece<kVec>(yr + c0, o); }")],
            # each row stored as it came (the statistics go dead)
            "no_compute": [("o[j] = (value<kVec>(cur[i], j) - mu) * inv * "
                            "g[i][j] + be[i][j];",
                            "o[j] = value<kVec>(cur[i], j);")],
            "lanes32": [("constexpr int kLanes = kVec == 4 ? 16 : 32;",
                         "constexpr int kLanes = 32;")],
            "ahead0": [("return ahead ? launch<kVec, 1>(a) : "
                        "launch<kVec, 0>(a);", "return launch<kVec, 0>(a);")],
            "ahead1": [("return ahead ? launch<kVec, 1>(a) : "
                        "launch<kVec, 0>(a);", "return launch<kVec, 1>(a);")],
            "16B": WIDE16,
            # the same with registers for four blocks an SM (no spills)
            "16B_4": WIDE16 + [("constexpr int kMinBlocks = 5;",
                                "constexpr int kMinBlocks = 4;")]}
    return {
        "kernel": [],
        "no_load": [("v[i] = c < C ? __bfloat162float(xr[c]) : 0.f;",
                     "v[i] = c < C ? 0.25f * (float)((row + c) & 7) : 0.f;")],
        "no_store": [("if (c < C) yr[c] = __float2bfloat16((v[i] - mu) * inv "
                      "* w[c] + b[c]);",
                      "if (c < C) { const float o = (v[i] - mu) * inv * w[c] "
                      "+ b[c]; if (o == 1.25e-38f) yr[c] = "
                      "__float2bfloat16(o); }")]}


def build(out: Path, csrc: Path, nvcc: list, edits_of: dict) -> dict:
    """{variant: (nvcc process, library)}, every compile started at once
    (the empty kernel's too)."""
    out.mkdir(parents=True, exist_ok=True)
    text = (csrc / "rdg_layernorm.cu").read_text()
    sources = {"empty": EMPTY}
    for name, edits in edits_of.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: rdg_layernorm.cu has no {old!r}")
            src = src.replace(old, new)
        sources[name] = src
    procs = {}
    for name, src in sources.items():
        cu, so = out / f"rdg_layernorm_{name}.cu", out / f"rdg_layernorm_{name}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [*nvcc, "-shared", "-I", str(csrc), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    return procs


def ptxas_lines(log: str) -> list:
    """``<template args>: registers, spills`` for each kernel in the log."""
    lines, name, spill = [], None, ""
    for raw in log.splitlines():
        if "Compiling entry function" in raw:
            mangled = raw.split("'")[1]
            args = re.findall(r"Li(\d+)E", mangled)
            name = "<" + ",".join(args) + ">" if args else mangled
        elif "spill stores" in raw:
            spill = raw.split(":", 1)[-1].strip()
        elif "Used" in raw and "registers" in raw and name:
            regs = re.search(r"Used (\d+) registers", raw).group(1)
            lines.append(f"{name} {regs} regs, {spill}")
            name, spill = None, ""
    return lines


def load(procs: dict, signatures: dict) -> dict:
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        if name == "empty":
            lib.adsr_empty.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
            lib.adsr_empty.restype = ctypes.c_int
        else:
            print(f"[ptxas] {name}: " + "; ".join(ptxas_lines(log)),
                  flush=True)
            for entry in ("adsr_rdg_layernorm",
                          "adsr_rdg_layernorm_blocks_per_sm"):
                if entry in signatures:
                    fn = getattr(lib, entry)
                    fn.argtypes = signatures[entry]
                    fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn``'s launches replayed as one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
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
    global _build
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the tree whose package and sources to time")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from adsr_tpu_torch.kernels import _build
    from adsr_tpu_torch.kernels import rdg_layernorm as ln
    from adsr_tpu_torch.kernels.rdg_gemm import pitched, row_pitch
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    print(f"[sweep] tree {root}", flush=True)
    dev = torch.device("cuda")
    out = Path(__file__).resolve().parents[1] / "build" / "layernorm_sweep" \
        / root.name
    edits = variants((_build.CSRC / "rdg_layernorm.cu").read_text())
    libs = load(build(out, _build.CSRC, [_build._nvcc(), *_build.NVCC_FLAGS],
                      edits), _build.SIGNATURES)
    planning = hasattr(ln, "rdg_layernorm_plan")
    real_check = getattr(ln, "check_ln_layout", None)
    real_lanes = getattr(ln, "LANES", None)

    def use(lib, lanes=None, piece=None):
        """The wrapper on ``lib``, with the plan's lanes a row and the
        layout's piece as given (None: the tree's own)."""
        _build.library = lambda: lib
        if planning:
            ln.LANES = lanes or real_lanes
            ln.check_ln_layout = real_check if piece is None else (
                lambda *a: min(real_check(*a), piece))
            ln.blocks_per_sm.cache_clear()
            ln.rdg_layernorm_plan.cache_clear()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    gen = torch.Generator(device=dev).manual_seed(0)
    result = {}
    for geo, m in GEOMETRIES:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(
                torch.bfloat16)
        cat = randn(m, CAT)
        cat_p = pitched(m, CAT, device=dev)
        cat_p.copy_(cat)
        # every output into one scratch in 16-byte rows, as chip_smoke.py's
        # timing phase writes them
        scratch = torch.empty(m * row_pitch(CAT), dtype=torch.bfloat16,
                              device=dev)
        blocks = []
        for c in WIDTHS:
            x1 = randn(m, c)
            x1_p = pitched(m, c, device=dev)
            x1_p.copy_(x1)
            blocks.append({
                "c": c, "w": 1.0 + 0.1 * torch.randn(c, generator=gen,
                                                     device=dev),
                "b": 0.1 * torch.randn(c, generator=gen, device=dev),
                "main": (cat[:, :c], x1), "pitched": (cat_p[:, :c], x1_p),
                "out": scratch.as_strided((m, c), (row_pitch(c), 1)),
                "out_packed": scratch.as_strided((m, c), (c, 1))})

        def run_packed():
            for blk in blocks:
                for src in blk["main"]:
                    ln.rdg_layernorm(src, blk["w"], blk["b"],
                                     blk["out_packed"])

        def run(layout):
            for blk in blocks:
                for src in blk[layout]:
                    ln.rdg_layernorm(src, blk["w"], blk["b"], blk["out"])

        def check(layout, what):
            for blk in blocks:
                for src in blk[layout]:
                    ln.rdg_layernorm(src, blk["w"], blk["b"], blk["out"])
                    torch.cuda.synchronize()
                    want = ln.rdg_layernorm_plain(src, blk["w"], blk["b"])
                    err = (blk["out"].float() - want).abs()
                    if bool((err > LN_ATOL + RTOL * want.abs()).any()):
                        raise AssertionError(
                            f"{what} {geo} {layout} c={blk['c']}: max abs "
                            f"error {err.max().item():.3e}")

        res = result.setdefault(geo, {"m": m})
        # (name, library, lanes a row, piece): every variant as built, and
        # the 2-byte pieces of the kernel as it is
        runs = [(name, lib, {8: 32, 2: 32} if name == "lanes32" else None,
                 None) for name, lib in libs.items() if name != "empty"]
        if planning:
            runs.append(("2B", libs["kernel"], None, 2))
        for name, lib, lanes, piece in runs:
            use(lib, lanes, piece)
            # 16-byte pieces need 16-byte rows
            for layout in ("pitched",) if name.startswith("16B") else (
                    "main", "pitched"):
                if name not in ABLATIONS:
                    check(layout, name)
                ms = graph_ms(lambda: run(layout))
                res.setdefault(name, {})[layout] = ms
                print(f"[sweep] {geo} m={m} {name:14s} {layout:8s} one RDG "
                      f"{ms:.4f} ms", flush=True)
            if name == "kernel":    # the main layout into [m, c] rows
                ms = graph_ms(run_packed)
                res[name]["packed_out"] = ms
                print(f"[sweep] {geo} m={m} {name:14s} {'[m, c] out':8s} "
                      f"one RDG {ms:.4f} ms", flush=True)
        use(libs["kernel"])
        # what the memory gives as many bytes: one contiguous
        # device-to-device copy
        total = m * 2 * sum(WIDTHS)
        src_flat = torch.empty(total, dtype=torch.bfloat16, device=dev)
        dst_flat = torch.empty_like(src_flat)
        res["memcpy"] = graph_ms(lambda: dst_flat.copy_(src_flat))
        print(f"[sweep] {geo} m={m} {'memcpy':14s} one RDG's bytes "
              f"contiguous {res['memcpy']:.4f} ms", flush=True)
        del src_flat, dst_flat
        # the launch floor: ten empty launches at the plan's grid (the
        # parent: its own 8 rows a block of 256 threads) and at one block
        if planning:
            p = ln.rdg_layernorm_plan(m, CAT, _build.sm_count(dev), 8,
                                      ln.blocks_per_sm(8))
            grid, threads = p["blocks"], p["threads"]
        else:
            grid, threads = -(-m // 8), 256
        for label, g_, t_ in (("empty_grid", grid, threads),
                              ("empty_1block", 1, threads)):
            ms = graph_ms(lambda: [libs["empty"].adsr_empty(g_, t_, stream())
                                   for _ in range(10)])
            res[label] = {"ms": ms, "grid": g_, "threads": t_}
            print(f"[sweep] {geo} m={m} {label:14s} ten launches of "
                  f"{g_} x {t_} threads {ms:.4f} ms", flush=True)
        del cat, cat_p, scratch, blocks
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "tree": str(root), "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
