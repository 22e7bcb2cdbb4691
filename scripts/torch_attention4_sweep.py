#!/usr/bin/env python3
"""Where kernels (c) ``window_attention`` and (f) ``window_attention_bwd``
spend their time at 4x4 windows (N = 16), on one CUDA card at the 64/x4
shapes (batch 16, 16 x 16 tokens, the five Swin blocks of one RDG, qkv /
ctx / dO / dqkv in 16-byte rows).

    python3 scripts/torch_attention4_sweep.py [--root DIR]

``--root`` takes the package and the sources of another tree (a ``git
archive`` of the parent unpacked under ``workspace/``), so one script
times both sides of a change. Builds variants of the tree's
``csrc/window_attention4.cu`` and ``csrc/window_attention_bwd4.cu`` by
text edits into ``build/attention4_sweep/<tree>/`` (one shared library
each, nvcc in parallel) and calls each through the tree's own wrapper with
the wrapper's library swapped for the variant's (so each tree's launch
plan and arguments hold). Each variant's time is one RDG's five calls
replayed as a CUDA graph (CUDA events over 20 replays), and each block's
call alone:

- ``kernel``: the source as it is, checked against the plain version
  (``chip_smoke.py``'s limits);
- ``no_load``: without the global loads of qkv (and dO); ``no_compute``:
  without the attention (products, softmax, the results' writes into
  shared memory); ``no_core`` (the redesign) without the products and
  softmax alone; ``no_store``: without the global stores of the context
  (dqkv); ``no_piece_store`` (the parent's sources): without the element
  stores of the 16-byte pieces a head shares with its neighbour. Wrong
  outputs, timing only;
- ``profile`` (the redesign): the timeline build (``csrc/attn4.cuh``
  ATTN4_PROFILE), one launch a block: each block's wait for its rows,
  compute and store of its first window in SM cycles (median and largest
  over the blocks), warp 0's steps on its first head (``head_step1-4``:
  (c) S, the softmax, P V, the context written; (f) S and dP, the
  softmax, dS and dQ, dq written and the wait for the head's other warp,
  dK and dV written), the spread of the blocks' starts and the launch's
  span in ns (``[timeline]`` lines).

On a tree whose plans stage windows (``stages`` in the plan: the redesign)
it also times the kernel at other plans, each checked against the plain
version too: ``two_a_block`` (half the blocks, two windows each, double-
buffered) and ``stages3`` (the same grid, three stages).

Prints ptxas's registers and spills of each variant, one line per variant,
and one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

BATCH, SIDE, WIN = 16, 16, 4
N = WIN * WIN
BLOCKS_64 = [(180, 6, 0), (212, 4, 2), (244, 2, 0), (276, 6, 2), (308, 4, 0)]


# the timeline build (csrc/attn4.cuh ATTN4_PROFILE) and its read-back
PROFILE = ('#include "attn4.cuh"', '#define ATTN4_PROFILE\n#include "attn4.cuh"')
PROFILE_TAKE = ("\n// ``stages``, ``grid`` and ``smem`` are", """
extern "C" int adsr_attn4_profile_take(void* out) {
  return (int)cudaMemcpyFromSymbol(out, attn4_profile, sizeof(attn4_profile));
}

// ``stages``, ``grid`` and ``smem`` are""")


def variants(fwd_src: str, bwd_src: str) -> tuple:
    """The text edits of each variant of (c) and (f), for the tree's
    sources: the redesign's switches (``kLoad``, ``kCompute``, ``kCore``,
    ``kStore``, the timeline build) or the parent's loops."""
    if "constexpr bool kLoad = true;" in fwd_src:
        switches = {"kernel": [],
                    "no_load": [("kLoad = true;", "kLoad = false;")],
                    "no_compute": [("kCompute = true;", "kCompute = false;")],
                    "no_core": [("kCore = true;", "kCore = false;")],
                    "no_store": [("kStore = true;", "kStore = false;")],
                    "profile": [PROFILE, PROFILE_TAKE]}
        return switches, switches
    fwd = {
        "kernel": [],
        "no_load": [("        src_row[j] = token_row(grp, t, windows, nw, "
                     "nww, H, W, shift);",
                     "        src_row[j] = W > 0 ? -1 : token_row(grp, t, "
                     "windows, nw, nww, H, W, shift);")],
        "no_compute": [("  if (fw < windows) {",
                        "  if (fw < windows && W < 0) {")],
        "no_store": [("    if (row < 0) continue;",
                      "    if (row < 0 || W > 0) continue;")],
        "no_piece_store": [("        if (x < n && c0 + x >= s0 && c0 + x < "
                            "s0 + hd) dst[x] = src[x];",
                            "        if (W < 0) dst[x] = src[x];")]}
    bwd = {
        "kernel": [],
        "no_load": [("          if (row >= 0) {",
                     "          if (row >= 0 && W < 0) {")],
        "no_compute": [("    if (fw < w_end) {",
                        "    if (fw < w_end && W < 0) {")],
        "no_store": [("      if (row < 0) continue;",
                      "      if (row < 0 || W > 0) continue;")],
        "no_piece_store": [("            dst[x] = src[c0 - s0 + x];",
                            "            if (W < 0) dst[x] = "
                            "src[c0 - s0 + x];")]}
    return fwd, bwd


def build(out: Path, csrc: Path, src_name: str, edits_of: dict) -> dict:
    """{variant: (nvcc process, library)}, every compile started at once."""
    out.mkdir(parents=True, exist_ok=True)
    text = (csrc / src_name).read_text()
    procs = {}
    for name, edits in edits_of.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {src_name} has no {old!r}")
            src = src.replace(old, new)
        stem = f"{Path(src_name).stem}_{name}"
        cu, so = out / f"{stem}.cu", out / f"{stem}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(csrc),
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    return procs


class Library:
    """One entry point of a variant's shared library, as the wrappers
    reach it (``_build.library().<entry>``)."""

    def __init__(self, so: Path, entry: str):
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        setattr(self, entry, fn)
        self.take = getattr(lib, "adsr_attn4_profile_take", None)
        if self.take is not None:
            self.take.argtypes = [ctypes.c_void_p]
            self.take.restype = ctypes.c_int


def load(procs: dict, tag: str, entry: str) -> dict:
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line and "Used" in line]
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line]
        print(f"[ptxas] {tag} {name}: " + " | ".join(
            f"{r}; {s}" for r, s in zip(regs, spills)), flush=True)
        libs[name] = Library(so, entry)
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


def timeline(lib, fn, tag: str, k: int) -> dict:
    """One launch of the profile build (``fn``, after a warm-up): each
    block's phases of its first window from its marks (csrc/attn4.cuh
    ATTN4_PROFILE), median and largest over the blocks, in SM cycles; the
    spread of the blocks' starts and the launch's span, in ns."""
    import numpy as np
    fn()
    fn()
    torch.cuda.synchronize()
    buf = np.zeros(2048 * 16, dtype=np.uint64)
    if lib.take(buf.ctypes.data):
        raise RuntimeError("adsr_attn4_profile_take failed")
    torch.cuda.synchronize()
    m = buf.reshape(2048, 16).astype(np.int64)
    m = m[m[:, 6] > 0]                       # the blocks of this launch
    phases = {"wait_rows": m[:, 2] - m[:, 1], "compute": m[:, 3] - m[:, 2],
              "store": m[:, 4] - m[:, 3], "block": m[:, 5] - m[:, 1]}
    # warp 0's first head: its steps from the rows' arrival (the kernel's
    # own marks 8-11)
    steps = [m[:, 2]] + [m[:, i] for i in range(8, 12)]
    for i in range(1, 5):
        phases[f"head_step{i}"] = steps[i] - steps[i - 1]
    out = {name: {"median": float(np.median(v)), "max": float(v.max())}
           for name, v in phases.items()}
    out["start_spread_ns"] = float(m[:, 0].max() - m[:, 0].min())
    out["span_ns"] = float(m[:, 6].max() - m[:, 0].min())
    out["blocks"] = int(len(m))
    print(f"[timeline] {tag} b{k + 1}: {len(m)} blocks; cycles median/max "
          + ", ".join(f"{n} {v['median']:.0f}/{v['max']:.0f}"
                      for n, v in out.items() if isinstance(v, dict))
          + f"; starts spread {out['start_spread_ns']:.0f} ns, span "
          f"{out['span_ns']:.0f} ns", flush=True)
    return out


def within(got, want, atol, rtol, what):
    err = (got.float() - want).abs()
    if bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{what}: beyond the tolerance of chip_smoke.py "
                             f"(max abs error {err.max().item():.3e})")


def main() -> int:
    global _build
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the tree whose package and sources to time")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from adsr_tpu_torch.kernels import _build
    from adsr_tpu_torch.kernels import window_attention as wa
    from adsr_tpu_torch.kernels import window_attention_bwd as wab
    from adsr_tpu_torch.kernels.rdg_gemm import pitched
    from adsr_tpu_torch.models.drct import shift_attn_mask
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    print(f"[sweep] tree {root}", flush=True)
    dev = torch.device("cuda")
    out = Path(__file__).resolve().parents[1] / "build" / "attention4_sweep" \
        / root.name
    fwd_src = (_build.CSRC / "window_attention4.cu").read_text()
    bwd_src = (_build.CSRC / "window_attention_bwd4.cu").read_text()
    fwd_edits, bwd_edits = variants(fwd_src, bwd_src)
    fp = build(out, _build.CSRC, "window_attention4.cu", fwd_edits)
    bp = build(out, _build.CSRC, "window_attention_bwd4.cu", bwd_edits)
    fwd = load(fp, "(c)", "adsr_window_attention4")
    bwd = load(bp, "(f)", "adsr_window_attention_bwd4")

    gen = torch.Generator(device=dev).manual_seed(0)
    m = BATCH * SIDE * SIDE
    mask = torch.as_tensor(shift_attn_mask(SIDE, SIDE, WIN, WIN // 2),
                           device=dev)
    cases = []
    for c, nh, shift in BLOCKS_64:
        qkv, dout = pitched(m, 3 * c, device=dev), pitched(m, c, device=dev)
        qkv.copy_(torch.randn(m, 3 * c, generator=gen, device=dev))
        dout.copy_(torch.randn(m, c, generator=gen, device=dev))
        cases.append({
            "c": c, "nh": nh, "shift": shift, "qkv": qkv, "dout": dout,
            "bias": 0.5 * torch.randn(nh, N, N, generator=gen, device=dev),
            "mask": mask if shift else None,
            "ctx": pitched(m, c, device=dev),
            "dqkv": pitched(m, 3 * c, device=dev),
            "dbias": torch.empty(nh, N, N, device=dev)})

    def run_fwd(case):
        wa.window_attention(case["qkv"], case["ctx"], case["bias"],
                            case["mask"], SIDE, SIDE, case["nh"], WIN,
                            case["shift"])

    def run_bwd(case):
        wab.window_attention_bwd(case["qkv"], case["dout"], case["bias"],
                                 case["mask"], SIDE, SIDE, case["nh"], WIN,
                                 case["shift"], case["dqkv"], case["dbias"])

    def check(case, which):
        torch.cuda.synchronize()
        c, nh, shift = case["c"], case["nh"], case["shift"]
        if which == "(c)":
            want = wa.window_attention_plain(case["qkv"], case["bias"],
                                             case["mask"], SIDE, SIDE, nh,
                                             WIN, shift)
            v = case["qkv"][:, 2 * c:].float().abs().max().item()
            within(case["ctx"], want, 2.0 ** -8 * v, 2.0 ** -7,
                   f"(c) c={c}")
            return
        want_q, want_b = wab.window_attention_bwd_plain(
            case["qkv"], case["dout"], case["bias"], case["mask"], SIDE,
            SIDE, nh, WIN, shift)
        for i in range(3):
            ref = want_q[:, i * c:(i + 1) * c]
            within(case["dqkv"][:, i * c:(i + 1) * c], ref,
                   2.0 ** -7 * ref.abs().max().item(), 2.0 ** -7,
                   f"(f) c={c} d{'qkv'[i]}")
        within(case["dbias"], want_b, 2.0 ** -8 * want_b.abs().max().item(),
               0.0, f"(f) c={c} dbias")

    # other plans of a staging tree: (name, {plan key: value} by windows)
    plans = {}
    staged = "stages" in wa.window_attention_plan(180, 6, BATCH, SIDE, SIDE,
                                                  window=WIN)
    if staged:
        windows = BATCH * (SIDE // WIN) ** 2
        plans = {"two_a_block": (2, -(-windows // 2)),
                 "stages3": (3, -(-windows // 2))}

    result = {}
    for tag, libs, run, mod, plan_name in (
            ("(c)", fwd, run_fwd, wa, "window_attention_plan"),
            ("(f)", bwd, run_bwd, wab, "window_attention_bwd_plan")):
        real_plan = getattr(mod, plan_name)
        for name, lib in list(libs.items()) + [(p, libs["kernel"])
                                                for p in plans]:
            _build.library = lambda lib=lib: lib
            if name in plans:
                stages, grid = plans[name]

                def plan(*a, stages=stages, grid=grid, **kw):
                    p = real_plan(*a, **kw)
                    return {**p, **wa.plan4_at(p, stages, grid)}
                setattr(mod, plan_name, plan)
            if name == "kernel" or name in plans:
                for case in cases:
                    run(case)
                    check(case, tag)
            if name == "profile":
                result.setdefault(tag + " timeline", {})
                for k, case in enumerate(cases):
                    result[tag + " timeline"][f"b{k + 1}"] = timeline(
                        lib, lambda case=case: run(case), tag, k)
                continue
            ms = [graph_ms(lambda case=case: run(case)) for case in cases]
            rdg = graph_ms(lambda: [run(case) for case in cases])
            setattr(mod, plan_name, real_plan)
            result.setdefault(tag, {})[name] = {"rdg_ms": rdg, "blocks": ms}
            print(f"[sweep] {tag} {name:16s} one RDG {rdg:.4f} ms; each "
                  "block alone " + " ".join(f"{x:.4f}" for x in ms),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "tree": str(root), "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
