#!/usr/bin/env python3
"""Where the f32 instance of kernel (g) spends its time: one RDG's five
launches at batch 16 at the flagship (8x8 windows, 32 x 32 tokens), 64/x4
(4x4 windows, 16 x 16) and 256px/x4 (16x16 windows, 64 x 64) shapes, on
one CUDA card.

    python3 scripts/torch_swin_block_f32_sweep.py

Builds variants of ``adsr_tpu_torch/csrc/swin_block{4,,16}_f32.cu`` with
the ablation switches of ``swin_block_f32.cuh`` set on nvcc's command line,
one shared library a variant (nvcc in parallel) under
``build/swin_block_f32_sweep/``, and times each through the port's wrapper
(``fused_swin_block`` on f32 tensors, the variant's library in place of the
package's), the five launches captured as a CUDA graph and replayed 20
times between CUDA events:

- ``kernel``: the sources as they are, checked against the plain version;
- ``no_attention``: ``SWIN_F32_ATTEND=0``, the attention left out;
- ``no_ln_load``: ``SWIN_F32_LN_LOAD=0``, qkv's A fragments not
  normalised;
- ``no_stage``: ``SWIN_F32_STAGE=0``, the products' tiles not staged (the
  ring holds whatever it holds);
- ``one_tf32``: ``ATTN16_F32_X3=0``, one TF32 product of three (products
  and attention);
- ``no_mma``: ``SWIN_F32_MMA=0``, the products' mma left out (the
  fragment loads, splits, barriers and epilogues stay);
- ``no_mma_no_attention``: both, what is left is the data movement, the
  LayerNorms and the barriers.

Prints ptxas's registers and spills of each variant, one line per window
and variant, and one JSON line with the card's name and power limit.
Timing only: the ablated variants' outputs are not the block's.
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
from adsr_tpu_torch.kernels import fused_swin_block as fsb  # noqa: E402
from adsr_tpu_torch.kernels.fused_rdg import prepack_rdg_stack  # noqa: E402
from adsr_tpu_torch.kernels.rdg_gemm import pitched  # noqa: E402
from adsr_tpu_torch.models.factory import init_sr_params  # noqa: E402

OUT = ROOT / "build" / "swin_block_f32_sweep"
BATCH = 16
SOURCES = ("swin_block4_f32.cu", "swin_block_f32.cu", "swin_block16_f32.cu")
VARIANTS = {"kernel": [], "no_attention": ["SWIN_F32_ATTEND=0"],
            "no_ln_load": ["SWIN_F32_LN_LOAD=0"],
            "no_stage": ["SWIN_F32_STAGE=0"],
            "one_tf32": ["ATTN16_F32_X3=0"],
            "no_mma": ["SWIN_F32_MMA=0"],
            "no_mma_no_attention": ["SWIN_F32_MMA=0", "SWIN_F32_ATTEND=0"]}
# window: (model resolution, scale); the windows of 128, 64 and 256 px x4
GEOMETRIES = {8: (128, 4), 4: (64, 4), 16: (256, 4)}
F32_LIMIT = 1e-5         # relative L2 against the plain version


def build() -> dict:
    """{variant: ctypes library}, each the three sources compiled with the
    variant's defines and linked into one shared library."""
    nvcc = _build._nvcc()
    jobs = []
    for name, defines in VARIANTS.items():
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        flags = [f"-D{d}" for d in defines]
        for src in SOURCES:
            obj = out / (Path(src).stem + ".o")
            jobs.append((name, src, obj, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC),
                 "-c", str(_build.CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs = {}
    for name, src, obj, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {src}:\n{log}")
        regs = sorted({line.split("Used", 1)[1].strip() for line in
                       log.splitlines() if "Used" in line})
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill stores" in line})
        print(f"[ptxas] {name} {src}: {'; '.join(regs)} | "
              f"{'; '.join(spills)}", flush=True)
        objs.setdefault(name, []).append(str(obj))
    libs = {}
    for name, files in objs.items():
        so = OUT / name / "libswin_f32.so"
        link = subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o",
                               str(so), *files], capture_output=True,
                              text=True)
        if link.returncode:
            raise RuntimeError(f"link failed for {name}:\n{link.stderr}")
        lib = ctypes.CDLL(str(so))
        for entry in fsb.F32_ENTRIES.values():
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms of ``fn``'s launches, captured once as a CUDA graph and
    replayed ``iters`` times between CUDA events."""
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
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs = build()
    package_library = _build.library
    results = {}
    for win, geo in GEOMETRIES.items():
        cfg = drct_experiment("grid", *geo, precision="fp32").model
        side = cfg.img_size
        gen = torch.Generator().manual_seed(win)
        sd, _ = init_sr_params(cfg, gen, device=dev)
        sd = {k: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
              for k, v in sd.items()}
        packed = prepack_rdg_stack(sd, cfg, side, side, torch.float32, dev)
        blocks, masks = packed["rdgs"][0], packed["masks"]
        m = BATCH * side * side
        cat = torch.randn(m, 308, generator=gen).to(dev)
        outs = [pitched(m, cat.shape[1], dtype=torch.float32, device=dev)
                for _ in range(5)]

        def rdg(k_range=range(5)):
            for k in k_range:
                c = fsb.block_geometry(cfg, k)["c"]
                fsb.fused_swin_block(cat[:, :c], blocks[k], masks, cfg, side,
                                     side, k, outs[k][:, :c])

        for name, lib in libs.items():
            _build.library = lambda lib=lib: lib
            try:
                if name == "kernel":
                    rdg()
                    worst = 0.0
                    for k in range(5):
                        c = fsb.block_geometry(cfg, k)["c"]
                        want = fsb.fused_swin_block_plain(
                            cat[:, :c], blocks[k], masks, cfg, side, side, k)
                        err = ((outs[k][:, :c] - want).norm()
                               / want.norm()).item()
                        worst = max(worst, err)
                    if worst > F32_LIMIT:
                        raise AssertionError(f"window {win}: relative L2 "
                                             f"{worst:.3e} from the plain "
                                             "version")
                ms = graph_ms(rdg)
            finally:
                _build.library = package_library
            results.setdefault(f"w{win}", {})[name] = ms
            print(f"[sweep] window {win:2d} (M = {m}) {name:20s} one RDG's "
                  f"five launches {ms:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
