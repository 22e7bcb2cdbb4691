#!/usr/bin/env python3
"""Where kernel (g) ``swin_block`` spends its time at 16x16 windows
(N = 256: the 256px/x4 shapes, batch 16 on 64 x 64 tokens, a cluster of
four blocks a window) and at 4x4 windows (N = 16: the 64/x4 shapes, batch
16 on 16 x 16 tokens, four windows a group), on one CUDA card, the five
Swin blocks of one RDG.

    python3 scripts/torch_swin_block16_sweep.py

Builds variants of ``adsr_tpu_torch/csrc/swin_block16.cu`` and
``csrc/swin_block4.cu`` by text edits of their ablation constants into
``build/swin_block_sweep/`` (one shared library each, nvcc in parallel) and
times one RDG's five launches of each through its C entry point, captured
as a CUDA graph and replayed 20 times between CUDA events:

- ``kernel``: the source as it is, checked against the plain version; at
  N = 256 also at 4 ring stages (the fewest: two a warpgroup), at N = 16
  also with one block a group (``cluster`` 1) beside the plan's two, and
  both at batch 256 (1,024 groups, where the plan takes one block a
  group);
- ``no_attention``: the attention's products, scores and softmax left out
  (``kAttend``; the context is not a number: timing only);
- ``no_exchange``: the cluster traffic left out (``kExchange``; at N = 256
  the pulls of the peers' K and V tiles, at N = 16 the exchanges of the
  partial streams; the barriers stay: timing only);
- ``products``: both left out, the products with the LayerNorms, the
  gather and scatter and the barriers;
- ``stream``: the products' wgmma left out too (``SWIN_PRODUCTS`` 0): the
  weight tiles streamed, awaited and released, the epilogues on zeros;
- ``profile``: the kernel built with ``SWIN_PROFILE`` (swin_block_core.cuh):
  one launch a block, then the share of each consumer warpgroup's clocks
  spent waiting for weight stages, at its barriers, at cluster barriers,
  in the cluster exchange and in the attention (and of the producer's in
  waits for empty stages); timed too, with its atomics.

Prints ptxas's registers and spills of each variant, one line per variant
and block, and one JSON line with the card's name and power limit.
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
from adsr_tpu_torch.kernels.fused_rdg import (  # noqa: E402
    rdg_geometry, shift_masks)
from adsr_tpu_torch.kernels.fused_swin_block import (  # noqa: E402
    STAGE_BYTES, fused_swin_block_plain, swin_block_plan)
from adsr_tpu_torch.kernels.rdg_gemm import pitched  # noqa: E402
from adsr_tpu_torch.kernels.rdg_layernorm import EPS  # noqa: E402
from adsr_tpu_torch.kernels.window_attention import (  # noqa: E402
    attn_operands, full_bias)

OUT = ROOT / "build" / "swin_block_sweep"
BATCH = 16
# window: (source, entry point, model resolution, scale)
GEOMETRIES = {16: ("swin_block16.cu", "adsr_swin_block16", 256, 4),
              4: ("swin_block4.cu", "adsr_swin_block4", 64, 4)}
ATTEND = ("kAttend = true", "kAttend = false")
# appended to the profile build: its clocks to the host, then zeroed
PROFILE_READER = """
extern "C" int adsr_swin_profile_take(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, adsr_swin_profile,
                                       sizeof(adsr_swin_profile));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[kProfSlots] = {};
  return (int)cudaMemcpyToSymbol(adsr_swin_profile, zero, sizeof(zero));
}
"""
EXCHANGE = ("kExchange = true", "kExchange = false")
VARIANTS = {"kernel": [], "no_attention": [ATTEND],
            "no_exchange": [EXCHANGE], "products": [ATTEND, EXCHANGE],
            "stream": [ATTEND, EXCHANGE, ("#include <cuda_bf16.h>",
                                          "#define SWIN_PRODUCTS 0\n"
                                          "#include <cuda_bf16.h>")],
            "profile": [("#include <cuda_bf16.h>",
                         "#define SWIN_PROFILE 1\n#include <cuda_bf16.h>"),
                        (None, PROFILE_READER)]}
# the profile build's clocks (swin_block_core.cuh ``ProfileSlot``)
PROFILE_SLOTS = ("full", "barrier", "cluster", "exchange", "attention",
                 "mainloop", "epilogue", "norm", "merge", "span", "empty",
                 "records")
STAGES16 = (4,)          # besides the plan's, for the kernel at N = 256
WIDE4 = 256              # a batch at N = 16 whose 1,024 groups fill the
                         # card (the plan's cluster 1, as the tiled CLI's)
SWIN_ATOL = 4e-2         # chip_smoke.py's limit against the plain version


def build() -> dict:
    """{(window, variant): ctypes entry point}, each built from the edited
    source, nvcc in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for win, (src, entry, _, _) in GEOMETRIES.items():
        text = (_build.CSRC / src).read_text()
        for name, edits in VARIANTS.items():
            body = text
            for old, new in edits:
                if old is None:               # appended
                    body += new
                    continue
                if old not in body:
                    raise RuntimeError(f"{src}: no {old!r}")
                body = body.replace(old, new, 1)
            cu, so = OUT / f"w{win}_{name}.cu", OUT / f"w{win}_{name}.so"
            cu.write_text(body)
            procs[win, name] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                 str(_build.CSRC), "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                so, entry)
    fns = {}
    for (win, name), (proc, so, entry) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for w{win} {name}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line and "Used" in line]
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line]
        print(f"[ptxas] w{win} {name}: " + " | ".join(
            f"{r}; {s}" for r, s in zip(regs, spills)), flush=True)
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fn.lib = lib
        fns[win, name] = fn
    return fns


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms of ``fn``'s launches, captured once as a CUDA graph and
    replayed ``iters`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up, launched
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


def cases(win: int, dev, gen, batch: int = BATCH) -> tuple:
    """The five blocks' seeded weights and outputs, the RDG's input and the
    model config at window ``win``'s geometry and ``batch``."""
    _, _, res, scale = GEOMETRIES[win]
    cfg = drct_experiment("grid", res, scale).model
    side = cfg.img_size
    g = rdg_geometry(cfg)
    m = batch * side * side
    masks = shift_masks(side, side, win, tuple(g["shifts"]), dev)
    cat = torch.randn(m, g["cat_width"], generator=gen,
                      device=dev).to(torch.bfloat16)

    def randn(*shape, std, bf16=False):
        t = torch.randn(*shape, generator=gen, device=dev) * std
        if not bf16:
            return t
        out = pitched(*shape, device=dev)
        out.copy_(t)
        return out

    out = []
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
             "attn_table": randn(nh, (2 * win - 1) ** 2, std=0.5)}
        p["attn_bias"] = full_bias(p["attn_table"], win) if win == 16 \
            else randn(nh, win * win, win * win, std=0.5)
        out.append({"k": k, "c": c, "f": f, "nh": nh, "shift": g["shifts"][k],
                    "p": p, "plan": swin_block_plan(
                        c, f, nh, batch, side, side, window=win,
                        sms=_build.sm_count(dev)),
                    "out": torch.empty(m, c, dtype=torch.bfloat16,
                                       device=dev)})
    return cfg, cat, masks, out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    geos = {(win, BATCH): cases(win, dev, gen) for win in GEOMETRIES}
    geos[4, WIDE4] = cases(4, dev, gen, WIDE4)
    fns = build()

    def time_rdg(fn, gk, name, label, kw):
        """Each block's launch and the RDG's five, as CUDA graphs, at
        geometry ``gk`` (window, batch)."""
        blocks = geos[gk][3]
        per = [graph_ms(lambda: launch(fn, gk, case, **kw))
               for case in blocks]
        rdg = graph_ms(lambda: [launch(fn, gk, case, **kw)
                                for case in blocks])
        print(f"[sweep] w{gk[0]} B={gk[1]} {name:12s} {label:10s}: one RDG "
              f"{rdg:.4f} "
              "ms; blocks " + " ".join(f"{v:.4f}" for v in per), flush=True)
        return {"blocks_ms": per, "rdg_ms": rdg}

    def launch(fn, gk, case, stages=None, cluster=None):
        win, batch = gk
        cfg, cat, masks, _ = geos[gk]
        side = cfg.img_size
        p, c, plan = case["p"], case["c"], case["plan"]
        stages = plan["stages"] if stages is None else stages
        bias, mask = attn_operands(p, masks, side, side, case["shift"], win)
        smem = plan["smem_bytes"] + (stages - plan["stages"]) \
            * (STAGE_BYTES + 16)
        rc = fn(cat.data_ptr(), cat.stride(0), case["out"].data_ptr(),
                case["out"].stride(0), p["ln1_w"].data_ptr(),
                p["ln1_b"].data_ptr(), p["wqkv"].data_ptr(),
                p["wqkv"].stride(0), p["bqkv"].data_ptr(), bias.data_ptr(),
                None if mask is None else mask.data_ptr(),
                p["wproj"].data_ptr(), p["wproj"].stride(0),
                p["bproj"].data_ptr(), p["ln2_w"].data_ptr(),
                p["ln2_b"].data_ptr(), p["w1"].data_ptr(), p["w1"].stride(0),
                p["b1"].data_ptr(), p["w2"].data_ptr(), p["w2"].stride(0),
                p["b2"].data_ptr(), batch, side, side, c, case["f"],
                case["nh"], win, case["shift"], stages,
                plan["cluster"] if cluster is None else cluster, EPS, smem,
                _build.stream_ptr(cat))
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    result = {}
    for (win, name), fn in fns.items():
        gk = (win, BATCH)
        cfg, cat, masks, blocks = geos[gk]
        side = cfg.img_size
        if name == "kernel":
            for case in blocks:
                launch(fn, gk, case)
                torch.cuda.synchronize()
                want = fused_swin_block_plain(cat[:, :case["c"]], case["p"],
                                              masks, cfg, side, side,
                                              case["k"])
                err = (case["out"].float() - want).abs()
                if bool((err > SWIN_ATOL + 2.0 ** -7 * want.abs()).any()):
                    raise AssertionError(f"w{win} c={case['c']}: beyond the "
                                         "tolerance of chip_smoke.py")
        result[f"w{win}_{name}"] = {"plan": time_rdg(fn, gk, name, "plan",
                                                     {})}
    # where the profile build's warpgroups spend their clocks, a block at a
    # time: each kind of wait as a share of the consumer's span
    for win in GEOMETRIES:
        fn = fns[win, "profile"]
        take = fn.lib.adsr_swin_profile_take
        take.argtypes = [ctypes.c_void_p]
        clocks = (ctypes.c_ulonglong * len(PROFILE_SLOTS))()
        rows = []
        for case in geos[win, BATCH][3]:
            torch.cuda.synchronize()
            _build.check_rc("profile", take(ctypes.addressof(clocks)))
            launch(fn, (win, BATCH), case)
            torch.cuda.synchronize()
            _build.check_rc("profile", take(ctypes.addressof(clocks)))
            got = dict(zip(PROFILE_SLOTS, list(clocks)))
            span = got["span"] or 1
            share = {k: got[k] / span for k in PROFILE_SLOTS
                     if k not in ("span", "records")}
            share["empty"] = got["empty"] / max(1, got["records"] // 2) \
                / (span / max(1, got["records"]))
            rows.append({"c": case["c"], "clocks_per_warpgroup":
                         span / max(1, got["records"]), "share": share})
            print(f"[profile] w{win} c={case['c']}: span "
                  f"{span / max(1, got['records']):.0f} clocks a warpgroup; "
                  + ", ".join(f"{k} {v:.3f}" for k, v in share.items()),
                  flush=True)
        result[f"w{win}_profile"]["shares"] = rows
    # the unedited kernel at other settings, last
    extra = {(16, BATCH): {f"{s} stages": {"stages": s} for s in STAGES16},
             (4, BATCH): {"cluster 1": {"cluster": 1},
                          "cluster 2": {"cluster": 2}},
             (4, WIDE4): {f"B={WIDE4} cluster 1": {"cluster": 1},
                          f"B={WIDE4} cluster 2": {"cluster": 2}}}
    for gk, settings in extra.items():
        for label, kw in settings.items():
            result[f"w{gk[0]}_kernel"][label] = time_rdg(
                fns[gk[0], "kernel"], gk, "kernel", label, kw)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
