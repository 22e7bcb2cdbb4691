#!/usr/bin/env python3
"""Host cost per launch of the port's GEMM kernels (b) ``rdg_gemm`` and (d)
``rdg_gemm_bwd`` on one CUDA card, at the flagship DRCT x4 @128px shapes
(batch 16, M = 16384 token rows, the five Swin blocks of one RDG).

    python3 scripts/torch_gemm_launch_cost.py [--root DIR]

``--root`` is a checkout (or ``git archive``) of the repo whose
``adsr_tpu_torch`` is measured (default: this one), so two versions can be
compared on one card in one run, in turns. Each set is one RDG's
launches as that version's main path makes them: (b) the 25 forward
products; (d) the 25 backward products (``rdg_gemm_grads`` where the
version has it, else ``rdg_gemm_dgrad`` then ``rdg_gemm_wgrad``), operands
in 16-byte rows where the version has ``pitched``. Per set:

- ``host_us_per_launch``: host wall time to issue the set (no device wait:
  the queue is drained before each repetition), median and least of 30;
- ``graph_ms``: device time of the set replayed as a CUDA graph;
- ``launched_ms``: the set launched from Python, CUDA events over 20;
- ``gap_us_per_launch``: (launched_ms - graph_ms) / launches.

Also the rdg-mode serving forward at batch 16 (random weights), launched and
as a CUDA graph. Prints one JSON line, with the card's name and power limit.
``--profile N`` adds, for the forward and each set, the N functions with the
most host time of their own under cProfile (us per call and per launch).
``--train-steps N`` adds the train step at batch 16 (``make_train_step``,
random images): ms a step over N steps after warm-up (CUDA events), median
and least of 5 repetitions.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH, HR, SCALE, SEED = 16, 128, 4, 0


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
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


def graph_ms(fn, iters: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def host_us(fn, reps: int = 30):
    """(median, least) host seconds to issue ``fn``'s launches, in us."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6, min(times) * 1e6


def host_profile(fn, launches: int, top: int, reps: int = 10) -> list:
    """[(function, us per call, calls per launch, us per launch)] of the
    ``top`` functions by host time of their own over ``reps`` runs."""
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    for _ in range(reps):
        prof.enable()
        fn()
        prof.disable()
        torch.cuda.synchronize()
    rows = []
    for (file, line, name), (_, calls, own, _, _) in \
            pstats.Stats(prof).stats.items():
        rows.append((f"{Path(file).name}:{line} {name}", own * 1e6 / calls,
                     calls / (reps * launches), own * 1e6 / (reps * launches)))
    return sorted(rows, key=lambda r: -r[3])[:top]


def measure(fn, launches: int, top: int = 0) -> dict:
    med, least = host_us(fn)
    g = graph_ms(fn, iters=20)
    launched = cuda_ms(fn, iters=20)
    out = {"launches": launches, "host_us_per_launch": med / launches,
           "host_us_per_launch_least": least / launches, "graph_ms": g,
           "launched_ms": launched,
           "gap_us_per_launch": (launched - g) * 1e3 / launches}
    if top:
        out["host_profile"] = host_profile(fn, launches, top)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    ap.add_argument("--train-steps", type=int, default=0, metavar="N")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from adsr_tpu_torch.core.config import drct_experiment
    from adsr_tpu_torch.kernels import rdg_gemm as rg
    from adsr_tpu_torch.kernels import rdg_gemm_bwd as gb
    from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
    from adsr_tpu_torch.kernels.fused_rdg import rdg_geometry
    from adsr_tpu_torch.models.factory import init_sr_params
    from adsr_tpu_torch.train.trainer import make_train_step

    dev = torch.device("cuda")
    exp = drct_experiment("grid", HR, SCALE, precision="bf16",
                          batch_size=BATCH)
    cfg = exp.model
    geo = rdg_geometry(cfg)
    m = BATCH * cfg.img_size ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32
    pitched = getattr(rg, "pitched", None)

    def rnd(*shape, dtype=bf, std=1.0, pitch=False):
        t = (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)
        if pitch and pitched is not None:
            out = pitched(*shape, dtype=dtype, device=dev)
            out.copy_(t)
            return out
        return t

    cat = rnd(m, geo["cat_width"])
    dcat = rnd(m, geo["cat_width"], dtype=f32)
    res = rnd(m, max(geo["feats"]), dtype=f32)
    g_out = rnd(m, cfg.embed_dim)
    dp = torch.ones(BATCH, 10, device=dev)
    fwd, bwd = [], []
    for k in range(5):
        c, f, a_out = geo["feats"][k], geo["hidden"][k], geo["adj_out"][k]
        act, hid = rnd(m, c, pitch=True), rnd(m, f, pitch=True)
        ctx, x1, qkv = rnd(m, c), rnd(m, c), rnd(m, 3 * c)
        pre = rnd(m, f)
        ws = {n: (rnd(o, i, std=0.05, pitch=True), rnd(o, dtype=f32))
              for n, (o, i) in {"qkv": (3 * c, c), "proj": (c, c),
                                "fc1": (f, c), "fc2": (c, f),
                                "adj": (a_out, c)}.items()}
        out = torch.empty(m, 3 * c, dtype=bf, device=dev)
        fwd += [(act, *ws["qkv"], out, "none", None),
                (ctx, *ws["proj"], out[:, :c], "residual", cat[:, :c]),
                (act, *ws["fc1"], out[:, :f], "gelu", None),
                (hid, *ws["fc2"], out[:, :c], "residual", x1)]
        fwd.append((act, *ws["adj"], cat[:, c:c + cfg.gc], "leaky_relu", None)
                   if k < 4 else
                   (act, *ws["adj"], cat[:, :cfg.embed_dim], "scaled_residual",
                    cat[:, :cfg.embed_dim]))
        adj = ((dcat[:, c:c + cfg.gc], {"slope_src": cat[:, c:c + cfg.gc]})
               if k < 4 else (g_out, {"alpha": 0.2}))
        for (dy, kw), w, a, odt in (
                (adj, ws["adj"][0], act, f32),
                ((res[:, :c], {"row_scale": dp[:, 2 * k + 1],
                               "gelu_pre": pre}), ws["fc2"][0], hid, bf),
                ((hid, {}), ws["fc1"][0], act, f32),
                ((res[:, :c], {"row_scale": dp[:, 2 * k]}), ws["proj"][0],
                 ctx, bf),
                ((qkv, {}), ws["qkv"][0], act, f32)):
            bwd.append((dy, w, a, kw,
                        torch.empty(m, w.shape[1], dtype=odt, device=dev),
                        torch.empty(w.shape, dtype=f32, device=dev),
                        torch.empty(w.shape[0], dtype=f32, device=dev)))

    def gemm_set():
        for a, w, b, out, epi, r in fwd:
            rg.rdg_gemm(a, w, b, out, epi, r)

    grads = getattr(gb, "rdg_gemm_grads", None)

    def gemm_bwd_set():
        for dy, w, a, kw, out, dw, db in bwd:
            if grads is not None:
                grads(dy, w, a, out, dw, db, **kw)
            else:
                gb.rdg_gemm_dgrad(dy, w, out, **kw)
                gb.rdg_gemm_wgrad(dy, a, dw, db, **{
                    key: v for key, v in kw.items() if key != "gelu_pre"})

    result = {"root": str(Path(args.root).resolve()),
              "rdg_gemm": measure(gemm_set, len(fwd), args.profile),
              "rdg_gemm_bwd": measure(gemm_bwd_set, 2 * len(bwd),
                                      args.profile)}

    params, _ = init_sr_params(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    packed = prepack_drct(params, cfg, cfg.img_size, cfg.img_size,
                          dtype=bf, device=dev, mode="rdg")
    x = 255 * torch.rand(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                         generator=gen, device=dev)
    with torch.no_grad():
        result["forward"] = measure(lambda: fused_drct_apply(packed, cfg, x),
                                    40 * cfg.num_layers, args.profile)
    if args.train_steps:
        bundle = make_train_step(exp, device=dev)
        cpu_gen = torch.Generator().manual_seed(SEED)
        state = bundle.init_state(cpu_gen)
        side = cfg.img_size
        lrs = [255 * torch.rand(BATCH, side, side, cfg.in_chans,
                                generator=gen, device=dev)]
        hr = 255 * torch.rand(BATCH, side * SCALE, side * SCALE,
                              cfg.in_chans, generator=gen, device=dev)

        def train_step():
            bundle.step(state, lrs, hr, exp.optim.lr, cpu_gen)

        reps = [cuda_ms(train_step, args.train_steps, warmup=3)
                for _ in range(5)]
        result["train_step"] = {"steps": args.train_steps,
                                "step_ms": statistics.median(reps),
                                "step_ms_least": min(reps), "reps": reps}
    result["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
