#!/usr/bin/env python3
"""Drive the PyTorch port's DRCT x4 @128px anomaly-serving path on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit's nvcc. Phases, each printing its own lines; any failed check raises:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel of ``adsr_tpu_torch/csrc`` (timed);
3. kernels against their plain PyTorch versions at the flagship shapes
   (batch 16, 1024 tokens): rdg_layernorm at every block width, rdg_gemm at
   every product and epilogue of the five Swin blocks, window_attention at
   every block geometry at shift 0 and 4;
4. main path: the flagship DRCT (27.4M params, random weights from a seed,
   bf16) registered with ``AnomalyServer`` scores 16 good + 16 defective
   synthetic grid images and a tail of 5, with the launch counters of every
   kernel checked; the same forward runs through the eager f32 model on the
   card and is compared RDG by RDG; the array core of ``evaluate_anomaly``
   turns a test split into AUCs;
5. timing with CUDA events after warm-up: the forward at batch 16 (as
   launched, and replayed as a CUDA graph), a torch.profiler breakdown of its
   device time, and each kernel's launches of one RDG (device time, CUDA
   graph replay) beside its bound, its plain version and a library call that
   computes the same function.

The last three lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``; a ``[report]`` line before them holds
every number the run measured, as JSON.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from adsr_tpu_torch.core.config import drct_experiment
from adsr_tpu_torch.data.pipeline import set_channel
from adsr_tpu_torch.data.synthetic import grid_texture, inject_defect
from adsr_tpu_torch.eval.evaluate import evaluate_anomaly_arrays
from adsr_tpu_torch.eval.serving import AnomalyServer
from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.kernels.fused_rdg import rdg_flops, rdg_geometry
from adsr_tpu_torch.kernels.rdg_gemm import rdg_gemm, rdg_gemm_plain
from adsr_tpu_torch.kernels.rdg_layernorm import (rdg_layernorm,
                                                  rdg_layernorm_plain)
from adsr_tpu_torch.kernels.window_attention import (build_attn_term,
                                                     window_attention,
                                                     window_attention_plain)
from adsr_tpu_torch.models.drct import shift_attn_mask
from adsr_tpu_torch.models.factory import init_sr_params, make_model

SEED = 0
DEVICE = "cuda"
BATCH = 16
HR = 128
SCALE = 4
# H100 SXM published peaks (dense), for the bounds
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12

# Tolerances of the kernel checks (kernel in bf16 vs plain f32 on the same
# bf16-rounded inputs, TF32 off):
# - every kernel rounds its f32 result once to bf16 (unit roundoff 2^-8), and
#   f32 sums in another order can move a value across a rounding boundary:
#   |kernel - plain| <= ATOL + 2^-7 |plain|;
# - GEMM: f32 accumulation over K <= 616 in another order, ATOL 1e-3 for
#   outputs of order 1;
# - LayerNorm: f32 statistics as the plain version, ATOL 1e-4;
# - attention: the probabilities are rounded to bf16 before P @ V, so the
#   context may move by up to 2^-8 * max|v|: ATOL = 2^-8 * max|v|.
PARAMS_RANGE = (27.0e6, 27.8e6)     # the flagship has ~27.4M parameters
RTOL = 2.0 ** -7
GEMM_ATOL = 1e-3
LN_ATOL = 1e-4
# End to end, bf16 kernels vs the eager f32 model: the token stream is stored
# in bf16 after every RDG and each block rounds ~10 intermediates to bf16
# (unit roundoff 3.9e-3). On an H100 80GB HBM3 the seeded, perturbed weights
# read at most 6.5e-3 relative L2 on the token stream, 1.9e-2 on an RDG's
# increment (out - in, which passes through all of a block's roundings) and
# 5.6e-3 on the float SR; the limits sit at 2.3-2.7x those readings, tight
# enough that a fault in one RDG's path shows.
TOKENS_REL_L2 = 1.5e-2
INCREMENT_REL_L2 = 5e-2
SR_REL_L2 = 1.5e-2

KERNELS = ("rdg_layernorm", "rdg_gemm", "window_attention")
WRAPPERS = {"rdg_layernorm": rdg_layernorm, "rdg_gemm": rdg_gemm,
            "window_attention": window_attention}
PER_FORWARD = {"rdg_layernorm": 120, "rdg_gemm": 300, "window_attention": 60}
SOURCES = {k: f"adsr_tpu_torch/csrc/{k}.cu" for k in KERNELS}
REPLACES = "adsr_tpu/ops/fused_rdg.py:573"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def counts() -> dict:
    return {k: fn.launches for k, fn in WRAPPERS.items()}


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
    """Device time of ``fn``'s launches replayed as one CUDA graph: the same
    kernels back to back, without the host's launch gaps."""
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


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


class Checker:
    def __init__(self):
        self.max_abs = {k: 0.0 for k in KERNELS}
        self.cases = 0

    def __call__(self, kernel: str, case: str, got: torch.Tensor,
                 want: torch.Tensor, atol: float) -> None:
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        max_abs = err.max().item()
        rel = max_abs / max(want.abs().max().item(), 1e-30)
        bad = int((err > atol + RTOL * want.abs()).sum().item())
        say("kernels", f"{kernel:16s} {case:34s} max_abs {max_abs:.3e} "
                       f"max_abs/max|ref| {rel:.3e} over-tolerance {bad}")
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{kernel} {case}: {bad} elements beyond "
                                 f"{atol} + {RTOL}|ref|")
        self.max_abs[kernel] = max(self.max_abs[kernel], max_abs)
        self.cases += 1


def flagship_shapes(cfg):
    g = rdg_geometry(cfg)
    return g, BATCH * cfg.img_size * cfg.img_size


def make_case_inputs(cfg, dev, gen):
    """Random operands at every kernel shape of one RDG (bf16 working copies
    plus the f32 copies the plain versions read)."""
    g, m = flagship_shapes(cfg)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    cat = randn(m, g["cat_width"])
    n = cfg.window_size ** 2
    blocks = []
    for k in range(5):
        c, nh, f, a = g["feats"][k], g["heads"][k], g["hidden"][k], g["adj_out"][k]
        blk = {
            "c": c, "nh": nh, "f": f, "a": a, "shift": g["shifts"][k],
            "ln_w": 1.0 + randn(c, std=0.1, dtype=torch.float32),
            "ln_b": randn(c, std=0.1, dtype=torch.float32),
            "act": randn(m, c), "hid": randn(m, f), "x1": randn(m, c),
            "qkv": randn(m, 3 * c),
            "attn_bias": randn(nh, n, n, std=0.5, dtype=torch.float32),
        }
        for name, (n_out, n_in) in {"wqkv": (3 * c, c), "wproj": (c, c),
                                    "w1": (f, c), "w2": (c, f),
                                    "wadj": (a, c)}.items():
            blk[name] = randn(n_out, n_in, std=0.05)
            blk["b" + name[1:]] = randn(n_out, std=0.05, dtype=torch.float32)
        blocks.append(blk)
    masks = {s: torch.as_tensor(shift_attn_mask(cfg.img_size, cfg.img_size,
                                                cfg.window_size, s),
                                device=dev)
             for s in set(g["shifts"]) if s}
    return cat, blocks, masks


def gemm_cases(cfg, cat, blk, k):
    """(label, a, w, bias, epilogue, residual) of block k's five products."""
    c, d = blk["c"], cfg.embed_dim
    cases = [
        ("qkv", blk["act"], blk["wqkv"], blk["bqkv"], "none", None),
        ("proj", blk["act"], blk["wproj"], blk["bproj"], "residual", cat[:, :c]),
        ("fc1", blk["act"], blk["w1"], blk["b1"], "gelu", None),
        ("fc2", blk["hid"], blk["w2"], blk["b2"], "residual", blk["x1"]),
    ]
    if k < 4:
        cases.append(("adjust", blk["act"], blk["wadj"], blk["badj"],
                      "leaky_relu", None))
    else:
        cases.append(("adjust", blk["act"], blk["wadj"], blk["badj"],
                      "scaled_residual", cat[:, :d]))
    return cases


def phase_kernels(cfg, dev, check: Checker):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cat, blocks, masks = make_case_inputs(cfg, dev, gen)
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    for blk in blocks:
        c = blk["c"]
        out = torch.empty(m, c, dtype=torch.bfloat16, device=dev)
        rdg_layernorm(cat[:, :c], blk["ln_w"], blk["ln_b"], out)
        check("rdg_layernorm", f"c={c} (concat prefix, stride "
              f"{cat.shape[1]})", out,
              rdg_layernorm_plain(cat[:, :c].float(), blk["ln_w"],
                                  blk["ln_b"]), LN_ATOL)
    for k, blk in enumerate(blocks):
        for label, a, wt, bias, epi, res in gemm_cases(cfg, cat, blk, k):
            want = rdg_gemm_plain(a.float(), wt.float(), bias, epi,
                                  None if res is None else res.float())
            if label == "adjust":
                # adjust 1-4 straight into the concat columns at the buffer's
                # stride; adjust 5 in place over the RDG input
                dst = cat.clone()
                out = dst[:, blk["c"]:blk["c"] + cfg.gc] if k < 4 \
                    else dst[:, :cfg.embed_dim]
                res = None if k < 4 else out
            else:
                out = torch.empty(m, wt.shape[0], dtype=torch.bfloat16,
                                  device=dev)
            rdg_gemm(a, wt, bias, out, epi, res)
            check("rdg_gemm", f"b{k + 1} {label} {m}x{wt.shape[0]}x"
                  f"{wt.shape[1]} {epi}", out, want, GEMM_ATOL)
    for k, blk in enumerate(blocks):
        c, nh = blk["c"], blk["nh"]
        atol = 2.0 ** -8 * blk["qkv"][:, 2 * c:].float().abs().max().item()
        for shift in (0, cfg.window_size // 2):
            mask = masks.get(shift)
            out = torch.empty(m, c, dtype=torch.bfloat16, device=dev)
            window_attention(blk["qkv"], out, blk["attn_bias"], mask, h, w,
                             nh, cfg.window_size, shift)
            want = window_attention_plain(blk["qkv"].float(), blk["attn_bias"],
                                          mask, h, w, nh, cfg.window_size,
                                          shift)
            check("window_attention", f"b{k + 1} c={c} heads={nh} "
                  f"hd={c // nh} shift={shift}", out, want, atol)


def synthetic_split(rng, n_good, n_bad):
    """uint8 RGB HR [N,128,128,3] and LR [N,32,32,3]. The LR is 4x4 block
    averaging, a stand-in for the reference's Lanczos prep, which waits for
    the data slice of the port."""
    good = [grid_texture(rng, HR) for _ in range(n_good)]
    kinds = ("blob", "scratch")
    bad = [inject_defect(rng, grid_texture(rng, HR), kinds[i % 2])
           for i in range(n_bad)]
    hr = np.stack(good + bad)
    lr = hr.reshape(hr.shape[0], HR // SCALE, SCALE, HR // SCALE, SCALE, 3) \
        .astype(np.float64).mean(axis=(2, 4)).round().astype(np.uint8)
    return lr, hr


def to_float(imgs_u8, n_colors, rgb_range):
    return np.stack([set_channel(im, n_colors) for im in imgs_u8]) \
        * (rgb_range / 255.0)


def phase_main(exp, dev, report):
    cfg = exp.model
    params, _ = init_sr_params(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    # every leaf plus a seeded N(0, 0.02), as the CPU parity tests do, so
    # biases, LayerNorm affines and the bias tables are not trivial and the
    # attention is not near uniform
    gen = torch.Generator().manual_seed(SEED + 2)
    params = {k: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
              for k, v in params.items()}
    n_params = sum(v.numel() for v in params.values())
    say("main", f"DRCT x{cfg.upscale} @{HR}px: embed {cfg.embed_dim}, "
                f"{cfg.num_layers} RDGs, window {cfg.window_size}, "
                f"{n_params} params ({n_params / 1e6:.2f}M), {exp.precision}")
    if not PARAMS_RANGE[0] < n_params < PARAMS_RANGE[1]:
        raise AssertionError(f"param count {n_params}, expected ~27.4M")
    report["params"] = n_params

    rng = np.random.RandomState(SEED)
    lr_u8, hr_u8 = synthetic_split(rng, 16 + 5, 16)
    order = list(range(16)) + list(range(21, 37)) + list(range(16, 21))
    lr_u8, hr_u8 = lr_u8[order], hr_u8[order]      # good, bad, tail of 5
    server = AnomalyServer(batch_size=BATCH, ssim_window=11, device=dev)
    server.register("grid", exp, params)

    reset_counts()
    t0 = time.perf_counter()
    scores = server.score("grid", lr_u8, hr_u8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    n_fwd = math.ceil(len(lr_u8) / BATCH)
    say("main", f"AnomalyServer scored {len(lr_u8)} requests in {n_fwd} "
                f"forwards ({wall * 1e3:.1f} ms wall, first call); launches "
                f"{got}")
    for k in KERNELS:
        if got[k] != PER_FORWARD[k] * n_fwd:
            raise AssertionError(f"{k}: {got[k]} launches, expected "
                                 f"{PER_FORWARD[k]} x {n_fwd}")
    if scores.shape != (len(lr_u8), 3) or not np.isfinite(scores).all():
        raise AssertionError(f"scores {scores.shape} not finite")
    say("main", "scores (1-SSIM, MSE, -PSNR) mean good "
                f"{scores[:16].mean(0).round(5).tolist()} bad "
                f"{scores[16:32].mean(0).round(5).tolist()}")
    report["main_path_launches"] = got
    report["main_path_forwards"] = n_fwd

    # the same forward, kernels vs the eager f32 model (TF32 off), per RDG
    packed = prepack_drct(params, cfg, cfg.img_size, cfg.img_size,
                          dtype=torch.bfloat16, device=dev)
    x = torch.as_tensor(to_float(lr_u8[:BATCH], cfg.in_chans,
                                 exp.data.rgb_range), device=dev)
    model = make_model(cfg, device=dev)
    model.load_state_dict(params)
    with torch.no_grad():
        taps_k, taps_p = [], []
        sr_k = fused_drct_apply(packed, cfg, x, taps=taps_k)
        sr_p = model(x, taps=taps_p)
        t_in_k = t_in_p = None
        tok, inc = [], []
        for i, (tk, tp) in enumerate(zip(taps_k, taps_p)):
            tok.append(rel_l2(tk, tp))
            if i:
                inc.append(rel_l2(tk.float() - t_in_k.float(),
                                  tp - t_in_p))
            t_in_k, t_in_p = tk, tp
        sr_err = rel_l2(sr_k, sr_p)
    say("main", "kernels (bf16) vs eager f32 model, relative L2 of the token "
                "stream after each RDG: " + " ".join(f"{e:.2e}" for e in tok))
    say("main", "... of each RDG's increment (RDGs 2-12): "
                + " ".join(f"{e:.2e}" for e in inc))
    say("main", f"... of the float SR: {sr_err:.3e}")
    if max(tok) > TOKENS_REL_L2 or max(inc) > INCREMENT_REL_L2 \
            or sr_err > SR_REL_L2 or not torch.isfinite(sr_k).all():
        raise AssertionError(f"forward vs plain: tokens {max(tok):.3e} > "
                             f"{TOKENS_REL_L2} or increments {max(inc):.3e} > "
                             f"{INCREMENT_REL_L2} or SR {sr_err:.3e} > "
                             f"{SR_REL_L2}")
    report["rel_l2_tokens"] = tok
    report["rel_l2_increments"] = inc
    report["rel_l2_sr"] = sr_err

    # the array core of evaluate_anomaly over the same synthetic test split
    rgb = exp.data.rgb_range
    lr_f = to_float(lr_u8, cfg.in_chans, rgb)
    hr_f = to_float(hr_u8, cfg.in_chans, rgb)
    good = list(range(16)) + list(range(32, 37))
    bad = list(range(16, 32))
    reset_counts()
    res = evaluate_anomaly_arrays(exp, params, lr_f[good], hr_f[good],
                                  lr_f[bad], hr_f[bad], batch=BATCH,
                                  device=dev, log=lambda s: say("main", s))
    torch.cuda.synchronize()
    n_eval = math.ceil(len(good) / BATCH) + math.ceil(len(bad) / BATCH)
    got = counts()
    for k in KERNELS:
        if got[k] != PER_FORWARD[k] * n_eval:
            raise AssertionError(f"evaluate: {k} {got[k]} launches, "
                                 f"expected {PER_FORWARD[k]} x {n_eval}")
    aucs = [res["auc_ssim"], res["auc_mse"], res["auc_psnr"]]
    if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs):
        raise AssertionError(f"AUCs out of [0, 1]: {aucs}")
    say("main", f"evaluate_anomaly core: AUC ssim/mse/psnr "
                f"{aucs[0]:.4f}/{aucs[1]:.4f}/{aucs[2]:.4f}, best window "
                f"{res['best_ws']} (random weights: only range is checked); "
                f"launches {got}")
    report["evaluate"] = {"aucs": aucs, "best_ws": res["best_ws"],
                          "launches": got}
    return params, packed, x, model, server, lr_u8, hr_u8


def set_bounds(cfg, blocks, m, masks):
    """Least time (ms) of one RDG's launches of each kernel, and what bounds
    it: max(bytes / HBM rate, sum over types of ops / peak rate)."""
    ln_b = ln_ops = 0.0
    mm_b = mm_ops = 0.0
    at_b = at_tc = at_f32 = 0.0
    n = cfg.window_size ** 2
    for k, blk in enumerate(blocks):
        c, f, a, nh = blk["c"], blk["f"], blk["a"], blk["nh"]
        ln_b += 2 * (2 * m * c * 2 + 2 * c * 4)
        ln_ops += 2 * 8 * m * c
        for n_out, n_in, res in ((3 * c, c, False), (c, c, True),
                                 (f, c, False), (c, f, True), (a, c, k == 4)):
            mm_b += (m * n_in * 2 + n_out * n_in * 2 + n_out * 4
                     + m * n_out * 2 * (2 if res else 1))
            mm_ops += 2 * m * n_out * n_in
        at_b += m * 3 * c * 2 + m * c * 2 + nh * n * n * 4
        if blk["shift"]:
            at_b += masks[blk["shift"]].numel() * 4
        at_tc += 4 * m * n * c
        at_f32 += 6 * (m // n) * nh * n * n       # scale, bias, mask, exp, sum, div
    out = {}
    for name, byt, t_ops in (
            ("rdg_layernorm", ln_b, ln_ops / F32_FLOPS),
            ("rdg_gemm", mm_b, mm_ops / BF16_TC_FLOPS),
            ("window_attention", at_b, at_tc / BF16_TC_FLOPS
             + at_f32 / F32_FLOPS)):
        t_b = byt / HBM_BYTES_PER_S
        out[name] = (max(t_b, t_ops) * 1e3,
                     "bytes" if t_b >= t_ops else "operations")
    return out


def profile_forward(packed, cfg, x, reps: int = 3):
    """(wall ms per forward, {kernel family: device ms per forward}) from
    torch.profiler's CUDA activity; families not of this port are 'other'
    (the head/tail convolutions, LayerNorms, copies)."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        fused_drct_apply(packed, cfg, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(reps):
                fused_drct_apply(packed, cfg, x)
            end.record()
            torch.cuda.synchronize()
    families = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            fam = next((k for k in KERNELS if k + "_kernel" in ev.key), "other")
            families[fam] = families.get(fam, 0.0) + us / 1e3 / reps
    return start.elapsed_time(end) / reps, families


def head_tail_flops(packed, cfg, batch: int) -> int:
    """Flops of the convolutions outside the RDGs, from the packed weights."""
    side = cfg.img_size
    convs = [("conv_first", side), ("conv_after_body", side),
             ("conv_before_upsample.0", side)]
    convs += [(f"upsample.{2 * i}", side << i)
              for i in range(cfg.upscale.bit_length() - 1)]
    convs.append(("conv_last", side * cfg.upscale))
    return sum(2 * batch * s * s * packed["head"][name][0].numel()
               for name, s in convs)


def phase_timing(exp, dev, packed, x, model, server, lr_u8, hr_u8, report):
    cfg = exp.model
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: fused_drct_apply(packed, cfg, x), iters=20,
                         warmup=3)
        eager_ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
        fwd_graph_ms = graph_ms(lambda: fused_drct_apply(packed, cfg, x),
                                iters=20)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        server.score("grid", lr_u8[:BATCH], hr_u8[:BATCH])
    torch.cuda.synchronize()
    score_ms = (time.perf_counter() - t0) * 1e3 / reps
    say("timing", f"fused forward, batch {BATCH}: {fwd_ms:.3f} ms = "
                  f"{BATCH * 1e3 / fwd_ms:.1f} img/s (bf16 kernels); eager f32 "
                  f"model {eager_ms:.3f} ms; AnomalyServer.score of {BATCH} "
                  f"uint8 requests {score_ms:.3f} ms host wall")
    say("timing", f"the same forward replayed as a CUDA graph (no host launch "
                  f"gaps): {fwd_graph_ms:.3f} ms = "
                  f"{BATCH * 1e3 / fwd_graph_ms:.1f} img/s")
    report.update(forward_ms=fwd_ms, forward_img_per_s=BATCH * 1e3 / fwd_ms,
                  forward_graph_ms=fwd_graph_ms,
                  eager_f32_forward_ms=eager_ms, score_batch_ms=score_ms)
    wall, families = profile_forward(packed, cfg, x)
    busy = sum(families.values())
    if busy > 0:
        say("timing", "profiler, device ms per forward: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(families.items(),
                                              key=lambda kv: -kv[1]))
            + f"; busy {busy:.3f} of {wall:.3f} ms wall under the profiler "
              f"(idle share {max(0.0, 1 - busy / wall):.3f})")
    else:
        say("timing", "profiler recorded no device time: breakdown not "
                      "measured")
    report["profile"] = {"wall_ms": wall, "device_ms": families}

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cat, blocks, masks = make_case_inputs(cfg, dev, gen)
    # f32 copies for the plain versions, bf16 biases for the library calls
    cat32 = cat.float()
    blocks32 = [{k: (v.float() if torch.is_tensor(v) else v)
                 for k, v in blk.items()} for blk in blocks]
    bf = {id(t): t.to(torch.bfloat16) for blk in blocks for t in blk.values()
          if torch.is_tensor(t) and t.dtype == torch.float32}
    scratch = torch.empty(m * 3 * max(g["feats"]), dtype=torch.bfloat16,
                          device=dev)

    def rows(n_cols):
        return scratch[:m * n_cols].view(m, n_cols)

    def ln_set(mode="kernel"):
        for blk, blk32 in zip(blocks, blocks32):
            c = blk["c"]
            if mode == "library":
                for _ in range(2):
                    F.layer_norm(blk["x1"], (c,), bf[id(blk["ln_w"])],
                                 bf[id(blk["ln_b"])], eps=1e-6)
            elif mode == "plain":
                for src in (cat32[:, :c], blk32["x1"]):
                    rdg_layernorm_plain(src, blk["ln_w"], blk["ln_b"])
            else:
                for src in (cat[:, :c], blk["x1"]):
                    rdg_layernorm(src, blk["ln_w"], blk["ln_b"], rows(c))

    def gemm_set(mode="kernel"):
        for k, (blk, blk32) in enumerate(zip(blocks, blocks32)):
            if mode == "plain":
                for _, a, wt, bias, epi, res in gemm_cases(cfg, cat32, blk32, k):
                    rdg_gemm_plain(a, wt, bias, epi, res)
                continue
            for _, a, wt, bias, epi, res in gemm_cases(cfg, cat, blk, k):
                if mode == "library":
                    F.linear(a, wt, bf[id(bias)])
                else:
                    rdg_gemm(a, wt, bias, rows(wt.shape[0]), epi, res)

    sdpa_in = []
    nw = (h // cfg.window_size) * (w // cfg.window_size)
    for blk in blocks:
        hd = blk["c"] // blk["nh"]
        q, k_, v = (torch.randn(BATCH, nw, blk["nh"], cfg.window_size ** 2,
                                hd, generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(3))
        term = build_attn_term(blk["attn_bias"], h, w, cfg.window_size,
                               masks.get(blk["shift"]))
        sdpa_in.append((q, k_, v, term.to(torch.bfloat16).contiguous()))

    def attn_set(mode="kernel"):
        for k, (blk, blk32) in enumerate(zip(blocks, blocks32)):
            c, nh, shift = blk["c"], blk["nh"], blk["shift"]
            if mode == "library":
                q, k_, v, term = sdpa_in[k]
                F.scaled_dot_product_attention(q, k_, v, attn_mask=term)
            elif mode == "plain":
                window_attention_plain(blk32["qkv"], blk["attn_bias"],
                                       masks.get(shift), h, w, nh,
                                       cfg.window_size, shift)
            else:
                window_attention(blk["qkv"], rows(c), blk["attn_bias"],
                                 masks.get(shift), h, w, nh,
                                 cfg.window_size, shift)

    bounds = set_bounds(cfg, blocks, m, masks)
    timings = {}
    for name, fn in (("rdg_layernorm", ln_set), ("rdg_gemm", gemm_set),
                     ("window_attention", attn_set)):
        # device time: each set replayed as a CUDA graph (launched one by
        # one from Python the small kernels are bound by host launch cost,
        # reported beside as launched_ms)
        kernel_ms = graph_ms(fn, iters=20)
        plain_ms = graph_ms(lambda: fn("plain"), iters=5)
        library_ms = graph_ms(lambda: fn("library"), iters=20)
        launched_ms = cuda_ms(fn, iters=20)
        timings[name] = (kernel_ms, plain_ms, library_ms) + bounds[name]
        report.setdefault("per_rdg_launched_ms", {})[name] = launched_ms
        say("timing", f"{name:16s} one RDG's launches: kernel "
                      f"{kernel_ms:.4f} ms, bound {bounds[name][0]:.4f} ms "
                      f"({bounds[name][1]}), plain f32 {plain_ms:.4f} ms, "
                      f"library {library_ms:.4f} ms (device time, CUDA "
                      f"graph); launched from Python {launched_ms:.4f} ms")
    rdg_sum = sum(t[0] for t in timings.values())
    say("timing", f"sum over kernels x {cfg.num_layers} RDGs = "
                  f"{rdg_sum * cfg.num_layers:.3f} ms of the {fwd_ms:.3f} ms "
                  "forward")
    flops = cfg.num_layers * rdg_flops(cfg, m)
    head = head_tail_flops(packed, cfg, BATCH)
    compute_ms = (flops + head) / BF16_TC_FLOPS * 1e3
    unfused_ms = cfg.num_layers * sum(t[3] for t in timings.values())
    say("timing", f"forward bounds at batch {BATCH}: compute {compute_ms:.3f} "
                  f"ms ({(flops + head) / BATCH / 1e9:.2f} GFLOP an image, "
                  f"head/tail convs {head / BATCH / 1e9:.2f}); the kernels' own "
                  f"bounds x {cfg.num_layers} RDGs {unfused_ms:.3f} ms")
    report.update(forward_compute_bound_ms=compute_ms,
                  forward_unfused_bound_ms=unfused_ms,
                  gflop_per_image=(flops + head) / BATCH / 1e9)
    report["per_rdg_ms"] = {k: {"ms": v[0], "plain_ms": v[1],
                                "library_ms": v[2], "bound_ms": v[3],
                                "bound_by": v[4]} for k, v in timings.items()}
    return timings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs one",
              file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    # the plain f32 references run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    t_start = time.perf_counter()

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; nvidia-smi name,power.limit: {smi}; torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}, "
                  f"{torch.cuda.device_count()} device(s)")
    report["device"] = {"name": kind, "nvidia_smi": smi}

    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.library()
    build_s = time.perf_counter() - t0
    say("build", f"{lib.relative_to(_build.BUILD_ROOT.parent.parent)} ready "
                 f"in {build_s:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line.lower():
            say("build", line.strip())
    report["build_s"] = build_s

    exp = drct_experiment("grid", HR, SCALE, precision="bf16",
                          batch_size=BATCH, run_tag="chip_smoke")
    check = Checker()
    phase_kernels(exp.model, dev, check)
    say("kernels", f"{check.cases} cases within tolerance; max abs error "
                   f"{check.max_abs}")
    report["max_abs_err"] = check.max_abs

    params, packed, x, model, server, lr_u8, hr_u8 = phase_main(exp, dev,
                                                                report)
    main_launches = report["main_path_launches"]
    timings = phase_timing(exp, dev, packed, x, model, server, lr_u8, hr_u8,
                           report)

    kernels = []
    for k in KERNELS:
        kernel_ms, plain_ms, library_ms, bound_ms, bound_by = timings[k]
        kernels.append({"name": k, "route": "cuda", "source": SOURCES[k],
                        "replaces": REPLACES, "launches": main_launches[k],
                        "max_abs_err": check.max_abs[k], "ms": kernel_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms})
    report["total_s"] = time.perf_counter() - t_start
    say("report", json.dumps(report))
    say("done", f"all phases passed in {report['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
