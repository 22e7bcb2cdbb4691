#!/usr/bin/env python3
"""Drive the PyTorch port's DRCT x4 @128px serving and training paths and its
train and evaluate CLIs on one GPU, then the window-16 geometry (256px/x4
and 512/x8).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit's nvcc. Phases, each printing its own lines; any failed check raises:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel of ``adsr_tpu_torch/csrc`` (timed) and
   ptxas's registers, shared memory and spills of each kernel are printed,
   then the launch plans of window_attention (c), swin_block (g),
   window_attention_bwd (f) and rdg_layernorm_bwd (e) at the five flagship
   blocks (blocks, threads, shared memory, (g)'s ring, (f)'s windows a
   block);
3. kernels against their plain PyTorch versions at the flagship shapes
   (batch 16, 1024 tokens): rdg_layernorm at every block width, rdg_gemm at
   every product and epilogue of the five Swin blocks (the training
   forward's drop-path and GELU-with-pre-activation epilogues included, and
   the redesign's edges: an M that is not a multiple of the 128-row tile,
   the N = 32 and N = 180 adjust products, ``out`` aliasing ``residual``),
   window_attention at every block geometry at shift 0 and 4 (and block 2
   at batch 5), and the whole
   Swin block kernel swin_block (g) at all five blocks, also against the
   (a)-(c) composition;
4. main path: the flagship DRCT (27.4M params, random weights from a seed,
   bf16) registered with ``AnomalyServer`` scores 16 good + 16 defective
   synthetic grid images and a tail of 5, in rdg mode and in block mode,
   with the launch counters of every kernel checked; both forwards run
   against the eager f32 model on the card RDG by RDG; the array core of
   ``evaluate_anomaly`` turns a test split into AUCs;
5. timing with CUDA events after warm-up: the forward at batch 16 in both
   modes (as launched, and replayed as a CUDA graph), a torch.profiler
   breakdown of its device time, and each kernel's launches of one RDG
   (device time, CUDA graph replay) beside its bound, its achieved TB/s and
   TFLOP/s, its plain version and a library call that computes the same
   function (for swin_block also the (a)-(c) composition); every main path's
   GEMM operands must all go by TMA (``[paths]`` lines);
6. backward kernels against their plain versions at the flagship shapes:
   rdg_gemm_bwd (dgrad and wgrad of all five products of every block
   through ``rdg_gemm_grads``, as the training backward calls them, with
   their dY transforms and strided f32 dY slices, an M that is not a
   multiple of the tile, and every call run twice, bitwise equal),
   rdg_layernorm_bwd (both LayerNorms of
   every block, accumulating into the strided concat gradient),
   window_attention_bwd (every block geometry at shift 0 and 4, qkv, dO
   and dqkv in 16-byte rows as the training backward lays them out, and
   blocks 1 and 4 at batch 5 on 40 x 40 tokens, whose windows the plan
   groups with a short last group); each (e) and (f) call twice, bitwise
   equal;
7. one RDG at full width and batch 16 (seeded weights perturbed by
   N(0, 0.02), drop-path zeros): the autograd Function's output and every
   gradient (bf16 kernels) against the eager f32 RDG under autograd, with a
   limit per class of tensor, and two backward passes bitwise equal;
8. training: a ``Trainer`` on the flagship experiment (bf16, drop path live)
   trains two short epochs on 32 synthetic good grid images, then
   ``Trainer.test`` scores 8; the launch counters of every kernel per step
   are checked; 20 steps on one fixed batch lower the loss;
9. training timing: the train step at batch 16 (CUDA events), its forward and
   backward, a torch.profiler breakdown and idle share, and the backward
   kernels' launches of one RDG beside their bounds, plain versions and
   library calls (the SDPA backward replayed as a CUDA graph, or the median
   of 20 launched runs where it cannot be captured);
10. the CLIs: a synthetic data root written with the port's PNG writer
   (under ``workspace/chip_smoke``), ``cli.main`` trains the flagship for
   one epoch (16 steps at batch 16) into a run dir, then ``cli.evaluate``
   scores 8 + 8 test images of 512 px, auto-tiled (25 tiles of 32 LR px an
   image), in rdg mode and with ``ADSR_TPU_RDG=0``; launch counters, run-dir
   files, AUCs, specificity and tiled img/s in both modes;
11. the window-16 geometry, lines "[w16] <phase>: ...": the full-width
   256px model (``drct_experiment("grid", 256, 4)``: LR 64 x 64, 16x16
   windows, N = 256 keys, shifts 0 and 8, M = 65,536 token rows at batch
   16) through phases 2-10 at that size: the plans of (c), (g) (a cluster
   of four blocks a window, and the clusters the card holds at once) and
   (f); kernels (a)-(c), (g) and (d)-(f) against their plain versions
   (every block, both shifts; (c) and (f) take the bias as its relative-
   position table and the shift mask as region labels, and (c) also writes
   each query row's softmax statistics, checked against the plain
   version's; (f) is fed (c)'s own context and statistics, as the training
   backward feeds it, also at batch 5 with short groups; (g) at batch 5 on
   32 x 32 tokens and against the (a)-(c) composition; each (f) and (g)
   call twice, bitwise equal); ``AnomalyServer`` scores 16 good
   + 16 defective 256 px images and a tail of 5 in rdg mode and in block
   mode (``ADSR_TPU_RDG=0``), and both forwards run RDG by RDG against the
   eager f32 model; the timing of both forwards, each kernel ((c) also with
   the statistics, as the training recompute calls it) and the step;
   one RDG's gradients; the Trainer; ``cli.main --resolution 256`` and
   ``cli.evaluate`` in both modes on 512 px test images (2 x 2 tiles of 64
   LR px); then 512 px at x8 (``drct_experiment("grid", 512, 8)``):
   ``AnomalyServer`` scores one batch in each mode, the SR against eager
   f32, and four train steps.

The last three lines are the kernels' JSON record (each kernel's
window-16 readings under ``"w16"``, its launches on every main path under
``"launches_by_path"``), the nvidia-smi line and ``{"ok": true, "device":
{...}}``; a ``[report]`` line before them holds every number the run
measured, as JSON (the window-16 phase's under ``"w16"``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from adsr_tpu_torch.cli import evaluate as cli_eval
from adsr_tpu_torch.cli import main as cli_main
from adsr_tpu_torch.core.config import drct_experiment
from adsr_tpu_torch.data.pipeline import SRDataset, load_sr_dataset, set_channel
from adsr_tpu_torch.data.synthetic import grid_texture, inject_defect
from adsr_tpu_torch.eval.evaluate import evaluate_anomaly_arrays
from adsr_tpu_torch.eval.rundir import resolve_checkpoint
from adsr_tpu_torch.eval.serving import AnomalyServer
from adsr_tpu_torch.eval.tiled import tile_starts
from adsr_tpu_torch.io.journal import load_state_dict
from adsr_tpu_torch.io.png import write_png
from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.kernels import rdg_gemm_bwd as gbwd
from adsr_tpu_torch.kernels.fused_rdg import (block_buffers, fused_rdg,
                                              prepack_rdg_stack, rdg_flops,
                                              rdg_geometry, rdg_workspace,
                                              shift_masks, swin_block_forward)
from adsr_tpu_torch.kernels.fused_swin_block import (fused_swin_block,
                                                     fused_swin_block_plain,
                                                     swin_block16_clusters,
                                                     swin_block_plan)
from adsr_tpu_torch.kernels.fused_rdg_train import (fused_drct_train_forward,
                                                    fused_rdg_train,
                                                    rdg_train_flops,
                                                    rdg_train_plain)
from adsr_tpu_torch.kernels.rdg_gemm import (pitched, rdg_gemm,
                                             rdg_gemm_plain, row_pitch)
from adsr_tpu_torch.kernels.rdg_layernorm import (rdg_layernorm,
                                                  rdg_layernorm_plain)
from adsr_tpu_torch.kernels.rdg_layernorm_bwd import (rdg_layernorm_bwd,
                                                      rdg_layernorm_bwd_plain,
                                                      rdg_layernorm_bwd_plan)
from adsr_tpu_torch.kernels.window_attention import (TILED_WINDOWS,
                                                     attn_operands,
                                                     build_attn_term,
                                                     full_bias,
                                                     softmax_stats,
                                                     window_attention,
                                                     window_attention_plain,
                                                     window_attention_plan)
from adsr_tpu_torch.kernels.window_attention_bwd import (
    window_attention_bwd, window_attention_bwd_plain,
    window_attention_bwd_plan)
from adsr_tpu_torch.models.drct import RDG, drop_path_mults, shift_attn_mask
from adsr_tpu_torch.models.factory import (init_sr_params, init_weights_,
                                           make_model)
from adsr_tpu_torch.train.trainer import (Trainer, make_tiled_serving_forward,
                                          make_train_step)

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
# - swin_block (g), a whole Swin block on N(0, 1) tokens with N(0, 0.05^2)
#   weights: it rounds the same operands to bf16 as the (a)-(c) composition
#   (LayerNorm outputs, q/k/v, P, the context, the hidden activations) but
#   keeps the residual stream in f32. On an H100 80GB HBM3 at 700 W the
#   kernel read at most 1.92e-2 absolute against its plain version at the
#   five flagship blocks (outputs up to |5.9|), the composition 3.37e-2:
#   ATOL 4e-2 is twice the kernel's reading and above the composition's;
#   (g) against the composition is held to twice that.
PARAMS_RANGE = (27.0e6, 27.8e6)     # the flagship has ~27.4M parameters
RTOL = 2.0 ** -7
GEMM_ATOL = 1e-3
LN_ATOL = 1e-4
SWIN_ATOL = 4e-2
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

# Backward kernels against their plain f32 versions on the same inputs:
# - rdg_gemm_bwd: dY rounds to bf16 in shared memory (relative 2^-9 a term)
#   and a bf16 output rounds once more, so elementwise
#   |err| <= 2^-8 (sum |dY_eff| |W| + |ref|), the sum taken over the
#   reduction; db sums the f32 dY, so its bound is 1e-5 of sum |dY_eff|;
# - rdg_layernorm_bwd: f32 statistics and sums as the plain version, in
#   another order: 1e-4 of the largest magnitude of each output;
# - window_attention_bwd: P and dS round to bf16 before the three output
#   products: 2^-7 (max |ref| + |ref|) per part of dqkv, 2^-8 max |ref| for
#   d(bias) (dS itself is f32).
# One RDG, bf16 kernels vs the eager f32 RDG under autograd, relative L2 per
# tensor, one limit per class; readings on an H100 80GB HBM3 at 700 W:
# - output 2.376e-3, input gradient 2.728e-3: limit 7e-3 (2.9x, 2.6x);
# - block 5's parameters, whose gradients reach them through the linear
#   0.2 * adjust 5: at most 5.767e-3 (swin5.mlp.fc1.weight), limit 1.5e-2
#   (2.6x);
# - blocks 1-4's parameters: weight matrices and bias tables at most
#   4.381e-2 (swin4.attn.proj.weight), bias and LayerNorm vectors at most
#   5.683e-2 (swin3.norm1.bias), limit 1e-1 (2.3x, 1.8x), the line above
#   which a reading is a fault rather than rounding. Their gradients pass
#   through adjust 1-4's LeakyReLU, whose slope (1 or 0.2) the backward
#   reads from the sign of the bf16 forward's concat: where the bf16 and
#   f32 forwards put a pre-activation on opposite sides of 0 the two
#   gradients differ by 0.8 of that element's. phase_rdg prints the share
#   of such elements.
RDG_REL_L2 = {"out/dx": 7e-3, "block 5": 1.5e-2, "blocks 1-4": 1e-1}
# Kernel (c)'s softmax statistics at 16x16 windows (each query row's max m
# and 1 / sum of its scaled, biased, masked scores) against the plain
# version's f32 ones on the same bf16 q, k: both sum the same exact bf16
# products in f32, in another order (~1e-6 relative on scores of order 1-10),
# so m within 1e-4 + 1e-4 |m| and 1 / sum within 1e-4 relative.
STATS_TOL = 1e-4


def rdg_tensor_class(name: str) -> str:
    if name in ("out", "dx"):
        return "out/dx"
    return "block 5" if name.startswith(("swin5.", "adjust5.")) \
        else "blocks 1-4"


# Training on one fixed batch: 20 steps at the flagship's LR lowered the L1
# loss by 51.6% (same card); the check asks for half of that.
FIXED_BATCH_STEPS = 20
FIXED_BATCH_MIN_DROP = 0.25

KERNELS = ("rdg_layernorm", "rdg_gemm", "window_attention")
BWD_KERNELS = ("rdg_gemm_bwd", "rdg_layernorm_bwd", "window_attention_bwd")
BLOCK_KERNELS = ("swin_block",)
WRAPPERS = {"rdg_layernorm": rdg_layernorm, "rdg_gemm": rdg_gemm,
            "window_attention": window_attention,
            "rdg_gemm_dgrad": gbwd.rdg_gemm_dgrad,
            "rdg_gemm_wgrad": gbwd.rdg_gemm_wgrad,
            "rdg_layernorm_bwd": rdg_layernorm_bwd,
            "window_attention_bwd": window_attention_bwd,
            "swin_block": fused_swin_block}
PER_FORWARD = {"rdg_layernorm": 120, "rdg_gemm": 300, "window_attention": 60}
# block mode: per RDG five (g) launches and five adjust products
PER_FORWARD_BLOCK = {"swin_block": 60, "rdg_gemm": 60}
# one train step, 12 RDGs: forward 10 / 25 / 5 a RDG; the backward
# recomputes 10 LayerNorms, 20 products (not adjust) and 5 attentions, then
# 25 dgrad, 25 wgrad, 10 LayerNorm backward and 5 attention backward a RDG
PER_TRAIN_STEP = {"rdg_layernorm": 240, "rdg_gemm": 540,
                  "window_attention": 120, "rdg_gemm_dgrad": 300,
                  "rdg_gemm_wgrad": 300, "rdg_layernorm_bwd": 120,
                  "window_attention_bwd": 60}
# 16x16 windows: kernel (f) makes two launches a call (dq, then dK / dV
# over groups of windows), so 120 a step; the other counts are the
# flagship's (the same launches a block at any window)
PER_TRAIN_STEP_W16 = {**PER_TRAIN_STEP, "window_attention_bwd": 120}
W16_BWD_LAUNCHES = 2
SOURCES = {k: f"adsr_tpu_torch/csrc/{k}.cu"
           for k in KERNELS + BWD_KERNELS + BLOCK_KERNELS}
# kernels (c)'s, (f)'s and (g)'s 16x16-window launches have sources of
# their own
W16_SOURCES = {"window_attention": "adsr_tpu_torch/csrc/window_attention16.cu",
               "window_attention_bwd":
               "adsr_tpu_torch/csrc/window_attention_bwd16.cu",
               "swin_block": "adsr_tpu_torch/csrc/swin_block16.cu"}
REPLACES = "adsr_tpu/ops/fused_rdg.py:573"
REPLACES_TRAIN_FWD = "adsr_tpu/ops/fused_rdg_train.py:823"
REPLACES_BWD = "adsr_tpu/ops/fused_rdg_train.py:968"
REPLACES_BLOCK = "adsr_tpu/ops/fused_swin_block.py:337"


def expected_counts(per: dict, n: int) -> dict:
    """Launch counts of every wrapper after ``n`` runs of ``per``."""
    want = {k: 0 for k in WRAPPERS}
    want.update({k: v * n for k, v in per.items()})
    return want


# "w16" while the window-16 phase runs: its lines read "[w16] <phase>: ..."
PREFIX = None


def say(phase: str, msg: str) -> None:
    if PREFIX:
        print(f"[{PREFIX}] {phase}: {msg}", flush=True)
    else:
        print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """``rdg_gemm_kernel<128,6>`` from an Itanium-mangled kernel name (the
    length-prefixed identifier that ends in ``_kernel``, and its integer
    template arguments)."""
    found = re.search(r"_kernel(?=I|E|v)", mangled)
    if found is None:
        return mangled
    end = found.end()
    for start in range(end - 1, 0, -1):
        digits = str(end - start)
        if mangled[start - len(digits):start] == digits:
            args = re.match(r"I((?:Li\d+E)+)E", mangled[end:])
            return mangled[start:end] + (
                "<" + ",".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"
                if args else "")
    return mangled


def ptxas_summary(log: str) -> list:
    """One line per kernel from ptxas -v: its name (and template
    arguments), registers, shared memory and spills."""
    lines, name, spill = [], None, ""
    for raw in log.splitlines():
        line = raw.strip()
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "spill stores" in line:
            spill = line
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return lines


GEMMS = ("rdg_gemm", "rdg_gemm_bwd")


def reset_counts() -> None:
    """Every wrapper's launch count, and the GEMM kernels' operand counts
    by load path, to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    for k in GEMMS:
        _build.operand_paths(k)[:] = [0, 0]
    gbwd.dy_eff_copies = 0


def counts() -> dict:
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def operand_paths() -> dict:
    """{GEMM kernel: [operands loaded by TMA, by cp.async]} since the last
    :func:`reset_counts`."""
    return {k: list(_build.operand_paths(k)) for k in GEMMS}


# dY_eff copies of one Swin block's backward: adjust (the f32 concat
# gradient, or 0.2 g), fc2 and proj (the f32 residual-stream gradient with
# the drop-path multiplier); fc1's dh and qkv's dqkv (16-byte rows, written
# by kernel (f)) are read in place
DY_EFF_COPIES_PER_BLOCK = 3


def check_operand_paths(path: str, got: dict, report: dict,
                        bwd_launches: int = 1) -> None:
    """Every GEMM operand of a main path goes by TMA: the port keeps every
    buffer a GEMM loads in 16-byte rows (the attention context too, which
    kernel (c) writes in 16-byte stores, and dqkv, which kernel (f) writes
    in 16-byte rows), and the backward's dY that are not (an f32 gradient)
    go through the dY_eff pre-pass into 16-byte rows. A lost TMA path, or a
    dY copied that could be read in place, fails here instead of only
    running slower. ``bwd_launches``: kernel (f)'s launches a Swin block
    backward (2 at 16x16 windows)."""
    paths = operand_paths()
    want = {"rdg_gemm": 2 * got["rdg_gemm"],
            "rdg_gemm_bwd": 2 * (got["rdg_gemm_dgrad"]
                                 + got["rdg_gemm_wgrad"])}
    copies = gbwd.dy_eff_copies
    want_copies = DY_EFF_COPIES_PER_BLOCK * got["window_attention_bwd"] \
        // bwd_launches
    say("paths", f"{path}: GEMM operands [TMA, cp.async] {paths}; dY_eff "
                 f"copies {copies} (qkv's dY read in place)")
    for k, total in want.items():
        if paths[k] != [total, 0]:
            raise AssertionError(f"{path}: {k} operands {paths[k]} by [TMA, "
                                 f"cp.async], expected {total} by TMA and "
                                 "none by cp.async")
    if copies != want_copies:
        raise AssertionError(f"{path}: {copies} dY_eff copies, expected "
                             f"{want_copies}")
    report.setdefault("operand_paths", {})[path] = paths
    report.setdefault("dy_eff_copies", {})[path] = copies


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
        self.max_abs = {k: 0.0 for k in KERNELS + BWD_KERNELS + BLOCK_KERNELS}
        self.cases = 0

    def __call__(self, kernel: str, case: str, got: torch.Tensor,
                 want: torch.Tensor, atol, rtol: float = RTOL,
                 phase: str = "kernels") -> None:
        """|got - want| <= atol + rtol |want| elementwise; ``atol`` a float
        or a tensor of per-element bounds."""
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        max_abs = err.max().item()
        rel = max_abs / max(want.abs().max().item(), 1e-30)
        bad = int((err > atol + rtol * want.abs()).sum().item())
        say(phase, f"{kernel:20s} {case:40s} max_abs {max_abs:.3e} "
                   f"max_abs/max|ref| {rel:.3e} over-tolerance {bad}")
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{kernel} {case}: {bad} elements beyond "
                                 "the tolerance")
        self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0), max_abs)
        self.cases += 1


def flagship_shapes(cfg):
    g = rdg_geometry(cfg)
    return g, BATCH * cfg.img_size * cfg.img_size


def make_case_inputs(cfg, dev, gen):
    """Random operands at every kernel shape of one RDG (bf16 working copies
    plus the f32 copies the plain versions read), laid out as the main path
    lays them out: weights, the GEMM operands ``act`` (LayerNorm and adjust
    inputs, and the attention context ``ctx``: the same tensor) and ``hid``,
    ``qkv``, and the backward's ``dqkv`` (the qkv values) and ``dctx`` (the
    act values) in 16-byte rows (``pitched``; ``attention_grad_buffers`` on
    the training backward), as kernels (b)-(d) and (f) take them; at 16x16
    windows the bias as a random relative-position table ``attn_table``
    (what (c) and (f) read) and its gather ``attn_bias``."""
    g, m = flagship_shapes(cfg)

    def randn(*shape, std=1.0, dtype=torch.bfloat16, pitch=False):
        t = (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)
        if not pitch:
            return t
        out = pitched(*shape, dtype=dtype, device=dev)
        out.copy_(t)
        return out

    cat = randn(m, g["cat_width"])
    n = cfg.window_size ** 2
    blocks = []
    for k in range(5):
        c, nh, f, a = g["feats"][k], g["heads"][k], g["hidden"][k], g["adj_out"][k]
        blk = {
            "c": c, "nh": nh, "f": f, "a": a, "shift": g["shifts"][k],
            "ln_w": 1.0 + randn(c, std=0.1, dtype=torch.float32),
            "ln_b": randn(c, std=0.1, dtype=torch.float32),
            "act": randn(m, c, pitch=True), "hid": randn(m, f, pitch=True),
            "x1": randn(m, c),
            "qkv": randn(m, 3 * c, pitch=True),
        }
        if cfg.window_size in TILED_WINDOWS:
            # the relative-position table kernels (c) and (f) read, and its
            # [nh, N, N] gather for (g), the plain versions and the library
            blk["attn_table"] = randn(nh, (2 * cfg.window_size - 1) ** 2,
                                      std=0.5, dtype=torch.float32)
            blk["attn_bias"] = full_bias(blk["attn_table"], cfg.window_size)
        else:
            blk["attn_bias"] = randn(nh, n, n, std=0.5, dtype=torch.float32)
        blk["ctx"] = blk["act"]
        blk["dqkv"] = pitched(m, 3 * c, device=dev)
        blk["dqkv"].copy_(blk["qkv"])
        blk["dctx"] = pitched(m, c, device=dev)
        blk["dctx"].copy_(blk["act"])
        for name, (n_out, n_in) in {"wqkv": (3 * c, c), "wproj": (c, c),
                                    "w1": (f, c), "w2": (c, f),
                                    "wadj": (a, c)}.items():
            blk[name] = randn(n_out, n_in, std=0.05, pitch=True)
            blk["b" + name[1:]] = randn(n_out, std=0.05, dtype=torch.float32)
        blocks.append(blk)
    # the shift masks (at 16x16 windows (c) and (f) read their region
    # labels, attn_operands)
    masks = shift_masks(cfg.img_size, cfg.img_size, cfg.window_size,
                        tuple(g["shifts"]), torch.device(dev))
    return cat, blocks, masks


def gemm_cases(cfg, cat, blk, k):
    """(label, a, w, bias, epilogue, residual) of block k's five products."""
    c, d = blk["c"], cfg.embed_dim
    cases = [
        ("qkv", blk["act"], blk["wqkv"], blk["bqkv"], "none", None),
        ("proj", blk["ctx"], blk["wproj"], blk["bproj"], "residual", cat[:, :c]),
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


def print_plans(cfg, report):
    """The launch plans of kernels (c), (g), (f) and (e) at the five
    blocks of ``cfg`` (kernels/window_attention.py,
    kernels/fused_swin_block.py, kernels/window_attention_bwd.py,
    kernels/rdg_layernorm_bwd.py): blocks, threads, shared memory, (g)'s
    ring stages, weight tiles a block and (at 16x16 windows) cluster size
    and the clusters the card holds at once, (f)'s windows a block and
    d(bias) partials, (e)'s grid."""
    g = rdg_geometry(cfg)
    side = cfg.img_size
    m = BATCH * side * side
    sms = _build.sm_count(torch.device(DEVICE))
    plans = {}
    for k in range(5):
        c, f, nh = g["feats"][k], g["hidden"][k], g["heads"][k]
        win = cfg.window_size
        pa = window_attention_plan(c, nh, BATCH, side, side, window=win)
        pg = swin_block_plan(c, f, nh, BATCH, side, side, window=win)
        if win == 16:           # clusters of 4 blocks the card holds at once
            pg = {**pg, "clusters_at_once": swin_block16_clusters(c, f, nh)}
        pf = window_attention_bwd_plan(c, nh, BATCH, side, side, sms, win)
        pe = rdg_layernorm_bwd_plan(m, c, sms)
        say("plan", f"b{k + 1} c={c} heads={nh}: window_attention {pa}; "
                    f"swin_block {pg}")
        say("plan", f"b{k + 1} c={c} heads={nh}: window_attention_bwd {pf}; "
                    f"rdg_layernorm_bwd {pe}")
        plans[f"b{k + 1}"] = {"window_attention": pa, "swin_block": pg,
                              "window_attention_bwd": pf,
                              "rdg_layernorm_bwd": pe}
    report["plans"] = plans


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
    # every product at M = B * L rows, then blocks 1 and 5 again at an M that
    # is not a multiple of the 128-row tile (the last tile's rows past M load
    # as zeros and are not stored)
    for rows in (m, m - 40):
        tag = "" if rows == m else " (ragged M)"
        for k, blk in enumerate(blocks):
            if rows != m and k not in (0, 4):
                continue
            for label, a, wt, bias, epi, res in gemm_cases(cfg, cat, blk, k):
                a, res = a[:rows], None if res is None else res[:rows]
                want = rdg_gemm_plain(a.float(), wt.float(), bias, epi,
                                      None if res is None else res.float())
                if label == "adjust":
                    # adjust 1-4 straight into the concat columns at the
                    # buffer's stride; adjust 5 in place over the RDG input
                    # (out aliases residual)
                    dst = cat.clone()[:rows]
                    out = dst[:, blk["c"]:blk["c"] + cfg.gc] if k < 4 \
                        else dst[:, :cfg.embed_dim]
                    res = None if k < 4 else out
                else:
                    out = torch.empty(rows, wt.shape[0], dtype=torch.bfloat16,
                                      device=dev)
                rdg_gemm(a, wt, bias, out, epi, res)
                check("rdg_gemm", f"b{k + 1} {label} {rows}x{wt.shape[0]}x"
                      f"{wt.shape[1]} {epi}{tag}", out, want, GEMM_ATOL)
    # the training forward's epilogues: proj and fc2 scale the branch by a
    # per-sample multiplier, a strided [B] column of a drop-path tensor of
    # zeros and 1/keep (every column holds zeros); fc1 also writes its
    # pre-activation into aux
    dp = torch.full((BATCH, 10), 1.0 / 0.9, device=dev)
    dp[1, 0::2] = dp[BATCH - 1, 1::2] = dp[BATCH // 2] = 0.0
    for k, blk in enumerate(blocks):
        c, f = blk["c"], blk["f"]
        for label, a, wt, bias, res, col in (
                ("proj", blk["ctx"], blk["wproj"], blk["bproj"], cat[:, :c],
                 2 * k),
                ("fc2", blk["hid"], blk["w2"], blk["b2"], blk["x1"],
                 2 * k + 1)):
            out = torch.empty(m, c, dtype=torch.bfloat16, device=dev)
            rdg_gemm(a, wt, bias, out, "drop_residual", res,
                     row_scale=dp[:, col])
            want = rdg_gemm_plain(a.float(), wt.float(), bias,
                                  "drop_residual", res.float(), dp[:, col])
            check("rdg_gemm", f"b{k + 1} {label} {m}x{c}x{wt.shape[1]} "
                  f"drop_residual", out, want, GEMM_ATOL)
        out = torch.empty(m, f, dtype=torch.bfloat16, device=dev)
        aux = torch.empty_like(out)
        rdg_gemm(blk["act"], blk["w1"], blk["b1"], out, "gelu_aux", aux=aux)
        for name, got, epi in (("out", out, "gelu_aux"), ("aux", aux, "none")):
            check("rdg_gemm", f"b{k + 1} fc1 {m}x{f}x{c} gelu_aux {name}",
                  got, rdg_gemm_plain(blk["act"].float(), blk["w1"].float(),
                                      blk["b1"], epi), GEMM_ATOL)
    # every block at both shifts, then block 2 on the first 5 images (an
    # odd batch: a grid that is no multiple of the batch of 16)
    for k, blk in enumerate(blocks):
        c, nh = blk["c"], blk["nh"]
        atol = 2.0 ** -8 * blk["qkv"][:, 2 * c:].float().abs().max().item()
        half = cfg.window_size // 2
        for shift, rows in [(0, m), (half, m)] + ([(half, 5 * h * w)]
                                                  if k == 1 else []):
            mask = masks.get(shift)
            kbias, kmask = attn_operands(blk, masks, h, w, shift,
                                         cfg.window_size)
            qkv = blk["qkv"][:rows]
            out = pitched(rows, c, device=dev)
            # at 16x16 windows also the softmax statistics the training
            # backward's recompute asks for
            stats = softmax_stats(qkv, h, w, nh, cfg.window_size)
            want_st = None if stats is None else torch.empty_like(stats)
            window_attention(qkv, out, kbias, kmask, h, w, nh,
                             cfg.window_size, shift, stats)
            want = window_attention_plain(qkv.float(), blk["attn_bias"],
                                          mask, h, w, nh, cfg.window_size,
                                          shift, want_st)
            label = (f"b{k + 1} c={c} heads={nh} hd={c // nh} shift={shift}"
                     + ("" if rows == m else f" B={rows // (h * w)}"))
            check("window_attention", label, out, want, atol)
            if stats is not None:
                check("window_attention", f"{label} stats max",
                      stats[..., 0], want_st[..., 0], STATS_TOL, STATS_TOL)
                check("window_attention", f"{label} stats 1/sum",
                      stats[..., 1], want_st[..., 1], 0.0, STATS_TOL)


def swin_case(blk):
    """The packed block dict of kernel (g) from one block's case inputs
    (the matrices in 16-byte rows, as block mode hands them to (g))."""
    return {
        "ln1_w": blk["ln_w"], "ln1_b": blk["ln_b"], "wqkv": blk["wqkv"],
        "bqkv": blk["bqkv"], "attn_bias": blk["attn_bias"],
        "wproj": blk["wproj"], "bproj": blk["bproj"], "ln2_w": blk["ln_w"],
        "ln2_b": blk["ln_b"], "w1": blk["w1"], "b1": blk["b1"],
        "w2": blk["w2"], "b2": blk["b2"],
        **({"attn_table": blk["attn_table"]} if "attn_table" in blk else {})}


def phase_swin_block(cfg, dev, check: Checker):
    """Kernel (g) at the five block shapes of ``cfg`` against its plain f32
    version and against the (a)-(c) composition on the same inputs; at
    16x16 windows also two launches bitwise equal, and each block at batch 5
    on 32 x 32 tokens (4 windows an image: 20 clusters, a grid short of
    the card's SMs)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    cat, blocks, masks = make_case_inputs(cfg, dev, gen)
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    work = rdg_workspace(m, cfg, torch.bfloat16, dev)
    for k, blk in enumerate(blocks):
        c, nh, f = blk["c"], blk["nh"], blk["f"]
        p, x = swin_case(blk), cat[:, :c]
        out = torch.empty(m, c, dtype=torch.bfloat16, device=dev)
        fused_swin_block(x, p, masks, cfg, h, w, k, out)
        want = fused_swin_block_plain(x, p, masks, cfg, h, w, k)
        case = f"b{k + 1} c={c} heads={nh} hd={c // nh} f={f} " \
               f"shift={blk['shift']}"
        check("swin_block", case, out, want, SWIN_ATOL)
        comp = swin_block_forward(x, p, block_buffers(work, m, c, f),
                                  masks, cfg, h, w, k)
        check("swin_block vs (a)-(c)", case, out, comp.float(),
              2 * SWIN_ATOL, 2 * RTOL)
        say("kernels", f"{'':20s} (a)-(c) composition vs plain max_abs "
                       f"{(comp.float() - want).abs().max().item():.3e}")
        if cfg.window_size == 16:
            again = torch.empty_like(out)
            fused_swin_block(x, p, masks, cfg, h, w, k, again)
            if not torch.equal(out, again):
                raise AssertionError(f"swin_block {case}: two launches differ")
    if cfg.window_size != 16:
        return
    side = 32
    rows = 5 * side * side
    masks_s = {s: torch.as_tensor(shift_attn_mask(side, side, 16, s),
                                  device=dev) for s in masks}
    for k, blk in enumerate(blocks):
        c, p, x = blk["c"], swin_case(blk), cat[:rows, :blk["c"]]
        out = torch.empty(rows, c, dtype=torch.bfloat16, device=dev)
        fused_swin_block(x, p, masks_s, cfg, side, side, k, out)
        check("swin_block", f"b{k + 1} c={c} shift={blk['shift']} B=5 on "
              f"{side}x{side}", out,
              fused_swin_block_plain(x, p, masks_s, cfg, side, side, k),
              SWIN_ATOL)


def synthetic_split(rng, n_good, n_bad, hr_px=None, scale=None):
    """uint8 RGB HR [N, hr_px, hr_px, 3] (default HR) and LR at 1 / scale
    (default SCALE). The LR is block averaging, a stand-in for the
    reference's Lanczos prep, which waits for the data slice of the port."""
    hr_px, scale = hr_px or HR, scale or SCALE
    good = [grid_texture(rng, hr_px) for _ in range(n_good)]
    kinds = ("blob", "scratch")
    bad = [inject_defect(rng, grid_texture(rng, hr_px), kinds[i % 2])
           for i in range(n_bad)]
    hr = np.stack(good + bad)
    s = hr_px // scale
    lr = hr.reshape(hr.shape[0], s, scale, s, scale, 3) \
        .astype(np.float64).mean(axis=(2, 4)).round().astype(np.uint8)
    return lr, hr


def to_float(imgs_u8, n_colors, rgb_range):
    return np.stack([set_channel(im, n_colors) for im in imgs_u8]) \
        * (rgb_range / 255.0)


def seeded_params(cfg, dev):
    """The model's seeded init plus a seeded N(0, 0.02) on every leaf, as
    the CPU parity tests do, so biases, LayerNorm affines and the bias
    tables are not trivial and the attention is not near uniform."""
    params, _ = init_sr_params(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    gen = torch.Generator().manual_seed(SEED + 2)
    return {k: v + 0.02 * torch.randn(v.shape, generator=gen).to(dev)
            for k, v in params.items()}


def check_forwards(packed, cfg, x, model, report, phase):
    """Both serving modes' forwards of ``packed`` on ``x``, kernels (bf16)
    against the eager f32 ``model`` (TF32 off) RDG by RDG within PERF.md
    section 2's limits, and block mode against rdg mode."""
    with torch.no_grad():
        taps_p = []
        sr_p = model(x, taps=taps_p)
        outs = {}
        for mode in ("rdg", "block"):
            taps_k = []
            sr_k = fused_drct_apply(packed, cfg, x, taps=taps_k, mode=mode)
            outs[mode] = (sr_k, taps_k)
            tok, inc, sr_err = stream_errors(taps_k, sr_k, taps_p, sr_p)
            say(phase, f"{mode} mode, kernels (bf16) vs eager f32 model, "
                       "relative L2 of the token stream after each RDG: "
                       + " ".join(f"{e:.2e}" for e in tok))
            say(phase, "... of each RDG's increment (RDGs 2-12): "
                       + " ".join(f"{e:.2e}" for e in inc))
            say(phase, f"... of the float SR [{tuple(sr_k.shape)}]: "
                       f"{sr_err:.3e}")
            if max(tok) > TOKENS_REL_L2 or max(inc) > INCREMENT_REL_L2 \
                    or sr_err > SR_REL_L2 or not torch.isfinite(sr_k).all():
                raise AssertionError(
                    f"{mode} forward vs plain: tokens {max(tok):.3e} > "
                    f"{TOKENS_REL_L2} or increments {max(inc):.3e} > "
                    f"{INCREMENT_REL_L2} or SR {sr_err:.3e} > {SR_REL_L2}")
            key = "" if mode == "rdg" else "_block"
            report["rel_l2_tokens" + key] = tok
            report["rel_l2_increments" + key] = inc
            report["rel_l2_sr" + key] = sr_err
        (sr_r, taps_r), (sr_b, taps_b) = outs["rdg"], outs["block"]
        between = {"tokens": max(rel_l2(b, r) for b, r in zip(taps_b, taps_r)),
                   "sr": rel_l2(sr_b, sr_r)}
    say(phase, f"block mode vs rdg mode, relative L2: token stream at most "
               f"{between['tokens']:.3e}, float SR {between['sr']:.3e}")
    report["rel_l2_block_vs_rdg"] = between


def check_block_server(server_b, lr_u8, hr_u8, scores, n_fwd, report,
                       phase):
    """``server_b``, registered in block mode, scores the requests that rdg
    mode scored as ``scores``: its launches (kernel (g) and the adjust
    products only), GEMM operand paths and finite scores, and the largest
    difference to rdg mode."""
    reset_counts()
    scores_b = server_b.score("grid", lr_u8, hr_u8)
    torch.cuda.synchronize()
    got = counts()
    say(phase, f"AnomalyServer in block mode scored {len(lr_u8)} requests in "
               f"{n_fwd} forwards; launches {got}; largest score difference "
               f"to rdg mode (1-SSIM, MSE, -PSNR) "
               f"{np.abs(scores_b - scores).max(0).tolist()}")
    if got != expected_counts(PER_FORWARD_BLOCK, n_fwd):
        raise AssertionError(f"block mode launches {got}, expected "
                             f"{PER_FORWARD_BLOCK} x {n_fwd}")
    check_operand_paths("serving_block", got, report)
    if scores_b.shape != scores.shape or not np.isfinite(scores_b).all():
        raise AssertionError(f"block mode scores {scores_b.shape} not finite")
    report["main_path_launches_block"] = got
    report["score_diff_block_vs_rdg"] = np.abs(scores_b - scores).max(0) \
        .tolist()


def phase_main(exp, dev, report):
    cfg = exp.model
    params = seeded_params(cfg, dev)
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
    server.register("grid", exp, params, mode="rdg")

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
    check_operand_paths("serving", got, report)
    if scores.shape != (len(lr_u8), 3) or not np.isfinite(scores).all():
        raise AssertionError(f"scores {scores.shape} not finite")
    say("main", "scores (1-SSIM, MSE, -PSNR) mean good "
                f"{scores[:16].mean(0).round(5).tolist()} bad "
                f"{scores[16:32].mean(0).round(5).tolist()}")
    report["main_path_launches"] = got
    report["main_path_forwards"] = n_fwd

    # the same forward, kernels vs the eager f32 model (TF32 off), per RDG
    packed = prepack_drct(params, cfg, cfg.img_size, cfg.img_size,
                          dtype=torch.bfloat16, device=dev, mode="rdg")
    x = torch.as_tensor(to_float(lr_u8[:BATCH], cfg.in_chans,
                                 exp.data.rgb_range), device=dev)
    model = make_model(cfg, device=dev)
    model.load_state_dict(params)
    check_forwards(packed, cfg, x, model, report, "main")

    # the block serving mode through the entry point a user calls
    server_b = AnomalyServer(batch_size=BATCH, ssim_window=11, device=dev)
    server_b.register("grid", exp, params, mode="block")
    check_block_server(server_b, lr_u8, hr_u8, scores, n_fwd, report, "main")

    # the array core of evaluate_anomaly over the same synthetic test split
    rgb = exp.data.rgb_range
    lr_f = to_float(lr_u8, cfg.in_chans, rgb)
    hr_f = to_float(hr_u8, cfg.in_chans, rgb)
    good = list(range(16)) + list(range(32, 37))
    bad = list(range(16, 32))
    reset_counts()
    res = evaluate_anomaly_arrays(exp, params, lr_f[good], hr_f[good],
                                  lr_f[bad], hr_f[bad], batch=BATCH,
                                  device=dev, log=lambda s: say("main", s),
                                  mode="rdg")
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


def phase_serving(exp, dev, report, n_good=16, n_bad=16, tail=5):
    """Window-16 serving: ``exp``'s model (random weights from a seed, bf16)
    registered with ``AnomalyServer`` scores ``n_good`` good and ``n_bad``
    defective synthetic grid images and a tail, in rdg mode and in block mode
    (``ADSR_TPU_RDG=0`` at registration: kernel (g) at 16x16 windows), with
    the launch counters checked; both forwards RDG by RDG against the eager
    f32 model (PERF.md section 2's limits), and block mode against rdg
    mode."""
    cfg = exp.model
    hr_px, scale = exp.data.resolution, cfg.upscale
    params = seeded_params(cfg, dev)
    n_params = sum(v.numel() for v in params.values())
    say("serving", f"DRCT x{scale} @{hr_px}px: LR {cfg.img_size}x"
                   f"{cfg.img_size}, window {cfg.window_size}, embed "
                   f"{cfg.embed_dim}, {cfg.num_layers} RDGs, {n_params} "
                   f"params ({n_params / 1e6:.2f}M), {exp.precision}")
    if not PARAMS_RANGE[0] < n_params < PARAMS_RANGE[1]:
        raise AssertionError(f"param count {n_params}, expected ~27.6M")
    rng = np.random.RandomState(SEED + 20)
    lr_u8, hr_u8 = synthetic_split(rng, n_good + tail, n_bad, hr_px, scale)
    order = list(range(n_good)) + list(range(n_good + tail, len(lr_u8))) \
        + list(range(n_good, n_good + tail))
    lr_u8, hr_u8 = lr_u8[order], hr_u8[order]      # good, bad, tail
    server = AnomalyServer(batch_size=BATCH, ssim_window=11, device=dev)
    server.register("grid", exp, params, mode="rdg")
    reset_counts()
    t0 = time.perf_counter()
    scores = server.score("grid", lr_u8, hr_u8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    n_fwd = math.ceil(len(lr_u8) / BATCH)
    say("serving", f"AnomalyServer scored {len(lr_u8)} requests of {hr_px} "
                   f"px in {n_fwd} forwards ({wall * 1e3:.1f} ms wall, first "
                   f"call); launches {got}")
    if got != expected_counts(PER_FORWARD, n_fwd):
        raise AssertionError(f"serving launches {got}, expected "
                             f"{PER_FORWARD} x {n_fwd}")
    check_operand_paths("serving", got, report)
    if scores.shape != (len(lr_u8), 3) or not np.isfinite(scores).all():
        raise AssertionError(f"scores {scores.shape} not finite")
    say("serving", "scores (1-SSIM, MSE, -PSNR) mean good "
                   f"{scores[:n_good].mean(0).round(5).tolist()} bad "
                   f"{scores[n_good:n_good + n_bad].mean(0).round(5).tolist()}")
    report["main_path_launches"] = got
    report["main_path_forwards"] = n_fwd
    report["params"] = n_params

    # block mode as a user selects it: ADSR_TPU_RDG=0 at registration
    os.environ["ADSR_TPU_RDG"] = "0"
    server_b = AnomalyServer(batch_size=BATCH, ssim_window=11, device=dev)
    server_b.register("grid", exp, params)
    os.environ.pop("ADSR_TPU_RDG")
    check_block_server(server_b, lr_u8, hr_u8, scores, n_fwd, report,
                       "serving")
    del server_b

    # both forwards, kernels vs the eager f32 model (TF32 off), per RDG
    packed = prepack_drct(params, cfg, cfg.img_size, cfg.img_size,
                          dtype=torch.bfloat16, device=dev, mode="rdg")
    x = torch.as_tensor(to_float(lr_u8[:BATCH], cfg.in_chans,
                                 exp.data.rgb_range), device=dev)
    model = make_model(cfg, device=dev)
    model.load_state_dict(params)
    check_forwards(packed, cfg, x, model, report, "serving")
    return params, packed, x, model, server, lr_u8, hr_u8


def phase_x8(dev, report, steps=4):
    """512 px at x8 (LR 64 x 64: the window-16 token geometry, three pixel
    shuffles in the tail): ``AnomalyServer`` scores one batch in each mode,
    each forward against the eager f32 model, then ``steps`` train steps at
    batch 16."""
    exp = drct_experiment("grid", 512, 8, precision="bf16",
                          batch_size=BATCH, run_tag="chip_smoke_x8")
    cfg = exp.model
    _, packed, x, model, server, lr_u8, hr_u8 = phase_serving(
        exp, dev, report, n_good=BATCH // 2, n_bad=BATCH // 2, tail=0)
    serving = report["main_path_launches"]
    serving_block = report["main_path_launches_block"]
    del model, server, packed
    bundle = make_train_step(exp, dev)
    state = bundle.init_state(torch.Generator().manual_seed(SEED + 21))
    lr = torch.as_tensor(to_float(lr_u8, 1, 255.0), dtype=torch.float32,
                         device=dev)
    hr = torch.as_tensor(to_float(hr_u8, 1, 255.0), dtype=torch.float32,
                         device=dev)
    gen = torch.Generator().manual_seed(SEED + 22)
    losses = []
    reset_counts()
    for _ in range(steps):
        state, metrics = bundle.step(state, [lr], hr, exp.optim.lr, gen)
        losses.append(float(metrics["total"]))
    torch.cuda.synchronize()
    got = counts()
    say("x8", f"{steps} train steps at batch {BATCH} (HR {hr.shape[1]} px, "
              f"x{cfg.upscale}): L1 " + " ".join(f"{v:.4f}" for v in losses)
        + f"; launches {got}")
    if not all(math.isfinite(v) for v in losses) \
            or got != expected_counts(PER_TRAIN_STEP_W16, steps):
        raise AssertionError(f"x8 train: losses {losses}, launches {got}")
    check_operand_paths("train_x8", got, report, W16_BWD_LAUNCHES)
    report["train_x8"] = {"losses": losses, "launches": got}
    return {"serving_x8": serving, "serving_block_x8": serving_block,
            "train_x8": got}


def stream_errors(taps_k, sr_k, taps_p, sr_p):
    """Relative L2 of the token stream after each RDG, of each RDG's
    increment (RDGs 2..), and of the float SR, kernels against the plain
    model."""
    tok, inc = [], []
    for i, (tk, tp) in enumerate(zip(taps_k, taps_p)):
        tok.append(rel_l2(tk, tp))
        if i:
            inc.append(rel_l2(tk.float() - taps_k[i - 1].float(),
                              tp - taps_p[i - 1]))
    return tok, inc, rel_l2(sr_k, sr_p)


def attn_operand_bytes(blk, cfg, masks) -> int:
    """Bytes of the bias and shift mask kernels (c) and (f) read
    (``attn_operands``): the relative-position table and the region labels
    at 16x16 windows, [nh, N, N] and [nW, N, N] at 8x8 (no mask at shift
    0)."""
    return sum(t.numel() * t.element_size()
               for t in attn_operands(blk, masks, cfg.img_size, cfg.img_size,
                                      blk["shift"], cfg.window_size)
               if t is not None)


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
        at_b += m * 3 * c * 2 + m * c * 2 + attn_operand_bytes(blk, cfg, masks)
        at_tc += 4 * m * n * c
        at_f32 += 6 * (m // n) * nh * n * n       # scale, bias, mask, exp, sum, div
    out = {}
    for name, byt, ops, t_ops in (
            ("rdg_layernorm", ln_b, ln_ops, ln_ops / F32_FLOPS),
            ("rdg_gemm", mm_b, mm_ops, mm_ops / BF16_TC_FLOPS),
            ("window_attention", at_b, at_tc + at_f32, at_tc / BF16_TC_FLOPS
             + at_f32 / F32_FLOPS)):
        t_b = byt / HBM_BYTES_PER_S
        out[name] = (max(t_b, t_ops) * 1e3,
                     "bytes" if t_b >= t_ops else "operations", byt, ops)
    return out


def achieved(kernel_ms: float, bound) -> str:
    """The bound's bytes and operations over the measured time."""
    return (f"achieved {bound[2] / kernel_ms / 1e9:.3f} TB/s, "
            f"{bound[3] / kernel_ms / 1e9:.1f} TFLOP/s")


def profile_forward(packed, cfg, x, reps: int = 3, mode: str = "rdg"):
    """(wall ms per forward, {kernel family: device ms per forward}) from
    torch.profiler's CUDA activity; families not of this port are 'other'
    (the head/tail convolutions, LayerNorms, copies)."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        fused_drct_apply(packed, cfg, x, mode=mode)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(reps):
                fused_drct_apply(packed, cfg, x, mode=mode)
            end.record()
            torch.cuda.synchronize()
    families = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            # window_attention16_kernel: (c) at 16x16 windows
            fam = next((k for k in KERNELS + BLOCK_KERNELS
                        if k + "_kernel" in ev.key or k + "16_" in ev.key),
                       "other")
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
    scratch = torch.empty(m * row_pitch(3 * max(g["feats"])),
                          dtype=torch.bfloat16, device=dev)

    def rows(n_cols):           # 16-byte rows, as the main path's buffers
        return scratch.as_strided((m, n_cols), (row_pitch(n_cols), 1))

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
            else:               # "stats": as the training recompute calls it
                window_attention(blk["qkv"], rows(c),
                                 *attn_operands(blk, masks, h, w, shift,
                                                cfg.window_size),
                                 h, w, nh, cfg.window_size, shift,
                                 attn_stats[k] if mode == "stats" else None)

    attn_stats = [softmax_stats(blk["qkv"], h, w, blk["nh"], cfg.window_size)
                  for blk in blocks]

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
        timings[name] = (kernel_ms, plain_ms, library_ms) + bounds[name][:2]
        report.setdefault("per_rdg_launched_ms", {})[name] = launched_ms
        report.setdefault("per_rdg_achieved", {})[name] = {
            "tb_per_s": bounds[name][2] / kernel_ms / 1e9,
            "tflop_per_s": bounds[name][3] / kernel_ms / 1e9}
        say("timing", f"{name:16s} one RDG's launches: kernel "
                      f"{kernel_ms:.4f} ms, bound {bounds[name][0]:.4f} ms "
                      f"({bounds[name][1]}; {achieved(kernel_ms, bounds[name])}"
                      f"), plain f32 {plain_ms:.4f} ms, library "
                      f"{library_ms:.4f} ms (device time, CUDA graph); "
                      f"launched from Python {launched_ms:.4f} ms")
    if attn_stats[0] is not None:
        stats_ms = graph_ms(lambda: attn_set("stats"), iters=20)
        report["window_attention_stats_ms"] = stats_ms
        say("timing", f"window_attention one RDG's launches with the softmax "
                      f"statistics (the training recompute's call): "
                      f"{stats_ms:.4f} ms (device time, CUDA graph)")
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

def swin_bound(cfg, blocks, m, masks):
    """Least time (ms) of one RDG's five (g) launches: bytes (x read once,
    the output written once, weights, vectors, bias tables and masks read
    once) over the HBM rate against the products on the tensor cores plus
    the softmax and LayerNorm work on the f32 units."""
    n = cfg.window_size ** 2
    byt = tc = f32 = 0.0
    for blk in blocks:
        c, f, nh = blk["c"], blk["f"], blk["nh"]
        byt += 2 * m * c * 2 + (4 * c * c + 2 * c * f) * 2 \
            + (3 * c + 7 * c + f) * 4 + nh * n * n * 4
        if blk["shift"]:
            byt += masks[blk["shift"]].numel() * 4
        tc += 2 * m * (4 * c * c + 2 * c * f) + 4 * m * n * c
        f32 += 6 * (m // n) * nh * n * n + 2 * 8 * m * c + 8 * m * f
    t_b, t_ops = byt / HBM_BYTES_PER_S, tc / BF16_TC_FLOPS + f32 / F32_FLOPS
    return (max(t_b, t_ops) * 1e3, "bytes" if t_b >= t_ops else "operations",
            byt, tc + f32)


def phase_block_timing(exp, dev, packed, x, report):
    """Kernel (g)'s five launches of one RDG beside its bound, its plain
    version, the same blocks in PyTorch library calls and the (a)-(c)
    composition; the block-mode forward against rdg mode in this call."""
    cfg = exp.model
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    with torch.no_grad():
        rdg_ms = cuda_ms(lambda: fused_drct_apply(packed, cfg, x, mode="rdg"),
                         iters=20, warmup=3)
        block_ms = cuda_ms(lambda: fused_drct_apply(packed, cfg, x,
                                                    mode="block"),
                           iters=20, warmup=3)
        block_graph_ms = graph_ms(lambda: fused_drct_apply(
            packed, cfg, x, mode="block"), iters=20)
        wall, families = profile_forward(packed, cfg, x, mode="block")
    busy = sum(families.values())
    say("timing", f"block mode forward, batch {BATCH}: {block_ms:.3f} ms = "
                  f"{BATCH * 1e3 / block_ms:.1f} img/s ({block_graph_ms:.3f} "
                  f"ms as a CUDA graph); rdg mode in this call {rdg_ms:.3f} "
                  f"ms: block / rdg = {block_ms / rdg_ms:.3f}")
    say("timing", "profiler, block mode, device ms per forward: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(families.items(),
                                          key=lambda kv: -kv[1]))
        + f"; busy {busy:.3f} of {wall:.3f} ms wall (idle share "
          f"{max(0.0, 1 - busy / wall) if busy else float('nan'):.3f})")
    report["block_mode"] = {"forward_ms": block_ms,
                            "forward_img_per_s": BATCH * 1e3 / block_ms,
                            "forward_graph_ms": block_graph_ms,
                            "rdg_forward_ms_same_call": rdg_ms,
                            "profile": {"wall_ms": wall,
                                        "device_ms": families}}

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    cat, blocks, masks = make_case_inputs(cfg, dev, gen)
    cat32 = cat.float()
    ps = [swin_case(blk) for blk in blocks]
    ps32 = [{k: v.float() for k, v in p.items()} for p in ps]
    outs = [torch.empty(m, blk["c"], dtype=torch.bfloat16, device=dev)
            for blk in blocks]
    work = rdg_workspace(m, cfg, torch.bfloat16, dev)
    bf = torch.bfloat16
    lib = []
    nw = (h // cfg.window_size) * (w // cfg.window_size)
    for blk, p in zip(blocks, ps):
        hd = blk["c"] // blk["nh"]
        q, k_, v = (torch.randn(BATCH, nw, blk["nh"], cfg.window_size ** 2,
                                hd, generator=gen, device=dev).to(bf)
                    for _ in range(3))
        term = build_attn_term(blk["attn_bias"], h, w, cfg.window_size,
                               masks.get(blk["shift"])).to(bf).contiguous()
        lib.append((q, k_, v, term, {n: t.to(bf) for n, t in p.items()
                                     if t.dim() == 1}))

    def block_set(mode="kernel"):
        for k, blk in enumerate(blocks):
            c = blk["c"]
            if mode == "plain":
                fused_swin_block_plain(cat32[:, :c], ps32[k], masks, cfg, h,
                                       w, k)
            elif mode == "composition":
                swin_block_forward(cat[:, :c], ps[k],
                                   block_buffers(work, m, c, blk["f"]),
                                   masks, cfg, h, w, k)
            elif mode == "library":
                q, k_, v, term, vec = lib[k]
                p = ps[k]
                ln = F.layer_norm(cat[:, :c], (c,), vec["ln1_w"],
                                  vec["ln1_b"], eps=1e-6)
                F.linear(ln, p["wqkv"], vec["bqkv"])
                F.scaled_dot_product_attention(q, k_, v, attn_mask=term)
                x1 = F.linear(blk["ctx"], p["wproj"], vec["bproj"]) \
                    + cat[:, :c]
                hid = F.gelu(F.linear(F.layer_norm(x1, (c,), vec["ln2_w"],
                                                   vec["ln2_b"], eps=1e-6),
                                      p["w1"], vec["b1"]))
                F.linear(hid, p["w2"], vec["b2"]).add_(x1)
            else:
                fused_swin_block(cat[:, :c], ps[k], masks, cfg, h, w, k,
                                 outs[k])

    kernel_ms = graph_ms(block_set, iters=20)
    plain_ms = graph_ms(lambda: block_set("plain"), iters=5)
    library_ms = graph_ms(lambda: block_set("library"), iters=20)
    composition_ms = graph_ms(lambda: block_set("composition"), iters=20)
    launched_ms = cuda_ms(block_set, iters=20)
    bound = swin_bound(cfg, blocks, m, masks)
    say("timing", f"swin_block       one RDG's launches: kernel "
                  f"{kernel_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
                  f"{achieved(kernel_ms, bound)}), "
                  f"plain f32 {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
                  f"(a)-(c) composition {composition_ms:.4f} ms (device "
                  f"time, CUDA graph); launched from Python "
                  f"{launched_ms:.4f} ms")
    report.setdefault("per_rdg_launched_ms", {})["swin_block"] = launched_ms
    report.setdefault("per_rdg_achieved", {})["swin_block"] = {
        "tb_per_s": bound[2] / kernel_ms / 1e9,
        "tflop_per_s": bound[3] / kernel_ms / 1e9}
    report.setdefault("per_rdg_ms", {})["swin_block"] = {
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "composition_ms": composition_ms, "bound_ms": bound[0],
        "bound_by": bound[1]}
    return {"swin_block": (kernel_ms, plain_ms, library_ms) + bound[:2]}


# --------------------------------------------------------------------------- #
# Training: backward kernels, one RDG, the Trainer, timing
# --------------------------------------------------------------------------- #

def bwd_cases(cfg, cat, dcat, blk, k, extra):
    """Block k's five backward products as (label, dy, w, a, kw, out dtype):
    dgrad ``dy_eff @ w`` into ``out dtype``, wgrad ``dy_eff.T @ a``. The dY
    sources and transforms are those of the training backward
    (kernels/fused_rdg_train.py): adjust reads the f32 concat gradient's
    columns with LeakyReLU' from the saved concat (adjust 5: 0.2 g), fc2 and
    proj the f32 residual-stream gradient with the drop-path multiplier,
    fc1 and qkv bf16 gradients."""
    c, gc, f32, bf = blk["c"], cfg.gc, torch.float32, torch.bfloat16
    m_attn, m_mlp = extra["dp"][:, 2 * k], extra["dp"][:, 2 * k + 1]
    if k < 4:
        adj = ("adjust", dcat[:, c:c + gc], blk["wadj"], blk["act"],
               {"slope_src": cat[:, c:c + gc]}, f32)
    else:
        adj = ("adjust", extra["g"], blk["wadj"], blk["act"], {"alpha": 0.2},
               f32)
    return [adj,
            ("fc2", extra["res"][:, :c], blk["w2"], blk["hid"],
             {"row_scale": m_mlp, "gelu_pre": extra["pre"][:, :blk["f"]]}, bf),
            ("fc1", blk["hid"], blk["w1"], blk["act"], {}, f32),
            ("proj", extra["res"][:, :c], blk["wproj"], blk["ctx"],
             {"row_scale": m_attn}, bf),
            ("qkv", blk["dqkv"], blk["wqkv"], blk["act"], {}, f32)]


def make_bwd_extra(cfg, dev, gen, cat):
    g_, m = flagship_shapes(cfg)
    dp = torch.ones(BATCH, 10, device=dev)
    dp[1, :4] = dp[-1, 6:] = 0.0
    cmax, fmax = max(g_["feats"]), max(g_["hidden"])
    return {
        "dcat": torch.randn(m, cat.shape[1], generator=gen, device=dev),
        "g": torch.randn(m, cfg.embed_dim, generator=gen, device=dev)
        .to(torch.bfloat16),
        "res": torch.randn(m, cmax, generator=gen, device=dev),
        "pre": torch.randn(m, fmax, generator=gen, device=dev)
        .to(torch.bfloat16),
        "dp": dp / 0.9,
    }


def bwd_case(check, label, dy, wt, a, kw, odt, tag=""):
    """One product's backward as the training backward runs it, through
    ``rdg_gemm_grads`` (dgrad and wgrad of one dY, one pre-pass), against
    the plain versions; twice, bitwise equal."""
    m, f32 = dy.shape[0], torch.float32
    eff = gbwd.dy_effective(dy, kw.get("alpha", 1.0), kw.get("slope_src"),
                            kw.get("row_scale"))
    runs = []
    for _ in range(2):
        got = (torch.empty(m, wt.shape[1], dtype=odt, device=dy.device),
               torch.empty(wt.shape, dtype=f32, device=dy.device),
               torch.empty(wt.shape[0], dtype=f32, device=dy.device))
        gbwd.rdg_gemm_grads(dy, wt, a, *got, **kw)
        runs.append(got)
    (out, dw, db), again = runs
    want = gbwd.rdg_gemm_dgrad_plain(dy, wt, **kw)
    bound = eff.abs() @ wt.float().abs()
    if "gelu_pre" in kw:
        bound = bound * gbwd.gelu_grad(kw["gelu_pre"]).abs()
    check("rdg_gemm_bwd", f"{label} dgrad {m}x{wt.shape[0]}->{wt.shape[1]} "
          f"{str(odt)[6:]}{tag}", out, want,
          2.0 ** -8 * (bound + want.abs()) + 1e-6, 0.0, "bwd")
    want_w, want_b = gbwd.rdg_gemm_wgrad_plain(
        dy, a, **{key: v for key, v in kw.items() if key != "gelu_pre"})
    check("rdg_gemm_bwd", f"{label} wgrad dW {tuple(wt.shape)}{tag}", dw,
          want_w, 2.0 ** -8 * (eff.abs().t() @ a.float().abs()) + 1e-5, 0.0,
          "bwd")
    check("rdg_gemm_bwd", f"{label} wgrad db{tag}", db, want_b,
          1e-5 * eff.abs().sum(0) + 1e-5, 0.0, "bwd")
    if not all(torch.equal(x, y) for x, y in zip(again, (out, dw, db))):
        raise AssertionError(f"{label}{tag}: a second rdg_gemm_grads call "
                             "differs")


def phase_bwd_kernels(cfg, dev, check: Checker):
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cat, blocks, masks = make_case_inputs(cfg, dev, gen)
    extra = make_bwd_extra(cfg, dev, gen, cat)
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    f32 = torch.float32
    # every product at M = B * L rows, then blocks 1 and 5 again at an M that
    # is not a multiple of the tile (with alpha 1.1 for the drop-path
    # multiplier, whose [B] needs B to divide M); every call runs twice and
    # must repeat itself bitwise
    for rows in (m, m - 40):
        tag = "" if rows == m else " (ragged M)"
        for k, blk in enumerate(blocks):
            if rows != m and k not in (0, 4):
                continue
            for label, dy, wt, a, kw, odt in bwd_cases(cfg, cat, extra["dcat"],
                                                       blk, k, extra):
                if rows != m:
                    dy, a = dy[:rows], a[:rows]
                    kw = {key: (v[:rows] if key in ("slope_src", "gelu_pre")
                                else v) for key, v in kw.items()
                          if key != "row_scale"} | (
                        {"alpha": 1.1} if "row_scale" in kw else {})
                bwd_case(check, f"b{k + 1} {label}", dy, wt, a, kw, odt, tag)
    for k, blk in enumerate(blocks):
        c = blk["c"]
        dy = extra["res"][:, :c].contiguous()
        for label, x, residual in (("ln1 into dcat[:, :c]", cat[:, :c],
                                    extra["res"][:, :c]),
                                   ("ln2 into the stream grad", blk["x1"],
                                    None)):
            runs = []
            for _ in range(2):           # twice: bitwise equal
                acc = extra["dcat"].clone()
                dw = torch.empty(c, dtype=f32, device=dev)
                db = torch.empty(c, dtype=f32, device=dev)
                rdg_layernorm_bwd(x, dy, blk["ln_w"], acc[:, :c], dw, db,
                                  residual=residual)
                runs.append((acc, dw, db))
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"rdg_layernorm_bwd b{k + 1} {label}: a "
                                     "second call differs")
            acc, dw, db = runs[0]
            dx = acc[:, :c]
            gx, gw, gb = rdg_layernorm_bwd_plain(x, dy, blk["ln_w"])
            want = extra["dcat"][:, :c] + gx + \
                (0.0 if residual is None else residual)
            for name, got, ref in (("dx", dx, want), ("dgamma", dw, gw),
                                   ("dbeta", db, gb)):
                check("rdg_layernorm_bwd", f"b{k + 1} c={c} {label} {name}",
                      got, ref, 1e-4 * ref.abs().max().item(), 0.0, "bwd")
            if not torch.equal(acc[:, c:], extra["dcat"][:, c:]):
                raise AssertionError("rdg_layernorm_bwd wrote past column c")
    # every block geometry at both shifts on the main batch, in the
    # training backward's 16-byte rows and the plan's windows a block; then
    # two blocks at batch 5 whose plan ends on a short group: at window 8
    # blocks 1 and 4 on 40 x 40 tokens (125 windows, groups of 2), at
    # window 16 blocks 2 and 5 on 64 x 64 (80 windows, groups of 3); every
    # call twice, bitwise equal
    win = cfg.window_size
    short, half = (5, 40 if win == 8 else 64), win // 2
    short_blocks = (0, 3) if win == 8 else (1, 4)
    short_masks = shift_masks(short[1], short[1], win, (half,),
                              torch.device(dev))
    for k, blk in enumerate(blocks):
        c, nh = blk["c"], blk["nh"]
        cases = [(shift, h, masks) for shift in (0, half)]
        if k in short_blocks and short[0] * short[1] ** 2 <= m:
            cases.append((half, short[1], short_masks))
        for shift, side, mks in cases:
            # the full mask for the plain version, the kernels' own form
            mask = mks.get(shift)
            kbias, kmask = attn_operands(blk, mks, side, side, shift, win)
            rows = m if side == h else short[0] * side * side
            plan = window_attention_bwd_plan(c, nh, rows // side ** 2, side,
                                             side, window=win)
            qkv, dctx = blk["qkv"][:rows], blk["dctx"][:rows]
            # at 16x16 windows (f) reads kernel (c)'s own context and
            # softmax statistics, as the training backward's recompute
            # leaves them
            fwd = ()
            if win in TILED_WINDOWS:
                ctx = pitched(rows, c, device=dev)
                stats = softmax_stats(qkv, side, side, nh, win)
                window_attention(qkv, ctx, kbias, kmask,
                                 side, side, nh, win, shift, stats)
                fwd = (ctx, stats)
            runs = []
            for _ in range(2):
                dqkv = pitched(rows, 3 * c, device=dev)
                dbias = torch.empty(blk["attn_bias"].shape, dtype=f32,
                                    device=dev)
                window_attention_bwd(qkv, dctx, kbias, kmask,
                                     side, side, nh, cfg.window_size, shift,
                                     dqkv, dbias, *fwd)
                runs.append((dqkv, dbias))
            (dqkv, dbias), again = runs
            tag = "" if side == h else (
                f" {side}x{side} B={rows // side ** 2} groups of "
                f"{plan['group']}, last {plan['last_group']}")
            if not (torch.equal(dqkv, again[0])
                    and torch.equal(dbias, again[1])):
                raise AssertionError(f"window_attention_bwd b{k + 1} shift="
                                     f"{shift}{tag}: a second call differs")
            want_q, want_b = window_attention_bwd_plain(
                qkv, dctx, blk["attn_bias"], mask, side, side, nh,
                cfg.window_size, shift)
            for i, part in enumerate("qkv"):
                ref = want_q[:, i * c:(i + 1) * c]
                check("window_attention_bwd", f"b{k + 1} c={c} heads={nh} "
                      f"shift={shift}{tag} d{part}",
                      dqkv[:, i * c:(i + 1) * c], ref,
                      2.0 ** -7 * ref.abs().max().item(), 2.0 ** -7, "bwd")
            check("window_attention_bwd", f"b{k + 1} c={c} shift={shift}"
                  f"{tag} dbias", dbias, want_b,
                  2.0 ** -8 * want_b.abs().max().item(), 0.0, "bwd")
    return cat, blocks, masks, extra


def perturbed_rdg(cfg, dev):
    """RDG 1 of the flagship at full width, seeded init + N(0, 0.02)."""
    win = cfg.window_size
    layer = RDG(cfg.embed_dim, (cfg.img_size, cfg.img_size), cfg.num_heads,
                win, cfg.mlp_ratio, cfg.gc, cfg.qkv_bias)
    init_weights_(layer, torch.Generator().manual_seed(SEED + 4))
    gen = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return layer.to(dev)


def phase_rdg(exp, dev, report):
    cfg = exp.model
    cfg1 = dataclasses.replace(cfg, num_layers=1)
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    layer = perturbed_rdg(cfg, dev)
    params = {f"layers.0.{k}": p for k, p in layer.named_parameters()}
    gen = torch.Generator().manual_seed(SEED + 6)
    x = torch.randn(m, cfg.embed_dim, generator=gen).to(dev)
    gout = torch.randn(m, cfg.embed_dim, generator=gen).to(dev)
    dp = drop_path_mults(torch.Generator().manual_seed(SEED + 7), cfg, BATCH,
                         deterministic=False)[-1].to(dev)
    dp[0, 1] = dp[BATCH // 2, 4] = dp[-1, 9] = 0.0
    runs = []
    for _ in range(2):
        layer.zero_grad(set_to_none=True)
        xk = x.to(torch.bfloat16).requires_grad_(True)
        packed = prepack_rdg_stack(params, cfg1, h, w, torch.bfloat16, dev,
                                   detach=False)
        out = fused_rdg_train(xk, packed["rdgs"][0], packed["masks"], cfg, h,
                              w, dp)
        torch.autograd.backward(out, gout.to(torch.bfloat16))
        torch.cuda.synchronize()
        runs.append((out.detach(), xk.grad.clone(),
                     {k: p.grad.clone() for k, p in params.items()}))
    same = torch.equal(runs[0][0], runs[1][0]) and \
        torch.equal(runs[0][1], runs[1][1]) and \
        all(torch.equal(runs[0][2][k], runs[1][2][k]) for k in params)
    say("rdg", f"two backward passes on the same inputs bitwise equal: {same}")
    if not same:
        raise AssertionError("the backward is not deterministic")
    out, gx, grads = runs[0]
    # the bf16 forward's concat, for adjust 1-4's LeakyReLU signs
    cat = torch.empty(m, g["cat_width"], dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        cat[:, :cfg.embed_dim] = x
        fused_rdg(cat, packed["rdgs"][0], packed["masks"], cfg, h, w,
                  rdg_workspace(m, cfg, torch.bfloat16, dev), dp=dp,
                  out=torch.empty_like(out))
    pre = []
    hooks = [getattr(layer, f"adjust{k + 1}").register_forward_hook(
        lambda mod, inp, y: pre.append(y.detach())) for k in range(4)]
    layer.zero_grad(set_to_none=True)
    xp = x.clone().requires_grad_(True)
    ref = rdg_train_plain(layer, xp, h, w, dp)
    torch.autograd.backward(ref, gout)
    torch.cuda.synchronize()
    for hook in hooks:
        hook.remove()
    flips = []
    for k, y in enumerate(pre):                     # [B, gc, h, w] -> rows
        c = g["feats"][k]
        flips.append(((cat[:, c:c + cfg.gc] > 0)
                      != (y.permute(0, 2, 3, 1).reshape(m, -1) > 0))
                     .float().mean().item())
    readings = {"out": rel_l2(out, ref.detach()), "dx": rel_l2(gx, xp.grad)}
    for k, p in params.items():
        readings[k[len("layers.0."):]] = rel_l2(grads[k], p.grad)
    by_class = {}
    for k, v in readings.items():
        cls = rdg_tensor_class(k)
        if v >= by_class.get(cls, ("", -1.0))[1]:
            by_class[cls] = (k, v)
    say("rdg", f"one RDG, batch {BATCH}, bf16 kernels vs eager f32 autograd, "
               f"relative L2 of {len(readings)} tensors, largest of each "
               "class (limit): " + "; ".join(
                   f"{cls} {k} {v:.3e} ({RDG_REL_L2[cls]})"
                   for cls, (k, v) in by_class.items())
               + f"; median {sorted(readings.values())[len(readings) // 2]:.3e}")
    say("rdg", "share of adjust 1-4 pre-activations whose sign differs "
               "between the bf16 and the f32 forward: "
               + " ".join(f"{s:.3e}" for s in flips))
    report["rdg_rel_l2"] = readings
    report["rdg_leaky_sign_flips"] = flips
    for cls, (k, v) in by_class.items():
        if not v <= RDG_REL_L2[cls]:
            raise AssertionError(f"one RDG vs eager f32: {k} relative L2 "
                                 f"{v:.3e} > {RDG_REL_L2[cls]} ({cls})")


def train_dataset(rng, n, hr_px=None, scale=None):
    lr_u8, hr_u8 = synthetic_split(rng, n, 0, hr_px, scale)
    lr = to_float(lr_u8, 1, 255.0).astype(np.float32)
    hr = to_float(hr_u8, 1, 255.0).astype(np.float32)
    return SRDataset(hr=hr, lrs=[lr], scales_desc=(scale or SCALE,),
                     filenames=[f"{i:03d}" for i in range(n)])


def phase_train(exp, dev, report, per_step_want=None, bwd_launches=1):
    """A Trainer of two short epochs, its test and 20 steps on one batch,
    with the launch counters checked (``per_step_want``: one step's
    launches, default PER_TRAIN_STEP; ``bwd_launches``: kernel (f)'s a
    Swin block backward)."""
    per_step_want = per_step_want or PER_TRAIN_STEP
    hr_px, scale = exp.data.resolution, max(exp.data.scale)
    exp = dataclasses.replace(
        exp, data=dataclasses.replace(exp.data, test_every=2),
        optim=dataclasses.replace(exp.optim, epochs=2), print_every=1)
    rng = np.random.RandomState(SEED + 8)
    train_ds = train_dataset(rng, 32, hr_px, scale)
    test_ds = train_dataset(rng, 8, hr_px, scale)
    trainer = Trainer(exp, train_ds, test_ds, device=dev)
    losses = []
    step = trainer.train_step

    def logged_step(*args):
        state, metrics = step(*args)
        losses.append(float(metrics["total"]))
        return state, metrics

    trainer.train_step = logged_step
    reset_counts()
    t0 = time.perf_counter()
    while not trainer.terminate():
        trainer.train_one_epoch()
    psnr, ssim = trainer.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    n_steps = exp.optim.epochs * exp.data.test_every
    want = expected_counts(per_step_want, n_steps)
    for k, v in PER_FORWARD.items():
        want[k] += v                     # Trainer.test: one forward of 8
    say("train", f"Trainer: {exp.optim.epochs} epochs x "
                 f"{exp.data.test_every} steps of batch {BATCH} + test of "
                 f"{test_ds.n}: {wall:.1f} s wall (first calls); losses "
                 + " ".join(f"{v:.4f}" for v in losses)
                 + f"; test PSNR {psnr:.3f} SSIM {ssim:.4f}; launches {got}")
    if len(losses) != n_steps or not all(math.isfinite(v) for v in losses) \
            or not (math.isfinite(psnr) and math.isfinite(ssim)):
        raise AssertionError(f"train: losses {losses}, test {psnr} {ssim}")
    if got != want:
        raise AssertionError(f"train launches {got}, expected {want}")
    check_operand_paths("train", got, report, bwd_launches)
    report["train_path"] = {"losses": losses, "psnr": psnr, "ssim": ssim,
                            "launches": got, "wall_s": wall}

    # one fixed batch: the loss must fall
    lrs, hr = next(trainer.sampler.epoch(99))
    lr_rate = exp.optim.lr
    fixed = []
    reset_counts()
    for i in range(FIXED_BATCH_STEPS):
        trainer.state, metrics = step(trainer.state, lrs, hr, lr_rate,
                                      trainer.dropout_gen)
        fixed.append(float(metrics["total"]))
        if i == 0:
            torch.cuda.synchronize()
            per_step = counts()
    if per_step != expected_counts(per_step_want, 1):
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{per_step_want}")
    drop = 1.0 - fixed[-1] / fixed[0]
    say("train", f"{FIXED_BATCH_STEPS} steps on one batch at LR {lr_rate}: "
                 f"L1 {fixed[0]:.4f} -> {fixed[-1]:.4f} (drop {drop:.3f}); "
                 f"launches per step {per_step}")
    report["fixed_batch"] = {"losses": fixed, "drop": drop,
                             "launches_per_step": per_step}
    if not all(math.isfinite(v) for v in fixed) or drop <= FIXED_BATCH_MIN_DROP:
        raise AssertionError(f"fixed batch: loss {fixed[0]} -> {fixed[-1]}, "
                             f"drop {drop} <= {FIXED_BATCH_MIN_DROP}")
    return trainer, lrs, hr, got


def bwd_bounds(cfg, cat, dcat, blocks, extra, m, masks):
    """Least time (ms) of one RDG's launches of each backward kernel.
    ``rdg_gemm_bwd`` is one function of dY (dgrad and wgrad together), so
    dY and the LeakyReLU sign source count once."""
    n = cfg.window_size ** 2
    gm_b = gm_ops = ln_b = ln_ops = at_b = at_tc = at_f32 = 0.0
    for k, blk in enumerate(blocks):
        c, nh = blk["c"], blk["nh"]
        for _, dy, wt, a, kw, odt in bwd_cases(cfg, cat, dcat, blk, k,
                                               extra):
            nn_, kk = wt.shape
            dy_b = m * nn_ * dy.element_size()
            src_b = m * nn_ * 2 if "slope_src" in kw else 0
            pre_b = m * kk * 2 if "gelu_pre" in kw else 0
            out_b = m * kk * (4 if odt == torch.float32 else 2)
            gm_b += dy_b + src_b + nn_ * kk * 2 + pre_b + out_b     # dgrad
            gm_b += m * kk * 2 + nn_ * kk * 4 + nn_ * 4             # wgrad
            gm_ops += 2 * (2 * m * nn_ * kk)
        for residual in (True, False):
            ln_b += m * c * (2 + 4 + 2 * 4 + (4 if residual else 0)) + 3 * c * 4
            ln_ops += 12 * m * c
        # what the gradient needs: qkv, dqkv, dO, the bias and mask in,
        # d(bias) [nh, N, N] out (not the forward's context and statistics
        # (f) also reads at 16x16 windows: phase_train_timing reports them)
        at_b += m * 3 * c * 2 * 2 + m * c * 2 + nh * n * n * 4 \
            + attn_operand_bytes(blk, cfg, masks)
        at_tc += 10 * m * n * c
        at_f32 += 10 * (m // n) * nh * n * n
    out = {}
    for name, byt, ops, t_ops in (
            ("rdg_gemm_bwd", gm_b, gm_ops, gm_ops / BF16_TC_FLOPS),
            ("rdg_layernorm_bwd", ln_b, ln_ops, ln_ops / F32_FLOPS),
            ("window_attention_bwd", at_b, at_tc + at_f32,
             at_tc / BF16_TC_FLOPS + at_f32 / F32_FLOPS)):
        t_b = byt / HBM_BYTES_PER_S
        out[name] = (max(t_b, t_ops) * 1e3,
                     "bytes" if t_b >= t_ops else "operations", byt, ops)
    return out


def profile_steps(fn, reps: int = 3):
    """(wall ms per call, {kernel family: device ms per call}) of ``fn``.
    Only device-side events count: a kernel launched inside an autograd
    node (every RDG Function) is also charged to that node's CPU event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fams = {"dgrad_kernel": "rdg_gemm_bwd dgrad",
            "wgrad_kernel": "rdg_gemm_bwd wgrad",
            "dy_prep_kernel": "rdg_gemm_bwd dY prep",
            "sum_partials_kernel": "partial sums (d, e, f)"}
    fams.update({f"{k}_kernel": k for k in KERNELS + BWD_KERNELS[1:]})
    # 16x16 windows: (c)'s kernel and (f)'s two launches
    fams.update({"window_attention16_kernel": "window_attention",
                 "window_attention_bwd16_dq_kernel": "window_attention_bwd dq",
                 "window_attention_bwd16_dkv_kernel":
                     "window_attention_bwd dkv"})
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    families = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            fam = next((v for k, v in fams.items() if k in ev.key), "other")
            families[fam] = families.get(fam, 0.0) + us / 1e3 / reps
    return start.elapsed_time(end) / reps, families


def sdpa_bwd_ms(sdpa, launched, runs: int = 20):
    """(ms, how) of the SDPA backward of one RDG's five attentions, the
    library call beside kernel (f): replayed as a CUDA graph, its forward
    captured first into a graph of its own on the same stream and pool (as
    ``torch.cuda.make_graphed_callables`` does), so that autograd runs the
    backward on the capturing stream; where capture fails, the median of
    ``runs`` launched runs of ``launched``, with their spread."""
    def forward():
        return [F.scaled_dot_product_attention(*ins, attn_mask=term)
                for _, ins, _, term in sdpa]

    def backward(outs):
        for o, (_, ins, do, _) in zip(outs, sdpa):
            torch.autograd.grad(o, ins, do)

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                backward(forward())
        torch.cuda.current_stream().wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        fwd_graph, bwd_graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        # autograd runs the backward on its own thread: capture per thread
        with torch.cuda.graph(fwd_graph, pool=pool,
                              capture_error_mode="thread_local"):
            outs = forward()
        with torch.cuda.graph(bwd_graph, pool=pool,
                              capture_error_mode="thread_local"):
            backward(outs)
        return cuda_ms(bwd_graph.replay, iters=10), "CUDA graph"
    except RuntimeError as err:
        torch.cuda.synchronize()
        times = sorted(cuda_ms(launched, iters=1) for _ in range(runs))
        return times[runs // 2], (
            f"launched, median of {runs} runs (min {times[0]:.4f}, max "
            f"{times[-1]:.4f} ms); graph capture failed: "
            f"{str(err).splitlines()[0][:160]}")


def phase_train_timing(exp, dev, trainer, lrs, hr, bwd_inputs, report,
                       per_step_want=None):
    per_step_want = per_step_want or PER_TRAIN_STEP
    cfg = exp.model
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    state, step = trainer.state, trainer._bundle.step
    gen = trainer.dropout_gen
    lr_rate = exp.optim.lr

    def train_step():
        step(state, lrs, hr, lr_rate, gen)

    params = dict(state.model.named_parameters())
    dp = drop_path_mults(gen, cfg, BATCH, deterministic=False).to(dev)

    def forward_only():
        return F.l1_loss(fused_drct_train_forward(params, cfg, lrs[0], dp), hr)

    def forward_backward():
        forward_only().backward()

    step_ms = cuda_ms(train_step, iters=10, warmup=2)
    fwd_ms = cuda_ms(forward_only, iters=10, warmup=1)
    fb_ms = cuda_ms(forward_backward, iters=10, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    train_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    wall, families = profile_steps(train_step)
    busy = sum(families.values())
    flops = cfg.num_layers * rdg_train_flops(cfg, m)
    packed = prepack_drct(state.model.state_dict(), cfg, h, w,
                          dtype=torch.bfloat16, device=dev)
    head = 3 * head_tail_flops(packed, cfg, BATCH)
    say("train-timing", f"train step, batch {BATCH}: {step_ms:.3f} ms = "
                        f"{BATCH * 1e3 / step_ms:.1f} img/s; training forward "
                        f"+ loss {fwd_ms:.3f} ms, forward + backward "
                        f"{fb_ms:.3f} ms (backward {fb_ms - fwd_ms:.3f} ms); "
                        f"peak device memory {peak / 2 ** 30:.2f} GiB")
    say("train-timing", f"step flops from the shapes: {(flops + head) / 1e9:.1f}"
                        f" GFLOP ({(flops + head) / BATCH / 1e9:.2f} an image,"
                        f" head/tail convs {head / 1e9:.1f}); compute bound "
                        f"{(flops + head) / BF16_TC_FLOPS * 1e3:.3f} ms, "
                        f"achieved {(flops + head) / step_ms / 1e9:.1f} TFLOP/s")
    say("train-timing", "profiler, device ms per step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(families.items(),
                                          key=lambda kv: -kv[1]))
        + f"; busy {busy:.3f} of {wall:.3f} ms wall under the profiler (idle "
          f"share {max(0.0, 1 - busy / wall):.3f})")
    launches = sum(per_step_want.values())
    # one partial-sum pass a wgrad, a LayerNorm backward and an attention
    # backward (half the forward attention launches of a step: the other
    # half are the recompute's)
    partial_passes = sum(per_step_want[k] for k in (
        "rdg_gemm_wgrad", "rdg_layernorm_bwd")) \
        + per_step_want["window_attention"] // 2
    say("train-timing", f"launches per step: {launches} through the wrappers"
                        f" + {partial_passes} partial-sum passes")
    report["train_timing"] = {
        "step_ms": step_ms, "img_per_s": BATCH * 1e3 / step_ms,
        "forward_ms": fwd_ms, "forward_backward_ms": fb_ms,
        "backward_ms": fb_ms - fwd_ms, "peak_bytes": peak,
        "step_gflop": (flops + head) / 1e9, "profile_wall_ms": wall,
        "profile_device_ms": families, "launches_per_step": launches,
        "partial_sum_passes_per_step": partial_passes}

    cat, blocks, masks, extra = bwd_inputs
    dcat = extra["dcat"]
    f32, bf = torch.float32, torch.bfloat16
    cases = [bwd_cases(cfg, cat, dcat, blk, k, extra)
             for k, blk in enumerate(blocks)]
    lib_dy = {id(dy): dy.to(bf).contiguous() for cs in cases
              for _, dy, *_ in cs}
    outs = {(k, i): torch.empty(m, wt.shape[1], dtype=odt, device=dev)
            for k, cs in enumerate(cases)
            for i, (_, _, wt, _, _, odt) in enumerate(cs)}
    grads = {(k, i): (torch.empty(wt.shape, dtype=f32, device=dev),
                      torch.empty(wt.shape[0], dtype=f32, device=dev))
             for k, cs in enumerate(cases)
             for i, (_, _, wt, _, _, _) in enumerate(cs)}

    def gemm_bwd_set(mode="kernel"):
        for k, cs in enumerate(cases):
            for i, (_, dy, wt, a, kw, _) in enumerate(cs):
                if mode == "library":
                    torch.matmul(lib_dy[id(dy)], wt)
                    torch.matmul(lib_dy[id(dy)].t(), a)
                    continue
                if mode == "plain":
                    wkw = {key: v for key, v in kw.items()
                           if key != "gelu_pre"}
                    gbwd.rdg_gemm_dgrad_plain(dy, wt, **kw)
                    gbwd.rdg_gemm_wgrad_plain(dy, a, **wkw)
                else:           # as the training backward calls them
                    gbwd.rdg_gemm_grads(dy, wt, a, outs[k, i], *grads[k, i],
                                        **kw)

    ln_in = []
    for blk in blocks:
        c = blk["c"]
        dy = extra["res"][:, :c].contiguous()
        xs = (cat[:, :c], blk["x1"])
        lib = []
        for x in xs:
            xc = x.contiguous()
            wb, bb = blk["ln_w"].to(bf), blk["ln_b"].to(bf)
            _, mean, rstd = torch.ops.aten.native_layer_norm(xc, [c], wb, bb,
                                                             1e-6)
            lib.append((dy.to(bf), xc, mean, rstd, wb, bb))
        ln_in.append((blk, dy, xs, lib, torch.empty(c, device=dev),
                      torch.empty(c, device=dev)))
    acc = dcat.clone()

    def ln_bwd_set(mode="kernel"):
        for blk, dy, xs, lib, dw, db in ln_in:
            c = blk["c"]
            for j, x in enumerate(xs):
                if mode == "library":
                    torch.ops.aten.native_layer_norm_backward(
                        lib[j][0], lib[j][1], [c], lib[j][2], lib[j][3],
                        lib[j][4], lib[j][5], [True, True, True])
                elif mode == "plain":
                    rdg_layernorm_bwd_plain(x, dy, blk["ln_w"])
                else:
                    rdg_layernorm_bwd(x, dy, blk["ln_w"], acc[:, :c], dw, db,
                                      residual=dy if j == 0 else None)

    nw = (h // cfg.window_size) * (w // cfg.window_size)
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 9)
    sdpa = []
    for blk in blocks:
        hd = blk["c"] // blk["nh"]
        q, k_, v = (torch.randn(BATCH, nw, blk["nh"], cfg.window_size ** 2,
                                hd, generator=gen_t, device=dev)
                    .to(bf).requires_grad_(True) for _ in range(3))
        term = build_attn_term(blk["attn_bias"], h, w, cfg.window_size,
                               masks.get(blk["shift"])).to(bf).contiguous()
        o = torch.nn.functional.scaled_dot_product_attention(q, k_, v,
                                                             attn_mask=term)
        sdpa.append((o, (q, k_, v), torch.randn_like(o), term))
    attn_out = [(pitched(m, 3 * blk["c"], dtype=bf, device=dev),
                 torch.empty(blk["attn_bias"].shape, device=dev))
                for blk in blocks]
    # at 16x16 windows (f) also reads the forward's context and softmax
    # statistics: kernel (c)'s, made once here (the recompute's launch is
    # not (f)'s time)
    attn_fwd = []
    for blk in blocks:
        c, nh, shift = blk["c"], blk["nh"], blk["shift"]
        stats = softmax_stats(blk["qkv"], h, w, nh, cfg.window_size)
        if stats is None:
            attn_fwd.append(())
            continue
        ctx = pitched(m, c, dtype=bf, device=dev)
        window_attention(blk["qkv"], ctx,
                         *attn_operands(blk, masks, h, w, shift,
                                        cfg.window_size),
                         h, w, nh, cfg.window_size, shift, stats)
        attn_fwd.append((ctx, stats))

    def attn_bwd_set(mode="kernel"):
        for k, blk in enumerate(blocks):
            c, nh, shift = blk["c"], blk["nh"], blk["shift"]
            geo = (h, w, nh, cfg.window_size, shift)
            if mode == "library":
                o, ins, do, _ = sdpa[k]
                torch.autograd.grad(o, ins, do, retain_graph=True)
            elif mode == "plain":
                window_attention_bwd_plain(blk["qkv"], blk["dctx"],
                                           blk["attn_bias"], masks.get(shift),
                                           *geo, *attn_fwd[k])
            else:
                window_attention_bwd(blk["qkv"], blk["dctx"],
                                     *attn_operands(blk, masks, h, w, shift,
                                                    cfg.window_size),
                                     *geo, *attn_out[k], *attn_fwd[k])

    bounds = bwd_bounds(cfg, cat, dcat, blocks, extra, m, masks)
    timings = {}
    for name, fn in (("rdg_gemm_bwd", gemm_bwd_set),
                     ("rdg_layernorm_bwd", ln_bwd_set),
                     ("window_attention_bwd", attn_bwd_set)):
        kernel_ms = graph_ms(fn, iters=10)
        plain_ms = graph_ms(lambda: fn("plain"), iters=3)
        library_how = "CUDA graph"
        if name == "window_attention_bwd":
            library_ms, library_how = sdpa_bwd_ms(
                sdpa, lambda: fn("library"))
            report["sdpa_bwd_timing"] = library_how
        else:
            library_ms = graph_ms(lambda: fn("library"), iters=10)
        launched_ms = cuda_ms(fn, iters=10)
        timings[name] = (kernel_ms, plain_ms, library_ms) + bounds[name][:2]
        report.setdefault("per_rdg_launched_ms", {})[name] = launched_ms
        report.setdefault("per_rdg_achieved", {})[name] = {
            "tb_per_s": bounds[name][2] / kernel_ms / 1e9,
            "tflop_per_s": bounds[name][3] / kernel_ms / 1e9}
        say("train-timing", f"{name:20s} one RDG's launches: kernel "
                            f"{kernel_ms:.4f} ms, bound {bounds[name][0]:.4f} "
                            f"ms ({bounds[name][1]}; "
                            f"{achieved(kernel_ms, bounds[name])}), plain f32 "
                            f"{plain_ms:.4f} ms, library {library_ms:.4f} ms "
                            f"(device time, CUDA graph; library: "
                            f"{library_how}); launched from "
                            f"Python {launched_ms:.4f} ms")
    report["per_rdg_bwd_ms"] = {k: {"ms": v[0], "plain_ms": v[1],
                                    "library_ms": v[2], "bound_ms": v[3],
                                    "bound_by": v[4]}
                                for k, v in timings.items()}
    # at 16x16 windows (f) also reads the forward's context and softmax
    # statistics, which its bound leaves out (the gradient does not need
    # them): their bytes and time at the HBM rate, beside the bound
    fwd_bytes = sum(t.numel() * t.element_size()
                    for pair in attn_fwd for t in pair)
    if fwd_bytes:
        fwd_ms = fwd_bytes / HBM_BYTES_PER_S * 1e3
        report["window_attention_bwd_fwd_operands"] = {"bytes": fwd_bytes,
                                                       "ms": fwd_ms}
        say("train-timing", f"window_attention_bwd also reads the forward's "
                            f"context and statistics: {fwd_bytes / 1e6:.1f} "
                            f"MB an RDG, {fwd_ms:.4f} ms at the HBM rate "
                            f"(outside its bound)")
    return timings


# --------------------------------------------------------------------------- #
# The entry points a user runs: the train CLI, then the evaluate CLI
# --------------------------------------------------------------------------- #

CLI_DIR = Path("workspace") / "chip_smoke"
CLI_TRAIN, CLI_VAL, CLI_TEST = 32, 8, 8       # images per split
CLI_TEST_HR = 512                             # LR 128: 25 tiles of 32 px
CLI_BATCH = 8                                 # the evaluate CLI's default


def write_split(base: Path, rng, n: int, hr: int, defect: bool = False):
    """Synthetic grid images with the port's PNG writer: HR and its 4x4
    block-averaged LR (a stand-in for the reference's Lanczos prep)."""
    (base / "HR").mkdir(parents=True)
    (base / "LR_bicubic" / f"X{SCALE}").mkdir(parents=True)
    kinds = ("blob", "scratch")
    for i in range(n):
        img = grid_texture(rng, hr)
        if defect:
            img = inject_defect(rng, img, kinds[i % 2])
        lr = img.reshape(hr // SCALE, SCALE, hr // SCALE, SCALE, 3) \
            .astype(np.float64).mean(axis=(1, 3)).round().astype(np.uint8)
        write_png(base / "HR" / f"{i:03d}.png", img)
        write_png(base / "LR_bicubic" / f"X{SCALE}" / f"{i:03d}x{SCALE}.png",
                  lr)


def phase_cli(exp, dev, report, cli_dir=CLI_DIR, modes=("rdg", "block"),
              per_step_want=None, bwd_launches=1, overlap=8):
    """``cli.main`` trains ``exp``'s model (the flagship by default) for one
    epoch into a run dir, then ``cli.evaluate`` scores 512 px test images
    from it, auto-tiled with ``overlap`` LR px between tiles, in each of
    ``modes`` (rdg mode, and block mode with ``ADSR_TPU_RDG=0``); tiled
    img/s in each mode. ``per_step_want``: one train step's launches
    (default PER_TRAIN_STEP)."""
    per_step_want = per_step_want or PER_TRAIN_STEP
    hr_px = exp.data.resolution
    shutil.rmtree(cli_dir, ignore_errors=True)
    root = cli_dir / "data"
    rng = np.random.RandomState(SEED + 11)
    t0 = time.perf_counter()
    write_split(root / "grid" / "train" / "good", rng, CLI_TRAIN, hr_px)
    write_split(root / "grid" / "val" / "good", rng, CLI_VAL, hr_px)
    write_split(root / "grid" / "test" / "good", rng, CLI_TEST, CLI_TEST_HR)
    write_split(root / "grid" / "test" / "bad", rng, CLI_TEST, CLI_TEST_HR,
                defect=True)
    say("cli", f"data root {root}: {CLI_TRAIN} train + {CLI_VAL} val images "
               f"at {hr_px} px, {CLI_TEST} + {CLI_TEST} test images at "
               f"{CLI_TEST_HR} px, written in {time.perf_counter() - t0:.1f} s")

    os.environ["ADSR_TPU_RDG"] = "1"
    reset_counts()
    t0 = time.perf_counter()
    run_dir = cli_main.main(["--resolution", str(hr_px), "--scale",
                             str(SCALE), "--epochs", "1", "--batch-size",
                             str(BATCH), "--data-root", str(root),
                             "--save-dir", str(cli_dir / "runs"),
                             "--run-tag", "chip"])
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = counts()
    steps = 256 // BATCH                  # the reference's mvtec cadence
    want = expected_counts(per_step_want, steps)
    for k, v in PER_FORWARD.items():      # the val/good test: one forward
        want[k] += v
    say("cli", f"cli.main: {steps} steps at batch {BATCH} and the val/good "
               f"test in {train_wall:.1f} s wall (first calls); launches "
               f"{train_launches}")
    if train_launches != want:
        raise AssertionError(f"train CLI launches {train_launches}, "
                             f"expected {want}")
    check_operand_paths("train_cli", train_launches, report, bwd_launches)
    run = Path(run_dir)
    files = {p.name for p in run.iterdir()}
    model_files = {p.name for p in (run / "model").iterdir()}
    history = json.loads((run / "psnr_ssim_log.json").read_text())
    losses = json.loads((run / "loss_log.json").read_text())
    ckpt = resolve_checkpoint(run_dir)
    need = {"log.txt", "config.txt", "metrics.jsonl", "loss_log.json",
            "psnr_ssim_log.json", "model", "results"}
    if not need <= files or model_files != {
            "model_best.pt", "model_latest.pt", "train_state_latest.pt"} \
            or len(history) != 1 or not ckpt.endswith("model_best.pt") \
            or not all(math.isfinite(v) for v in losses[0].values()):
        raise AssertionError(f"run dir {run}: {sorted(files)}, model "
                             f"{sorted(model_files)}, val tests {history}, "
                             f"checkpoint {ckpt}, losses {losses}")
    say("cli", f"run dir {run.name}: {sorted(files)}; model "
               f"{sorted(model_files)}; epoch loss {losses[0]}; val/good "
               f"PSNR/SSIM {history[0]}; resolve_checkpoint -> "
               f"{Path(ckpt).name}")

    results, walls, launches = {}, {}, {}
    n_fwd = 2 * math.ceil(CLI_TEST / CLI_BATCH)
    for mode in modes:
        flag = "1" if mode == "rdg" else "0"
        os.environ["ADSR_TPU_RDG"] = flag
        reset_counts()
        t0 = time.perf_counter()
        res = cli_eval.main(["--run-dir", run_dir, "--data-root", str(root),
                             "--sweep-windows", "9",
                             "--tile-overlap", str(overlap),
                             "--output-dir", str(cli_dir / f"eval_{mode}")])
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
        launches[mode] = counts()
        per = PER_FORWARD if mode == "rdg" else PER_FORWARD_BLOCK
        aucs = [res["auc_ssim"], res["auc_mse"], res["auc_psnr"]]
        lines = (cli_dir / f"eval_{mode}" / "scores.txt").read_text() \
            .splitlines()
        say("cli", f"cli.evaluate, {mode} mode (ADSR_TPU_RDG={flag}): AUC "
                   f"ssim/mse/psnr {aucs[0]:.4f}/{aucs[1]:.4f}/{aucs[2]:.4f}, "
                   f"best window {res['best_ws']}, specificity "
                   f"{res['specificity']}; {walls[mode]:.1f} s wall; "
                   f"launches {launches[mode]}")
        if launches[mode] != expected_counts(per, n_fwd):
            raise AssertionError(f"evaluate CLI ({mode}) launches "
                                 f"{launches[mode]}, expected {per} x {n_fwd}")
        check_operand_paths(f"evaluate_cli_{mode}", launches[mode], report)
        if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs) \
                or len(lines) != 2 * CLI_TEST \
                or set(res["specificity"]) != {"ssim", "mse", "psnr"} \
                or not res["checkpoint"].endswith("model_best.pt"):
            raise AssertionError(f"evaluate CLI ({mode}): AUCs {aucs}, "
                                 f"{len(lines)} score lines, {res}")
        results[mode] = res
    os.environ.pop("ADSR_TPU_RDG")
    diff = None
    if len(modes) == 2:
        diff = {k: float(np.max(np.abs(np.subtract(results["rdg"][k],
                                                   results["block"][k]))))
                for k in ("scores_ssim", "scores_mse", "scores_psnr")}
        say("cli", f"largest per-image score difference, block vs rdg mode: "
                   f"{diff}")

    # tiled serving of the 512 px test images in both modes
    lr = load_sr_dataset(str(root / "grid" / "test" / "good"), (SCALE,), 1)
    lr = torch.as_tensor(lr.lrs[0], device=dev)
    params = load_state_dict(ckpt, dev)
    tiled = {}
    tile = exp.model.img_size
    n_tiles = len(tile_starts(lr.shape[1], tile, overlap)) \
        * len(tile_starts(lr.shape[2], tile, overlap))
    for mode in modes:
        fwd = make_tiled_serving_forward(exp, params, overlap=overlap,
                                         quantize_out=False, device=dev,
                                         mode=mode)
        ms = cuda_ms(lambda: fwd(lr), iters=3, warmup=1)
        tiled[mode] = {"ms": ms, "img_per_s": lr.shape[0] * 1e3 / ms,
                       "tiles_per_image": n_tiles}
        say("cli", f"tiled serving, {mode} mode: {lr.shape[0]} images of "
                   f"{CLI_TEST_HR} px ({n_tiles} tiles of {tile} LR px each, "
                   f"one forward of {n_tiles * lr.shape[0]} tiles) in "
                   f"{ms:.3f} ms = {tiled[mode]['img_per_s']:.1f} img/s")
    report["cli"] = {"train_wall_s": train_wall,
                     "train_launches": train_launches,
                     "eval_wall_s": walls, "eval_launches": launches,
                     "aucs": {m: [r["auc_ssim"], r["auc_mse"], r["auc_psnr"]]
                              for m, r in results.items()},
                     "specificity": {m: r["specificity"]
                                     for m, r in results.items()},
                     "score_diff_block_vs_rdg": diff, "tiled": tiled}
    return {"train_cli": train_launches,
            **{f"evaluate_cli_{m}": launches[m] for m in modes}}


W16_CLI_DIR = Path("workspace") / "chip_smoke_w16"


def phase_w16(dev, report):
    """The window-16 geometry (16x16 windows, N = 256 keys a window) at full
    width: ``drct_experiment("grid", 256, 4)`` (LR 64 x 64, M = 65,536 token
    rows a batch of 16) through the same checks as the flagship (launch
    plans; kernels (a)-(c) and (g) against their plain versions; serving RDG
    by RDG; timing; kernels (d)-(f); one RDG's gradients; the Trainer; the
    CLIs), in rdg mode and in block mode (kernel (g) at N = 256), then 512
    px at x8. Its lines read "[w16] ...". Returns (launches by main path,
    timings)."""
    global PREFIX
    PREFIX = "w16"
    r16 = report.setdefault("w16", {})
    exp = drct_experiment("grid", 256, 4, precision="bf16",
                          batch_size=BATCH, run_tag="chip_smoke_w16")
    cfg = exp.model
    check = Checker()
    print_plans(cfg, r16)
    phase_kernels(cfg, dev, check)
    phase_swin_block(cfg, dev, check)
    params, packed, x, model, server, lr_u8, hr_u8 = phase_serving(exp, dev,
                                                                   r16)
    serving = r16["main_path_launches"]
    serving_block = r16["main_path_launches_block"]
    timings = phase_timing(exp, dev, packed, x, model, server, lr_u8, hr_u8,
                           r16)
    timings.update(phase_block_timing(exp, dev, packed, x, r16))
    del model, server, packed
    bwd_inputs = phase_bwd_kernels(cfg, dev, check)
    say("kernels", f"{check.cases} cases within tolerance; max abs error "
                   f"{check.max_abs}")
    r16["max_abs_err"] = check.max_abs
    phase_rdg(exp, dev, r16)
    trainer, lrs, hr, train = phase_train(exp, dev, r16, PER_TRAIN_STEP_W16,
                                          W16_BWD_LAUNCHES)
    timings.update(phase_train_timing(exp, dev, trainer, lrs, hr, bwd_inputs,
                                      r16, PER_TRAIN_STEP_W16))
    del trainer, bwd_inputs
    cli = phase_cli(exp, dev, r16, W16_CLI_DIR, ("rdg", "block"),
                    PER_TRAIN_STEP_W16, W16_BWD_LAUNCHES, overlap=0)
    x8 = phase_x8(dev, r16.setdefault("x8", {}))
    paths = {"serving_w16": serving, "serving_block_w16": serving_block,
             "train_w16": train, "train_cli_w16": cli["train_cli"],
             "evaluate_cli_w16": cli["evaluate_cli_rdg"],
             "evaluate_cli_block_w16": cli["evaluate_cli_block"], **x8}
    # (c) on both paths, (f) on the training path and (g) on the block-mode
    # paths went through N = 256
    for path, k in (("serving_w16", "window_attention"),
                    ("train_w16", "window_attention"),
                    ("train_w16", "window_attention_bwd"),
                    ("serving_block_w16", "swin_block"),
                    ("evaluate_cli_block_w16", "swin_block"),
                    ("serving_block_x8", "swin_block")):
        if not paths[path][k]:
            raise AssertionError(f"{path}: {k} launched no time")
    PREFIX = None
    return paths, timings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs one",
              file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    # the plain f32 references run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every phase names its serving mode; the CLI phase sets the switch
    os.environ.pop("ADSR_TPU_RDG", None)
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
    for line in ptxas_summary(_build.build_log()):
        say("build", line)
    report["build_s"] = build_s

    exp = drct_experiment("grid", HR, SCALE, precision="bf16",
                          batch_size=BATCH, run_tag="chip_smoke")
    check = Checker()
    reset_counts()
    print_plans(exp.model, report)
    phase_kernels(exp.model, dev, check)
    phase_swin_block(exp.model, dev, check)
    say("kernels", f"{check.cases} cases within tolerance; max abs error "
                   f"{check.max_abs}; GEMM operands [TMA, cp.async] over "
                   f"these cases {operand_paths()}")
    report["max_abs_err"] = check.max_abs

    params, packed, x, model, server, lr_u8, hr_u8 = phase_main(exp, dev,
                                                                report)
    main_launches = report["main_path_launches"]
    block_launches = report["main_path_launches_block"]
    timings = phase_timing(exp, dev, packed, x, model, server, lr_u8, hr_u8,
                           report)
    timings.update(phase_block_timing(exp, dev, packed, x, report))
    del model, server, packed

    bwd_inputs = phase_bwd_kernels(exp.model, dev, check)
    say("bwd", f"{check.cases} kernel cases within tolerance in all; max abs "
               f"error {check.max_abs}")
    report["max_abs_err"] = check.max_abs
    phase_rdg(exp, dev, report)
    trainer, lrs, hr, train_launches = phase_train(exp, dev, report)
    timings.update(phase_train_timing(exp, dev, trainer, lrs, hr, bwd_inputs,
                                      report))
    del trainer, bwd_inputs
    cli_launches = phase_cli(exp, dev, report)
    w16_paths, timings16 = phase_w16(dev, report)

    # launches by main path, each counted from 0 over that path's run
    paths = {"serving": main_launches, "serving_block": block_launches,
             "train": train_launches, **cli_launches, **w16_paths}
    kernels = []
    for k in KERNELS + BWD_KERNELS + BLOCK_KERNELS:
        kernel_ms, plain_ms, library_ms, bound_ms, bound_by = timings[k]
        names = ("rdg_gemm_dgrad", "rdg_gemm_wgrad") \
            if k == "rdg_gemm_bwd" else (k,)
        by_path = {p: sum(got[n] for n in names) for p, got in paths.items()}
        by_path = {p: n for p, n in by_path.items() if n}
        if k in KERNELS:
            replaces = f"{REPLACES}; {REPLACES_TRAIN_FWD}"
        elif k in BWD_KERNELS:
            replaces = REPLACES_BWD
        else:
            replaces = REPLACES_BLOCK
        if not by_path:
            raise AssertionError(f"{k}: launched on no main path")
        entry = {"name": k, "route": "cuda", "source": SOURCES[k],
                 "replaces": replaces,
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": check.max_abs[k], "ms": kernel_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms}
        if k in GEMMS:          # [TMA, cp.async] operands by main path
            entry["operands_by_path"] = {
                p: got[k] for p, got in report["operand_paths"].items()
                if p in by_path}
        if k in timings16:      # at 16x16 windows, M = 65,536 token rows
            kernel_ms, plain_ms, library_ms, bound_ms, bound_by = timings16[k]
            entry["w16"] = {"source": W16_SOURCES.get(k, SOURCES[k]),
                            "ms": kernel_ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": library_ms,
                            "max_abs_err": report["w16"]["max_abs_err"][k]}
        kernels.append(entry)
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
