#!/usr/bin/env python3
"""Drive the PyTorch port's DRCT x4 @128px serving and training paths and its
train and evaluate CLIs on one GPU, then the window-16 geometry (256px/x4
and 512/x8), the window-4 geometry (64/x4, 128/x8 and 32/x2), the
end-to-end smoke CLI (prepare -> train -> evaluate), DRN-L x4 @128px with
its dual models, EfficientAD at 256 px and the device mesh (world 1, and
world 2 on the one card).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit's nvcc. Phases, each printing its own lines; any failed check raises:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel of ``adsr_tpu_torch/csrc`` (timed) and
   ptxas's registers, shared memory and spills of each kernel are printed;
   it fails on a spill byte in any instance of (c) f32, (d) f32 and (f)
   f32's dq and dkv launches at 16x16 windows and on a C7520 ("wgmma
   serialized") in (b) f32's log (the f32 kernels on the tensor cores), one
   line saying how many it read; then the launch plans of rdg_layernorm (a), window_attention (c),
   swin_block (g), window_attention_bwd (f) and rdg_layernorm_bwd (e) at
   the five flagship blocks (blocks, threads, shared memory, (a)'s pieces,
   lanes a row and rows ahead, (g)'s ring, (f)'s windows a block);
3. kernels against their plain PyTorch versions at the flagship shapes
   (batch 16, 1024 tokens): rdg_layernorm at every block width (and, last
   in each geometry, after the timed phases, on every layout the main path
   and the wrapper hand it: the concat prefix at strides 308 and 312,
   ``x1`` contiguous and pitched, into 16-byte rows and into a contiguous
   [m, c] out, a ragged M and M = 1, and the 2-byte path, each call twice,
   bitwise equal), rdg_gemm at
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
   synthetic grid images (LR by the prep tool's LANCZOS resize) and a
   tail of 5, in rdg mode and in block mode,
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
   (under ``workspace/chip_smoke``; HR and its LANCZOS ``LR_4``, the prep
   tool's layout), ``cli.main`` trains the flagship for
   one epoch (16 steps at batch 16) into a run dir, then ``cli.evaluate
   --precision bf16`` (the bf16 kernels; phase 11a runs its fp32 default)
   scores 8 + 8 test images of 512 px, auto-tiled (25 tiles of 32 LR px an
   image), in rdg mode and with ``ADSR_TPU_RDG=0``; launch counters, run-dir
   files (the loss and PSNR/SSIM PDFs among them), AUCs, specificity and
   tiled img/s in both modes; each evaluation's figures
   (``roc_curve.pdf``, min(16, n) heatmaps a split) and their wall, one
   heatmap a split decoded and its 1-SSIM panel held to a CPU recompute
   from the same uint8 pair (``HEATMAP_EQUAL``);
11. graphs: serving through CUDA graphs, the entry points' default
   (``core/graphs.py``; phases 4-10 check the launched route,
   ``graphs=False``): ``make_serving_forward`` in both modes, ``AnomalyServer``
   in both modes (the 16 + 16 + 5 requests of phase 4, tail padded) and
   ``make_tiled_serving_forward`` on 16 images of 512 px, each replay
   bitwise equal to the launched route, the warm-up and the capture one
   call's launches each and the replays none, the memory each capture
   reserved; then graphs against launched in alternating turns (host clock,
   median and spread): the forward, request latency, tiled img/s and the
   wall of ``evaluate_anomaly`` (the core of ``cli.evaluate``) on phase 10's
   data root;
11a. fp32 serving, lines "[fp32] <phase>: ...": the f32 instances of
   kernels (a)-(c) (TPU kernel 1 at dtype f32) and of kernel (g) (TPU
   kernel 4 at dtype f32) against their plain f32 versions on the card
   (TF32 off): (a) on the concat prefix, ``x1`` and the 4-byte path, (b) at
   every flagship product and epilogue (the training ones too, adjust 5 in
   place), (c) at every block at both shifts, (g) at every block's shape at
   both shifts, twice bitwise (and at batch 5 on 20 x 20 / 32 x 32 tokens
   at windows 4 / 16), at windows 8, 4 (64/x4) and 16 (256px/x4; the table
   and region labels), each within ``F32_REL_L2`` / ``F32_MAX_ABS``; the
   flagship's fp32 forward (``prepack_drct(..., dtype=float32)``) in rdg
   and in block mode against the eager f32 model and the CPU's forward RDG
   by RDG; their launches (40 f32 a RDG in rdg mode, 5 (g) f32 and 5 (b)
   f32 in block mode, no bf16) through the forward, ``AnomalyServer`` and
   ``evaluate_anomaly``; the forward, server and tiled forward of each
   mode through their graphs bitwise equal to the launched route, with the
   capture's memory; scores and AUCs of both modes against the CPU's;
   ``cli.evaluate`` at its fp32 default on phase 10's run dir in rdg mode
   and with ``ADSR_TPU_RDG=0`` (block mode; its scores and AUCs against
   rdg mode's); each f32 kernel's ms per RDG at the three geometries beside
   its bound, plain version and library call ((g) also beside the (a)-(c)
   f32 composition; (b) and (c), whose products run as 3xTF32 on the tensor
   cores, beside their 3xTF32 bound and their FFMA bound; (c) also at batch
   5 on 20 x 20 / 32 x 32 tokens at windows 4 / 16), and both fp32
   forwards' ms in turns;
11b. fp32 training, lines "[fp32_train] <phase>: ...": the f32 instances
   of the backward kernels (d)-(f) (TPU kernel 3 at dtype f32) against their
   plain f32 versions on the card (TF32 off): (d) at every product and dY
   transform of the five blocks through ``rdg_gemm_grads`` (at windows 8,
   4 and 16: wgrad's splits over M = 65,536, adjust's N = 32, dgrad with
   GELU'), (e) at both LayerNorms of every block, (f) at every block and
   both shifts at windows 8, 4 (64/x4) and 16 (256px/x4; fed kernel (c)
   f32's context and softmax statistics,
   which are checked too), every call twice, bitwise equal, each within
   ``F32_REL_L2`` / ``F32_MAX_ABS``; one RDG in f32 against eager f32
   autograd (``F32_RDG_REL_L2``), twice bitwise; a fp32 ``Trainer`` (two
   steps, a test, 20 steps on one batch: the loss falls, every launch of
   (a)-(f) f32 and none bf16, the step's convolutions with cuDNN TF32 off,
   its backward twice bitwise); the fp32 step's ms, idle share and bound;
   ``cli.main --precision fp32`` one epoch on phase 10's data root and
   ``cli.evaluate`` at fp32 on its run dir; each f32 backward kernel's ms
   per RDG at the three geometries beside its bound, plain version and
   library call (``torch.matmul`` x 2, ATen's LayerNorm backward, SDPA's
   f32 backward; (d), and (f) at 16x16 windows, on the tensor cores, beside
   their 3xTF32 bound and their FFMA bound);
12. the window-16 geometry, lines "[w16] <phase>: ...": the full-width
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
   LR px); phase 11 at that size; then 512 px at x8 (``drct_experiment(
   "grid", 512, 8)``): ``AnomalyServer`` scores one batch in each mode, the
   SR against eager f32, the rdg-mode forward and ``AnomalyServer`` through
   their graphs against the launched route, and two train steps;
13. the window-4 geometry, lines "[w4] <phase>: ...": the full-width 64/x4
   model (``drct_experiment("grid", 64, 4)``: LR 16 x 16, 4x4 windows, N =
   16 keys, shifts 0 and 2, M = 4,096 token rows at batch 16) through
   phases 2-11 at that size: the plans of (c), (g) and (f) ((c) and (f):
   every head of a window a block, one window a block at batch 16, a
   persistent grid of staged windows at the tiled CLI's 1,024 crops; (g):
   four windows a block, the last group short at batch 5 on 20 x 20
   tokens); kernels (a)-(c), (g) and (d)-(f) against their plain versions
   (every block, both shifts, every block also at batch 5 on 20 x 20
   tokens, 125 windows, and (c) on the tiled CLI's 1,024 crops and (f) at
   batch 64, the persistent route; each (c), (f) and (g) call twice,
   bitwise equal; (g) also against the (a)-(c) composition); ``AnomalyServer`` scores 16 good + 16
   defective 64 px images and a tail of 5 in both modes, both forwards RDG
   by RDG against the eager f32 model; the timing of both forwards, each
   kernel and the step; one RDG's gradients; the Trainer; ``cli.main
   --resolution 64`` and ``cli.evaluate`` in both modes on 512 px test
   images (8 x 8 tiles of 16 LR px at overlap 0); phase 11 at that size;
   then 128/x8 (one ``AnomalyServer`` batch in each mode against eager
   f32, the rdg forward's and the server's graphs against the launched
   route, four train steps) and 32/x2 (the same without the steps);
14. smoke, lines "[smoke] ...": ``python -m adsr_tpu_torch.cli.smoke
   --resolution 128 --full-size --epochs 1 --device cuda``: the synthetic
   MVTec grid source, ``cli.prepare``'s LANCZOS tree, ``cli.main`` trains the
   flagship one epoch and ``cli.evaluate`` scores the test split, each step
   a process of its own; each step's wall, the prepared tree, the train
   log's device and parameter count, the AUCs, the run dir's loss PDFs, the
   evaluation's figures (as in phase 10); then ``analyze_window_sizes(...,
   device="cuda")`` over the saved SR folders and the HR as the evaluation
   read it, its best window and AUCs beside ``cli.evaluate``'s;
15. DRN-L, lines "[drn] ...": ``drn_experiment("grid", 128, 4)`` at full
   width (scales (2, 4), 40 RCABs an up phase at 20 features, 9.82M params,
   720 in the two duals; random weights from the seed; bf16; batch 16; LR
   pyramid by the prep's LANCZOS): the bf16 forward against the eager f32
   one (TF32 off), each of the three SRs; one dual-regression train step in
   bf16 against f32 from the same state (loss terms, gradients); 20 steps
   on one batch; the serving forward launched and through its CUDA graph
   (bitwise equal); ``AnomalyServer`` with the flagship DRCT grid class and
   a full-width DRN-L carpet class (3 channels), 16 + 16 + 5 requests each,
   every replay bitwise equal to the launched route; ``evaluate_anomaly`` on
   8 + 8 images of 512 px, auto-tiled at 32 LR px; ``cli.smoke --model-type
   drn-l --resolution 128 --epochs 1`` (its run dir holds
   ``dual_model_latest.pt`` and ``loss_{total,primary,dual}.pdf``); the
   forward's and the step's times and the
   step's idle share. DRN's convolutions are cuDNN's: its path launches
   none of the port's kernels, which the kernels line records as its
   ``"drn"`` path, all 0s;
16. EfficientAD, lines "[ead] ...": ``EADConfig()`` at full width (the
   PDN-small teacher at 384 channels, the student at 768, the autoencoder;
   256 px; random weights from the seed; f32 with TF32 off): the teacher's,
   student's, autoencoder's and the distillation oracle's (medium PDN)
   forwards on the card against the CPU on the same weights and inputs;
   one train step on the card against the CPU from the same state and
   draws, without and with a penalty batch (the loss terms, and each
   student and autoencoder leaf's gradient and Adam update); 20 steps on
   one batch of 12; ``map_normalization``, ``test_auc`` and
   ``final_metrics`` on synthetic grid images; the step's time, idle share
   and share of its f32 bound (its convolutions' FLOPs from the shapes)
   and ``predict_maps``' img/s at batch 12; ``cli.efficientad
   --teacher scratch`` (40 distillation and 40 train steps) on a synthetic
   MVTec grid tree of 200 px PNGs, so the loaders' bilinear resize runs.
   EfficientAD's convolutions are cuDNN's: its path launches none of the
   port's kernels, which the kernels line records as its ``"efficientad"``
   path, all 0s;
17. the device mesh, lines "[mesh] ...": the flagship at global batch 8
   over ``core/mesh.py``, each world in spawned ranks
   (``parallel/launch.py``): world 1 over NCCL, where
   ``make_parallel_trainer``'s two steps equal ``make_train_step``'s from
   the same state and draws bit for bit; world 2 over gloo, both ranks on
   the one card (NCCL refuses two ranks on one device): two steps of the
   fused kernel step on 4 rows a rank, each rank's launches the single
   step's, the ranks' parameters bitwise equal, a second run of the two
   steps from the same state bitwise equal to the first, the loss terms,
   the step-1 gradients and the parameters after step 2 against the
   world-1 step at the global batch (``RDG_REL_L2`` by class, loss terms
   at its ``out/dx`` limit); the batch-parallel serving forward through
   graphs bitwise equal to the unsharded one; a ``Trainer`` on the mesh
   (one epoch of two steps, a test of 8); the step's wall at both world
   sizes and the share of one all-reduce of the gradient bucket in it
   (gloo's goes through the host: no speed claim).

The build and the ptxas lines come from this process; each geometry
(phases 3-11 of the flagship, 11a and 11b in fp32, 12, 13), the smoke (14),
DRN-L (15),
EfficientAD (16) and the mesh (17) runs in a process of its own, which
this one starts and waits for (``--phase NAME OUT``).

The last three lines are the kernels' JSON record (each kernel's
window-16 readings under ``"w16"``, its window-4 readings under ``"w4"``,
its launches on every main path under ``"launches_by_path"``), the
nvidia-smi line and ``{"ok": true, "device": {...}}``; the f32 instances are
the kernels line's ``rdg_layernorm_f32``, ``rdg_gemm_f32`` and
``window_attention_f32``, and of (d)-(f) ``rdg_gemm_bwd_f32``,
``rdg_layernorm_bwd_f32`` and ``window_attention_bwd_f32`` (their launches
each wrapper's ``launches_f32``), their windows 4 and 16 under ``"w4"`` /
``"w16"``;
a ``[report]`` line
before them holds every number the run measured, as JSON (the fp32
phases' under ``"fp32"`` and ``"fp32_train"``, the window-16
phase's under ``"w16"``, the window-4 phase's under ``"w4"``, the smoke's
under ``"smoke"``, DRN-L's under ``"drn"``, EfficientAD's under
``"ead"``, the mesh's under ``"mesh"``; the mesh's launches are the
kernels line's ``"mesh_w1"``, ``"mesh_w2"`` (both ranks' steps),
``"mesh_w2_serving"`` and ``"mesh_w2_trainer"`` paths).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from adsr_tpu_torch.cli import efficientad as cli_ead
from adsr_tpu_torch.cli import evaluate as cli_eval
from adsr_tpu_torch.cli import main as cli_main
from adsr_tpu_torch.cli import smoke as cli_smoke
from adsr_tpu_torch.core.config import (MeshConfig, drct_experiment,
                                        drn_experiment)
from adsr_tpu_torch.core.device import deterministic_f32, full_f32
from adsr_tpu_torch.core.mesh import default_backend, make_mesh
from adsr_tpu_torch.data.pipeline import SRDataset, load_sr_dataset, set_channel
from adsr_tpu_torch.data.prepare import lr_from_hr
from adsr_tpu_torch.data.synthetic import (carpet_texture,
                                           generate_synthetic_mvtec,
                                           grid_texture, inject_defect)
from adsr_tpu_torch.eval.disk import analyze_window_sizes
from adsr_tpu_torch.eval.evaluate import (evaluate_anomaly,
                                          evaluate_anomaly_arrays)
from adsr_tpu_torch.eval.rundir import resolve_checkpoint
from adsr_tpu_torch.eval.serving import AnomalyServer
from adsr_tpu_torch.eval.tiled import tile_starts
from adsr_tpu_torch.eval.visual import (heatmap_panel, index_agreement,
                                        lut_indices, one_minus_ssim)
from adsr_tpu_torch.io.journal import load_state_dict
from adsr_tpu_torch.io.png import read_png, write_png
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
from adsr_tpu_torch.kernels.rdg_layernorm import (blocks_per_sm,
                                                  check_ln_layout,
                                                  rdg_layernorm,
                                                  rdg_layernorm_plain,
                                                  rdg_layernorm_plan)
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
from adsr_tpu_torch.models.drn import apply_dual
from adsr_tpu_torch.models.efficientad import PDN, init_efficientad_
from adsr_tpu_torch.models.factory import (init_sr_params, init_weights_,
                                           make_model)
from adsr_tpu_torch.parallel.launch import run_ranks
from adsr_tpu_torch.parallel.sharding import make_parallel_trainer
from adsr_tpu_torch.train.efficientad import (EADConfig, EfficientADTrainer,
                                              StepDraws, final_metrics,
                                              normalize_imagenet)
from adsr_tpu_torch.train.trainer import (Trainer, make_serving_forward,
                                          make_tiled_serving_forward,
                                          make_train_step, stream_seed)

SEED = 0
DEVICE = "cuda"
BATCH = 16
HR = 128
SCALE = 4
# H100 SXM published peaks (dense), for the bounds
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12
# (b) f32 and (f) f32 at 16x16 windows run their products as 3xTF32 on the
# tensor cores: their bound is three TF32 products at this rate (the rest
# of their arithmetic at F32_FLOPS) or the bytes, the FFMA bound beside it
TF32_TC_FLOPS = 495e12

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
TRAIN_TIMED = 5              # steps (forwards, forward + backwards) timed
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
# the f32 instances of (a)-(c) (fp32 serving, csrc/rdg_layernorm.cu's f32
# instances, rdg_gemm_f32.cu, window_attention*_f32.cu): counted apart, in
# each wrapper's ``launches_f32``; 40 a RDG, as the bf16 route
F32_KERNELS = ("rdg_layernorm_f32", "rdg_gemm_f32", "window_attention_f32")
F32_WRAPPERS = {"rdg_layernorm_f32": rdg_layernorm, "rdg_gemm_f32": rdg_gemm,
                "window_attention_f32": window_attention,
                "rdg_gemm_dgrad_f32": gbwd.rdg_gemm_dgrad,
                "rdg_gemm_wgrad_f32": gbwd.rdg_gemm_wgrad,
                "rdg_layernorm_bwd_f32": rdg_layernorm_bwd,
                "window_attention_bwd_f32": window_attention_bwd,
                "swin_block_f32": fused_swin_block}
PER_FORWARD_F32 = {"rdg_layernorm_f32": 120, "rdg_gemm_f32": 300,
                   "window_attention_f32": 60}
F32_SOURCES = {"rdg_layernorm_f32": "adsr_tpu_torch/csrc/rdg_layernorm.cu",
               "rdg_gemm_f32": "adsr_tpu_torch/csrc/rdg_gemm_f32.cu",
               "window_attention_f32":
               "adsr_tpu_torch/csrc/window_attention_f32.cu"}
# (c)'s f32 instances have a source a window, on window_attention_tc_f32.cuh
F32_WINDOW_SOURCES = {
    "w4": "adsr_tpu_torch/csrc/window_attention4_f32.cu",
    "w16": "adsr_tpu_torch/csrc/window_attention16_f32.cu"}
# the f32 instances of (d)-(f) (fp32 training: rdg_gemm_bwd_f32.cu,
# rdg_layernorm_bwd.cu's f32 instance, window_attention_bwd*_f32.cu on
# window_attention_bwd_f32.cuh, a source a window), counted in each
# wrapper's ``launches_f32``
F32_BWD_KERNELS = ("rdg_gemm_bwd_f32", "rdg_layernorm_bwd_f32",
                   "window_attention_bwd_f32")
F32_BWD_SOURCES = {
    "rdg_gemm_bwd_f32": "adsr_tpu_torch/csrc/rdg_gemm_bwd_f32.cu",
    "rdg_layernorm_bwd_f32": "adsr_tpu_torch/csrc/rdg_layernorm_bwd.cu",
    "window_attention_bwd_f32":
    "adsr_tpu_torch/csrc/window_attention_bwd_f32.cu"}
F32_BWD_WINDOW_SOURCES = {
    "w4": "adsr_tpu_torch/csrc/window_attention_bwd4_f32.cu",
    "w16": "adsr_tpu_torch/csrc/window_attention_bwd16_f32.cu"}
# block mode: per RDG five (g) launches and five adjust products
PER_FORWARD_BLOCK = {"swin_block": 60, "rdg_gemm": 60}
# fp32 block mode: the same launches, (g)'s and (b)'s f32 instances
# (csrc/swin_block{,4,16}_f32.cu on swin_block_f32.cuh, a source a window)
PER_FORWARD_BLOCK_F32 = {"swin_block_f32": 60, "rdg_gemm_f32": 60}
F32_SWIN_SOURCES = {"w8": "adsr_tpu_torch/csrc/swin_block_f32.cu",
                    "w4": "adsr_tpu_torch/csrc/swin_block4_f32.cu",
                    "w16": "adsr_tpu_torch/csrc/swin_block16_f32.cu"}
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
# one fp32 train step at the flagship: the same launches, every one an f32
# instance
PER_TRAIN_STEP_F32 = {f"{k}_f32": v for k, v in PER_TRAIN_STEP.items()}
W16_BWD_LAUNCHES = 2
SOURCES = {k: f"adsr_tpu_torch/csrc/{k}.cu"
           for k in KERNELS + BWD_KERNELS + BLOCK_KERNELS}
# kernels (c)'s, (f)'s and (g)'s 16x16-window launches have sources of
# their own
W16_SOURCES = {"window_attention": "adsr_tpu_torch/csrc/window_attention16.cu",
               "window_attention_bwd":
               "adsr_tpu_torch/csrc/window_attention_bwd16.cu",
               "swin_block": "adsr_tpu_torch/csrc/swin_block16.cu"}
# ... and their 4x4-window launches too
W4_SOURCES = {"window_attention": "adsr_tpu_torch/csrc/window_attention4.cu",
              "window_attention_bwd":
              "adsr_tpu_torch/csrc/window_attention_bwd4.cu",
              "swin_block": "adsr_tpu_torch/csrc/swin_block4.cu"}
# kernels (c) and (f) at 4x4 windows take a persistent grid of staged
# windows where the card cannot hold a block for every window: the 64/x4
# tiled CLI's forward of 1,024 crops of 16 x 16 tokens (16 images of 512 px
# in 8 x 8 tiles); (f) is checked there at a batch of 64 crops (1,024
# windows), which takes the same route
TILED_CROPS4 = 1024
PERSISTENT_BATCH4 = 64
REPLACES = "adsr_tpu/ops/fused_rdg.py:573"
REPLACES_TRAIN_FWD = "adsr_tpu/ops/fused_rdg_train.py:823"
REPLACES_BWD = "adsr_tpu/ops/fused_rdg_train.py:968"
REPLACES_BLOCK = "adsr_tpu/ops/fused_swin_block.py:337"


def expected_counts(per: dict, n: int) -> dict:
    """Launch counts of every wrapper after ``n`` runs of ``per``."""
    want = {k: 0 for k in (*WRAPPERS, *F32_WRAPPERS)}
    want.update({k: v * n for k, v in per.items()})
    return want


# "w16" / "w4" while the window-16 / window-4 phase runs: its lines read
# "[w16] <phase>: ..."
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
    and element-type template arguments: ``rdg_layernorm_kernel<float,4,0>``)."""
    found = re.search(r"_kernel(?=I|E|v)", mangled)
    if found is None:
        return mangled
    end = found.end()
    for start in range(end - 1, 0, -1):
        digits = str(end - start)
        if mangled[start - len(digits):start] == digits:
            args = re.match(r"I((?:Li\d+E|f|13__nv_bfloat16)+)E",
                            mangled[end:])
            names = [n or ("float" if f else "bf16") for n, f, _ in
                     re.findall(r"Li(\d+)E|(f)|(13__nv_bfloat16)",
                                args.group(1))] if args else []
            return mangled[start:end] + (f"<{','.join(names)}>"
                                         if names else "")
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


# the f32 kernels on the tensor cores: (c) f32's, (d) f32's, (f) f32's
# (N = 16 / 64 and both N = 256 launches) and (g) f32's must not spill
# (every instance), (b) f32's wgmma must not be serialized (ptxas's C7520
# warning)
NO_SPILL_KERNELS = ("window_attention_f32_kernel", "gemm_f32_kernel",
                    "attn_bwd_f32_kernel", "attn_bwd16_dq_f32_kernel",
                    "attn_bwd16_dkv_f32_kernel", "swin_block_f32_kernel")
NO_C7520_SOURCE = "rdg_gemm_f32"


def check_tensor_core_builds(build_dir: Path) -> dict:
    """Fails on a spill byte in ptxas's line of any instance of
    ``NO_SPILL_KERNELS`` and on a C7520 in ``NO_C7520_SOURCE``'s build log
    (the logs ``_build`` keeps beside the library); returns what it read."""
    logs = {p.stem: p.read_text() for p in build_dir.glob("*.log")}
    lines = [line for line in ptxas_summary("\n".join(logs.values()))
             if line.split("<")[0] in NO_SPILL_KERNELS]
    spilled = [line for line in lines
               if not re.search(r" 0 bytes spill stores, 0 bytes spill loads",
                                line)]
    c7520 = [line.strip() for line in logs[NO_C7520_SOURCE].splitlines()
             if "C7520" in line]
    kinds = {k: sum(line.split("<")[0] == k for line in lines)
             for k in NO_SPILL_KERNELS}
    say("build", "tensor-core f32 kernels: " + ", ".join(
        f"{v} {k}" for k, v in kinds.items()) + f" instances ((c), (d), "
        f"(f) at N = 16 / 64 and 256, (g)), {len(spilled)} with spills; "
        f"(b) f32 "
        f"({NO_C7520_SOURCE}.cu): {len(c7520)} C7520 warnings")
    if not all(kinds.values()) or spilled or c7520:
        raise AssertionError("tensor-core f32 kernels: spills "
                             f"{spilled or lines or 'no instances found'}; "
                             f"C7520 {c7520}")
    return {"no_spill_instances": len(lines), "c7520": len(c7520)}


GEMMS = ("rdg_gemm", "rdg_gemm_bwd")


def reset_counts() -> None:
    """Every wrapper's launch count, and the GEMM kernels' operand counts
    by load path, to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn in F32_WRAPPERS.values():
        fn.launches_f32 = 0
    for k in GEMMS:
        _build.operand_paths(k)[:] = [0, 0]
    gbwd.dy_eff_copies = 0


def counts() -> dict:
    """Every wrapper's launches since :func:`reset_counts`: the bf16
    kernels' by name, the f32 instances' under ``F32_KERNELS``."""
    return {**{k: fn.launches for k, fn in WRAPPERS.items()},
            **{k: fn.launches_f32 for k, fn in F32_WRAPPERS.items()}}


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


def main_path_ln_pieces(cfg, k: int) -> tuple:
    """The piece widths (bytes) kernel (a) takes on the main path at block
    ``k``: LN1 over the concat prefix (``fused_drct``'s concat buffer at its
    plain stride) and LN2 over ``x1``, both into 16-byte rows
    (``rdg_workspace`` / ``block_buffers``; their layouts at two rows on
    the host, the rule is the same at any M)."""
    g = rdg_geometry(cfg)
    c, f = g["feats"][k], g["hidden"][k]
    bufs = block_buffers(rdg_workspace(2, cfg, torch.bfloat16, "cpu"), 2, c,
                         f)
    cat = torch.empty(2, g["cat_width"], dtype=torch.bfloat16)
    return (check_ln_layout("rdg_layernorm", cat[:, :c], bufs["ln1"]),
            check_ln_layout("rdg_layernorm", bufs["x1"], bufs["ln2"]))


def print_plans(cfg, report):
    """The launch plans of kernels (a), (c), (g), (f) and (e) at the five
    blocks of ``cfg`` (kernels/rdg_layernorm.py, kernels/window_attention.py,
    kernels/fused_swin_block.py, kernels/window_attention_bwd.py,
    kernels/rdg_layernorm_bwd.py): blocks, threads, shared memory, (a)'s
    piece bytes, lanes a row and rows a step for LN1 and LN2, (g)'s
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
        pl1, pl2 = (rdg_layernorm_plan(m, c, sms, piece,
                                       blocks_per_sm(piece))
                    for piece in main_path_ln_pieces(cfg, k))
        say("plan", f"b{k + 1} c={c}: rdg_layernorm LN1 {pl1}; LN2 {pl2}")
        win = cfg.window_size
        pa = window_attention_plan(c, nh, BATCH, side, side, window=win,
                                   sms=sms)
        pg = swin_block_plan(c, f, nh, BATCH, side, side, window=win,
                             sms=sms)
        # blocks in flight: one an SM (shared memory); at 16x16 windows the
        # clusters of 4 the card holds at once; every block streams each
        # weight tile itself by TMA (no multicast, at every window)
        if win == 16:
            at_once = swin_block16_clusters(c, f, nh)
            pg = {**pg, "clusters_at_once": at_once,
                  "in_flight": min(pg["blocks"], 4 * at_once)}
        else:
            pg = {**pg, "in_flight": min(pg["blocks"], sms)}
        pg["multicast"] = False
        pf = window_attention_bwd_plan(c, nh, BATCH, side, side, sms, win)
        pe = rdg_layernorm_bwd_plan(m, c, sms)
        say("plan", f"b{k + 1} c={c} heads={nh}: window_attention {pa}; "
                    f"swin_block {pg}")
        say("plan", f"b{k + 1} c={c} heads={nh}: window_attention_bwd {pf}; "
                    f"rdg_layernorm_bwd {pe}")
        plans[f"b{k + 1}"] = {"rdg_layernorm": {"ln1": pl1, "ln2": pl2},
                              "window_attention": pa, "swin_block": pg,
                              "window_attention_bwd": pf,
                              "rdg_layernorm_bwd": pe}
        if win == 4:            # the tiled CLI's persistent grid
            pt = window_attention_plan(c, nh, TILED_CROPS4, side, side,
                                       window=win, sms=sms)
            pft = window_attention_bwd_plan(c, nh, PERSISTENT_BATCH4, side,
                                            side, sms, win)
            say("plan", f"b{k + 1} c={c} heads={nh}: window_attention at "
                        f"{TILED_CROPS4} crops {pt}; window_attention_bwd at "
                        f"batch {PERSISTENT_BATCH4} {pft}")
            plans[f"b{k + 1}"].update(window_attention_tiled=pt,
                                      window_attention_bwd_persistent=pft)
    report["plans"] = plans


def ln_cases(cat, blocks, m, dev) -> list:
    """Kernel (a)'s layouts, (label, x, weight, bias, out layout): at every
    block the concat prefix at the main path's stride (``cat``, 308) and at
    16-byte rows (312), into 16-byte rows (the main path's ``ln1``) and
    into a contiguous [m, c] out (8-byte rows: the next row starts right
    after column c), ``x1`` contiguous (the main path's) and pitched; the
    concat prefix at a ragged M (m - 40) and at M = 1 for blocks 1 and 5;
    and the 2-byte path: a base 4 bytes past alignment and c = 178."""
    wide = pitched(m, cat.shape[1], device=dev)
    wide.copy_(cat)
    cases = []
    for k, blk in enumerate(blocks):
        c, wt, bs = blk["c"], blk["ln_w"], blk["ln_b"]
        x1p = pitched(m, c, device=dev)
        x1p.copy_(blk["x1"])
        tag = f"b{k + 1} c={c}"
        cases += [
            (f"{tag} concat prefix, stride {cat.shape[1]}", cat[:, :c], wt,
             bs, "pitched"),
            (f"{tag} concat prefix, stride {wide.stride(0)}", wide[:, :c], wt,
             bs, "pitched"),
            (f"{tag} concat prefix -> [m, c] out", cat[:, :c], wt, bs,
             "contiguous"),
            (f"{tag} x1 contiguous", blk["x1"], wt, bs, "pitched"),
            (f"{tag} x1 pitched", x1p, wt, bs, "pitched")]
        if k in (0, 4):
            cases += [(f"{tag} concat prefix, M = {rows}", cat[:rows, :c], wt,
                       bs, "contiguous") for rows in (m - 40, 1)]
    blk = blocks[0]
    cases += [
        ("b1 c=180 base 4 bytes past alignment", cat[:, 2:182], blk["ln_w"],
         blk["ln_b"], "contiguous"),
        ("c=178", wide[:, :178], blk["ln_w"][:178].contiguous(),
         blk["ln_b"][:178].contiguous(), "pitched")]
    return cases


def check_ln_layouts(cat, blocks, m, dev, check: Checker) -> None:
    """Kernel (a) on every layout of :func:`ln_cases` against its plain
    version, each call twice (bitwise equal); a pitched out's pad columns
    hold NaN before and must after (no store past column c)."""
    for label, x, wt, bs, layout in ln_cases(cat, blocks, m, dev):
        rows, c = x.shape
        outs = []
        for _ in range(2):
            if layout == "pitched":
                pitch = row_pitch(c)
                flat = torch.full(((rows - 1) * pitch + c,), float("nan"),
                                  dtype=torch.bfloat16, device=dev)
                out = flat.as_strided((rows, c), (pitch, 1))
            else:
                flat, out = None, torch.empty(rows, c, dtype=torch.bfloat16,
                                              device=dev)
            rdg_layernorm(x, wt, bs, out)
            if flat is not None and rows > 1 and not bool(
                    flat[:(rows - 1) * pitch].view(rows - 1, pitch)[:, c:]
                    .isnan().all()):
                raise AssertionError(f"rdg_layernorm {label}: a store past "
                                     f"column {c}")
            outs.append(out)
        piece = check_ln_layout("rdg_layernorm", x, outs[0])
        check("rdg_layernorm", f"{label} ({piece}-byte pieces)", outs[0],
              rdg_layernorm_plain(x.float(), wt, bs), LN_ATOL)
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"rdg_layernorm {label}: two launches "
                                 "differ")


def phase_ln_layouts(cfg, dev, check: Checker) -> None:
    """Kernel (a) on every layout of :func:`ln_cases` at the geometry's M,
    on the kernels phase's inputs made again from the seed. Each geometry
    runs it last: its buffers, made before the timing phases, moved the
    allocations those phases reuse (kernel (e) read up to 5% slower), and
    they go back to the card when it ends."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cat, blocks, _ = make_case_inputs(cfg, dev, gen)
    n0 = check.cases
    check_ln_layouts(cat, blocks, flagship_shapes(cfg)[1], dev, check)
    say("kernels", f"rdg_layernorm: {check.cases - n0} layouts within "
                   f"tolerance, each twice bitwise equal; max abs error "
                   f"{check.max_abs['rdg_layernorm']}")
    del cat, blocks
    torch.cuda.empty_cache()


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
    # odd batch: a grid that is no multiple of the batch of 16); at 4x4
    # windows every block on 5 images of 20 x 20 tokens (125 windows: the
    # last group of four holds one)
    # ... and at 4x4 windows every block also on the tiled CLI's 1,024
    # crops (the plan's persistent grid, the block's own shift), each call
    # twice, bitwise equal
    win, half = cfg.window_size, cfg.window_size // 2
    side5 = 20 if win == 4 else h
    masks5 = shift_masks(side5, side5, win, (half,), torch.device(dev))
    sms = _build.sm_count(dev)
    for k, blk in enumerate(blocks):
        c, nh = blk["c"], blk["nh"]
        atol = 2.0 ** -8 * blk["qkv"][:, 2 * c:].float().abs().max().item()
        cases = [(0, h, m, masks), (half, h, m, masks)]
        if k == 1 or win == 4:
            cases.append((half, side5, 5 * side5 ** 2, masks5))
        if win == 4:
            cases.append((blk["shift"], h, TILED_CROPS4 * h * w, masks))
        for shift, side, rows, mks in cases:
            mask = mks.get(shift)
            kbias, kmask = attn_operands(blk, mks, side, side, shift, win)
            if rows > m:        # fresh rows at the bound of the main case
                qkv = pitched(rows, 3 * c, device=dev)
                qkv.copy_(torch.randn(rows, 3 * c, generator=gen,
                                      device=dev))
                atol = 2.0 ** -8 * qkv[:, 2 * c:].float().abs().max().item()
            else:
                qkv = blk["qkv"][:rows]
            out = pitched(rows, c, device=dev)
            # at 16x16 windows also the softmax statistics the training
            # backward's recompute asks for
            stats = softmax_stats(qkv, side, side, nh, win)
            want_st = None if stats is None else torch.empty_like(stats)
            window_attention(qkv, out, kbias, kmask, side, side, nh, win,
                             shift, stats)
            want = window_attention_plain(qkv.float(), blk["attn_bias"],
                                          mask, side, side, nh, win, shift,
                                          want_st)
            label = (f"b{k + 1} c={c} heads={nh} hd={c // nh} shift={shift}"
                     + ("" if rows == m else
                        f" B={rows // side ** 2} on {side}x{side}"))
            if win == 4:
                plan = window_attention_plan(c, nh, rows // side ** 2, side,
                                             side, window=4, sms=sms)
                label += f" grid={plan['grid']} stages={plan['stages']}"
                if (rows > m) != (plan["stages"] > 1):
                    raise AssertionError(f"window_attention {label}: not the "
                                         "route this case is for")
            check("window_attention", label, out, want, atol)
            if win == 4:
                again = pitched(rows, c, device=dev)
                window_attention(qkv, again, kbias, kmask, side, side, nh,
                                 win, shift)
                if not torch.equal(out, again):
                    raise AssertionError(f"window_attention {label}: two "
                                         "launches differ")
            del want
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
    16x16 and 4x4 windows also two launches bitwise equal, and each block at
    batch 5 on 32 x 32 tokens at 16x16 windows (4 windows an image: 20
    clusters, a grid short of the card's SMs) or on 20 x 20 at 4x4 (125
    windows: the last block of four holds one); at 4x4 each case names the
    plan's cluster (2 where two blocks a group fit one wave), and each
    block also runs at batch 16 on 32 x 32 tokens (256 groups: cluster 1,
    the route of the tiled CLI's crops), twice, bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    cat, blocks, masks = make_case_inputs(cfg, dev, gen)
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    work = rdg_workspace(m, cfg, torch.bfloat16, dev)
    sms = _build.sm_count(dev)

    def cluster_of(blk, b, side):
        """The plan's blocks a group at 4x4 windows, as a case's suffix"""
        if cfg.window_size != 4:
            return ""
        plan = swin_block_plan(blk["c"], blk["f"], blk["nh"], b, side, side,
                               window=4, sms=sms)
        return f" cluster={plan['cluster']}"

    for k, blk in enumerate(blocks):
        c, nh, f = blk["c"], blk["nh"], blk["f"]
        p, x = swin_case(blk), cat[:, :c]
        out = torch.empty(m, c, dtype=torch.bfloat16, device=dev)
        fused_swin_block(x, p, masks, cfg, h, w, k, out)
        want = fused_swin_block_plain(x, p, masks, cfg, h, w, k)
        case = f"b{k + 1} c={c} heads={nh} hd={c // nh} f={f} " \
               f"shift={blk['shift']}" + cluster_of(blk, BATCH, h)
        check("swin_block", case, out, want, SWIN_ATOL)
        comp = swin_block_forward(x, p, block_buffers(work, m, c, f),
                                  masks, cfg, h, w, k)
        check("swin_block vs (a)-(c)", case, out, comp.float(),
              2 * SWIN_ATOL, 2 * RTOL)
        say("kernels", f"{'':20s} (a)-(c) composition vs plain max_abs "
                       f"{(comp.float() - want).abs().max().item():.3e}")
        if cfg.window_size in (4, 16):
            again = torch.empty_like(out)
            fused_swin_block(x, p, masks, cfg, h, w, k, again)
            if not torch.equal(out, again):
                raise AssertionError(f"swin_block {case}: two launches differ")
    if cfg.window_size not in (4, 16):
        return
    side = 32 if cfg.window_size == 16 else 20
    rows = 5 * side * side
    masks_s = {s: torch.as_tensor(shift_attn_mask(side, side, cfg.window_size,
                                                  s), device=dev)
               for s in masks}
    for k, blk in enumerate(blocks):
        c, p, x = blk["c"], swin_case(blk), cat[:rows, :blk["c"]]
        out = torch.empty(rows, c, dtype=torch.bfloat16, device=dev)
        fused_swin_block(x, p, masks_s, cfg, side, side, k, out)
        check("swin_block", f"b{k + 1} c={c} shift={blk['shift']} B=5 on "
              f"{side}x{side}" + cluster_of(blk, 5, side), out,
              fused_swin_block_plain(x, p, masks_s, cfg, side, side, k),
              SWIN_ATOL)
    if cfg.window_size != 4:
        return
    side = 32
    rows = BATCH * side * side
    masks_w = {s: torch.as_tensor(shift_attn_mask(side, side, 4, s),
                                  device=dev) for s in masks}
    wide = (torch.randn(rows, cat.shape[1], generator=gen, device=dev)
            ).to(torch.bfloat16)
    for k, blk in enumerate(blocks):
        c, p, x = blk["c"], swin_case(blk), wide[:, :blk["c"]]
        tag = cluster_of(blk, BATCH, side)
        if tag != " cluster=1":
            raise AssertionError(f"swin_block b{k + 1}: the plan at batch "
                                 f"{BATCH} on {side}x{side} took{tag}")
        case = f"b{k + 1} c={c} shift={blk['shift']} B={BATCH} on " \
               f"{side}x{side}{tag}"
        out = torch.empty(rows, c, dtype=torch.bfloat16, device=dev)
        fused_swin_block(x, p, masks_w, cfg, side, side, k, out)
        check("swin_block", case, out,
              fused_swin_block_plain(x, p, masks_w, cfg, side, side, k),
              SWIN_ATOL)
        again = torch.empty_like(out)
        fused_swin_block(x, p, masks_w, cfg, side, side, k, again)
        if not torch.equal(out, again):
            raise AssertionError(f"swin_block {case}: two launches differ")


def synthetic_split(rng, n_good, n_bad, hr_px=None, scale=None,
                    texture=grid_texture):
    """uint8 RGB HR [N, hr_px, hr_px, 3] (default HR; grid images unless
    ``texture`` says otherwise) and LR at 1 / scale (default SCALE), made by
    the prep tool's LANCZOS resize (``lr_from_hr``, Pillow's bytes)."""
    hr_px, scale = hr_px or HR, scale or SCALE
    good = [texture(rng, hr_px) for _ in range(n_good)]
    kinds = ("blob", "scratch")
    bad = [inject_defect(rng, texture(rng, hr_px), kinds[i % 2])
           for i in range(n_bad)]
    hr = np.stack(good + bad)
    lr = np.stack([lr_from_hr(im, scale) for im in hr])
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
    # the launched route (graphs=False): every call counts its launches;
    # phase_graphs holds the captured route against it
    server = AnomalyServer(batch_size=BATCH, ssim_window=11, device=dev,
                           graphs=False)
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
    server_b = AnomalyServer(batch_size=BATCH, ssim_window=11, device=dev,
                             graphs=False)
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
                                  mode="rdg", graphs=False)
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
    server = AnomalyServer(batch_size=BATCH, ssim_window=11, device=dev,
                           graphs=False)
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
    server_b = AnomalyServer(batch_size=BATCH, ssim_window=11, device=dev,
                             graphs=False)
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


def phase_x8(dev, report, res=512, scale=8, steps=2, suffix="_x8",
             per_step_want=None, bwd_launches=W16_BWD_LAUNCHES):
    """Another tail on a geometry's tokens: ``drct_experiment("grid", res,
    scale)`` (512/x8 by default: LR 64 x 64, the window-16 token geometry,
    three pixel shuffles in the tail; 128/x8 and 32/x2 on the 64/x4 model's
    window-4 tokens): ``AnomalyServer`` scores one batch in each mode, each
    forward against the eager f32 model, the rdg-mode forward and
    ``AnomalyServer`` through their graphs against the launched route, then
    ``steps`` train steps at batch 16 (``per_step_want``: one step's
    launches, default PER_TRAIN_STEP_W16; ``bwd_launches``: kernel (f)'s a
    Swin block backward). Returns launches by path, each path's name ending
    in ``suffix``."""
    per_step_want = per_step_want or PER_TRAIN_STEP_W16
    exp = drct_experiment("grid", res, scale, precision="bf16",
                          batch_size=BATCH, run_tag=f"chip_smoke{suffix}")
    cfg = exp.model
    params, packed, x, model, server, lr_u8, hr_u8 = phase_serving(
        exp, dev, report, n_good=BATCH // 2, n_bad=BATCH // 2, tail=0)
    serving = report["main_path_launches"]
    serving_block = report["main_path_launches_block"]
    del model, server, packed
    fwd = {g: make_serving_forward(exp, params, dev, mode="rdg", graphs=g)
           for g in (True, False)}
    check_replays("forward_rdg", fwd[True], fwd[False], forward_inputs(x),
                  PER_FORWARD, report)
    del fwd
    serving_graphs = check_server_graphs(exp, dev, params, lr_u8, hr_u8,
                                         "rdg", report, "serving_graphs")[0]
    paths = {f"serving{suffix}": serving,
             f"serving_block{suffix}": serving_block,
             f"serving_graphs{suffix}": serving_graphs}
    if not steps:
        return paths
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
            or got != expected_counts(per_step_want, steps):
        raise AssertionError(f"x{scale} train: losses {losses}, launches "
                             f"{got}")
    check_operand_paths(f"train{suffix}", got, report, bwd_launches)
    report[f"train{suffix}"] = {"losses": losses, "launches": got}
    return {**paths, f"train{suffix}": got}


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
    """The bound's bytes and operations over the measured time, and the
    bound over the time."""
    return (f"achieved {bound[2] / kernel_ms / 1e9:.3f} TB/s, "
            f"{bound[3] / kernel_ms / 1e9:.1f} TFLOP/s, bound / time "
            f"{bound[0] / kernel_ms:.3f}")


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
            # window_attention16_kernel, window_attention4_kernel: (c) at
            # 16x16 and 4x4 windows (swin_block16_, swin_block4_: (g));
            # the f32 instances: rdg_gemm_f32_kernel,
            # window_attention_f32_kernel, rdg_layernorm_kernel<float
            fam = next((k for k in F32_KERNELS if k + "_kernel" in ev.key),
                       None)
            if fam is None and "rdg_layernorm_kernel<float" in ev.key:
                fam = "rdg_layernorm_f32"
            fam = fam or next((k for k in KERNELS + BLOCK_KERNELS
                               if k + "_kernel" in ev.key
                               or k + "16_" in ev.key
                               or k + "4_" in ev.key), "other")
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
                  f"uint8 requests {score_ms:.3f} ms host wall (launched, "
                  "graphs=False)")
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
    the output written once, weights, vectors, the bias and the mask read
    once: at 16x16 windows as the relative-position table and the region
    labels the kernel reads, else [nh, N, N] and [nW, N, N]) over the HBM
    rate against the products on the tensor cores plus the softmax and
    LayerNorm work on the f32 units."""
    win = cfg.window_size
    n = win * win
    byt = tc = f32 = 0.0
    for blk in blocks:
        c, f, nh = blk["c"], blk["f"], blk["nh"]
        byt += 2 * m * c * 2 + (4 * c * c + 2 * c * f) * 2 \
            + (3 * c + 7 * c + f) * 4
        mask = masks[blk["shift"]] if blk["shift"] else None
        if win in TILED_WINDOWS:
            byt += nh * (2 * win - 1) ** 2 * 4
            byt += 0 if mask is None else mask.shape[0] * n * 4
        else:
            byt += nh * n * n * 4 + (0 if mask is None else mask.numel() * 4)
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
    # blocks at batch 5 whose plan ends on a short group: at window 8
    # blocks 1 and 4 on 40 x 40 tokens (125 windows, groups of 2), at
    # window 16 blocks 2 and 5 on 64 x 64 (80 windows, groups of 3), at
    # window 4 every block on 20 x 20 (125 windows, one a block), and at
    # window 4 every block also at batch 64 (1,024 windows: the plan's
    # persistent grid of staged windows, the block's own shift); every call
    # twice, bitwise equal
    win = cfg.window_size
    short, half = (5, {4: 20, 8: 40}.get(win, 64)), win // 2
    short_blocks = {4: range(5), 8: (0, 3)}.get(win, (1, 4))
    short_masks = shift_masks(short[1], short[1], win, (half,),
                              torch.device(dev))
    for k, blk in enumerate(blocks):
        c, nh = blk["c"], blk["nh"]
        cases = [(shift, h, masks, BATCH) for shift in (0, half)]
        if k in short_blocks and short[0] * short[1] ** 2 <= m:
            cases.append((half, short[1], short_masks, short[0]))
        if win == 4:
            cases.append((blk["shift"], h, masks, PERSISTENT_BATCH4))
        for shift, side, mks, batch in cases:
            # the full mask for the plain version, the kernels' own form
            mask = mks.get(shift)
            kbias, kmask = attn_operands(blk, mks, side, side, shift, win)
            rows = batch * side * side
            plan = window_attention_bwd_plan(c, nh, batch, side, side,
                                             _build.sm_count(dev), win)
            if rows > m:        # fresh rows as the main case's
                qkv = pitched(rows, 3 * c, device=dev)
                qkv.copy_(torch.randn(rows, 3 * c, generator=gen,
                                      device=dev))
                dctx = pitched(rows, c, device=dev)
                dctx.copy_(torch.randn(rows, c, generator=gen, device=dev))
            else:
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
            if win == 4:
                tag = (f" B={batch} on {side}x{side} grid={plan['grid']} "
                       f"stages={plan['stages']}")
                if (rows > m) != (plan["stages"] > 1):
                    raise AssertionError(f"window_attention_bwd b{k + 1}"
                                         f"{tag}: not the route this case "
                                         "is for")
            else:
                tag = "" if side == h else (
                    f" {side}x{side} B={batch} groups of "
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


def profile_steps(fn, reps: int = 2):
    """(wall ms per call, {kernel family: device ms per call}) of ``fn``.
    Only device-side events count: a kernel launched inside an autograd
    node (every RDG Function) is also charged to that node's CPU event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # the f32 instances first: "rdg_gemm_f32_kernel<128, 0>" holds
    # "gemm_f32_kernel<1" ((d) f32's are gemm_f32_kernel<0, 2>, dgrad, and
    # <1, 4>, wgrad)
    fams = {"rdg_gemm_f32_kernel": "rdg_gemm_f32",
            "gemm_f32_kernel<0": "rdg_gemm_bwd_f32 dgrad",
            "gemm_f32_kernel<1": "rdg_gemm_bwd_f32 wgrad",
            "dy_prep_f32_kernel": "rdg_gemm_bwd_f32 dY prep",
            "rdg_layernorm_kernel<float": "rdg_layernorm_f32",
            "rdg_layernorm_bwd_kernel<float": "rdg_layernorm_bwd_f32",
            "window_attention_f32_kernel": "window_attention_f32",
            "attn_bwd_f32_kernel": "window_attention_bwd_f32",
            "attn_bwd16_dq_f32_kernel": "window_attention_bwd_f32 dq",
            "attn_bwd16_dkv_f32_kernel": "window_attention_bwd_f32 dkv"}
    fams.update({"dgrad_kernel": "rdg_gemm_bwd dgrad",
                 "wgrad_kernel": "rdg_gemm_bwd wgrad",
                 "dy_prep_kernel": "rdg_gemm_bwd dY prep",
                 "sum_partials_kernel": "partial sums (d, e, f)"})
    fams.update({f"{k}_kernel": k for k in KERNELS + BWD_KERNELS[1:]})
    # 16x16 windows: (c)'s kernel and (f)'s two launches; 4x4: (c), (f)
    fams.update({"window_attention16_kernel": "window_attention",
                 "window_attention_bwd16_dq_kernel": "window_attention_bwd dq",
                 "window_attention_bwd16_dkv_kernel":
                     "window_attention_bwd dkv",
                 "window_attention4_kernel": "window_attention",
                 "window_attention_bwd4_kernel": "window_attention_bwd"})
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


def sdpa_bwd_ms(sdpa, launched, runs: int = 20, capture: bool = True):
    """(ms, how) of the SDPA backward of one RDG's five attentions, the
    library call beside kernel (f): replayed as a CUDA graph, its forward
    captured first into a graph of its own on the same stream and pool (as
    ``torch.cuda.make_graphed_callables`` does), so that autograd runs the
    backward on the capturing stream; where capture fails, or without
    ``capture`` (a failed capture leaves the default CUDA generator unable
    to draw: "Offset increment outside graph capture"), the median of
    ``runs`` launched runs of ``launched``, with their spread."""
    def forward():
        return [F.scaled_dot_product_attention(*ins, attn_mask=term)
                for _, ins, _, term in sdpa]

    def backward(outs):
        for o, (_, ins, do, _) in zip(outs, sdpa):
            torch.autograd.grad(o, ins, do)

    try:
        if not capture:
            raise RuntimeError("not asked to capture")
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
        why = (f"; graph capture failed: {str(err).splitlines()[0][:160]}"
               if capture else "")
        return times[runs // 2], (
            f"launched, median of {runs} runs (min {times[0]:.4f}, max "
            f"{times[-1]:.4f} ms){why}")


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

    step_ms = cuda_ms(train_step, iters=TRAIN_TIMED, warmup=2)
    fwd_ms = cuda_ms(forward_only, iters=TRAIN_TIMED, warmup=1)
    fb_ms = cuda_ms(forward_backward, iters=TRAIN_TIMED, warmup=1)
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
    """Synthetic grid images with the port's PNG writer: HR and, as the prep
    tool lays it out, its LANCZOS LR at 1 / SCALE under ``LR_{SCALE}``."""
    (base / "HR").mkdir(parents=True)
    (base / f"LR_{SCALE}").mkdir(parents=True)
    kinds = ("blob", "scratch")
    for i in range(n):
        img = grid_texture(rng, hr)
        if defect:
            img = inject_defect(rng, img, kinds[i % 2])
        write_png(base / "HR" / f"{i:03d}.png", img)
        write_png(base / f"LR_{SCALE}" / f"{i:03d}.png",
                  lr_from_hr(img, SCALE))


HEATMAPS_PER_SPLIT = 16     # save_heatmaps' max_images, as the JAX package
# a heatmap's 1-SSIM panel, decoded, against its CPU recompute from the same
# uint8 pair: every pixel at most one table index apart, and at least this
# share equal
HEATMAP_EQUAL = 0.99


def eval_hr_u8(exp, data_root: Path, classe: str, split: str):
    """The HR of ``{data_root}/{classe}/test/{split}`` as ``evaluate_anomaly``
    scores it (read to floats, then the truncating uint8 conversion), and
    the file stems."""
    scale = max(exp.data.scale)
    ds = load_sr_dataset(str(data_root / classe / "test" / split), (scale,),
                         exp.data.n_colors, exp.data.rgb_range)
    hr = np.clip(ds.hr * (255.0 / exp.data.rgb_range), 0, 255).astype(np.uint8)
    return hr, ds.filenames


def check_figures(exp, out_dir: Path, data_root: Path, classe: str,
                  res: dict) -> dict:
    """``cli.evaluate``'s figures in ``out_dir``: ``roc_curve.pdf`` and, a
    split, min(HEATMAPS_PER_SPLIT, n) heatmaps named as the split's first
    images; the first heatmap of each split decoded, its 1-SSIM panel held to
    a CPU recompute from the same uint8 pair (the saved SR, the HR as the
    evaluation read it) at the best window. Returns the figure step's wall
    and each split's panel agreement."""
    roc = (out_dir / "roc_curve.pdf").read_bytes()
    if not roc.startswith(b"%PDF-1.4") or not roc.endswith(b"%%EOF\n"):
        raise AssertionError(f"{out_dir}/roc_curve.pdf is not a whole PDF")
    scale, ws = max(exp.data.scale), res["best_ws"]
    agreement = {}
    for split in ("good", "bad"):
        names = [f for f, s in zip(res["filenames"], res["splits"])
                 if s == split][:HEATMAPS_PER_SPLIT]
        got = sorted(p.stem for p in (out_dir / "heatmaps" / split)
                     .glob("*.png"))
        if got != sorted(names):
            raise AssertionError(f"{out_dir}/heatmaps/{split}: {got}, "
                                 f"expected {names}")
        hr, stems = eval_hr_u8(exp, data_root, classe, split)
        hr = hr[stems.index(names[0])]
        sr = read_png(out_dir / split / f"x{scale}" / f"{names[0]}.png")
        sr = sr.reshape(hr.shape)
        want = lut_indices(one_minus_ssim(hr[None], sr[None], ws, "cpu")[0])
        fig = read_png(out_dir / "heatmaps" / split / f"{names[0]}.png")
        equal, near = index_agreement(
            heatmap_panel(fig, hr.shape[0], hr.shape[1], ws, 2), want)
        agreement[split] = equal
        if not near or equal < HEATMAP_EQUAL:
            raise AssertionError(
                f"heatmap {split}/{names[0]}: 1-SSIM panel against the CPU "
                f"recompute: {equal:.6f} of the pixels equal (limit "
                f"{HEATMAP_EQUAL}), every pixel within one index: {near}")
    say("figures", f"{out_dir}: roc_curve.pdf and {len(res['filenames'])} "
                   f"images' heatmaps (at most {HEATMAPS_PER_SPLIT} a split) "
                   f"in {res['figures_s']:.3f} s; each split's first "
                   f"heatmap's 1-SSIM panel (ws={ws}) against its CPU "
                   f"recompute: share of pixels equal {agreement}, every "
                   "pixel within one table index")
    return {"figures_s": res["figures_s"], "ssim_panel_equal": agreement}


def check_run_dir_plots(run: Path, keys) -> list:
    """The run dir's ``loss_{k}.pdf`` for every loss term of its history
    (``keys`` among them) and, after a validation test,
    ``test_{data_test}_psnr_ssim.pdf``: whole PDFs. Returns their names."""
    losses = json.loads((run / "loss_log.json").read_text())
    history = json.loads((run / "psnr_ssim_log.json").read_text())
    want = {f"loss_{k}.pdf" for k in losses[0]}
    got = sorted(p.name for p in run.glob("*.pdf"))
    psnr = [n for n in got if n.startswith("test_")
            and n.endswith("_psnr_ssim.pdf")]
    whole = all((run / n).read_bytes().endswith(b"%%EOF\n") for n in got)
    if not set(keys) <= set(losses[0]) or set(got) != want | set(psnr) \
            or len(psnr) != (1 if history else 0) or not whole:
        raise AssertionError(f"run dir {run}: PDFs {got}, loss terms "
                             f"{sorted(losses[0])}, {len(history)} tests")
    return got


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
    plots = check_run_dir_plots(run, ("total",))

    results, walls, launches, figures = {}, {}, {}, {}
    # cli.evaluate serves through one CUDA graph per LR shape (both splits
    # pad to the batch: one shape): its warm-up and its capture count one
    # forward's launches each, its replays none
    n_fwd = min(2 * math.ceil(CLI_TEST / CLI_BATCH), 2)
    for mode in modes:
        flag = "1" if mode == "rdg" else "0"
        os.environ["ADSR_TPU_RDG"] = flag
        reset_counts()
        t0 = time.perf_counter()
        # the bf16 kernels (block mode has no f32 kernel (g));
        # phase_fp32 runs the CLI at its fp32 default
        res = cli_eval.main(["--run-dir", run_dir, "--data-root", str(root),
                             "--precision", "bf16", "--sweep-windows", "9",
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
        figures[mode] = check_figures(exp, cli_dir / f"eval_{mode}", root,
                                      "grid", res)
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
                                         mode=mode, graphs=False)
        ms = cuda_ms(lambda: fwd(lr), iters=3, warmup=1)
        tiled[mode] = {"ms": ms, "img_per_s": lr.shape[0] * 1e3 / ms,
                       "tiles_per_image": n_tiles}
        say("cli", f"tiled serving, {mode} mode: {lr.shape[0]} images of "
                   f"{CLI_TEST_HR} px ({n_tiles} tiles of {tile} LR px each, "
                   f"one forward of {n_tiles * lr.shape[0]} tiles) in "
                   f"{ms:.3f} ms = {tiled[mode]['img_per_s']:.1f} img/s")
    report["cli"] = {"train_wall_s": train_wall,
                     "train_launches": train_launches, "run_dir_pdfs": plots,
                     "eval_wall_s": walls, "eval_launches": launches,
                     "figures": figures,
                     "aucs": {m: [r["auc_ssim"], r["auc_mse"], r["auc_psnr"]]
                              for m, r in results.items()},
                     "specificity": {m: r["specificity"]
                                     for m, r in results.items()},
                     "score_diff_block_vs_rdg": diff, "tiled": tiled}
    return {"train_cli": train_launches,
            **{f"evaluate_cli_{m}": launches[m] for m in modes}}


# --------------------------------------------------------------------------- #
# Serving through CUDA graphs (core/graphs.py): replays against the launched
# route bit for bit, launch counts, memory, and graphs against launched
# --------------------------------------------------------------------------- #

GRAPH_TURNS = 2      # A/B turns; the routes' order alternates turn by turn
GRAPH_CALLS = 10     # timed calls a turn of a forward or a scoring call


def host_ms(fn, calls: int) -> list:
    """Host wall ms of each of ``calls`` calls of ``fn``, each ended by a
    synchronize: the latency a caller sees."""
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def ab_turns(routes: dict, calls: int, turns: int = GRAPH_TURNS) -> dict:
    """{route: the median of each turn's calls (ms), and their median,
    least and most}: the routes timed in turns, in the order a b, b a, ..."""
    names = list(routes)
    per = {k: [] for k in names}
    for t in range(turns):
        for k in (names if t % 2 == 0 else names[::-1]):
            per[k].append(statistics.median(host_ms(routes[k], calls)))
    return {k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                "turns": v} for k, v in per.items()}


def ab_text(ab: dict, batch: int = 0) -> str:
    """'graphs 10.7 ms [10.6, 10.8]; launched ...' (img/s too with a
    batch)."""
    def one(v):
        text = f"{v['median']:.3f} ms [{v['min']:.3f}, {v['max']:.3f}]"
        if batch:
            text += f" = {batch * 1e3 / v['median']:.1f} img/s"
        return text
    return "; ".join(f"{k} {one(v)}" for k, v in ab.items())


def check_replays(label: str, graphed, launched, inputs: list, per: dict,
                  report: dict) -> dict:
    """``graphed`` (a ``CapturedCall``) on ``inputs`` (one shape): its
    warm-up and its capture count one call's ``per`` launches each, its
    replays none; each result equals ``launched``'s on the same input bit
    for bit, after every later replay. Returns the launches."""
    reset_counts()
    outs = []
    for i, x in enumerate(inputs):
        outs.append(graphed(x))
        torch.cuda.synchronize()
        got, want = counts(), expected_counts(per, min(i + 1, 2))
        if got != want:
            raise AssertionError(f"{label}: launches {got} after call {i + 1}"
                                 f", expected {want}")
    launches = counts()
    check_operand_paths(f"{label}_graphs", launches, report)
    if graphed.captured() != 1:
        raise AssertionError(f"{label}: {graphed.captured()} graphs for one "
                             "input shape")
    for i, (x, got) in enumerate(zip(inputs, outs)):
        want = launched(x)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{label}: call {i + 1} differs from the launched route by "
                f"up to {(got - want).abs().max().item():.3e}")
    mib = graphed.reserved_bytes() / 2 ** 20
    say("graphs", f"{label}: {len(inputs)} calls at {tuple(inputs[0].shape)}"
                  f": warm-up and capture launched {launches}, the "
                  f"{len(inputs) - 2} calls after the capture added 0; every "
                  f"result bitwise "
                  f"equal to the launched route's; the capture reserved "
                  f"{mib:.1f} MiB")
    report.setdefault("graphs", {})[label] = {
        "launches": launches, "replays": len(inputs) - 2,
        "reserved_mib": mib, "bitwise_equal": True}
    return launches


def forward_inputs(x: torch.Tensor) -> list:
    """Four inputs of ``x``'s shape: itself, mirrored in each axis and
    rolled over the batch."""
    return [x, x.flip(1), x.flip(2), x.roll(1, 0)]


def check_server_graphs(exp, dev, params, lr_u8, hr_u8, mode, report,
                        label: str, per=None):
    """``AnomalyServer`` scores ``lr_u8`` / ``hr_u8`` (tail padded) through
    its captured call and launched: the capture's launches (``per`` a
    forward, by default ``mode``'s bf16 ones), scores equal bit for bit
    (twice, so every batch replays once). Returns (launches, graphed
    server, launched server)."""
    if per is None:
        per = PER_FORWARD if mode == "rdg" else PER_FORWARD_BLOCK
    servers = {}
    for graphs in (True, False):
        servers[graphs] = AnomalyServer(batch_size=BATCH, ssim_window=11,
                                        device=dev, graphs=graphs)
        servers[graphs].register("grid", exp, params, mode=mode)
    n_calls = math.ceil(len(lr_u8) / BATCH)
    reset_counts()
    first = servers[True].score("grid", lr_u8, hr_u8)
    torch.cuda.synchronize()
    after_first = counts()
    again = servers[True].score("grid", lr_u8, hr_u8)
    torch.cuda.synchronize()
    launches = counts()
    if after_first != expected_counts(per, min(n_calls, 2)) \
            or launches != expected_counts(per, 2):
        raise AssertionError(f"{label}: launches {after_first} after "
                             f"{n_calls} calls, {launches} after "
                             f"{2 * n_calls}")
    check_operand_paths(label, launches, report)
    want = servers[False].score("grid", lr_u8, hr_u8)
    for got in (first, again):
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: scores differ from the launched "
                                 f"route by {np.abs(got - want).max(0)}")
    entry = servers[True]._entries["grid"]
    mib = entry.reserved_bytes() / 2 ** 20
    say("graphs", f"{label}: AnomalyServer ({mode} mode) scored "
                  f"{len(lr_u8)} requests twice ({n_calls} calls a time, one "
                  f"shape): launches {launches} (warm-up and capture), "
                  f"{2 * n_calls - 2} replays added 0; scores bitwise equal "
                  f"to the launched route's; the capture reserved "
                  f"{mib:.1f} MiB")
    report.setdefault("graphs", {})[label] = {
        "launches": launches, "calls": 2 * n_calls, "reserved_mib": mib,
        "bitwise_equal": True}
    return launches, servers[True], servers[False]


def phase_graphs(exp, dev, params, lr_u8, hr_u8, report, cli_dir=CLI_DIR,
                 overlap=8, suffix=""):
    """Serving through CUDA graphs, the defaults of the entry points: for
    the forward of ``make_serving_forward`` (both modes),
    ``AnomalyServer`` (both modes, the requests of the main phase with their
    padded tail) and ``make_tiled_serving_forward`` on 16 LR images of 512
    px HR, replays against the launched route (``graphs=False``) bit for
    bit with the launch counts of :func:`check_replays`; then graphs
    against launched in turns (host clock): the forward, request latency
    (16 requests), tiled img/s and ``evaluate_anomaly`` (the core of
    ``cli.evaluate``) on the CLI phase's data root. Returns launches by
    path."""
    cfg = exp.model
    rgb = exp.data.rgb_range
    scale = cfg.upscale
    paths, timing = {}, {}
    x = torch.as_tensor(to_float(lr_u8[:BATCH], cfg.in_chans, rgb),
                        dtype=torch.float32, device=dev)
    for mode in ("rdg", "block"):
        per = PER_FORWARD if mode == "rdg" else PER_FORWARD_BLOCK
        fwd = {g: make_serving_forward(exp, params, dev, mode=mode, graphs=g)
               for g in (True, False)}
        check_replays(f"forward_{mode}", fwd[True], fwd[False],
                      forward_inputs(x), per, report)
        ab = ab_turns({"graphs": lambda: fwd[True](x),
                       "launched": lambda: fwd[False](x)}, GRAPH_CALLS)
        say("graphs", f"{mode}-mode forward through make_serving_forward, "
                      f"batch {BATCH}, host clock, median [least, most] of "
                      f"{GRAPH_TURNS} turns: {ab_text(ab, BATCH)}")
        timing[f"forward_{mode}"] = ab
        del fwd
        launches, s_g, s_l = check_server_graphs(
            exp, dev, params, lr_u8, hr_u8, mode, report,
            f"serving{'' if mode == 'rdg' else '_block'}_graphs")
        paths[f"serving{'' if mode == 'rdg' else '_block'}_graphs{suffix}"] \
            = launches
        req = (lr_u8[:BATCH], hr_u8[:BATCH])
        ab = ab_turns({"graphs": lambda: s_g.score("grid", *req),
                       "launched": lambda: s_l.score("grid", *req)},
                      GRAPH_CALLS)
        say("graphs", f"{mode}-mode request latency, AnomalyServer.score of "
                      f"{BATCH} uint8 requests, host clock: {ab_text(ab)}")
        timing[f"request_{mode}"] = ab
        del s_g, s_l

    # tiled serving of 16 images of 512 px, as cli.evaluate serves them
    rng = np.random.RandomState(SEED + 30)
    lr_t, _ = synthetic_split(rng, BATCH // 2, BATCH // 2, CLI_TEST_HR, scale)
    xt = torch.as_tensor(to_float(lr_t, cfg.in_chans, rgb),
                         dtype=torch.float32, device=dev)
    tiled = {g: make_tiled_serving_forward(exp, params, overlap=overlap,
                                           quantize_out=False, device=dev,
                                           mode="rdg", graphs=g)
             for g in (True, False)}
    n_tiles = len(tile_starts(xt.shape[1], cfg.img_size, overlap)) ** 2
    check_replays("tiled", tiled[True], tiled[False], forward_inputs(xt)[:3],
                  PER_FORWARD, report)
    ab = ab_turns({"graphs": lambda: tiled[True](xt),
                   "launched": lambda: tiled[False](xt)}, 2)
    say("graphs", f"tiled serving, rdg mode, {BATCH} images of {CLI_TEST_HR} "
                  f"px ({n_tiles} tiles of {cfg.img_size} LR px each, one "
                  f"forward of {n_tiles * BATCH} tiles): {ab_text(ab, BATCH)}")
    timing["tiled"] = ab
    del tiled

    # the evaluate CLI's core on its data root, one call a turn: a new
    # captured call each evaluation (warm-up, capture, replays)
    root = cli_dir / "data"
    results = {}

    def evaluate(graphs):
        results[graphs] = evaluate_anomaly(
            exp, params, str(root), "grid",
            out_dir=str(cli_dir / f"graphs_eval_{graphs}"), batch=CLI_BATCH,
            device=dev, log=lambda s: None, tile_overlap=overlap,
            sweep_windows=9, mode="rdg", graphs=graphs)

    ab = ab_turns({"graphs": lambda: evaluate(True),
                   "launched": lambda: evaluate(False)}, 1)
    for k in ("scores_ssim", "scores_mse", "scores_psnr"):
        if results[True][k] != results[False][k]:
            raise AssertionError(f"evaluate_anomaly: {k} differ between "
                                 "graphs and launched")
    say("graphs", f"evaluate_anomaly (cli.evaluate's core: {2 * CLI_TEST} "
                  f"PNGs of {CLI_TEST_HR} px, tiled, the 9-window sweep, "
                  f"images written), rdg mode, wall: {ab_text(ab)}; scores "
                  "equal")
    timing["evaluate"] = ab
    report.setdefault("graphs", {})["timing"] = timing
    return paths


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
    graph_paths = phase_graphs(exp, dev, params, lr_u8, hr_u8, r16,
                               W16_CLI_DIR, overlap=0, suffix="_w16")
    x8 = phase_x8(dev, r16.setdefault("x8", {}))
    phase_ln_layouts(cfg, dev, check)
    paths = {"serving_w16": serving, "serving_block_w16": serving_block,
             "train_w16": train, "train_cli_w16": cli["train_cli"],
             "evaluate_cli_w16": cli["evaluate_cli_rdg"],
             "evaluate_cli_block_w16": cli["evaluate_cli_block"],
             **graph_paths, **x8}
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


W4_CLI_DIR = Path("workspace") / "chip_smoke_w4"


def phase_w4(dev, report):
    """The window-4 geometry (4x4 windows, N = 16 keys a window) at full
    width: ``drct_experiment("grid", 64, 4)`` (LR 16 x 16, shifts 0 and 2,
    M = 4,096 token rows a batch of 16) through the same checks as the
    flagship (launch plans; kernels (a)-(c) and (g) against their plain
    versions, also at batch 5 on 20 x 20 tokens; serving RDG by RDG in both
    modes; timing; kernels (d)-(f); one RDG's gradients; the Trainer; the
    CLIs; the graphs), then 128/x8 (four train steps too) and 32/x2 on the
    same tokens. Its lines read "[w4] ...". Returns (launches by main path,
    timings)."""
    global PREFIX
    PREFIX = "w4"
    r4 = report.setdefault("w4", {})
    exp = drct_experiment("grid", 64, 4, precision="bf16",
                          batch_size=BATCH, run_tag="chip_smoke_w4")
    cfg = exp.model
    check = Checker()
    print_plans(cfg, r4)
    phase_kernels(cfg, dev, check)
    phase_swin_block(cfg, dev, check)
    params, packed, x, model, server, lr_u8, hr_u8 = phase_serving(exp, dev,
                                                                   r4)
    serving = r4["main_path_launches"]
    serving_block = r4["main_path_launches_block"]
    timings = phase_timing(exp, dev, packed, x, model, server, lr_u8, hr_u8,
                           r4)
    timings.update(phase_block_timing(exp, dev, packed, x, r4))
    del model, server, packed
    bwd_inputs = phase_bwd_kernels(cfg, dev, check)
    say("kernels", f"{check.cases} cases within tolerance; max abs error "
                   f"{check.max_abs}")
    r4["max_abs_err"] = check.max_abs
    phase_rdg(exp, dev, r4)
    trainer, lrs, hr, train = phase_train(exp, dev, r4)
    timings.update(phase_train_timing(exp, dev, trainer, lrs, hr, bwd_inputs,
                                      r4))
    del trainer, bwd_inputs
    cli = phase_cli(exp, dev, r4, W4_CLI_DIR, ("rdg", "block"), overlap=0)
    graph_paths = phase_graphs(exp, dev, params, lr_u8, hr_u8, r4,
                               W4_CLI_DIR, overlap=0, suffix="_w4")
    tails = {**phase_x8(dev, r4.setdefault("128x8", {}), 128, 8, 4,
                        "_128x8", PER_TRAIN_STEP, 1),
             **phase_x8(dev, r4.setdefault("32x2", {}), 32, 2, 0, "_32x2")}
    phase_ln_layouts(cfg, dev, check)
    paths = {"serving_w4": serving, "serving_block_w4": serving_block,
             "train_w4": train, "train_cli_w4": cli["train_cli"],
             "evaluate_cli_w4": cli["evaluate_cli_rdg"],
             "evaluate_cli_block_w4": cli["evaluate_cli_block"],
             **graph_paths, **tails}
    # (c) on both paths, (f) on the training path and (g) on the block-mode
    # paths went through N = 16
    for path, k in (("serving_w4", "window_attention"),
                    ("train_w4", "window_attention"),
                    ("train_w4", "window_attention_bwd"),
                    ("serving_block_w4", "swin_block"),
                    ("evaluate_cli_block_w4", "swin_block"),
                    ("serving_block_128x8", "swin_block"),
                    ("serving_block_32x2", "swin_block"),
                    ("train_128x8", "window_attention_bwd")):
        if not paths[path][k]:
            raise AssertionError(f"{path}: {k} launched no time")
    PREFIX = None
    return paths, timings


# --------------------------------------------------------------------------- #
# The user's whole path from raw images: cli.smoke (prepare -> train ->
# evaluate, each step a process of its own)
# --------------------------------------------------------------------------- #

SMOKE_DIR = Path("workspace") / "chip_smoke" / "smoke"
SMOKE_ARGS = ["--workdir", str(SMOKE_DIR), "--resolution", str(HR),
              "--full-size", "--epochs", "1", "--device", DEVICE]
# cli.prepare's split of the 24 + 6 + 2 x 3 synthetic grid images (val 0.1)
SMOKE_SPLITS = {"train/good": 22, "val/good": 2, "test/good": 6,
                "test/bad": 6}


def phase_smoke(dev, report):
    """``python -m adsr_tpu_torch.cli.smoke --workdir workspace/chip_smoke/
    smoke --resolution 128 --full-size --epochs 1 --device cuda``, run as
    ``cli.smoke.main`` with those flags: ``cli.prepare`` writes the
    synthetic MVTec grid source (256 px) and its LANCZOS tree at 128 px (LR_2
    and LR_4), ``cli.main`` trains the flagship at full width (27.4M
    params, 12 RDGs at embed 180, window 8) one epoch of 64 steps at batch 4
    through kernels (a)-(f), then ``cli.evaluate`` scores the 6 + 6 test
    images through (a)-(c). Each step is a process of its own (a grandchild
    of this script), so its kernel launches are counted there and not here:
    this phase adds no launches to the kernels line. Checks the prepared
    tree (counts, sizes, every LR the LANCZOS resize of its HR), the train
    log (the card, the flagship's parameter count, a whole epoch and the
    seconds its steps took), the checkpoint and the AUCs; a failed step exits this process non-zero. Returns ({}, {})."""
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    res = cli_smoke.main(SMOKE_ARGS)
    wall = time.perf_counter() - t0
    data = SMOKE_DIR / "data" / f"mvtec_{HR}" / "grid"
    for split, n in SMOKE_SPLITS.items():
        names = sorted(p.name for p in (data / split / "HR").glob("*.png"))
        if len(names) != n:
            raise AssertionError(f"smoke: {split} has {len(names)} HR "
                                 f"images, expected {n}")
        for name in names:
            hr = read_png(data / split / "HR" / name)
            for s in (2, 4):
                lr = read_png(data / split / f"LR_{s}" / name)
                if hr.shape != (HR, HR, 3) or \
                        not np.array_equal(lr, lr_from_hr(hr, s)):
                    raise AssertionError(f"smoke: {split}/{name}: HR "
                                         f"{hr.shape}, LR_{s} {lr.shape} "
                                         "is not its LANCZOS resize")
    log = (Path(res["run_dir"]) / "log.txt").read_text()
    n_params = re.search(r"number of parameters is ([0-9.]+)M", log)
    n_params = float(n_params.group(1)) * 1e6 if n_params else 0.0
    # the epoch's last progress line: samples seen, then the seconds spent
    # in the train step and in the sampler
    epoch = re.findall(r"\[(\d+)/(\d+)\]\t.*\t([0-9.]+)\+([0-9.]+)s", log)
    if not epoch or epoch[-1][0] != epoch[-1][1]:
        raise AssertionError(f"smoke: no whole epoch in the train log "
                             f"{log[-2000:]}")
    step_s, data_s = float(epoch[-1][2]), float(epoch[-1][3])
    ckpt = resolve_checkpoint(res["run_dir"])
    aucs = [res["auc_ssim"], res["auc_mse"], res["auc_psnr"]]
    if "Using devices: cuda" not in log \
            or not PARAMS_RANGE[0] < n_params < PARAMS_RANGE[1] \
            or not ckpt.endswith("model_best.pt") \
            or not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs):
        raise AssertionError(f"smoke: params {n_params}, checkpoint {ckpt}, "
                             f"AUCs {aucs}, log {log[-2000:]}")
    walls = res["walls_s"]
    run = Path(res["run_dir"])
    plots = check_run_dir_plots(run, ("total",))
    say("smoke", f"run dir {run.name}: {plots}")
    # the evaluation's figures, then the disk sweep over its saved SR
    # folders against the HR as the evaluation read it (the prepared tree's
    # HR is RGB; the flagship scores its Y channel, truncated to uint8)
    ev = json.loads((SMOKE_DIR / "smoke_eval.json").read_text())
    exp = drct_experiment("grid", HR, SCALE)
    root = SMOKE_DIR / "data" / f"mvtec_{HR}"
    out_dir = run / "eval_results"
    figures = check_figures(exp, out_dir, root, "grid", ev)
    hr_dir = SMOKE_DIR / "hr_eval"
    for split in ("good", "bad"):
        hr, stems = eval_hr_u8(exp, root, "grid", split)
        (hr_dir / split).mkdir(parents=True, exist_ok=True)
        for img, name in zip(hr, stems):
            write_png(hr_dir / split / f"{name}.png", img)
    t0 = time.perf_counter()
    sweep = analyze_window_sizes(
        str(out_dir / "good" / f"x{SCALE}"), str(hr_dir / "good"),
        str(out_dir / "bad" / f"x{SCALE}"), str(hr_dir / "bad"),
        device=DEVICE)
    sweep_wall = time.perf_counter() - t0
    sweep_aucs = [sweep["auc_ssim"], sweep["auc_mse"], sweep["auc_psnr"]]
    say("smoke", f"analyze_window_sizes on the card over {out_dir.name}/"
                 f"{{good,bad}}/x{SCALE} and {hr_dir.name}/{{good,bad}}: best "
                 f"window {sweep['best_ws']}, AUC ssim/mse/psnr "
                 + "/".join(f"{a:.6f}" for a in sweep_aucs)
                 + f" in {sweep_wall:.3f} s; cli.evaluate's: best window "
                 f"{ev['best_ws']}, AUC ssim/mse/psnr "
                 + "/".join(f"{ev[k]:.6f}" for k in
                            ("auc_ssim", "auc_mse", "auc_psnr")))
    if sweep["best_ws"] != ev["best_ws"] \
            or sweep["auc_ssim"] != ev["auc_ssim"] \
            or sweep["names"] != ev["filenames"]:
        raise AssertionError(f"analyze_window_sizes {sweep} against "
                             f"cli.evaluate's {ev}")
    say("smoke", f"cli.smoke {' '.join(SMOKE_ARGS)}: prepare "
                 f"{walls['prepare']:.1f} s, train {walls['train']:.1f} s, "
                 f"evaluate {walls['evaluate']:.1f} s wall ({wall:.1f} s in "
                 f"all); the epoch's {epoch[-1][0]} samples: {step_s:.1f} s "
                 f"in the train step, {data_s:.1f} s in the sampler; "
                 f"{n_params / 1e6:.2f}M params; AUC ssim/mse/psnr "
                 f"{aucs[0]:.4f}/{aucs[1]:.4f}/{aucs[2]:.4f}")
    report["smoke"] = {"args": SMOKE_ARGS, "walls_s": walls, "wall_s": wall,
                       "epoch_step_s": step_s, "epoch_data_s": data_s,
                       "params": n_params, "aucs": aucs,
                       "run_dir_pdfs": plots, "figures": figures,
                       "analyze_window_sizes": {
                           "best_ws": sweep["best_ws"], "aucs": sweep_aucs,
                           "wall_s": sweep_wall}}
    return {}, {}


# --------------------------------------------------------------------------- #
# DRN-L x4 @128px with its dual models: the model, dual-regression training,
# AnomalyServer beside a DRCT class, tiled evaluation and cli.smoke. DRN's
# convolutions, bicubic products and pixel shuffles are cuDNN / PyTorch, as
# the JAX package computes them in XLA: no kernel of the port is on its path
# --------------------------------------------------------------------------- #

DRN_PARAMS = 9_821_907        # the grid model (1 channel)
DRN_DUAL_PARAMS = 720         # its two dual models
DRN_RGB_PARAMS = 9_825_893    # the carpet twin (3 channels)
DRN_STEP_REL = 1.5e-2         # bf16 against f32: each loss term of a step
DRN_STEPS = 20
DRN_EVAL_DIR = Path("workspace") / "chip_smoke" / "drn"
DRN_TEST = 8                  # good and as many defective 512 px images
DRN_SMOKE_DIR = Path("workspace") / "chip_smoke" / "drn_smoke"
DRN_SMOKE_ARGS = ["--model-type", "drn-l", "--workdir", str(DRN_SMOKE_DIR),
                  "--resolution", str(HR), "--epochs", "1", "--device",
                  DEVICE]


def conv_flops(module, run) -> int:
    """The multiply-adds x 2 of every convolution of ``module`` while
    ``run()`` runs, counted from the shapes by forward hooks (for DRN-L the
    bicubic products, the CALayers' means and the elementwise work are left
    out: under 1%)."""
    total = [0]

    def hook(mod, inputs, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()
    return total[0]


def flat_grads(modules) -> torch.Tensor:
    return torch.cat([p.grad.flatten() for m in modules
                      for p in m.parameters()])


def phase_drn(dev, report):
    """DRN-L x4 @128px (``drn_experiment("grid", 128, 4)``: scales (2, 4),
    40 RCABs an up phase at 20 features, 9.82M params; random weights from
    the seed; bf16) at batch 16 on synthetic grid images whose LR pyramid
    (LR_4, LR_2) is the prep's LANCZOS: the bf16 forward against the eager
    f32 forward (TF32 off), SR by SR; one dual-regression train step in
    bf16 against f32 from the same state (loss terms, gradients); 20 steps
    on one batch; ``AnomalyServer`` with the flagship DRCT grid class and a
    full-width DRN-L carpet class (3 channels), 16 + 16 + 5 requests each,
    every captured replay bitwise equal to the launched route;
    ``evaluate_anomaly`` on 512 px test images (auto-tiled at 32 LR px);
    ``cli.smoke --model-type drn-l``; the forward and step times. Every
    part but the DRCT class runs with the launch counters at 0 and must
    leave them there: the "drn" path of the kernels line. Returns (launches
    by path, {})."""
    t_phase = time.perf_counter()
    exp = drn_experiment("grid", HR, SCALE, precision="bf16",
                         batch_size=BATCH, run_tag="chip_smoke_drn")
    cfg = exp.model
    params, dual_sds = init_sr_params(
        cfg, torch.Generator().manual_seed(SEED + 30), device=dev)
    n_params = sum(v.numel() for v in params.values())
    n_dual = sum(v.numel() for d in dual_sds for v in d.values())
    say("drn", f"DRN-L x{cfg.max_scale} @{HR}px: scales {cfg.scale}, "
               f"{cfg.n_blocks} RCABs an up phase, {cfg.n_feats} features, "
               f"{n_params} params ({n_params / 1e6:.2f}M) + {n_dual} in "
               f"{len(dual_sds)} duals, {exp.precision}")
    if n_params != DRN_PARAMS or n_dual != DRN_DUAL_PARAMS:
        raise AssertionError(f"DRN params {n_params} + {n_dual}, expected "
                             f"{DRN_PARAMS} + {DRN_DUAL_PARAMS}")
    drn_launches = {k: 0 for k in (*WRAPPERS, *F32_WRAPPERS)}

    def counted(fn):
        """``fn()`` with the counters from 0; its launches join the drn
        path's."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in counts().items():
            drn_launches[k] += v
        return out

    rng = np.random.RandomState(SEED + 31)
    hr_u8 = np.stack([grid_texture(rng, HR) for _ in range(BATCH)])
    lrs = [torch.as_tensor(to_float(np.stack([lr_from_hr(im, s)
                                              for im in hr_u8]), 1, 255.0),
                           dtype=torch.float32, device=dev)
           for s in sorted(cfg.scale, reverse=True)]
    hr = torch.as_tensor(to_float(hr_u8, 1, 255.0), dtype=torch.float32,
                         device=dev)

    # the bf16 forward against the eager f32 one (TF32 off), SR by SR
    model = make_model(cfg, dev)
    model.load_state_dict(params)
    model.eval()
    with torch.no_grad():
        sr_b = counted(lambda: model(lrs[0], dtype=torch.bfloat16))
        sr_f = model(lrs[0], dtype=torch.float32)
    errs = [rel_l2(b, f) for b, f in zip(sr_b, sr_f)]
    shapes = [tuple(t.shape) for t in sr_b]
    say("drn", f"forward bf16 vs eager f32 (TF32 off), relative L2 of the "
               f"SRs {shapes}: " + " ".join(f"{e:.3e}" for e in errs))
    if len(errs) != 3 or max(errs) > SR_REL_L2 \
            or not all(torch.isfinite(t.float()).all() for t in sr_b) \
            or shapes[-1] != (BATCH, HR, HR, 1):
        raise AssertionError(f"DRN forward: {shapes}, rel L2 {errs} > "
                             f"{SR_REL_L2} or not finite")
    del sr_b, sr_f

    # one dual-regression step in bf16 and in f32 from the same state
    bundles, states = {}, {}
    for prec in ("bf16", "fp32"):
        bundles[prec] = make_train_step(dataclasses.replace(
            exp, precision=prec), dev)
        state = bundles[prec].init_state(torch.Generator().manual_seed(0))
        state.model.load_state_dict(params)
        for dual, sd in zip(state.duals, dual_sds):
            dual.load_state_dict(sd)
        states[prec] = state
    gen = torch.Generator().manual_seed(SEED + 32)
    step_metrics = {}
    for prec in ("bf16", "fp32"):
        states[prec], m = counted(lambda: bundles[prec].step(
            states[prec], lrs, hr, exp.optim.lr, gen))
        step_metrics[prec] = {k: float(v) for k, v in m.items()}
    terms = {k: abs(step_metrics["bf16"][k] / step_metrics["fp32"][k] - 1)
             for k in ("total", "primary", "dual")}
    grad_err = {
        "primal": rel_l2(flat_grads([states["bf16"].model]),
                         flat_grads([states["fp32"].model])),
        "duals": rel_l2(flat_grads(states["bf16"].duals),
                        flat_grads(states["fp32"].duals))}
    say("drn", f"one step, bf16 vs f32 from the same state: loss terms "
               f"{step_metrics['bf16']} vs {step_metrics['fp32']}, relative "
               f"differences " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in terms.items())
        + f"; gradients' relative L2: primal {grad_err['primal']:.3e}, "
          f"duals {grad_err['duals']:.3e}")
    if max(terms.values()) > DRN_STEP_REL \
            or not all(math.isfinite(v) for v in grad_err.values()):
        raise AssertionError(f"DRN step: loss terms {terms} > "
                             f"{DRN_STEP_REL}, gradients {grad_err}")
    del bundles["fp32"], states["fp32"]

    # 20 steps on one batch (bf16): the loss falls, everything finite
    bundle, state = bundles["bf16"], states["bf16"]

    def steps():
        nonlocal state
        out = []
        for _ in range(DRN_STEPS):
            state, m = bundle.step(state, lrs, hr, exp.optim.lr, gen)
            out.append({k: float(v) for k, v in m.items()})
        return out

    t0 = time.perf_counter()
    losses = counted(steps)
    steps_wall = time.perf_counter() - t0
    totals = [m["total"] for m in losses]
    finite = all(torch.isfinite(p).all() for mod in [state.model,
                                                     *state.duals]
                 for p in mod.parameters())
    drop = totals[0] - totals[-1]
    say("drn", f"{DRN_STEPS} steps on one batch at LR {exp.optim.lr}: total "
               f"{totals[0]:.4f} -> {totals[-1]:.4f} (drop {drop:.4f}, "
               f"{drop / totals[0]:.4f} of the first); primary {losses[0]['primary']:.4f} -> "
               f"{losses[-1]['primary']:.4f}, dual {losses[0]['dual']:.4f} -> "
               f"{losses[-1]['dual']:.4f}; {steps_wall:.2f} s wall")
    if not finite or not all(math.isfinite(v) for v in totals) \
            or not totals[-1] < totals[0]:
        raise AssertionError(f"DRN steps: totals {totals}, params finite "
                             f"{finite}")

    # timings (not claims): the serving forward (make_serving_forward, raw
    # SR) launched and through its CUDA graph, its replays bitwise equal to
    # the launched route; the step and its device idle share
    x = lrs[0]
    flops = conv_flops(model, lambda: model(x, dtype=torch.bfloat16))
    serve = {g: make_serving_forward(exp, params, dev, quantize_out=False,
                                     graphs=g) for g in (True, False)}
    fwd_launched = counted(lambda: cuda_ms(lambda: serve[False](x), 10))
    fwd_graph = counted(lambda: cuda_ms(lambda: serve[True](x), 10))
    for xi in forward_inputs(x):
        if not torch.equal(serve[True](xi), serve[False](xi)):
            raise AssertionError("DRN serving forward: a replay differs "
                                 "from the launched route")
    del serve
    step_fn = lambda: bundle.step(state, lrs, hr, exp.optim.lr, gen)  # noqa
    step_ms = counted(lambda: cuda_ms(step_fn, 5))
    step_wall, fams = profile_steps(step_fn)
    busy = sum(fams.values())
    idle = max(0.0, 1.0 - busy / step_wall)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bound_ms = flops / BF16_TC_FLOPS * 1e3
    say("drn", f"serving forward at batch {BATCH}: {flops / 1e9:.1f} GFLOP "
               f"(bf16 compute bound {bound_ms:.3f} ms); {fwd_launched:.3f} "
               f"ms launched, {fwd_graph:.3f} ms through its CUDA graph "
               f"(CUDA events; {flops / fwd_graph / 1e9:.1f} TFLOP/s), "
               f"replays bitwise equal to the launched route; train step "
               f"{step_ms:.3f} ms (CUDA events), profiled {step_wall:.3f} ms "
               f"with {busy:.3f} ms of device time: idle share {idle:.3f} "
               f"under the profiler, {max(0.0, 1 - busy / step_ms):.3f} "
               f"against the unprofiled step; peak allocated {peak:.2f} GiB")
    del bundle, bundles, states

    # AnomalyServer: the flagship DRCT grid class beside a DRN-L carpet class
    drct = drct_experiment("grid", HR, SCALE, precision="bf16",
                           batch_size=BATCH, run_tag="chip_smoke_drn_server")
    carpet = drn_experiment("carpet", HR, SCALE, precision="bf16",
                            batch_size=BATCH, run_tag="chip_smoke_drn_server")
    drct_params = seeded_params(drct.model, dev)
    carpet_params, _ = init_sr_params(
        carpet.model, torch.Generator().manual_seed(SEED + 33), device=dev)
    n_rgb = sum(v.numel() for v in carpet_params.values())
    if n_rgb != DRN_RGB_PARAMS:
        raise AssertionError(f"carpet DRN params {n_rgb}, expected "
                             f"{DRN_RGB_PARAMS}")
    order = list(range(16)) + list(range(21, 37)) + list(range(16, 21))
    requests = {}
    for name, texture in (("grid", grid_texture), ("carpet", carpet_texture)):
        lr_u8, hr_u8 = synthetic_split(rng, 16 + 5, 16, texture=texture)
        requests[name] = (lr_u8[order], hr_u8[order])   # good, bad, tail
    servers = {}
    for graphs in (True, False):
        servers[graphs] = AnomalyServer(batch_size=BATCH, ssim_window=11,
                                        device=dev, graphs=graphs)
        servers[graphs].register("grid", drct, drct_params, mode="rdg")
        servers[graphs].register("carpet", carpet, carpet_params)
    n_calls = math.ceil(len(order) / BATCH)
    launched = {"carpet": counted(lambda: servers[False].score(
        "carpet", *requests["carpet"]))}
    reset_counts()
    launched["grid"] = servers[False].score("grid", *requests["grid"])
    torch.cuda.synchronize()
    grid_launched = counts()
    if grid_launched != expected_counts(PER_FORWARD, n_calls):
        raise AssertionError(f"two-class server, DRCT class launches "
                             f"{grid_launched}, expected {PER_FORWARD} x "
                             f"{n_calls}")
    # through the captured calls: twice, so every batch replays at least once
    graphed = {"carpet": counted(lambda: [servers[True].score(
        "carpet", *requests["carpet"]) for _ in range(2)])}
    reset_counts()
    graphed["grid"] = [servers[True].score("grid", *requests["grid"])
                       for _ in range(2)]
    torch.cuda.synchronize()
    grid_graphs = counts()
    if grid_graphs != expected_counts(PER_FORWARD, 2):
        raise AssertionError(f"two-class server, DRCT class captured "
                             f"launches {grid_graphs}")
    server_report = {}
    for name in ("grid", "carpet"):
        want = launched[name]
        for got in graphed[name]:
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"two-class server, {name}: a replay differs from the "
                    f"launched route by {np.abs(got - want).max(0)}")
        if want.shape != (len(order), 3) or not np.isfinite(want).all():
            raise AssertionError(f"{name} scores {want.shape} not finite")
        mib = servers[True]._entries[name].reserved_bytes() / 2 ** 20
        means = [want[:16].mean(0).round(5).tolist(),
                 want[16:32].mean(0).round(5).tolist()]
        say("drn", f"AnomalyServer class {name} "
                   f"({'DRCT' if name == 'grid' else 'DRN-L, 3 channels'}): "
                   f"{len(order)} requests in {n_calls} calls, twice through "
                   f"its CUDA graph, every replay bitwise equal to the "
                   f"launched route; mean scores (1-SSIM, MSE, -PSNR) good "
                   f"{means[0]} bad {means[1]}; the capture reserved "
                   f"{mib:.1f} MiB")
        server_report[name] = {"bitwise_equal": True, "reserved_mib": mib,
                               "mean_scores_good_bad": means}
    server_report["grid"]["launches"] = grid_launched
    server_report["grid"]["launches_graphs"] = grid_graphs
    del servers, drct_params, carpet_params

    # evaluate_anomaly on 512 px test images: auto-tiled at 32 LR px
    shutil.rmtree(DRN_EVAL_DIR, ignore_errors=True)
    for split, defect in (("good", False), ("bad", True)):
        write_split(DRN_EVAL_DIR / "grid" / "test" / split, rng, DRN_TEST,
                    CLI_TEST_HR, defect=defect)
    logs = []
    t0 = time.perf_counter()
    res = counted(lambda: evaluate_anomaly(
        exp, params, str(DRN_EVAL_DIR), "grid", out_dir=None,
        save_images=False, batch=CLI_BATCH, device=dev, log=logs.append))
    eval_wall = time.perf_counter() - t0
    aucs = [res["auc_ssim"], res["auc_mse"], res["auc_psnr"]]
    tiled = f"Tiled serving: tile=32 overlap=8 for {CLI_TEST_HR // SCALE}px " \
            "LR input"
    say("drn", f"evaluate_anomaly on {DRN_TEST} + {DRN_TEST} images of "
               f"{CLI_TEST_HR} px: '{tiled}' "
               f"{'logged' if tiled in logs else 'NOT logged'}; AUC "
               f"ssim/mse/psnr {aucs[0]:.4f}/{aucs[1]:.4f}/{aucs[2]:.4f} "
               f"(random weights: only the range is checked), best window "
               f"{res['best_ws']}; {eval_wall:.2f} s wall")
    if tiled not in logs or not all(math.isfinite(a) and 0.0 <= a <= 1.0
                                    for a in aucs):
        raise AssertionError(f"DRN evaluate: logs {logs}, AUCs {aucs}")

    # the user's whole path: cli.smoke --model-type drn-l
    shutil.rmtree(DRN_SMOKE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    smoke = cli_smoke.main(DRN_SMOKE_ARGS)
    smoke_wall = time.perf_counter() - t0
    run_dir = Path(smoke["run_dir"])
    log = (run_dir / "log.txt").read_text()
    epoch = re.findall(r"\[(\d+)/(\d+)\]\t.*\t([0-9.]+)\+([0-9.]+)s", log)
    smoke_aucs = [smoke["auc_ssim"], smoke["auc_mse"], smoke["auc_psnr"]]
    walls = smoke["walls_s"]
    say("drn", f"cli.smoke {' '.join(DRN_SMOKE_ARGS)}: prepare "
               f"{walls['prepare']:.1f} s, train {walls['train']:.1f} s, "
               f"evaluate {walls['evaluate']:.1f} s wall ({smoke_wall:.1f} s "
               f"in all); the epoch's samples {epoch[-1][0] if epoch else '?'}"
               f": {epoch[-1][2] if epoch else '?'} s in the train step; AUC "
               f"ssim/mse/psnr " + "/".join(f"{a:.4f}" for a in smoke_aucs))
    if not (run_dir / "model" / "dual_model_latest.pt").is_file() \
            or "Using devices: cuda" not in log \
            or "number of parameters is 9.82M" not in log \
            or not epoch or epoch[-1][0] != epoch[-1][1] \
            or not all(math.isfinite(a) and 0.0 <= a <= 1.0
                       for a in smoke_aucs):
        raise AssertionError(f"DRN smoke: run dir {run_dir}, AUCs "
                             f"{smoke_aucs}, log {log[-2000:]}")
    smoke_plots = check_run_dir_plots(run_dir, ("total", "primary", "dual"))
    say("drn", f"run dir {run_dir.name}: {smoke_plots}")

    if any(drn_launches.values()):
        raise AssertionError(f"the DRN path launched kernels of the port: "
                             f"{drn_launches}")
    wall = time.perf_counter() - t_phase
    say("drn", f"the DRN path launched none of the port's kernels "
               f"{drn_launches}; phase wall {wall:.1f} s")
    report["drn"] = {
        "params": n_params, "dual_params": n_dual,
        "rel_l2_sr_bf16_vs_f32": errs, "step_terms_bf16": step_metrics["bf16"],
        "step_terms_fp32": step_metrics["fp32"], "step_term_rel": terms,
        "grad_rel_l2": grad_err, "fixed_batch": losses,
        "forward_gflop": flops / 1e9, "forward_bound_ms": bound_ms,
        "forward_ms": {"launched": fwd_launched, "graph": fwd_graph},
        "step_ms": step_ms, "step_profiled_ms": step_wall,
        "step_device_ms": busy, "step_idle_share": idle,
        "peak_allocated_gib": peak, "server": server_report,
        "evaluate": {"aucs": aucs, "best_ws": res["best_ws"],
                     "wall_s": eval_wall},
        "smoke": {"args": DRN_SMOKE_ARGS, "walls_s": walls,
                  "wall_s": smoke_wall, "aucs": smoke_aucs,
                  "run_dir_pdfs": smoke_plots},
        "launches": drn_launches, "wall_s": wall}
    return {"drn": drn_launches, "two_class_server": grid_launched,
            "two_class_server_graphs": grid_graphs}, {}


# --------------------------------------------------------------------------- #
# EfficientAD at full width: the teacher PDN-small (384 channels), the
# student (768) and the autoencoder at 256 px, the student-teacher trainer,
# scratch-teacher distillation and cli.efficientad. The JAX package computes
# it with XLA convolutions (no pallas_call); the port with cuDNN's in f32,
# TF32 off: no kernel of the port is on its path
# --------------------------------------------------------------------------- #

EAD_SIZE = 256
EAD_BATCH = 12                # the CLI's default batch
EAD_CPU_BATCH = 4             # the card-against-CPU comparisons
# parameters: teacher, student, autoencoder, the distillation's oracle
EAD_PARAMS = {"teacher": 2_694_144, "student": 4_267_392,
              "autoencoder": 1_096_320, "oracle": 8_026_624}
EAD_FWD_REL_L2 = 1e-4         # f32 (TF32 off) on the card against the CPU's
EAD_TERM_REL = 1e-4           # each loss term of one f32 step, card vs CPU
# each student and autoencoder gradient leaf after that step, card vs CPU,
# relative L2: the first convolutions' weight gradients, each a sum over
# 4 x 128 x 128 positions taken in another order on each side, read up to
# 1.1e-4 (the other leaves up to 6.4e-5) on an H100 80GB HBM3 at 700 W
EAD_GRAD_REL_L2 = 5e-4
# Adam's first update is lr g / (|g| + eps), g with the weight decay: a sign
# where |g| >> eps, so where g lies within the two sides' f32 noise of 0 the
# update may flip (2 lr apart; one flipped element of a leaf read 2.8e-3 of
# its update's L2). The update is held where g is resolved: where the two
# gradients' difference d moves it by eps d / (|g| (|g| + eps)) <= 1e-5 of
# itself, so the update agrees but for the rounding of p + update
EAD_UPDATE_REL_L2 = 1e-4
EAD_ADAM_EPS = 1e-8
EAD_RESOLVED = 1e-5
EAD_RESOLVED_SHARE = 0.5      # of each network's elements, at the least
EAD_STEPS = 20
EAD_CLI_DIR = Path("workspace") / "chip_smoke" / "ead"
EAD_CLI_SRC = 200             # the synthetic tree's size: the loaders resize
EAD_CLI_ARGS = ["--dataset-path", str(EAD_CLI_DIR / "data"),
                "--subdataset", "grid", "--train-steps", "40",
                "--batch-size", str(EAD_BATCH), "--teacher", "scratch",
                "--distill-steps", "40", "--eval-after", "20",
                "--eval-every", "10", "--output-dir",
                str(EAD_CLI_DIR / "out"), "--device", DEVICE]
EAD_CHECKPOINTS = ("teacher_distilled", "student_tmp", "autoencoder_tmp",
                   "teacher_final", "student_final", "autoencoder_final")


def ead_pair(weights, mean_std, dev, cfg):
    """A trainer on the card and one on the CPU, both from ``weights`` (the
    three networks' state_dicts) and the card's teacher statistics, each
    with a fresh Adam."""
    pair = []
    for d in (dev, torch.device("cpu")):
        tr = EfficientADTrainer(cfg, log=lambda *_: None, device=d)
        for name, sd in weights.items():
            getattr(tr, name).load_state_dict(sd)
        tr.teacher_mean, tr.teacher_std = (t.to(d) for t in mean_std)
        pair.append(tr)
    return pair


def ead_step_state(card, cpu, weights):
    """After one step of ``card`` and ``cpu`` from ``weights``, for the
    student and the autoencoder: the largest relative L2 over their leaves
    of the card's gradient against the CPU's and of its Adam update where
    the gradient is resolved (``EAD_UPDATE_REL_L2``), each as {network:
    [reading, leaf]}, and the share of each network's elements resolved."""
    wd = cpu.cfg.weight_decay
    readings = {"grad": {}, "update": {}}
    resolved = {}
    for name in ("student", "autoencoder"):
        on_cpu = dict(getattr(cpu, name).named_parameters())
        n_res = n_all = 0
        for leaf, p in getattr(card, name).named_parameters():
            q = on_cpu[leaf]
            before = weights[name][leaf].cpu()
            g_card, g_cpu = p.grad.cpu() + wd * before, q.grad + wd * before
            ok = EAD_ADAM_EPS * (g_card - g_cpu).abs() <= EAD_RESOLVED \
                * g_cpu.abs() * (g_cpu.abs() + EAD_ADAM_EPS)
            moved, want = p.detach().cpu() - before, q.detach() - before
            n_res += int(ok.sum())
            n_all += ok.numel()
            for key, v in (("grad", rel_l2(p.grad.cpu(), q.grad)),
                           ("update", rel_l2(moved[ok], want[ok])
                            if ok.any() else 0.0)):
                readings[key].setdefault(name, []).append([v, leaf])
        resolved[name] = n_res / n_all
    # the largest of each, a NaN above every number
    worst = {key: {name: max(got, key=lambda r: (not r[0] <= math.inf,
                                                 r[0]))
                   for name, got in by_net.items()}
             for key, by_net in readings.items()}
    worst["resolved_share"] = resolved
    return worst


def ead_step_flops(trainer, x) -> int:
    """The convolutions' multiply-adds x 2 of one train step without a
    penalty batch on ``x`` ([B, 3, H, W]): the teacher's two forwards; the
    student's two calls, each a forward, a weight gradient and (but for its
    first convolution, whose input needs none) an input gradient, its last
    convolution counted at the half of its channels that call reads; the
    autoencoder's one call alike."""
    t, s, a = trainer.teacher, trainer.student, trainer.autoencoder
    fwd = {k: conv_flops(m, lambda m=m: m(x)) for k, m in (
        ("t", t), ("s", s), ("a", a))}
    first = {k: conv_flops(m[0], lambda m=m: m(x)) for k, m in (
        ("s", s), ("a", a))}
    s_last = conv_flops(s[-1], lambda: s(x))
    return (2 * fwd["t"] + 2 * (3 * (fwd["s"] - s_last // 2) - first["s"])
            + 3 * fwd["a"] - first["a"])


def phase_ead(dev, report):
    """EfficientAD at full width (``EADConfig()``: PDN-small teacher at 384
    channels, student at 768, the autoencoder; 256 px; random weights from
    the seed; f32, TF32 off): the four networks' forwards on the card
    against the CPU on the same weights and inputs; one train step on the
    card against the CPU from the same state and draws, without and with a
    penalty batch (loss terms, gradients, Adam updates); 20 steps on one batch (batch 12); map normalisation,
    ``test_auc`` and ``final_metrics`` on synthetic grid images; the step's
    time and idle share and ``predict_maps``' img/s; ``cli.efficientad
    --teacher scratch`` on a synthetic MVTec tree of 200 px images. Every
    part runs with the launch counters at 0 and must leave them there: the
    "efficientad" path of the kernels line. Returns (launches by path,
    {})."""
    t_phase = time.perf_counter()
    cfg = EADConfig(batch_size=EAD_BATCH, seed=SEED + 40)
    reset_counts()
    trainer = EfficientADTrainer(cfg, log=lambda *_: None, device=dev)
    oracle = init_efficientad_(
        PDN(cfg.out_channels, "medium"),
        torch.Generator().manual_seed(SEED + 41)).to(dev)
    nets = {"teacher": trainer.teacher, "student": trainer.student,
            "autoencoder": trainer.autoencoder, "oracle": oracle}
    n_params = {k: sum(p.numel() for p in m.parameters())
                for k, m in nets.items()}
    say("ead", f"EfficientAD {cfg.model_size} @{cfg.image_size}px, "
               f"{cfg.out_channels} channels, batch {cfg.batch_size}, f32 "
               f"(TF32 off): params {n_params}")
    if n_params != EAD_PARAMS:
        raise AssertionError(f"EfficientAD params {n_params}, expected "
                             f"{EAD_PARAMS}")

    rng = np.random.RandomState(SEED + 42)
    _, hr_u8 = synthetic_split(rng, EAD_BATCH, EAD_BATCH, hr_px=EAD_SIZE)
    test_imgs = hr_u8.astype(np.float32) / np.float32(255.0)
    labels = ["good"] * EAD_BATCH + ["crack"] * EAD_BATCH
    train_imgs, val_imgs = (
        synthetic_split(rng, EAD_BATCH, 0, hr_px=EAD_SIZE)[1]
        .astype(np.float32) / np.float32(255.0) for _ in range(2))
    batch = torch.as_tensor(train_imgs, device=dev)
    trainer.teacher_normalization(train_imgs)

    # the forwards, card against CPU on the same weights and inputs
    x = normalize_imagenet(torch.as_tensor(
        train_imgs[:EAD_CPU_BATCH])).permute(0, 3, 1, 2).contiguous()
    fwd_err = {}
    with torch.no_grad(), full_f32():
        for name, net in nets.items():
            cpu = copy.deepcopy(net).cpu()
            fwd_err[name] = rel_l2(net(x.to(dev)).cpu(), cpu(x))
    say("ead", f"forwards on the card vs the CPU at batch {EAD_CPU_BATCH}, "
               f"relative L2: " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in fwd_err.items())
        + f" (limit {EAD_FWD_REL_L2})")
    if not all(v <= EAD_FWD_REL_L2 for v in fwd_err.values()):
        raise AssertionError(f"EfficientAD forwards {fwd_err} > "
                             f"{EAD_FWD_REL_L2}")
    del oracle, nets

    # one step, card against CPU, from the same state and draws
    weights = {k: {n: v.clone() for n, v in getattr(
        trainer, k).state_dict().items()}
        for k in ("teacher", "student", "autoencoder")}
    mean_std = (trainer.teacher_mean, trainer.teacher_std)
    step_cfg = dataclasses.replace(cfg, batch_size=EAD_CPU_BATCH)
    gen = torch.Generator().manual_seed(SEED + 43)
    small = train_imgs[:EAD_CPU_BATCH]
    pen = test_imgs[-EAD_CPU_BATCH:]
    step_terms, step_rel, step_state = {}, {}, {}
    for label, penalty in (("plain", None), ("penalty", pen)):
        draws = StepDraws.sample(EAD_CPU_BATCH, gen,
                                 penalty=penalty is not None)
        card, cpu = ead_pair(weights, mean_std, dev, step_cfg)
        got = card.train_step(small, small, draws, penalty)
        want = cpu.train_step(small, small, draws, penalty)
        step_terms[label] = {"card": got, "cpu": want}
        step_rel[label] = {k: abs(got[k] / want[k] - 1) for k in want}
        step_state[label] = ead_step_state(card, cpu, weights)
        del card, cpu
    say("ead", f"one step at batch {EAD_CPU_BATCH}, card vs CPU from the "
               f"same state and draws: " + "; ".join(
                   f"{label} {step_terms[label]['card']} vs "
                   f"{step_terms[label]['cpu']}, relative "
                   + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
                   for label, rel in step_rel.items())
        + f" (limit {EAD_TERM_REL})")
    if set(step_rel["penalty"]) != {"total", "hard", "penalty", "ae",
                                    "stae"} \
            or max(v for rel in step_rel.values()
                   for v in rel.values()) > EAD_TERM_REL:
        raise AssertionError(f"EfficientAD step terms {step_rel}")
    say("ead", "after that step, card vs CPU, the largest over each "
               "network's leaves: " + "; ".join(
                   f"{label} gradient relative L2 "
                   + ", ".join(f"{n} {v:.3e} ({leaf})" for n, (v, leaf)
                               in st["grad"].items())
                   + f" (limit {EAD_GRAD_REL_L2}), Adam update relative L2 "
                     f"where g is resolved "
                   + ", ".join(f"{n} {v:.3e} ({leaf})" for n, (v, leaf)
                               in st["update"].items())
                   + f" (limit {EAD_UPDATE_REL_L2}), resolved "
                   + ", ".join(f"{n} {v:.4f}" for n, v
                               in st["resolved_share"].items())
                   + f" of the elements (limit >= {EAD_RESOLVED_SHARE})"
                   for label, st in step_state.items()))
    for st in step_state.values():
        for key, limit in (("grad", EAD_GRAD_REL_L2),
                           ("update", EAD_UPDATE_REL_L2)):
            if not all(v <= limit for v, _ in st[key].values()):
                raise AssertionError(f"EfficientAD step state {key}: "
                                     f"{st[key]} > {limit}")
        if not all(v >= EAD_RESOLVED_SHARE
                   for v in st["resolved_share"].values()):
            raise AssertionError(f"EfficientAD step: resolved "
                                 f"{st['resolved_share']}")

    # the main path with the counters from 0: 20 steps on one batch (one
    # set of draws, so each step sees the same images), then scoring
    reset_counts()
    draws = StepDraws.sample(EAD_BATCH, gen)
    t0 = time.perf_counter()
    losses = [trainer.train_step(batch, batch, draws)
              for _ in range(EAD_STEPS)]
    torch.cuda.synchronize()
    steps_wall = time.perf_counter() - t0
    totals = [m["total"] for m in losses]
    finite = all(torch.isfinite(p).all() for m in (trainer.student,
                                                   trainer.autoencoder)
                 for p in m.parameters())
    say("ead", f"{EAD_STEPS} steps on one batch of {EAD_BATCH} at LR "
               f"{cfg.lr}: total {totals[0]:.4f} -> {totals[-1]:.4f} (drop "
               f"{(totals[0] - totals[-1]) / totals[0]:.4f} of the first); "
               f"hard {losses[0]['hard']:.4f} -> {losses[-1]['hard']:.4f}, "
               f"ae {losses[0]['ae']:.4f} -> {losses[-1]['ae']:.4f}, stae "
               f"{losses[0]['stae']:.5f} -> {losses[-1]['stae']:.5f}; "
               f"{steps_wall:.2f} s wall")
    if not finite or not all(math.isfinite(v) for v in totals) \
            or not totals[-1] < totals[0]:
        raise AssertionError(f"EfficientAD steps: totals {totals}, params "
                             f"finite {finite}")

    q = trainer.map_normalization(val_imgs)
    auc, y_true, y_score = trainer.test_auc(test_imgs, labels, q)
    fm = final_metrics(y_true, y_score)
    say("ead", f"map_normalization quantiles (st 0.9 / 0.995, ae 0.9 / "
               f"0.995) {[round(v, 6) for v in q]}; test_auc on "
               f"{EAD_BATCH} + {EAD_BATCH} images {auc:.4f} (random "
               f"teacher: only the range is checked); final_metrics {fm}")
    if not (q[0] <= q[1] and q[2] <= q[3]) \
            or not all(math.isfinite(v) for v in q + tuple(fm.values())) \
            or not 0.0 <= auc <= 1.0:
        raise AssertionError(f"EfficientAD scoring: q {q}, auc {auc}, {fm}")

    # timings: the step (CUDA events; its idle share under the profiler)
    # and predict_maps at batch 12
    step_fn = lambda: trainer.train_step(batch, batch, draws)  # noqa: E731
    step_ms = cuda_ms(step_fn, 5)
    step_wall, fams = profile_steps(step_fn)
    busy = sum(fams.values())
    idle = max(0.0, 1.0 - busy / step_wall)
    maps_ms = cuda_ms(lambda: trainer.predict_maps(batch), 10)
    x_full = batch.permute(0, 3, 1, 2)
    maps_flops = sum(conv_flops(m, lambda m=m: m(x_full)) for m in (
        trainer.teacher, trainer.student, trainer.autoencoder))
    maps_bound = maps_flops / F32_FLOPS * 1e3
    step_flops = ead_step_flops(trainer, x_full)
    step_bound = step_flops / F32_FLOPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("ead", f"train step at batch {EAD_BATCH}: {step_ms:.3f} ms (CUDA "
               f"events), profiled {step_wall:.3f} ms with {busy:.3f} ms of "
               f"device time: idle share {idle:.3f} under the profiler, "
               f"{max(0.0, 1 - busy / step_ms):.3f} against the unprofiled "
               f"step, {step_flops / 1e9:.1f} GFLOP (f32 bound "
               f"{step_bound:.3f} ms: {step_bound / step_ms:.3f} of it); "
               f"predict_maps at batch {EAD_BATCH}: {maps_ms:.3f} ms, "
               f"{EAD_BATCH / maps_ms * 1e3:.1f} img/s, "
               f"{maps_flops / 1e9:.1f} GFLOP (f32 bound {maps_bound:.3f} "
               f"ms at {F32_FLOPS / 1e12:.0f} TFLOP/s; "
               f"{maps_flops / maps_ms / 1e9:.1f} TFLOP/s); peak allocated "
               f"{peak:.2f} GiB")
    del trainer, batch

    # the user's path: cli.efficientad --teacher scratch on a synthetic
    # MVTec tree of 200 px PNGs (the loaders' bilinear resize to 256 runs)
    shutil.rmtree(EAD_CLI_DIR, ignore_errors=True)
    generate_synthetic_mvtec(str(EAD_CLI_DIR / "data"), classes=("grid",),
                             size=EAD_CLI_SRC, seed=SEED + 44)
    t0 = time.perf_counter()
    cli_auc = cli_ead.main(EAD_CLI_ARGS)
    cli_wall = time.perf_counter() - t0
    run, = (EAD_CLI_DIR / "out").iterdir()     # <subdataset>_<steps>
    fm_cli = json.loads((run / "final_metrics.json").read_text())
    ckpts = sorted(p.name for p in run.glob("*.pt"))
    say("ead", f"cli.efficientad {' '.join(EAD_CLI_ARGS)}: AUC "
               f"{cli_auc:.4f}, final_metrics.json {fm_cli}, checkpoints "
               f"{ckpts}; {cli_wall:.1f} s wall")
    if ckpts != sorted(f"{n}.pt" for n in EAD_CHECKPOINTS) \
            or fm_cli["auc"] != cli_auc or not 0.0 <= cli_auc <= 1.0 \
            or set(fm_cli) != {"auc", "threshold", "accuracy", "precision",
                               "recall", "f1", "train_time_h"}:
        raise AssertionError(f"cli.efficientad: {ckpts}, {fm_cli}")

    torch.cuda.synchronize()
    launches = counts()
    if any(launches.values()):
        raise AssertionError(f"the EfficientAD path launched kernels of the "
                             f"port: {launches}")
    wall = time.perf_counter() - t_phase
    say("ead", f"the EfficientAD path launched none of the port's kernels "
               f"{launches}; phase wall {wall:.1f} s")
    report["ead"] = {
        "params": n_params, "fwd_rel_l2_card_vs_cpu": fwd_err,
        "step_terms": step_terms, "step_term_rel": step_rel,
        "step_state_card_vs_cpu": step_state,
        "fixed_batch": losses, "quantiles": list(q), "auc": auc,
        "final_metrics": fm, "step_ms": step_ms,
        "step_profiled_ms": step_wall, "step_device_ms": busy,
        "step_idle_share": idle, "step_gflop": step_flops / 1e9,
        "step_f32_bound_ms": step_bound,
        "step_bound_share": step_bound / step_ms,
        "predict_maps_ms": maps_ms,
        "predict_maps_img_s": EAD_BATCH / maps_ms * 1e3,
        "predict_maps_gflop": maps_flops / 1e9,
        "predict_maps_f32_bound_ms": maps_bound,
        "peak_allocated_gib": peak,
        "cli": {"args": EAD_CLI_ARGS, "auc": cli_auc,
                "final_metrics": fm_cli, "checkpoints": ckpts,
                "wall_s": cli_wall},
        "launches": launches, "wall_s": wall}
    return {"efficientad": launches}, {}


# --------------------------------------------------------------------------- #
# [mesh]: the device mesh (core/mesh.py, parallel/): world 1 over NCCL, world
# 2 over gloo on the one card
# --------------------------------------------------------------------------- #

MESH_BATCH = 8          # the global batch: 4 rows a rank at world 2
MESH_STEPS = 2
MESH_TIMED = 5          # steps (and all-reduces) timed a world size
MESH_TEST = 8
MESH_TIMEOUT = 600      # seconds, each launch of ranks


def card_setup() -> None:
    """What every process of this script sets before it works on the card:
    full f32 for the plain references, no serving-mode switch, the built
    kernels loaded."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("ADSR_TPU_RDG", None)
    _build.library()


def mesh_experiment(dp: int):
    """The flagship at the [mesh] phase's batch, on ``MeshConfig(dp=dp)``."""
    exp = drct_experiment("grid", HR, SCALE, precision="bf16",
                          batch_size=MESH_BATCH, run_tag="chip_smoke_mesh")
    return dataclasses.replace(
        exp, mesh=MeshConfig(dp=dp),
        data=dataclasses.replace(exp.data, test_every=MESH_STEPS),
        optim=dataclasses.replace(exp.optim, epochs=1), print_every=1)


def mesh_data():
    """The steps' global batches (LR pyramid, HR as numpy) and the
    Trainer's train and test sets, the same in every process."""
    rng = np.random.RandomState(SEED + 20)
    ds = train_dataset(rng, MESH_BATCH * MESH_STEPS)
    b = MESH_BATCH
    batches = [([ds.lrs[0][i * b:(i + 1) * b]], ds.hr[i * b:(i + 1) * b])
               for i in range(MESH_STEPS)]
    return batches, train_dataset(rng, 2 * MESH_BATCH), \
        train_dataset(rng, MESH_TEST)


def init_generator(exp) -> torch.Generator:
    """The init stream ``make_parallel_trainer`` seeds from ``exp.seed``."""
    return torch.Generator().manual_seed(stream_seed(exp.seed, "init"))


def dropout_generator() -> torch.Generator:
    return torch.Generator().manual_seed(stream_seed(SEED, "dropout"))


def host(tensors: dict) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in tensors.items()}


def fingerprint(model) -> str:
    """sha256 of every parameter's bytes: equal only if bitwise equal."""
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def step_wall_ms(step, barrier=None) -> float:
    """Median host wall (ms) of ``MESH_TIMED`` calls of ``step``, each
    between device syncs (and, on a mesh, after a barrier)."""
    times = []
    for _ in range(MESH_TIMED):
        torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bucket_all_reduce_ms(n: int, dev, group) -> float:
    """Median host wall (ms) of one all_reduce of an f32 bucket of ``n``
    elements on the card (the step's gradient bucket) over ``group``."""
    bucket = torch.zeros(n, device=dev)
    return step_wall_ms(lambda: dist.all_reduce(bucket, group=group),
                        dist.barrier)


def mesh_world1(rank: int, batches):
    """World 1 over NCCL: the single-process ``make_train_step`` and
    ``make_parallel_trainer`` take the same two steps from the same state;
    returns both runs' metrics, whether the parameters are bitwise equal,
    the launches of the mesh's steps, the global-batch gradients of step 1
    and parameters after step 2 (for world 2), and the times."""
    card_setup()
    dev = torch.device(DEVICE)
    exp = mesh_experiment(1)
    lr_rate = exp.optim.lr
    bundle = make_train_step(dataclasses.replace(exp, mesh=MeshConfig()), dev)
    ref = bundle.init_state(init_generator(exp))
    gen = dropout_generator()
    ref_metrics, grads1 = [], None
    for lrs, hr in batches:
        ref, m = bundle.step(ref, lrs, hr, lr_rate, gen)
        ref_metrics.append({k: float(v) for k, v in m.items()})
        if grads1 is None:
            grads1 = host({n: p.grad for n, p in
                           ref.model.named_parameters()})
    mesh = make_mesh(exp.mesh, devices=[dev])
    trainer = make_parallel_trainer(exp, mesh)
    gen = dropout_generator()
    reset_counts()
    metrics = [{k: float(v) for k, v in trainer.step(lrs, hr, lr_rate,
                                                     gen).items()}
               for lrs, hr in batches]
    torch.cuda.synchronize()
    launches = counts()
    report = {}
    check_operand_paths("mesh_w1", launches, report)
    ref_params = dict(ref.model.named_parameters())
    bitwise = all(torch.equal(p, ref_params[n])
                  for n, p in trainer.state.model.named_parameters())
    n_params = sum(p.numel() for p in ref_params.values())
    params2 = host(ref_params)          # before the timed steps move them
    lrs, hr = batches[0]
    step_ms = step_wall_ms(lambda: trainer.step(lrs, hr, lr_rate, gen))
    single_ms = step_wall_ms(lambda: bundle.step(ref, lrs, hr, lr_rate, gen))
    return {"metrics": metrics, "ref_metrics": ref_metrics,
            "bitwise": bitwise, "launches": launches,
            "grads1": grads1, "params2": params2,
            "n_params": n_params, "step_ms": step_ms,
            "single_step_ms": single_ms,
            "all_reduce_ms": bucket_all_reduce_ms(n_params, dev, None)}


def mesh_world2(rank: int, batches):
    """World 2 over gloo, both ranks on the one card: two steps of the
    fused kernel step on 4 rows a rank (launches, averaged metrics, rank
    0's step-1 gradients and step-2 parameters, every rank's parameter
    fingerprint), the batch-parallel serving forward through graphs against
    the unsharded one, a Trainer's short epoch and test, and the times."""
    card_setup()
    dev = torch.device(DEVICE)
    exp = mesh_experiment(2)
    lr_rate = exp.optim.lr
    mesh = make_mesh(exp.mesh, devices=[dev, dev])
    trainer = make_parallel_trainer(exp, mesh)
    gen = dropout_generator()
    reset_counts()
    metrics, grads1 = [], None
    for lrs, hr in batches:
        metrics.append({k: float(v) for k, v in
                        trainer.step(lrs, hr, lr_rate, gen).items()})
        if grads1 is None and rank == 0:
            grads1 = host({n: p.grad for n, p in
                           trainer.state.model.named_parameters()})
    torch.cuda.synchronize()
    launches = counts()
    report = {}
    check_operand_paths(f"mesh_w2 rank {rank}", launches, report)
    out = {"metrics": metrics, "launches": launches,
           "fingerprint": fingerprint(trainer.state.model)}
    if rank == 0:
        out["grads1"] = grads1
        out["params2"] = host(dict(trainer.state.model.named_parameters()))
    # a second run of the same steps from the same state: the gloo sum and
    # the kernels are deterministic from run to run
    again = make_parallel_trainer(exp, mesh)
    gen = dropout_generator()
    out["metrics_again"] = [
        {k: float(v) for k, v in again.step(lrs, hr, lr_rate, gen).items()}
        for lrs, hr in batches]
    out["fingerprint_again"] = fingerprint(again.state.model)
    del again
    gen = dropout_generator()

    # serving: each rank its 4 rows through its own graph, gathered
    params = trainer.state.model.state_dict()
    x = batches[0][0][0]
    reset_counts()
    served = make_serving_forward(exp, params, dev, mesh=mesh)
    got = [served(x) for _ in range(3)]      # warm-up, capture, replay
    torch.cuda.synchronize()
    out["serving_launches"] = counts()
    alone = make_serving_forward(exp, params, dev)
    want = [alone(x) for _ in range(3)]
    out["serving_bitwise"] = all(torch.equal(a, b) for a, b in zip(got, want))
    out["serving_max_abs"] = max((a - b).abs().max().item()
                                 for a, b in zip(got, want))
    out["serving_captured"] = served.fn.captured()
    del served, alone, got, want

    # a Trainer on the mesh: one epoch of two steps and a test of 8
    _, train_ds, test_ds = mesh_data()
    tr = Trainer(exp, train_ds, test_ds, device=dev, mesh=mesh)
    reset_counts()
    t0 = time.perf_counter()
    mean = tr.train_one_epoch()
    psnr, ssim = tr.test()
    torch.cuda.synchronize()
    out["trainer"] = {"mean": mean, "psnr": psnr, "ssim": ssim,
                      "launches": counts(),
                      "wall_s": time.perf_counter() - t0}
    del tr

    lrs, hr = batches[0]
    out["step_ms"] = step_wall_ms(
        lambda: trainer.step(lrs, hr, lr_rate, gen), dist.barrier)
    n_params = sum(p.numel() for p in trainer.state.model.parameters())
    out["all_reduce_ms"] = bucket_all_reduce_ms(n_params, dev,
                                                mesh.data_group)
    return out


def mesh_tensor_class(name: str) -> str:
    """The RDG_REL_L2 class of a full-model parameter: an RDG's by its
    block, the head's and tail's as the RDG's output."""
    m = re.match(r"layers\.\d+\.(.*)", name)
    return rdg_tensor_class(m.group(1)) if m else "out/dx"


def mesh_rel_l2(got: dict, want: dict) -> dict:
    """The largest relative L2 of ``got`` against ``want`` in each class;
    raises where a tensor is beyond its class's limit."""
    worst = {}
    for name, w in want.items():
        cls = mesh_tensor_class(name)
        err = rel_l2(got[name], w)
        worst[cls] = max(worst.get(cls, 0.0), err)
        if not err <= RDG_REL_L2[cls]:
            raise AssertionError(f"mesh: {name} relative L2 {err:.3e} > "
                                 f"{RDG_REL_L2[cls]} ({cls})")
    return worst


def phase_mesh(dev, report):
    """The [mesh] phase: world 1 over NCCL (bitwise against the
    single-process step), world 2 over gloo on the one card (the fused
    step on 4 rows a rank within the train limits of the global-batch
    step, launch counts, batch-parallel serving through graphs, a
    Trainer), the step's wall at both world sizes and the all-reduce's
    share. Returns its launches by path."""
    smi = nvidia_smi()
    t_phase = time.perf_counter()
    batches, _, _ = mesh_data()
    # NCCL refuses two ranks on one device: world 2 shares the card over
    # gloo
    w1 = run_ranks(mesh_world1, 1, [DEVICE], default_backend(DEVICE),
                   batches, timeout=MESH_TIMEOUT)[0]
    say("mesh", f"world 1 (NCCL): make_parallel_trainer {MESH_STEPS} steps "
                f"of batch {MESH_BATCH}: losses "
                + " ".join(f"{m['total']:.6f}" for m in w1["metrics"])
                + f"; bitwise equal to make_train_step: {w1['bitwise']}; "
                f"launches {w1['launches']}")
    if not w1["bitwise"] or w1["metrics"] != w1["ref_metrics"]:
        raise AssertionError("mesh: the world-1 step is not the "
                             "single-process step bit for bit")
    want = expected_counts(PER_TRAIN_STEP, MESH_STEPS)
    if w1["launches"] != want:
        raise AssertionError(f"mesh world 1 launches {w1['launches']}, "
                             f"expected {want}")

    w2 = run_ranks(mesh_world2, 2, [DEVICE, DEVICE], "gloo", batches,
                   timeout=MESH_TIMEOUT)
    for rank, r in enumerate(w2):
        say("mesh", f"world 2 (gloo, one card) rank {rank}: {MESH_STEPS} "
                    f"steps of {MESH_BATCH // 2} rows: losses "
                    + " ".join(f"{m['total']:.6f}" for m in r["metrics"])
                    + f"; launches {r['launches']}")
        if r["launches"] != want:
            raise AssertionError(f"mesh world 2 rank {rank} launches "
                                 f"{r['launches']}, expected {want}")
    if w2[0]["fingerprint"] != w2[1]["fingerprint"] \
            or w2[0]["metrics"] != w2[1]["metrics"]:
        raise AssertionError("mesh: the two ranks' parameters or metrics "
                             "differ after the steps")
    again = all(r["fingerprint_again"] == r["fingerprint"]
                and r["metrics_again"] == r["metrics"] for r in w2)
    say("mesh", f"world 2: a second run of the {MESH_STEPS} steps from the "
                f"same state bitwise equal to the first on both ranks: "
                f"{again}")
    if not again:
        raise AssertionError("mesh: two world-2 runs of the same steps "
                             "differ")
    # against the world-1 step at the global batch
    terms = {}
    for step, (got, ref) in enumerate(zip(w2[0]["metrics"],
                                          w1["ref_metrics"])):
        for k, v in ref.items():
            err = abs(got[k] - v) / max(abs(v), 1e-30)
            terms[f"step{step + 1}.{k}"] = err
            if not err <= RDG_REL_L2["out/dx"]:
                raise AssertionError(f"mesh: step {step + 1} {k} {got[k]} "
                                     f"against {v} (relative {err:.3e})")
    grads = mesh_rel_l2(w2[0]["grads1"], w1["grads1"])
    params = mesh_rel_l2(w2[0]["params2"], w1["params2"])
    say("mesh", "world 2 against the global-batch step: loss terms relative "
                + ", ".join(f"{k} {v:.3e}" for k, v in terms.items())
                + "; step-1 gradients rel. L2 by class "
                + ", ".join(f"{k} {v:.3e}" for k, v in grads.items())
                + "; parameters after step 2 "
                + ", ".join(f"{k} {v:.3e}" for k, v in params.items())
                + f" (limits {RDG_REL_L2})")

    serve_want = expected_counts(PER_FORWARD, 2)
    for rank, r in enumerate(w2):
        say("mesh", f"rank {rank}: serving forward over the mesh (batch "
                    f"{MESH_BATCH}, 4 rows a rank, graphs): bitwise equal to "
                    f"the unsharded forward: {r['serving_bitwise']} (max abs "
                    f"{r['serving_max_abs']:.3e}), {r['serving_captured']} "
                    f"graph(s); launches {r['serving_launches']}")
        if not r["serving_bitwise"]:
            raise AssertionError(f"mesh rank {rank}: the batch-parallel "
                                 "serving forward differs from the "
                                 "unsharded one")
        if r["serving_launches"] != serve_want:
            raise AssertionError(f"mesh rank {rank}: serving launches "
                                 f"{r['serving_launches']}, expected "
                                 f"{serve_want}")
        t = r["trainer"]
        t_want = expected_counts(PER_TRAIN_STEP, MESH_STEPS)
        for k, v in PER_FORWARD.items():
            t_want[k] += v
        say("mesh", f"rank {rank}: Trainer on the mesh: {MESH_STEPS} steps "
                    f"+ test of {MESH_TEST}: {t['wall_s']:.1f} s, loss "
                    f"{t['mean']['total']:.4f}, PSNR {t['psnr']:.3f} SSIM "
                    f"{t['ssim']:.4f}; launches {t['launches']}")
        if t["launches"] != t_want or not (
                math.isfinite(t["mean"]["total"]) and math.isfinite(t["psnr"])
                and math.isfinite(t["ssim"])):
            raise AssertionError(f"mesh rank {rank}: Trainer {t}")
    share1 = w1["all_reduce_ms"] / w1["step_ms"]
    step2 = max(r["step_ms"] for r in w2)
    reduce2 = max(r["all_reduce_ms"] for r in w2)
    share2 = reduce2 / step2
    wall = time.perf_counter() - t_phase
    say("mesh", f"step wall at batch {MESH_BATCH} (host clock, median of "
                f"{MESH_TIMED}): single process {w1['single_step_ms']:.2f} "
                f"ms, world 1 (NCCL) {w1['step_ms']:.2f} ms, world 2 (gloo, "
                f"two ranks on one card) {step2:.2f} ms; all_reduce of the "
                f"{w1['n_params']} f32 gradient bucket: world 1 "
                f"{w1['all_reduce_ms']:.3f} ms (share {share1:.3f}), world 2 "
                f"{reduce2:.2f} ms (share {share2:.3f}; gloo goes through the "
                f"host: no speed claim); {smi}; phase {wall:.1f} s")
    report["mesh"] = {
        "nvidia_smi": smi, "world1": {k: w1[k] for k in (
            "metrics", "launches", "step_ms", "single_step_ms",
            "all_reduce_ms")},
        "world2": [{k: r[k] for k in ("metrics", "launches", "step_ms",
                                      "all_reduce_ms", "serving_launches",
                                      "serving_max_abs", "trainer")}
                   for r in w2],
        "loss_terms_rel": terms, "grads1_rel_l2": grads,
        "params2_rel_l2": params, "share_w1": share1, "share_w2": share2,
        "n_params": w1["n_params"], "wall_s": wall}
    total = lambda key: {k: sum(r[key][k] for r in w2) for k in want}
    paths = {"mesh_w1": w1["launches"], "mesh_w2": total("launches"),
             "mesh_w2_serving": total("serving_launches"),
             "mesh_w2_trainer": {k: sum(r["trainer"]["launches"][k]
                                        for r in w2) for k in want}}
    return paths, {}


def phase_flagship(dev, report):
    """The flagship, DRCT x4 @128px (phases 3-11): returns (launches by
    main path, timings by kernel)."""
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
    graph_paths = phase_graphs(exp, dev, params, lr_u8, hr_u8, report)
    phase_ln_layouts(exp.model, dev, check)
    paths = {"serving": main_launches, "serving_block": block_launches,
             "train": train_launches, **cli_launches, **graph_paths}
    return paths, timings


# --------------------------------------------------------------------------- #
# fp32 serving: the f32 instances of kernels (a)-(c) (the TPU kernel at dtype
# f32), the fp32 forward, AnomalyServer, evaluate_anomaly and cli.evaluate
# at its fp32 default
# --------------------------------------------------------------------------- #

# Limits of the f32 route. Kernels against their plain f32 versions on the
# same f32 inputs on the card (TF32 off): both sum exact f32 products in
# f32, in another order (~1e-7 relative a value): relative L2 1e-5, and a
# max-abs of 1e-5 of the scale (the largest reference value; for the GEMM
# plus the largest sum of |products|, sum_k |a_k| |w_k|). The fp32 forward
# against the eager f32 model on the card and against the CPU's forward
# from the same params: relative L2 1e-4 on the token stream after each RDG
# and on the float SR, 1e-3 on each RDG's increment (out - in, smaller than
# the stream it is taken from). Scores against the CPU's: the SR is
# quantised to the 0-255 grid, so an SR value within ~1e-6 of a rounding
# boundary may round the other way: rtol 1e-3, atol 1e-4 (the CPU suite's
# limits against the JAX package); each AUC within 1 / (n_good * n_bad), one
# swapped pair of ranks.
F32_REL_L2 = 1e-5
F32_MAX_ABS = 1e-5
F32_FWD_REL_L2 = 1e-4
F32_INCREMENT_REL_L2 = 1e-3
F32_SCORE_RTOL, F32_SCORE_ATOL = 1e-3, 1e-4
F32_CPU_BATCH = 4             # images of the card-against-CPU comparisons
F32_CPU_SPLIT = 8             # good and as many defective images


def as_f32(t: torch.Tensor, gen) -> torch.Tensor:
    """An f32 copy of a bf16 case tensor at its own strides (16-byte rows
    stay 16-byte rows), its values moved off the bf16 grid by a relative
    2^-9 so every mantissa bit is exercised."""
    if t.dtype != torch.bfloat16:
        return t
    out = torch.empty_strided(t.shape, t.stride(), dtype=torch.float32,
                              device=t.device)
    out.copy_(t.float() * (1 + 2.0 ** -9 * torch.randn(
        t.shape, generator=gen, device=t.device)))
    return out


def f32_case_inputs(cfg, dev, gen):
    """:func:`make_case_inputs` in f32: the same layouts (the concat
    buffer, 16-byte rows for the GEMM operands, qkv and the context)."""
    cat, blocks, masks = make_case_inputs(cfg, dev, gen)
    cat = as_f32(cat, gen)
    blocks = [{k: as_f32(v, gen) if torch.is_tensor(v) else v
               for k, v in blk.items() if k not in ("dqkv", "dctx")}
              for blk in blocks]
    for blk in blocks:
        blk["ctx"] = blk["act"]
    return cat, blocks, masks


def check_f32(errs: dict, kernel: str, case: str, got, want, scale) -> None:
    """``got`` within ``F32_REL_L2`` relative L2 and ``F32_MAX_ABS * scale``
    elementwise of ``want``; the largest reading joins ``errs``."""
    torch.cuda.synchronize()
    got = got.float()
    max_abs = (got - want).abs().max().item()
    rel = rel_l2(got, want)
    limit = F32_MAX_ABS * float(scale)
    say("kernels", f"{kernel:21s} {case:44s} max_abs {max_abs:.3e} (limit "
                   f"{limit:.3e}) rel_l2 {rel:.3e}")
    if not torch.isfinite(got).all() or max_abs > limit \
            or rel > F32_REL_L2:
        raise AssertionError(f"{kernel} {case}: max_abs {max_abs:.3e} > "
                             f"{limit:.3e} or rel_l2 {rel:.3e} > {F32_REL_L2}")
    errs[kernel] = max(errs.get(kernel, 0.0), max_abs)


def f32_bounds(cfg, blocks, m, masks):
    """:func:`set_bounds` for the f32 instances: 4 bytes an element, every
    operation at the f32 peak, (b)'s and (c)'s products also as 3xTF32 on
    the tensor cores (:func:`tf32x3_bound`; the FFMA bound under
    ``"ffma"``)."""
    ln_b = ln_ops = mm_b = mm_ops = at_b = at_tc = at_ew = 0.0
    n = cfg.window_size ** 2
    for k, blk in enumerate(blocks):
        c, f, a, nh = blk["c"], blk["f"], blk["a"], blk["nh"]
        ln_b += 2 * (2 * m * c * 4 + 2 * c * 4)
        ln_ops += 2 * 8 * m * c
        for n_out, n_in, res in ((3 * c, c, False), (c, c, True),
                                 (f, c, False), (c, f, True), (a, c, k == 4)):
            mm_b += (m * n_in * 4 + n_out * n_in * 4 + n_out * 4
                     + m * n_out * 4 * (2 if res else 1))
            mm_ops += 2 * m * n_out * n_in
        at_b += m * 3 * c * 4 + m * c * 4 \
            + attn_operand_bytes(blk, cfg, masks)
        at_tc += 4 * m * n * c                    # its two products
        at_ew += 6 * (m // n) * nh * n * n
    out = {}
    for name, byt, ops in (("rdg_layernorm_f32", ln_b, ln_ops),
                           ("rdg_gemm_f32", mm_b, mm_ops),
                           ("window_attention_f32", at_b, at_tc + at_ew)):
        t_b, t_ops = byt / HBM_BYTES_PER_S, ops / F32_FLOPS
        out[name] = (max(t_b, t_ops) * 1e3,
                     "bytes" if t_b >= t_ops else "operations", byt, ops)
    # (b) f32 and (c) f32 run their products as 3xTF32: the FFMA bound
    # stays beside it
    out["ffma"] = {k: out[k] for k in ("rdg_gemm_f32", "window_attention_f32")}
    out["rdg_gemm_f32"] = tf32x3_bound(mm_b, mm_ops, 0.0)
    out["window_attention_f32"] = tf32x3_bound(at_b, at_tc, at_ew)
    return out


def tf32x3_bound(byt: float, tc_ops: float, f32_ops: float) -> tuple:
    """(ms, bound_by, bytes, operations) of work whose products (``tc_ops``
    operations) run as three TF32 products each on the tensor cores and
    whose other arithmetic (``f32_ops``) at the f32 peak."""
    t_b = byt / HBM_BYTES_PER_S
    t_ops = 3 * tc_ops / TF32_TC_FLOPS + f32_ops / F32_FLOPS
    return (max(t_b, t_ops) * 1e3, "bytes" if t_b >= t_ops else "operations",
            byt, tc_ops + f32_ops)


def bound_text(name: str, kernel_ms: float, bounds: dict) -> str:
    """The bound of ``name`` for a timing line: 3xTF32 and FFMA both where
    the kernel runs its products on the tensor cores."""
    b = bounds[name]
    text = f"bound {b[0]:.4f} ms ({b[1]}; {achieved(kernel_ms, b)})"
    if name in bounds.get("ffma", {}):
        f = bounds["ffma"][name]
        text = (f"3xTF32 bound {b[0]:.4f} ms ({b[1]}; "
                f"{achieved(kernel_ms, b)}), FFMA bound {f[0]:.4f} ms "
                f"({f[1]}; {achieved(kernel_ms, f)})")
    return text


def f32_geometry(cfg, dev, errs: dict, label: str, full: bool,
                 ffma: dict = None):
    """The f32 instances at ``cfg``'s shapes (batch ``BATCH``): each against
    its plain f32 version (every GEMM product and epilogue and every
    attention block and shift, at windows 4 and 16 also at batch 5 on 20 x
    20 / 32 x 32 tokens, with ``full`` every LayerNorm piece too),
    then one RDG's
    launches of each timed beside its bound, its plain version and its
    library call (``F.layer_norm``, ``F.linear`` in f32 with TF32 off,
    ``scaled_dot_product_attention`` in f32 with a float mask). Returns
    {kernel: (ms, plain_ms, library_ms, bound_ms, bound_by)}; ``ffma``
    (where given) takes the FFMA bound (ms) of each kernel whose bound_ms
    is its 3xTF32 one. Each GEMM case runs twice, bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    cat, blocks, masks = f32_case_inputs(cfg, dev, gen)
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    win, d = cfg.window_size, cfg.embed_dim
    say("kernels", f"{label}: f32 kernels against their plain f32 versions "
                   f"at M = {m} token rows, window {win}")
    if full:
        for k, blk in enumerate(blocks):
            c = blk["c"]
            layouts = [("concat prefix", cat[:, :c], 16),
                       ("x1 contiguous", blk["x1"], 16)]
            if k == 0:    # single values: a base one float past alignment
                layouts.append(("4-byte pieces", cat[:, 1:1 + c], 4))
            for name, x, piece in layouts:
                out = pitched(m, x.shape[1], dtype=torch.float32, device=dev)
                got_piece = check_ln_layout("rdg_layernorm", x, out)
                if got_piece != piece:
                    raise AssertionError(f"rdg_layernorm f32 {name}: piece "
                                         f"{got_piece}, expected {piece}")
                rdg_layernorm(x, blk["ln_w"], blk["ln_b"], out)
                want = rdg_layernorm_plain(x, blk["ln_w"], blk["ln_b"])
                check_f32(errs, "rdg_layernorm_f32",
                          f"c={x.shape[1]} {name} ({piece}-byte pieces)",
                          out, want, want.abs().max())
    # (b) at every geometry: its tile width follows M (f32_tile_width)
    dp = torch.full((BATCH, 10), 1.0 / 0.9, device=dev)
    dp[1, 0::2] = dp[BATCH - 1, 1::2] = dp[BATCH // 2] = 0.0
    for k, blk in enumerate(blocks):
        c = blk["c"]
        cases = [(label_, a, wt, bias, epi, res, None)
                 for label_, a, wt, bias, epi, res
                 in gemm_cases(cfg, cat, blk, k)]
        cases += [("proj", blk["ctx"], blk["wproj"], blk["bproj"],
                   "drop_residual", cat[:, :c], 2 * k),
                  ("fc2", blk["hid"], blk["w2"], blk["b2"],
                   "drop_residual", blk["x1"], 2 * k + 1),
                  ("fc1", blk["act"], blk["w1"], blk["b1"], "gelu_aux",
                   None, None)]
        for name, a, wt, bias, epi, res, col in cases:
            scale = None if col is None else dp[:, col]
            want = rdg_gemm_plain(a, wt, bias, epi, res, scale)

            def gemm_once(res=res):
                aux = torch.empty(m, wt.shape[0], device=dev) \
                    if epi == "gelu_aux" else None
                if name == "adjust":
                    # adjust 1-4 into the concat columns, adjust 5 in
                    # place over the RDG input (out aliases residual)
                    dst = cat.clone()
                    out = dst[:, c:c + cfg.gc] if k < 4 else dst[:, :d]
                    res = None if k < 4 else out
                else:
                    out = pitched(m, wt.shape[0], dtype=torch.float32,
                                  device=dev)
                rdg_gemm(a, wt, bias, out, epi, res, scale, aux)
                return out, aux

            out, aux = gemm_once()
            again, aux_again = gemm_once()
            if not torch.equal(out, again) or (
                    aux is not None and not torch.equal(aux, aux_again)):
                raise AssertionError(f"rdg_gemm_f32 b{k + 1} {name} "
                                     f"{epi}: two launches differ")
            size = (a.abs() @ wt.abs().t()).max() + want.abs().max()
            check_f32(errs, "rdg_gemm_f32", f"b{k + 1} {name} {m}x"
                      f"{wt.shape[0]}x{wt.shape[1]} {epi}", out, want,
                      size)
            if aux is not None:
                check_f32(errs, "rdg_gemm_f32", f"b{k + 1} {name} aux",
                          aux, rdg_gemm_plain(a, wt, bias), size)
    for k, blk in enumerate(blocks):
        c, nh = blk["c"], blk["nh"]
        for shift in (0, win // 2):
            kbias, kmask = attn_operands(blk, masks, h, w, shift, win)
            out = pitched(m, c, dtype=torch.float32, device=dev)
            window_attention(blk["qkv"], out, kbias, kmask, h, w, nh, win,
                             shift)
            want = window_attention_plain(blk["qkv"], blk["attn_bias"],
                                          masks.get(shift), h, w, nh, win,
                                          shift)
            check_f32(errs, "window_attention_f32", f"b{k + 1} c={c} "
                      f"heads={nh} hd={c // nh} shift={shift}", out, want,
                      want.abs().max())
            again = pitched(m, c, dtype=torch.float32, device=dev)
            window_attention(blk["qkv"], again, kbias, kmask, h, w, nh, win,
                             shift)
            if not torch.equal(out, again):
                raise AssertionError(f"window_attention_f32 b{k + 1} shift "
                                     f"{shift}: two launches differ")
    if win in (4, 16):
        # batch 5 on 20 x 20 / 32 x 32 tokens: windows that fill no power
        # of two, twice bitwise
        side = 20 if win == 4 else 32
        rows = 5 * side * side
        masks5 = {s_: torch.as_tensor(shift_attn_mask(side, side, win, s_),
                                      device=dev) for s_ in masks}
        for k, blk in enumerate(blocks):
            c, nh = blk["c"], blk["nh"]
            qkv = blk["qkv"][:rows]
            for shift in (0, win // 2):
                kbias, kmask = attn_operands(blk, masks5, side, side, shift,
                                             win)
                outs = [pitched(rows, c, dtype=torch.float32, device=dev)
                        for _ in range(2)]
                for o in outs:
                    window_attention(qkv, o, kbias, kmask, side, side, nh,
                                     win, shift)
                want = window_attention_plain(qkv, blk["attn_bias"],
                                              masks5.get(shift), side, side,
                                              nh, win, shift)
                case = f"b{k + 1} hd={c // nh} shift={shift} B=5 on " \
                       f"{side}x{side}"
                check_f32(errs, "window_attention_f32", case, outs[0], want,
                          want.abs().max())
                if not torch.equal(outs[0], outs[1]):
                    raise AssertionError(f"window_attention_f32 {case}: two "
                                         "launches differ")

    scratch = torch.empty(m * row_pitch(3 * max(g["feats"])),
                          dtype=torch.float32, device=dev)

    def rows(n_cols):           # 16-byte rows, as the main path's buffers
        return scratch.as_strided((m, n_cols), (row_pitch(n_cols), 1))

    def ln_set(mode="kernel"):
        for blk in blocks:
            c = blk["c"]
            for src in (cat[:, :c], blk["x1"]):
                if mode == "library":
                    F.layer_norm(src, (c,), blk["ln_w"], blk["ln_b"],
                                 eps=1e-6)
                elif mode == "plain":
                    rdg_layernorm_plain(src, blk["ln_w"], blk["ln_b"])
                else:
                    rdg_layernorm(src, blk["ln_w"], blk["ln_b"], rows(c))

    def gemm_set(mode="kernel"):
        for k, blk in enumerate(blocks):
            for _, a, wt, bias, epi, res in gemm_cases(cfg, cat, blk, k):
                if mode == "library":
                    F.linear(a, wt, bias)
                elif mode == "plain":
                    rdg_gemm_plain(a, wt, bias, epi, res)
                else:
                    rdg_gemm(a, wt, bias, rows(wt.shape[0]), epi, res)

    nw = (h // win) * (w // win)
    sdpa_in = []
    for blk in blocks:
        hd = blk["c"] // blk["nh"]
        q, k_, v = (torch.randn(BATCH, nw, blk["nh"], win * win, hd,
                                generator=gen, device=dev) for _ in range(3))
        term = build_attn_term(blk["attn_bias"], h, w, win,
                               masks.get(blk["shift"]))
        sdpa_in.append((q, k_, v, term.contiguous()))

    def attn_set(mode="kernel"):
        for k, blk in enumerate(blocks):
            c, nh, shift = blk["c"], blk["nh"], blk["shift"]
            if mode == "library":
                F.scaled_dot_product_attention(*sdpa_in[k][:3],
                                               attn_mask=sdpa_in[k][3])
            elif mode == "plain":
                window_attention_plain(blk["qkv"], blk["attn_bias"],
                                       masks.get(shift), h, w, nh, win, shift)
            else:
                window_attention(blk["qkv"], rows(c),
                                 *attn_operands(blk, masks, h, w, shift, win),
                                 h, w, nh, win, shift)

    bounds = f32_bounds(cfg, blocks, m, masks)
    timings = {}
    for name, fn in (("rdg_layernorm_f32", ln_set), ("rdg_gemm_f32", gemm_set),
                     ("window_attention_f32", attn_set)):
        kernel_ms = graph_ms(fn, iters=10)
        plain_ms = graph_ms(lambda: fn("plain"), iters=3)
        library_ms = graph_ms(lambda: fn("library"), iters=10)
        timings[name] = (kernel_ms, plain_ms, library_ms) + bounds[name][:2]
        say("timing", f"{label} {name:20s} one RDG's launches: kernel "
                      f"{kernel_ms:.4f} ms, "
                      f"{bound_text(name, kernel_ms, bounds)}, plain f32 "
                      f"{plain_ms:.4f} ms, library {library_ms:.4f} ms "
                      f"(device time, CUDA graph)")
    if ffma is not None:
        ffma.update({k: v[0] for k, v in bounds["ffma"].items()})
    return timings


def swin_f32_bound(cfg, blocks, m, masks):
    """Least time (ms) of one RDG's five f32 (g) launches: bytes at 4 an
    element (x read once, the output written once, weights, vectors, bias
    and mask read once, as :func:`swin_bound`) over the HBM rate against
    the operations: the four products and the attention's two as three TF32
    products each on the tensor cores, the softmax, LayerNorms and GELU at
    the f32 peak (:func:`tf32x3_bound`). Returns (that bound, the FFMA
    bound: every operation at the f32 peak)."""
    win = cfg.window_size
    n = win * win
    byt = tc_ops = f32_ops = 0.0
    for blk in blocks:
        c, f, nh = blk["c"], blk["f"], blk["nh"]
        byt += 2 * m * c * 4 + (4 * c * c + 2 * c * f) * 4 \
            + (3 * c + 7 * c + f) * 4
        mask = masks[blk["shift"]] if blk["shift"] else None
        if win in TILED_WINDOWS:
            byt += nh * (2 * win - 1) ** 2 * 4
            byt += 0 if mask is None else mask.shape[0] * n * 4
        else:
            byt += nh * n * n * 4 + (0 if mask is None else mask.numel() * 4)
        tc_ops += 2 * m * (4 * c * c + 2 * c * f) + 4 * m * n * c
        f32_ops += 6 * (m // n) * nh * n * n + 2 * 8 * m * c + 8 * m * f
    ops = tc_ops + f32_ops
    t_b, t_ops = byt / HBM_BYTES_PER_S, ops / F32_FLOPS
    ffma = (max(t_b, t_ops) * 1e3, "bytes" if t_b >= t_ops else "operations",
            byt, ops)
    return tf32x3_bound(byt, tc_ops, f32_ops), ffma


def swin_f32_cfg(cfg, blk):
    """A config whose blocks 1 and 2 (k = 0 unshifted, k = 1 shifted) have
    block ``blk``'s width, heads and hidden width (gc 0): kernel (g) at
    each block's shape at both shifts."""
    lone = dataclasses.replace(cfg, embed_dim=blk["c"], num_heads=blk["nh"],
                               gc=0, mlp_ratio=blk["f"] / blk["c"])
    g = rdg_geometry(lone)
    if any(g[key][:2] != (blk[b],) * 2 for key, b in
           (("feats", "c"), ("heads", "nh"), ("hidden", "f"))):
        raise AssertionError(f"swin_f32_cfg: {g} is not block {blk['c']}")
    return lone


def f32_swin_geometry(cfg, dev, errs: dict, label: str):
    """Kernel (g)'s f32 instance at ``cfg``'s five block shapes (batch
    ``BATCH``), each at both shifts, twice, bitwise equal, within
    ``F32_REL_L2`` / ``F32_MAX_ABS`` of its plain f32 version; at windows 4
    and 16 also at batch 5 on 20 x 20 / 32 x 32 tokens (a short last group
    of four windows; 20 clusters). Then one RDG's five launches timed
    beside the bound, the plain version, the library sum (``F.layer_norm``,
    ``F.linear`` with TF32 off, SDPA f32 with a float mask) and the (a)-(c)
    f32 composition. Returns (ms, plain_ms, library_ms, bound_ms,
    bound_by, composition_ms)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    cat, blocks, masks = f32_case_inputs(cfg, dev, gen)
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    win = cfg.window_size
    ps = [swin_case(blk) for blk in blocks]
    sides = [(BATCH, h, masks)]
    if win in (4, 16):
        side = 20 if win == 4 else 32
        sides.append((5, side, {s: torch.as_tensor(shift_attn_mask(
            side, side, win, s), device=dev) for s in masks}))
    for k, (blk, p) in enumerate(zip(blocks, ps)):
        c = blk["c"]
        lone = swin_f32_cfg(cfg, blk)
        for b, side, msk in sides:
            rows = b * side * side
            x = cat[:rows, :c]
            for kk in (0, 1):
                outs = [torch.empty(rows, c, device=dev) for _ in range(2)]
                for o in outs:
                    fused_swin_block(x, p, msk, lone, side, side, kk, o)
                want = fused_swin_block_plain(x, p, msk, lone, side, side, kk)
                case = f"b{k + 1} c={c} heads={blk['nh']} f={blk['f']} " \
                       f"shift={kk * win // 2} B={b} on {side}x{side}"
                check_f32(errs, "swin_block_f32", case, outs[0], want,
                          want.abs().max())
                if not torch.equal(outs[0], outs[1]):
                    raise AssertionError(f"swin_block_f32 {case}: two "
                                         "launches differ")

    outs = [torch.empty(m, blk["c"], device=dev) for blk in blocks]
    work = rdg_workspace(m, cfg, torch.float32, dev)
    nw = (h // win) * (w // win)
    lib = []
    for blk in blocks:
        hd = blk["c"] // blk["nh"]
        q, k_, v = (torch.randn(BATCH, nw, blk["nh"], win * win, hd,
                                generator=gen, device=dev) for _ in range(3))
        term = build_attn_term(blk["attn_bias"], h, w, win,
                               masks.get(blk["shift"])).contiguous()
        lib.append((q, k_, v, term))

    def block_set(mode="kernel"):
        for k, blk in enumerate(blocks):
            c, p = blk["c"], ps[k]
            if mode == "plain":
                fused_swin_block_plain(cat[:, :c], p, masks, cfg, h, w, k)
            elif mode == "composition":
                swin_block_forward(cat[:, :c], p,
                                   block_buffers(work, m, c, blk["f"]),
                                   masks, cfg, h, w, k)
            elif mode == "library":
                q, k_, v, term = lib[k]
                ln = F.layer_norm(cat[:, :c], (c,), p["ln1_w"], p["ln1_b"],
                                  eps=1e-6)
                F.linear(ln, p["wqkv"], p["bqkv"])
                F.scaled_dot_product_attention(q, k_, v, attn_mask=term)
                x1 = F.linear(blk["ctx"], p["wproj"], p["bproj"]) \
                    + cat[:, :c]
                hid = F.gelu(F.linear(F.layer_norm(x1, (c,), p["ln2_w"],
                                                   p["ln2_b"], eps=1e-6),
                                      p["w1"], p["b1"]))
                F.linear(hid, p["w2"], p["b2"]).add_(x1)
            else:
                fused_swin_block(cat[:, :c], p, masks, cfg, h, w, k, outs[k])

    kernel_ms = graph_ms(block_set, iters=10)
    plain_ms = graph_ms(lambda: block_set("plain"), iters=3)
    library_ms = graph_ms(lambda: block_set("library"), iters=10)
    composition_ms = graph_ms(lambda: block_set("composition"), iters=10)
    bound, ffma = swin_f32_bound(cfg, blocks, m, masks)
    say("timing", f"{label} swin_block_f32       one RDG's launches: kernel "
                  f"{kernel_ms:.4f} ms, 3xTF32 bound {bound[0]:.4f} ms "
                  f"({bound[1]}; {achieved(kernel_ms, bound)}), FFMA bound "
                  f"{ffma[0]:.4f} ms ({ffma[1]}; {achieved(kernel_ms, ffma)}), "
                  f"plain f32 {plain_ms:.4f} ms, library {library_ms:.4f} "
                  f"ms, (a)-(c) f32 composition {composition_ms:.4f} ms "
                  "(device time, CUDA graph)")
    return (kernel_ms, plain_ms, library_ms) + bound[:2] \
        + (composition_ms, ffma[0])


def f32_cpu_pair(exp, params):
    """The CPU's fp32 forward of ``params`` (the plain versions of (a)-(c)
    and PyTorch's CPU convolutions): a packing on the CPU."""
    cfg = exp.model
    cpu_params = {k: v.cpu() for k, v in params.items()}
    return cpu_params, prepack_drct(cpu_params, cfg, cfg.img_size,
                                    cfg.img_size, dtype=torch.float32,
                                    device="cpu", mode="rdg")


def f32_adjust_bound(cfg, batch: int) -> float:
    """Least time (ms) of one RDG's five f32 adjust products (kernel (b) in
    block mode) at ``batch`` images: bytes (each input read once, each
    output written once; adjust 5 reads its residual) over the HBM rate
    against the operations at the f32 peak."""
    g = rdg_geometry(cfg)
    m = batch * cfg.img_size ** 2
    byt = ops = 0.0
    for k, (c, a) in enumerate(zip(g["feats"], g["adj_out"])):
        byt += m * c * 4 + a * c * 4 + a * 4 + m * a * 4 * (2 if k == 4 else 1)
        ops += 2 * m * a * c
    return max(byt / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3


def phase_fp32(dev, report):
    """fp32 DRCT serving on the card (kernels (a)-(c) and (g) in f32), in a
    process of its own after the flagship's: the f32 kernels against their
    plain versions at windows 8 (the flagship), 4 and 16 and their times;
    the flagship's fp32 forward in rdg and in block mode against the eager
    f32 model and the CPU; its launches (40 f32 a RDG in rdg mode, 10 in
    block mode, no bf16) through ``AnomalyServer`` and
    ``evaluate_anomaly``; the captured forward, server and tiled forward of
    each mode bitwise equal to the launched route; scores and AUCs against
    the CPU's; ``cli.evaluate`` at its fp32 default on the flagship phase's
    run dir in both modes; both forwards' times. Returns (launches by path,
    the flagship's kernel timings)."""
    global PREFIX
    PREFIX = "fp32"
    t_phase = time.perf_counter()
    out = report.setdefault("fp32", {})
    exp = drct_experiment("grid", HR, SCALE, precision="fp32",
                          batch_size=BATCH, run_tag="chip_smoke_fp32")
    cfg = exp.model
    walls, t_lap = {}, [t_phase]

    def lap(name):
        """The wall of the section that ends here, under ``name``."""
        now = time.perf_counter()
        walls[name], t_lap[0] = now - t_lap[0], now

    errs = {}
    reset_counts()
    ffma = out.setdefault("ffma_bound_ms", {})
    timings = f32_geometry(cfg, dev, errs, "w8", full=True,
                           ffma=ffma.setdefault("w8", {}))
    swin = {"w8": f32_swin_geometry(cfg, dev, errs, "w8")}
    out["max_abs_err"] = dict(errs)
    for tag, geo in (("w4", (64, 4)), ("w16", (256, 4))):
        e = {}
        cfg_g = drct_experiment("grid", *geo, precision="fp32",
                                run_tag="t").model
        t = f32_geometry(cfg_g, dev, e, tag, full=False,
                         ffma=ffma.setdefault(tag, {}))
        swin[tag] = f32_swin_geometry(cfg_g, dev, e, tag)
        out[f"timings_{tag}"] = {k: list(v) for k, v in t.items()}
        out[f"timings_{tag}"]["swin_block_f32"] = list(swin[tag][:5])
        out[f"max_abs_err_{tag}"] = e
        torch.cuda.empty_cache()
    out["swin_block_f32"] = {
        tag: {"ms": v[0], "plain_ms": v[1], "library_ms": v[2],
              "bound_ms": v[3], "bound_by": v[4], "composition_ms": v[5],
              "bound_ffma_ms": v[6]}
        for tag, v in swin.items()}
    if any(counts().get(k) for k in WRAPPERS):
        raise AssertionError(f"the f32 kernel cases launched bf16 kernels: "
                             f"{counts()}")

    lap("kernels")
    # the flagship's fp32 forward in each mode: launches, the eager f32
    # model, the CPU
    params = seeded_params(cfg, dev)
    rng = np.random.RandomState(SEED + 40)
    lr_u8, hr_u8 = synthetic_split(rng, 16 + 5, 16)
    order = list(range(16)) + list(range(21, 37)) + list(range(16, 21))
    lr_u8, hr_u8 = lr_u8[order], hr_u8[order]
    rgb = exp.data.rgb_range
    x = torch.as_tensor(to_float(lr_u8[:BATCH], cfg.in_chans, rgb),
                        dtype=torch.float32, device=dev)
    packed = prepack_drct(params, cfg, cfg.img_size, cfg.img_size,
                          dtype=torch.float32, device=dev, mode="rdg")
    cpu_params, packed_cpu = f32_cpu_pair(exp, params)
    with torch.no_grad():
        model = make_model(cfg, device=dev)
        model.load_state_dict(params)
        taps_p = []
        with full_f32():
            sr_p = model(x, taps=taps_p)
    del model
    modes = {"rdg": PER_FORWARD_F32, "block": PER_FORWARD_BLOCK_F32}
    for mode, per in modes.items():
        with torch.no_grad():
            reset_counts()
            taps_k = []
            sr_k = fused_drct_apply(packed, cfg, x, taps=taps_k, mode=mode)
            torch.cuda.synchronize()
            got = counts()
            if got != expected_counts(per, 1):
                raise AssertionError(f"fp32 {mode} forward launches {got}, "
                                     f"expected {per} and no bf16 kernel")
            taps_c = []
            sr_c = fused_drct_apply(packed_cpu, cfg, x[:F32_CPU_BATCH].cpu(),
                                    taps=taps_c, mode=mode)
        errors = {}
        for name, taps, sr, rows in (("eager", taps_p, sr_p, BATCH),
                                     ("cpu", taps_c, sr_c, F32_CPU_BATCH)):
            tok, inc, sr_err = stream_errors(
                [t[:rows].cpu() for t in taps_k], sr_k[:rows].cpu(),
                [t.cpu() for t in taps], sr.cpu())
            errors[name] = {"tokens": tok, "increments": inc, "sr": sr_err}
            say("main", f"fp32 {mode}-mode forward (f32 kernels) vs the "
                        f"{name} f32 forward ({rows} images), relative L2 of "
                        "the token stream after each RDG: "
                        + " ".join(f"{e:.2e}" for e in tok)
                        + "; of each RDG's increment: "
                        + " ".join(f"{e:.2e}" for e in inc)
                        + f"; of the float SR: {sr_err:.3e}")
            if max(tok) > F32_FWD_REL_L2 or sr_err > F32_FWD_REL_L2 \
                    or max(inc) > F32_INCREMENT_REL_L2 \
                    or not torch.isfinite(sr_k).all():
                raise AssertionError(
                    f"fp32 {mode} forward vs {name}: tokens {max(tok):.3e} "
                    f"or SR {sr_err:.3e} > {F32_FWD_REL_L2}, or increments "
                    f"{max(inc):.3e} > {F32_INCREMENT_REL_L2}")
        out["forward_rel_l2" if mode == "rdg" else "forward_rel_l2_block"] = \
            errors
        say("main", f"fp32 {mode}-mode forward launches {got}: "
                    f"{sum(per.values()) // cfg.num_layers} f32 kernels a "
                    "RDG, no bf16 kernel")
        del taps_k, taps_c
    del taps_p

    lap("forwards")
    # AnomalyServer and evaluate_anomaly in fp32 in each mode, launched:
    # that mode's f32 launches, no bf16 one
    lr_f = to_float(lr_u8, cfg.in_chans, rgb)
    hr_f = to_float(hr_u8, cfg.in_chans, rgb)
    good = list(range(16)) + list(range(32, 37))
    bad = list(range(16, 32))
    n_fwd = math.ceil(len(lr_u8) / BATCH)
    n_eval = math.ceil(len(good) / BATCH) + math.ceil(len(bad) / BATCH)
    paths = {}
    for mode, per in modes.items():
        tag = "fp32" if mode == "rdg" else "block_fp32"
        server = AnomalyServer(batch_size=BATCH, ssim_window=11, device=dev,
                               graphs=False)
        server.register("grid", exp, params, mode=mode)
        reset_counts()
        scores = server.score("grid", lr_u8, hr_u8)
        torch.cuda.synchronize()
        serving = counts()
        if serving != expected_counts(per, n_fwd) \
                or scores.shape != (len(lr_u8), 3) \
                or not np.isfinite(scores).all():
            raise AssertionError(f"fp32 {mode} AnomalyServer launches "
                                 f"{serving}, expected {per} x {n_fwd}; "
                                 f"scores {scores.shape}")
        say("main", f"fp32 AnomalyServer ({mode} mode) scored {len(lr_u8)} "
                    f"requests in {n_fwd} forwards; launches {serving}")
        reset_counts()
        res = evaluate_anomaly_arrays(exp, params, lr_f[good], hr_f[good],
                                      lr_f[bad], hr_f[bad], batch=BATCH,
                                      device=dev, log=lambda s: None,
                                      mode=mode, graphs=False)
        torch.cuda.synchronize()
        evaluate = counts()
        aucs = [res["auc_ssim"], res["auc_mse"], res["auc_psnr"]]
        if evaluate != expected_counts(per, n_eval) \
                or not all(0.0 <= a <= 1.0 for a in aucs):
            raise AssertionError(f"fp32 {mode} evaluate_anomaly launches "
                                 f"{evaluate}, expected {per} x {n_eval}; "
                                 f"AUCs {aucs}")
        say("main", f"fp32 evaluate_anomaly core ({mode} mode): AUC "
                    f"ssim/mse/psnr {aucs[0]:.4f}/{aucs[1]:.4f}/"
                    f"{aucs[2]:.4f}; launches {evaluate}")
        paths[f"serving_{tag}"] = serving
        paths[f"evaluate_{tag}"] = evaluate
        out["aucs" if mode == "rdg" else "aucs_block"] = aucs
        del server

    lap("serving")
    # scores and AUCs of each mode against the CPU's fp32 path from the same
    # params (its plain versions: the same functions in either mode)
    n = F32_CPU_SPLIT
    pick = list(range(n)) + list(range(16, 16 + n))
    sel_g, sel_b = list(range(n)), list(range(16, 16 + n))

    def scores_and_aucs(device, p, mode):
        server = AnomalyServer(batch_size=F32_CPU_BATCH, ssim_window=11,
                               device=device, graphs=False)
        server.register("grid", exp, p, mode=mode)
        return server.score("grid", lr_u8[pick], hr_u8[pick]), \
            evaluate_anomaly_arrays(exp, p, lr_f[sel_g], hr_f[sel_g],
                                    lr_f[sel_b], hr_f[sel_b],
                                    batch=F32_CPU_BATCH, device=device,
                                    log=lambda s: None, mode=mode,
                                    graphs=False)

    s_cpu, res_cpu = scores_and_aucs("cpu", cpu_params, "rdg")
    for mode in modes:
        s_card, res_card = scores_and_aucs(dev, params, mode)
        score_diff = np.abs(s_card - s_cpu).max(0).tolist()
        auc_diff = [abs(res_card[k] - res_cpu[k])
                    for k in ("auc_ssim", "auc_mse", "auc_psnr")]
        say("main", f"fp32 {mode} mode, card vs CPU on {n} + {n} images: "
                    f"largest score difference (1-SSIM, MSE, -PSNR) "
                    f"{score_diff}; AUC differences {auc_diff} (limit "
                    f"{1 / n ** 2:.4f}); best window {res_card['best_ws']} / "
                    f"{res_cpu['best_ws']}")
        np.testing.assert_allclose(s_card, s_cpu, rtol=F32_SCORE_RTOL,
                                   atol=F32_SCORE_ATOL)
        if max(auc_diff) > 1.0 / n ** 2:
            raise AssertionError(f"fp32 {mode} AUCs differ from the CPU's by "
                                 f"{auc_diff}")
        key = "" if mode == "rdg" else "_block"
        out[f"score_diff_vs_cpu{key}"] = score_diff
        out[f"auc_diff_vs_cpu{key}"] = auc_diff

    lap("cpu_scores")
    # the captured route of each mode: the forward, AnomalyServer and the
    # tiled forward bitwise equal to the launched route; the capture's
    # memory
    rng = np.random.RandomState(SEED + 30)
    lr_t, _ = synthetic_split(rng, BATCH // 2, BATCH // 2, CLI_TEST_HR, SCALE)
    xt = torch.as_tensor(to_float(lr_t, cfg.in_chans, rgb),
                         dtype=torch.float32, device=dev)
    for mode, per in modes.items():
        tag = "fp32" if mode == "rdg" else "block_fp32"
        fwd = {gr: make_serving_forward(exp, params, dev, mode=mode,
                                        graphs=gr) for gr in (True, False)}
        check_replays(f"forward_{tag}", fwd[True], fwd[False],
                      forward_inputs(x), per, report)
        del fwd
        launches, _, _ = check_server_graphs(exp, dev, params, lr_u8, hr_u8,
                                             mode, report,
                                             f"serving_{tag}_graphs", per=per)
        paths[f"serving_{tag}_graphs"] = launches
        tiled = {gr: make_tiled_serving_forward(
            exp, params, quantize_out=False, device=dev, mode=mode,
            graphs=gr) for gr in (True, False)}
        paths[f"tiled_{tag}_graphs"] = check_replays(
            f"tiled_{tag}", tiled[True], tiled[False],
            forward_inputs(xt)[:3], per, report)
        tiled_ms = cuda_ms(lambda: tiled[True](xt), iters=2, warmup=0)
        say("graphs", f"fp32 tiled serving ({mode} mode) through its graph: "
                      f"{BATCH} images of {CLI_TEST_HR} px in {tiled_ms:.3f} "
                      f"ms = {BATCH * 1e3 / tiled_ms:.1f} img/s")
        out["tiled_ms" if mode == "rdg" else "tiled_ms_block"] = tiled_ms
        del tiled

    lap("graphs")
    # cli.evaluate at its default (fp32) on the flagship phase's run dir in
    # each mode (ADSR_TPU_RDG=0: block mode): 8 + 8 test images of 512 px,
    # auto-tiled; its captured call's warm-up and capture count one
    # forward's f32 launches each; block mode's scores and AUCs against rdg
    # mode's
    run_dir = max((CLI_DIR / "runs" / "drct").glob("*"),
                  key=lambda q: q.stat().st_mtime)
    root = CLI_DIR / "data"
    flagship = Path("workspace") / "chip_smoke_flagship.json"
    bf16_aucs = json.loads(flagship.read_text())["report"]["cli"]["aucs"] \
        if flagship.exists() else {}
    cli = {}
    for mode, per in modes.items():
        tag = "fp32" if mode == "rdg" else "block_fp32"
        os.environ["ADSR_TPU_RDG"] = "1" if mode == "rdg" else "0"
        reset_counts()
        t0 = time.perf_counter()
        res = cli_eval.main(["--run-dir", str(run_dir), "--data-root",
                             str(root), "--sweep-windows", "9",
                             "--output-dir", str(CLI_DIR / f"eval_{tag}")])
        torch.cuda.synchronize()
        cli_wall = time.perf_counter() - t0
        os.environ.pop("ADSR_TPU_RDG")
        cli_launches = counts()
        cli_aucs = [res["auc_ssim"], res["auc_mse"], res["auc_psnr"]]
        lines = (CLI_DIR / f"eval_{tag}" / "scores.txt").read_text() \
            .splitlines()
        say("cli", f"cli.evaluate at its default precision (fp32), {mode} "
                   f"mode, on {run_dir.name}: AUC ssim/mse/psnr "
                   f"{cli_aucs[0]:.4f}/{cli_aucs[1]:.4f}/{cli_aucs[2]:.4f} "
                   f"(bf16 kernels in the flagship phase: "
                   f"{bf16_aucs.get(mode)}), best window {res['best_ws']}; "
                   f"{cli_wall:.1f} s wall; launches {cli_launches}")
        if cli_launches != expected_counts(per, 2) \
                or not all(math.isfinite(a) and 0.0 <= a <= 1.0
                           for a in cli_aucs) or len(lines) != 2 * CLI_TEST:
            raise AssertionError(f"fp32 evaluate CLI ({mode} mode): "
                                 f"launches {cli_launches}, expected {per} x "
                                 f"2; AUCs {cli_aucs}; {len(lines)} score "
                                 "lines")
        figures = check_figures(exp, CLI_DIR / f"eval_{tag}", root, "grid",
                                res)
        paths[f"evaluate_cli_{tag}"] = cli_launches
        cli[mode] = {"aucs": cli_aucs, "bf16_aucs": bf16_aucs.get(mode),
                     "wall_s": cli_wall, "figures": figures,
                     "scores": [res[k] for k in ("scores_ssim", "scores_mse",
                                                 "scores_psnr")]}
    auc_diff = [abs(a - b) for a, b in zip(cli["block"]["aucs"],
                                           cli["rdg"]["aucs"])]
    score_diff = [float(np.abs(np.asarray(a) - np.asarray(b)).max())
                  for a, b in zip(cli["block"].pop("scores"),
                                  cli["rdg"].pop("scores"))]
    say("cli", f"cli.evaluate fp32, block mode vs rdg mode: AUC differences "
               f"{auc_diff} (limit {1 / CLI_TEST ** 2:.4f}), largest score "
               f"difference (1-SSIM, MSE, -PSNR) {score_diff}")
    if max(auc_diff) > 1.0 / CLI_TEST ** 2:
        raise AssertionError(f"fp32 evaluate CLI: block mode's AUCs differ "
                             f"from rdg mode's by {auc_diff}")
    out["cli"] = {**cli["rdg"], "block": {**cli["block"],
                                          "auc_diff_vs_rdg": auc_diff,
                                          "score_diff_vs_rdg": score_diff}}

    lap("cli")
    # the fp32 forwards' time at batch 16, launched and as graphs (the two
    # modes in turns: rdg, block, block, rdg), against their bounds (the
    # kernels' bounds x 12 RDGs)
    fwd_ms, fwd_graph_ms = {}, {}
    with torch.no_grad():
        for mode in ("rdg", "block", "block", "rdg"):
            fwd_ms.setdefault(mode, []).append(cuda_ms(
                lambda: fused_drct_apply(packed, cfg, x, mode=mode), iters=5,
                warmup=1))
            fwd_graph_ms.setdefault(mode, []).append(graph_ms(
                lambda: fused_drct_apply(packed, cfg, x, mode=mode), iters=5))
    bound_ms = {"rdg": cfg.num_layers * sum(t[3] for t in timings.values()),
                "block": cfg.num_layers * (
                    swin["w8"][3] + f32_adjust_bound(cfg, BATCH))}
    wall, families = profile_forward(packed, cfg, x, reps=2)
    busy = sum(families.values())
    for mode in ("rdg", "block"):
        g_ms = min(fwd_graph_ms[mode])
        say("timing", f"fp32 {mode}-mode forward, batch {BATCH}: "
                      f"{' / '.join(f'{v:.3f}' for v in fwd_ms[mode])} ms "
                      "launched, "
                      f"{' / '.join(f'{v:.3f}' for v in fwd_graph_ms[mode])}"
                      f" ms as a CUDA graph = {BATCH * 1e3 / g_ms:.1f} img/s; "
                      f"the kernels' bounds x {cfg.num_layers} RDGs "
                      f"{bound_ms[mode]:.3f} ms (bound / time "
                      f"{bound_ms[mode] / g_ms:.3f})")
    say("timing", "fp32 rdg-mode forward, profiler, device ms per forward: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                      families.items(), key=lambda kv: -kv[1]))
                  + f"; busy {busy:.3f} of {wall:.3f} ms wall")
    out.update(forward_ms=fwd_ms["rdg"][0],
               forward_graph_ms=fwd_graph_ms["rdg"][0],
               forward_bound_ms=bound_ms["rdg"],
               block_forward_ms=fwd_ms["block"],
               block_forward_graph_ms=fwd_graph_ms["block"],
               block_forward_bound_ms=bound_ms["block"],
               rdg_forward_turns_ms=fwd_ms["rdg"],
               rdg_forward_graph_turns_ms=fwd_graph_ms["rdg"],
               profile={"wall_ms": wall, "device_ms": families},
               phase_wall_s=time.perf_counter() - t_phase)
    out["per_rdg_ms"] = {k: {"ms": v[0], "plain_ms": v[1], "library_ms": v[2],
                             "bound_ms": v[3], "bound_by": v[4]}
                         for k, v in timings.items()}
    lap("timing")
    out["walls_s"] = walls
    say("done", f"fp32 phase in {out['phase_wall_s']:.1f} s: "
                + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    PREFIX = None
    return paths, {**timings, "swin_block_f32": swin["w8"][:5]}


# --------------------------------------------------------------------------- #
# fp32 training: the f32 instances of kernels (d)-(f) (TPU kernel 3 at dtype
# f32) beside the training forward's (a)-(c) (TPU kernel 2 at dtype f32), one
# RDG's gradients, the Trainer, cli.main --precision fp32 and cli.evaluate
# --------------------------------------------------------------------------- #

# Limits of fp32 training (written before its first run): each f32 backward
# kernel against its plain f32 version as the forward ones (``F32_REL_L2``,
# ``F32_MAX_ABS`` of the scale: the largest reference value, or for the
# GEMM products the largest sum of |products|); one RDG's output, input
# gradient and every parameter gradient against eager f32 autograd (TF32
# off): relative L2 1e-4 (both sum exact f32 products in another order, and
# an adjust pre-activation within ~1e-7 of 0 may take the other LeakyReLU
# slope); the loss of 20 steps on one batch falls by ``FIXED_BATCH_MIN_DROP``.
F32_RDG_REL_L2 = 1e-4
F32_TRAIN_DIR = CLI_DIR / "fp32_train"


def f32_bwd_case(errs, label, dy, wt, a, kw):
    """One product's backward through ``rdg_gemm_grads`` in f32, twice
    (bitwise equal), against the plain f32 versions."""
    m = dy.shape[0]
    runs = []
    for _ in range(2):
        got = (torch.empty(m, wt.shape[1], device=dy.device),
               torch.empty(wt.shape, device=dy.device),
               torch.empty(wt.shape[0], device=dy.device))
        gbwd.rdg_gemm_grads(dy, wt, a, *got, **kw)
        runs.append(got)
    (out, dw, db), again = runs
    if not all(torch.equal(x, y) for x, y in zip(again, (out, dw, db))):
        raise AssertionError(f"rdg_gemm_bwd f32 {label}: a second call "
                             "differs")
    wkw = {key: v for key, v in kw.items() if key != "gelu_pre"}
    eff = gbwd.dy_effective(dy, kw.get("alpha", 1.0), kw.get("slope_src"),
                            kw.get("row_scale"))
    want = gbwd.rdg_gemm_dgrad_plain(dy, wt, **kw)
    bound = eff.abs() @ wt.abs()
    if "gelu_pre" in kw:
        bound = bound * gbwd.gelu_grad(kw["gelu_pre"]).abs()
    check_f32(errs, "rdg_gemm_bwd_f32", f"{label} dgrad {m}x{wt.shape[0]}"
              f"->{wt.shape[1]}", out, want, bound.max() + want.abs().max())
    want_w, want_b = gbwd.rdg_gemm_wgrad_plain(dy, a, **wkw)
    check_f32(errs, "rdg_gemm_bwd_f32", f"{label} wgrad dW "
              f"{tuple(wt.shape)}", dw, want_w,
              (eff.abs().t() @ a.abs()).max())
    check_f32(errs, "rdg_gemm_bwd_f32", f"{label} wgrad db", db, want_b,
              eff.abs().sum(0).max())


def f32_bwd_bounds(cfg, cat, dcat, blocks, extra, m, masks):
    """:func:`bwd_bounds` for the f32 instances: 4 bytes an element, every
    operation at the f32 peak; (d) f32's and (f) f32's products at 3xTF32
    (their FFMA bounds under ``"ffma"``)."""
    n = cfg.window_size ** 2
    gm_b = gm_ops = ln_b = ln_ops = at_b = at_tc = at_ew = 0.0
    for k, blk in enumerate(blocks):
        c, nh = blk["c"], blk["nh"]
        for _, dy, wt, a, kw, _ in bwd_cases(cfg, cat, dcat, blk, k, extra):
            nn_, kk = wt.shape
            gm_b += 4 * (m * nn_ + nn_ * kk + m * kk)               # dgrad
            gm_b += 4 * (m * nn_ if "slope_src" in kw else 0) \
                + 4 * (m * kk if "gelu_pre" in kw else 0)
            gm_b += 4 * (m * kk + nn_ * kk + nn_)                   # wgrad
            gm_ops += 2 * (2 * m * nn_ * kk)
        for residual in (True, False):
            ln_b += m * c * (4 + 4 + 2 * 4 + (4 if residual else 0)) \
                + 3 * c * 4
            ln_ops += 12 * m * c
        at_b += 4 * (2 * m * 3 * c + m * c + nh * n * n) \
            + attn_operand_bytes(blk, cfg, masks)
        at_tc += 10 * m * n * c                 # its five products
        at_ew += 10 * (m // n) * nh * n * n
    out = {}
    for name, byt, ops in (("rdg_gemm_bwd_f32", gm_b, gm_ops),
                           ("rdg_layernorm_bwd_f32", ln_b, ln_ops),
                           ("window_attention_bwd_f32", at_b, at_tc + at_ew)):
        t_b, t_ops = byt / HBM_BYTES_PER_S, ops / F32_FLOPS
        out[name] = (max(t_b, t_ops) * 1e3,
                     "bytes" if t_b >= t_ops else "operations", byt, ops)
    # (d) f32 and (f) f32 run their products as 3xTF32
    out["ffma"] = {k: out[k] for k in ("rdg_gemm_bwd_f32",
                                       "window_attention_bwd_f32")}
    out["rdg_gemm_bwd_f32"] = tf32x3_bound(gm_b, gm_ops, 0.0)
    out["window_attention_bwd_f32"] = tf32x3_bound(at_b, at_tc, at_ew)
    return out


def f32_bwd_geometry(cfg, dev, errs: dict, label: str, full: bool,
                     ffma: dict = None):
    """The f32 instances of (d)-(f) at ``cfg``'s shapes (batch ``BATCH``):
    (d) at every product of the five blocks, with ``full`` (e) at both
    LayerNorms of each, then (f) at every block and both shifts (at 16x16
    windows fed kernel (c) f32's context and softmax statistics, which are
    checked too), each call twice, bitwise equal; then one RDG's launches
    of each timed beside its bound, its plain version and its library call
    (``torch.matmul`` x 2 in f32 with TF32 off, ATen's LayerNorm backward,
    ``scaled_dot_product_attention``'s f32 backward). Returns {kernel: (ms,
    plain_ms, library_ms, bound_ms, bound_by)}; ``ffma`` as
    :func:`f32_geometry`'s."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    cat, blocks, masks = f32_case_inputs(cfg, dev, gen)
    for blk in blocks:          # qkv's and act's values, 16-byte rows
        blk["dqkv"], blk["dctx"] = blk["qkv"], blk["act"]
    extra = make_bwd_extra(cfg, dev, gen, cat)
    extra["g"], extra["pre"] = extra["g"].float(), extra["pre"].float()
    dcat = extra["dcat"]
    g, m = flagship_shapes(cfg)
    h = w = cfg.img_size
    win = cfg.window_size
    say("kernels", f"{label}: f32 backward kernels against their plain f32 "
                   f"versions at M = {m} token rows, window {win}")
    # (d) at every geometry: wgrad's splits reduce over thousands of rows
    # at M = 65,536 (two-level sums), adjust's N = 32, dgrad with GELU'
    for k, blk in enumerate(blocks):
        for name, dy, wt, a, kw, _ in bwd_cases(cfg, cat, dcat, blk, k,
                                                extra):
            f32_bwd_case(errs, f"b{k + 1} {name}", dy, wt, a, kw)
    if full:
        for k, blk in enumerate(blocks):
            c = blk["c"]
            dy = extra["res"][:, :c].contiguous()
            for name, x, residual in (("ln1 into dcat[:, :c]", cat[:, :c],
                                       extra["res"][:, :c]),
                                      ("ln2 into the stream grad", blk["x1"],
                                       None)):
                runs = []
                for _ in range(2):
                    acc = dcat.clone()
                    dw, db = (torch.empty(c, device=dev) for _ in range(2))
                    rdg_layernorm_bwd(x, dy, blk["ln_w"], acc[:, :c], dw, db,
                                      residual=residual)
                    runs.append((acc, dw, db))
                if not all(torch.equal(p, q) for p, q in zip(*runs)):
                    raise AssertionError(f"rdg_layernorm_bwd f32 b{k + 1} "
                                         f"{name}: a second call differs")
                acc, dw, db = runs[0]
                gx, gw, gb_ = rdg_layernorm_bwd_plain(x, dy, blk["ln_w"])
                want = dcat[:, :c] + gx + (0.0 if residual is None
                                           else residual)
                for part, got, ref in (("dx", acc[:, :c], want),
                                       ("dgamma", dw, gw), ("dbeta", db, gb_)):
                    check_f32(errs, "rdg_layernorm_bwd_f32",
                              f"b{k + 1} c={c} {name} {part}", got, ref,
                              ref.abs().max())
                if not torch.equal(acc[:, c:], dcat[:, c:]):
                    raise AssertionError("rdg_layernorm_bwd f32 wrote past "
                                         "column c")
    attn_fwd = []
    for k, blk in enumerate(blocks):
        c, nh = blk["c"], blk["nh"]
        for shift in (0, win // 2):
            kbias, kmask = attn_operands(blk, masks, h, w, shift, win)
            fwd = ()
            if win in TILED_WINDOWS:
                ctx = pitched(m, c, dtype=torch.float32, device=dev)
                stats = softmax_stats(blk["qkv"], h, w, nh, win)
                want_s = torch.empty_like(stats)
                window_attention(blk["qkv"], ctx, kbias, kmask, h, w, nh, win,
                                 shift, stats)
                window_attention_plain(blk["qkv"], blk["attn_bias"],
                                       masks.get(shift), h, w, nh, win, shift,
                                       want_s)
                for i, part in enumerate(("max", "1/sum")):
                    check_f32(errs, "window_attention_f32", f"b{k + 1} "
                              f"shift={shift} statistics {part}",
                              stats[..., i], want_s[..., i],
                              want_s[..., i].abs().max())
                fwd = (ctx, stats)
                if shift == blk["shift"]:
                    attn_fwd.append(fwd)
            elif shift == blk["shift"]:
                attn_fwd.append(())
            runs = []
            for _ in range(2):
                dqkv = pitched(m, 3 * c, dtype=torch.float32, device=dev)
                dbias = torch.empty(blk["attn_bias"].shape, device=dev)
                window_attention_bwd(blk["qkv"], blk["dctx"], kbias, kmask, h,
                                     w, nh, win, shift, dqkv, dbias, *fwd)
                runs.append((dqkv, dbias))
            if not all(torch.equal(p, q) for p, q in zip(*runs)):
                raise AssertionError(f"window_attention_bwd f32 b{k + 1} "
                                     f"shift={shift}: a second call differs")
            dqkv, dbias = runs[0]
            want_q, want_b = window_attention_bwd_plain(
                blk["qkv"], blk["dctx"], blk["attn_bias"], masks.get(shift),
                h, w, nh, win, shift, *fwd)
            for i, part in enumerate("qkv"):
                ref = want_q[:, i * c:(i + 1) * c]
                check_f32(errs, "window_attention_bwd_f32", f"b{k + 1} c={c} "
                          f"heads={nh} shift={shift} d{part}",
                          dqkv[:, i * c:(i + 1) * c], ref, ref.abs().max())
            check_f32(errs, "window_attention_bwd_f32", f"b{k + 1} "
                      f"shift={shift} dbias", dbias, want_b,
                      want_b.abs().max())
            del runs, dqkv, dbias, want_q, want_b

    # one RDG's launches of each, timed
    cases = [bwd_cases(cfg, cat, dcat, blk, k, extra)
             for k, blk in enumerate(blocks)]
    outs = {(k, i): (torch.empty(m, wt.shape[1], device=dev),
                     torch.empty(wt.shape, device=dev),
                     torch.empty(wt.shape[0], device=dev))
            for k, cs in enumerate(cases)
            for i, (_, _, wt, _, _, _) in enumerate(cs)}
    lib_dy = {id(dy): dy.contiguous() for cs in cases for _, dy, *_ in cs}

    def gemm_bwd_set(mode="kernel"):
        for k, cs in enumerate(cases):
            for i, (_, dy, wt, a, kw, _) in enumerate(cs):
                if mode == "library":
                    torch.matmul(lib_dy[id(dy)], wt)
                    torch.matmul(lib_dy[id(dy)].t(), a)
                elif mode == "plain":
                    gbwd.rdg_gemm_dgrad_plain(dy, wt, **kw)
                    gbwd.rdg_gemm_wgrad_plain(
                        dy, a, **{key: v for key, v in kw.items()
                                  if key != "gelu_pre"})
                else:
                    gbwd.rdg_gemm_grads(dy, wt, a, *outs[k, i], **kw)

    ln_in = []
    for blk in blocks:
        c = blk["c"]
        dy = extra["res"][:, :c].contiguous()
        lib = []
        for x in (cat[:, :c], blk["x1"]):
            xc = x.contiguous()
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                xc, [c], blk["ln_w"], blk["ln_b"], 1e-6)
            lib.append((x, xc, mean, rstd))
        ln_in.append((blk, dy, lib, torch.empty(c, device=dev),
                      torch.empty(c, device=dev)))
    acc = dcat.clone()

    def ln_bwd_set(mode="kernel"):
        for blk, dy, lib, dw, db in ln_in:
            c = blk["c"]
            for j, (x, xc, mean, rstd) in enumerate(lib):
                if mode == "library":
                    torch.ops.aten.native_layer_norm_backward(
                        dy, xc, [c], mean, rstd, blk["ln_w"], blk["ln_b"],
                        [True, True, True])
                elif mode == "plain":
                    rdg_layernorm_bwd_plain(x, dy, blk["ln_w"])
                else:
                    rdg_layernorm_bwd(x, dy, blk["ln_w"], acc[:, :c], dw, db,
                                      residual=dy if j == 0 else None)

    nw = (h // win) * (w // win)
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 14)
    sdpa = []
    for blk in blocks:
        hd = blk["c"] // blk["nh"]
        q, k_, v = (torch.randn(BATCH, nw, blk["nh"], win * win, hd,
                                generator=gen_t, device=dev)
                    .requires_grad_(True) for _ in range(3))
        term = build_attn_term(blk["attn_bias"], h, w, win,
                               masks.get(blk["shift"])).contiguous()
        o = F.scaled_dot_product_attention(q, k_, v, attn_mask=term)
        sdpa.append((o, (q, k_, v), torch.randn(o.shape, generator=gen_t,
                                                device=dev), term))
    attn_out = [(pitched(m, 3 * blk["c"], dtype=torch.float32, device=dev),
                 torch.empty(blk["attn_bias"].shape, device=dev))
                for blk in blocks]

    def attn_bwd_set(mode="kernel"):
        for k, blk in enumerate(blocks):
            nh, shift = blk["nh"], blk["shift"]
            geo = (h, w, nh, win, shift)
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
                                                    win),
                                     *geo, *attn_out[k], *attn_fwd[k])

    bounds = f32_bwd_bounds(cfg, cat, dcat, blocks, extra, m, masks)
    timings = {}
    for name, fn in (("rdg_gemm_bwd_f32", gemm_bwd_set),
                     ("rdg_layernorm_bwd_f32", ln_bwd_set),
                     ("window_attention_bwd_f32", attn_bwd_set)):
        kernel_ms = graph_ms(fn, iters=10)
        plain_ms = graph_ms(lambda: fn("plain"), iters=3)
        how = "CUDA graph"
        if name == "window_attention_bwd_f32":
            library_ms, how = sdpa_bwd_ms(sdpa, lambda: fn("library"),
                                          capture=False)
        else:
            library_ms = graph_ms(lambda: fn("library"), iters=10)
        timings[name] = (kernel_ms, plain_ms, library_ms) + bounds[name][:2]
        say("timing", f"{label} {name:24s} one RDG's launches: kernel "
                      f"{kernel_ms:.4f} ms, "
                      f"{bound_text(name, kernel_ms, bounds)}, plain f32 "
                      f"{plain_ms:.4f} ms, library {library_ms:.4f} ms "
                      f"(device time; library: {how})")
    if ffma is not None:
        ffma.update({k: v[0] for k, v in bounds.get("ffma", {}).items()})
    return timings


def phase_rdg_f32(exp, dev, out):
    """One RDG at full width and batch 16 in f32 (the perturbed seeded
    weights, drop-path zeros): the autograd Function's output and every
    gradient against the eager f32 RDG under autograd with TF32 off, each
    within ``F32_RDG_REL_L2``; two passes bitwise equal; every launch an
    f32 instance."""
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
        xk = x.clone().requires_grad_(True)
        reset_counts()
        packed = prepack_rdg_stack(params, cfg1, h, w, torch.float32, dev,
                                   detach=False)
        res = fused_rdg_train(xk, packed["rdgs"][0], packed["masks"], cfg, h,
                              w, dp)
        torch.autograd.backward(res, gout)
        torch.cuda.synchronize()
        launched = counts()
        runs.append((res.detach(), xk.grad.clone(),
                     {k: p.grad.clone() for k, p in params.items()}))
    want_launches = expected_counts(
        {k: v // cfg.num_layers for k, v in PER_TRAIN_STEP_F32.items()}, 1)
    if launched != want_launches:
        raise AssertionError(f"one f32 RDG launched {launched}, expected "
                             f"{want_launches} (f32 only)")
    same = torch.equal(runs[0][0], runs[1][0]) and \
        torch.equal(runs[0][1], runs[1][1]) and \
        all(torch.equal(runs[0][2][k], runs[1][2][k]) for k in params)
    if not same:
        raise AssertionError("the f32 backward is not deterministic")
    got, gx, grads = runs[0]
    layer.zero_grad(set_to_none=True)
    xp = x.clone().requires_grad_(True)
    with full_f32():
        ref = rdg_train_plain(layer, xp, h, w, dp)
        torch.autograd.backward(ref, gout)
    torch.cuda.synchronize()
    readings = {"out": rel_l2(got, ref.detach()), "dx": rel_l2(gx, xp.grad)}
    for k, p in params.items():
        readings[k[len("layers.0."):]] = rel_l2(grads[k], p.grad)
    worst = max(readings, key=readings.get)
    say("rdg", f"one RDG in f32, batch {BATCH}: f32 kernels vs eager f32 "
               f"autograd (TF32 off), relative L2 of {len(readings)} tensors: "
               f"largest {worst} {readings[worst]:.3e} (limit "
               f"{F32_RDG_REL_L2}), out {readings['out']:.3e}, dx "
               f"{readings['dx']:.3e}, median "
               f"{sorted(readings.values())[len(readings) // 2]:.3e}; two "
               f"passes bitwise equal; launches {launched}")
    out["rdg_rel_l2"] = readings
    if not readings[worst] <= F32_RDG_REL_L2:
        raise AssertionError(f"one f32 RDG vs eager f32: {worst} relative L2 "
                             f"{readings[worst]:.3e} > {F32_RDG_REL_L2}")


class _ConvTF32(torch.overrides.TorchFunctionMode):
    """Records cuDNN's TF32 switch at every ``conv2d`` call inside it."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.conv2d:
            self.seen.add(torch.backends.cudnn.allow_tf32)
        return func(*args, **(kwargs or {}))


def phase_train_f32(exp, dev, out):
    """A fp32 ``Trainer`` on the flagship (drop path live): one epoch of two
    steps and a test of 8, then 20 steps on one batch; every launch f32 and
    per step ``PER_TRAIN_STEP_F32``; the step's convolutions with TF32 off
    although cuDNN's default allows it; one batch's backward twice, bitwise
    equal. Returns (launches, trainer, lrs, hr)."""
    exp = dataclasses.replace(
        exp, data=dataclasses.replace(exp.data, test_every=2),
        optim=dataclasses.replace(exp.optim, epochs=1), print_every=1)
    cfg = exp.model
    rng = np.random.RandomState(SEED + 15)
    trainer = Trainer(exp, train_dataset(rng, 32), train_dataset(rng, 8),
                      device=dev)
    reset_counts()
    t0 = time.perf_counter()
    while not trainer.terminate():
        trainer.train_one_epoch()
    psnr, ssim = trainer.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    want = expected_counts(PER_TRAIN_STEP_F32, exp.data.test_every)
    for k, v in PER_FORWARD_F32.items():
        want[k] += v                      # Trainer.test: one forward of 8
    say("train", f"fp32 Trainer: {exp.data.test_every} steps of batch {BATCH}"
                 f" + test of 8: {wall:.1f} s wall (first calls); test PSNR "
                 f"{psnr:.3f} SSIM {ssim:.4f}; launches {got}")
    if got != want or not (math.isfinite(psnr) and math.isfinite(ssim)):
        raise AssertionError(f"fp32 train launches {got}, expected {want}; "
                             f"test {psnr} {ssim}")

    lrs, hr = next(trainer.sampler.epoch(99))
    step, lr_rate = trainer.train_step, exp.optim.lr
    fixed = []
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True       # cuDNN's own default
    convs = _ConvTF32()
    reset_counts()
    for i in range(FIXED_BATCH_STEPS):
        if i == 0:
            with convs:
                trainer.state, metrics = step(trainer.state, lrs, hr, lr_rate,
                                              trainer.dropout_gen)
            torch.cuda.synchronize()
            per_step = counts()
        else:
            trainer.state, metrics = step(trainer.state, lrs, hr, lr_rate,
                                          trainer.dropout_gen)
        fixed.append(float(metrics["total"]))
    torch.backends.cudnn.allow_tf32 = saved
    drop = 1.0 - fixed[-1] / fixed[0]
    say("train", f"fp32: {FIXED_BATCH_STEPS} steps on one batch at LR "
                 f"{lr_rate}: L1 {fixed[0]:.4f} -> {fixed[-1]:.4f} (drop "
                 f"{drop:.3f}); launches per step {per_step}; cuDNN TF32 "
                 f"inside the step's convolutions {sorted(convs.seen)} (its "
                 "default outside: True)")
    if per_step != expected_counts(PER_TRAIN_STEP_F32, 1):
        raise AssertionError(f"fp32 launches per step {per_step}, expected "
                             f"{PER_TRAIN_STEP_F32}")
    if convs.seen != {False}:
        raise AssertionError(f"fp32 step convolutions with cuDNN TF32 "
                             f"{convs.seen}")
    if not all(math.isfinite(v) for v in fixed) or drop <= FIXED_BATCH_MIN_DROP:
        raise AssertionError(f"fp32 fixed batch: loss {fixed[0]} -> "
                             f"{fixed[-1]}, drop {drop} <= "
                             f"{FIXED_BATCH_MIN_DROP}")

    # the step's backward twice from one state and one set of draws, in the
    # step's own context (cuDNN's deterministic algorithms, TF32 off)
    params = dict(trainer.state.model.named_parameters())
    dp = drop_path_mults(torch.Generator().manual_seed(SEED + 16), cfg, BATCH,
                         deterministic=False).to(dev)
    grads = []
    for _ in range(2):
        for p in params.values():
            p.grad = None
        with deterministic_f32():
            F.l1_loss(fused_drct_train_forward(params, cfg, lrs[0], dp,
                                               torch.float32), hr).backward()
        grads.append({k: p.grad.clone() for k, p in params.items()})
    differ = {k: rel_l2(grads[0][k], grads[1][k]) for k in params
              if not torch.equal(grads[0][k], grads[1][k])}
    if differ:
        raise AssertionError(f"the fp32 step's backward is not bitwise "
                             f"repeatable: {len(differ)} gradients differ, "
                             f"relative L2 {differ}")
    say("train", f"fp32 backward of one batch twice: {len(params)} gradients "
                 "bitwise equal")
    for p in params.values():
        p.grad = None
    out["train"] = {"losses_test": [psnr, ssim], "launches": got,
                    "wall_s": wall, "fixed_batch": fixed, "drop": drop,
                    "launches_per_step": per_step}
    return got, trainer, lrs, hr


def f32_step_timing(exp, dev, trainer, lrs, hr, out):
    """The fp32 step at batch 16 (CUDA events), its forward and backward,
    its peak memory, a profiler breakdown and idle share, and its bound:
    every product's flops at the f32 peak."""
    cfg = exp.model
    g, m = flagship_shapes(cfg)
    state, step = trainer.state, trainer._bundle.step
    gen = trainer.dropout_gen
    lr_rate = exp.optim.lr

    def train_step():
        step(state, lrs, hr, lr_rate, gen)

    params = dict(state.model.named_parameters())
    dp = drop_path_mults(gen, cfg, BATCH, deterministic=False).to(dev)

    def forward_only():
        with deterministic_f32():
            return F.l1_loss(fused_drct_train_forward(params, cfg, lrs[0], dp,
                                                      torch.float32), hr)

    def forward_backward():
        loss = forward_only()
        with deterministic_f32():
            loss.backward()

    step_ms = cuda_ms(train_step, iters=TRAIN_TIMED, warmup=2)
    fwd_ms = cuda_ms(forward_only, iters=TRAIN_TIMED, warmup=1)
    fb_ms = cuda_ms(forward_backward, iters=TRAIN_TIMED, warmup=1)
    for p in params.values():
        p.grad = None
    torch.cuda.reset_peak_memory_stats()
    train_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    wall, families = profile_steps(train_step)
    busy = sum(families.values())
    flops = cfg.num_layers * rdg_train_flops(cfg, m)
    packed = prepack_drct(state.model.state_dict(), cfg, cfg.img_size,
                          cfg.img_size, dtype=torch.float32, device=dev)
    head = 3 * head_tail_flops(packed, cfg, BATCH)
    bound_ms = (flops + head) / F32_FLOPS * 1e3
    idle = max(0.0, 1 - busy / wall)
    say("train-timing", f"fp32 train step, batch {BATCH}: {step_ms:.3f} ms = "
                        f"{BATCH * 1e3 / step_ms:.1f} img/s; training forward "
                        f"+ loss {fwd_ms:.3f} ms, forward + backward "
                        f"{fb_ms:.3f} ms (backward {fb_ms - fwd_ms:.3f} ms); "
                        f"peak device memory {peak / 2 ** 30:.2f} GiB; step "
                        f"flops {(flops + head) / 1e9:.1f} GFLOP, bound at the "
                        f"f32 peak {bound_ms:.3f} ms (bound / time "
                        f"{bound_ms / step_ms:.3f})")
    say("train-timing", "fp32 profiler, device ms per step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(families.items(),
                                          key=lambda kv: -kv[1]))
        + f"; busy {busy:.3f} of {wall:.3f} ms wall under the profiler (idle "
          f"share {idle:.3f})")
    out["step"] = {"step_ms": step_ms, "img_per_s": BATCH * 1e3 / step_ms,
                   "forward_ms": fwd_ms, "forward_backward_ms": fb_ms,
                   "peak_bytes": peak, "step_gflop": (flops + head) / 1e9,
                   "bound_ms": bound_ms, "profile_wall_ms": wall,
                   "profile_device_ms": families, "idle_share": idle}


def phase_cli_f32(exp, dev, out):
    """``cli.main --precision fp32`` trains the flagship one epoch on the
    flagship phase's synthetic data root (16 steps, every launch f32, the
    val/good test), then ``cli.evaluate`` at its fp32 default scores 8 + 8
    test images of 512 px from that run dir. Returns the launches by
    path."""
    root = CLI_DIR / "data"
    if not (root / "grid" / "train" / "good").is_dir():
        raise AssertionError(f"{root}: the flagship phase's data root is "
                             "missing")
    shutil.rmtree(F32_TRAIN_DIR, ignore_errors=True)
    os.environ["ADSR_TPU_RDG"] = "1"
    reset_counts()
    t0 = time.perf_counter()
    run_dir = cli_main.main(["--resolution", str(HR), "--scale", str(SCALE),
                             "--epochs", "1", "--batch-size", str(BATCH),
                             "--data-root", str(root), "--precision", "fp32",
                             "--save-dir", str(F32_TRAIN_DIR / "runs"),
                             "--run-tag", "chip_fp32"])
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train = counts()
    steps = 256 // BATCH                  # the reference's mvtec cadence
    want = expected_counts(PER_TRAIN_STEP_F32, steps)
    for k, v in PER_FORWARD_F32.items():  # the val/good test: one forward
        want[k] += v
    run = Path(run_dir)
    log = (run / "log.txt").read_text()
    losses = json.loads((run / "loss_log.json").read_text())
    say("cli", f"cli.main --precision fp32: {steps} steps at batch {BATCH} and "
               f"the val/good test in {train_wall:.1f} s wall (first calls); "
               f"epoch loss {losses[0]}; launches {train}")
    if train != want or "Using devices: cuda" not in log \
            or not all(math.isfinite(v) for v in losses[0].values()) \
            or not (run / "model" / "model_best.pt").exists():
        raise AssertionError(f"fp32 train CLI: launches {train}, expected "
                             f"{want}; run dir {run}")
    reset_counts()
    t0 = time.perf_counter()
    res = cli_eval.main(["--run-dir", run_dir, "--data-root", str(root),
                         "--sweep-windows", "9",
                         "--output-dir", str(F32_TRAIN_DIR / "eval")])
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    os.environ.pop("ADSR_TPU_RDG")
    evaluate = counts()
    aucs = [res["auc_ssim"], res["auc_mse"], res["auc_psnr"]]
    lines = (F32_TRAIN_DIR / "eval" / "scores.txt").read_text().splitlines()
    say("cli", f"cli.evaluate at fp32 on the fp32 run dir {run.name}: AUC "
               f"ssim/mse/psnr {aucs[0]:.4f}/{aucs[1]:.4f}/{aucs[2]:.4f}, best "
               f"window {res['best_ws']}; {eval_wall:.1f} s wall; launches "
               f"{evaluate}")
    if evaluate != expected_counts(PER_FORWARD_F32, 2) \
            or not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs) \
            or len(lines) != 2 * CLI_TEST:
        raise AssertionError(f"fp32 evaluate CLI: launches {evaluate}, "
                             f"expected {PER_FORWARD_F32} x 2; AUCs {aucs}; "
                             f"{len(lines)} score lines")
    out["cli"] = {"train_wall_s": train_wall, "epoch_loss": losses[0],
                  "eval_wall_s": eval_wall, "aucs": aucs}
    return {"train_cli_fp32": train, "evaluate_cli_fp32_train": evaluate}


def phase_fp32_train(dev, report):
    """fp32 DRCT training on the card (kernels (a)-(f) in f32), in a process
    of its own after the fp32 serving phase: the f32 backward kernels
    against their plain versions at windows 8 (the flagship), 4 and 16 and
    their times; one RDG's gradients against eager f32; a fp32 ``Trainer``;
    the fp32 step's time and idle share; ``cli.main --precision fp32`` and
    ``cli.evaluate`` on its run dir. Returns (launches by path, the
    flagship's kernel timings)."""
    global PREFIX
    PREFIX = "fp32_train"
    t_phase = time.perf_counter()
    out = report.setdefault("fp32_train", {})
    exp = drct_experiment("grid", HR, SCALE, precision="fp32",
                          batch_size=BATCH, run_tag="chip_smoke_fp32_train")
    errs = {}
    reset_counts()
    ffma = out.setdefault("ffma_bound_ms", {})
    timings = f32_bwd_geometry(exp.model, dev, errs, "w8", full=True,
                               ffma=ffma.setdefault("w8", {}))
    out["max_abs_err"] = dict(errs)
    for tag, geo in (("w4", (64, 4)), ("w16", (256, 4))):
        e = {}
        t = f32_bwd_geometry(drct_experiment("grid", *geo, precision="fp32",
                                             run_tag="t").model,
                             dev, e, tag, full=False,
                             ffma=ffma.setdefault(tag, {}))
        out[f"timings_{tag}"] = {k: list(v) for k, v in t.items()}
        out[f"max_abs_err_{tag}"] = e
        torch.cuda.empty_cache()
    if any(counts().get(k) for k in WRAPPERS):
        raise AssertionError(f"the f32 backward cases launched bf16 kernels: "
                             f"{counts()}")
    phase_rdg_f32(exp, dev, out)
    launches, trainer, lrs, hr = phase_train_f32(exp, dev, out)
    f32_step_timing(exp, dev, trainer, lrs, hr, out)
    del trainer
    torch.cuda.empty_cache()
    paths = {"train_fp32": launches, **phase_cli_f32(exp, dev, out)}
    out["per_rdg_ms"] = {k: {"ms": v[0], "plain_ms": v[1], "library_ms": v[2],
                             "bound_ms": v[3], "bound_by": v[4]}
                         for k, v in timings.items()}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    say("done", f"fp32_train phase in {out['phase_wall_s']:.1f} s")
    PREFIX = None
    return paths, timings


PHASES = {"flagship": phase_flagship, "fp32": phase_fp32,
          "fp32_train": phase_fp32_train, "w16": phase_w16, "w4": phase_w4,
          "smoke": phase_smoke, "drn": phase_drn, "ead": phase_ead,
          "mesh": phase_mesh}


def run_phase(name: str) -> dict:
    """Phase ``name`` of ``PHASES`` in a process of its own (this script with
    ``--phase name OUT``), so that each geometry starts with an empty
    caching allocator: one process that ran them all held more device
    memory in cached segments that ``torch.cuda.empty_cache`` did not
    release with every phase (``scripts/torch_smoke_memory.py``: 31.5 GiB
    after the flagship's phases, 75.5 after window 16's on an H100 80GB
    HBM3), until the window-4 phase's tiled capture ran out of memory. Its
    lines go to this process's output.
    Returns its {"paths", "timings", "report"}."""
    out = Path("workspace") / f"chip_smoke_{name}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                         "--phase", name, str(out)]).returncode
    if rc:
        raise AssertionError(f"the {name} phase failed (exit {rc})")
    return json.loads(out.read_text())


def phase_child(name: str, out: str) -> int:
    """The body of :func:`run_phase`'s process: phase ``name`` on the card,
    its launches by path, timings and report written to ``out``."""
    card_setup()
    report = {}
    paths, timings = PHASES[name](torch.device(DEVICE), report)
    Path(out).write_text(json.dumps({"paths": paths, "timings": timings,
                                     "report": report}))
    return 0


def ffma_key(phase_report: dict, tag: str, kernel: str) -> dict:
    """{"bound_ffma_ms": ms} where ``kernel``'s bound_ms at ``tag`` is its
    3xTF32 bound (its products on the tensor cores), else {}."""
    ms = phase_report.get("ffma_bound_ms", {}).get(tag, {}).get(kernel)
    return {} if ms is None else {"bound_ffma_ms": ms}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--phase":
        return phase_child(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs one",
              file=sys.stderr)
        return 1
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
    report["tensor_core_f32"] = check_tensor_core_builds(lib.parent)

    # each geometry in a process of its own (run_phase)
    runs, walls = {}, {}
    for name in PHASES:
        t0 = time.perf_counter()
        runs[name] = run_phase(name)
        walls[name] = time.perf_counter() - t0
    say("phases", "walls (s, each its own process): " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()))
    report["phase_walls_s"] = walls
    for run in runs.values():
        report.update(run["report"])
    timings, timings16, timings4 = (runs[name]["timings"]
                                    for name in ("flagship", "w16", "w4"))

    # launches by main path, each counted from 0 over that path's run (a
    # captured path's: its warm-up and its capture)
    paths = {p: got for run in runs.values()
             for p, got in run["paths"].items()}
    kernels = []
    for k in KERNELS + BWD_KERNELS + BLOCK_KERNELS:
        kernel_ms, plain_ms, library_ms, bound_ms, bound_by = timings[k]
        names = ("rdg_gemm_dgrad", "rdg_gemm_wgrad") \
            if k == "rdg_gemm_bwd" else (k,)
        by_path = {p: sum(got[n] for n in names) for p, got in paths.items()}
        # the DRN and EfficientAD paths stay in the record with their 0s:
        # they run no kernel of the port
        by_path = {p: n for p, n in by_path.items()
                   if n or p in ("drn", "efficientad")}
        if k in KERNELS:
            replaces = f"{REPLACES}; {REPLACES_TRAIN_FWD}"
        elif k in BWD_KERNELS:
            replaces = REPLACES_BWD
        else:
            replaces = REPLACES_BLOCK
        if not any(by_path.values()):
            raise AssertionError(f"{k}: launched on no main path")
        entry = {"name": k, "route": "cuda", "source": SOURCES[k],
                 "replaces": replaces,
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": report["max_abs_err"][k], "ms": kernel_ms,
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
        if k in timings4:       # at 4x4 windows, M = 4,096 token rows
            kernel_ms, plain_ms, library_ms, bound_ms, bound_by = timings4[k]
            entry["w4"] = {"source": W4_SOURCES.get(k, SOURCES[k]),
                           "ms": kernel_ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": library_ms,
                           "max_abs_err": report["w4"]["max_abs_err"][k]}
        kernels.append(entry)
    # the f32 instances of (a)-(c): the fp32 phase's readings at the
    # flagship (window 8), and under "w4" / "w16" at those geometries
    f32 = report["fp32"]
    for k in F32_KERNELS:
        kernel_ms, plain_ms, library_ms, bound_ms, bound_by = \
            runs["fp32"]["timings"][k]
        by_path = {p: got[k] for p, got in paths.items() if got.get(k)}
        if not by_path:
            raise AssertionError(f"{k}: launched on no main path")
        entry = {"name": k, "route": "cuda", "source": F32_SOURCES[k],
                 "replaces": f"{REPLACES}; {REPLACES_TRAIN_FWD} (dtype f32)",
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": f32["max_abs_err"][k], "ms": kernel_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms,
                 **ffma_key(f32, "w8", k)}
        for tag in ("w4", "w16"):
            kernel_ms, plain_ms, library_ms, bound_ms, bound_by = \
                f32[f"timings_{tag}"][k]
            entry[tag] = {"source": F32_WINDOW_SOURCES[tag]
                          if k == "window_attention_f32" else F32_SOURCES[k],
                          "ms": kernel_ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms,
                          "max_abs_err": f32[f"max_abs_err_{tag}"].get(k),
                          **ffma_key(f32, tag, k)}
        kernels.append(entry)
    # the f32 instance of (g): the fp32 phase's readings at the flagship
    # (window 8), and under "w4" / "w16" at those geometries, each beside
    # the (a)-(c) f32 composition
    swin = f32["swin_block_f32"]
    by_path = {p: got["swin_block_f32"] for p, got in paths.items()
               if got.get("swin_block_f32")}
    if not by_path:
        raise AssertionError("swin_block_f32: launched on no main path")
    entry = {"name": "swin_block_f32", "route": "cuda",
             "source": F32_SWIN_SOURCES["w8"],
             "replaces": f"{REPLACES_BLOCK} (dtype f32)",
             "counter": "launches_f32", "launches": sum(by_path.values()),
             "launches_by_path": by_path,
             "max_abs_err": f32["max_abs_err"]["swin_block_f32"],
             **{k: swin["w8"][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "composition_ms",
                                           "bound_ffma_ms")}}
    for tag in ("w4", "w16"):
        entry[tag] = {"source": F32_SWIN_SOURCES[tag], **swin[tag],
                      "max_abs_err":
                      f32[f"max_abs_err_{tag}"]["swin_block_f32"]}
    kernels.append(entry)
    # the f32 instances of (d)-(f): the fp32_train phase's readings at the
    # flagship, and under "w4" / "w16" at those geometries; their launches
    # are each wrapper's ``launches_f32``
    ft = report["fp32_train"]
    for k in F32_BWD_KERNELS:
        kernel_ms, plain_ms, library_ms, bound_ms, bound_by = \
            runs["fp32_train"]["timings"][k]
        names = ("rdg_gemm_dgrad_f32", "rdg_gemm_wgrad_f32") \
            if k == "rdg_gemm_bwd_f32" else (k,)
        by_path = {p: sum(got.get(n, 0) for n in names)
                   for p, got in paths.items()}
        by_path = {p: n for p, n in by_path.items() if n}
        if not by_path:
            raise AssertionError(f"{k}: launched on no main path")
        entry = {"name": k, "route": "cuda", "source": F32_BWD_SOURCES[k],
                 "replaces": f"{REPLACES_BWD} (dtype f32)",
                 "counter": "launches_f32",
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": ft["max_abs_err"][k], "ms": kernel_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms,
                 **ffma_key(ft, "w8", k)}
        for tag in ("w4", "w16"):
            kernel_ms, plain_ms, library_ms, bound_ms, bound_by = \
                ft[f"timings_{tag}"][k]
            entry[tag] = {"source": F32_BWD_WINDOW_SOURCES[tag]
                          if k == "window_attention_bwd_f32"
                          else F32_BWD_SOURCES[k],
                          "ms": kernel_ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms,
                          "max_abs_err": ft[f"max_abs_err_{tag}"].get(k),
                          **ffma_key(ft, tag, k)}
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
