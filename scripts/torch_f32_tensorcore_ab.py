#!/usr/bin/env python3
"""The f32 kernels that run their products as 3xTF32 on the tensor cores,
(b) f32 (``csrc/rdg_gemm_f32.cu``), (c) f32
(``csrc/window_attention_tc_f32.cuh``), (d) f32
(``csrc/rdg_gemm_bwd_f32.cu``), (f) f32
(``csrc/window_attention_bwd_f32.cuh``) and (g) f32
(``csrc/swin_block_f32.cuh``), and the fp32 forwards and training forward +
backward they make up, against another checkout's (say the parent's) on
one CUDA card, in turns.

    python3 scripts/torch_f32_tensorcore_ab.py --parent DIR [--turns 1]

``DIR`` is a ``git archive`` of the other commit, unpacked (a directory
that ``.gitignore`` lists, such as ``build/parent``). Each turn runs one
process per tree (the other's first, then this one's, then this one's, then
the other's, and so on), each building its tree's kernels into its own
``build/`` and timing, with the port's wrappers (whose C entries and
arguments both trees share), every reading a CUDA graph replayed 10 times
between CUDA events:

- ``gemm_f32``: one flagship RDG's 25 f32 products (qkv, proj, fc1, fc2,
  adjust of each of the five blocks, their main-path epilogues) at 16,384
  (window 8), 4,096 (window 4) and 65,536 (window 16) token rows; beside it
  the same products through ``F.linear`` with TF32 off (``f_linear``);
- ``gemm_bwd_f32``: one RDG's 25 dgrad and 25 wgrad products through
  ``rdg_gemm_grads`` with the training backward's dY transforms (adjust's
  LeakyReLU' or 0.2, fc2's drop-path multiplier and GELU', proj's
  multiplier) at the same three M; beside it ``torch.matmul`` x 2 (dY @ W
  and dY^T @ A) with TF32 off (``matmul_x2``);
- ``attention_f32``: one RDG's five (c) f32 calls (each block at its own
  shift) at batch 16 on 32 x 32 tokens (window 8), 16 x 16 (window 4) and
  64 x 64 (window 16, writing the statistics); beside it
  ``scaled_dot_product_attention`` in f32 on the same shapes with a float
  mask (``sdpa_f32``);
- ``attention_bwd16_f32``: one RDG's five (f) f32 calls at the 256px/x4
  geometry (batch 16 on 64 x 64 tokens, 16x16 windows, each block at its
  own shift), fed kernel (c) f32's context and statistics; then a digest
  of their result fed the plain version's (``attention_bwd16_f32_digest``,
  equal where (f) f32 computes the same);
- ``attention_bwd_f32``: one RDG's five (f) f32 calls at batch 16 on 32 x
  32 tokens (window 8) and 16 x 16 (window 4), each block at its own
  shift; beside it ``scaled_dot_product_attention``'s f32 backward on the
  same shapes with a float mask, launched (``sdpa_bwd_f32``; autograd does
  not capture);
- ``swin_block_f32``: one RDG's five f32 (g) launches (the blocks' own
  seeded weights, each at its shift) at batch 16 at windows 8 (the
  flagship), 4 (64/x4) and 16 (256px/x4); beside it the library sum of the
  same block (``library_sum``: ``F.layer_norm`` x 2, ``F.linear`` x 4 with
  TF32 off, SDPA f32 with a float mask);
- ``fp32_forward``: the flagship's fp32 serving forward (rdg mode, batch
  16, seeded weights; with a digest of its SR), ``fp32_block_forward`` in
  block mode (f32 (g) and (b)'s adjust; with a digest of its SR) and
  ``fp32_train_fb``: its fp32
  training forward + loss + backward (``fused_drct_train_forward`` with
  drop path, cuDNN TF32 off, timed launched: autograd does not capture).

Prints one line a tree a turn, then one JSON line with every reading, the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# one process's timing (run with the tree on sys.path first)
CHILD = r"""
import hashlib, json, sys
import torch
import torch.nn.functional as F
sys.path.insert(0, sys.argv[1])
from adsr_tpu_torch.core.config import drct_experiment
from adsr_tpu_torch.core.device import deterministic_f32
from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels import rdg_gemm_bwd as gb
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.kernels.fused_rdg import prepack_rdg_stack
from adsr_tpu_torch.kernels.fused_rdg_train import fused_drct_train_forward
from adsr_tpu_torch.kernels.fused_swin_block import fused_swin_block
from adsr_tpu_torch.kernels.rdg_gemm import pitched, rdg_gemm
from adsr_tpu_torch.kernels.window_attention import (softmax_stats,
                                                     window_attention,
                                                     window_attention_plain)
from adsr_tpu_torch.kernels.window_attention_bwd import window_attention_bwd
from adsr_tpu_torch.models.drct import (drop_path_mults, shift_attn_mask,
                                        shift_region_labels)
from adsr_tpu_torch.models.factory import init_sr_params
assert _build.CSRC.parent.parent == __import__("pathlib").Path(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(24)

def graph_ms(fn, iters=10):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(); fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters

def rand(m, n, std=1.0):
    t = pitched(m, n, torch.float32, dev)
    t.copy_(std * torch.randn(m, n, generator=gen, device=dev))
    return t

feats, hidden = (180, 212, 244, 276, 308), (360, 424, 488, 276, 308)
out = {}
for tag, m in (("w8", 16384), ("w4", 4096), ("w16", 65536)):
    cases = []
    for k, (c, f) in enumerate(zip(feats, hidden)):
        a = 180 if k == 4 else 32
        x, ctx, hid = rand(m, c), rand(m, c), rand(m, f)
        for n, src, epi in ((3 * c, x, "none"), (c, ctx, "residual"),
                            (f, x, "gelu"), (c, hid, "residual"),
                            (a, x, "scaled_residual" if k == 4
                             else "leaky_relu")):
            kk = src.shape[1]
            res = rand(m, n) if "residual" in epi else None
            cases.append((src, rand(n, kk, 0.05),
                          0.05 * torch.randn(n, generator=gen, device=dev),
                          rand(m, n), epi, res))
    def kernel():
        for src, w, bias, dst, epi, res in cases:
            rdg_gemm(src, w, bias, dst, epi, res)
    def library():
        for src, w, bias, dst, epi, res in cases:
            F.linear(src, w, bias)
    out[f"gemm_f32_{tag}"] = graph_ms(kernel)
    out[f"f_linear_{tag}"] = graph_ms(library)
    del cases
    torch.cuda.empty_cache()

for tag, m in (("w8", 16384), ("w4", 4096), ("w16", 65536)):
    cases = []
    for k, (c, f) in enumerate(zip(feats, hidden)):
        a = 180 if k == 4 else 32
        act, hid, ctx_ = rand(m, c), rand(m, f), rand(m, c)
        scale = torch.ones(16, device=dev)
        scale[1] = 0.0
        adj = ({"alpha": 0.2} if k == 4
               else {"slope_src": torch.randn(m, a, generator=gen,
                                              device=dev)})
        for n, src, kw in ((a, act, adj),
                           (c, hid, {"row_scale": scale,
                                     "gelu_pre": rand(m, f)}),
                           (f, act, {}), (c, ctx_, {"row_scale": scale}),
                           (3 * c, act, {})):
            kk = src.shape[1]
            cases.append((rand(m, n), rand(n, kk, 0.05), src, kw,
                          torch.empty(m, kk, device=dev),
                          torch.empty(n, kk, device=dev),
                          torch.empty(n, device=dev)))
    def kernel():
        for dy, w, src, kw, da, dw, db in cases:
            gb.rdg_gemm_grads(dy, w, src, da, dw, db, **kw)
    def library():
        for dy, w, src, kw, da, dw, db in cases:
            torch.matmul(dy, w)
            torch.matmul(dy.t(), src)
    out[f"gemm_bwd_f32_{tag}"] = graph_ms(kernel)
    out[f"matmul_x2_{tag}"] = graph_ms(library)
    del cases
    torch.cuda.empty_cache()

shifts = (0, 1, 0, 1, 0)        # each block at its own shift (a half window)
heads = (6, 4, 2, 6, 4)
for tag, win, side in (("w8", 8, 32), ("w4", 4, 16), ("w16", 16, 64)):
    m, n = 16 * side * side, win * win
    nw = (side // win) ** 2
    calls, sdpa = [], []
    for c, nh, sh in zip(feats, heads, shifts):
        shift = sh * win // 2
        qkv = rand(m, 3 * c)
        if win == 16:
            bias = 0.5 * torch.randn(nh, 961, generator=gen, device=dev)
            mask = (torch.as_tensor(shift_region_labels(side, side, win,
                                                        shift), device=dev)
                    if shift else None)
        else:
            bias = 0.5 * torch.randn(nh, n, n, generator=gen, device=dev)
            mask = (torch.as_tensor(shift_attn_mask(side, side, win, shift),
                                    device=dev) if shift else None)
        stats = softmax_stats(qkv, side, side, nh, win)
        calls.append((qkv, pitched(m, c, torch.float32, dev), bias, mask, nh,
                      shift, stats))
        q, k_, v = (torch.randn(16, nw, nh, n, c // nh, generator=gen,
                                device=dev) for _ in range(3))
        sdpa.append((q, k_, v, torch.randn(nw, nh, n, n, generator=gen,
                                           device=dev)))
    def attn():
        for qkv, ctx, bias, mask, nh, shift, stats in calls:
            window_attention(qkv, ctx, bias, mask, side, side, nh, win, shift,
                             stats)
    def attn_library():
        for q, k_, v, term in sdpa:
            F.scaled_dot_product_attention(q, k_, v, attn_mask=term)
    out[f"attention_f32_{tag}"] = graph_ms(attn)
    out[f"sdpa_f32_{tag}"] = graph_ms(attn_library)
    del calls, sdpa
    torch.cuda.empty_cache()

side, b, win = 64, 16, 16
m = b * side * side
calls = []
for c, nh, shift in ((180, 6, 0), (212, 4, 8), (244, 2, 0), (276, 6, 8),
                     (308, 4, 0)):
    qkv, dout = rand(m, 3 * c), rand(m, c)
    bias = 0.5 * torch.randn(nh, 961, generator=gen, device=dev)
    mask = (torch.as_tensor(shift_region_labels(side, side, win, shift),
                            device=dev) if shift else None)
    ctx = pitched(m, c, torch.float32, dev)
    stats = softmax_stats(qkv, side, side, nh, win)
    window_attention(qkv, ctx, bias, mask, side, side, nh, win, shift, stats)
    calls.append((qkv, dout, bias, mask, nh, shift, pitched(m, 3 * c,
                  torch.float32, dev), torch.empty(nh, 256, 256, device=dev),
                  ctx, stats))
def attn_bwd():
    for qkv, dout, bias, mask, nh, shift, dqkv, dbias, ctx, stats in calls:
        window_attention_bwd(qkv, dout, bias, mask, side, side, nh, win,
                             shift, dqkv, dbias, ctx, stats)
out["attention_bwd16_f32_w16"] = graph_ms(attn_bwd)
# (f) f32's result on inputs no kernel of this script made (the plain
# version's context and statistics), as a digest both trees can match
digest = hashlib.sha256()
for qkv, dout, bias, mask, nh, shift, dqkv, dbias, ctx, stats in calls:
    ctx.copy_(window_attention_plain(qkv, bias, mask, side, side, nh, win,
                                     shift, stats))
    window_attention_bwd(qkv, dout, bias, mask, side, side, nh, win, shift,
                         dqkv, dbias, ctx, stats)
    digest.update(dqkv.cpu().numpy().tobytes())
    digest.update(dbias.cpu().numpy().tobytes())
out["attention_bwd16_f32_digest"] = digest.hexdigest()[:16]
del calls
torch.cuda.empty_cache()

for tag, win, side in (("w8", 8, 32), ("w4", 4, 16)):
    m, n = 16 * side * side, win * win
    nw = (side // win) ** 2
    calls, sdpa = [], []
    for c, nh, sh in zip(feats, heads, shifts):
        shift = sh * win // 2
        mask = (torch.as_tensor(shift_attn_mask(side, side, win, shift),
                                device=dev) if shift else None)
        calls.append((rand(m, 3 * c), rand(m, c),
                      0.5 * torch.randn(nh, n, n, generator=gen, device=dev),
                      mask, nh, shift, pitched(m, 3 * c, torch.float32, dev),
                      torch.empty(nh, n, n, device=dev)))
        ins = tuple(torch.randn(16, nw, nh, n, c // nh, generator=gen,
                                device=dev, requires_grad=True)
                    for _ in range(3))
        o = F.scaled_dot_product_attention(
            *ins, attn_mask=torch.randn(nw, nh, n, n, generator=gen,
                                        device=dev))
        sdpa.append((o, ins, torch.randn(o.shape, generator=gen, device=dev)))
    def attn_bwd():
        for qkv, dout, bias, mask, nh, shift, dqkv, dbias in calls:
            window_attention_bwd(qkv, dout, bias, mask, side, side, nh, win,
                                 shift, dqkv, dbias)
    out[f"attention_bwd_f32_{tag}"] = graph_ms(attn_bwd)
    def sdpa_bwd():
        for o, ins, do in sdpa:
            torch.autograd.grad(o, ins, do, retain_graph=True)
    sdpa_bwd()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(10):
        sdpa_bwd()
    t1.record()
    torch.cuda.synchronize()
    out[f"sdpa_bwd_f32_{tag}"] = t0.elapsed_time(t1) / 10
    del calls, sdpa
    torch.cuda.empty_cache()

for tag, hr_px in (("w8", 128), ("w4", 64), ("w16", 256)):
    cfg_g = drct_experiment("grid", hr_px, 4, precision="fp32",
                            run_tag="ab").model
    side, win = cfg_g.img_size, cfg_g.window_size
    m, nw, n = 16 * side * side, (side // cfg_g.window_size) ** 2, win * win
    params_g, _ = init_sr_params(cfg_g, torch.Generator().manual_seed(27),
                                 device=dev)
    stack = prepack_rdg_stack(params_g, cfg_g, side, side, torch.float32,
                              dev)
    blocks, masks = stack["rdgs"][0], stack["masks"]
    x = rand(m, 308)
    outs = [pitched(m, c, torch.float32, dev) for c in feats]
    def swin():
        for k, p in enumerate(blocks):
            fused_swin_block(x[:, :feats[k]], p, masks, cfg_g, side, side, k,
                             outs[k])
    out[f"swin_block_f32_{tag}"] = graph_ms(swin)
    lib = [tuple(torch.randn(16, nw, nh, n, c // nh, generator=gen,
                             device=dev) for _ in range(3))
           + (torch.randn(nw, nh, n, n, generator=gen, device=dev),
              rand(m, c)) for c, nh in zip(feats, heads)]
    def swin_library():
        for k, p in enumerate(blocks):
            c = feats[k]
            q, k_, v, term, ctx = lib[k]
            xs = x[:, :c]
            ln = F.layer_norm(xs, (c,), p["ln1_w"], p["ln1_b"], eps=1e-6)
            F.linear(ln, p["wqkv"], p["bqkv"])
            F.scaled_dot_product_attention(q, k_, v, attn_mask=term)
            x1 = F.linear(ctx, p["wproj"], p["bproj"]) + xs
            hid = F.gelu(F.linear(F.layer_norm(x1, (c,), p["ln2_w"],
                                               p["ln2_b"], eps=1e-6),
                                  p["w1"], p["b1"]))
            F.linear(hid, p["w2"], p["b2"]).add_(x1)
    out[f"library_sum_{tag}"] = graph_ms(swin_library)
    del blocks, masks, stack, x, outs, lib
    torch.cuda.empty_cache()

exp = drct_experiment("grid", 128, 4, precision="fp32", batch_size=16,
                      run_tag="ab")
cfg = exp.model
params, _ = init_sr_params(cfg, torch.Generator().manual_seed(25), device=dev)
packed = prepack_drct(params, cfg, cfg.img_size, cfg.img_size,
                      dtype=torch.float32, device=dev, mode="rdg")
lr = torch.rand(16, cfg.img_size, cfg.img_size, cfg.in_chans, generator=gen,
                device=dev)
hr = torch.rand(16, 4 * cfg.img_size, 4 * cfg.img_size, cfg.in_chans,
                generator=gen, device=dev)
block = prepack_drct(params, cfg, cfg.img_size, cfg.img_size,
                     dtype=torch.float32, device=dev, mode="block")
with torch.no_grad():
    out["fp32_forward_w8"] = graph_ms(
        lambda: fused_drct_apply(packed, cfg, lr, mode="rdg"))
    sr = fused_drct_apply(packed, cfg, lr, mode="rdg")
    out["fp32_forward_digest"] = hashlib.sha256(
        sr.cpu().numpy().tobytes()).hexdigest()[:16]
    # block mode: (g) f32 and (b) f32's adjust, and its result's digest
    out["fp32_block_forward_w8"] = graph_ms(
        lambda: fused_drct_apply(block, cfg, lr, mode="block"))
    sr = fused_drct_apply(block, cfg, lr, mode="block")
    out["fp32_block_forward_digest"] = hashlib.sha256(
        sr.cpu().numpy().tobytes()).hexdigest()[:16]
leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
dp = drop_path_mults(torch.Generator().manual_seed(26), cfg, 16,
                     deterministic=False).to(dev)
def train_fb():
    with deterministic_f32():
        loss = F.l1_loss(fused_drct_train_forward(leaves, cfg, lr, dp,
                                                  torch.float32), hr)
        loss.backward()
    for v in leaves.values():
        v.grad = None
train_fb(); train_fb()
torch.cuda.synchronize()
t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
t0.record()
for _ in range(10):
    train_fb()
t1.record()
torch.cuda.synchronize()
out["fp32_train_fb_w8"] = t0.elapsed_time(t1) / 10
print(json.dumps(out))
"""


def run(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    done = subprocess.run([sys.executable, "-c", CHILD, str(tree)],
                          cwd=tree, env=env, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"{tree}: exit {done.returncode}\n"
                           f"{done.stdout[-4000:]}{done.stderr[-8000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    parent = args.parent.resolve()
    readings = {"parent": [], "this": []}
    for _ in range(args.turns):
        for name, tree in (("parent", parent), ("this", HERE),
                           ("this", HERE), ("parent", parent)):
            got = run(tree)
            readings[name].append(got)
            print(name, json.dumps(got), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
