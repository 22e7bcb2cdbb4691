#!/usr/bin/env python3
"""The f32 kernels that run their products as 3xTF32 on the tensor cores,
(b) f32 (``csrc/rdg_gemm_f32.cu``) and (f) f32 at 16x16 windows
(``csrc/window_attention_bwd_f32.cuh``), against another checkout's (say
the parent's SIMT designs) on one CUDA card, in turns.

    python3 scripts/torch_f32_tensorcore_ab.py --parent DIR [--turns 1]

``DIR`` is a ``git archive`` of the other commit, unpacked (a directory
that ``.gitignore`` lists, such as ``build/parent``). Each turn runs one
process per tree (the other's first, then this one's, then this one's, then
the other's, and so on), each building its tree's kernels into its own
``build/`` and timing, with the port's wrappers (whose C entries and
arguments both trees share):

- ``gemm_f32``: one flagship RDG's 25 f32 products (qkv, proj, fc1, fc2,
  adjust of each of the five blocks, their main-path epilogues) at 16,384
  (window 8), 4,096 (window 4) and 65,536 (window 16) token rows, captured
  as a CUDA graph and replayed 10 times between CUDA events; beside it the
  same products through ``F.linear`` with TF32 off;
- ``attention_bwd16_f32``: one RDG's five (f) f32 calls at the 256px/x4
  geometry (batch 16 on 64 x 64 tokens, 16x16 windows, each block at its
  own shift), fed kernel (c) f32's context and statistics, as a graph.

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
import json, sys
import torch
import torch.nn.functional as F
sys.path.insert(0, sys.argv[1])
from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.rdg_gemm import pitched, rdg_gemm
from adsr_tpu_torch.kernels.window_attention import (softmax_stats,
                                                     window_attention)
from adsr_tpu_torch.kernels.window_attention_bwd import window_attention_bwd
from adsr_tpu_torch.models.drct import shift_region_labels
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
