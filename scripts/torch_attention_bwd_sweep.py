#!/usr/bin/env python3
"""Where kernel (f) ``window_attention_bwd`` spends its time, on one CUDA
card at the flagship DRCT x4 @128px shapes (batch 16, 32 x 32 tokens, the
five Swin blocks of one RDG, qkv / dO / dqkv in 16-byte rows).

    python3 scripts/torch_attention_bwd_sweep.py

Builds variants of ``adsr_tpu_torch/csrc/window_attention_bwd.cu`` by
text edits into ``build/attention_bwd_sweep/`` (one shared library each,
nvcc in parallel) and times one RDG's five launches of each through its
C entry point (the kernel and its d(bias) partial sum, CUDA events over 20
launches), at windows a block G = 1..6 and at the plan's G
(``window_attention_bwd_plan``):

- ``kernel``: the source as it is, checked against the plain version;
- ``free_registers``: without the ``__launch_bounds__`` minimum of blocks
  an SM (ptxas then takes 220-255 registers a thread), checked too;
- ``no_store``, ``no_load``, ``no_compute``: the dqkv stores, the global
  loads of the gather, or the products and softmax left out (wrong
  outputs, timing only): what each phase costs; ``no_shared_store`` and
  ``no_whole_store`` leave out only the element stores of the pieces a
  head shares with its neighbour, or only the whole 16-byte stores.

Prints ptxas's registers and spills of each variant, then one line per
variant and block, and one JSON line with the card's name and power limit.
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

from adsr_tpu_torch.kernels import _build  # noqa: E402
from adsr_tpu_torch.kernels.rdg_gemm import pitched  # noqa: E402
from adsr_tpu_torch.kernels.window_attention_bwd import (  # noqa: E402
    window_attention_bwd_plain, window_attention_bwd_plan)
from adsr_tpu_torch.models.drct import shift_attn_mask  # noqa: E402

SRC = _build.CSRC / "window_attention_bwd.cu"
OUT = ROOT / "build" / "attention_bwd_sweep"
BATCH, SIDE = 16, 32
FLAGSHIP = [(180, 6, 0), (212, 4, 4), (244, 2, 0), (276, 6, 4), (308, 4, 0)]
GROUPS = range(1, 7)
LOAD_Q = "            v[j] = __ldg(reinterpret_cast<const uint4*>(src));"
LOAD_H = ("            const uint2 u = __ldg(reinterpret_cast<const "
          "uint2*>(src));")
VARIANTS = {
    "kernel": [],
    "free_registers": [("__launch_bounds__(kThreads, min_blocks(HDP))",
                        "__launch_bounds__(kThreads)")],
    "no_store": [("i < N * pc.begin[3];", "i < 0 * pc.begin[3];")],
    "no_shared_store": [("          if (x < n && c0 + x >= s0 && c0 + x < "
                         "s0 + hd)\n", "          if (x < 0)\n")],
    "no_whole_store": [("        if (n == 8)\n          *reinterpret_cast"
                        "<uint4*>(dst) = v;",
                        "        if (n < 0)\n          *reinterpret_cast"
                        "<uint4*>(dst) = v;")],
    "no_load": [(LOAD_Q, "            v[j] = make_uint4((unsigned)row, "
                         "(unsigned)c0, 0u, 0u);"),
                (LOAD_H, "            const uint2 u = make_uint2("
                         "(unsigned)row, 0u);")],
    "no_compute": [("    float acc[HDP / 8][4];\n    attn_bwd_rows",
                    "    float acc[HDP / 8][4] = {};\n    if (windows < 0) "
                    "attn_bwd_rows"),
                   ("        tile_t_times<HDP>(",
                    "        if (windows < 0) tile_t_times<HDP>(")],
}
CHECKED = ("kernel", "free_registers")


def build() -> dict:
    """{variant: ctypes entry point}, each built from the edited source."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            src = src.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line and "Used" in line]
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line]
        print(f"[ptxas] {name}: " + " | ".join(
            f"{r}; {s}" for r, s in zip(regs, spills)), flush=True)
        fn = ctypes.CDLL(str(so)).adsr_window_attention_bwd
        fn.argtypes = _build.SIGNATURES["adsr_window_attention_bwd"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    m = BATCH * SIDE * SIDE
    mask = torch.as_tensor(shift_attn_mask(SIDE, SIDE, 8, 4), device=dev)
    cases = []
    for c, nh, shift in FLAGSHIP:
        qkv, dout = pitched(m, 3 * c, device=dev), pitched(m, c, device=dev)
        qkv.copy_(torch.randn(m, 3 * c, generator=gen, device=dev))
        dout.copy_(torch.randn(m, c, generator=gen, device=dev))
        bias = 0.5 * torch.randn(nh, 64, 64, generator=gen, device=dev)
        msk = mask if shift else None
        cases.append({
            "c": c, "nh": nh, "shift": shift, "qkv": qkv, "dout": dout,
            "bias": bias, "mask": msk,
            "plan": window_attention_bwd_plan(c, nh, BATCH, SIDE, SIDE),
            "want": window_attention_bwd_plain(qkv, dout, bias, msk, SIDE,
                                               SIDE, nh, 8, shift),
            "dqkv": pitched(m, 3 * c, device=dev),
            "dbias": torch.empty(nh, 64, 64, device=dev),
            "part": torch.empty(BATCH * 16 * nh * 64 * 64, device=dev)})
    fns = build()

    def launch(fn, case, group):
        q, d = case["qkv"], case["dqkv"]
        rc = fn(q.data_ptr(), q.stride(0), case["dout"].data_ptr(),
                case["dout"].stride(0), case["bias"].data_ptr(),
                None if case["mask"] is None else case["mask"].data_ptr(),
                d.data_ptr(), d.stride(0), case["part"].data_ptr(),
                case["dbias"].data_ptr(), BATCH, SIDE, SIDE, case["c"],
                case["nh"], 8, case["shift"], group,
                case["plan"]["smem_bytes"], _build.stream_ptr(q))
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    result = {}
    for name, fn in fns.items():
        total = 0.0
        for case in cases:
            g0 = case["plan"]["group"]
            if name in CHECKED:
                launch(fn, case, g0)
                torch.cuda.synchronize()
                want_q, want_b = case["want"]
                err = (case["dqkv"].float() - want_q).abs()
                bound = 2.0 ** -7 * (want_q.abs().max() + want_q.abs())
                berr = (case["dbias"] - want_b).abs().max()
                if bool((err > bound).any()) or \
                        berr > 2.0 ** -8 * want_b.abs().max():
                    raise AssertionError(f"{name} c={case['c']}: beyond the "
                                         "tolerance of chip_smoke.py")
            groups = GROUPS if name in CHECKED else (g0,)
            ms = {g: cuda_ms(lambda: launch(fn, case, g)) for g in groups}
            total += ms[g0]
            result.setdefault(name, {})[case["c"]] = ms
            print(f"[sweep] {name:14s} c={case['c']} heads={case['nh']}: "
                  f"plan G={g0} {ms[g0]:.4f} ms; " + " ".join(
                      f"G={g} {v:.4f}" for g, v in ms.items()), flush=True)
        result.setdefault("rdg_ms_at_plan", {})[name] = total
        print(f"[sweep] {name:14s} one RDG at the plan's G: {total:.4f} ms",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
