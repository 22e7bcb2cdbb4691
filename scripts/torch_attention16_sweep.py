#!/usr/bin/env python3
"""Where kernels (c) ``window_attention`` and (f) ``window_attention_bwd``
spend their time at 16x16 windows (N = 256), on one CUDA card at the 256px
shapes (batch 16, 64 x 64 tokens, the five Swin blocks of one RDG, qkv /
ctx / dO / dqkv in 16-byte rows).

    python3 scripts/torch_attention16_sweep.py

Builds variants of ``adsr_tpu_torch/csrc/window_attention16.cu`` and
``csrc/window_attention_bwd16.cu`` by text edits into
``build/attention16_sweep/`` (one shared library each, nvcc in parallel)
and times one RDG's five calls of each through its C entry point (CUDA
events over 20 calls; (f)'s call is its two launches and the d(bias)
partial sum):

- (c) ``kernel``: the source as it is, against the plain version (context
  and softmax statistics, ``chip_smoke.py``'s limits); ``one_warpgroup``:
  one consumer warpgroup a block taking all four query tiles (bitwise
  equal to ``kernel``); ``no_bias``: without the bias and mask terms,
  ``no_mask``: without the mask loads, ``no_store``: without the context
  stores (wrong outputs, timing only);
- (f) fed the (c) kernel's own context and statistics: ``kernel`` against
  the plain version (``chip_smoke.py``'s limits); ``no_bias`` (without
  the bias and mask terms), ``no_mask`` (the mask's), ``no_store``,
  ``exact_exp`` (the backward's P with ``expf`` instead of the hardware
  exponent), ``no_dbias`` (without dkv's d(bias) read-modify-writes in
  shared memory), ``no_exp`` (dkv's exponents), ``no_kv_load`` (dkv's
  gather of each window's K and V, staged or not), ``no_merge`` (dkv's sum
  of the warpgroups' dK and dV), ``dq_no_products`` and
  ``dkv_no_products`` (a launch without its wgmma products),
  ``dq_no_kv_unpack`` and ``dkv_no_qg_unpack`` (without the unpacking of
  its staged tiles, at the head tiles that stage them); ``dq_only`` and
  ``dkv_only``: one of the two launches (dkv reading the statistics a
  ``kernel`` call left), each with the partial sum.

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

from adsr_tpu_torch.kernels import _build  # noqa: E402
from adsr_tpu_torch.kernels.rdg_gemm import pitched  # noqa: E402
from adsr_tpu_torch.kernels.window_attention import (  # noqa: E402
    softmax_stats, window_attention_plain, window_attention_plan)
from adsr_tpu_torch.kernels.window_attention_bwd import (  # noqa: E402
    window_attention_bwd_plain, window_attention_bwd_plan)
from adsr_tpu_torch.models.drct import shift_region_labels  # noqa: E402

OUT = ROOT / "build" / "attention16_sweep"
BATCH, SIDE, WIN = 16, 64, 16
N = WIN * WIN
BLOCKS_256 = [(180, 6, 0), (212, 4, 8), (244, 2, 0), (276, 6, 8), (308, 4, 0)]


def never(stmt: str, indent: int = 4) -> tuple:
    """A text edit that leaves the statement starting ``stmt`` (at
    ``indent`` spaces) never run: ``if (W < 0)`` before it (W, the image
    width, is positive)."""
    pad = " " * indent
    return pad + stmt, pad + "if (W < 0) " + stmt


FWD = ("window_attention16.cu", "adsr_window_attention16", {
    "kernel": [],
    "one_warpgroup": [("kGroups = 2;", "kGroups = 1;")],
    "no_bias": [("kBias = true;", "kBias = false;")],
    "no_store": [("kStore = true;", "kStore = false;")],
    "no_mask": [("      if (masked) {        // the mask",
                 "      if (masked && W < 0) {        // the mask")],
})
BWD = ("window_attention_bwd16.cu", "adsr_window_attention_bwd16", {
    "kernel": [],
    "no_bias": [("kBias = true;", "kBias = false;")],
    "no_store": [("kStore = true;", "kStore = false;")],
    "no_mask": [("    if (masked) {            // the mask",
                 "    if (masked && W < 0) {            // the mask"),
                ("            if (masked) x += mask_term(",
                 "            if (masked && W < 0) x += mask_term(")],
    "exact_exp": [("kFastExp = true;", "kFastExp = false;")],
    "no_dbias": [("          acc[acc_at((int)q0 + 8 * j + 2 * t + ii, "
                  "kr + 8 * rr)] +=\n              dp[4 * j + 2 * rr + ii];\n",
                  "          (void)0;\n")],
    "no_exp": [("s[e] = exp_p(x - q4.x) * q4.y;", "s[e] = (x - q4.x) * q4.y;")],
    "no_kv_load": [never("if (kKvStaged) stage_kv(w_begin);"),
                   never("if (kKvStaged && more) stage_kv(w + 1);"),
                   never("unpack_swz<HDP>(sk, skv, ok, hd, tid, ", 6),
                   never("unpack_swz<HDP>(sv, skv + kStage, ov, hd, tid, ", 6),
                   never("load_swz<HDP, kWin>(sk, qkv, ldq, C3, s0 + C, ", 6),
                   never("load_swz<HDP, kWin>(sv, qkv, ldq, C3, s0 + 2 * C, ",
                         6)],
    "no_merge": [("    if (wg == 1) {", "    if (w < 0) {"),
                 ("        dk[x] += scratch[x * 128 + wtid];\n"
                  "        dv[x] += scratch[(HDP / 2 + x) * 128 + wtid];\n",
                  "")],
    "dq_no_products": [never("wg_scores<HDP>(s, sq, sk);"),
                       never("wg_scores<HDP>(dp, sg, sv);"),
                       never("wg_pv<HDP>(dq, ds, sk);")],
    "dq_no_kv_unpack": [never("unpack_swz<HDP>(sk, sst, ok, hd, tid, "),
                        never("unpack_swz<HDP>(sv, sst + kStage, ov, hd, ")],
    "dkv_no_products": [never("wg_scores<HDP>(s, sk, sq);"),
                        never("wg_scores<HDP>(dp, sv, sg);"),
                        never("wg_pv<HDP>(dv, p, sg);"),
                        never("wg_pv<HDP>(dk, ds, sq);")],
    "dkv_no_qg_unpack": [never("unpack_swz<HDP>(sq, sqg, oq, hd, wtid, ", 6),
                         never("unpack_swz<HDP>(sg, sqg + kStage, oq, hd, ",
                               6)],
    "dq_only": [("  window_attention_bwd16_dkv_kernel<HDP>\n      <<<",
                 "  if (windows < 0) window_attention_bwd16_dkv_kernel<HDP>"
                 "\n      <<<")],
    "dkv_only": [("  window_attention_bwd16_dq_kernel<HDP>\n      <<<",
                  "  if (windows < 0) window_attention_bwd16_dq_kernel<HDP>"
                  "\n      <<<")],
})
BITWISE = ("one_warpgroup",)


def build(spec) -> dict:
    """{variant: (entry point name, nvcc process, library)} of one
    source's variants, every compile started at once."""
    src_name, entry, variants = spec
    OUT.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / src_name).read_text()
    procs = {}
    for name, edits in variants.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {src_name} has no {old!r}")
            src = src.replace(old, new)
        stem = f"{Path(src_name).stem}_{name}"
        cu, so = OUT / f"{stem}.cu", OUT / f"{stem}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    return {name: (entry, proc, so) for name, (proc, so) in procs.items()}


def load(*builds) -> list:
    """The entry points of each (built variants, tag), once every compile
    has ended: {variant: ctypes entry point} a build."""
    logs = [{name: proc.communicate()[0] for name, (_, proc, _) in b.items()}
            for b, _ in builds]
    out = []
    for (built, tag), log_of in zip(builds, logs):
        fns = {}
        for name, (entry, proc, so) in built.items():
            log = log_of[name]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
            regs = [line.split(":", 1)[1].strip()
                    for line in log.splitlines()
                    if "registers" in line and "Used" in line]
            spills = [line.strip() for line in log.splitlines()
                      if "spill stores" in line]
            print(f"[ptxas] {tag} {name}: " + " | ".join(
                f"{r}; {s}" for r, s in zip(regs, spills)), flush=True)
            fn = getattr(ctypes.CDLL(str(so)), entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[name] = fn
        out.append(fns)
    return out


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


def within(got, want, atol, rtol, what):
    err = (got.float() - want).abs()
    if bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{what}: beyond the tolerance of chip_smoke.py "
                             f"(max abs error {err.max().item():.3e})")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    m = BATCH * SIDE * SIDE
    # the shift mask as (c) and (f) take it: each window's region labels
    mask = torch.as_tensor(shift_region_labels(SIDE, SIDE, WIN, WIN // 2),
                           device=dev)
    fwd, bwd = load((build(FWD), "(c)"), (build(BWD), "(f)"))  # nvcc at once
    cases = []
    for c, nh, shift in BLOCKS_256:
        qkv, dout = pitched(m, 3 * c, device=dev), pitched(m, c, device=dev)
        qkv.copy_(torch.randn(m, 3 * c, generator=gen, device=dev))
        dout.copy_(torch.randn(m, c, generator=gen, device=dev))
        cases.append({
            "c": c, "nh": nh, "shift": shift, "qkv": qkv, "dout": dout,
            # the bias as (c) and (f) take it: its relative-position table
            "bias": 0.5 * torch.randn(nh, (2 * WIN - 1) ** 2, generator=gen,
                                      device=dev),
            "mask": mask if shift else None,
            "plan": window_attention_plan(c, nh, window=WIN),
            "bplan": window_attention_bwd_plan(c, nh, BATCH, SIDE, SIDE,
                                               _build.sm_count(dev), WIN),
            "ctx": pitched(m, c, device=dev),
            "stats": softmax_stats(qkv, SIDE, SIDE, nh, WIN),
            "dqkv": pitched(m, 3 * c, device=dev),
            "dbias": torch.empty(nh, N, N, device=dev)})
    for case in cases:
        p = case["bplan"]
        case["stats4"] = torch.empty(p["stats_bytes"] // 4, device=dev)
        case["part"] = torch.empty(p["partial_bytes"] // 4, device=dev)

    def run_fwd(fn, case, out, stats):
        q = case["qkv"]
        rc = fn(q.data_ptr(), q.stride(0), out.data_ptr(), out.stride(0),
                case["bias"].data_ptr(),
                None if case["mask"] is None else case["mask"].data_ptr(),
                None if stats is None else stats.data_ptr(), BATCH, SIDE,
                SIDE, case["c"], case["nh"], case["shift"],
                case["plan"]["smem_bytes"], _build.stream_ptr(q))
        if rc:
            raise RuntimeError(f"(c) launch failed: CUDA error {rc}")

    def run_bwd(fn, case):
        q, d, p = case["qkv"], case["dqkv"], case["bplan"]
        rc = fn(q.data_ptr(), q.stride(0), case["dout"].data_ptr(),
                case["dout"].stride(0), case["ctx"].data_ptr(),
                case["ctx"].stride(0), case["bias"].data_ptr(),
                None if case["mask"] is None else case["mask"].data_ptr(),
                case["stats"].data_ptr(), d.data_ptr(), d.stride(0),
                case["stats4"].data_ptr(), case["part"].data_ptr(),
                case["dbias"].data_ptr(), BATCH, SIDE, SIDE, case["c"],
                case["nh"], case["shift"], p["group"], p["smem_dq_bytes"],
                p["smem_bytes"], _build.stream_ptr(q))
        if rc:
            raise RuntimeError(f"(f) launch failed: CUDA error {rc}")

    result = {"window_attention": {}, "window_attention_bwd": {}}
    # (c): the kernel against the plain version, then every variant's time
    for case in cases:
        run_fwd(fwd["kernel"], case, case["ctx"], case["stats"])
        torch.cuda.synchronize()
        st = torch.empty_like(case["stats"])
        want = window_attention_plain(case["qkv"], case["bias"],
                                      case["mask"], SIDE, SIDE, case["nh"],
                                      WIN, case["shift"], st)
        v = case["qkv"][:, 2 * case["c"]:].float().abs().max().item()
        within(case["ctx"], want, 2.0 ** -8 * v, 2.0 ** -7,
               f"(c) c={case['c']}")
        within(case["stats"][..., 0], st[..., 0], 1e-4, 1e-4,
               f"(c) c={case['c']} stats max")
        within(case["stats"][..., 1], st[..., 1], 0.0, 1e-4,
               f"(c) c={case['c']} stats 1/sum")
        for name in BITWISE:
            out, s2 = pitched(m, case["c"], device=dev), \
                torch.empty_like(case["stats"])
            run_fwd(fwd[name], case, out, s2)
            if not (torch.equal(out, case["ctx"])
                    and torch.equal(s2, case["stats"])):
                raise AssertionError(f"(c) {name} c={case['c']}: differs "
                                     "from the kernel")
    scratch = [(pitched(m, case["c"], device=dev),
                torch.empty_like(case["stats"])) for case in cases]
    for name, fn in fwd.items():
        for stats in (False, True):
            if stats and name != "kernel":
                continue
            tag = name + (" with stats" if stats else "")
            ms = [cuda_ms(lambda: run_fwd(fn, case, out, st if stats
                                          else None))
                  for case, (out, st) in zip(cases, scratch)]
            result["window_attention"][tag] = {"blocks": ms,
                                               "rdg_ms": sum(ms)}
            print(f"[sweep] (c) {tag:24s} one RDG {sum(ms):.4f} ms; by "
                  "block " + " ".join(f"{x:.4f}" for x in ms), flush=True)
    # (f), fed (c)'s own context and statistics (case["ctx"], ["stats"])
    for case in cases:
        run_bwd(bwd["kernel"], case)
        torch.cuda.synchronize()
        want_q, want_b = window_attention_bwd_plain(
            case["qkv"], case["dout"], case["bias"], case["mask"], SIDE,
            SIDE, case["nh"], WIN, case["shift"])
        c = case["c"]
        for i in range(3):
            ref = want_q[:, i * c:(i + 1) * c]
            within(case["dqkv"][:, i * c:(i + 1) * c], ref,
                   2.0 ** -7 * ref.abs().max().item(), 2.0 ** -7,
                   f"(f) c={c} d{'qkv'[i]}")
        within(case["dbias"], want_b, 2.0 ** -8 * want_b.abs().max().item(),
               0.0, f"(f) c={c} dbias")
        del want_q, want_b
    for name, fn in bwd.items():
        ms = [cuda_ms(lambda: run_bwd(fn, case), iters=10) for case in cases]
        result["window_attention_bwd"][name] = {"blocks": ms,
                                                "rdg_ms": sum(ms)}
        print(f"[sweep] (f) {name:24s} one RDG {sum(ms):.4f} ms; by block "
              + " ".join(f"{x:.4f}" for x in ms), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
