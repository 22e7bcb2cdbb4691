"""Kernel (g) ``swin_block``: one whole Swin block per window in one launch.

Replaces the Pallas kernel ``fused_swin_block``
(``adsr_tpu/ops/fused_swin_block.py:297``, body ``_kernel`` ``:215``,
pallas_call ``:337``), which the JAX package's "block" serving mode
(``ADSR_TPU_RDG=0``) runs once per Swin block. Source:
``adsr_tpu_torch/csrc/swin_block.cu`` (with ``hopper_gemm.cuh``'s TMA,
mbarrier and wgmma wrappers and the attention core of
``window_attn_core.cuh``, shared with kernel (c)). Bound on the H100:
operations (the weights are re-read from L2 by every window; each window's
activations are read and written once). Design: one thread block per (image,
8x8 window) takes the window's 64 token rows through LN1, qkv, shifted-window
attention, proj + residual, LN2, fc1 + GELU and fc2 + residual in shared
memory, with the residual stream in f32; a producer warp streams the packed
weights (16-byte rows) by TMA into a ring of 64 x 64 tiles, two consumer
warpgroups run the products on wgmma (32 of a tile's 64 columns each) with
their epilogues from the accumulators, and the attention core per head; the
cyclic shift is the raster-row map that ``window_attention`` uses; head
dims are zero-padded to multiples of 16; the numerics are the eager model's
(stabilised softmax, exact-erf GELU).

The block reads the packed block dict of ``kernels/fused_rdg.py``
(``pack_swin`` / ``_pack_block``) as it is: no second packer and no second
copy of the weights. ``pack_swin_weights`` carries a JAX ``SwinBlock`` param
tree into that dict, for the tests.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional

import torch

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.io.convert import _flatten, _leaf
from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.fused_rdg import pack_swin, rdg_geometry
from adsr_tpu_torch.kernels.rdg_gemm import rdg_gemm_plain
from adsr_tpu_torch.kernels.rdg_layernorm import EPS, rdg_layernorm_plain
from adsr_tpu_torch.kernels.window_attention import (BLOCK_SHARED_MAX,
                                                     KERNEL_WINDOW, REGISTERS,
                                                     check_rows16, head_tile,
                                                     window_attention_plain)

MAX_WIDTH = 320        # the kernel's LayerNorm keeps <= 10 values a lane
THREADS = 288          # two consumer warpgroups + one producer warp
STAGE_BYTES = 64 * 128  # a ring stage: 64 weight rows x 64 bf16
MAX_STAGES = 16
_VECTORS = ("ln1_w", "ln1_b", "bqkv", "attn_bias", "bproj", "ln2_w", "ln2_b",
            "b1", "b2")
_MATRICES = ("wqkv", "wproj", "w1", "w2")


def pack_swin_weights(params: Mapping[str, Any], c: int, window: int,
                      dtype=torch.float32, device="cpu"
                      ) -> Dict[str, torch.Tensor]:
    """A JAX ``SwinBlock`` param tree (flax names: ``attn/qkv/kernel`` [I, O],
    ``norm1/scale``, ...) -> the port's block dict (:func:`pack_swin`), the
    counterpart of ``pack_swin_weights`` (adsr_tpu/ops/fused_swin_block.py:51)
    without the lane padding."""
    sd = {}
    for path, v in _flatten(params):
        suffix, arr = _leaf(path, v)
        module = ".".join(path.split("/")[:-1])
        sd[f"{module}.{suffix}"] = torch.as_tensor(arr.copy())
    return pack_swin(sd, "", c, window, dtype, device)


@functools.lru_cache(maxsize=None)
def swin_block_plan(c: int, f: int, nh: int, b: int = 1, h: int = 8,
                    w: int = 8) -> Dict[str, int]:
    """What kernel (g) launches for width ``c``, hidden width ``f`` and
    ``nh`` heads at batch ``b`` and ``h`` x ``w`` tokens: one block of
    ``THREADS`` per (image, window); its shared memory (1 KB of alignment
    room, the weight ring, the LayerNorm output as swizzled 64-column atoms,
    one head's context as such atoms (it starts at column (h hd) % 8, so
    that its share of Wproj starts 16-byte aligned), the f32 residual
    [64][ldx], one head's q/k/v planes, the ring's mbarriers) with as many
    8 KB ring stages as fit, at most ``MAX_STAGES``; the 64-row weight tiles
    one window streams (qkv per head and part, proj per head over its dims,
    fc1 and fc2 per 64 hidden columns); the registers a thread may use
    (one block an SM: each of the SM's four register quarters holds up to
    three of its nine warps). The source refuses a launch whose stages and
    shared memory differ from its own layout. Read only (cached)."""
    hd = c // nh
    hdp = head_tile(hd)
    kp = -(-c // 64) * 64
    hk = -(-(hd + 7) // 64)     # a head's context from column (h hd) % 8
    ldx = c + (24 - c % 16) % 16
    fixed = 1024 + (kp // 64 + hk) * STAGE_BYTES + 64 * ldx * 4 \
        + 3 * 64 * (hdp + 8) * 2
    stages = min(MAX_STAGES, (BLOCK_SHARED_MAX - fixed) // (STAGE_BYTES + 16))
    ks, nc = kp // 64, -(-c // 64)
    tiles = 3 * nh * hk * ks + nh * nc * hk + -(-f // 64) * (ks + nc)
    return {"hdp": hdp, "ldx": ldx, "stages": stages,
            "smem_bytes": fixed + stages * (STAGE_BYTES + 16),
            "threads": THREADS,
            "blocks": b * (h // KERNEL_WINDOW) * (w // KERNEL_WINDOW),
            "weight_tiles": tiles,
            "max_registers": min(255, REGISTERS // 4 // -(-THREADS // 128)
                                 // 32 // 8 * 8)}


def block_geometry(cfg: DRCTModelConfig, k: int) -> Dict[str, int]:
    """Width, heads, hidden width and shift of block ``k`` (0-based)."""
    g = rdg_geometry(cfg)
    return {"c": g["feats"][k], "heads": g["heads"][k],
            "hidden": g["hidden"][k], "shift": g["shifts"][k]}


def fused_swin_block_plain(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                           masks: Mapping[int, torch.Tensor],
                           cfg: DRCTModelConfig, h: int, w: int,
                           k: int) -> torch.Tensor:
    """f32 output [M, c] of Swin block ``k`` on ``x`` [M, c] (any row
    stride), the block in plain PyTorch over whole windows: LN1, qkv,
    shifted-window attention, proj + residual, LN2, fc1 + GELU, fc2 +
    residual, f32 throughout."""
    geo = block_geometry(cfg, k)
    shift = geo["shift"]
    xf = x.float()
    ln1 = rdg_layernorm_plain(xf, p["ln1_w"], p["ln1_b"])
    qkv = rdg_gemm_plain(ln1, p["wqkv"], p["bqkv"])
    ctx = window_attention_plain(qkv, p["attn_bias"], masks.get(shift), h, w,
                                 geo["heads"], cfg.window_size, shift)
    x1 = rdg_gemm_plain(ctx, p["wproj"], p["bproj"], "residual", xf)
    hid = rdg_gemm_plain(rdg_layernorm_plain(x1, p["ln2_w"], p["ln2_b"]),
                         p["w1"], p["b1"], "gelu")
    return rdg_gemm_plain(hid, p["w2"], p["b2"], "residual", x1)


def fused_swin_block(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                     masks: Mapping[int, torch.Tensor], cfg: DRCTModelConfig,
                     h: int, w: int, k: int,
                     out: torch.Tensor) -> torch.Tensor:
    """Swin block ``k`` (0-based) of an RDG on ``x`` [B*h*w, c_k] (raster
    token order, any row stride: the concat prefix ``cat[:, :c_k]``) into
    ``out`` [B*h*w, c_k]. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or the call raises."""
    geo = block_geometry(cfg, k)
    c, shift = geo["c"], geo["shift"]
    m = x.shape[0]
    mask: Optional[torch.Tensor] = masks.get(shift) if shift else None
    if x.shape != (m, c) or out.shape != (m, c) or m % (h * w) \
            or (shift > 0) != (mask is not None):
        raise ValueError(f"fused_swin_block: x {tuple(x.shape)}, out "
                         f"{tuple(out.shape)}, block {k + 1} width {c}, "
                         f"{h}x{w} tokens, shift {shift}")
    if x.device.type == "cpu":
        out.copy_(fused_swin_block_plain(x, p, masks, cfg, h, w, k))
        return out
    win = cfg.window_size
    if win != KERNEL_WINDOW or h % win or w % win or c > MAX_WIDTH \
            or c % 4 or geo["hidden"] % 4 or c // geo["heads"] > 128:
        raise NotImplementedError(
            f"fused_swin_block: the CUDA kernel takes 8x8 windows, widths "
            f"<= {MAX_WIDTH} and multiples of 4, head dims <= 128 (got "
            f"window {win}, {h}x{w}, c {c}, hidden {geo['hidden']}); at "
            f"16x16 windows serve in rdg mode (ADSR_TPU_RDG=1)")
    _build.require_bf16_cuda("fused_swin_block", x, out,
                             *(p[n] for n in _MATRICES))
    _build.require_f32_cuda("fused_swin_block", *(p[n] for n in _VECTORS))
    if mask is not None:
        _build.require_f32_cuda("fused_swin_block", mask)
    if x.stride(0) % 4 or out.stride(0) % 4:
        raise ValueError("fused_swin_block: needs row strides of x and out "
                         "that are multiples of 4")
    check_rows16("fused_swin_block", *(p[n] for n in _MATRICES))
    plan = swin_block_plan(c, geo["hidden"], geo["heads"])
    rc = _build.library().adsr_swin_block(
        x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
        p["ln1_w"].data_ptr(), p["ln1_b"].data_ptr(), p["wqkv"].data_ptr(),
        p["wqkv"].stride(0), p["bqkv"].data_ptr(), p["attn_bias"].data_ptr(),
        None if mask is None else mask.data_ptr(), p["wproj"].data_ptr(),
        p["wproj"].stride(0), p["bproj"].data_ptr(), p["ln2_w"].data_ptr(),
        p["ln2_b"].data_ptr(), p["w1"].data_ptr(), p["w1"].stride(0),
        p["b1"].data_ptr(), p["w2"].data_ptr(), p["w2"].stride(0),
        p["b2"].data_ptr(), m // (h * w), h, w, c, geo["hidden"],
        geo["heads"], win, shift, plan["stages"], EPS, plan["smem_bytes"],
        _build.stream_ptr(x))
    _build.check_rc("fused_swin_block", rc)
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0
