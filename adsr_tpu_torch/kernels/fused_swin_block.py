"""Kernel (g) ``swin_block``: one whole Swin block per window in one launch.

Replaces the Pallas kernel ``fused_swin_block``
(``adsr_tpu/ops/fused_swin_block.py:297``, body ``_kernel`` ``:215``,
pallas_call ``:337``), which the JAX package's "block" serving mode
(``ADSR_TPU_RDG=0``) runs once per Swin block. Sources:
``adsr_tpu_torch/csrc/swin_block.cu`` (8x8 windows) and
``csrc/swin_block16.cu`` (16x16 windows), on the ring, products and
LayerNorm of ``csrc/swin_block_core.cuh`` (with ``hopper_gemm.cuh``'s TMA,
mbarrier and wgmma wrappers) and the attention core of
``window_attn_core.cuh``, shared with kernel (c). Bound on the H100:
operations (the weights are re-read from L2 by every window; each window's
activations are read and written once). Design: a thread block holds 64
token rows through LN1, qkv, shifted-window attention, proj + residual,
LN2, fc1 + GELU and fc2 + residual in shared memory, with the residual
stream in f32; a producer warp streams the packed weights (16-byte rows) by
TMA into a ring of 64 x 64 tiles, two consumer warpgroups run the products
on wgmma (32 of a tile's 64 columns each) with their epilogues from the
accumulators, and the attention core per head. At 8x8 windows one block
per (image, window) holds the window. At 16x16 windows (N = 256) one
cluster of ``CLUSTER`` blocks per (image, window), one 64-row query tile a
block: each block computes its rows' q, k and v, and walks the window's four
key tiles with kernel (c)'s online softmax, reading the peers' K and V
tiles from their shared memory (distributed shared memory), with two
cluster barriers a head. The cyclic shift is the raster-row map that
``window_attention`` uses; head dims are zero-padded to multiples of 16;
the numerics are the eager model's (stabilised softmax, exact-erf GELU).

The block reads the packed block dict of ``kernels/fused_rdg.py``
(``pack_swin`` / ``_pack_block``) as it is: no second packer and no second
copy of the weights. ``pack_swin_weights`` carries a JAX ``SwinBlock`` param
tree into that dict, for the tests.
"""

from __future__ import annotations

import ctypes
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
                                                     KERNEL_WINDOW,
                                                     KERNEL_WINDOWS, KEY_TILE,
                                                     REGISTERS, check_rows16,
                                                     head_tile,
                                                     window_attention_plain)

MAX_WIDTH = 320        # the kernel's LayerNorm keeps <= 10 values a lane
THREADS = 288          # two consumer warpgroups + one producer warp
STAGE_BYTES = 64 * 128  # a ring stage: 64 weight rows x 64 bf16
MAX_STAGES = 16
CLUSTER = 4            # blocks a 16x16 window: one 64-row query tile each
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
                    w: int = 8, window: int = KERNEL_WINDOW) -> Dict[str, int]:
    """What kernel (g) launches for width ``c``, hidden width ``f`` and
    ``nh`` heads at batch ``b``, ``h`` x ``w`` tokens and ``window`` x
    ``window`` windows: ``cluster`` blocks of ``THREADS`` per (image,
    window), each holding 64 token rows (one block at window 8, a cluster of
    ``CLUSTER`` at window 16, one 64-row query tile a block); ``blocks`` in
    all. A block's shared memory, ``regions`` in the source's order after
    1 KB of alignment room: the weight ``ring``, the LayerNorm output
    (``ln``) as swizzled 64-column atoms, one head's context (``ctx``) as
    such atoms (it starts at column (h hd) % 8, so that its share of Wproj
    starts 16-byte aligned; at window 16 the region also holds a peer's K
    and V tiles during the attention, ``staging_bytes``), the f32 residual
    ``x`` [64][ldx], the block's rows of one head's q/k/v planes (``qkv``),
    the ring's mbarriers (``bars``); with as many 8 KB ring stages as fit,
    at most ``MAX_STAGES``. Also the 64-row weight tiles one block streams
    (qkv per head and part, proj per head over its dims, fc1 and fc2 per 64
    hidden columns) and one window (``window_weight_tiles``: every block of
    a cluster streams them all), and the registers a thread may use (one
    block an SM: each of the SM's four register quarters holds up to three
    of its nine warps).
    The source refuses a launch whose stages and shared memory differ from
    its own layout. Read only (cached)."""
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"swin_block_plan: window {window}, the kernel "
                         f"takes {KERNEL_WINDOWS}")
    hd = c // nh
    hdp = head_tile(hd)
    kp = -(-c // 64) * 64
    hk = -(-(hd + 7) // 64)     # a head's context from column (h hd) % 8
    ldx = c + (24 - c % 16) % 16
    cluster = window * window // KEY_TILE
    staging = 2 * KEY_TILE * (hdp + 8) * 2 if cluster > 1 else 0
    regions = {"ln": kp // 64 * STAGE_BYTES,
               "ctx": max(hk * STAGE_BYTES, staging), "x": 64 * ldx * 4,
               "qkv": 3 * 64 * (hdp + 8) * 2}
    fixed = 1024 + sum(regions.values())
    stages = min(MAX_STAGES, (BLOCK_SHARED_MAX - fixed) // (STAGE_BYTES + 16))
    regions = {"ring": stages * STAGE_BYTES, **regions, "bars": 16 * stages}
    ks, nc = kp // 64, -(-c // 64)
    tiles = 3 * nh * hk * ks + nh * nc * hk + -(-f // 64) * (ks + nc)
    windows = b * (h // window) * (w // window)
    return {"hdp": hdp, "ldx": ldx, "stages": stages,
            "smem_bytes": fixed + stages * (STAGE_BYTES + 16),
            "regions": regions, "threads": THREADS, "cluster": cluster,
            "windows": windows, "blocks": windows * cluster,
            "staging_bytes": staging, "weight_tiles": tiles,
            "window_weight_tiles": tiles * cluster,
            "max_registers": min(255, REGISTERS // 4 // -(-THREADS // 128)
                                 // 32 // 8 * 8)}


def swin_block16_clusters(c: int, f: int, nh: int) -> int:
    """How many clusters of the 16x16-window kernel the card holds at once
    at this block's plan (``cudaOccupancyMaxActiveClusters``: four blocks
    of one SM each within one GPC). Needs the card."""
    plan = swin_block_plan(c, f, nh, window=16)
    n = ctypes.c_int(0)
    _build.check_rc("swin_block16_clusters",
                    _build.library().adsr_swin_block16_clusters(
                        c // nh, plan["smem_bytes"], ctypes.addressof(n)))
    return n.value


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
    launches the kernel (8x8 or 16x16 windows) or the call raises."""
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
    if win not in KERNEL_WINDOWS or h % win or w % win or c > MAX_WIDTH \
            or c % 4 or geo["hidden"] % 4 or c // geo["heads"] > 128:
        raise NotImplementedError(
            f"fused_swin_block: the CUDA kernel takes 8x8 or 16x16 windows, "
            f"widths <= {MAX_WIDTH} and multiples of 4, head dims <= 128 (got "
            f"window {win}, {h}x{w}, c {c}, hidden {geo['hidden']})")
    _build.require_bf16_cuda("fused_swin_block", x, out,
                             *(p[n] for n in _MATRICES))
    _build.require_f32_cuda("fused_swin_block", *(p[n] for n in _VECTORS))
    if mask is not None:
        _build.require_f32_cuda("fused_swin_block", mask)
    if x.stride(0) % 4 or out.stride(0) % 4:
        raise ValueError("fused_swin_block: needs row strides of x and out "
                         "that are multiples of 4")
    check_rows16("fused_swin_block", *(p[n] for n in _MATRICES))
    n = win * win
    if p["attn_bias"].shape != (geo["heads"], n, n) or (
            mask is not None
            and mask.shape != ((h // win) * (w // win), n, n)):
        raise ValueError(f"fused_swin_block: bias "
                         f"{tuple(p['attn_bias'].shape)}, mask "
                         f"{None if mask is None else tuple(mask.shape)} at "
                         f"{win}x{win} windows of {h}x{w} tokens")
    plan = swin_block_plan(c, geo["hidden"], geo["heads"], window=win)
    lib = _build.library()
    launch = lib.adsr_swin_block if win == KERNEL_WINDOW \
        else lib.adsr_swin_block16
    rc = launch(
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
