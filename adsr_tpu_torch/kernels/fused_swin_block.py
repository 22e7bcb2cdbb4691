"""Kernel (g) ``swin_block``: one whole Swin block per window in one launch.

Replaces the Pallas kernel ``fused_swin_block``
(``adsr_tpu/ops/fused_swin_block.py:297``, body ``_kernel`` ``:215``,
pallas_call ``:337``), which the JAX package's "block" serving mode
(``ADSR_TPU_RDG=0``) runs once per Swin block. Sources:
``adsr_tpu_torch/csrc/swin_block.cu`` (8x8 windows),
``csrc/swin_block4.cu`` (4x4 windows) and ``csrc/swin_block16.cu`` (16x16
windows), on the ring, products and LayerNorm of
``csrc/swin_block_core.cuh`` (with ``hopper_gemm.cuh``'s TMA,
mbarrier and wgmma wrappers), the attention core of
``window_attn_core.cuh`` (windows 4 and 8, shared with kernel (c)) and the
lookups and register-A wgmma of ``attn16.cuh`` (window 16). Bound on the
H100: operations (the weights are re-read from L2 by every window; each
window's activations are read and written once). Design: a thread block
holds 64 token rows through LN1, qkv, shifted-window attention, proj +
residual, LN2, fc1 + GELU and fc2 + residual in shared memory, with the
residual stream in f32; a producer warp streams the packed weights (16-byte
rows) by TMA into a ring of 64 x 64 tiles and two consumer warpgroups run
the products on wgmma with their epilogues from the accumulators. At 8x8
windows one block per (image, window), each 64-column output tile split
between the warpgroups. At 4x4 and 16x16 windows the ping-pong path: each
tile belongs to one warpgroup (m64n64k16) and the tiles alternate, one
warpgroup's epilogue under the other's mainloop; q, k and v of a head are
one product, the MLP runs in 128-wide hidden chunks. At 4x4 windows (N =
16) one block holds four consecutive windows over the flat (image,
window) index, the last group possibly short, each warp of the first
warpgroup attending its own window; where the groups leave half the card
idle, a cluster of two blocks shares each group (half of the heads and
hidden chunks each, the partial streams joined through distributed shared
memory). At 16x16 windows (N = 256) one cluster of ``CLUSTER`` blocks per
(image, window), one 64-row query tile a block: each block computes its
rows' q, k and v (transposed), and both warpgroups walk the window's four
key tiles on wgmma, 32 keys of each, with kernel (c)'s online softmax,
pulling the peers' K and V tiles from their shared memory (each block
streams every weight tile itself), with the bias as the head's relative-position table and the mask as the window's region
labels (kernel (c)'s inputs at N = 256). The cyclic shift is the raster-row
map that ``window_attention`` uses; head dims are zero-padded to multiples
of 16; the numerics are the eager model's (stabilised softmax, exact-erf
GELU).

In f32 (the JAX block mode in fp32: the Pallas kernel at dtype f32) the
kernel is ``csrc/swin_block_f32.cuh`` (one source a window,
``swin_block4_f32.cu``, ``swin_block_f32.cu``, ``swin_block16_f32.cu``):
every product f32-accurate as 3xTF32 on the tensor cores (``mma.sync``
m16n8k8), eight warps holding 64 token rows (a window at 8x8, four windows
at 4x4, a query tile of a 16x16 window in a cluster of four blocks, each
peer's K and V plane pulled whole into the idle product ring), K in steps
of 32 through a three-stage ``cp.async`` ring, sums in two levels, LN1
applied to the rows as qkv stages them, FlashAttention-2 per head (each
warp 16 query rows and half of every key tile, the halves merged), the
stream after proj in the output rows, the MLP in 128-wide hidden chunks
(fc2's added into the output rows); shared memory from
:func:`swin_block_f32_plan`. f32 launches count in
``fused_swin_block.launches_f32``, bf16 ones in ``launches``.

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
                                                     GROUP4, KERNEL_WINDOW,
                                                     KERNEL_WINDOWS,
                                                     LABEL_BYTES,
                                                     REGISTERS,
                                                     REL_TABLE_BYTES,
                                                     attn_operands,
                                                     check_rows16,
                                                     head_tile,
                                                     window_attention_plain,
                                                     windows_text)

# widths (g) takes: its bf16 LayerNorm keeps <= 10 values a lane, and its
# f32 layout fits an SM's shared memory up to 320 columns
MAX_WIDTH = 320
THREADS = 288          # two consumer warpgroups + one producer warp
STAGE_BYTES = 64 * 128  # a ring stage: 64 weight rows x 64 bf16
MAX_STAGES = 16
CLUSTER = 4            # blocks a 16x16 window: one 64-row query tile each
CHUNK = 128            # hidden columns of an MLP chunk (windows 4 and 16)
H100_SMS = 132         # the card's SMs: the plans' default
_VECTORS = ("ln1_w", "ln1_b", "bqkv", "attn_bias", "bproj", "ln2_w", "ln2_b",
            "b1", "b2")
_MATRICES = ("wqkv", "wproj", "w1", "w2")
# the f32 instance (csrc/swin_block_f32.cuh): a block of F32_THREADS holds
# 64 token rows; products step K by F32_STEP_K through a ring of
# F32_STAGES stages of F32_STAGE_ROWS rows [F32_STEP_K + F32_PAD] f32 (a W
# tile of 128 output columns, or an A and a W tile of 64); rows of act and
# y hold c rounded up to a K step, plus F32_PAD (8-byte fragment loads free
# of bank conflicts)
F32_THREADS = 256
F32_STEP_K = 32
F32_STAGES = 3
F32_STAGE_ROWS = 128
F32_PAD = 8
F32_ENTRIES = {8: "adsr_swin_block_f32", 4: "adsr_swin_block4_f32",
               16: "adsr_swin_block16_f32"}
# where the windows and widths the kernels refuse stand (their note)
REFUSED = ("; other windows are ROADMAP.md Queue 2 item 1, wider blocks and "
           "head dims Queue 2 item 4")


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
                    w: int = 8, window: int = KERNEL_WINDOW,
                    sms: int = H100_SMS) -> Dict[str, int]:
    """What kernel (g) launches for width ``c``, hidden width ``f`` and
    ``nh`` heads at batch ``b``, ``h`` x ``w`` tokens and ``window`` x
    ``window`` windows on a card of ``sms`` SMs: ``THREADS`` a block, each
    holding 64 token rows (one block per window at window 8; a cluster of
    ``CLUSTER`` per window at window 16, one 64-row query tile a block; at
    window 4 one block, or a cluster of two, per ``group`` consecutive
    windows, ``last_group`` in the last), ``blocks`` in all.

    A block's shared memory, ``regions`` in the source's order after 1 KB
    of alignment room: the weight ``ring``, the LayerNorm output (``ln``) as
    swizzled 64-column atoms, the f32 residual ``x`` [64][ldx], the ring's
    mbarriers (``bars``), as many 8 KB ring stages as fit (at most
    ``MAX_STAGES``), and per window:

    - 8: one head's context (``ctx``, hk atoms: it starts at column (h hd)
      % 8, so that its share of Wproj starts 16-byte aligned) and the
      block's rows of one head's q/k/v planes (``qkv``, [3][64][hdp + 8]);
      each product's 64-column tile split between the two warpgroups;
    - 4: the same, the context region at least two atoms (the MLP's
      128-wide hidden chunk); the ping-pong products; ``cluster`` 2 (two
      blocks a group, each half of the heads and hidden chunks, joined
      through distributed shared memory) where that grid still fits one
      wave (2 groups <= sms), else 1;
    - 16: q, k and v of one head transposed (head dims as rows of 64
      tokens: ``hdp`` x 128 bytes each; ``q`` over max(hdp, 16 ``ctx_ksteps``)
      rows, where the context goes after the attention), the ``slot`` of a
      peer's K or V tile (q and slot at least 16 KB: the hidden chunk),
      ``k``, ``v``, the head's relative-position table (``tab``), the
      window's region labels (``lab``) and the two warpgroups' row
      statistics (``ml``); the ping-pong products.

    Also the ring stages one block streams (``weight_tiles``: the stages of
    its products, q/k/v of a head as one product, the MLP in chunks of 128
    hidden columns at windows 4 and 16) and one window
    (``window_weight_tiles``), and the registers a thread may use (one
    block an SM: each of the SM's four register quarters holds up to three
    of its nine warps). The source refuses a launch whose stages, shared
    memory or cluster differ from its own layout. Read only (cached)."""
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"swin_block_plan: window {window}, the kernel "
                         f"takes {KERNEL_WINDOWS}")
    hd = c // nh
    hdp = head_tile(hd)
    kp = -(-c // 64) * 64
    hk = -(-(hd + 7) // 64)     # a head's context from column (h hd) % 8
    ldx = c + (24 - c % 16) % 16
    ks, nc = kp // 64, -(-c // 64)
    windows = b * (h // window) * (w // window)
    regions = {"ln": kp // 64 * STAGE_BYTES}
    plan = {"hdp": hdp, "ldx": ldx, "threads": THREADS, "windows": windows,
            "max_registers": min(255, REGISTERS // 4 // -(-THREADS // 128)
                                 // 32 // 8 * 8)}
    if window == KERNEL_WINDOW:
        regions.update(ctx=hk * STAGE_BYTES, x=64 * ldx * 4,
                       qkv=3 * 64 * (hdp + 8) * 2)
        tiles = 3 * nh * hk * ks + nh * nc * hk + -(-f // 64) * (ks + nc)
        plan.update(cluster=1, blocks=windows, weight_tiles=tiles,
                    window_weight_tiles=tiles)
    elif window == 4:
        regions.update(ctx=max(hk, 2) * STAGE_BYTES, x=64 * ldx * 4,
                       qkv=3 * 64 * (hdp + 8) * 2)
        groups = -(-windows // GROUP4)
        split = 2 if 2 * groups <= sms else 1
        heads = [len(range(r, nh, split)) for r in range(split)]
        chunks = [range(CHUNK * r, f, CHUNK * split) for r in range(split)]
        tiles = [heads[r] * (_tiles(3 * hdp) * ks + nc * hk)
                 + _mlp_tiles(chunks[r], f, ks, nc) for r in range(split)]
        plan.update(group=GROUP4, groups=groups, cluster=split,
                    blocks=groups * split,
                    last_group=windows - (groups - 1) * GROUP4,
                    weight_tiles=tiles[0],
                    window_weight_tiles=sum(tiles) / GROUP4)
    else:
        kk = ctx_ksteps(c, nh)
        tile, qb = hdp * 128, max(hdp, 16 * kk) * 128
        regions.update(q=qb, slot=max(tile, 2 * STAGE_BYTES - qb), k=tile,
                       v=tile, x=64 * ldx * 4, tab=REL_TABLE_BYTES,
                       lab=LABEL_BYTES, ml=2 * 64 * 8)
        tiles = nh * (_tiles(3 * hdp) * ks + nc * -(-kk // 4)) \
            + _mlp_tiles(range(0, f, CHUNK), f, ks, nc)
        plan.update(cluster=CLUSTER, blocks=windows * CLUSTER,
                    ctx_ksteps=kk, weight_tiles=tiles,
                    window_weight_tiles=tiles * CLUSTER)
    fixed = 1024 + sum(regions.values())
    stages = min(MAX_STAGES, (BLOCK_SHARED_MAX - fixed) // (STAGE_BYTES + 16))
    plan.update(stages=stages,
                smem_bytes=fixed + stages * (STAGE_BYTES + 16),
                regions={"ring": stages * STAGE_BYTES, **regions,
                         "bars": 16 * stages})
    return plan


@functools.lru_cache(maxsize=None)
def swin_block_f32_plan(c: int, f: int, nh: int, b: int = 1, h: int = 8,
                        w: int = 8, window: int = KERNEL_WINDOW
                        ) -> Dict[str, Any]:
    """What the f32 kernel (g) (``csrc/swin_block_f32.cuh``) launches for
    width ``c``, hidden width ``f`` and ``nh`` heads at batch ``b`` on ``h``
    x ``w`` tokens: ``F32_THREADS`` a block (eight warps), each holding 64
    token rows (a window at 8x8 windows; ``group`` consecutive windows at
    4x4, the last ``last_group``; one query tile at 16x16, ``cluster``
    blocks a window), ``blocks`` in all, one block an SM.

    A block's shared memory, ``regions`` in the source's order: the rows'
    token offsets (int64), the LayerNorms' per-row mean and 1/std, the
    second key half's row max and sum (``merge``), the context / hidden
    chunk buffer ``act`` (the larger of [64][ldc], ``ldc`` = c rounded up
    to a K step of 32, plus ``F32_PAD``, and the hidden chunk [64][136]), a
    ``union`` of the attention's q, k, v planes [3][64][hdp + 4]
    (``planes``) and ``y`` [64][ldc] (LN2 of the stream after proj), and
    the product ``ring`` (``stages`` x [128][40] f32), which at 16x16
    windows also holds a peer's K or V plane between products (``stage``,
    [64][hdp + 4]). The source refuses a launch whose shared memory, stages
    or cluster differ. Read only (cached)."""
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"swin_block_f32_plan: window {window}, the kernel "
                         f"takes {KERNEL_WINDOWS}")
    hdp = head_tile(c // nh)
    ldc = -(-c // F32_STEP_K) * F32_STEP_K + F32_PAD
    planes = 4 * 3 * 64 * (hdp + 4)
    y = 4 * 64 * ldc
    stage = 4 * 64 * (hdp + 4) if window == 16 else 0
    regions = {"rows": 8 * 64, "ln_stats": 2 * 4 * 64, "merge": 2 * 4 * 64,
               "act": 4 * 64 * max(ldc, CHUNK + F32_PAD),
               "union": max(planes, y),
               "ring": max(4 * F32_STAGES * F32_STAGE_ROWS
                           * (F32_STEP_K + F32_PAD), stage)}
    windows = b * (h // window) * (w // window)
    plan = {"hdp": hdp, "ldc": ldc, "threads": F32_THREADS,
            "stages": F32_STAGES, "windows": windows, "regions": regions,
            "planes": planes, "y": y, "stage": stage,
            "smem_bytes": sum(regions.values())}
    if window == 16:
        plan.update(cluster=CLUSTER, blocks=windows * CLUSTER)
    elif window == 4:
        groups = -(-windows // GROUP4)
        plan.update(cluster=1, blocks=groups, group=GROUP4,
                    last_group=windows - (groups - 1) * GROUP4)
    else:
        plan.update(cluster=1, blocks=windows)
    return plan


def _tiles(n: int) -> int:
    """Output tiles of 64 columns in ``n``."""
    return -(-n // 64)


def _mlp_tiles(starts, f: int, ks: int, nc: int) -> int:
    """Ring stages of the MLP over the 128-wide hidden chunks that start at
    ``starts``: fc1's tiles of the chunk over ``ks`` K steps, then fc2's
    ``nc`` tiles over the chunk's K steps."""
    return sum(_tiles(min(CHUNK, f - f0)) * (ks + nc) for f0 in starts)


def ctx_ksteps(c: int, nh: int) -> int:
    """K steps (16 rows each) of the transposed context kernel (g) keeps at
    16x16 windows: the largest (h hd) % 8 + hd over the heads, rounded up
    (its dims start at row (h hd) % 8, so that its share of Wproj starts
    16-byte aligned)."""
    hd = c // nh
    return -(-max((h * hd) % 8 + hd for h in range(nh)) // 16)


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
    ``out`` [B*h*w, c_k], both bf16 or both f32 (the working type). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (4x4,
    8x8 or 16x16 windows; its f32 instance on f32 tensors) or the call
    raises."""
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
            f"fused_swin_block: the CUDA kernel takes {windows_text()}, "
            f"widths <= {MAX_WIDTH} and multiples of 4, head dims <= 128 (got "
            f"window {win}, {h}x{w}, c {c}, hidden {geo['hidden']})"
            + REFUSED)
    dtype = _build.require_cuda("fused_swin_block", _build.BF16_F32, x, out,
                                *(p[n] for n in _MATRICES))
    _build.require_f32_cuda("fused_swin_block", *(p[n] for n in _VECTORS))
    if mask is not None:
        _build.require_f32_cuda("fused_swin_block", mask)
    if x.stride(0) % 4 or out.stride(0) % 4 or (
            dtype == torch.float32 and (x.data_ptr() | out.data_ptr()) % 16):
        raise ValueError("fused_swin_block: needs row strides of x and out "
                         "that are multiples of 4 (and 16-byte aligned bases "
                         "in f32)")
    check_rows16("fused_swin_block", *(p[n] for n in _MATRICES))
    n = win * win
    if p["attn_bias"].shape != (geo["heads"], n, n) or (
            mask is not None
            and mask.shape != ((h // win) * (w // win), n, n)):
        raise ValueError(f"fused_swin_block: bias "
                         f"{tuple(p['attn_bias'].shape)}, mask "
                         f"{None if mask is None else tuple(mask.shape)} at "
                         f"{win}x{win} windows of {h}x{w} tokens")
    # at 16x16 windows the bias as its table and the mask as region labels
    bias, mask = attn_operands(p, masks, h, w, shift, win)
    if win == 16 and (bias.shape != (geo["heads"], (2 * win - 1) ** 2)
                      or not bias.is_contiguous()):
        raise ValueError(f"fused_swin_block: the bias table "
                         f"{tuple(bias.shape)} at {win}x{win} windows")
    _build.require_f32_cuda("fused_swin_block", bias)
    bsz = m // (h * w)
    lib = _build.library()
    args = [x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
            p["ln1_w"].data_ptr(), p["ln1_b"].data_ptr(),
            p["wqkv"].data_ptr(), p["wqkv"].stride(0), p["bqkv"].data_ptr(),
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            p["wproj"].data_ptr(), p["wproj"].stride(0),
            p["bproj"].data_ptr(), p["ln2_w"].data_ptr(),
            p["ln2_b"].data_ptr(), p["w1"].data_ptr(), p["w1"].stride(0),
            p["b1"].data_ptr(), p["w2"].data_ptr(), p["w2"].stride(0),
            p["b2"].data_ptr(), bsz, h, w, c, geo["hidden"], geo["heads"],
            win, shift]
    if dtype == torch.float32:
        plan = swin_block_f32_plan(c, geo["hidden"], geo["heads"], bsz, h, w,
                                   window=win)
        if plan["smem_bytes"] > BLOCK_SHARED_MAX:
            raise NotImplementedError(
                f"fused_swin_block: the f32 kernel's block {k + 1} (c {c}, "
                f"head dim {c // geo['heads']}) needs {plan['smem_bytes']} "
                f"bytes of shared memory, more than {BLOCK_SHARED_MAX}"
                + REFUSED)
        rc = getattr(lib, F32_ENTRIES[win])(
            *args, plan["stages"], plan["cluster"], EPS, plan["smem_bytes"],
            _build.stream_ptr(x))
        _build.check_rc("fused_swin_block", rc)
        fused_swin_block.launches_f32 += 1
        return out
    plan = swin_block_plan(c, geo["hidden"], geo["heads"], bsz, h, w,
                           window=win, sms=_build.sm_count(x.device))
    if win == KERNEL_WINDOW:
        rc = lib.adsr_swin_block(*args, plan["stages"], EPS,
                                 plan["smem_bytes"], _build.stream_ptr(x))
    else:
        launch = lib.adsr_swin_block4 if win == 4 else lib.adsr_swin_block16
        rc = launch(*args, plan["stages"], plan["cluster"], EPS,
                    plan["smem_bytes"], _build.stream_ptr(x))
    _build.check_rc("fused_swin_block", rc)
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0
fused_swin_block.launches_f32 = 0
