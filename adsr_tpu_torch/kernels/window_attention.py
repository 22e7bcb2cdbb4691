"""Kernel (c) ``window_attention``: shifted-window MSA over the raster qkv.

Replaces the attention phases of the Pallas kernel ``_rdg_kernel_impl``
(``adsr_tpu/ops/fused_rdg.py:734-855``). Source:
``adsr_tpu_torch/csrc/window_attention.cu`` on the attention core of
``csrc/window_attn_core.cuh`` (shared with kernel (g)). Bound on the H100:
bytes (qkv is read once, the context written once; the 64-token products
are cheap). Design: one small block per (image, window, head), several to
an SM, reads the pieces of the window's 64 qkv rows that hold its head in
16-byte loads (``qkv`` and ``out`` have 16-byte rows: row strides that are
multiples of 8 elements, as ``kernels/rdg_gemm.py`` ``pitched`` lays them
out) into q/k/v planes in shared memory (head dims zero-padded to a
multiple of 16); each warp runs the register-resident core (mma.sync
scores, bias and mask, stabilised f32 softmax, P @ V) on 16 query rows; the
context goes back in 16-byte stores. At 16x16 windows (N = 256) one
block per (image, window, head, tile of 64 query rows) walks the window's
four key tiles once with the same core pieces, FlashAttention-2's online
softmax: exp(S - running max) rounded once to bf16 for P @ V, the f32
context rescaled as the max grows and divided by the row sum at the end.
The cyclic shift is index
arithmetic on raster rows, so nothing is rolled or gathered in memory; the
softmax is the stabilised f32 one (the TPU kernel's unstabilised exp2 form,
its score-bound guard and its window pairs with -1e30 off-diagonal terms
are not carried over).

Also here, for packing and the plain version: the additive attention term
(relative-position bias plus shift mask) in its per-window form, the JAX
``build_attn_term`` (``adsr_tpu/ops/fused_swin_block.py:157``) without pair
grouping.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.models.drct import (window_attention_eager,
                                        window_partition, window_reverse)

KERNEL_WINDOW = 8      # the CUDA kernel's first window: 8x8 (N = 64)
KERNEL_WINDOWS = (8, 16)     # the windows it takes: N = 64 and N = 256
KEY_TILE = 64          # keys (and query rows) a tile at N = 256
THREADS = 128          # 4 warps a block, 16 query rows each
SM_SHARED_BYTES = 233472     # an H100 SM's shared memory
BLOCK_SHARED_MAX = 232448    # the most one block may take
BLOCK_RESERVED = 1024        # what the runtime keeps per resident block
REGISTERS = 65536            # 32-bit registers an SM


def head_tile(hd: int) -> int:
    """The head dim a plane holds: ``hd`` zero-padded to a multiple of 16
    (the mma k and n steps)."""
    return -(-hd // 16) * 16


@functools.lru_cache(maxsize=None)
def window_attention_plan(c: int, nh: int, b: int = 1, h: int = 8,
                          w: int = 8, window: int = KERNEL_WINDOW) -> dict:
    """What kernel (c) launches for width ``c`` and ``nh`` heads at batch
    ``b``, ``h`` x ``w`` tokens and ``window`` x ``window`` windows. At
    window 8 one block of ``THREADS`` per (image, window, head), its shared
    memory the head's q/k/v planes [3][64][hdp + 8] bf16; at window 16 one
    block per (image, window, head, tile of 64 query rows), which keeps its
    Q tile and one 64-key K and V tile, the same [3][64][hdp + 8], plus a
    staging area for the next K and V tiles' 16-byte pieces
    (:func:`stage_bytes`), and walks the window's ``key_tiles`` key tiles
    once. Also the blocks an SM holds
    by shared memory and the registers a thread may use for that. The
    source refuses a launch whose shared memory differs from this plan's.
    Read only (cached)."""
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"window_attention_plan: window {window}, the "
                         f"kernel takes {KERNEL_WINDOWS}")
    hdp = head_tile(c // nh)
    n = window * window
    smem = 3 * KEY_TILE * (hdp + 8) * 2
    if window != KERNEL_WINDOW:
        smem += 2 * stage_bytes(hdp)
    per_sm = SM_SHARED_BYTES // (smem + BLOCK_RESERVED)
    return {"hdp": hdp, "ld": hdp + 8, "smem_bytes": smem,
            "threads": THREADS, "tokens": n, "key_tiles": n // KEY_TILE,
            "blocks": b * (h // window) * (w // window) * nh
            * (n // KEY_TILE),
            "blocks_per_sm": per_sm,
            "max_registers": min(255, REGISTERS // (THREADS * per_sm))}


def stage_bytes(hdp: int) -> int:
    """Bytes of one part's staged tile at N = 256: 64 rows of at most
    ``hdp // 8 + 1`` 16-byte pieces (a head from any column offset)."""
    return KEY_TILE * (hdp // 8 + 1) * 16


def check_rows16(name: str, *tensors: torch.Tensor) -> None:
    """The layout rule of ``qkv`` and the context of kernel (c) and of the
    weights of kernel (g), on tensor metadata only (no card needed): 16-byte
    rows, that is unit column stride, a row stride that is a multiple of 8
    elements and a 16-byte aligned base."""
    for t in tensors:
        if t.stride(-1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name}: needs 16-byte rows (unit column "
                             "stride, a row stride that is a multiple of 8 "
                             f"and a 16-byte aligned base), got strides "
                             f"{tuple(t.stride())}")

def build_attn_term(bias: torch.Tensor, h: int, w: int, window: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[nW, nh, N, N] additive term: bias [nh, N, N] (+ mask [nW, N, N])."""
    nw = (h // window) * (w // window)
    term = bias[None].expand(nw, *bias.shape)
    if mask is not None:
        term = term + mask[:, None]
    return term


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor], h: int, w: int,
                           num_heads: int, window: int,
                           shift: int) -> torch.Tensor:
    """f32 context [B*L, c] from raster-order qkv [B*L, 3c]."""
    m, c3 = qkv.shape
    c = c3 // 3
    b = m // (h * w)
    nh, hd, n = num_heads, c // num_heads, window * window
    x = qkv.float().reshape(b, h, w, c3)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = window_partition(x, window).reshape(-1, n, 3, nh, hd)
    q, k, v = xw.permute(2, 0, 3, 1, 4)                  # [B*nW, nh, N, hd]
    o = window_attention_eager(q * hd ** -0.5, k, v, bias.float(),
                               None if mask is None else mask.float())
    o = window_reverse(o.transpose(1, 2).reshape(-1, n, c), window, h, w)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    return o.reshape(m, c)


def window_attention(qkv: torch.Tensor, out: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], h: int, w: int,
                     num_heads: int, window: int, shift: int) -> torch.Tensor:
    """Context of raster-order ``qkv`` [B*h*w, 3c] into ``out`` [B*h*w, c],
    both with 16-byte rows on the card (any strides on the CPU).

    ``bias`` [nh, N, N] f32; ``mask`` [nW, N, N] f32 when ``shift > 0``."""
    m, c3 = qkv.shape
    c = c3 // 3
    n = window * window
    nw = (h // window) * (w // window)
    if (c3 % 3 or m % (h * w) or out.shape != (m, c) or c % num_heads
            or bias.shape != (num_heads, n, n)
            or (shift > 0) != (mask is not None)
            or (mask is not None and mask.shape != (nw, n, n))):
        raise ValueError(f"window_attention: qkv {tuple(qkv.shape)}, out "
                         f"{tuple(out.shape)}, bias {tuple(bias.shape)}, "
                         f"heads {num_heads}, shift {shift}, mask "
                         f"{None if mask is None else tuple(mask.shape)}")
    if qkv.device.type == "cpu":
        out.copy_(window_attention_plain(qkv, bias, mask, h, w, num_heads,
                                         window, shift))
        return out
    if window not in KERNEL_WINDOWS or h % window or w % window \
            or c // num_heads > 128 or c % 4:
        raise NotImplementedError(
            f"window_attention: the CUDA kernel takes 8x8 windows or 16x16 "
            f"windows, widths that are multiples of 4 and head dims <= 128 "
            f"(got window {window}, {h}x{w}, c {c}, hd {c // num_heads})")
    _build.require_bf16_cuda("window_attention", qkv, out)
    check_rows16("window_attention", qkv, out)
    params = (bias,) + ((mask,) if mask is not None else ())
    _build.require_f32_cuda("window_attention", *params)
    rc = _build.library().adsr_window_attention(
        qkv.data_ptr(), qkv.stride(0), out.data_ptr(), out.stride(0),
        bias.data_ptr(), None if mask is None else mask.data_ptr(),
        m // (h * w), h, w, c, num_heads, window, shift,
        window_attention_plan(c, num_heads, window=window)["smem_bytes"],
        _build.stream_ptr(qkv))
    _build.check_rc("window_attention", rc)
    window_attention.launches += 1
    return out


window_attention.launches = 0
