"""Kernel (f) ``window_attention_bwd``: backward of the shifted-window MSA.

From the raster-order ``qkv`` [B*L, 3c] and the context's gradient ``dout``
[B*L, c]: recompute ``S = q k^T * scale + bias + mask`` and the stabilised
softmax ``P``, then ``dV = P^T dO``, ``dP = dO V^T``,
``dS = P o (dP - rowsum(dO o O))``, ``dQ = dS K * scale``,
``dK = dS^T Q * scale``, written into a raster-order ``dqkv`` [B*L, 3c], and
``d(bias)`` [nh, N, N], the sum of dS over every window of every image
(deterministic two-pass reduction).

Replaces the attention backward phases of the Pallas kernel ``_bwd_kernel``
(``adsr_tpu/ops/fused_rdg_train.py:405-770``). Source:
``adsr_tpu_torch/csrc/window_attention_bwd.cu`` on the backward core of
``csrc/window_attn_bwd_core.cuh``. Bound on the H100: bytes. Design: a
block takes one head and a group of consecutive windows
(:func:`window_attention_bwd_plan`), gathers each window's q, k, v and dO by
16-byte pieces, keeps S, P, dP, dS and dQ of each warp's 16 rows in
registers, computes dK and dV from bf16 P and dS tiles, and writes one
d(bias) partial per (group, head). The kernel takes 8x8 windows
(``KERNEL_WINDOW``) like the forward, and ``qkv``, ``dout`` and ``dqkv``
with 16-byte rows at their row strides (:func:`check_rows16`).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
the call raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.window_attention import (BLOCK_RESERVED,
                                                     KERNEL_WINDOW, REGISTERS,
                                                     SM_SHARED_BYTES,
                                                     check_rows16, head_tile)
from adsr_tpu_torch.models.drct import window_partition, window_reverse

THREADS = 128          # 4 warps, 16 query (and key) rows each
MAX_GROUP = 8          # windows a block
_TOKENS = KERNEL_WINDOW ** 2
_TILE_LD = _TOKENS + 8          # bf16 pitch of the P and dS tiles
_SMS = 132                      # the H100's SMs


def min_blocks(hdp: int) -> int:
    """Blocks an SM holds by registers: the source's ``__launch_bounds__``
    minimum (168 registers a thread up to a head tile of 80, else 255)."""
    return 3 if hdp <= 80 else 2


@functools.lru_cache(maxsize=None)
def window_attention_bwd_plan(c: int, nh: int, b: int = 1, h: int = 8,
                              w: int = 8, sms: int = _SMS) -> dict:
    """What kernel (f) launches for width ``c`` and ``nh`` heads at batch
    ``b`` and ``h`` x ``w`` tokens. A block of ``THREADS`` takes one head
    and ``group`` consecutive (image, window)s, the last group possibly
    short; its shared memory holds the head's q, k, v and dO planes
    [4][64][hdp + 8] and the bf16 P and dS tiles [2][64][72]. ``group`` is
    the fewest windows a block (at most ``MAX_GROUP``) for which every
    block is resident at once, ``blocks_per_sm`` of them an SM (by shared
    memory and :func:`min_blocks`): one wave, as many blocks as fit, and
    G times fewer d(bias) partials, one per (group, head), than windows.
    The source refuses a launch whose shared memory differs from this
    plan's. Read only (cached)."""
    hdp = head_tile(c // nh)
    smem = 4 * _TOKENS * (hdp + 8) * 2 + 2 * _TOKENS * _TILE_LD * 2
    per_sm = min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED), min_blocks(hdp))
    windows = b * (h // KERNEL_WINDOW) * (w // KERNEL_WINDOW)
    group = next((g for g in range(1, MAX_GROUP)
                  if nh * -(-windows // g) <= per_sm * sms), MAX_GROUP)
    groups = -(-windows // group)
    return {"hdp": hdp, "ld": hdp + 8, "smem_bytes": smem,
            "threads": THREADS, "windows": windows, "group": group,
            "groups": groups, "last_group": windows - (groups - 1) * group,
            "blocks": groups * nh, "blocks_per_sm": per_sm,
            "max_registers": min(255, REGISTERS // (THREADS * per_sm)),
            "partial_bytes": groups * nh * _TOKENS * _TOKENS * 4}


def window_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                               bias: torch.Tensor,
                               mask: Optional[torch.Tensor], h: int, w: int,
                               num_heads: int, window: int, shift: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (dqkv [B*L, 3c], dbias [nh, N, N]); any strides."""
    m, c3 = qkv.shape
    c = c3 // 3
    b = m // (h * w)
    nh, hd, n = num_heads, c // num_heads, window * window

    def windows(t: torch.Tensor) -> torch.Tensor:
        x = t.float().reshape(b, h, w, t.shape[1])
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        return window_partition(x, window)                # [B*nW, N, ch]

    q, k, v = windows(qkv).reshape(-1, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    do = windows(dout).reshape(-1, n, nh, hd).transpose(1, 2)
    scale = hd ** -0.5
    s = (q * scale) @ k.transpose(-1, -2) + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.view(-1, nw, nh, n, n)
             + mask.float()[None, :, None]).view(-1, nh, n, n)
    p = s.softmax(dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = ds @ k * scale
    dk = ds.transpose(-1, -2) @ q * scale
    dv = p.transpose(-1, -2) @ do
    g = torch.stack([dq, dk, dv], 2)                      # [B*nW, nh, 3, N, hd]
    g = g.permute(0, 3, 2, 1, 4).reshape(-1, n, c3)
    g = window_reverse(g, window, h, w)
    if shift:
        g = torch.roll(g, (shift, shift), dims=(1, 2))
    return g.reshape(m, c3), ds.sum(0)


def window_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         h: int, w: int, num_heads: int, window: int,
                         shift: int, dqkv: torch.Tensor,
                         dbias: torch.Tensor) -> None:
    """Write the gradient of ``qkv`` into ``dqkv`` [B*L, 3c] and of the
    additive bias into ``dbias`` [nh, N, N] (f32). On the card ``qkv``,
    ``dout`` and ``dqkv`` have 16-byte rows (any row stride that is a
    multiple of 8); any strides on the CPU."""
    m, c3 = qkv.shape
    c = c3 // 3
    n = window * window
    nw = (h // window) * (w // window)
    if (c3 % 3 or m % (h * w) or dout.shape != (m, c) or c % num_heads
            or dqkv.shape != (m, c3) or bias.shape != (num_heads, n, n)
            or dbias.shape != (num_heads, n, n)
            or (shift > 0) != (mask is not None)
            or (mask is not None and mask.shape != (nw, n, n))):
        raise ValueError(f"window_attention_bwd: qkv {tuple(qkv.shape)}, "
                         f"dout {tuple(dout.shape)}, dqkv "
                         f"{tuple(dqkv.shape)}, heads {num_heads}, shift "
                         f"{shift}")
    if qkv.device.type == "cpu":
        gq, gb = window_attention_bwd_plain(qkv, dout, bias, mask, h, w,
                                            num_heads, window, shift)
        dqkv.copy_(gq)
        dbias.copy_(gb)
        return
    if window != KERNEL_WINDOW or h % window or w % window \
            or c // num_heads > 128 or c % 4:
        raise NotImplementedError(
            f"window_attention_bwd: the CUDA kernel takes 8x8 windows, widths "
            f"that are multiples of 4 and head dims <= 128 (got window "
            f"{window}, c {c}, hd {c // num_heads})")
    check_rows16("window_attention_bwd", qkv, dout, dqkv)
    _build.require_bf16_cuda("window_attention_bwd", qkv, dout, dqkv)
    params = (bias, dbias) + ((mask,) if mask is not None else ())
    _build.require_f32_cuda("window_attention_bwd", *params)
    b = m // (h * w)
    plan = window_attention_bwd_plan(c, num_heads, b, h, w,
                                     _build.sm_count(qkv.device))
    part = torch.empty(plan["partial_bytes"] // 4, dtype=torch.float32,
                       device=qkv.device)
    rc = _build.library().adsr_window_attention_bwd(
        qkv.data_ptr(), qkv.stride(0), dout.data_ptr(), dout.stride(0),
        bias.data_ptr(), None if mask is None else mask.data_ptr(),
        dqkv.data_ptr(), dqkv.stride(0), part.data_ptr(), dbias.data_ptr(),
        b, h, w, c, num_heads, window, shift, plan["group"],
        plan["smem_bytes"],
        _build.stream_ptr(qkv))
    _build.check_rc("window_attention_bwd", rc)
    window_attention_bwd.launches += 1


window_attention_bwd.launches = 0
