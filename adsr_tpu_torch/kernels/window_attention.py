"""Kernel (c) ``window_attention``: shifted-window MSA over the raster qkv.

Replaces the attention phases of the Pallas kernel ``_rdg_kernel_impl``
(``adsr_tpu/ops/fused_rdg.py:734-855``). Source:
``adsr_tpu_torch/csrc/window_attention.cu``. Bound on the H100: bytes (qkv is
read once, the context written once; the 64-token products are cheap).
Design: one block per (image, window, head); the cyclic shift is index
arithmetic on raster rows, so nothing is rolled or gathered in memory; head
dims are zero-padded to a multiple of 16 in shared memory; the softmax is the
stabilised f32 one (the TPU kernel's unstabilised exp2 form, its score-bound
guard and its window pairs with -1e30 off-diagonal terms are not carried over).

Also here, for packing and the plain version: the additive attention term
(relative-position bias plus shift mask) in its per-window form, the JAX
``build_attn_term`` (``adsr_tpu/ops/fused_swin_block.py:157``) without pair
grouping.
"""

from __future__ import annotations

from typing import Optional

import torch

from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.models.drct import (window_attention_eager,
                                        window_partition, window_reverse)

KERNEL_WINDOW = 8      # the CUDA kernel is written for 8x8 windows (N = 64)


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
    """Context of raster-order ``qkv`` [B*h*w, 3c] into ``out`` [B*h*w, c].

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
    if window != KERNEL_WINDOW or h % window or w % window \
            or c // num_heads > 128:
        raise NotImplementedError(
            f"window_attention: the CUDA kernel takes 8x8 windows and head "
            f"dims <= 128 (got window {window}, {h}x{w}, hd {c // num_heads})")
    _build.require_bf16_cuda("window_attention", qkv, out)
    if not (qkv.is_contiguous() and out.is_contiguous()):
        raise ValueError("window_attention: qkv and out must be contiguous")
    params = (bias,) + ((mask,) if mask is not None else ())
    _build.require_f32_cuda("window_attention", *params)
    rc = _build.library().adsr_window_attention(
        qkv.data_ptr(), out.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(),
        m // (h * w), h, w, c, num_heads, window, shift, _build.stream_ptr(qkv))
    _build.check_rc("window_attention", rc)
    window_attention.launches += 1
    return out


window_attention.launches = 0
