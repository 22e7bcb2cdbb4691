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
``adsr_tpu_torch/csrc/window_attention_bwd.cu``. Bound on the H100: bytes.
Design: one block per (image, window, head), the shift as the forward's
row arithmetic, head dims zero-padded in shared memory. The kernel takes
8x8 windows (``KERNEL_WINDOW``) like the forward, and ``qkv`` at its row
stride (the forward's 16-byte rows, read in place); ``dout`` and ``dqkv``
are contiguous.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
the call raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.window_attention import KERNEL_WINDOW
from adsr_tpu_torch.models.drct import window_partition, window_reverse


def window_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                               bias: torch.Tensor,
                               mask: Optional[torch.Tensor], h: int, w: int,
                               num_heads: int, window: int, shift: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (dqkv [B*L, 3c], dbias [nh, N, N])."""
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
    additive bias into ``dbias`` [nh, N, N] (f32)."""
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
            or c // num_heads > 128:
        raise NotImplementedError(
            f"window_attention_bwd: the CUDA kernel takes 8x8 windows and "
            f"head dims <= 128 (got window {window}, hd {c // num_heads})")
    _build.require_bf16_cuda("window_attention_bwd", qkv, dout, dqkv)
    if not (qkv.stride(1) == 1 and dout.is_contiguous()
            and dqkv.is_contiguous()):
        raise ValueError("window_attention_bwd: qkv needs unit column "
                         "stride, dout and dqkv must be contiguous")
    params = (bias, dbias) + ((mask,) if mask is not None else ())
    _build.require_f32_cuda("window_attention_bwd", *params)
    b = m // (h * w)
    part = torch.empty(b * nw * num_heads * n * n, dtype=torch.float32,
                       device=qkv.device)
    rc = _build.library().adsr_window_attention_bwd(
        qkv.data_ptr(), qkv.stride(0), dout.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), dqkv.data_ptr(),
        part.data_ptr(), dbias.data_ptr(), b, h, w, c, num_heads, window,
        shift, _build.stream_ptr(qkv))
    _build.check_rc("window_attention_bwd", rc)
    window_attention_bwd.launches += 1


window_attention_bwd.launches = 0
