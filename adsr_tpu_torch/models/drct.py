"""DRCT Swin-style transformer SR network, eager PyTorch (NHWC at the edges).

The plain version of the whole serving forward: the fused path
(``kernels/fused_drct.py``) is held against it. Module names are the
reference torch names (reference src/drct.py:716-898), so the JAX package's
``convert_drct`` maps this ``state_dict`` into its params unchanged:
``conv_first``, ``patch_embed.norm``, ``layers.{i}.swin{k}.{norm1, attn.qkv,
attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{i}.adjust{k}``, ``norm``, ``conv_after_body``,
``conv_before_upsample.0``, ``upsample.{0,2}``, ``conv_last``.

Architecture arithmetic (as the JAX ``models/drct.py``):
- per-block head fix-up ``num_heads - ((dim + k*gc) % num_heads)``: embed 180,
  gc 32 -> dims 180/212/244/276/308 with heads 6/4/2/6/4;
- blocks 4 and 5 of each RDG use mlp_ratio 1;
- LayerNorm eps 1e-6 (flax's default, not torch's 1e-5).
Forward only, deterministic (stochastic depth is a training concern).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.models.common import RGB_MEAN

LN_EPS = 1e-6


# --------------------------------------------------------------------------- #
# Static geometry: relative-position index and shifted-window masks
# --------------------------------------------------------------------------- #

@lru_cache(maxsize=None)
def relative_position_index(window_size: int) -> np.ndarray:
    """[N, N] gather index into the (2W-1)^2 bias table (src/drct.py:249-259)."""
    w = window_size
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


@lru_cache(maxsize=None)
def shift_attn_mask(h: int, w: int, window_size: int, shift: int) -> np.ndarray:
    """[nW, N, N] additive 0/-100 mask for SW-MSA (src/drct.py:449-470)."""
    img = np.zeros((h, w))
    slices = (slice(0, -window_size), slice(-window_size, -shift),
              slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    win = (img.reshape(h // window_size, window_size,
                       w // window_size, window_size)
              .transpose(0, 2, 1, 3)
              .reshape(-1, window_size * window_size))
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, win*win, C] (src/drct.py:193-204)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def window_reverse(x: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    """[B*nW, win*win, C] -> [B, H, W, C] (src/drct.py:207-220)."""
    c = x.shape[-1]
    b = x.shape[0] // (h * w // win // win)
    x = x.reshape(b, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_position_bias(table: torch.Tensor, window_size: int
                           ) -> torch.Tensor:
    """Gather the (2W-1)^2 x nh table into the [nh, N, N] bias
    (the JAX ``pack_swin_weights_jnp`` gather, fused_swin_block.py:129-134)."""
    n = window_size * window_size
    idx = torch.as_tensor(relative_position_index(window_size).reshape(-1),
                          device=table.device)
    return table[idx].reshape(n, n, table.shape[1]).permute(2, 0, 1)


def window_attention_eager(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Per-window attention; q, k, v [B*nW, nh, N, hd] with q pre-scaled,
    bias [nh, N, N], mask [nW, N, N] (the JAX ``window_attention_xla``)."""
    b, nh, n, _ = q.shape
    attn = q @ k.transpose(-1, -2) + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b // nw, nw, nh, n, n)
                + mask[None, :, None].to(attn.dtype)).view(b, nh, n, n)
    return attn.softmax(dim=-1) @ v


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #

class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))   # exact-erf GELU


class WindowAttention(nn.Module):
    """W-MSA with learned relative position bias (src/drct.py:223-302)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]          # [B, nh, N, hd]
        bias = relative_position_bias(self.relative_position_bias_table,
                                      self.window_size)
        out = window_attention_eager(q * hd ** -0.5, k, v, bias, mask)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class SwinBlock(nn.Module):
    """Swin transformer block with optional cyclic shift (src/drct.py:398-512)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float, qkv_bias: bool = True):
        super().__init__()
        win, shift = window_size, shift_size
        # window-size clamp for small inputs (src/drct.py:426-429)
        if min(input_resolution) <= win:
            win, shift = min(input_resolution), 0
        self.window_size, self.shift_size = win, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, win, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        h, w = x_size
        b, l, c = x.shape
        win, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = None
        if shift > 0:
            mask = torch.as_tensor(shift_attn_mask(h, w, win, shift),
                                   device=x.device)
        xw = self.attn(window_partition(x, win), mask)
        x = window_reverse(xw, win, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


def _to_space(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Patch-unembed: [B, L, C] -> [B, C, H, W]."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """Patch-embed: [B, C, H, W] -> [B, L, C]."""
    return x.flatten(2).transpose(1, 2)


class RDG(nn.Module):
    """Residual Dense Group: 5 Swin blocks, dense growth gc (src/drct.py:322-396)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, mlp_ratio: float, gc: int,
                 qkv_bias: bool = True):
        super().__init__()
        shift = window_size // 2
        for k in range(5):
            feat = dim + k * gc
            heads = num_heads if k == 0 else num_heads - (feat % num_heads)
            ratio = mlp_ratio if k < 3 else 1.0
            self.add_module(f"swin{k + 1}", SwinBlock(
                feat, input_resolution, heads, window_size,
                shift if k % 2 else 0, ratio, qkv_bias))
            self.add_module(f"adjust{k + 1}",
                            nn.Conv2d(feat, dim if k == 4 else gc, 1))

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        h, w = x_size
        outs = [x]
        for k in range(5):
            inp = outs[0] if k == 0 else torch.cat(outs, dim=-1)
            t = getattr(self, f"swin{k + 1}")(inp, x_size)
            t = _to_tokens(getattr(self, f"adjust{k + 1}")(_to_space(t, h, w)))
            if k < 4:
                t = F.leaky_relu(t, 0.2)
            outs.append(t)
        return outs[5] * 0.2 + x


class PatchEmbed(nn.Module):
    """Holds the top-level patch-embed LayerNorm (patch_norm=True in the
    reference, src/drct.py:739, 793-798)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


class DRCT(nn.Module):
    """Full DRCT model: LR [B, h, w, C] -> SR [B, h*scale, w*scale, C]."""

    def __init__(self, cfg: DRCTModelConfig):
        super().__init__()
        if cfg.upscale & (cfg.upscale - 1):
            raise NotImplementedError("only power-of-two scales")
        self.cfg = cfg
        d, nf = cfg.embed_dim, cfg.num_feat
        res = (cfg.img_size, cfg.img_size)
        self.conv_first = nn.Conv2d(cfg.in_chans, d, 3, 1, 1)
        self.patch_embed = PatchEmbed(d)
        self.layers = nn.ModuleList(
            RDG(d, res, cfg.num_heads, cfg.window_size, cfg.mlp_ratio, cfg.gc,
                cfg.qkv_bias) for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.conv_after_body = nn.Conv2d(d, d, 3, 1, 1)
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(d, nf, 3, 1, 1),
                                                  nn.LeakyReLU(0.01))
        ups: List[nn.Module] = []
        for _ in range(cfg.upscale.bit_length() - 1):
            ups += [nn.Conv2d(nf, 4 * nf, 3, 1, 1), nn.PixelShuffle(2)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = nn.Conv2d(nf, cfg.in_chans, 3, 1, 1)
        # dataset mean shift (src/drct.py:773-777); not a parameter
        self.register_buffer("mean", torch.tensor(
            RGB_MEAN if cfg.in_chans == 3 else (0.0,) * cfg.in_chans),
            persistent=False)

    def forward(self, x: torch.Tensor,
                taps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """x: LR NHWC float. ``taps``, when given, collects the [B, L, d]
        token stream after each RDG."""
        cfg = self.cfg
        x = (x - self.mean) * cfg.img_range
        b, h, w, _ = x.shape
        feat = self.conv_first(x.permute(0, 3, 1, 2))
        t = self.patch_embed.norm(_to_tokens(feat))
        for layer in self.layers:
            t = layer(t, (h, w))
            if taps is not None:
                taps.append(t)
        deep = _to_space(self.norm(t), h, w)
        y = self.conv_after_body(deep) + feat
        y = self.conv_last(self.upsample(self.conv_before_upsample(y)))
        return y.permute(0, 2, 3, 1) / cfg.img_range + self.mean
