"""Fused DRCT serving forward: the 12 RDGs on the hand-written kernels, the
convolutional head and tail in plain PyTorch.

The port of ``adsr_tpu/ops/fused_drct.py`` (``prepack_drct`` ``:57``,
``fused_drct_apply`` ``:114``) in both of its modes:

- ``"rdg"`` (the default): each RDG through ``fused_rdg``, 40 launches of
  kernels (a)-(c) (the port of TPU kernel 1);
- ``"block"`` (``ADSR_TPU_RDG=0``, as in the JAX package): each Swin block
  through kernel (g) ``fused_swin_block`` (the port of TPU kernel 4),
  followed by its adjust conv through ``rdg_gemm`` into the concat buffer,
  10 launches an RDG.

Both modes read the same packed block dicts, whose matrices sit in 16-byte
rows: kernels (b) and (g) load them by TMA, so no mode keeps a second copy
of the weights. As there, the head and tail (conv embed, patch and final
LayerNorm in f32 statistics, conv after body, upsampling convs, pixel
shuffle, last conv) stay outside any hand kernel: ``F.conv2d``,
``F.layer_norm``, ``F.pixel_shuffle``. Forward only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.kernels.fused_rdg import (_rows, dense_adjust,
                                              fused_rdg, prepack_rdg_stack,
                                              rdg_geometry, rdg_workspace)
from adsr_tpu_torch.kernels.fused_swin_block import fused_swin_block
from adsr_tpu_torch.kernels.rdg_gemm import row_pitch
from adsr_tpu_torch.models.common import RGB_MEAN
from adsr_tpu_torch.models.drct import LN_EPS

_HEAD_CONVS = ("conv_first", "conv_after_body", "conv_before_upsample.0",
               "conv_last")
MODES = ("rdg", "block")


def resolve_mode(mode: Optional[str] = None) -> str:
    """``None`` reads ``ADSR_TPU_RDG`` as the JAX package does
    (adsr_tpu/ops/fused_drct.py:76-79): ``"0"`` selects ``"block"``."""
    if mode is None:
        mode = "block" if os.environ.get("ADSR_TPU_RDG", "1") == "0" else "rdg"
    if mode not in MODES:
        raise ValueError(f"unknown fused DRCT mode {mode!r}; one of {MODES}")
    return mode


def prepack_drct(state_dict: Mapping[str, torch.Tensor], cfg: DRCTModelConfig,
                 h: int, w: int, dtype=torch.bfloat16, device="cuda",
                 mode: Optional[str] = None) -> Dict:
    """One-off packing of the port's state_dict for ``fused_drct_apply``:
    RDG operands (``prepack_rdg_stack``) plus the head/tail tensors, all on
    ``device``; conv weights in ``dtype``, LayerNorm params in f32. ``mode``
    (see :func:`resolve_mode`) is recorded for ``fused_drct_apply``."""
    packed = prepack_rdg_stack(state_dict, cfg, h, w, dtype=dtype,
                               device=device)

    def get(name, dt):
        return torch.as_tensor(state_dict[name]).detach() \
            .to(device=device, dtype=dt).contiguous()

    head = {}
    n_up = cfg.upscale.bit_length() - 1
    for name in _HEAD_CONVS + tuple(f"upsample.{2 * i}" for i in range(n_up)):
        head[name] = (get(f"{name}.weight", dtype), get(f"{name}.bias", dtype))
    for name in ("patch_embed.norm", "norm"):
        head[name] = (get(f"{name}.weight", torch.float32),
                      get(f"{name}.bias", torch.float32))
    packed["head"] = head
    packed["dtype"] = dtype
    packed["mode"] = resolve_mode(mode)
    # the dataset mean shift (src/drct.py:773-777), on the device once
    packed["mean"] = torch.tensor(RGB_MEAN if cfg.in_chans == 3
                                  else (0.0,) * cfg.in_chans,
                                  dtype=torch.float32, device=device)
    return packed


def rdg_by_blocks(cat: torch.Tensor, blocks: List[Dict[str, torch.Tensor]],
                  masks: Dict[int, torch.Tensor], cfg: DRCTModelConfig,
                  h: int, w: int, x2: torch.Tensor) -> torch.Tensor:
    """One RDG in block mode, over ``cat[:, :d]`` in place: five times
    kernel (g) on the concat prefix into the scratch ``x2`` (flat, at least
    M x row_pitch(c_5) elements: 16-byte rows, which the adjust conv's GEMM
    loads by TMA), then the block's adjust conv (the JAX block mode's
    ``layer``, adsr_tpu/ops/fused_drct.py:169-184)."""
    m = cat.shape[0]
    feats = rdg_geometry(cfg)["feats"]
    for k, p in enumerate(blocks):
        c = feats[k]
        y = fused_swin_block(cat[:, :c], p, masks, cfg, h, w, k,
                             _rows(x2, m, c, row_pitch(c)))
        dense_adjust(cat, y, p, cfg, k)
    return cat[:, :cfg.embed_dim]


def _conv(x: torch.Tensor, wb) -> torch.Tensor:
    w, b = wb
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def _layer_norm(t: torch.Tensor, wb, dtype) -> torch.Tensor:
    return F.layer_norm(t.float(), (t.shape[-1],), wb[0], wb[1],
                        eps=LN_EPS).to(dtype)


def fused_drct_apply(packed: Dict, cfg: DRCTModelConfig, x: torch.Tensor,
                     taps: Optional[List[torch.Tensor]] = None,
                     mode: Optional[str] = None) -> torch.Tensor:
    """LR [B, h, w, C] float -> SR [B, h*s, w*s, C] float32 from a
    :func:`prepack_drct` tree, in ``mode`` (default: the packed one).
    ``taps``, when given, collects the [B, L, d] token stream after each
    RDG."""
    mode = packed["mode"] if mode is None else resolve_mode(mode)
    dtype = packed["dtype"]
    head = packed["head"]
    d = cfg.embed_dim
    mean = packed["mean"]
    x = ((x.float() - mean) * cfg.img_range).to(dtype)
    b, h, w, _ = x.shape
    m = b * h * w

    feat = _conv(x.permute(0, 3, 1, 2), head["conv_first"])    # NCHW
    tokens = feat.permute(0, 2, 3, 1).reshape(m, d)
    g = rdg_geometry(cfg)
    cat = torch.empty(m, g["cat_width"], dtype=dtype, device=x.device)
    cat[:, :d] = _layer_norm(tokens, head["patch_embed.norm"], dtype)
    if mode == "rdg":
        work = rdg_workspace(m, cfg, dtype, x.device)
    else:
        x2 = torch.empty(m * row_pitch(max(g["feats"])), dtype=dtype,
                         device=x.device)
    for blocks in packed["rdgs"]:
        if mode == "rdg":
            fused_rdg(cat, blocks, packed["masks"], cfg, h, w, work)
        else:
            rdg_by_blocks(cat, blocks, packed["masks"], cfg, h, w, x2)
        if taps is not None:
            taps.append(cat[:, :d].reshape(b, h * w, d).clone())

    t = _layer_norm(cat[:, :d], head["norm"], dtype)
    deep = t.reshape(b, h, w, d).permute(0, 3, 1, 2)
    y = _conv(deep, head["conv_after_body"]) + feat
    y = F.leaky_relu(_conv(y, head["conv_before_upsample.0"]), 0.01)
    for i in range(cfg.upscale.bit_length() - 1):
        y = F.pixel_shuffle(_conv(y, head[f"upsample.{2 * i}"]), 2)
    y = _conv(y, head["conv_last"])
    return y.permute(0, 2, 3, 1).float() / cfg.img_range + mean
