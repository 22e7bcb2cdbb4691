"""Fused DRCT serving forward: the 12 RDGs through ``fused_rdg``, the
convolutional head and tail in plain PyTorch.

The port of ``adsr_tpu/ops/fused_drct.py`` (``prepack_drct`` ``:57``,
``fused_drct_apply`` ``:114``, rdg mode). As there, the head and tail (conv
embed, patch and final LayerNorm in f32 statistics, conv after body,
upsampling convs, pixel shuffle, last conv) stay outside any hand kernel:
``F.conv2d``, ``F.layer_norm``, ``F.pixel_shuffle``. Forward only.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.kernels.fused_rdg import (fused_rdg, prepack_rdg_stack,
                                              rdg_geometry, rdg_workspace)
from adsr_tpu_torch.models.common import RGB_MEAN
from adsr_tpu_torch.models.drct import LN_EPS

_HEAD_CONVS = ("conv_first", "conv_after_body", "conv_before_upsample.0",
               "conv_last")


def prepack_drct(state_dict: Mapping[str, torch.Tensor], cfg: DRCTModelConfig,
                 h: int, w: int, dtype=torch.bfloat16, device="cuda") -> Dict:
    """One-off packing of the port's state_dict for ``fused_drct_apply``:
    RDG operands (``prepack_rdg_stack``) plus the head/tail tensors, all on
    ``device``; conv weights in ``dtype``, LayerNorm params in f32."""
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
    # the dataset mean shift (src/drct.py:773-777), on the device once
    packed["mean"] = torch.tensor(RGB_MEAN if cfg.in_chans == 3
                                  else (0.0,) * cfg.in_chans,
                                  dtype=torch.float32, device=device)
    return packed


def _conv(x: torch.Tensor, wb) -> torch.Tensor:
    w, b = wb
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def _layer_norm(t: torch.Tensor, wb, dtype) -> torch.Tensor:
    return F.layer_norm(t.float(), (t.shape[-1],), wb[0], wb[1],
                        eps=LN_EPS).to(dtype)


def fused_drct_apply(packed: Dict, cfg: DRCTModelConfig, x: torch.Tensor,
                     taps: Optional[List[torch.Tensor]] = None
                     ) -> torch.Tensor:
    """LR [B, h, w, C] float -> SR [B, h*s, w*s, C] float32 from a
    :func:`prepack_drct` tree. ``taps``, when given, collects the [B, L, d]
    token stream after each RDG."""
    dtype = packed["dtype"]
    head = packed["head"]
    d = cfg.embed_dim
    mean = packed["mean"]
    x = ((x.float() - mean) * cfg.img_range).to(dtype)
    b, h, w, _ = x.shape
    m = b * h * w

    feat = _conv(x.permute(0, 3, 1, 2), head["conv_first"])    # NCHW
    tokens = feat.permute(0, 2, 3, 1).reshape(m, d)
    cat = torch.empty(m, rdg_geometry(cfg)["cat_width"], dtype=dtype,
                      device=x.device)
    cat[:, :d] = _layer_norm(tokens, head["patch_embed.norm"], dtype)
    work = rdg_workspace(m, cfg, dtype, x.device)
    for blocks in packed["rdgs"]:
        fused_rdg(cat, blocks, packed["masks"], cfg, h, w, work)
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
