"""Serving forward of one Residual Dense Group through kernels (a)-(c).

The port of the Pallas kernel ``fused_rdg`` (``adsr_tpu/ops/fused_rdg.py:489``,
body ``_rdg_kernel_impl`` ``:636``). The TPU kernel keeps a whole RDG in VMEM;
on the H100 one RDG's concat buffer (1024 x 308 bf16 = 0.63 MB an image)
exceeds an SM's 227 KB of shared memory, so an RDG is a short sequence of
launches around a concat buffer ``cat`` [B*L, d + 4*gc] (308 columns at the
flagship) in device memory:

    for k in 0..4:                                   # 5 Swin blocks
        ln   = rdg_layernorm(cat[:, :c_k])            # (a)
        qkv  = rdg_gemm(ln, Wqkv) ; ctx = window_attention(qkv)   # (b) (c)
        x1   = rdg_gemm(ctx, Wproj, residual=cat[:, :c_k])
        ln   = rdg_layernorm(x1) ; hid = rdg_gemm(ln, W1, gelu)
        x2   = rdg_gemm(hid, W2, residual=x1)
        k < 4:  cat[:, c_k:c_k+gc] = rdg_gemm(x2, Wadj, leaky_relu)
        k == 4: cat[:, :d] = 0.2 * rdg_gemm(x2, Wadj) + cat[:, :d]   # in place

Tokens stay in raster order (no quadrant-major order, no lane padding, no
window pairs) and every weight stays unfolded: the port computes the model's
function plainly, with a stabilised softmax and exact-erf GELU (the JAX bf16
serving path uses an unstabilised exp2 softmax and tanh GELU). The per-RDG
output overwrites ``cat[:, :d]``, so one buffer serves all 12 RDGs: columns
past ``d`` are always rewritten by block k before block k+1 reads them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.kernels.rdg_gemm import rdg_gemm
from adsr_tpu_torch.kernels.rdg_layernorm import rdg_layernorm
from adsr_tpu_torch.kernels.window_attention import window_attention
from adsr_tpu_torch.models.drct import relative_position_bias, shift_attn_mask


def rdg_geometry(cfg: DRCTModelConfig) -> Dict[str, tuple]:
    """Per-block channel/head/shift/hidden arithmetic (src/drct.py:337-373)."""
    d, gc, nh = cfg.embed_dim, cfg.gc, cfg.num_heads
    shift = cfg.window_size // 2
    feats = tuple(d + k * gc for k in range(5))
    heads = (nh,) + tuple(nh - ((d + k * gc) % nh) for k in range(1, 5))
    ratios = (cfg.mlp_ratio,) * 3 + (1.0, 1.0)
    return {"feats": feats, "heads": heads,
            "shifts": (0, shift, 0, shift, 0),
            "hidden": tuple(int(c * r) for c, r in zip(feats, ratios)),
            "adj_out": (gc,) * 4 + (d,),
            "cat_width": feats[4]}          # d + 4*gc: block 5's input


def _pack_block(sd: Mapping[str, torch.Tensor], layer: int, k: int, c: int,
                window: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Block ``k`` (1-based) of RDG ``layer``: matrices in ``dtype`` as torch
    Linear [out, in], vectors and the attention bias in f32."""
    sw, adj = f"layers.{layer}.swin{k}", f"layers.{layer}.adjust{k}"

    def get(name, dt):
        return torch.as_tensor(sd[name]).detach() \
            .to(device=device, dtype=dt).contiguous()

    wadj = get(f"{adj}.weight", dtype)              # 1x1 conv [O, I, 1, 1]
    qkv_b = f"{sw}.attn.qkv.bias"                   # absent with qkv_bias=False
    table = get(f"{sw}.attn.relative_position_bias_table", torch.float32)
    return {
        "ln1_w": get(f"{sw}.norm1.weight", torch.float32),
        "ln1_b": get(f"{sw}.norm1.bias", torch.float32),
        "wqkv": get(f"{sw}.attn.qkv.weight", dtype),
        "bqkv": (get(qkv_b, torch.float32) if qkv_b in sd else
                 torch.zeros(3 * c, dtype=torch.float32, device=device)),
        "attn_bias": relative_position_bias(table, window).contiguous(),
        "wproj": get(f"{sw}.attn.proj.weight", dtype),
        "bproj": get(f"{sw}.attn.proj.bias", torch.float32),
        "ln2_w": get(f"{sw}.norm2.weight", torch.float32),
        "ln2_b": get(f"{sw}.norm2.bias", torch.float32),
        "w1": get(f"{sw}.mlp.fc1.weight", dtype),
        "b1": get(f"{sw}.mlp.fc1.bias", torch.float32),
        "w2": get(f"{sw}.mlp.fc2.weight", dtype),
        "b2": get(f"{sw}.mlp.fc2.bias", torch.float32),
        "wadj": wadj.reshape(wadj.shape[0], wadj.shape[1]),  # == Linear [O, I]
        "badj": get(f"{adj}.bias", torch.float32),
    }


def prepack_rdg_stack(state_dict: Mapping[str, torch.Tensor],
                      cfg: DRCTModelConfig, h: int, w: int,
                      dtype=torch.bfloat16, device="cuda") -> Dict:
    """The port's state_dict -> {'rdgs': [num_layers x [5 block dicts]],
    'masks': {shift: [nW, N, N] f32}}, on ``device``. Run once at
    registration (the counterpart of ``prepack_rdg_stack``,
    adsr_tpu/ops/fused_rdg.py:394): the bias gather and the shift masks are
    built here, never per forward."""
    win = cfg.window_size
    if min(h, w) <= win or h % win or w % win:
        raise ValueError(f"fused RDG path needs an image larger than, and a "
                         f"multiple of, the window ({h}x{w}, window {win})")
    g = rdg_geometry(cfg)
    masks = {s: torch.as_tensor(shift_attn_mask(h, w, win, s), device=device)
             for s in set(g["shifts"]) if s}
    rdgs = [[_pack_block(state_dict, i, k + 1, g["feats"][k], win, dtype,
                         device) for k in range(5)]
            for i in range(cfg.num_layers)]
    return {"rdgs": rdgs, "masks": masks}


def rdg_workspace(m: int, cfg: DRCTModelConfig, dtype,
                  device) -> Dict[str, torch.Tensor]:
    """Flat scratch buffers for one RDG at ``m`` token rows (reused by all)."""
    g = rdg_geometry(cfg)
    cmax = max(g["feats"])
    sizes = {"ln": cmax, "qkv_hid": max(3 * cmax, max(g["hidden"])),
             "ctx_x2": cmax, "x1": cmax}
    return {k: torch.empty(m * n, dtype=dtype, device=device)
            for k, n in sizes.items()}


def _rows(buf: torch.Tensor, m: int, n: int) -> torch.Tensor:
    return buf[:m * n].view(m, n)


def fused_rdg(cat: torch.Tensor, blocks: List[Dict[str, torch.Tensor]],
              masks: Dict[int, torch.Tensor], cfg: DRCTModelConfig,
              h: int, w: int, work: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One RDG in place: reads the tokens from ``cat[:, :d]`` (raster order,
    B*h*w rows) and leaves the RDG's output there. ``work`` holds the
    scratch buffers of :func:`rdg_workspace`."""
    g = rdg_geometry(cfg)
    m = cat.shape[0]
    d = cfg.embed_dim
    if cat.shape[1] != g["cat_width"]:
        raise ValueError(f"fused_rdg: concat buffer width {cat.shape[1]}, "
                         f"expected {g['cat_width']}")
    for k, p in enumerate(blocks):
        c, nh, shift = g["feats"][k], g["heads"][k], g["shifts"][k]
        f = g["hidden"][k]
        x = cat[:, :c]
        ln = _rows(work["ln"], m, c)
        qkv = _rows(work["qkv_hid"], m, 3 * c)
        ctx = _rows(work["ctx_x2"], m, c)
        x1 = _rows(work["x1"], m, c)
        rdg_layernorm(x, p["ln1_w"], p["ln1_b"], ln)
        rdg_gemm(ln, p["wqkv"], p["bqkv"], qkv)
        window_attention(qkv, ctx, p["attn_bias"], masks.get(shift), h, w,
                         nh, cfg.window_size, shift)
        rdg_gemm(ctx, p["wproj"], p["bproj"], x1, "residual", residual=x)
        rdg_layernorm(x1, p["ln2_w"], p["ln2_b"], ln)
        hid = _rows(work["qkv_hid"], m, f)
        rdg_gemm(ln, p["w1"], p["b1"], hid, "gelu")
        x2 = _rows(work["ctx_x2"], m, c)
        rdg_gemm(hid, p["w2"], p["b2"], x2, "residual", residual=x1)
        if k < 4:
            rdg_gemm(x2, p["wadj"], p["badj"], cat[:, c:c + cfg.gc],
                     "leaky_relu")
        else:
            rdg_gemm(x2, p["wadj"], p["badj"], cat[:, :d], "scaled_residual",
                     residual=cat[:, :d])
    return cat


def rdg_flops(cfg: DRCTModelConfig, m: int) -> int:
    """Multiply-add flops (x2) of one RDG's matmuls and attention at ``m``
    token rows; for bounds and MFU, computed from the shapes."""
    g = rdg_geometry(cfg)
    n = cfg.window_size ** 2
    total = 0
    for c, f, a in zip(g["feats"], g["hidden"], g["adj_out"]):
        total += 2 * m * c * (3 * c + c + f) + 2 * m * f * c + 2 * m * c * a
        total += 2 * 2 * m * n * c          # q k^T and p v over all heads
    return total

