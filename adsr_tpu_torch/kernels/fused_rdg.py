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

The training forward (TPU kernel 2, ``kernels/fused_rdg_train.py``) runs the
same launches with two changes: proj and fc2 take the per-sample
stochastic-depth epilogue (``dp``), and adjust 5 writes the RDG's output to
``out``, so ``cat`` keeps every block's input for the backward.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional

import torch

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.kernels.rdg_gemm import pitched, rdg_gemm, row_pitch
from adsr_tpu_torch.kernels.rdg_layernorm import rdg_layernorm
from adsr_tpu_torch.kernels.window_attention import (attn_operands,
                                                     window_attention)
from adsr_tpu_torch.models.drct import relative_position_bias, shift_attn_mask


@functools.lru_cache(maxsize=None)
def rdg_geometry(cfg: DRCTModelConfig) -> Dict[str, tuple]:
    """Per-block channel/head/shift/hidden arithmetic (src/drct.py:337-373),
    computed once per (frozen) config: the forward asks for it at every
    launch. Read only."""
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


def _getter(sd: Mapping[str, torch.Tensor], device, detach: bool):
    def get(name, dt):
        t = torch.as_tensor(sd[name])
        t = t.detach() if detach else t
        return t.to(device=device, dtype=dt).contiguous()
    return get


def _matrix_getter(sd: Mapping[str, torch.Tensor], device, detach: bool):
    """Weight matrices [N, K] (torch Linear) in 16-byte rows (``pitched``),
    which the GEMM kernels load by TMA: one copy that casts, moves and
    pitches, differentiable when ``detach`` is False."""
    def get(name, dt):
        t = torch.as_tensor(sd[name])
        t = (t.detach() if detach else t).reshape(t.shape[0], -1)
        out = pitched(t.shape[0], t.shape[1], dt, device)
        out.copy_(t)
        return out
    return get


def _pack_block(sd: Mapping[str, torch.Tensor], layer: int, k: int, c: int,
                window: int, dtype, device,
                detach: bool = True) -> Dict[str, torch.Tensor]:
    """Block ``k`` (1-based) of RDG ``layer``: matrices in ``dtype`` as torch
    Linear [out, in], vectors and the attention bias in f32. With
    ``detach=False`` the packing is differentiable (the casts and the bias
    gather carry gradients back to ``sd``'s tensors)."""
    adj = f"layers.{layer}.adjust{k}"
    get = _getter(sd, device, detach)
    return {**pack_swin(sd, f"layers.{layer}.swin{k}.", c, window, dtype,
                        device, detach),
            # 1x1 conv [O, I, 1, 1] as a Linear [O, I]
            "wadj": _matrix_getter(sd, device, detach)(f"{adj}.weight", dtype),
            "badj": get(f"{adj}.bias", torch.float32)}


def pack_swin(sd: Mapping[str, torch.Tensor], prefix: str, c: int,
              window: int, dtype, device,
              detach: bool = True) -> Dict[str, torch.Tensor]:
    """The Swin block whose state_dict names start with ``prefix`` (e.g.
    ``layers.0.swin1.``, or ``""`` for a lone block): the block dict of
    :func:`_pack_block` without the adjust conv (what
    ``swin_block_forward`` and ``fused_swin_block`` read). The matrices sit
    in 16-byte rows, which kernels (b) and (g) load by TMA."""
    get = _getter(sd, device, detach)
    mat = _matrix_getter(sd, device, detach)
    qkv_b = f"{prefix}attn.qkv.bias"               # absent with qkv_bias=False
    table = get(f"{prefix}attn.relative_position_bias_table", torch.float32)
    f32 = torch.float32
    return {
        "ln1_w": get(f"{prefix}norm1.weight", f32),
        "ln1_b": get(f"{prefix}norm1.bias", f32),
        "wqkv": mat(f"{prefix}attn.qkv.weight", dtype),
        "bqkv": (get(qkv_b, f32) if qkv_b in sd else
                 torch.zeros(3 * c, dtype=f32, device=device)),
        "attn_bias": relative_position_bias(table, window).contiguous(),
        "wproj": mat(f"{prefix}attn.proj.weight", dtype),
        "bproj": get(f"{prefix}attn.proj.bias", f32),
        "ln2_w": get(f"{prefix}norm2.weight", f32),
        "ln2_b": get(f"{prefix}norm2.bias", f32),
        "w1": mat(f"{prefix}mlp.fc1.weight", dtype),
        "b1": get(f"{prefix}mlp.fc1.bias", f32),
        "w2": mat(f"{prefix}mlp.fc2.weight", dtype),
        "b2": get(f"{prefix}mlp.fc2.bias", f32),
        # the bias as its table [nh, (2W - 1)^2], which kernels (c) and (f)
        # read at 16x16 windows (window_attention.attn_operands); gradients
        # reach the table through attn_bias
        "attn_table": table.detach().t().contiguous(),
    }


@functools.lru_cache(maxsize=None)
def shift_masks(h: int, w: int, window: int, shifts: tuple,
                device: torch.device) -> Dict[int, torch.Tensor]:
    """{shift: [nW, N, N] f32} on ``device``, built once per geometry."""
    return {s: torch.as_tensor(shift_attn_mask(h, w, window, s),
                               device=device) for s in set(shifts) if s}


def prepack_rdg_stack(state_dict: Mapping[str, torch.Tensor],
                      cfg: DRCTModelConfig, h: int, w: int,
                      dtype=torch.bfloat16, device="cuda",
                      detach: bool = True) -> Dict:
    """The port's state_dict -> {'rdgs': [num_layers x [5 block dicts]],
    'masks': {shift: [nW, N, N] f32}}, on ``device`` (the counterpart of
    ``prepack_rdg_stack``, adsr_tpu/ops/fused_rdg.py:394). Serving runs it
    once at registration: the bias gather and the shift masks are built
    here, never per forward. Training packs every step with
    ``detach=False``, so the casts and the gather are differentiable (the
    JAX ``pack_train``, adsr_tpu/ops/fused_rdg_train.py:1048)."""
    win = cfg.window_size
    if min(h, w) <= win or h % win or w % win:
        raise ValueError(f"fused RDG path needs an image larger than, and a "
                         f"multiple of, the window ({h}x{w}, window {win})")
    g = rdg_geometry(cfg)
    rdgs = [[_pack_block(state_dict, i, k + 1, g["feats"][k], win, dtype,
                         device, detach) for k in range(5)]
            for i in range(cfg.num_layers)]
    return {"rdgs": rdgs,
            "masks": shift_masks(h, w, win, g["shifts"], torch.device(device))}


def rdg_workspace(m: int, cfg: DRCTModelConfig, dtype,
                  device) -> Dict[str, torch.Tensor]:
    """Flat scratch buffers for one RDG at ``m`` token rows (reused by all)."""
    g = rdg_geometry(cfg)
    cmax = max(g["feats"])
    sizes = {"ln": row_pitch(cmax),
             "qkv_hid": max(row_pitch(3 * cmax), row_pitch(max(g["hidden"]))),
             "ctx_x2": row_pitch(cmax), "x1": cmax}
    return {k: torch.empty(m * n, dtype=dtype, device=device)
            for k, n in sizes.items()}


def _rows(buf: torch.Tensor, m: int, n: int,
          pitch: Optional[int] = None) -> torch.Tensor:
    """[m, n] rows of the flat ``buf``, ``pitch`` (default n) elements
    apart (one view: a launch's host time is mostly such Python)."""
    return buf.as_strided((m, n), (n if pitch is None else pitch, 1))


def block_buffers(work: Dict[str, torch.Tensor], m: int, c: int,
                  f: int) -> Dict[str, torch.Tensor]:
    """The [m, n] outputs of ``swin_block_forward`` for width ``c`` and
    hidden width ``f``, as views of :func:`rdg_workspace`'s buffers
    (outputs whose lives do not overlap share one). Every row a kernel
    loads in 16-byte pieces has 16-byte rows: the GEMM operands (``ln1``,
    ``ln2``, ``ctx``, ``hid``, ``x2``), which kernel (b) loads by TMA, and
    ``qkv``, which kernel (c) reads whole, as it writes ``ctx``."""
    ln = _rows(work["ln"], m, c, row_pitch(c))
    ctx_x2 = _rows(work["ctx_x2"], m, c, row_pitch(c))
    return {"ln1": ln, "ln2": ln, "ctx": ctx_x2, "x2": ctx_x2,
            "qkv": _rows(work["qkv_hid"], m, 3 * c, row_pitch(3 * c)),
            "hid": _rows(work["qkv_hid"], m, f, row_pitch(f)),
            "x1": _rows(work["x1"], m, c)}


def attention_grad_buffers(m: int, c: int, dtype, device
                           ) -> Dict[str, torch.Tensor]:
    """The training backward's attention gradients for width ``c``: the
    context's ``dctx`` [m, c] and ``dqkv`` [m, 3c], both with 16-byte rows
    (:func:`~adsr_tpu_torch.kernels.rdg_gemm.pitched`): kernel (d) writes
    dctx and kernel (f) reads it in 16-byte pieces, (f) writes dqkv and (d)
    reads it in place by TMA (no dY_eff copy)."""
    return {"dctx": pitched(m, c, dtype=dtype, device=device),
            "dqkv": pitched(m, 3 * c, dtype=dtype, device=device)}


def fused_rdg(cat: torch.Tensor, blocks: List[Dict[str, torch.Tensor]],
              masks: Dict[int, torch.Tensor], cfg: DRCTModelConfig,
              h: int, w: int, work: Dict[str, torch.Tensor],
              dp: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One RDG: reads the tokens from ``cat[:, :d]`` (raster order, B*h*w
    rows) and returns the RDG's output, written over ``cat[:, :d]`` or, when
    given, into ``out`` [B*h*w, d]. ``work`` holds the scratch buffers of
    :func:`rdg_workspace`. ``dp`` [B, 10] f32 are the per-sample
    stochastic-depth multipliers of the (attn, mlp) branches of blocks
    1..5 (training)."""
    g = rdg_geometry(cfg)
    m = cat.shape[0]
    d = cfg.embed_dim
    if cat.shape[1] != g["cat_width"]:
        raise ValueError(f"fused_rdg: concat buffer width {cat.shape[1]}, "
                         f"expected {g['cat_width']}")
    for k, p in enumerate(blocks):
        c, f = g["feats"][k], g["hidden"][k]
        x2 = swin_block_forward(cat[:, :c], p, block_buffers(work, m, c, f),
                                masks, cfg, h, w, k, dp)
        dense_adjust(cat, x2, p, cfg, k, out)
    return cat[:, :d] if out is None else out


def dense_adjust(cat: torch.Tensor, x2: torch.Tensor,
                 p: Dict[str, torch.Tensor], cfg: DRCTModelConfig, k: int,
                 out: Optional[torch.Tensor] = None) -> None:
    """The 1x1 adjust conv after Swin block ``k`` (0-based) on its output
    ``x2``: blocks 1-4 append LeakyReLU(0.2) of it to the concat columns
    ``[c_k, c_k + gc)``; block 5 writes ``0.2 * adjust + cat[:, :d]``, the
    RDG's output, over ``cat[:, :d]`` in place or into ``out``."""
    d = cfg.embed_dim
    if k < 4:
        c = rdg_geometry(cfg)["feats"][k]
        rdg_gemm(x2, p["wadj"], p["badj"], cat[:, c:c + cfg.gc], "leaky_relu")
    else:
        rdg_gemm(x2, p["wadj"], p["badj"], cat[:, :d] if out is None else out,
                 "scaled_residual", residual=cat[:, :d])


def swin_block_forward(x: torch.Tensor, p: Dict[str, torch.Tensor],
                       bufs: Dict[str, torch.Tensor],
                       masks: Dict[int, torch.Tensor], cfg: DRCTModelConfig,
                       h: int, w: int, k: int,
                       dp: Optional[torch.Tensor] = None,
                       hpre: Optional[torch.Tensor] = None,
                       stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Swin block ``k`` (0-based) of an RDG on kernels (a)-(c), from its
    input ``x`` [M, c_k]: LN1, qkv, window attention, proj + residual, LN2,
    fc1 + GELU, fc2 + residual. ``bufs`` holds the [M, n] outputs ``ln1``,
    ``qkv``, ``ctx``, ``x1``, ``ln2``, ``hid`` and ``x2``. With ``hpre``,
    fc1 also writes its pre-activation there, and with ``stats`` the
    attention its softmax statistics (the backward's recompute,
    ``kernels/fused_rdg_train.py``), which must equal the forward's launch
    for launch. Returns ``bufs["x2"]``."""
    g = rdg_geometry(cfg)
    nh, shift = g["heads"][k], g["shifts"][k]
    rdg_layernorm(x, p["ln1_w"], p["ln1_b"], bufs["ln1"])
    rdg_gemm(bufs["ln1"], p["wqkv"], p["bqkv"], bufs["qkv"])
    window_attention(bufs["qkv"], bufs["ctx"],
                     *attn_operands(p, masks, h, w, shift, cfg.window_size),
                     h, w, nh, cfg.window_size, shift, stats)
    residual_add(bufs["ctx"], p["wproj"], p["bproj"], bufs["x1"], x, dp, 2 * k)
    rdg_layernorm(bufs["x1"], p["ln2_w"], p["ln2_b"], bufs["ln2"])
    if hpre is None:
        rdg_gemm(bufs["ln2"], p["w1"], p["b1"], bufs["hid"], "gelu")
    else:
        rdg_gemm(bufs["ln2"], p["w1"], p["b1"], bufs["hid"], "gelu_aux",
                 aux=hpre)
    residual_add(bufs["hid"], p["w2"], p["b2"], bufs["x2"], bufs["x1"], dp,
                 2 * k + 1)
    return bufs["x2"]


def residual_add(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 out: torch.Tensor, residual: torch.Tensor,
                 dp: Optional[torch.Tensor], branch: int) -> torch.Tensor:
    """``out = residual + m * (a @ w.T + b)``: m is the branch's per-sample
    drop-path multiplier ``dp[:, branch]``, or 1 without ``dp``."""
    if dp is None:
        return rdg_gemm(a, w, b, out, "residual", residual=residual)
    return rdg_gemm(a, w, b, out, "drop_residual", residual=residual,
                    row_scale=dp[:, branch])


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

