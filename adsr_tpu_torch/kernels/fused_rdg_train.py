"""Training forward and backward of one RDG, and of the whole DRCT, on the
hand-written kernels (TPU kernels 2 and 3).

The port of ``adsr_tpu/ops/fused_rdg_train.py``: ``_rdg_train_fwd_call``
``:823`` (``_fwd_kernel`` ``:266``) and ``_rdg_train_bwd`` ``:968``
(``_bwd_kernel`` ``:405``) and ``fused_drct_train_forward`` ``:1127``; the
JAX ``pack_train`` ``:1048`` is ``prepack_rdg_stack(..., detach=False)``
(``kernels/fused_rdg.py``). The kernels run in the compute dtype, as the
TPU kernels do (``fused_rdg_train.py:1146``): bf16, or f32 for fp32
training, where every launch of (a)-(f) is an f32 instance (each wrapper's
``launches_f32``) and every buffer below is f32. Each RDG is one
``torch.autograd.Function``:

- forward: the serving RDG's launches (kernels (a)-(c), ``fused_rdg``) with
  the per-sample stochastic-depth multipliers on the attention and MLP
  branches (``rdg_gemm``'s ``drop_residual`` epilogue). It saves only the
  final concat buffer ``cat`` [B*L, d + 4*gc] (the residual trick,
  fused_rdg_train.py:31-36): block k reads ``cat[:, :c_k]`` and adjust k
  appends columns ``[c_k, c_k + gc)``, so the final buffer holds every
  block's exact input. The RDG's output goes to its own buffer, never over
  ``cat[:, :d]``, which block 1's backward reads.
- backward: blocks 5 -> 1, each recomputing its LayerNorms, qkv, attention
  context, GELU pre-activation and output from ``cat`` with kernels (a)-(c)
  (at 16x16 windows (c) also writes its softmax statistics), then the
  gradients with kernels (d) ``rdg_gemm_bwd`` (``rdg_gemm_grads``: dgrad
  and wgrad of one dY behind one dY_eff pre-pass), (e)
  ``rdg_layernorm_bwd`` and (f) ``window_attention_bwd`` (at 16x16 windows
  from the recomputed context and those statistics). ``dcat`` (f32)
  collects each block's input gradient in ``dcat[:, :c_k]``; the columns
  of adjust k are complete when block k is reached, and adjust 1-4's
  LeakyReLU derivative is read from the sign of the saved ``cat`` columns.

Packing stays outside the Function, in differentiable torch: the casts of
the f32 master weights to the compute dtype and the relative-position-bias
gather, so autograd
carries the gradients to the raw parameters, the bias tables included (the
JAX custom-VJP boundary at the packed operands, :44-48, 1048-1080). The
softmax is always the stabilised one: the JAX exp2 fast path and its guard
are not ported. On CPU tensors every kernel wrapper runs its plain PyTorch
version, so the same orchestration runs in f32 on the CPU.

``rdg_train_plain`` (the eager ``RDG`` with ``dp`` under autograd) is the
plain version of one RDG; the eager ``DRCT`` with ``dp`` that of the whole
forward.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch
import torch.nn.functional as F

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.kernels.fused_rdg import (attention_grad_buffers,
                                              fused_rdg, prepack_rdg_stack,
                                              rdg_geometry, rdg_workspace,
                                              swin_block_forward)
from adsr_tpu_torch.kernels.rdg_gemm import pitched
from adsr_tpu_torch.kernels.rdg_gemm_bwd import rdg_gemm_grads
from adsr_tpu_torch.kernels.rdg_layernorm_bwd import rdg_layernorm_bwd
from adsr_tpu_torch.kernels.window_attention import (attn_operands,
                                                     softmax_stats)
from adsr_tpu_torch.kernels.window_attention_bwd import window_attention_bwd
from adsr_tpu_torch.models.common import RGB_MEAN
from adsr_tpu_torch.models.drct import RDG, LN_EPS

# the packed operands of one Swin block + adjust conv, in the Function's order
# (the bias table ``attn_table`` takes no gradient of its own, attn_bias's
# carries it: it rides in the Function's non-tensor spec)
BLOCK_KEYS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "attn_bias", "wproj", "bproj",
              "ln2_w", "ln2_b", "w1", "b1", "w2", "b2", "wadj", "badj")


def fused_rdg_train_bwd(cat: torch.Tensor, g: torch.Tensor,
                        blocks: Sequence[Dict[str, torch.Tensor]],
                        masks: Dict[int, torch.Tensor], cfg: DRCTModelConfig,
                        h: int, w: int, dp: torch.Tensor):
    """Backward of one RDG from its saved concat buffer ``cat`` [M, d+4gc]
    and the output's gradient ``g`` [M, d]. Returns (dx [M, d] f32,
    [5 x {operand: f32 gradient}])."""
    geo = rdg_geometry(cfg)
    m, d, gc = cat.shape[0], cfg.embed_dim, cfg.gc
    act, dev, f32 = cat.dtype, cat.device, torch.float32
    dcat = torch.zeros(m, geo["cat_width"], dtype=f32, device=dev)
    dcat[:, :d] = g          # out = 0.2 * adj5 + x_in: x_in receives g
    grads: List[Dict[str, torch.Tensor]] = []       # blocks 5 -> 1
    for k in reversed(range(5)):
        p = blocks[k]
        c, nh, shift = geo["feats"][k], geo["heads"][k], geo["shifts"][k]
        f = geo["hidden"][k]
        m_attn, m_mlp = dp[:, 2 * k], dp[:, 2 * k + 1]
        gr = {key: torch.empty(p[key].shape, dtype=f32, device=dev)
              for key in BLOCK_KEYS}
        grads.append(gr)
        # recompute the block from its input cat[:, :c], every output kept
        x = cat[:, :c]
        # 16-byte rows for every buffer a kernel loads in 16-byte pieces:
        # the GEMM operands (TMA) and qkv, which kernel (c) reads whole and
        # kernel (f) reads at its row stride
        bufs = {name: (torch.empty if name == "x1"
                       else pitched)(m, n, dtype=act, device=dev)
                for name, n in (("ln1", c), ("qkv", 3 * c), ("ctx", c),
                                ("x1", c), ("ln2", c), ("hid", f), ("x2", c))}
        hpre = torch.empty(m, f, dtype=act, device=dev)
        # at 16x16 windows the attention also writes its softmax
        # statistics, which kernel (f) reads beside the context
        stats = softmax_stats(bufs["qkv"], h, w, nh, cfg.window_size)
        swin_block_forward(x, p, bufs, masks, cfg, h, w, k, dp, hpre=hpre,
                           stats=stats)
        ln1, qkv, ctx, x1, ln2, hid, x2 = bufs.values()
        # adjust: k < 4 LeakyReLU into cat[:, c:c+gc]; k == 4 the 0.2 residual
        adj = (dict(dy=dcat[:, c:c + gc], slope_src=cat[:, c:c + gc])
               if k < 4 else dict(dy=g, alpha=0.2))
        res = torch.empty(m, c, dtype=f32, device=dev)   # residual stream
        rdg_gemm_grads(w=p["wadj"], a=x2, out=res, dw=gr["wadj"],
                       db=gr["badj"], **adj)
        # MLP branch: x2 = x1 + m_mlp * fc2(gelu(fc1(ln2(x1))))
        dh = pitched(m, f, dtype=act, device=dev)
        rdg_gemm_grads(res, p["w2"], hid, dh, gr["w2"], gr["b2"],
                       row_scale=m_mlp, gelu_pre=hpre)
        dln = torch.empty(m, c, dtype=f32, device=dev)
        rdg_gemm_grads(dh, p["w1"], ln2, dln, gr["w1"], gr["b1"])
        rdg_layernorm_bwd(x1, dln, p["ln2_w"], res, gr["ln2_w"], gr["ln2_b"])
        # attention branch: x1 = x + m_attn * proj(attn(qkv(ln1(x))))
        dctx, dqkv = attention_grad_buffers(m, c, act, dev).values()
        rdg_gemm_grads(res, p["wproj"], ctx, dctx, gr["wproj"], gr["bproj"],
                       row_scale=m_attn)
        window_attention_bwd(qkv, dctx,
                             *attn_operands(p, masks, h, w, shift,
                                            cfg.window_size),
                             h, w, nh, cfg.window_size, shift, dqkv,
                             gr["attn_bias"],
                             *((ctx, stats) if stats is not None else ()))
        rdg_gemm_grads(dqkv, p["wqkv"], ln1, dln, gr["wqkv"], gr["bqkv"])
        rdg_layernorm_bwd(x, dln, p["ln1_w"], dcat[:, :c], gr["ln1_w"],
                          gr["ln1_b"], residual=res)
    return dcat[:, :d], grads[::-1]


class _RDGTrain(torch.autograd.Function):
    """One RDG: forward on kernels (a)-(c), backward on (a)-(f)."""

    @staticmethod
    def forward(ctx, x, dp, spec, *operands):
        cfg, h, w, masks, tables = spec
        blocks = _unflatten(operands, tables)
        m, d = x.shape
        cat = torch.empty(m, rdg_geometry(cfg)["cat_width"], dtype=x.dtype,
                          device=x.device)
        cat[:, :d] = x
        out = torch.empty_like(x)
        fused_rdg(cat, blocks, masks, cfg, h, w,
                  rdg_workspace(m, cfg, x.dtype, x.device), dp=dp, out=out)
        ctx.save_for_backward(cat, dp, *operands)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, g):
        cat, dp, *operands = ctx.saved_tensors
        cfg, h, w, masks, tables = ctx.spec
        dx, grads = fused_rdg_train_bwd(cat, g.contiguous(),
                                        _unflatten(operands, tables), masks,
                                        cfg, h, w, dp)
        flat = [gr[key] for gr in grads for key in BLOCK_KEYS]
        return (dx.to(cat.dtype), None, None,
                *(gv.to(op.dtype) for gv, op in zip(flat, operands)))


def _unflatten(operands, tables) -> List[Dict[str, torch.Tensor]]:
    n = len(BLOCK_KEYS)
    return [dict(zip(BLOCK_KEYS, operands[i:i + n]), attn_table=t)
            for i, t in zip(range(0, len(operands), n), tables)]


def fused_rdg_train(x: torch.Tensor, blocks: Sequence[Dict[str, torch.Tensor]],
                    masks: Dict[int, torch.Tensor], cfg: DRCTModelConfig,
                    h: int, w: int, dp: torch.Tensor) -> torch.Tensor:
    """One RDG's training forward, differentiable: tokens ``x`` [B*h*w, d]
    (raster order), ``blocks`` one RDG of ``prepack_rdg_stack(...,
    detach=False)``, ``dp`` [B, 10] f32 drop-path multipliers. Returns the
    RDG's output [B*h*w, d]."""
    flat = [blk[key] for blk in blocks for key in BLOCK_KEYS]
    tables = [blk["attn_table"] for blk in blocks]
    return _RDGTrain.apply(x, dp.to(device=x.device, dtype=torch.float32)
                           .contiguous(), (cfg, h, w, masks, tables), *flat)


def rdg_train_plain(layer: RDG, x: torch.Tensor, h: int, w: int,
                    dp: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`fused_rdg_train`: the eager ``RDG`` with
    ``dp`` [B, 10], under autograd, on tokens [B*h*w, d]."""
    b = dp.shape[0]
    return layer(x.reshape(b, h * w, -1), (h, w), dp).reshape(x.shape)


def rdg_train_flops(cfg: DRCTModelConfig, m: int) -> int:
    """Multiply-add flops (x2) of one RDG's training forward and backward at
    ``m`` token rows, from the shapes: every matmul runs in the forward, the
    backward's recompute (but adjust), dgrad and wgrad; attention makes two
    64-token products in the forward, two in the recompute and four in the
    backward (dP, dV, dQ, dK)."""
    g = rdg_geometry(cfg)
    n = cfg.window_size ** 2
    total = 0
    for c, f, a in zip(g["feats"], g["hidden"], g["adj_out"]):
        mm = 2 * m * c * (3 * c + c + f) + 2 * m * f * c
        adj = 2 * m * c * a
        total += 4 * mm + 3 * adj + 4 * (2 * 2 * m * n * c)
    return total


def fused_drct_train_forward(params: Mapping[str, torch.Tensor],
                             cfg: DRCTModelConfig, x: torch.Tensor,
                             dp: torch.Tensor,
                             dtype=torch.bfloat16) -> torch.Tensor:
    """Training forward of the whole DRCT, differentiable with respect to
    ``params`` (the model's parameters by ``state_dict`` name): LR [B, h, w,
    C] -> SR [B, h*s, w*s, C] float32. The head convs and the patch
    LayerNorm, then the ``num_layers`` RDG Functions with ``dp``
    [num_layers, B, 10] (:func:`~adsr_tpu_torch.models.drct.drop_path_mults`),
    then the final LayerNorm, the tail convs and the pixel shuffle. Convs
    run in ``dtype``, LayerNorm statistics in f32."""
    dev = x.device
    d = cfg.embed_dim
    mean = torch.tensor(RGB_MEAN if cfg.in_chans == 3
                        else (0.0,) * cfg.in_chans, device=dev)
    x = ((x.float() - mean) * cfg.img_range).to(dtype)
    b, h, w, _ = x.shape
    m = b * h * w

    def conv(t, name):
        wt = params[f"{name}.weight"]
        return F.conv2d(t, wt.to(dtype), params[f"{name}.bias"].to(dtype),
                        padding=wt.shape[-1] // 2)

    def layer_norm(t, name):
        return F.layer_norm(t.float(), (d,), params[f"{name}.weight"],
                            params[f"{name}.bias"], eps=LN_EPS).to(dtype)

    feat = conv(x.permute(0, 3, 1, 2), "conv_first")              # NCHW
    t = layer_norm(feat.permute(0, 2, 3, 1).reshape(m, d), "patch_embed.norm")
    packed = prepack_rdg_stack(params, cfg, h, w, dtype, dev, detach=False)
    for blocks, dpl in zip(packed["rdgs"], dp):
        t = fused_rdg_train(t, blocks, packed["masks"], cfg, h, w, dpl)
    t = layer_norm(t, "norm")
    deep = t.reshape(b, h, w, d).permute(0, 3, 1, 2)
    y = conv(deep, "conv_after_body") + feat
    y = F.leaky_relu(conv(y, "conv_before_upsample.0"), 0.01)
    for i in range(cfg.upscale.bit_length() - 1):
        y = F.pixel_shuffle(conv(y, f"upsample.{2 * i}"), 2)
    y = conv(y, "conv_last")
    return y.permute(0, 2, 3, 1).float() / cfg.img_range + mean
