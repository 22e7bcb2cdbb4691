"""Megatron-style tensor-parallel layers for the eager DRCT.

With tp > 1 the JAX package leaves the fused Pallas step for the XLA model,
which GSPMD partitions by the rules of ``parallel/sharding.py``
(adsr_tpu/train/trainer.py:188-196). The port does the same with the eager
model: :func:`shard_model_` swaps every Swin block's attention and MLP whose
rule splits them for a layer that holds its tp shard, and two autograd
Functions place the collectives over the tp group:

- :class:`CopyToTP` at a column-parallel input: identity forward,
  ``all_reduce`` of the input gradient backward (each rank's heads or
  columns see only part of it);
- :class:`ReduceFromTP` at a row-parallel output: ``all_reduce`` forward,
  identity backward; the replicated bias is added after the reduce.

A sharded parameter's gradient is then its own piece, and a replicated
one's is the same on every tp rank, so the train step averages both over
the data group alone; Adam runs on the local shards, which is elementwise
the same update. Parameter names stay the reference's, holding shards.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from adsr_tpu_torch.core.mesh import Mesh
from adsr_tpu_torch.models.drct import (WindowAttention,
                                        relative_position_bias,
                                        window_attention_eager)
from adsr_tpu_torch.parallel.sharding import Split, shard_tensor


class CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class ReduceFromTP(torch.autograd.Function):
    """The partial outputs summed over the tp group forward; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _piece(p: torch.Tensor, spec: Split, mesh: Mesh) -> nn.Parameter:
    return nn.Parameter(shard_tensor(p.detach(), spec, mesh.tp,
                                     mesh.tp_index))


class ColumnParallelLinear(nn.Module):
    """``linear`` with its output features split (``spec``), its input
    behind :class:`CopyToTP`."""

    def __init__(self, full: nn.Linear, spec: Split, mesh: Mesh):
        super().__init__()
        self.group = mesh.tp_group
        self.weight = _piece(full.weight, spec, mesh)
        self.bias = None if full.bias is None \
            else _piece(full.bias, spec, mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(CopyToTP.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """``linear`` with its input features split, the partial products
    summed by :class:`ReduceFromTP`, then the replicated bias."""

    def __init__(self, full: nn.Linear, mesh: Mesh):
        super().__init__()
        self.group = mesh.tp_group
        self.weight = _piece(full.weight, Split(1), mesh)
        self.bias = nn.Parameter(full.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ReduceFromTP.apply(F.linear(x, self.weight), self.group) \
            + self.bias


class ParallelWindowAttention(nn.Module):
    """W-MSA over this rank's heads: q, k, v of its heads, its columns of
    the bias table, its input columns of ``proj`` (the eager
    ``WindowAttention``'s forward, head-local)."""

    def __init__(self, full: WindowAttention, mesh: Mesh):
        super().__init__()
        self.window_size = full.window_size
        self.heads = full.num_heads // mesh.tp
        self.head_dim = full.dim // full.num_heads
        # the full module's parameter order: the table, qkv, proj
        self.relative_position_bias_table = _piece(
            full.relative_position_bias_table, Split(1), mesh)
        self.qkv = ColumnParallelLinear(full.qkv, Split(0, 3), mesh)
        self.proj = RowParallelLinear(full.proj, mesh)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        nh, hd = self.heads, self.head_dim
        qkv = self.qkv(x).reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        bias = relative_position_bias(self.relative_position_bias_table,
                                      self.window_size)
        out = window_attention_eager(q * hd ** -0.5, k, v, bias, mask)
        return self.proj(out.transpose(1, 2).reshape(b, n, nh * hd))


class ParallelMlp(nn.Module):
    """fc1 column-parallel, exact GELU, fc2 row-parallel."""

    def __init__(self, full: nn.Module, mesh: Mesh):
        super().__init__()
        self.fc1 = ColumnParallelLinear(full.fc1, Split(0), mesh)
        self.fc2 = RowParallelLinear(full.fc2, mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def shard_model_(model: nn.Module, mesh: Mesh,
                 specs: Mapping[str, Optional[Split]]) -> nn.Module:
    """Swap, in place, each ``attn`` / ``mlp`` whose parameters ``specs``
    split (``param_shardings`` of the full model's ``state_dict``) for its
    tp layer, holding this rank's shard of the current weights."""
    for name, module in list(model.named_modules()):
        for child, make in (("attn", ParallelWindowAttention),
                            ("mlp", ParallelMlp)):
            prefix = f"{name}.{child}" if name else child
            key = f"{prefix}.{'qkv' if child == 'attn' else 'fc1'}.weight"
            if specs.get(key) is not None:
                setattr(module, child, make(getattr(module, child), mesh))
    return model
