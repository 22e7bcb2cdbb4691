"""Tensor-parallel rules and the parallel trainer: the port of
``adsr_tpu/parallel/sharding.py:39-106``.

The JAX package hands GSPMD a PartitionSpec a parameter and lets XLA insert
the collectives. The port says the same thing as a :class:`Split` a
parameter of the ``state_dict`` (reference names) and runs Megatron-style
layers (``parallel/tensor.py``):

- ``attn.qkv`` weight and bias: column-parallel **by heads**: the torch
  weight is ``[3C, C]`` with rows ``(q | k | v, head, dim)``, so each tp
  rank holds q, k and v of its own heads (``Split(0, groups=3)``), and its
  columns of ``relative_position_bias_table`` ``[(2W-1)^2, nh]``;
- ``mlp.fc1`` weight and bias: column-parallel (``Split(0)``);
- ``attn.proj`` and ``mlp.fc2`` weights: row-parallel on the input dim
  (``Split(1)``); their biases stay replicated;
- everything else is replicated, and so is a block whose head count, or an
  MLP whose hidden width, does not divide by tp (the JAX ``% tp == 0``
  checks). At embed 180 the heads are 6/4/2/6/4, so tp = 2 splits every
  block of the flagship.

``shard_state_dict`` / ``gather_state_dict`` cut a full ``state_dict`` into
a rank's shard and join the tp group's shards back (``shard_tensor`` /
``join_tensors`` a tensor). Checkpoints stay in the full reference
layout.

``ParallelTrainer`` / ``make_parallel_trainer(exp, mesh=None)`` follow the
JAX class: without a mesh they take the whole world on dp; ``step`` takes
the global batch and runs this rank's rows.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import torch

from adsr_tpu_torch.core.config import Experiment
from adsr_tpu_torch.core.mesh import (Mesh, gather_pieces, make_mesh,
                                      shard_batch)


@dataclass(frozen=True)
class Split:
    """A parameter split over the tp ranks along ``dim``: the dim is read as
    ``groups`` equal runs (q, k, v for the fused qkv) and each run is cut
    into tp equal pieces, piece i of every run going to tp rank i."""
    dim: int
    groups: int = 1


_ATTN = re.compile(r"^(.*\.attn)\.(qkv\.weight|qkv\.bias|proj\.weight|"
                   r"relative_position_bias_table)$")
_MLP = re.compile(r"^(.*\.mlp)\.(fc1\.weight|fc1\.bias|fc2\.weight)$")
_ATTN_SPLITS = {"qkv.weight": Split(0, 3), "qkv.bias": Split(0, 3),
                "proj.weight": Split(1),
                "relative_position_bias_table": Split(1)}
_MLP_SPLITS = {"fc1.weight": Split(0), "fc1.bias": Split(0),
               "fc2.weight": Split(1)}


def _tp_size(mesh_or_tp) -> int:
    return mesh_or_tp if isinstance(mesh_or_tp, int) else mesh_or_tp.tp


def param_shardings(state_dict: Mapping[str, torch.Tensor],
                    mesh_or_tp) -> Dict[str, Optional[Split]]:
    """Every name of a DRCT (or any) ``state_dict`` -> its :class:`Split`,
    or None where it is replicated, at the mesh's tp (or an int tp)."""
    tp = _tp_size(mesh_or_tp)
    out: Dict[str, Optional[Split]] = {}
    for name, t in state_dict.items():
        spec = None
        m = _ATTN.match(name) if tp > 1 else None
        if m:
            heads = state_dict[f"{m.group(1)}.relative_position_bias_table"]
            if heads.shape[1] % tp == 0:
                spec = _ATTN_SPLITS[m.group(2)]
        m = _MLP.match(name) if tp > 1 else None
        if m:
            hidden = state_dict[f"{m.group(1)}.fc1.weight"].shape[0]
            if hidden % tp == 0:
                spec = _MLP_SPLITS[m.group(2)]
        out[name] = spec
    return out


def shard_tensor(t: torch.Tensor, spec: Split, tp: int,
                 index: int) -> torch.Tensor:
    """Piece ``index`` of ``t`` under ``spec`` (a new contiguous tensor)."""
    d, g = spec.dim, spec.groups
    shape = tuple(t.shape)
    run = shape[d] // g
    piece = run // tp
    v = t.reshape(shape[:d] + (g, run) + shape[d + 1:])
    v = v.narrow(d + 1, index * piece, piece)
    return v.reshape(shape[:d] + (g * piece,) + shape[d + 1:]).clone()


def join_tensors(pieces: List[torch.Tensor], spec: Split) -> torch.Tensor:
    """The inverse of :func:`shard_tensor` over every index, in order."""
    d, g = spec.dim, spec.groups
    shape = tuple(pieces[0].shape)
    v = [p.reshape(shape[:d] + (g, shape[d] // g) + shape[d + 1:])
         for p in pieces]
    whole = torch.cat(v, dim=d + 1)
    return whole.reshape(shape[:d] + (shape[d] * len(pieces),)
                         + shape[d + 1:])


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], mesh: Mesh,
                     specs: Optional[Mapping[str, Optional[Split]]] = None
                     ) -> Dict[str, torch.Tensor]:
    """This rank's shard of a full ``state_dict`` (no collective)."""
    specs = specs if specs is not None else param_shardings(state_dict, mesh)
    return {k: (v if specs.get(k) is None
                else shard_tensor(v, specs[k], mesh.tp, mesh.tp_index))
            for k, v in state_dict.items()}


def gather_state_dict(shard: Mapping[str, torch.Tensor], mesh: Mesh,
                      specs: Mapping[str, Optional[Split]]
                      ) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` from every tp rank's ``shard`` (collective
    over the tp group: every rank calls it and every rank gets it).
    ``specs`` are the full ``state_dict``'s (:func:`param_shardings`)."""
    out = {}
    for k, v in shard.items():
        if specs.get(k) is None:
            out[k] = v
            continue
        pieces = gather_pieces(v.detach(), mesh.tp_group, mesh.tp_index,
                               mesh.tp, mesh.backend)
        out[k] = join_tensors(list(pieces), specs[k])
    return out


def _optimizer_tensors(opt_state: Mapping, names: List[str],
                       specs: Mapping[str, Optional[Split]], convert
                       ) -> Dict:
    """``opt_state`` (``Optimizer.state_dict()``, whose params are indexed
    in the order of ``names``) with ``convert(tensor, spec)`` applied to
    every per-parameter tensor of a split parameter (Adam's moments)."""
    state = {}
    for idx, entry in opt_state["state"].items():
        spec = specs.get(names[idx])
        state[idx] = {k: (convert(v, spec) if spec is not None
                          and torch.is_tensor(v) and v.dim() > 0 else v)
                      for k, v in entry.items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def shard_optimizer_state(opt_state: Mapping, names: List[str],
                          specs: Mapping[str, Optional[Split]],
                          mesh: Mesh) -> Dict:
    """This rank's shard of a full-layout optimizer ``state_dict``."""
    return _optimizer_tensors(
        opt_state, names, specs,
        lambda v, spec: shard_tensor(v, spec, mesh.tp, mesh.tp_index))


def gather_optimizer_state(opt_state: Mapping, names: List[str],
                           specs: Mapping[str, Optional[Split]],
                           mesh: Mesh) -> Dict:
    """The full-layout optimizer ``state_dict`` from every tp rank's
    (collective over the tp group)."""
    def gather(v, spec):
        pieces = gather_pieces(v, mesh.tp_group, mesh.tp_index, mesh.tp,
                               mesh.backend)
        return join_tensors(list(pieces), spec)
    return _optimizer_tensors(opt_state, names, specs, gather)


class ParallelTrainer:
    """The train step over a mesh, as the JAX class (adsr_tpu/parallel/
    sharding.py:83-101): every rank builds the same initial state from
    ``exp.seed`` (its tp shard of it), ``step`` takes the global batch and
    runs this rank's rows."""

    def __init__(self, exp: Experiment, mesh: Optional[Mesh] = None,
                 generator: Optional[torch.Generator] = None):
        # train.trainer imports parallel.tensor, which imports this module
        from adsr_tpu_torch.train.trainer import make_train_step, stream_seed
        self.exp = exp
        self.mesh = mesh if mesh is not None else make_mesh(exp.mesh)
        self.bundle = make_train_step(exp, self.mesh.device, mesh=self.mesh)
        generator = generator or torch.Generator().manual_seed(
            stream_seed(exp.seed, "init"))
        self.state = self.bundle.init_state(generator)

    def shard_batch(self, lrs, hr):
        return shard_batch(self.mesh, list(lrs)), shard_batch(self.mesh, hr)

    def step(self, lrs, hr, lr_rate: float, generator: torch.Generator,
             error_last: float = 1e8) -> Dict[str, torch.Tensor]:
        lrs, hr = self.shard_batch(lrs, hr)
        self.state, metrics = self.bundle.step(self.state, lrs, hr, lr_rate,
                                               generator, error_last)
        return metrics


def make_parallel_trainer(exp: Experiment,
                          mesh: Optional[Mesh] = None) -> ParallelTrainer:
    return ParallelTrainer(exp, mesh)
