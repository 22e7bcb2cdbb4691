"""The device mesh: the port of ``adsr_tpu/core/mesh.py:31-73``.

The JAX package lays its devices out as a ``(dcn,) dp, tp`` mesh inside one
controller. The port runs one process a rank (``parallel/launch.py``
starts them, or ``torchrun``) and gives every rank the same layout:

- ``mesh_layout(cfg, world_size)`` is the layout alone, ``{"dcn", "dp",
  "tp"}``, with the JAX rules: ``dp = -1`` absorbs what is left, sizes that
  do not cover the world raise, and tp is innermost, so rank =
  ``(dcn_i * dp + dp_i) * tp + tp_i`` (the order ``reshape(dcn, dp, tp)``
  gives the JAX device list);
- ``make_mesh(cfg, devices, backend)`` builds a :class:`Mesh` on the
  initialised default process group: this rank's coordinates and device, a
  data group (the ranks with this rank's tp index, over which the batch is
  split and the gradients averaged) and a tp group (the ranks with this
  rank's data index, which split DRCT's attention heads and MLP width);
- ``data_axes``, ``n_data``, ``shard_batch`` (this rank's rows of a global
  batch) and ``gather_rows`` (the global batch back from every data rank's
  rows, in rank order) are the counterparts of the JAX helpers;
  ``ShardedCall`` serves a forward batch-parallel with them.

Collectives go through NCCL when the rank's device is CUDA and gloo on the
CPU. gloo moves CUDA tensors only by ``all_reduce`` and ``broadcast``, so on
gloo a gather is an ``all_reduce`` into a zeroed buffer (every row has one
writer, and ``x + 0`` is ``x``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from adsr_tpu_torch.core.config import MeshConfig


def mesh_layout(cfg: MeshConfig, world_size: int) -> Dict[str, int]:
    """The ``{"dcn", "dp", "tp"}`` sizes of ``cfg`` over ``world_size``
    ranks (the JAX ``make_mesh`` rules, adsr_tpu/core/mesh.py:41-52)."""
    dcn = max(1, cfg.dcn)
    tp = max(1, cfg.tp)
    dp = cfg.dp if cfg.dp > 0 else world_size // (tp * dcn)
    if dcn * dp * tp != world_size:
        raise ValueError(
            f"mesh {'%dx' % dcn if dcn > 1 else ''}{dp}x{tp} does not cover "
            f"{world_size} devices")
    return {"dcn": dcn, "dp": dp, "tp": tp}


def rank_coords(layout: Dict[str, int], rank: int) -> Dict[str, int]:
    """The (dcn, dp, tp) coordinates of ``rank``: tp innermost."""
    data, tp_i = divmod(rank, layout["tp"])
    dcn_i, dp_i = divmod(data, layout["dp"])
    return {"dcn": dcn_i, "dp": dp_i, "tp": tp_i}


def explicit_mesh(cfg: MeshConfig) -> bool:
    """Explicit sizes > 1 build a mesh; the dp = -1 default stays
    single-stream (adsr_tpu/train/trainer.py:525-538)."""
    return cfg.tp > 1 or cfg.dcn > 1 or cfg.dp > 1


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclass
class Mesh:
    """One rank's view of the mesh. ``data_group`` / ``tp_group`` are None
    where the group is this rank alone."""
    layout: Dict[str, int]
    rank: int
    device: torch.device
    backend: str
    data_group: Optional[dist.ProcessGroup] = None
    tp_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        """The axes' sizes, as ``jax.sharding.Mesh.shape`` (no ``dcn`` key
        at dcn = 1)."""
        return {a: n for a, n in self.layout.items()
                if a != "dcn" or n > 1}

    @property
    def coords(self) -> Dict[str, int]:
        return rank_coords(self.layout, self.rank)

    @property
    def world_size(self) -> int:
        return self.layout["dcn"] * self.layout["dp"] * self.layout["tp"]

    @property
    def n_data(self) -> int:
        return self.layout["dcn"] * self.layout["dp"]

    @property
    def data_index(self) -> int:
        """This rank's place among the data ranks (its batch slice)."""
        return self.rank // self.layout["tp"]

    @property
    def tp(self) -> int:
        return self.layout["tp"]

    @property
    def tp_index(self) -> int:
        return self.rank % self.layout["tp"]

    def barrier(self) -> None:
        if self.world_size > 1:
            dist.barrier()

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any."""
        if self.world_size == 1:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t)
        return bool(t.item() > 0)


def _new_groups(layout: Dict[str, int], rank: int, backend: str):
    """Every data group and every tp group, made in the same order on every
    rank (``new_group`` is collective); returns this rank's two, None for a
    group of one."""
    tp, n_data = layout["tp"], layout["dcn"] * layout["dp"]
    data_groups = [[d * tp + t for d in range(n_data)] for t in range(tp)]
    tp_groups = [[d * tp + t for t in range(tp)] for d in range(n_data)]
    mine = {}
    for kind, groups in (("data", data_groups), ("tp", tp_groups)):
        for ranks in groups:
            if len(ranks) == 1:
                continue
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                mine[kind] = group
    return mine.get("data"), mine.get("tp")


def make_mesh(cfg: MeshConfig = MeshConfig(),
              devices: Optional[Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """This rank's :class:`Mesh` over the initialised default process group.

    ``devices[rank]`` is the rank's device; by default ``cuda:<local rank>``
    (``LOCAL_RANK`` under ``torchrun``, else the rank), and a world larger
    than ``torch.cuda.device_count()`` raises, as the JAX coverage check
    does. ``backend`` defaults to the default group's."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (parallel/launch.py run_ranks, or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    layout = mesh_layout(cfg, world)
    if devices is None:
        if world > torch.cuda.device_count():
            raise ValueError(
                f"a world of {world} ranks on {torch.cuda.device_count()} "
                "CUDA device(s): pass devices=[...] to share a device")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    else:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = torch.device(devices[rank])
    backend = backend or dist.get_backend()
    data_group, tp_group = _new_groups(layout, rank, backend)
    return Mesh(layout, rank, device, backend, data_group, tp_group)


def data_axes(mesh: Mesh) -> tuple:
    """The mesh axes the batch dimension is split over."""
    return tuple(a for a in ("dcn", "dp") if a in mesh.shape)


def n_data(mesh: Optional[Mesh]) -> int:
    """The product of the data axes (1 without a mesh)."""
    return 1 if mesh is None else mesh.n_data


def shard_rows(mesh: Mesh, x, dim: int = 0):
    """This data rank's equal slice of ``x`` along ``dim`` (a tensor or a
    numpy array); raises ``ValueError`` when the size does not divide by
    the data ranks."""
    n = x.shape[dim]
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} does not divide by the mesh's "
                         f"{mesh.n_data} data ranks")
    b = n // mesh.n_data
    i = mesh.data_index
    if isinstance(x, np.ndarray):
        return np.take(x, np.arange(i * b, (i + 1) * b), axis=dim)
    return x.narrow(dim, i * b, b)


def shard_batch(mesh: Mesh, x):
    """This rank's rows of a global batch: a tensor or array, or a list of
    them (an LR pyramid)."""
    if isinstance(x, (list, tuple)):
        return [shard_rows(mesh, t) for t in x]
    return shard_rows(mesh, x)


def gather_pieces(local: torch.Tensor, group: Optional[dist.ProcessGroup],
                  index: int, size: int, backend: str) -> torch.Tensor:
    """``[size, *local.shape]``: every member's ``local`` of ``group`` by
    its index. NCCL gathers; gloo sums into zeros (see the module
    docstring)."""
    if size == 1:
        return local.unsqueeze(0)
    local = local.contiguous()
    if backend == "nccl":
        out = local.new_empty((size,) + tuple(local.shape))
        dist.all_gather_into_tensor(out, local, group=group)
        return out
    out = local.new_zeros((size,) + tuple(local.shape))
    out[index] = local
    dist.all_reduce(out, group=group)
    return out


def gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The global batch from every data rank's rows, in rank order (the
    inverse of :func:`shard_rows` along dim 0)."""
    out = gather_pieces(local, mesh.data_group, mesh.data_index, mesh.n_data,
                        mesh.backend)
    return out.reshape((-1,) + tuple(local.shape[1:]))


def mean_over_data(mesh: Mesh, tensors: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """``tensors`` averaged over the data ranks: one flat bucket, one
    ``all_reduce``, a division by ``n_data``; returns views of the bucket
    in the tensors' order (``tensors`` themselves with one data rank)."""
    if mesh.n_data == 1:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.n_data)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class ShardedCall:
    """A batch-parallel forward: each data rank runs its rows of the
    caller's batch through ``fn`` and the results are gathered in rank
    order, so every rank returns the whole batch. The tp ranks of one data
    index compute the same rows. The batch must divide by ``n_data``."""

    def __init__(self, fn: Callable, mesh: Mesh):
        self.fn = fn
        self.mesh = mesh

    def __call__(self, x) -> torch.Tensor:
        return gather_rows(self.mesh, self.fn(shard_rows(self.mesh, x)))
