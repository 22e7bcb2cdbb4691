"""Rank bodies of the port's multi-process tests. ``parallel/launch.py``
``run_ranks`` spawns each rank on the CPU over gloo and imports this module
there by name, so it imports nothing of JAX: the tests compute the JAX side
in their own process and hand the ranks numpy arrays and state_dicts."""

from __future__ import annotations

import dataclasses
import time

import torch

from adsr_tpu_torch.core.config import MeshConfig
from adsr_tpu_torch.core.mesh import make_mesh
from adsr_tpu_torch.data.pipeline import SRDataset
from adsr_tpu_torch.eval.evaluate import _forward_split
from adsr_tpu_torch.io.journal import Journal
from adsr_tpu_torch.parallel.sharding import (ParallelTrainer,
                                              gather_state_dict,
                                              shard_state_dict)
from adsr_tpu_torch.train.trainer import Trainer, make_serving_forward

LR_RATE = 1e-3


def cpu_mesh(cfg: MeshConfig, world: int):
    return make_mesh(cfg, devices=["cpu"] * world)


def _full(tensors, trainer):
    """A ``{name: tensor}`` of the rank's model layout, in the full one."""
    specs = trainer.state.specs
    if specs is None:
        return {k: v.detach().clone() for k, v in tensors.items()}
    return gather_state_dict(tensors, trainer.mesh, specs)


def step_rank(rank: int, world: int, meshes, exp, primal, duals, lrs, hr):
    """One ``ParallelTrainer`` step from ``primal`` (and DRN's ``duals``)
    on the global batch, on each mesh of ``meshes`` in turn. Returns, per
    mesh: the metrics, the full-layout parameters after the step and the
    averaged gradients, and whether ``gather_state_dict(shard_state_dict(
    sd))`` gave ``sd`` back bitwise."""
    torch.set_num_threads(1)
    out = []
    for cfg in meshes:
        mesh = cpu_mesh(cfg, world)
        tr = ParallelTrainer(dataclasses.replace(exp, mesh=cfg), mesh)
        specs = tr.state.specs
        sd = {k: torch.as_tensor(v) for k, v in primal.items()}
        shard = shard_state_dict(sd, mesh, specs) if specs else sd
        back = gather_state_dict(shard, mesh, specs) if specs else shard
        roundtrip = all(torch.equal(back[k], sd[k]) for k in sd)
        tr.state.model.load_state_dict(shard)
        if duals is not None:
            for d, dsd in zip(tr.state.duals, duals):
                d.load_state_dict(dsd)
        m = tr.step([torch.from_numpy(x) for x in lrs], torch.from_numpy(hr),
                    LR_RATE, torch.Generator().manual_seed(1))
        model = tr.state.model
        rec = {"metrics": {k: float(v) for k, v in m.items()},
               "params": _full(model.state_dict(), tr),
               "grads": _full({n: p.grad for n, p in
                               model.named_parameters()}, tr),
               "roundtrip": roundtrip, "specs": specs,
               "coords": mesh.coords}
        if duals is not None:
            rec["duals"] = [d.state_dict() for d in tr.state.duals]
        out.append(rec)
    return out


def serve_rank(rank: int, world: int, exp, params, lr, hr, batch):
    """The batch-sharded ``_forward_split`` and ``make_serving_forward``
    against their unsharded runs in the same process."""
    torch.set_num_threads(1)
    mesh = cpu_mesh(MeshConfig(dp=world), world)
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    fwd = make_serving_forward(exp, params, device="cpu", quantize_out=False)
    sharded = _forward_split(fwd, exp, lr, hr, batch, mesh)
    single = _forward_split(fwd, exp, lr, hr, batch)
    served = make_serving_forward(exp, params, mesh=mesh)(lr[:batch])
    alone = make_serving_forward(exp, params, device="cpu")(lr[:batch])
    return {"sharded": sharded, "single": single, "served": served.numpy(),
            "alone": alone.numpy()}


def _dataset(arrays):
    hr, lrs, scales = arrays
    return SRDataset(hr=hr, lrs=lrs, scales_desc=scales,
                     filenames=[f"{i:03d}" for i in range(hr.shape[0])])


def _opt_equal(a, b) -> bool:
    """Two Adams' state bitwise equal (moments and counts, in order)."""
    sa, sb = a.state_dict()["state"], b.state_dict()["state"]
    return sa.keys() == sb.keys() and all(
        sa[i].keys() == sb[i].keys() and all(
            torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))
            for k in sa[i]) for i in sa)


def trainer_rank(rank: int, world: int, exp, train, test):
    """A ``Trainer`` on ``cpu_mesh(exp.mesh)`` (none at world 1): one
    epoch, ``test`` (rank 0 alone has a Journal), a checkpoint, then a new
    Trainer that resumes from it, its model shard and Adam state bitwise
    against the first's."""
    torch.set_num_threads(1)
    mesh = cpu_mesh(exp.mesh, world) if world > 1 else None
    journal = Journal(exp) if rank == 0 else None
    tr = Trainer(exp, _dataset(train), _dataset(test), journal=journal,
                 device="cpu", mesh=mesh)
    t0 = time.perf_counter()
    mean = tr.train_one_epoch()
    psnr_ssim = tr.test()
    tr.save_train_state()
    wall = time.perf_counter() - t0
    if journal is not None:
        journal.done()
    if mesh is not None:
        mesh.barrier()
    again = Journal(exp) if rank == 0 else None
    resumed = Trainer(exp, _dataset(train), None, journal=again,
                      device="cpu", mesh=mesh)
    resumed.load_train_state()
    same = all(torch.equal(a, b) for a, b in zip(
        resumed.state.model.state_dict().values(),
        tr.state.model.state_dict().values()))
    if again is not None:
        again.done()
    return {"mean": mean, "psnr_ssim": psnr_ssim,
            "layout": None if mesh is None else mesh.layout,
            "split": tr.state.specs is not None,
            "params": tr.model_state_dict(), "resumed_step":
            resumed.state.step, "resumed_epoch": resumed.epoch,
            "resumed_equal": same,
            "resumed_opt_equal": _opt_equal(resumed.state.optimizer,
                                            tr.state.optimizer),
            "wall": wall}


def fail_rank(rank: int, message: str):
    if rank == 1:
        raise RuntimeError(message)
    return rank


def sleep_rank(rank: int, seconds: float):
    time.sleep(seconds)
    return rank
