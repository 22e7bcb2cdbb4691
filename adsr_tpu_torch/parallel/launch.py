"""Start the ranks of a mesh on this host: one process a rank.

The JAX package is single-controller (one process drives every device of
the mesh), so it has no counterpart. ``run_ranks(fn, world_size, devices,
backend, *args)`` spawns ``world_size`` processes
(``torch.multiprocessing.start_processes(..., start_method="spawn")``);
each selects ``devices[rank]``, joins the default process group through a
``file://`` store in a fresh temporary directory (no TCP port to collide
with other launches) and calls ``fn(rank, *args)``. It returns every rank's
result, in rank order.

Nothing hangs quietly: the process group's ``timeout`` bounds a rendezvous
or a collective that never completes, and the join gives up after
``timeout`` seconds (None: no deadline, for a training run), ends every
rank and raises ``TimeoutError``. A rank that raises or dies ends the
others, and the first error raised in any rank is raised here. SIGTERM and
SIGINT sent to the caller while it waits are passed on to every rank, so a
rank that handles them (``cli/main.py`` checkpoints and stops) ends on its
own terms.

``join_torchrun(device)`` joins the group ``torchrun`` describes in the
environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` ...) instead.
"""

from __future__ import annotations

import datetime
import os
import shutil
import signal
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from adsr_tpu_torch.core.mesh import default_backend

# a training run's bound on one collective, in seconds: a rank may wait
# that long for another to build its kernels or for rank 0 to write
TRAIN_GROUP_TIMEOUT = 1800.0


def _rank_main(rank: int, fn: Callable, world_size: int,
               devices: Sequence[str], backend: str, tmp: str,
               group_timeout: float, args: tuple) -> None:
    # every rank of this launcher is on this host: gloo and NCCL talk over
    # the loopback interface unless told otherwise
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=group_timeout))
    try:
        # every rank is connected before any can fail and close its end
        if backend == "nccl":
            dist.barrier(device_ids=[device.index or 0])
        else:
            dist.barrier()
        result = fn(rank, *args)
        torch.save(result, Path(tmp) / f"result{rank}.pt")
    except Exception:
        # when and why, so that the caller raises the first failure and
        # not another rank's broken connection that followed it
        torch.save((time.time(), traceback.format_exc()),
                   Path(tmp) / f"error{rank}.pt")
        raise
    finally:
        dist.destroy_process_group()


def _first_error(tmp: str, world_size: int) -> Optional[str]:
    """The traceback of the rank that failed first, if any wrote one."""
    errors = [torch.load(f) for f in (Path(tmp) / f"error{r}.pt"
                                      for r in range(world_size))
              if f.is_file()]
    return min(errors)[1] if errors else None


def _end(processes) -> None:
    for p in processes:
        if p.is_alive():
            p.kill()
    for p in processes:
        p.join()


def run_ranks(fn: Callable, world_size: int,
              devices: Optional[Sequence] = None,
              backend: Optional[str] = None, *args,
              timeout: Optional[float] = 900.0,
              group_timeout: float = 120.0) -> List:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned ranks and return
    their results (anything ``torch.save`` writes) in rank order.

    ``devices`` (one a rank, default ``cuda:<rank>``) and ``backend``
    (default NCCL for CUDA devices, gloo for the CPU) set up each rank's
    default process group. ``fn`` must be importable by name (a module's
    top-level function). ``timeout`` bounds the whole run (None: no bound)
    and ``group_timeout`` each rendezvous and collective, in seconds."""
    devices = [str(d) for d in (devices or
                                [f"cuda:{i}" for i in range(world_size)])]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    backend = backend or default_backend(devices[0])
    tmp = tempfile.mkdtemp(prefix="adsr_ranks_")
    ctx = None
    forward = threading.current_thread() is threading.main_thread()
    old_handlers = {}

    def _pass_on(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, devices, backend, tmp,
                              group_timeout, args),
            nprocs=world_size, join=False, start_method="spawn")
        if forward:
            old_handlers = {s: signal.signal(s, _pass_on)
                            for s in (signal.SIGTERM, signal.SIGINT)}
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                if ctx.join(timeout=1.0):
                    break
            except (mp.ProcessRaisedException,
                    mp.ProcessExitedException) as e:
                first = _first_error(tmp, world_size)
                if first is None:
                    raise
                raise RuntimeError(f"a rank failed:\n{first}") from e
            if deadline is not None and time.monotonic() > deadline:
                _end(ctx.processes)
                raise TimeoutError(
                    f"{world_size} ranks did not finish in {timeout:.0f} s")
        results = []
        for r in range(world_size):
            f = Path(tmp) / f"result{r}.pt"
            if not f.is_file():     # a rank ended by SIGINT exits quietly
                raise RuntimeError(f"rank {r} ended without a result")
            results.append(torch.load(f, weights_only=False))
        return results
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        if ctx is not None:
            _end(ctx.processes)
        shutil.rmtree(tmp, ignore_errors=True)


def under_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def join_torchrun(device: str,
                  group_timeout: float = TRAIN_GROUP_TIMEOUT) -> str:
    """Join ``torchrun``'s process group; returns this rank's device
    (``cuda:<LOCAL_RANK>``, or the CPU)."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = "cpu" if torch.device(device).type == "cpu" else f"cuda:{local}"
    if dev != "cpu":
        torch.cuda.set_device(dev)
    dist.init_process_group(default_backend(dev), init_method="env://",
                            timeout=datetime.timedelta(seconds=group_timeout))
    return dev
