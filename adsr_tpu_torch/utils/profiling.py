"""Tracing / profiling utilities (the port of ``adsr_tpu/utils/profiling.py``):

- ``StepTimer``: the reference's data-vs-model split timer (src/trainer.py:
  21-42, 152-155), on the host clock as in the JAX package;
- ``trace``: a ``torch.profiler`` window written as a Chrome trace, with the
  card's activity when the device is the card;
- ``flops_estimate``: the FLOPs of one call as ``FlopCounterMode`` counts
  them, the counterpart of the JAX package's XLA cost analysis.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from adsr_tpu_torch.core.device import resolve_device


class StepTimer:
    """Accumulating split timer: data wait vs device compute per log window."""

    def __init__(self) -> None:
        self.data_acc = 0.0
        self.model_acc = 0.0
        self._t0 = time.perf_counter()

    def data_done(self) -> None:
        t = time.perf_counter()
        self.data_acc += t - self._t0
        self._t0 = t

    def model_done(self) -> None:
        t = time.perf_counter()
        self.model_acc += t - self._t0
        self._t0 = t

    def release(self) -> tuple:
        out = (self.model_acc, self.data_acc)
        self.data_acc = self.model_acc = 0.0
        self._t0 = time.perf_counter()
        return out


@contextlib.contextmanager
def trace(log_dir: str = "workspace/trace", device="cuda") -> Iterator[None]:
    """``torch.profiler`` over the block (host activity, and the card's on
    a CUDA ``device``); writes ``log_dir/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def flops_estimate(fn, *args) -> Optional[float]:
    """Total FLOPs of one call ``fn(*args)`` as ``FlopCounterMode`` counts
    them (matmuls, convolutions, attention; a multiply-add is 2); None where
    it counts none."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    total = counter.get_total_flops()
    return float(total) if total else None
