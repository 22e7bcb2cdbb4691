#!/usr/bin/env python3
"""Device memory the caching allocator holds after each phase of
``chip_smoke.py``, all phases in one process.

    python3 scripts/torch_smoke_memory.py

Runs the flagship, window-16 and window-4 phases of ``chip_smoke.py`` one
after the other in this process (``chip_smoke.py`` itself gives each its own
process) and prints, after each phase function, one ``[mem]`` line: the
reserved bytes, the reserved bytes after ``torch.cuda.empty_cache()`` (what
the allocator would not release), the allocated bytes, and both by memory
pool. Needs the card; stops at the first phase that fails.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

GIB = 2 ** 30
TRACED = ("phase_main", "phase_timing", "phase_block_timing",
          "phase_bwd_kernels", "phase_rdg", "phase_train",
          "phase_train_timing", "phase_cli", "phase_graphs", "phase_serving",
          "phase_x8", "sdpa_bwd_ms", "check_server_graphs", "check_replays")


def mem(tag: str) -> None:
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg["segment_pool_id"])
        total, alloc = pools.get(pool, (0, 0))
        pools[pool] = (total + seg["total_size"],
                       alloc + seg["allocated_size"])
    print(f"[mem] {tag}: reserved {reserved / GIB:.2f} GiB, after "
          f"empty_cache {torch.cuda.memory_reserved() / GIB:.2f}, allocated "
          f"{torch.cuda.memory_allocated() / GIB:.2f}; by pool (GiB "
          "reserved, allocated): " + str(
              {k: (round(t / GIB, 2), round(a / GIB, 2))
               for k, (t, a) in pools.items()}), flush=True)


def traced(name: str):
    fn = getattr(cs, name)

    def run(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        finally:
            mem(f"after {name}")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    for name in TRACED:
        setattr(cs, name, traced(name))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._build.library()
    dev = torch.device(cs.DEVICE)
    for phase in cs.PHASES.values():
        phase(dev, {})
    return 0


if __name__ == "__main__":
    sys.exit(main())
