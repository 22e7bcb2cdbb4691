#!/usr/bin/env python3
"""ptxas's registers, shared memory and spills of every kernel instance of
two checkouts of the port, side by side.

    python3 scripts/torch_ptxas_compare.py --root DIR

Builds ``adsr_tpu_torch/csrc`` of this checkout and of the one at ``--root``
(a ``git archive`` of another commit, say the parent), both at once, each
into its own ``build/`` (nvcc for ``sm_90a``: needs the CUDA toolkit, not a
card), and prints one line per kernel instance (by source) that either
build has: ``same`` where the two ptxas lines are equal, ``differs`` with
both lines where they are not, ``only here`` / ``only there`` for
instances of one build. The last line is a JSON count of each. Exits 1
if any instance that both builds have differs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
from chip_smoke import ptxas_summary  # noqa: E402

# each source's ptxas log (the build keeps one beside the library), as JSON
BUILD = ("import json; from adsr_tpu_torch.kernels import _build; "
         "lib = _build.library_path(); "
         "print(json.dumps({p.stem: p.read_text() "
         "for p in lib.parent.glob('*.log')}))")


def ptxas(logs: dict) -> dict:
    """{'source: kernel instance': 'registers, shared memory; spills'} from
    each source's ptxas -v log (``chip_smoke.ptxas_summary``'s lines)."""
    out = {}
    for src, log in logs.items():
        for line in ptxas_summary(log):
            name, text = line.split(": ", 1)
            out[f"{src}: {name}"] = text
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, type=Path)
    args = ap.parse_args()
    procs = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=root,
                              stdout=subprocess.PIPE, text=True)
             for root in (HERE, args.root.resolve())]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        print("a build failed", file=sys.stderr)
        return 2
    here, there = (ptxas(json.loads(log)) for log in logs)
    counts = {"same": 0, "differs": 0, "only here": 0, "only there": 0}
    for name in sorted(set(here) | set(there)):
        if name not in there:
            kind, text = "only here", here[name]
        elif name not in here:
            kind, text = "only there", there[name]
        elif here[name] == there[name]:
            kind, text = "same", here[name]
        else:
            kind, text = "differs", f"{here[name]} | there: {there[name]}"
        counts[kind] += 1
        print(f"[ptxas] {kind:10s} {name}: {text}")
    print(json.dumps(counts))
    return 1 if counts["differs"] else 0


if __name__ == "__main__":
    sys.exit(main())
