"""Run-dir metadata inference (reference src/evaluate.py:48-135 conventions;
the port of ``adsr_tpu/eval/rundir.py``).

Priority: path-name pattern ``<ds>_<cls>_<res>_X<scale>`` -> config.txt keys.
Checkpoints: the port reads the reference's ``.pt`` layout (best, then
latest); a run dir of the JAX package holds flax msgpack files, which would
need ``flax``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional


def infer_from_run_dir(run_dir: str) -> Dict[str, object]:
    result: Dict[str, object] = {"model_type": None, "dataset": None,
                                 "classe": None, "resolution": None,
                                 "scale": None}
    parts = Path(run_dir).parts
    for seg in parts:
        if seg in ("drct", "drn-l"):
            result["model_type"] = seg
            break

    m = re.match(r"(?P<ds>\w+)_(?P<cls>\w+)_(?P<res>\d+)_X(?P<scale>\d+)",
                 Path(run_dir).name)
    if m:
        result["dataset"] = m.group("ds")
        result["classe"] = m.group("cls")
        result["resolution"] = int(m.group("res"))
        result["scale"] = int(m.group("scale"))

    cfg_path = Path(run_dir) / "config.txt"
    if cfg_path.exists():
        lines = cfg_path.read_text().splitlines()

        def read_val(key: str) -> Optional[str]:
            for line in lines:
                if line.strip().startswith(f"{key}:"):
                    return line.split(":", 1)[1].strip()
            return None

        if (v := read_val("model_name")):
            result["model_type"] = v
        if (v := read_val("dataset")):
            result["dataset"] = v
        if (v := read_val("classe")):
            result["classe"] = v
        if (v := read_val("patch_size")) and v.isdigit():
            result["resolution"] = int(v)
        scale_val = read_val("upscale") or read_val("scale")
        if scale_val:
            nums = re.findall(r"\d+", scale_val)
            if nums:
                result["scale"] = int(nums[-1])
        # model-capacity keys (this framework's config.txt is a full dump)
        for key in ("embed_dim", "num_layers", "num_heads", "gc",
                    "n_feats", "n_blocks"):
            if (v := read_val(key)) and v.lstrip("-").isdigit():
                result[key] = int(v)
    return result


def resolve_checkpoint(run_dir: str = "", checkpoint: str = "") -> str:
    """``checkpoint`` if given, else ``model/model_best.pt`` then
    ``model/model_latest.pt`` of ``run_dir``."""
    if checkpoint:
        return checkpoint
    if run_dir:
        model_dir = Path(run_dir) / "model"
        for name in ("model_best.pt", "model_latest.pt"):
            cand = model_dir / name
            if cand.is_file():
                return str(cand)
        msgpack = sorted(p.name for p in model_dir.glob("*.msgpack"))
        if msgpack:
            raise FileNotFoundError(
                f"{model_dir} holds only flax msgpack checkpoints "
                f"({', '.join(msgpack)}): the port reads the reference's .pt "
                "layout (model_best.pt / model_latest.pt, a torch state_dict)"
                "; reading msgpack would need flax")
    raise FileNotFoundError(
        "Provide --checkpoint or a --run-dir containing model/ checkpoints")
