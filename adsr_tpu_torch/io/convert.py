"""Carry JAX DRCT params into the port's ``state_dict``.

``drct_state_dict_from_jax`` is the inverse of the JAX package's
``convert_drct`` followed by ``stack_scan_layers``
(``adsr_tpu/io/torch_convert.py:41, 240``):

- conv kernels HWIO [kH, kW, I, O] -> OIHW [O, I, kH, kW];
- Dense kernels [I, O] -> Linear weights [O, I];
- LayerNorm ``scale`` -> ``weight``;
- the 1x1 adjust kernel [1, 1, I, O] -> Conv2d weight [O, I, 1, 1];
- module names: ``patch_norm`` -> ``patch_embed.norm``,
  ``conv_before_upsample`` -> ``conv_before_upsample.0``,
  ``upsample_conv{i}`` -> ``upsample.{2i}``, ``rdg_{i}`` or the scan-stacked
  ``rdgs/rdg`` (leading [num_layers] axis) -> ``layers.{i}``.

The tree is a nested dict of arrays (numpy or anything ``np.asarray`` reads).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from adsr_tpu_torch.core.config import DRCTModelConfig

_TOP = {"conv_first": "conv_first", "conv_after_body": "conv_after_body",
        "conv_before_upsample": "conv_before_upsample.0",
        "conv_last": "conv_last", "norm": "norm",
        "patch_norm": "patch_embed.norm"}


def _leaf(path: str, v: np.ndarray) -> tuple:
    """(torch suffix, torch-layout array) for one JAX leaf."""
    name = path.rsplit("/", 1)[-1]
    if name == "kernel":
        if v.ndim == 4:
            return "weight", np.transpose(v, (3, 2, 0, 1))
        return "weight", np.transpose(v, (1, 0))
    if name == "scale":
        return "weight", v
    return name, v            # bias, relative_position_bias_table


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def drct_state_dict_from_jax(params: Mapping[str, Any],
                             cfg: DRCTModelConfig) -> Dict[str, torch.Tensor]:
    """JAX DRCT param tree -> the port's ``state_dict`` (float32 tensors)."""
    out: Dict[str, torch.Tensor] = {}

    def put(module: str, leaf_path: str, v: np.ndarray):
        suffix, arr = _leaf(leaf_path, v)
        out[f"{module}.{suffix}"] = torch.from_numpy(
            np.array(arr, dtype=np.float32))     # a writable copy

    def rdg_module(layer: int, rest: str) -> str:
        # 'swin1/attn/qkv/kernel' -> 'layers.i.swin1.attn.qkv'
        return f"layers.{layer}." + ".".join(rest.split("/")[:-1])

    for path, v in _flatten(params):
        top, _, rest = path.partition("/")
        if top in _TOP:
            put(_TOP[top], path, v)
        elif top.startswith("upsample_conv"):
            put(f"upsample.{2 * int(top[len('upsample_conv'):])}", path, v)
        elif top == "rdgs":
            sub = rest.partition("/")[2]           # drop the 'rdg' scope
            if v.shape[0] != cfg.num_layers:
                raise ValueError(f"{path}: leading axis {v.shape[0]}, "
                                 f"expected num_layers={cfg.num_layers}")
            for i in range(cfg.num_layers):
                put(rdg_module(i, sub), sub, v[i])
        elif top.startswith("rdg_"):
            put(rdg_module(int(top[len("rdg_"):]), rest), rest, v)
        else:
            raise KeyError(f"unmapped JAX DRCT param: {path}")
    return out
