"""Carry JAX DRCT and DRN-L params into the port's ``state_dict``.

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

``drn_state_dict_from_jax`` is the inverse of ``convert_drn`` followed by
``stack_drn_rcabs`` (``torch_convert.py:119, 252``), for the scan-stacked
``up{i}_rcabs/rcab`` tree (leading [n_blocks] axis) and the per-block
``up{i}_rcab{j}`` tree alike: ``sub_mean/shift`` -> ``sub_mean``,
``down_{p}/down{s}`` -> ``down.{p}.dual_module.{s}.0`` and
``down_{p}/proj`` -> the block's last index, RCAB ``conv0`` / ``conv1`` /
``ca/du_reduce`` / ``ca/du_expand`` -> ``body.0`` / ``body.2`` /
``body.3.conv_du.0`` / ``body.3.conv_du.2`` of ``up_blocks.{i}.{j}``,
``up{i}_upsampler/conv{k}`` -> ``up_blocks.{i}.{n_blocks}.{2k}``,
``up{i}_proj`` -> ``up_blocks.{i}.{n_blocks+1}``, ``tail_{idx}`` ->
``tail.{idx}``. ``drn_duals_from_jax`` maps the dual models' trees the same
way (``dual_module.{s}.0`` and the projection).

The tree is a nested dict of arrays (numpy or anything ``np.asarray`` reads).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from adsr_tpu_torch.core.config import DRCTModelConfig, DRNModelConfig

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


def _tensor(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))   # a writable copy


def drct_state_dict_from_jax(params: Mapping[str, Any],
                             cfg: DRCTModelConfig) -> Dict[str, torch.Tensor]:
    """JAX DRCT param tree -> the port's ``state_dict`` (float32 tensors)."""
    out: Dict[str, torch.Tensor] = {}

    def put(module: str, leaf_path: str, v: np.ndarray):
        suffix, arr = _leaf(leaf_path, v)
        out[f"{module}.{suffix}"] = _tensor(arr)

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


_RCAB = {"conv0": "body.0", "conv1": "body.2", "ca/du_reduce":
         "body.3.conv_du.0", "ca/du_expand": "body.3.conv_du.2"}


def _down_block(tree: Mapping[str, Any], prefix: str,
                out: Dict[str, torch.Tensor]) -> None:
    """A JAX ``DownBlock`` tree (``down{s}``, ``proj``) -> the reference's
    ``{prefix}dual_module.{s}.0`` / ``{prefix}dual_module.{last}``."""
    n_down = sum(1 for k in tree if k.startswith("down"))
    for path, v in _flatten(tree):
        conv_name, _, leaf = path.partition("/")
        if conv_name == "proj":
            module = f"{prefix}dual_module.{n_down}"
        elif conv_name.startswith("down"):
            module = f"{prefix}dual_module.{int(conv_name[4:])}.0"
        else:
            raise KeyError(f"unmapped JAX DownBlock param: {prefix}{path}")
        suffix, arr = _leaf(leaf, v)
        out[f"{module}.{suffix}"] = _tensor(arr)


def drn_state_dict_from_jax(params: Mapping[str, Any],
                            cfg: DRNModelConfig) -> Dict[str, torch.Tensor]:
    """JAX DRN param tree (scanned or per-block RCABs) -> the port's
    ``state_dict`` (float32 tensors)."""
    out: Dict[str, torch.Tensor] = {}
    nb = cfg.n_blocks

    def put(module: str, leaf_path: str, v: np.ndarray):
        suffix, arr = _leaf(leaf_path, v)
        out[f"{module}.{suffix}"] = _tensor(arr)

    def rcab(i: int, j: int, rest: str, v: np.ndarray):
        conv_path = rest.rsplit("/", 1)[0]
        if conv_path not in _RCAB:
            raise KeyError(f"unmapped JAX RCAB param: up{i}/{rest}")
        put(f"up_blocks.{i}.{j}.{_RCAB[conv_path]}", rest, v)

    for top, sub in params.items():
        if top in ("sub_mean", "add_mean"):
            for path, v in _flatten(sub["shift"]):
                put(top, path, v)
        elif top == "head" or top.startswith("tail_") or (
                top.startswith("up") and top.endswith("_proj")):
            if top == "head":
                module = "head"
            elif top.startswith("tail_"):
                module = f"tail.{int(top[len('tail_'):])}"
            else:
                module = f"up_blocks.{int(top[2:-len('_proj')])}.{nb + 1}"
            for path, v in _flatten(sub):
                put(module, path, v)
        elif top.startswith("down_"):
            _down_block(sub, f"down.{int(top[len('down_'):])}.", out)
        elif top.startswith("up") and top.endswith("_upsampler"):
            i = int(top[2:-len("_upsampler")])
            for path, v in _flatten(sub):
                k = int(path.split("/")[0][len("conv"):])
                put(f"up_blocks.{i}.{nb}.{2 * k}", path, v)
        elif top.startswith("up") and top.endswith("_rcabs"):
            i = int(top[2:-len("_rcabs")])
            for path, v in _flatten(sub["rcab"]):
                if v.shape[0] != nb:
                    raise ValueError(f"{top}/{path}: leading axis "
                                     f"{v.shape[0]}, expected n_blocks={nb}")
                for j in range(nb):
                    rcab(i, j, path, v[j])
        elif top.startswith("up") and "_rcab" in top:
            i, j = (int(n) for n in top[2:].split("_rcab"))
            for path, v in _flatten(sub):
                rcab(i, j, path, v)
        else:
            raise KeyError(f"unmapped JAX DRN param: {top}")
    return out


def drn_duals_from_jax(dual_params, cfg: DRNModelConfig
                       ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The JAX dual models' trees (one a scale entry) -> their
    ``state_dict``s."""
    if len(dual_params) != len(cfg.scale):
        raise ValueError(f"{len(dual_params)} dual trees for "
                         f"{len(cfg.scale)} scales")
    out = []
    for tree in dual_params:
        sd: Dict[str, torch.Tensor] = {}
        _down_block(tree, "", sd)
        out.append(sd)
    return tuple(out)
