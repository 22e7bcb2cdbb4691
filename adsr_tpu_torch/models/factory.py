"""Model factory and seeded parameter initialisation.

The counterpart of ``adsr_tpu/models/factory.py`` for DRCT and DRN-L:
``make_model`` builds the eager module, ``init_sr_params`` returns its
``state_dict`` (and DRN's dual models' ``state_dict``s) drawn from a
``torch.Generator`` with the JAX package's distributions (truncated normal
std 0.02 for Linear weights and bias tables, torch's Conv2d uniform for
convs, zero biases, unit LayerNorm scales; DRN's ``MeanShift`` keeps its
identity kernel and mean bias).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from adsr_tpu_torch.core.config import (DRCTModelConfig, DRNModelConfig,
                                        ModelConfig)
from adsr_tpu_torch.core.device import resolve_device
from adsr_tpu_torch.models.common import (MeanShift, torch_conv_init,
                                          trunc_normal_init)
from adsr_tpu_torch.models.drct import DRCT, WindowAttention
from adsr_tpu_torch.models.drn import DRN, make_dual_models

StateDict = Dict[str, torch.Tensor]


def make_model(cfg: ModelConfig, device="cuda") -> nn.Module:
    if isinstance(cfg, DRCTModelConfig):
        return DRCT(cfg).to(resolve_device(device))
    if isinstance(cfg, DRNModelConfig):
        return DRN(cfg).to(resolve_device(device))
    raise ValueError(f"no model for config {type(cfg).__name__}")


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded in-place init in module order (CPU generator, CPU module)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                trunc_normal_init(mod.weight, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, MeanShift):
                mod.reset_shift()
            elif isinstance(mod, nn.Conv2d):
                torch_conv_init(mod.weight, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, WindowAttention):
                trunc_normal_init(mod.relative_position_bias_table,
                                  generator=generator)
    return model


def init_sr_params(cfg: ModelConfig,
                   generator: Optional[torch.Generator] = None,
                   device="cuda"
                   ) -> Tuple[StateDict, Optional[Tuple[StateDict, ...]]]:
    """(state_dict, dual state_dicts): the duals are DRN's, one a scale
    entry, drawn after the primal; DRCT has none (None). The draw runs on
    the CPU from ``generator`` (a seeded CPU generator, seed 0 if None) and
    the tensors then move to ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def drawn(module: nn.Module) -> StateDict:
        init_weights_(module, generator)
        return {k: v.to(dev) for k, v in module.state_dict().items()}

    primal = drawn(make_model(cfg, device="cpu"))
    if not isinstance(cfg, DRNModelConfig):
        return primal, None
    return primal, tuple(drawn(d) for d in make_dual_models(cfg))
