"""Model factory and seeded parameter initialisation.

The counterpart of ``adsr_tpu/models/factory.py`` for DRCT: ``make_model``
builds the eager module, ``init_sr_params`` returns its ``state_dict`` drawn
from a ``torch.Generator`` with the JAX package's distributions (truncated
normal std 0.02 for Linear weights and bias tables, torch's Conv2d uniform
for convs, zero biases, unit LayerNorm scales).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.core.device import resolve_device
from adsr_tpu_torch.models.common import torch_conv_init, trunc_normal_init
from adsr_tpu_torch.models.drct import DRCT, WindowAttention


def make_model(cfg: DRCTModelConfig, device="cuda") -> DRCT:
    if not isinstance(cfg, DRCTModelConfig):
        raise NotImplementedError(
            f"the port serves DRCT only so far, not {type(cfg).__name__}")
    return DRCT(cfg).to(resolve_device(device))


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded in-place init in module order (CPU generator, CPU module)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                trunc_normal_init(mod.weight, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                torch_conv_init(mod.weight, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, WindowAttention):
                trunc_normal_init(mod.relative_position_bias_table,
                                  generator=generator)
    return model


def init_sr_params(cfg: DRCTModelConfig,
                   generator: Optional[torch.Generator] = None,
                   device="cuda") -> Tuple[Dict[str, torch.Tensor], None]:
    """(state_dict, None): DRCT has no dual models. The draw runs on the CPU
    from ``generator`` (a seeded CPU generator, seed 0 if None) and the
    tensors then move to ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_weights_(make_model(cfg, device="cpu"), generator)
    return {k: v.to(dev) for k, v in model.state_dict().items()}, None
