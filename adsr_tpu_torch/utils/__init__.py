"""Score-map and profiling utilities (the port of ``adsr_tpu/utils``)."""

from adsr_tpu_torch.utils.image import histogram_equalization, min_max_scaling
from adsr_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["StepTimer", "trace", "histogram_equalization", "min_max_scaling"]
