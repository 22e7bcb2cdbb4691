"""PyTorch + CUDA port of adsr_tpu: DRCT and DRN-L super-resolution anomaly
detection (training, serving, evaluation and their command-line entry
points).

Mirrors the JAX package's layout (``cli/``, ``core/``, ``models/``,
``eval/``, ``train/``, ``io/``, ``data/``, ``metrics.py``) with ``kernels/``
in place of ``ops/`` and the hand-written Hopper kernels under ``csrc/``.
Imports torch, numpy and the standard library only; the kernels build on
first use.
"""
