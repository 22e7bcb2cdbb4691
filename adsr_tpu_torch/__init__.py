"""PyTorch + CUDA port of adsr_tpu: DRCT super-resolution anomaly serving.

Mirrors the JAX package's layout (``core/``, ``models/``, ``eval/``,
``train/``, ``io/``, ``data/``, ``metrics.py``) with ``kernels/`` in place of
``ops/`` and the hand-written Hopper kernels under ``csrc/``. Imports torch,
numpy and the standard library only; the kernels build on first use.
"""
