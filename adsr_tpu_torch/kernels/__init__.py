"""Hand-written Hopper kernels of the serving path and their wrappers.

Each kernel module holds the wrapper (device dispatch: CPU tensors go to the
plain PyTorch version, CUDA tensors to the kernel), the plain version, and a
``launches`` counter on the wrapper. The CUDA library builds on first launch
(``_build.py``), never at import.
"""
