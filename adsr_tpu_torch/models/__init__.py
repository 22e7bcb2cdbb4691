"""Eager PyTorch models (the plain versions of the fused serving path)."""
