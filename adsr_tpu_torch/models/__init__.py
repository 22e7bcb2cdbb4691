"""Eager PyTorch models: DRCT (the plain version of the fused serving
path) and DRN-L with its dual models."""
