"""Run dirs and checkpoints, the PNG codec, and the weight carrier from the
JAX package."""
