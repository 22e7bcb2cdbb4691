"""Data loading (CPU, PIL) and the numpy synthetic textures."""
