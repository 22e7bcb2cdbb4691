"""Serving forward (training waits for a later slice)."""
