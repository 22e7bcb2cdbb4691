"""Dataset preparation, loading and the synthetic MVTec fixtures (numpy,
no PIL)."""
