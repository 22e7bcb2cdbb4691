"""Command-line entry points: ``python -m adsr_tpu_torch.cli.main`` (train)
and ``python -m adsr_tpu_torch.cli.evaluate`` (anomaly AUCs of a run dir)."""
