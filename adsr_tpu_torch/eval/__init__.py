"""Anomaly serving, evaluation and ROC-AUC."""
