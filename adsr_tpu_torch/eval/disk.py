"""Analysis of saved scores (the part of ``adsr_tpu/eval/disk.py`` that
``evaluate_anomaly`` returns): specificity at the perfect-recall threshold
(reference src/recall_1.py:419-435). The disk-folder pipelines of the JAX
module (window sweeps over saved PNG folders) wait for a later slice."""

from __future__ import annotations

from typing import Dict, Sequence

from adsr_tpu_torch.eval.auc import perfect_recall_threshold, specificity_at


def specificity_report(y_true: Sequence[int],
                       scores: Dict[str, Sequence[float]]
                       ) -> Dict[str, Dict[str, float]]:
    """Per metric: the lowest score of a defective image (the threshold at
    which every defective image is flagged) and the share of good images
    below it."""
    out = {}
    for name, s in scores.items():
        thr = perfect_recall_threshold(y_true, s)
        out[name] = {"threshold": thr,
                     "specificity": specificity_at(y_true, s, thr)}
    return out
