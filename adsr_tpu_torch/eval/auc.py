"""ROC-AUC and threshold selection without sklearn (numpy, on the host).

A copy of ``adsr_tpu/eval/auc.py``: the port imports nothing of the JAX
package.

``roc_auc`` is the Mann-Whitney U statistic with average ranks for ties —
numerically identical to sklearn.metrics.roc_auc_score, which the reference
uses for all anomaly scoring (reference src/evaluate.py:245-265). sklearn is
used only in tests as a cross-check oracle.

Threshold pickers reproduce the reference's research helpers
(src/helpers.py:453-481 and src/efficientAD.py:610-632).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties sharing their average rank."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), dtype=np.float64)
    sorted_x = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sorted_x[j + 1] == sorted_x[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def roc_auc(y_true: Sequence[int], scores: Sequence[float]) -> float:
    y = np.asarray(y_true)
    s = np.asarray(scores, dtype=np.float64)
    n1 = int(y.sum())
    n0 = len(y) - n1
    if n0 == 0 or n1 == 0:
        raise ValueError("roc_auc needs both classes present")
    ranks = _average_ranks(s)
    u = ranks[y == 1].sum() - n1 * (n1 + 1) / 2.0
    return float(u / (n0 * n1))


def roc_curve(y_true: Sequence[int], scores: Sequence[float]
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) at every distinct score, descending."""
    y = np.asarray(y_true)
    s = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-s, kind="mergesort")
    y_sorted = y[order]
    s_sorted = s[order]
    distinct = np.where(np.diff(s_sorted))[0]
    idx = np.r_[distinct, len(y) - 1]
    tps = np.cumsum(y_sorted)[idx]
    fps = (idx + 1) - tps
    tpr = tps / max(y.sum(), 1)
    fpr = fps / max(len(y) - y.sum(), 1)
    return fpr, tpr, s_sorted[idx]


def youden_threshold(y_true, scores) -> float:
    """argmax(tpr - fpr) (src/helpers.py:453-458)."""
    fpr, tpr, thr = roc_curve(y_true, scores)
    return float(thr[np.argmax(tpr - fpr)])


def min_distance_threshold(y_true, scores) -> float:
    """Closest point to (0, 1) on the ROC (src/helpers.py:460-469)."""
    fpr, tpr, thr = roc_curve(y_true, scores)
    return float(thr[np.argmin(np.sqrt(fpr ** 2 + (1 - tpr) ** 2))])


def perfect_recall_threshold(y_true, scores) -> float:
    """Minimum score among positives (src/helpers.py:471-481)."""
    y = np.asarray(y_true)
    s = np.asarray(scores, dtype=np.float64)
    return float(s[y == 1].min())


def specificity_at(y_true, scores, threshold: float) -> float:
    y = np.asarray(y_true)
    pred = np.asarray(scores) >= threshold
    tn = int(np.sum((y == 0) & ~pred))
    fp = int(np.sum((y == 0) & pred))
    return tn / max(tn + fp, 1)
