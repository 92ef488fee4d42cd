"""Audio-tagging metrics without scikit-learn: per-class average precision.

The class-mapping tagging evaluation (JAX
``training/runner_class_mapping.py:191-223``) scores each class by
``sklearn.metrics.average_precision_score(labels, probs, average=None)``
and sets a class without a positive to 0 (``.fillna(0)``).  Here the same
step-function integral over the precision-recall curve, in NumPy, in
scikit-learn's order of operations: the scores sorted descending, one
point per distinct score (ties share a point), ``AP = -Σ Δrecall ·
precision`` with recall running from 1 down to 0.
"""

from __future__ import annotations

import numpy as np


def _binary_average_precision(y_true: np.ndarray,
                              y_score: np.ndarray) -> float:
    order = np.argsort(y_score, kind="mergesort")[::-1]
    score = y_score[order]
    hits = (y_true[order] == 1).astype(np.float64)
    ends = np.r_[np.where(np.diff(score))[0], hits.size - 1]
    tps = np.cumsum(hits)[ends]
    fps = 1 + ends - tps
    if tps[-1] == 0:
        return 0.0
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1), 0.0)
    recall = tps / tps[-1]
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def average_precision(labels: np.ndarray, probs: np.ndarray) -> np.ndarray:
    """Average precision per class of ``probs [N, C]`` against the 0 / 1
    ``labels [N, C]``, 0 for a class with no positive: ``[C]`` float64."""
    labels = np.asarray(labels)
    probs = np.asarray(probs, np.float64)
    return np.array([_binary_average_precision(labels[:, c], probs[:, c])
                     for c in range(labels.shape[1])], np.float64)
