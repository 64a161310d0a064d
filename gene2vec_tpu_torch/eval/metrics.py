"""Small numpy metrics — a copy of ``gene2vec_tpu/eval/metrics.py``.

The reference computes its extrinsic score with ``sklearn.metrics.roc_auc_score``
on the positive-class softmax column (``src/GGIPNN_Classification.py:246-254``).
The ranking form here (Mann-Whitney U with midrank ties) is numerically
identical for binary labels and keeps the core framework dependency-light.
"""

from __future__ import annotations

import numpy as np


def _midranks(x: np.ndarray) -> np.ndarray:
    """Ranks (1-based) with ties assigned the midrank."""
    order = np.argsort(x, kind="mergesort")
    sx = x[order]
    n = len(x)
    ranks = np.empty(n, dtype=np.float64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary ROC-AUC via the rank statistic.

    ``y_true`` ∈ {0, 1}; ``y_score`` any real-valued score (the reference
    feeds softmax ``scores[:, 1]``).
    """
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    if y_true.shape != y_score.shape:
        raise ValueError("y_true and y_score shape mismatch")
    pos = y_true == 1
    n_pos = int(pos.sum())
    n_neg = int(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc_score needs both classes present")
    ranks = _midranks(y_score)
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    return float((y_true == y_pred).mean())
