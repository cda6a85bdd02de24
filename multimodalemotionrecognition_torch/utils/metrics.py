"""Evaluation metrics (reference `src/utils/metrics.py:7-16`), on numpy.

The port's own copy of the JAX package's `utils/metrics.py`: accuracy and
macro-F1 with sklearn's conventions (classes present in either targets or
predictions; a class's F1 is 0 when its denominator is 0).
"""

from __future__ import annotations

import numpy as np

__all__ = ["accuracy", "macro_f1"]


def accuracy(preds, targets) -> float:
    preds = np.asarray(preds)
    targets = np.asarray(targets)
    if preds.size == 0:
        return 0.0
    return float((preds == targets).mean())


def macro_f1(preds, targets, num_classes: int | None = None) -> float:
    """Macro-averaged F1 matching sklearn.f1_score(average="macro"): averaged
    over the union of classes observed in targets or preds (or
    range(num_classes) when given)."""
    preds = np.asarray(preds).astype(np.int64)
    targets = np.asarray(targets).astype(np.int64)
    if preds.size == 0:
        return 0.0
    if num_classes is None:
        classes = np.union1d(np.unique(targets), np.unique(preds))
    else:
        classes = np.arange(num_classes)
    f1s = []
    for c in classes:
        tp = float(np.sum((preds == c) & (targets == c)))
        fp = float(np.sum((preds == c) & (targets != c)))
        fn = float(np.sum((preds != c) & (targets == c)))
        denom = 2 * tp + fp + fn
        f1s.append(0.0 if denom == 0 else 2 * tp / denom)
    return float(np.mean(f1s)) if f1s else 0.0
