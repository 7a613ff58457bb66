"""Evaluation measures + global seeding (reference: gnntf/measures.py).

The JAX package's numpy functions, copied so the port stands alone, with
``auc`` written in numpy instead of through scikit-learn (reference
file:line):

  acc      :13-14  fraction of exact matches
  auc      :17-19  ROC AUC (sklearn's ``roc_curve`` + ``auc`` there)
  avprec   :22-27  average precision @k, normalized by the labels in top-k
  rec      :30-32  recall @k
  prec     :35-37  mean of the labels in top-k
  f1       :40-45  harmonic mean of prec/rec @k
"""
from __future__ import annotations

import random

import numpy as np

_GLOBAL_SEED_STATE = {"counter": 0, "seed": None}


def set_seed(seed: int) -> None:
    """Seed python/numpy plus the framework's seed stream
    (reference measures.py:7-10)."""
    random.seed(seed)
    np.random.seed(seed)
    _GLOBAL_SEED_STATE["seed"] = int(seed)
    _GLOBAL_SEED_STATE["counter"] = 0


def next_seed() -> int:
    """Draw a deterministic fresh seed for reset() calls, so repeated
    experiments under ``set_seed(k)`` are reproducible like the reference."""
    if _GLOBAL_SEED_STATE["seed"] is None:
        return int(np.random.randint(0, 2**31 - 1))
    _GLOBAL_SEED_STATE["counter"] += 1
    return (_GLOBAL_SEED_STATE["seed"] * 1000003
            + _GLOBAL_SEED_STATE["counter"]) % (2**31 - 1)


def acc(predictions, labels):
    predictions = np.asarray(predictions)
    labels = np.asarray(labels)
    return 1 - np.count_nonzero(predictions - labels) / predictions.shape[0]


def auc(labels, predictions):
    """Area under the ROC curve of ``predictions`` for ``labels == 1``, as
    scikit-learn's ``auc(*roc_curve(labels, predictions, pos_label=1)[:2])``
    computes it: one ROC point per distinct score, taken from the highest,
    from (0, 0), and the trapezoid rule over them.  NaN when one class is
    absent."""
    labels = np.asarray(labels).reshape(-1) == 1
    scores = np.asarray(predictions, np.float64).reshape(-1)
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, labels = scores[order], labels[order]
    last = np.r_[np.flatnonzero(np.diff(scores)), len(scores) - 1]
    tps = np.cumsum(labels)[last]
    fps = last + 1 - tps
    tpr = np.r_[0, tps] / (tps[-1] if tps[-1] else np.nan)
    fpr = np.r_[0, fps] / (fps[-1] if fps[-1] else np.nan)
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def avprec(labels, predictions, k: int = 5):
    """Average precision @k with the reference's own normalization: the
    label-weighted reciprocal-rank sum over the top-k, divided by the sum
    of the labels *in the top-k* (reference measures.py:27)."""
    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    top_desc = np.argsort(predictions)[-k:][::-1]
    hits = labels[top_desc].astype(np.float64)
    nom = float(np.sum(hits / (np.arange(hits.shape[0]) + 1.0)))
    return 0 if nom == 0 else nom / np.sum(hits)


def rec(labels, predictions, k: int = 5):
    labels = np.asarray(labels)
    top = np.argsort(np.asarray(predictions))[-k:]
    return np.sum(labels[top]) / np.sum(labels)


def prec(labels, predictions, k: int = 5):
    labels = np.asarray(labels)
    top = np.argsort(np.asarray(predictions))[-k:]
    return np.mean(labels[top])


def f1(labels, predictions, k: int = 5):
    precision = prec(labels, predictions, k)
    recall = rec(labels, predictions, k)
    if precision + recall == 0:
        return 0
    return 2 * precision * recall / (precision + recall)


def bootstrap_ci(values, confidence: float = 0.95, n_boot: int = 10000,
                 seed: int = 0):
    """Bootstrap confidence interval of the mean of repeated experiments'
    results (the reference's methodology, test_experiments.py:8-22).
    Returns ``(mean, low, high)``."""
    values = np.asarray(values, np.float64)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(values), size=(n_boot, len(values)))
    means = values[idx].mean(axis=1)
    alpha = (1.0 - confidence) / 2
    return (float(values.mean()),
            float(np.quantile(means, alpha)),
            float(np.quantile(means, 1 - alpha)))
