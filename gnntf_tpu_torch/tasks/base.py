"""The Predictor protocol: predictive tasks decoupled from architectures
(reference trainable.py:5-13).  An architecture is bound to one graph and
feature matrix; tasks are passed to ``predict()``/``evaluate()``."""
from __future__ import annotations

from typing import Any

import torch


class Predictor:
    """Task interface."""

    def refresh(self) -> None:
        """Host-side per-use resampling hook (e.g. negative sampling)."""

    @property
    def static(self) -> bool:
        """True when ``batch()`` is the same at every epoch: the fused
        multi-epoch trainer (``fit(block_epochs=N)``) then puts it on the
        model's device once."""
        return True

    def batch(self) -> Any:
        """The task's tensors consumed by loss/predict/evaluate."""
        return ()

    def loss(self, acts: torch.Tensor, batch: Any, params=None):
        raise NotImplementedError(
            "Predictors need to implement a loss method")

    def predict(self, acts: torch.Tensor, batch: Any, params=None):
        raise NotImplementedError(
            "Predictors need to implement a predict method")

    def evaluate(self, acts: torch.Tensor, batch: Any, params=None):
        raise NotImplementedError(
            "Predictors need to implement an evaluate method")
