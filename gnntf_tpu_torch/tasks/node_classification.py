"""Node classification task head (reference graph_predictor.py:10-31)."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .base import Predictor


class NodeClassification(Predictor):
    """Softmax classification over a set of node ids.  Node ids and labels
    are held on the CPU and moved to the activations' device on use; a
    batch already there (the fused trainer moves it once) is not copied.

    The loss is the reference's literal composition — ``log_softmax``, then
    softmax cross-entropy from logits on top (graph_predictor.py:24-25) —
    which equals plain softmax cross-entropy in value and gradient."""

    def __init__(self, nodes, labels=None,
                 loss_transform: Optional[Callable] = None):
        self.nodes = torch.as_tensor(np.asarray(nodes, np.int64))
        self.labels = None if labels is None else torch.as_tensor(
            np.asarray(labels, np.int64))
        self.loss_transform = loss_transform

    def batch(self):
        return (self.nodes, self.labels)

    def loss(self, acts, batch, params=None):
        nodes, labels = batch
        if labels is None:
            raise ValueError("Evaluation requires node labels")
        feats = acts
        if self.loss_transform is not None:
            feats = self.loss_transform(feats)
        logits = torch.log_softmax(feats[nodes.to(acts.device)], dim=1)
        z = torch.log_softmax(logits, dim=1)
        labels = labels.to(acts.device)
        return -z.gather(1, labels[:, None])[:, 0].mean()

    def predict(self, acts, batch=None, params=None):
        nodes = self.nodes if batch is None else batch[0]
        return torch.argmax(acts[nodes.to(acts.device)], dim=1)

    def evaluate(self, acts, batch=None, params=None):
        nodes, labels = (self.nodes, self.labels) if batch is None else batch
        if labels is None:
            raise ValueError("Evaluation requires node labels")
        preds = torch.argmax(acts[nodes.to(acts.device)], dim=1)
        wrong = torch.count_nonzero(preds - labels.to(acts.device))
        return 1 - wrong / preds.shape[0]
