"""Graph-free MLP baseline (reference: gnntf/core/nn/architectures/mlp.py)."""
from __future__ import annotations

import torch

from ..nn.layers import Dense, Dropout
from ..train.trainer import Trainable


class MLP(Trainable):
    """Dropout -> [Dense(latent, relu, dropout)]* -> Dense(C, no-reg)
    (reference mlp.py:6-12)."""

    def __init__(self, features, num_classes: int, latent_dims=(64,),
                 dropout: float = 0.5, device="cuda"):
        super().__init__(features, device)
        self.add(Dropout(dropout))
        for latent_dim in latent_dims:
            self.add(Dense(latent_dim, dropout=dropout, activation=torch.relu))
        self.add(Dense(num_classes, dropout=0, regularize=False))
