"""GCN / GCNII / NGCF architectures
(reference: gnntf/core/gnn/architectures/gcn.py)."""
from __future__ import annotations

import torch

from ..graph.coo import Graph
from ..nn.layers import Concatenate, Dense, Dropout
from .gnn import GNN
from .layers import GCNIILayer, GCNLayer, NGCFLayer


class GCN(GNN):
    """[layer_type(latent, graph_dropout=0.5, dropout=0.5)]* ->
    layer_type(C) (reference gcn.py:108-113); ``layer_type`` may be
    ``GCNSpectralPreservingLayer``."""

    def __init__(self, G: Graph, features, num_classes: int,
                 latent_dims=(64,), layer_type=GCNLayer, device="cuda",
                 **kwargs):
        super().__init__(G, features, device=device, **kwargs)
        for latent_dim in latent_dims:
            self.add(layer_type(latent_dim, graph_dropout=0.5, dropout=0.5))
        self.add(layer_type(num_classes))


class GCNII(GNN):
    """Dropout(d) -> Dense(latent, relu) = H0 -> ``iterations`` x
    layer_type(H0, a, l, k, relu, dropout=d, graph_dropout=0) -> Dense(C)
    (reference gcn.py:54-74; paper
    http://proceedings.mlr.press/v119/chen20v/chen20v.pdf); ``layer_type``
    may be ``GCNIISpectralPreservingLayer``."""

    def __init__(self, graph: Graph, features, num_classes: int,
                 a: float = 0.1, l: float = 0.5, latent_dims=(64,),
                 iterations: int = 64, dropout: float = 0.6,
                 convolution_regularization: bool = True,
                 layer_type=GCNIILayer, device="cuda", **kwargs):
        super().__init__(graph, features, device=device, **kwargs)
        self.add(Dropout(dropout))
        for latent_dim in latent_dims:
            self.add(Dense(latent_dim, dropout=0, activation=torch.relu))
        H0 = self.top_layer()
        for iteration in range(iterations):
            self.add(layer_type(H0, a, l, iteration, activation=torch.relu,
                                dropout=dropout, graph_dropout=0,
                                regularization=convolution_regularization))
        self.add(Dense(num_classes, dropout=0, regularize=False))


class NGCF(GNN):
    """A stack of NGCF layers with output-activation regularization, then
    the feature-wise concatenation of every layer's embedding (reference
    gcn.py:138-154, its axis-0 ``Concatenate`` fixed as in the JAX
    package)."""

    def __init__(self, graph: Graph, features, num_classes: int,
                 latent_dims=None, dropout: float = 0.1, device="cuda",
                 **kwargs):
        super().__init__(graph, features, device=device, **kwargs)
        if latent_dims is None:
            latent_dims = [num_classes] * 2
        layers = [self.add(NGCFLayer(dim, regularize=0.0, dropout=dropout,
                                     output_regularize=1))
                  for dim in list(latent_dims) + [num_classes]]
        self.add(Concatenate(layers))
