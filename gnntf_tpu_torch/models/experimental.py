"""Experimental architectures (reference:
gnntf/core/gnn/architectures/experimental_filter.py, experimental_gcn.py,
experimental_backup.py), as the JAX package has them: ``FastReg`` creates
its parameter once at build time, and ``APPNP2``/``APPNPThrough`` are the
working equivalents of the reference's ``experimental_backup.py``."""
from __future__ import annotations

import torch

from ..graph.coo import Graph
from ..nn.core import Forward, Layer, Network
from ..nn.layers import Dense, Dropout
from ..ops.normalize import _degree
from .gnn import GNN
from .layers import GCNIILayer, PPRIteration


def _identity(x):
    return x


class PPRSweep(Layer):
    """Divides the features by a 10-step PPR of all-ones, a degree-bias
    correction (reference experimental_filter.py:7-19)."""

    def build(self, net: Network, restart_probability: float = 0.1):
        self.restart_probability = restart_probability
        return net.top_shape()

    def apply(self, fw: Forward, x):
        adj = fw.adjacency()  # graph_dropout=0.5, as in the reference
        h0 = torch.ones_like(x)
        hn = h0
        for _ in range(10):
            hn = fw.spmm(adj, hn) * (1.0 - self.restart_probability) \
                + h0 * self.restart_probability
        return x / hn


class FastReg(Layer):
    """An identity layer that adds a negative Dirichlet-energy ratio to the
    loss (reference experimental_filter.py:22-43): an SpMM at width 1 and
    the degrees of the edge-dropped, unnormalized graph."""

    def build(self, net: Network):
        self.W = net.create_param((net.top_shape()[1], 1), regularize=1)
        return net.top_shape()

    def apply(self, fw: Forward, x):
        adj = fw.adjacency(graph_dropout=0.5, normalized="none")
        feats = torch.sigmoid(torch.matmul(x, fw.param(self.W)))
        diffs = feats - fw.spmm(adj, feats)
        deg = _degree(adj)
        lam = torch.sum(diffs * diffs) / torch.sum(
            deg[:, None] * feats * feats)
        fw.add_loss(-lam)
        return x


class APPNPReg(GNN):
    """APPNP without input dropout (reference
    experimental_filter.py:46-56)."""

    def __init__(self, G: Graph, features, num_classes: int, a: float = 0.1,
                 latent_dims=(64,), iterations: int = 10,
                 dropout: float = 0.6, graph_dropout: float = 0.5,
                 activation=_identity, device="cuda", **kwargs):
        super().__init__(G, features, device=device, **kwargs)
        for latent_dim in latent_dims:
            self.add(Dense(latent_dim, activation=torch.relu,
                           dropout=dropout))
        H0 = self.add(Dense(num_classes, regularize=False))
        restart = self.create_var() if a is None else a
        for _ in range(iterations):
            self.add(PPRIteration(H0, restart, graph_dropout=graph_dropout,
                                  activation=activation))


class GCNIIReg(GNN):
    """GCNII with a ``FastReg`` after its first dense layer (reference
    experimental_gcn.py:9-29)."""

    def __init__(self, graph: Graph, features, num_classes: int,
                 a: float = 0.1, l: float = 0.5, latent_dims=(64,),
                 iterations: int = 64, dropout: float = 0.6,
                 convolution_regularization: bool = True, device="cuda",
                 **kwargs):
        super().__init__(graph, features, device=device, **kwargs)
        self.add(Dropout(dropout))
        for latent_dim in latent_dims:
            self.add(Dense(latent_dim, dropout=dropout,
                           activation=torch.relu))
        H0 = self.top_layer()
        self.add(FastReg())
        for iteration in range(iterations):
            self.add(GCNIILayer(H0, a, l, iteration, activation=torch.relu,
                                dropout=dropout, graph_dropout=0,
                                regularization=convolution_regularization))
        self.add(Dense(num_classes, dropout=0, regularize=False))


class StableIteration(Layer):
    """A propagation step with two restart probabilities traded off by a
    learnable sigmoid gate (reference experimental_backup.py:6-24)."""

    def build(self, net: Network, H0: Layer, a1: float = 0.2,
              a2: float = 0.05, graph_dropout: float = 0.5):
        self.H0 = H0
        self.a1, self.a2 = a1, a2
        self.graph_dropout = graph_dropout
        self.gate = net.create_param((1, 1), "zero", regularize=False)
        return net.top_shape()

    def apply(self, fw: Forward, x):
        propagated = fw.spmm(fw.adjacency(self.graph_dropout), x)
        h0 = fw.value_of(self.H0)
        g = torch.sigmoid(fw.param(self.gate))
        out1 = propagated * (1.0 - self.a1) + h0 * self.a1
        out2 = propagated * (1.0 - self.a2) + h0 * self.a2
        return g * out1 + (1.0 - g) * out2


class APPNP2(GNN):
    """Dual-alpha APPNP (working equivalent of
    experimental_backup.py:27-43)."""

    def __init__(self, G: Graph, features, num_classes: int,
                 latent_dims=(64,), iterations: int = 10,
                 dropout: float = 0.6, graph_dropout: float = 0.5,
                 device="cuda", **kwargs):
        super().__init__(G, features, device=device, **kwargs)
        self.add(Dropout(0.5))
        for latent_dim in latent_dims:
            self.add(Dense(latent_dim, activation=torch.relu,
                           dropout=dropout))
        H0 = self.add(Dense(num_classes, regularize=False))
        for _ in range(iterations):
            self.add(StableIteration(H0, graph_dropout=graph_dropout))


class APPNPThrough(GNN):
    """APPNP with a label channel: the features gain ``num_classes`` zero
    columns, and ``train()`` writes the train task's one-hot labels into
    them (working equivalent of experimental_backup.py:46-62)."""

    def __init__(self, G: Graph, features, num_classes: int, a: float = 0.1,
                 latent_dims=(64,), iterations: int = 10,
                 dropout: float = 0.6, graph_dropout: float = 0.5,
                 device="cuda", **kwargs):
        features = torch.as_tensor(features, dtype=torch.float32)
        padded = torch.cat([features, features.new_zeros(
            features.shape[0], num_classes)], dim=1)
        super().__init__(G, padded, device=device, **kwargs)
        self.num_classes = num_classes
        self.add(Dropout(0.5))
        for latent_dim in latent_dims:
            self.add(Dense(latent_dim, activation=torch.relu,
                           dropout=dropout))
        H0 = self.add(Dense(num_classes, regularize=False))
        for _ in range(iterations):
            self.add(PPRIteration(H0, a, graph_dropout=graph_dropout))

    def train(self, train, **kwargs):
        """Write the train task's one-hot labels into the label columns of
        the model's feature tensor, in place, then train."""
        c = self.num_classes
        nodes = torch.as_tensor(train.nodes, dtype=torch.int64,
                                device=self.device)
        labels = torch.as_tensor(train.labels, dtype=torch.int64,
                                 device=self.device)
        with torch.no_grad():
            self.features[:, -c:] = 0.0
            self.features[nodes, self.features.shape[1] - c + labels] = 1.0
        self._act_cache = None
        return super().train(train, **kwargs)
