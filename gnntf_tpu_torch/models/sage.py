"""GraphSAGE and GIN (the JAX package's ``models/sage.py``).

Both aggregate through the model's SpMM operator for their adjacency
(``Forward.adjacency`` / ``Forward.spmm``): the prepared operator (the hub
slice and K1, its backward the walk over K1's transposed list) without edge
dropout, the masked walk over the training grids with it.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..graph.coo import Graph
from ..nn.core import Forward, Layer, Network
from ..nn.layers import Dense, Dropout
from .gnn import GNN
from .layers import _narrow_first


class SAGELayer(Layer):
    """GraphSAGE-mean convolution:

        out = act( X @ W_self + mean_{j in N(i)} X_j @ W_neigh + b )

    optionally L2-normalized.  The neighbour mean is the row-stochastic
    SpMM (``normalized="row"``: ``D_row^-1 A``); edge dropout composes with
    it (the mean over the surviving neighbours)."""

    def build(self, net: Network, outputs: int,
              activation: Optional[Callable] = torch.relu,
              bias: bool = True, normalize: bool = False,
              dropout: float = 0.0, graph_dropout: float = 0.0):
        n, d = net.top_shape()
        self.W_self = net.create_param((d, outputs), "xavier")
        self.W_neigh = net.create_param((d, outputs), "xavier")
        self.b = net.create_param((1, outputs), "zero") if bias else None
        self.activation = activation
        self.normalize = normalize
        self.dropout_rate = dropout
        self.graph_dropout = graph_dropout
        return (n, outputs)

    def apply(self, fw: Forward, x):
        adj = fw.adjacency(self.graph_dropout, normalized="row",
                           add_eye="none")
        agg = _narrow_first(fw, adj, x, fw.param(self.W_neigh))
        y = torch.matmul(x, fw.param(self.W_self)) + agg
        if self.b is not None:
            y = y + fw.param(self.b)
        if self.activation is not None:
            y = self.activation(y)
        if self.normalize:
            sumsq = torch.sum(torch.square(y), dim=1, keepdim=True)
            y = y * torch.rsqrt(torch.clamp(sumsq, min=1e-12))
        return fw.dropout(y, self.dropout_rate)


class GraphSAGE(GNN):
    """[SAGELayer(latent, relu)]* -> SAGELayer(C, linear), the transductive
    mean-aggregator recipe."""

    def __init__(self, G: Graph, features, num_classes: int,
                 latent_dims=(64,), dropout: float = 0.5,
                 normalize: bool = False, device="cuda", **kwargs):
        super().__init__(G, features, device=device, **kwargs)
        for latent_dim in latent_dims:
            self.add(SAGELayer(latent_dim, activation=torch.relu,
                               dropout=dropout, normalize=normalize))
        self.add(SAGELayer(num_classes, activation=None))


class GINLayer(Layer):
    """Graph isomorphism convolution:

        out = MLP( (1 + eps) * X + sum_{j in N(i)} X_j )

    with a 2-layer ReLU MLP and ``eps`` fixed or learnable (``train_eps``: a
    zero-initialized scalar parameter added to ``eps``)."""

    def build(self, net: Network, outputs: int, hidden: Optional[int] = None,
              eps: float = 0.0, train_eps: bool = True,
              activation: Callable = torch.relu,
              dropout: float = 0.0, graph_dropout: float = 0.0):
        n, d = net.top_shape()
        hidden = outputs if hidden is None else hidden
        self.W1 = net.create_param((d, hidden), "xavier")
        self.b1 = net.create_param((1, hidden), "zero")
        self.W2 = net.create_param((hidden, outputs), "xavier")
        self.b2 = net.create_param((1, outputs), "zero")
        self.eps0 = eps
        self.eps = net.create_param((1, 1), "zero") if train_eps else None
        self.activation = activation
        self.dropout_rate = dropout
        self.graph_dropout = graph_dropout
        return (n, outputs)

    def apply(self, fw: Forward, x):
        adj = fw.adjacency(self.graph_dropout, normalized="none",
                           add_eye="none")
        eps = self.eps0 if self.eps is None \
            else self.eps0 + fw.param(self.eps)[0, 0]
        y = (1.0 + eps) * x + fw.spmm(adj, x)
        y = self.activation(torch.matmul(y, fw.param(self.W1))
                            + fw.param(self.b1))
        y = torch.matmul(y, fw.param(self.W2)) + fw.param(self.b2)
        return fw.dropout(y, self.dropout_rate)


class GIN(GNN):
    """Dropout -> [GINLayer(latent)]* -> Dense(C), a node classifier."""

    def __init__(self, G: Graph, features, num_classes: int,
                 latent_dims=(64,), dropout: float = 0.5,
                 train_eps: bool = True, device="cuda", **kwargs):
        super().__init__(G, features, device=device, **kwargs)
        self.add(Dropout(dropout))
        for latent_dim in latent_dims:
            self.add(GINLayer(latent_dim, train_eps=train_eps,
                              dropout=dropout))
        self.add(Dense(num_classes, dropout=0, regularize=False))
