"""Graph propagation layers (reference: gnntf/core/gnn/architectures/*.py).
Aggregation goes through the model's SpMM operator for its normalized
adjacency (``Forward.adjacency`` / ``Forward.spmm``)."""
from __future__ import annotations

from typing import Callable, Union

import torch

from ..nn.core import Forward, Layer, Network


def _identity(x):
    return x


class PPRIteration(Layer):
    """One personalized-PageRank propagation step (reference
    filter.py:6-22):

        out = act( dropout( (1-a) * (A_hat @ X) + a * H0 ) )

    ``restart_probability`` may be a float or the name of a learnable scalar
    parameter (APPNP's ``a=None`` mode); ``restart_transform`` hooks its
    post-processing."""

    def build(self, net: Network, H0: Layer,
              restart_probability: Union[float, str] = 0.1,
              activation: Callable = _identity, dropout: float = 0.0,
              graph_dropout: float = 0.5,
              restart_transform: Callable = _identity):
        self.H0 = H0
        self.restart_probability = restart_probability
        self.activation = activation
        self.dropout_rate = dropout
        self.graph_dropout = graph_dropout
        self.restart_transform = restart_transform
        return net.top_shape()

    def apply(self, fw: Forward, x):
        adj = fw.adjacency(self.graph_dropout)
        propagated = fw.spmm(adj, x)
        a = self.restart_probability
        if isinstance(a, str):  # learnable (1,1) scalar parameter
            a = fw.param(a)
        a = self.restart_transform(a)
        out = propagated * (1.0 - a) + fw.value_of(self.H0) * a
        return self.activation(fw.dropout(out, self.dropout_rate))


def _narrow_first(fw: Forward, adj, x, W):
    """``A @ x @ W`` with the SpMM at the narrower width, by the JAX
    package's test: ``A @ (x @ W)`` when ``W`` narrows (more rows than
    columns), else ``(A @ x) @ W``."""
    if W.shape[0] > W.shape[1]:
        return fw.spmm(adj, torch.matmul(x, W))
    return torch.matmul(fw.spmm(adj, x), W)


class GCNLayer(Layer):
    """Aggregate-then-transform GCN convolution (reference gcn.py:77-89):
    ``out = dropout(act(A_hat @ X @ W + b))``, the SpMM at the narrower
    width."""

    def build(self, net: Network, outputs: int,
              activation: Callable = torch.relu, bias: bool = True,
              dropout: float = 0.0, graph_dropout: float = 0.0):
        n, d = net.top_shape()
        self.W = net.create_param((d, outputs))
        self.b = net.create_param((1, outputs), "zero") if bias else None
        self.activation = activation
        self.dropout_rate = dropout
        self.graph_dropout = graph_dropout
        return (n, outputs)

    def apply(self, fw: Forward, x):
        adj = fw.adjacency(self.graph_dropout)
        y = _narrow_first(fw, adj, x, fw.param(self.W))
        if self.b is not None:
            y = y + fw.param(self.b)
        return fw.dropout(self.activation(y), self.dropout_rate)


class GCNSpectralPreservingLayer(GCNLayer):
    """GCN variant emitting ``2 * dropout(act(A_hat @ X @ W + b) - b)``
    (reference gcn.py:95-113)."""

    def apply(self, fw: Forward, x):
        adj = fw.adjacency(self.graph_dropout)
        b = fw.param(self.b) if self.b is not None else 0.0
        y = _narrow_first(fw, adj, x, fw.param(self.W)) + b
        return 2.0 * fw.dropout(self.activation(y) - b, self.dropout_rate)


class GCNIILayer(Layer):
    """GCNII convolution with initial residual and identity mapping
    (reference gcn.py:7-27):

        beta = log1p(l / (k+1))
        out  = dropout( act( ((1-a)*A_hat@X + a*H0) @ ((1-beta)I + beta*W) ) )

    ``beta`` is a float32 value (``beta_transformer`` of the float32 ratio),
    so the mix rounds as the JAX package's does.  W is zero-initialized
    (gcn.py:11)."""

    def build(self, net: Network, H0: Layer, a: float, l: float, k: int = 0,
              activation: Callable = _identity,
              beta_transformer: Callable = torch.log1p,
              dropout: float = 0.5, graph_dropout: float = 0.5,
              regularization: bool = True):
        n, d = net.top_shape()
        self.W = net.create_param((d, d), "zero", regularize=regularization)
        self.H0 = H0
        self.a, self.l, self.k = a, l, k
        self.activation = activation
        self.beta = beta_transformer(
            torch.tensor(l / (k + 1), dtype=torch.float32)).to(net.device)
        self.dropout_rate = dropout
        self.graph_dropout = graph_dropout
        return (n, d)

    def _mixed(self, fw: Forward, x):
        """``tradeoff @ mix``, the propagation and the identity mapping."""
        adj = fw.adjacency(self.graph_dropout)
        agg = fw.spmm(adj, x)
        tradeoff = (1.0 - self.a) * agg + self.a * fw.value_of(self.H0)
        W, b = fw.param(self.W), self.beta
        eye = torch.eye(W.shape[1], dtype=W.dtype, device=W.device)
        return torch.matmul(tradeoff, (1.0 - b) * eye + b * W)

    def apply(self, fw: Forward, x):
        return fw.dropout(self.activation(self._mixed(fw, x)),
                          self.dropout_rate)


class GCNIISpectralPreservingLayer(GCNIILayer):
    """GCNII variant with a bias, emitting ``2 * dropout(act(.. + bias) -
    bias)`` (reference gcn.py:30-52)."""

    def build(self, net: Network, *args, **kwargs):
        shape = super().build(net, *args, **kwargs)
        self.bias = net.create_param((1, shape[1]), "zero")
        return shape

    def apply(self, fw: Forward, x):
        bias = fw.param(self.bias)
        y = self._mixed(fw, x) + bias
        return 2.0 * fw.dropout(self.activation(y) - bias, self.dropout_rate)


def _leaky_relu(x):
    return torch.nn.functional.leaky_relu(x, negative_slope=0.2)


def l2_normalize(x):
    """Row-wise ``x * rsqrt(max(sum(x^2), 1e-12))``
    (``tf.math.l2_normalize``)."""
    sumsq = torch.sum(torch.square(x), dim=1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sumsq, min=1e-12))


class NGCFLayer(Layer):
    """NGCF recommendation convolution (reference gcn.py:116-135):

        out = l2_normalize(dropout( act((X (.) A_hat X) W1 + b1)
                                  + act((A_hat X) W2 + b2) ))

    over the bipartite (``D^-1 A``) adjacency without self-loops; the
    activation defaults to ``leaky_relu(0.2)``.  ``node_dropout > 0`` draws
    a fresh edge dropout every step, as in the JAX package."""

    def build(self, net: Network, outputs: int,
              activation: Callable = None, bias: bool = True,
              dropout: float = 0.0, node_dropout: float = 0.0,
              regularize: float = 1.0):
        n, d = net.top_shape()
        scale = 1.0 / (n ** 0.5)
        self.W1 = net.create_param((d, outputs), scale, regularize=regularize)
        self.W2 = net.create_param((d, outputs), scale, regularize=regularize)
        self.b1 = net.create_param((1, outputs), scale) if bias else None
        self.b2 = net.create_param((1, outputs), scale) if bias else None
        self.activation = _leaky_relu if activation is None else activation
        self.dropout_rate = dropout
        self.node_dropout = node_dropout
        return (n, outputs)

    def apply(self, fw: Forward, x):
        adj = fw.adjacency(self.node_dropout, normalized="bipartite",
                           add_eye="none")
        agg = fw.spmm(adj, x)
        y1 = torch.matmul(x * agg, fw.param(self.W1))
        y2 = torch.matmul(agg, fw.param(self.W2))
        if self.b1 is not None:
            y1 = y1 + fw.param(self.b1)
            y2 = y2 + fw.param(self.b2)
        out = self.activation(y1) + self.activation(y2)
        return l2_normalize(fw.dropout(out, self.dropout_rate))
