"""Graph attention network (GAT; the JAX package's ``models/gat.py``).

A layer: the dense projection ``h = x @ W``, the per-node score halves
``s = <h, a>`` per head, then the attention chain of ``ops/attention.py``
(scores, segment softmax over each destination's incoming edges, the
weighted aggregation), on the graph with its self-loops.
"""
from __future__ import annotations

import torch

from ..graph.coo import Graph, add_self_loops
from ..nn.core import Forward, Layer, Network
from ..nn.layers import Dropout
from ..ops.attention import gat_attention
from .gnn import GNN


class GATLayer(Layer):
    """Multi-head graph attention (Velickovic et al., arXiv:1710.10903).

    ``concat_heads=True`` concatenates head outputs (hidden layers);
    ``False`` averages them (output layer).  In training,
    ``attn_dropout`` drops attention coefficients per (edge, head) with a
    salt pair drawn by :meth:`Forward.attention_salt`."""

    def build(self, net: Network, outputs: int, heads: int = 8,
              concat_heads: bool = True, activation=None,
              dropout: float = 0.0, attn_dropout: float = 0.0,
              negative_slope: float = 0.2, self_loops: bool = True,
              bias: bool = True):
        n, d = net.top_shape()
        self.W = net.create_param((d, heads * outputs), "xavier")
        self.a_src = net.create_param((heads, outputs), "xavier")
        self.a_dst = net.create_param((heads, outputs), "xavier")
        width = heads * outputs if concat_heads else outputs
        self.b = net.create_param((1, width), "zero") if bias else None
        self.heads, self.out_dim = heads, outputs
        self.concat_heads = concat_heads
        self.activation = activation
        self.dropout_rate = dropout
        self.attn_dropout = attn_dropout
        self.negative_slope = negative_slope
        self.self_loops = self_loops
        return (n, width)

    def apply(self, fw: Forward, x):
        graph: Graph = fw.graph
        if graph.scaled or graph.eye_weight != 0.0:
            # attention reads the raw structure: fold any lazy normalization
            # so that appended self-loops appear as real entries
            graph = graph.materialized()
        if self.self_loops:
            # memoized, so the attention grids' cache hits across layers
            graph = add_self_loops(graph)
        n, h_cnt, f = graph.n_nodes, self.heads, self.out_dim
        h = torch.matmul(x, fw.param(self.W)).reshape(n, h_cnt, f)
        s_src = torch.einsum("nhf,hf->nh", h, fw.param(self.a_src))
        s_dst = torch.einsum("nhf,hf->nh", h, fw.param(self.a_dst))
        drop = self.attn_dropout if fw.training else 0.0
        salt = fw.attention_salt() if drop else None
        out = gat_attention(graph, h, s_src, s_dst,
                            negative_slope=self.negative_slope,
                            attn_dropout=drop, salt=salt,
                            sorted_by_row=graph.sorted_by_row)
        out = out.reshape(n, h_cnt * f) if self.concat_heads \
            else torch.mean(out, dim=1)
        if self.b is not None:
            out = out + fw.param(self.b)
        if self.activation is not None:
            out = self.activation(out)
        return fw.dropout(out, self.dropout_rate)


class GAT(GNN):
    """Two-layer GAT: ``heads`` heads of ``latent`` units with ELU and
    concatenation, then one averaged head over the classes (the GAT paper's
    transductive recipe)."""

    def __init__(self, G: Graph, features, num_classes: int,
                 latent_dims=(8,), heads: int = 8, dropout: float = 0.6,
                 attn_dropout: float = 0.6, device="cuda", **kwargs):
        super().__init__(G, features, device=device, **kwargs)
        self.add(Dropout(dropout))
        for latent_dim in latent_dims:
            self.add(GATLayer(latent_dim, heads=heads, concat_heads=True,
                              activation=torch.nn.functional.elu,
                              dropout=dropout, attn_dropout=attn_dropout))
        self.add(GATLayer(num_classes, heads=1, concat_heads=False,
                          attn_dropout=attn_dropout))
