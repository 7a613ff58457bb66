"""GNN base model and the Structural embedding preprocessor (reference:
gnntf/core/gnn/gnn.py)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..graph.coo import Graph
from ..nn.core import Forward, Layer, Network
from ..ops.normalize import normalize_adjacency
from ..ops.spmm import current_executor, current_impl, prepare, spmm
from ..train.trainer import Trainable
from .layers import l2_normalize


class GNN(Trainable):
    """A Trainable bound to a sparse adjacency (reference gnn.py:29-34).

    The adjacency is fixed, so each normalized form that a layer asks for
    is built once on the model's device, together with its SpMM operator
    under the implementation in force, and held here, keyed by
    ``(normalized, add_eye, impl)``."""

    def __init__(self, graph: Graph, features,
                 preprocessor: Optional[Layer] = None, device="cuda"):
        super().__init__(features, device)
        if not isinstance(graph, Graph):
            raise TypeError("GNN expects a gnntf_tpu_torch Graph "
                            "(see graph2adj)")
        self.graph = graph.to(self.device)
        self._adjacency: Dict[Tuple[str, str, str],
                              Tuple[Graph, Callable]] = {}
        if preprocessor is not None:
            self.add(preprocessor)

    def adjacency(self, normalized: str = "symmetric",
                  add_eye: str = "none") -> Graph:
        """The cached deterministic normalized adjacency for the SpMM
        implementation in force."""
        impl = current_impl()
        key = (normalized, add_eye, impl)
        if key not in self._adjacency:
            graph = normalize_adjacency(self.graph, graph_dropout=0.0,
                                        normalized=normalized,
                                        add_eye=add_eye)
            self._adjacency[key] = (graph, prepare(graph, impl))
        return self._adjacency[key][0]

    def operator(self, graph: Graph) -> Callable[[torch.Tensor], torch.Tensor]:
        """The cached ``x -> graph @ x`` when ``graph`` is one of the cached
        adjacencies of the implementation in force and no executor override
        is in force, else the dispatching ``spmm``."""
        if current_executor() is not None:
            return lambda x: spmm(graph, x)
        impl = current_impl()
        for (_, _, key_impl), (cached, op) in self._adjacency.items():
            if cached is graph and key_impl == impl:
                return op
        return lambda x: spmm(graph, x)

    def get_adjacency(self, graph_dropout: float = 0.5,
                      normalized: str = "symmetric", add_eye: str = "none"):
        """Deterministic normalized adjacency with per-edge values, for
        host-side inspection."""
        return normalize_adjacency(self.graph, graph_dropout=0.0,
                                   normalized=normalized,
                                   add_eye=add_eye).materialized()


class Structural(Layer):
    """Free learnable node embeddings, optionally split into two bipartite
    tables and optionally L2-normalized, concatenated feature-wise before
    the input (pure-structural mode when the input width is 0) (reference
    gnn.py:5-26).  Used as ``preprocessor=`` for featureless or
    recommendation graphs; ``kwargs`` go to ``create_param``."""

    def build(self, net: Network, dims: int = 16, l2_contraint: bool = False,
              bipartite: int = 0, **kwargs):
        n, d = net.top_shape()
        self.l2_contraint = l2_contraint
        self.emb_a = net.create_param((bipartite, dims), **kwargs)
        self.emb_b = net.create_param((n - bipartite, dims), **kwargs)
        self.bipartite = bipartite
        return (n, dims + d)

    def apply(self, fw: Forward, x):
        emb = fw.param(self.emb_b)
        if self.bipartite != 0:
            emb = torch.cat([fw.param(self.emb_a), emb], dim=0)
        if self.l2_contraint:
            emb = l2_normalize(emb)
        if x.shape[1] == 0:
            return emb
        return torch.cat([emb, x], dim=1)
