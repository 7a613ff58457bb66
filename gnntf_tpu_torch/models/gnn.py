"""GNN base model (reference: gnntf/core/gnn/gnn.py)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..graph.coo import Graph
from ..nn.core import Layer
from ..ops.normalize import normalize_adjacency
from ..ops.spmm import current_impl, prepare, spmm
from ..train.trainer import Trainable


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
        adjacencies of the implementation in force, else the dispatching
        ``spmm``."""
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
