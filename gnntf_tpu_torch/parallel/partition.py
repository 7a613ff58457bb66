"""Host-side graph padding for multi-rank execution (the JAX package's
``parallel/partition.py``).

Edges are sharded across ranks in contiguous slices of the edge list.  The
list is padded to a multiple of the rank count with (0, 0, 0.0) entries,
whose zero value contributes nothing to degrees or products.
"""
from __future__ import annotations

import torch

from ..graph.coo import Graph


def pad_graph(graph: Graph, multiple: int) -> Graph:
    """The edge list padded to a multiple of ``multiple`` with zero-valued
    (0, 0) entries appended at the end (lazy dropout and scales folded in
    first); a graph already at a multiple is returned as it is.  The padded
    graph keeps ``num_self_loop`` and is marked ``sorted_by_row=False``."""
    e = graph.n_edges
    target = ((e + multiple - 1) // multiple) * multiple
    if target == e:
        return graph
    pad = target - e
    graph = graph.materialized()  # padding operates on per-edge values
    zeros = torch.zeros(pad, dtype=graph.row.dtype, device=graph.device)
    return Graph(
        row=torch.cat([graph.row, zeros]),
        col=torch.cat([graph.col, zeros]),
        val=torch.cat([graph.val, torch.zeros(pad, dtype=graph.val.dtype,
                                              device=graph.device)]),
        n_nodes=graph.n_nodes,
        num_self_loop=graph.num_self_loop,
        sorted_by_row=False,
    )
