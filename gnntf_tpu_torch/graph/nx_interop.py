"""networkx interop (reference: gnntf/core/gnn/graph_manipulation.py,
create_nx_graph :5-12, adj2graph :15-16, graph2indices :19-21, graph2adj
:24-31).  networkx is imported only inside :func:`create_nx_graph` (and so
:func:`adj2graph`); the other functions only call methods of the graph they
are given.
"""
from __future__ import annotations

import numpy as np
import torch

from .coo import Graph, from_edges


def create_nx_graph(nodes, edges):
    """A directed networkx graph from node and edge lists."""
    import networkx as nx

    graph = nx.DiGraph()
    if nodes is not None:
        graph.add_nodes_from(nodes)
    graph.add_edges_from(edges)
    return graph


def graph2indices(G):
    """Map node objects to dense ids in graph-iteration order; features and
    labels rows follow ``list(G)`` order."""
    node2id = {u: idx for idx, u in enumerate(G)}
    return [[node2id[u], node2id[v]] for u, v in G.edges()]


def graph2adj(G, directed: bool = False, dtype=torch.float32,
              device="cuda") -> Graph:
    """networkx graph -> :class:`Graph`: edge weights from the ``weight``
    attribute (default 1.0); with ``directed=False`` reversed edges are
    *appended*, so a reciprocal pair yields summed (value-2) entries."""
    indices = np.asarray(graph2indices(G), np.int32).reshape(-1, 2)
    values = np.asarray(
        [data.get("weight", 1.0) for _, _, data in G.edges(data=True)],
        np.float64)
    return from_edges(indices[:, 0], indices[:, 1], values,
                      n_nodes=len(G), directed=directed, dtype=dtype,
                      device=device)


def adj2graph(nodes, adj: Graph):
    """The inverse of :func:`graph2adj`: the edge list only, weights
    dropped."""
    row = adj.row.cpu().numpy()
    col = adj.col.cpu().numpy()
    return create_nx_graph(nodes, list(zip(row.tolist(), col.tolist())))
