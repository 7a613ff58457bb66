"""Locality-improving node reorderings (numpy, a copy of the JAX package's
so the permutations are bit-equal).

The blocked-COO SpMM (``ops/blocked.py``) pays off when edges cluster into
(row-window, col-tile) blocks; reverse Cuthill–McKee exposes the community
structure of a graph as a narrow band around the diagonal.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .coo import Graph, from_edges


def rcm_order(graph: Graph) -> np.ndarray:
    """Reverse Cuthill–McKee permutation: ``perm[new_id] = old_id``.

    BFS from lowest-degree nodes, neighbors visited degree-ascending, then
    the visitation order is reversed."""
    n = graph.n_nodes
    row = graph.row.cpu().numpy()
    col = graph.col.cpu().numpy()
    order = np.argsort(row, kind="stable")
    r, c = row[order], col[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr)
    degree = np.diff(indptr)

    visited = np.zeros(n, dtype=bool)
    result = np.empty(n, dtype=np.int64)
    pos = 0
    seeds = np.argsort(degree, kind="stable")
    for seed in seeds:
        if visited[seed]:
            continue
        visited[seed] = True
        result[pos] = seed
        head = pos
        pos += 1
        while head < pos:
            u = result[head]
            head += 1
            nbrs = c[indptr[u]:indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = np.unique(nbrs)
                nbrs = nbrs[~visited[nbrs]]
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                result[pos:pos + len(nbrs)] = nbrs
                pos += len(nbrs)
    return result[::-1].copy()


def permute_graph(graph: Graph, perm: np.ndarray) -> Tuple[Graph, np.ndarray]:
    """Relabel nodes by ``perm`` (``perm[new_id] = old_id``), on the graph's
    device.  Returns the permuted graph and the inverse mapping
    ``inv[old_id] = new_id``: ``x_new = x_old[perm]``, node ids map through
    ``inv[ids]``."""
    n = graph.n_nodes
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    row = inv[graph.row.cpu().numpy()]
    col = inv[graph.col.cpu().numpy()]
    g = from_edges(row, col, graph.val.cpu().numpy(), n_nodes=n,
                   directed=True, dtype=graph.val.dtype, device=graph.device)
    return g, inv


def bandwidth(graph: Graph) -> int:
    """Max |row - col| over the edges — the quantity RCM minimises."""
    if graph.n_edges == 0:
        return 0
    return int((graph.row - graph.col).abs().max())
