"""Adjacency normalization (reference ``GNN.get_adjacency``,
gnntf/core/gnn/gnn.py:36-50).

  1. edge dropout on the edge values, self-loop entries excepted: lazy salts
     and the counter hash of ``ops/stochastic.py`` at or above
     ``min_edges()`` edges, an eager Bernoulli draw below;
  2. optional self-loops *before* normalization (``add_eye='before'``);
  3. normalization, returned *lazily* as per-node scales:
       * ``symmetric``:  D = rsqrt(colsum) where colsum > 0, else 0;
                         A <- D[i]·A[ij]·D[j]
       * ``bipartite``:  D = 1/colsum (0 where colsum == 0); A <- D[i]·A[ij]
       * ``row``:        D = 1/rowsum (0 where rowsum == 0); A <- D[i]·A[ij]
       * ``none``:       passthrough
  4. optional self-loops *after* normalization (``add_eye='after'``), kept
     lazy as ``eye_weight``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..graph.coo import Graph, add_self_loops
from .spmm import current_executor, edge_degree
from .stochastic import (draw_salt, draw_uniform, grids_eligible,
                         stochastic_degree)


def _degree(graph: Graph, by: str = "col") -> torch.Tensor:
    """Column sums ``deg[j] = sum_i A[i, j]``; ``by='row'`` gives row sums.
    A lazily dropped graph at or above ``min_edges()`` edges takes the
    degree walk over its training grids' column (or row) list, as the JAX
    package takes its grid reduction; below, the materialized dropped values
    are summed by ``spmm.edge_degree`` (below 65,536 edges on a card the
    store-mode walk, no atomics).  An executor in force that offers
    ``degree`` (``parallel.dist.GspmdExecutor``: each rank's partial over
    its slice of the edges, summed over the ranks) computes them; an edge
    shard needs one.  A lazy ``eye_weight`` adds to every degree."""
    executor = current_executor()
    if executor is not None and hasattr(executor, "degree"):
        deg = executor.degree(graph, by=by)
    elif graph.is_shard:
        raise ValueError("the degrees of an edge shard need the gspmd "
                         "executor in force (parallel.dist.GspmdExecutor)")
    elif graph.dropped and grids_eligible(graph):
        deg = stochastic_degree(graph, by=by)
    else:
        deg = edge_degree(graph.materialized_dropout(), by=by)
    if graph.eye_weight != 0.0:
        deg = deg + graph.eye_weight
    return deg


def edge_dropout(graph: Graph, rate: float,
                 generator: Optional[torch.Generator]) -> Graph:
    """Dropout on the edge values; the trailing self-loop entries are never
    dropped.  ``generator`` is a CPU generator, so the masks of a run are the
    same on every device (or a draw tape, which feeds a replayed epoch):
    where the training grids take the graph (``grids_eligible``: at or above
    ``min_edges()`` edges) it draws the two salts of a lazy draw, put on the
    graph's device (``stochastic.draw_salt``), elsewhere an eager Bernoulli
    mask."""
    if rate == 0.0 or generator is None:
        return graph
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    keep = 1.0 - rate
    n_drop = graph.n_edges_global - graph.num_self_loop
    if grids_eligible(graph) and not graph.dropped:
        return dataclasses.replace(
            graph, drop_salt=draw_salt(generator, graph.device),
            drop_keep=keep, drop_n=n_drop)
    graph = graph.materialized_dropout()  # stacking draws: realize the first
    # one draw over the whole list; a shard keeps its slice of it
    lo = graph.edge_offset
    held = min(max(n_drop - lo, 0), graph.n_edges)
    mask = (draw_uniform(generator, n_drop, graph.device) < keep)[
        lo:lo + held]
    head = graph.val[:held]
    val = torch.cat([torch.where(mask, head / keep, torch.zeros_like(head)),
                     graph.val[held:]])
    return dataclasses.replace(graph, val=val)


def normalize_adjacency(
    graph: Graph,
    *,
    graph_dropout: float = 0.5,
    normalized: str = "symmetric",
    add_eye: str = "none",
    generator: Optional[torch.Generator] = None,
) -> Graph:
    """The normalized adjacency.  Pass ``generator=None`` (or
    ``graph_dropout=0``) for the deterministic (inference) path; otherwise
    ``generator`` is the CPU generator that edge dropout draws from."""
    if graph.scaled or graph.eye_weight != 0.0:
        # normalizing an already-normalized graph: fold the scales first so
        # degrees see the effective values
        graph = graph.materialized()
    graph = edge_dropout(graph, graph_dropout, generator)
    if add_eye == "before":
        graph = add_self_loops(graph)
    elif add_eye not in ("none", "after"):
        raise ValueError(f"Invalid add_eye: {add_eye!r}")
    if normalized == "symmetric":
        deg = _degree(graph)
        d = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)),
                        0.0)
        graph = dataclasses.replace(graph, row_scale=d.to(graph.val.dtype),
                                    col_scale=d.to(graph.val.dtype))
    elif normalized in ("bipartite", "row"):
        deg = _degree(graph, by="col" if normalized == "bipartite" else "row")
        d = torch.where(deg != 0,
                        1.0 / torch.where(deg == 0, 1.0, deg), 0.0)
        graph = dataclasses.replace(graph, row_scale=d.to(graph.val.dtype))
    elif normalized != "none":
        raise ValueError(f"Invalid matrix normalization: {normalized!r}")
    if add_eye == "after":
        graph = add_self_loops(graph)
    return graph
