"""Graph representation: a COO edge list as torch tensors.

The edge list is sorted by destination row (``np.lexsort((col, row))``), so
the host-built SpMM layouts see edges in row order.  ``row`` is the
destination of a message and ``col`` its source: ``out = A @ X`` with row
``i`` aggregating columns ``j`` (reference gnntf/core/gnn/graph_manipulation.py).

**Lazy diagonal scaling** (``row_scale``/``col_scale``, per-node vectors):
the effective matrix is ``diag(row_scale) A diag(col_scale)``.
Normalization stores its degree vectors here and the SpMM applies them as
two (N, F) row-wise multiplies around the product,
``D ⊙ (A @ (D ⊙ x)) == (D A D) @ x`` up to float reassociation.  ``None``
means identity.

**Lazy counter-based edge dropout** (``drop_salt``/``drop_keep``/
``drop_n``): when ``drop_salt`` is set, the effective edge values are
``val[e] * mask(e) / drop_keep`` for ``e < drop_n`` and ``val[e]`` for the
trailing self-loop entries, where ``mask(e)`` is a hash of the edge id and
the two salts (``ops/stochastic.py``).  Applied before the lazy scales:
dropout comes before renormalization.

**Lazy post-scale identity** (``eye_weight``): the effective matrix is
``diag(row_scale) A diag(col_scale) + eye_weight * I`` — self-loops added
*after* normalization stay a ``+ w*x`` in the SpMM.

**Edge shards** (``global_edges``/``edge_offset``): a graph may hold one
rank's contiguous slice of a larger edge list
(``parallel.multihost.shard_graph_local``): its entries are the global
edges ``edge_offset ..`` of ``global_edges``.  Every count that edge
dropout takes (``n_drop``, the lazy-draw threshold) is the global one and
every hashed id is global, so the slices of one draw over the ranks are
the draw over the whole list.  Appended self-loops extend the global list
at its end: the last slice holds them.  A shard's products, degrees and
attention need an executor that all-reduces over the ranks
(``parallel.dist.GspmdExecutor``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.idcache import IdLRU


@dataclasses.dataclass(frozen=True, eq=False)
class Graph:
    """A sparse adjacency matrix ``A`` with ``A[row[e], col[e]] = val[e]``.

    ``num_self_loop`` counts the *trailing* entries appended by
    :func:`add_self_loops` (edge dropout leaves them alone, reference
    gnn.py:37-39)."""

    row: torch.Tensor            # [E] int64 destination ids
    col: torch.Tensor            # [E] int64 source ids
    val: torch.Tensor            # [E] float edge weights
    n_nodes: int
    num_self_loop: int = 0
    sorted_by_row: bool = False
    row_scale: Optional[torch.Tensor] = None   # [N] or None (identity)
    col_scale: Optional[torch.Tensor] = None   # [N] or None (identity)
    drop_salt: Optional[torch.Tensor] = None   # (2,) int64 uint32 values
    drop_keep: float = 1.0
    drop_n: int = 0
    eye_weight: float = 0.0
    edge_offset: int = 0                       # a shard's first global id
    global_edges: Optional[int] = None         # None: not a shard

    @property
    def n_edges(self) -> int:
        return int(self.row.shape[0])

    @property
    def is_shard(self) -> bool:
        return self.global_edges is not None

    @property
    def n_edges_global(self) -> int:
        """The whole edge list's length: a shard's ``global_edges``, else
        :attr:`n_edges`."""
        return self.n_edges if self.global_edges is None \
            else self.global_edges

    @property
    def shape(self):
        return (self.n_nodes, self.n_nodes)

    @property
    def scaled(self) -> bool:
        return self.row_scale is not None or self.col_scale is not None

    @property
    def dropped(self) -> bool:
        return self.drop_salt is not None

    @property
    def device(self) -> torch.device:
        return self.val.device

    def to(self, device) -> "Graph":
        """The same graph with every tensor on ``device``."""
        device = resolve_device(device)
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, row=move(self.row), col=move(self.col), val=move(self.val),
            row_scale=move(self.row_scale), col_scale=move(self.col_scale),
            drop_salt=move(self.drop_salt))

    def materialized_dropout(self) -> "Graph":
        """Fold the lazy edge dropout into per-edge values (the scales stay
        lazy)."""
        if not self.dropped:
            return self
        from ..ops.stochastic import materialize_dropped
        return dataclasses.replace(self, val=materialize_dropped(self),
                                   drop_salt=None, drop_keep=1.0, drop_n=0)

    def materialized(self) -> "Graph":
        """Fold the lazy dropout, diagonal scales and post-scale identity
        into per-edge values (for inspection, tests and re-normalization)."""
        g = self.materialized_dropout()
        if g.scaled:
            val = g.val
            if g.row_scale is not None:
                val = val * g.row_scale[g.row].to(val.dtype)
            if g.col_scale is not None:
                val = val * g.col_scale[g.col].to(val.dtype)
            g = dataclasses.replace(g, val=val, row_scale=None,
                                    col_scale=None)
        if g.eye_weight != 0.0:
            g = _append_eye(dataclasses.replace(g, eye_weight=0.0),
                            g.eye_weight)
        return g

    def to_dense(self) -> torch.Tensor:
        """Densify (testing only)."""
        g = self.materialized()
        a = torch.zeros(g.n_nodes * g.n_nodes, dtype=g.val.dtype,
                        device=g.device)
        a.index_add_(0, g.row * g.n_nodes + g.col, g.val)
        return a.view(g.n_nodes, g.n_nodes)


# from_edges sorts this many edges or more with the C++ radix sort
# (utils/native.py::lexsort_edges, the same order), as the JAX package does
_NATIVE_SORT_EDGES = 100_000


def from_edges(src, dst, values=None, *, n_nodes: Optional[int] = None,
               directed: bool = True, sort: bool = True,
               dtype=torch.float32, device="cuda") -> Graph:
    """Build a :class:`Graph` from edge arrays.

    With ``directed=False`` the reversed edges are appended (duplicates sum —
    reference convention, graph_manipulation.py:29).  With ``sort`` the
    edges are stably sorted by (row, col), in C++ at or above
    ``_NATIVE_SORT_EDGES`` edges where the library builds.  Values are
    float64 on the host and cast to ``dtype``."""
    device = resolve_device(device)
    src = np.asarray(src, np.int32).reshape(-1)
    dst = np.asarray(dst, np.int32).reshape(-1)
    if values is None:
        values = np.ones(src.shape[0], np.float64)
    values = np.asarray(values, np.float64).reshape(-1)
    if src.shape != dst.shape or src.shape != values.shape:
        raise ValueError("src/dst/values must have the same length")
    if n_nodes is None:
        n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    row, col = src, dst
    if not directed:
        row = np.concatenate([src, dst])
        col = np.concatenate([dst, src])
        values = np.concatenate([values, values])
    if sort:
        order = None
        if row.shape[0] >= _NATIVE_SORT_EDGES:
            from ..utils.native import lexsort_edges
            order = lexsort_edges(row, col)
        if order is None:
            order = np.lexsort((col, row))
        row, col, values = row[order], col[order], values[order]
    return Graph(
        row=torch.from_numpy(row.astype(np.int64)).to(device),
        col=torch.from_numpy(col.astype(np.int64)).to(device),
        val=torch.from_numpy(values).to(dtype).to(device),
        n_nodes=n_nodes,
        sorted_by_row=sort,
    )


def _append_eye(graph: Graph, weight: float) -> Graph:
    """Structurally append N identity entries to an *unscaled* graph: to a
    shard, at the end of the global list, so only the last slice holds
    them."""
    n = graph.n_nodes
    if graph.is_shard:
        last = graph.edge_offset + graph.n_edges == graph.global_edges
        graph = dataclasses.replace(graph,
                                    global_edges=graph.global_edges + n)
        if not last:
            return dataclasses.replace(
                graph, num_self_loop=graph.num_self_loop + n)
    eye = torch.arange(n, dtype=graph.row.dtype, device=graph.device)
    return dataclasses.replace(
        graph,
        row=torch.cat([graph.row, eye]),
        col=torch.cat([graph.col, eye]),
        val=torch.cat([graph.val, torch.full((n,), weight,
                                             dtype=graph.val.dtype,
                                             device=graph.device)]),
        num_self_loop=graph.num_self_loop + n,
        sorted_by_row=False,
    )


# The extended structures of add_self_loops, memoized so that every layer
# and step shares one extension and the identity-keyed layout and grid
# caches hit (the JAX package's _EYE_CACHE).
_EYE_CACHE = IdLRU()


def add_self_loops(graph: Graph, weight: float = 1.0) -> Graph:
    """Add ``weight * I`` (reference gnn.py:38-39, :48-49).

    A *scaled* graph (``add_eye='after'``) keeps the identity lazy as
    ``eye_weight``; an unscaled one (``add_eye='before'``) gets N entries
    appended, counted in ``num_self_loop``.  The extension is built once per
    (``row``, ``col``, ``val``, ``weight``, ``num_self_loop``, ``n_nodes``),
    memoized on the tensors' identity, and the caller's lazy dropout is
    reattached to it."""
    if graph.scaled:
        return dataclasses.replace(graph,
                                   eye_weight=graph.eye_weight + weight)
    key = ("eye", id(graph.row), id(graph.col), id(graph.val), float(weight),
           graph.num_self_loop, graph.n_nodes, graph.edge_offset,
           graph.global_edges)
    anchors = (graph.row, graph.col, graph.val)
    ext = _EYE_CACHE.get(key, anchors)
    if ext is None:
        ext = _append_eye(dataclasses.replace(
            graph, drop_salt=None, drop_keep=1.0, drop_n=0), weight)
        _EYE_CACHE.put(key, anchors, ext)
    return dataclasses.replace(ext, drop_salt=graph.drop_salt,
                               drop_keep=graph.drop_keep,
                               drop_n=graph.drop_n)
