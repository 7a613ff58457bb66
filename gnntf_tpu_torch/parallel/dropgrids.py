"""Edge values and edge dropout for the distributed executors (the JAX
package's ``parallel/dropgrids.py``, in the port's form).

An edge's dropout decision is a pure hash of its id and the step's salts,
so any layout that keeps each edge's *global* id recomputes the realized
mask locally.  The JAX package routes the base values into each plan's
padded grid once and hashes the grid's ids inside the shard_map region.
The port's executors walk lists instead: each rank's lists
(:func:`rank_lists`) carry the global id of every edge as ``eid``, through
which the walks read the graph's own values (realized, or the base values
of a lazy draw, hashed in the masked walk).  No per-edge value is routed
or moved between ranks.

:func:`plan_value_grids` gives a plan's grids as the JAX package builds
them (the base values and the global ids by slot), from which the rank
lists take their ids; padding slots carry value 0 and id 0 and are left out
of the lists.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph.coo import Graph
from ..ops.blocked import blocked_spmm
from ..ops.ell_gather import ell_gather_masked, pair_lists
from ..utils.idcache import IdLRU

_GRID_CACHE = IdLRU()


def slot_ids(plan, shape):
    """``(eid_grid, live)`` of ``plan`` (any partition exposing
    ``edge_slot``/``n_edges``) shaped like its edge grid: each slot's global
    edge id (uint32, 0 in padding) and whether it holds an edge.  Cached on
    the identity of ``plan.edge_slot``."""
    key = ("slots", id(plan.edge_slot), tuple(shape))
    hit = _GRID_CACHE.get(key, (plan.edge_slot,))
    if hit is None:
        n_slots = int(np.prod(shape))
        eid = np.zeros(n_slots, np.uint32)
        eid[plan.edge_slot] = np.arange(plan.n_edges, dtype=np.uint32)
        live = np.zeros(n_slots, bool)
        live[plan.edge_slot] = True
        hit = (eid.reshape(shape), live.reshape(shape))
        _GRID_CACHE.put(key, (plan.edge_slot,), hit)
    return hit


def plan_value_grids(plan, graph: Graph, shape):
    """``(val_grid, eid_grid)`` for ``plan`` shaped like its edge grid, as
    the JAX package's: the base values of ``graph`` routed into their slots
    (a tensor on the graph's device, zeros in padding) and the slot -> edge
    id grid (numpy).  Cached per (plan, values) identity."""
    key = ("plangrid", id(plan.edge_slot), id(graph.val), tuple(shape))
    anchors = (plan.edge_slot, graph.val)
    hit = _GRID_CACHE.get(key, anchors)
    if hit is None:
        eid, _ = slot_ids(plan, shape)
        vg = torch.zeros(eid.size, dtype=graph.val.dtype, device=graph.device)
        vg[torch.from_numpy(plan.edge_slot).to(graph.device)] = \
            graph.val.detach()
        hit = (vg.reshape(shape), eid)
        _GRID_CACHE.put(key, anchors, hit)
    return hit


def executor_drop_state(graph: Graph):
    """``(val, draw)`` of the edges the executor walks: for a lazily dropped
    graph its float32 base values and ``(salt, keep, n_drop)``, hashed in
    the masked walk; else its realized values and None."""
    if graph.dropped:
        return (graph.val.to(torch.float32).contiguous(),
                (graph.drop_salt, graph.drop_keep, graph.drop_n))
    return graph.val.to(torch.float32).contiguous(), None


def rank_walk(lst, val: torch.Tensor, draw, x: torch.Tensor) -> torch.Tensor:
    """One rank's product over ``lst``: K2's store-mode walk with the
    realized values ``val`` (read by the list's ids), or with a ``draw``
    ``(salt, keep, n_drop[, id_base])`` K1's masked walk over the base
    values, the mask hashed at ``id_base`` plus the list's id.  On the CPU
    the plain versions."""
    x = x.to(torch.float32).contiguous()
    if draw is None:
        return blocked_spmm(lst, val, x)
    salt, keep, n_drop, *base = draw
    return ell_gather_masked(lst, val, salt, keep, n_drop, x, *base)


def rank_lists(dst, src, eid, n_out: int, n_in: int, n_edges: int,
               device) -> Optional[tuple]:
    """The forward and transposed lists of one rank's edges ``src -> dst``
    with global ids ``eid`` (``ops.ell_gather.pair_lists``), or None when
    the rank has no such edge."""
    if len(dst) == 0:
        return None
    return pair_lists(dst, src, eid, n_out, n_in, device, n_ids=n_edges)
