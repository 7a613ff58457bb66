"""Ring SpMM over the ``edge`` axis of a mesh (the JAX package's
``parallel/ring.py``, on ``torch.distributed``).

Node rows are split into ``P`` contiguous blocks; rank ``p`` owns block
``p`` and the edges whose *destination* falls in it.  Instead of exchanging
a precomputed halo (``halo.py``), the feature blocks rotate around the ring
with ``batch_isend_irecv``: at step ``s`` rank ``p`` holds block ``(p + s)
% P`` and walks exactly the edges whose source lives there, adding into its
rows; step ``s + 1``'s send and receive are posted before step ``s``'s
walk, so the rotation runs under it.  :func:`build_ring_partition` is the
JAX package's schedule, bit-equal.

The backward rotates the gradient blocks the other way: a buffer for block
``(p + t) % P`` starts at step ``P - 1`` with that step's transposed walk,
and at each earlier step is passed to the next rank, which adds its own
step's transposed walk, so that after the last step each rank holds its own
block's gradient.  The walks are those of ``halo.py`` (realized values, or a
lazy draw hashed by global edge id); the model is replicated as in
``dist.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..graph.coo import Graph
from ..ops.spmm import _scaled_call
from .collectives import (GroupRef, all_gather, rank_of,
                          slice_of_replicated)
from .dist import (EDGE_AXIS, Mesh, _StructureCache, check_device,
                   walk_or_zeros)
from .dropgrids import executor_drop_state, rank_lists, slot_ids
from .halo import _padded, structure



@dataclass(frozen=True)
class RingPartition:
    """Host-precomputed schedule for :func:`ring_spmm`.

    ``rows/cols[p, s, e]`` — the edges device ``p`` applies at ring step
    ``s`` (source block ``(p + s) % P``): local destination offset and
    source offset *within the rotating block* (0-padded).  ``edge_slot``
    maps each *original* edge to its flat slot in that grid so live
    edge values can be placed per call; ``base_val`` holds the build-time
    values for the ``val=None`` path.  Leaves are numpy.
    """

    rows: np.ndarray       # (P, P, Emax) int32
    cols: np.ndarray       # (P, P, Emax) int32
    edge_slot: np.ndarray  # (E,) int64 — original edge -> flat grid slot
    base_val: np.ndarray   # (E,)
    n_nodes: int
    n_edges: int
    n_parts: int
    rows_per_part: int

    @property
    def padded_nodes(self) -> int:
        return self.n_parts * self.rows_per_part

    @property
    def edges_per_group(self) -> int:
        return int(self.rows.shape[2])

    @property
    def vals(self) -> np.ndarray:
        """Build-time values in grid layout (diagnostics/tests)."""
        grid = np.zeros(self.n_parts * self.n_parts * self.edges_per_group,
                        self.base_val.dtype)
        grid[self.edge_slot] = self.base_val
        return grid.reshape(self.rows.shape)


def build_ring_partition(graph: Graph, n_parts: int) -> RingPartition:
    """Group edges by (destination block, ring step) — host, one-time,
    vectorized (one stable sort over (block, step), no per-edge loops)."""
    row, col, val = structure(graph)
    e = row.shape[0]
    n = graph.n_nodes
    nr = -(-n // n_parts)

    dst_block = row // nr
    src_block = col // nr
    # step at which device dst_block holds block src_block
    step = (src_block - dst_block) % n_parts

    gid = dst_block * n_parts + step           # (p, s) group id
    order = np.argsort(gid, kind="stable")
    gid_s = gid[order]
    counts = np.bincount(gid_s, minlength=n_parts * n_parts)
    emax = max(1, int(counts.max()) if e else 1)
    starts = np.zeros(n_parts * n_parts + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(e, dtype=np.int64) - starts[gid_s]
    slot_sorted = gid_s * emax + pos
    edge_slot = np.empty(e, np.int64)
    edge_slot[order] = slot_sorted

    q = (dst_block + step) % n_parts           # source block at that step
    rows_b = np.zeros((n_parts, n_parts, emax), np.int32)
    cols_b = np.zeros((n_parts, n_parts, emax), np.int32)
    rows_b.reshape(-1)[edge_slot] = (row - dst_block * nr).astype(np.int32)
    cols_b.reshape(-1)[edge_slot] = (col - q * nr).astype(np.int32)
    return RingPartition(
        rows=rows_b, cols=cols_b, edge_slot=edge_slot,
        base_val=np.asarray(val), n_nodes=n, n_edges=e, n_parts=n_parts,
        rows_per_part=nr)


def ring_lists(part: RingPartition, rank: int, device) -> tuple:
    """Rank ``rank``'s lists of each ring step (``dropgrids.rank_lists``;
    None where a step has no edge): destinations its own rows, sources the
    rows of the block it holds at that step."""
    eid, live = slot_ids(part, part.rows.shape)
    nr = part.rows_per_part
    out = []
    for s in range(part.n_parts):
        keep = live[rank, s]
        out.append(rank_lists(part.rows[rank, s][keep].astype(np.int64),
                              part.cols[rank, s][keep].astype(np.int64),
                              eid[rank, s][keep].astype(np.int64), nr, nr,
                              part.n_edges, device))
    return tuple(out)


def _rotate(x: torch.Tensor, group, to: int, frm: int):
    """Post the send of ``x`` to group rank ``to`` and the receive of a
    block like it from ``frm``; returns the receive buffer and the
    requests."""
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, frm),
                      group)]
    return buf, dist.batch_isend_irecv(ops)


class _RingFn(torch.autograd.Function):
    """``own -> out_own``: this rank's rows of ``A @ x``, the blocks
    rotating (module docstring)."""

    @staticmethod
    def forward(ctx, own, val, draw, lists, part, group):
        r, p = rank_of(group), part.n_parts
        ctx.val, ctx.draw, ctx.lists = val, draw, lists
        ctx.group = GroupRef(group)
        cur = own.to(torch.float32).contiguous()
        out = cur.new_zeros(part.rows_per_part, cur.shape[1])
        for s in range(p):
            if s < p - 1:  # block (r + s + 1) % P comes from rank r + 1
                nxt, reqs = _rotate(cur, group, (r - 1) % p, (r + 1) % p)
            if lists[s] is not None:
                out = out + walk_or_zeros(lists[s], 0, val, draw, cur,
                                          part.rows_per_part)
            if s < p - 1:
                for q in reqs:
                    q.wait()
                cur = nxt
        return out

    @staticmethod
    def backward(ctx, g):
        lists, group = ctx.lists, ctx.group()
        r, p = rank_of(group), len(lists)
        g = g.to(torch.float32).contiguous()
        step = lambda t: walk_or_zeros(lists[t], 1, ctx.val, ctx.draw, g,
                                       g.shape[0])
        acc = step(p - 1)  # the gradient of block (r + P - 1) % P
        for t in range(p - 2, -1, -1):
            recv, reqs = _rotate(acc, group, (r + 1) % p, (r - 1) % p)
            here = step(t) if lists[t] is not None else None
            for q in reqs:
                q.wait()
            acc = recv if here is None else recv + here
        return acc, None, None, None, None, None


def ring_spmm(part: RingPartition, x: torch.Tensor, mesh: Mesh,
              val: Optional[torch.Tensor] = None, *, drop=None,
              lists=None) -> torch.Tensor:
    """``out = A @ X`` with the rows of ``x`` (full, replicated, possibly
    unpadded) split over the mesh's ``edge`` axis and the blocks rotated
    around the ring; returns the full replicated product.  ``val`` and
    ``drop`` as in ``halo.halo_spmm``; ``lists``: this rank's
    :func:`ring_lists`, built when not given."""
    group = mesh.group(EDGE_AXIS)
    check_device(mesh, x)
    if val is None:
        val = torch.from_numpy(part.base_val).to(x.device)
    if val.shape[0] != part.n_edges:
        raise ValueError(
            f"ring partition built for {part.n_edges} edges, got values "
            f"for {val.shape[0]}")
    if lists is None:
        lists = ring_lists(part, rank_of(group), mesh.device)
    own = slice_of_replicated(_padded(x, part.padded_nodes), group,
                              part.rows_per_part)
    out = _RingFn.apply(own, val.to(torch.float32).contiguous(), drop, lists,
                        part, group)
    return all_gather(out, group)[:part.n_nodes].to(x.dtype)


class RingExecutor(_StructureCache):
    """An ``ops.spmm`` executor routing every propagation layer's SpMM
    through :func:`ring_spmm` (``fit(mesh=, spmm="ring")``), with
    ``halo.HaloExecutor``'s cache and lazy-dropout contract."""

    supports_lazy_dropout = True

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh

    def partition_for(self, graph: Graph):
        """``(plan, lists)``: the structure's plan and this rank's lists."""
        if graph.is_shard:
            raise ValueError("the ring plan needs the whole edge structure "
                             "on every rank, not an edge shard")

        def build():
            plan = build_ring_partition(Graph(
                row=graph.row, col=graph.col,
                val=torch.ones(graph.n_edges), n_nodes=graph.n_nodes,
                num_self_loop=graph.num_self_loop,
                sorted_by_row=graph.sorted_by_row),
                self.mesh.shape[EDGE_AXIS])
            rank = rank_of(self.mesh.group(EDGE_AXIS))
            return plan, ring_lists(plan, rank, self.mesh.device)
        return self.get(graph, build)

    def __call__(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        if graph.scaled or graph.eye_weight != 0.0:
            return _scaled_call(self, graph, x)
        plan, lists = self.partition_for(graph)
        val, draw = executor_drop_state(graph)
        return ring_spmm(plan, x, self.mesh, val, drop=draw, lists=lists)
