"""Halo-exchange SpMM over the ``edge`` axis of a mesh (the JAX package's
``parallel/halo.py``, on ``torch.distributed``).

Node rows are split into ``P`` contiguous blocks of ``Nr`` rows; rank ``p``
owns block ``p`` and the edges whose *destination* falls in it.  The only
communication is an ``all_to_all_single`` of exactly the boundary ("halo")
source rows each rank needs, and one ``all_gather`` of the rows of the
"hubs": source nodes needed by ``hub_fanout`` or more remote ranks (or
spilled by ``halo_cap``), which would otherwise inflate every pair's padded
buffer.  :func:`build_halo_partition` is the JAX package's plan, bit-equal
on every array and scalar; a rank's table is ``[own rows | pairwise halo
(P*S) | hubs (P*Hq)]``.

Each rank walks two lists of its edges (``dropgrids.rank_lists``, with
global edge ids): the *local* list, whose sources are its own rows, and the
*remote* list, over the halo and the hubs.  The exchange starts
asynchronously; the local walk runs while it is in flight and only the
remote walk waits for it (the JAX package builds the one table first, so
there even local edges wait).  The walks are K2's store-mode walk with
realized values, or K1's masked walk under a lazy draw, hashed by global
edge id; the remote product is added to the local one.  The backward walks
the transposed lists, the remote one first so that the reverse exchange of
the halo's and the hubs' gradients runs under the local walk.

The model is replicated (``dist.py``): :func:`halo_spmm` takes the full
``x``, slices this rank's block (``collectives.slice_of_replicated``) and
all-gathers the output blocks into the full replicated product.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph.coo import Graph
from ..ops.spmm import _scaled_call
from .collectives import (GroupRef, all_gather, exchange, gather_into,
                          rank_of, slice_of_replicated)
from .dist import (EDGE_AXIS, Mesh, _StructureCache, check_device,
                   walk_or_zeros)
from .dropgrids import executor_drop_state, rank_lists, slot_ids


def structure(graph: Graph):
    """``graph``'s row, col (int64) and values as numpy arrays."""
    return (graph.row.cpu().numpy().astype(np.int64),
            graph.col.cpu().numpy().astype(np.int64),
            graph.val.detach().cpu().numpy())


@dataclass(frozen=True)
class HaloPartition:
    """Host-precomputed partition plan for :func:`halo_spmm` (numpy, the
    JAX package's fields)."""

    rows: np.ndarray       # (P, Emax) int32 — local destination offsets
    cols: np.ndarray       # (P, Emax) int32 — positions in the local table
    edge_slot: np.ndarray  # (E,) int64 — original edge -> flat (P*Emax) slot
    base_val: np.ndarray   # (E,) — build-time edge values (val=None path)
    send_idx: np.ndarray   # (P, P, S) int32 — send_idx[q, p]: q -> p rows
    hub_idx: np.ndarray    # (P, Hq) int32 — hub rows each owner contributes
    n_nodes: int           # true (unpadded) node count
    n_edges: int
    n_parts: int
    rows_per_part: int
    halo_size: int         # S — pairwise all_to_all rows per (q, p)
    hub_rows: int          # Hq — all_gather rows per owner (0 = no hubs)

    @property
    def padded_nodes(self) -> int:
        return self.n_parts * self.rows_per_part

    @property
    def edges_per_part(self) -> int:
        return int(self.rows.shape[1])

    @property
    def halo_bytes_per_device(self) -> int:
        """all_to_all + all_gather payload rows (x4 bytes per feature)."""
        return 4 * (self.n_parts * self.halo_size
                    + self.n_parts * self.hub_rows)

    @property
    def table_rows(self) -> int:
        """Rows of a rank's remote table, ``[halo (P*S) | hubs (P*Hq)]``."""
        return self.n_parts * (self.halo_size + self.hub_rows)


def build_halo_partition(graph: Graph, n_parts: int, *, hub_fanout: int = 3,
                         max_hubs: int = 4096,
                         halo_cap: Optional[int] = -1) -> HaloPartition:
    """Partition a graph for halo execution (host, one-time, vectorized).

    ``hub_fanout`` — a source node needed by at least this many *remote*
    partitions is replicated via all_gather instead of the pairwise
    all_to_all (cap: ``max_hubs`` nodes, highest-fanout first).  Set
    ``hub_fanout=0`` to disable hub replication.

    ``halo_cap`` — hard bound on the per-pair all_to_all row count ``S``:
    any (sender, receiver) pair exceeding it spills its highest-fanout
    columns into the replicated hub table (spilling a column shrinks every
    pair that needs it), so one skewed boundary cannot inflate every
    device's padded buffer.  ``-1`` (default) = auto (the 95th percentile
    of nonzero pair sizes, at least 64); ``None`` = uncapped.
    """
    row, col, val = structure(graph)
    e = row.shape[0]
    n = graph.n_nodes
    nr = -(-n // n_parts)

    # sort edges by destination partition (stable keeps any row order)
    if e and np.any(row[1:] < row[:-1]):
        order = np.argsort(row, kind="stable")
    else:
        order = np.arange(e, dtype=np.int64)
    rs, cs = row[order], col[order]
    owner = rs // nr
    c_owner = cs // nr
    remote = c_owner != owner

    # remote fanout per source node = #distinct dest partitions needing it
    fanout = np.zeros(n, np.int64)
    if np.any(remote):
        upairs = np.unique(cs[remote] * n_parts + owner[remote])
        fan_nodes, fan = np.unique(upairs // n_parts, return_counts=True)
        fanout[fan_nodes] = fan

    # --- hub selection pass 1: global high-fanout nodes
    is_hub_node = np.zeros(n, bool)
    if hub_fanout > 0:
        cand = np.flatnonzero(fanout >= hub_fanout)
        if cand.shape[0] > max_hubs:
            keep = np.argsort(-fanout[cand], kind="stable")[:max_hubs]
            cand = cand[keep]
        is_hub_node[cand] = True

    def _pair_groups(mask):
        """Unique (dest p, col c) pairs among ``mask`` edges, grouped by
        (owner q, dest p) in (q, p, c) order.  Returns None when empty."""
        if not np.any(mask):
            return None
        pk = owner[mask] * (n + 1) + cs[mask]
        upk, inv = np.unique(pk, return_inverse=True)
        p_u = upk // (n + 1)
        c_u = upk % (n + 1)
        q_u = c_u // nr
        grp_order = np.lexsort((c_u, p_u, q_u))
        gk = q_u[grp_order] * n_parts + p_u[grp_order]
        new_grp = np.ones(gk.shape[0], bool)
        new_grp[1:] = gk[1:] != gk[:-1]
        grp_start_idx = np.flatnonzero(new_grp)
        grp_id = np.cumsum(new_grp) - 1
        rank_in_grp = np.arange(gk.shape[0]) - grp_start_idx[grp_id]
        counts = np.diff(np.append(grp_start_idx, gk.shape[0]))
        return upk, inv, grp_order, grp_id, rank_in_grp, counts

    # --- hub selection pass 2: cap spill.  One pass suffices — removing a
    # column only shrinks pair groups, so every group left after spilling
    # its over-cap members is within the cap.
    pairwise = remote & ~is_hub_node[cs]
    if halo_cap is not None and np.any(pairwise):
        grp = _pair_groups(pairwise)
        _, _, grp_order, grp_id, _, counts = grp
        cap = halo_cap if halo_cap > 0 else \
            max(64, int(np.percentile(counts, 95)))
        if int(counts.max()) > cap:
            upk = grp[0]
            c_u = (upk % (n + 1))[grp_order]
            # within each (q, p) group order by fanout ascending, so the
            # over-cap (spilled) members are the highest-fanout columns —
            # replicating those shrinks other pairs too
            sub = np.lexsort((fanout[c_u], grp_id))
            rank_f = np.arange(sub.shape[0]) - \
                np.flatnonzero(np.diff(np.append(-1, grp_id[sub])))[grp_id[sub]]
            spill = c_u[sub[rank_f >= cap]]
            is_hub_node[spill] = True
            pairwise = remote & ~is_hub_node[cs]

    # --- hub table layout (by owner, ascending node id)
    hub_pos = np.full(n, -1, np.int64)   # global hub slot (owner * Hq + rank)
    hub_rank = np.zeros(n, np.int64)     # rank within owner
    hq = 0
    hubs = np.flatnonzero(is_hub_node)
    if hubs.shape[0]:
        hub_owner = hubs // nr
        hub_counts = np.bincount(hub_owner, minlength=n_parts)
        hq = int(hub_counts.max())
        starts = np.zeros(n_parts + 1, np.int64)
        np.cumsum(hub_counts, out=starts[1:])
        rank = np.arange(hubs.shape[0]) - starts[hub_owner]
        hub_pos[hubs] = hub_owner * hq + rank
        hub_rank[hubs] = rank
    is_hub_edge = remote & (hub_pos[cs] >= 0)

    # --- pairwise send lists: unique (dest p, col c) among pairwise edges
    s = 1
    send = np.zeros((n_parts, n_parts, 1), np.int32)
    send_pos_of_edge = np.zeros(e, np.int64)
    grp = _pair_groups(pairwise)
    if grp is not None:
        upk, inv, grp_order, grp_id, rank_in_grp, counts = grp
        c_s = (upk % (n + 1))[grp_order]
        q_s = c_s // nr
        p_s = (upk // (n + 1))[grp_order]
        s = max(1, int(counts.max()))
        send = np.zeros((n_parts, n_parts, s), np.int32)
        send[q_s, p_s, rank_in_grp] = (c_s - q_s * nr).astype(np.int32)
        # table position of unique pair j (undo the lexsort):
        tbl = np.empty(upk.shape[0], np.int64)
        tbl[grp_order] = nr + q_s * s + rank_in_grp
        send_pos_of_edge[pairwise] = tbl[inv]

    # --- per-edge column remap into [own | halo P*S | hubs P*Hq]
    final_cols = np.where(
        pairwise, send_pos_of_edge,
        np.where(is_hub_edge, nr + n_parts * s + hub_pos[cs],
                 cs - owner * nr))

    # --- contiguous per-partition edge blocks + edge -> slot map
    part_count = np.bincount(owner, minlength=n_parts) if e else \
        np.zeros(n_parts, np.int64)
    emax = max(1, int(part_count.max()) if e else 1)
    estart = np.zeros(n_parts + 1, np.int64)
    np.cumsum(part_count, out=estart[1:])
    pos_in_part = np.arange(e, dtype=np.int64) - estart[owner]
    slot_sorted = owner * emax + pos_in_part
    edge_slot = np.empty(e, np.int64)
    edge_slot[order] = slot_sorted

    rows_b = np.zeros((n_parts, emax), np.int32)
    cols_b = np.zeros((n_parts, emax), np.int32)
    rows_b.reshape(-1)[slot_sorted] = (rs - owner * nr).astype(np.int32)
    cols_b.reshape(-1)[slot_sorted] = final_cols.astype(np.int32)

    hub_idx = np.zeros((n_parts, hq), np.int32)
    if hq:
        hub_nodes = np.flatnonzero(hub_pos >= 0)
        hub_idx[hub_nodes // nr, hub_rank[hub_nodes]] = \
            (hub_nodes % nr).astype(np.int32)

    return HaloPartition(
        rows=rows_b, cols=cols_b, edge_slot=edge_slot,
        base_val=np.asarray(val), send_idx=send, hub_idx=hub_idx,
        n_nodes=n, n_edges=e, n_parts=n_parts, rows_per_part=nr,
        halo_size=s, hub_rows=hq)



def halo_lists(part: HaloPartition, rank: int, device):
    """Rank ``rank``'s local and remote lists (``dropgrids.rank_lists``;
    None where it has no such edge; local sources are its own rows, remote
    sources index its remote table ``[halo | hubs]``) and, on ``device``,
    the rows it sends to each rank (``send_idx[rank]``) and its hub rows
    (``hub_idx[rank]``)."""
    eid, live = slot_ids(part, part.rows.shape)
    keep = live[rank]
    dst = part.rows[rank][keep].astype(np.int64)
    src = part.cols[rank][keep].astype(np.int64)
    ids = eid[rank][keep].astype(np.int64)
    nr = part.rows_per_part
    local = src < nr
    index = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)
    return (rank_lists(dst[local], src[local], ids[local], nr, nr,
                       part.n_edges, device),
            rank_lists(dst[~local], src[~local] - nr, ids[~local], nr,
                       part.table_rows, part.n_edges, device),
            index(part.send_idx[rank]), index(part.hub_idx[rank]))


def rank_table(part: HaloPartition, x: torch.Tensor, rank: int):
    """Rank ``rank``'s own rows and remote table ``[halo | hubs]`` built
    from the full ``x`` in one process, as the exchange builds them."""
    nr, p = part.rows_per_part, part.n_parts
    xp = _padded(x, part.padded_nodes)
    own = xp[rank * nr:(rank + 1) * nr]
    send = torch.from_numpy(part.send_idx.astype(np.int64)).to(x.device)
    hub = torch.from_numpy(part.hub_idx.astype(np.int64)).to(x.device)
    base = (torch.arange(p, device=x.device) * nr)[:, None]
    halo = xp[(base + send[:, rank]).reshape(-1)]
    hubs = xp[(base + hub).reshape(-1)]
    return own.contiguous(), torch.cat([halo, hubs]).contiguous()


def _padded(x: torch.Tensor, rows: int) -> torch.Tensor:
    pad = rows - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
    return x


class _HaloFn(torch.autograd.Function):
    """``own -> out_own``: this rank's rows of ``A @ x`` from its own rows,
    the exchanged halo and the gathered hubs (module docstring)."""

    @staticmethod
    def forward(ctx, own, val, draw, lists, part, group):
        p = part.n_parts
        s, hq, f = part.halo_size, part.hub_rows, own.shape[1]
        own = own.to(torch.float32).contiguous()
        ctx.val, ctx.draw, ctx.lists = val, draw, lists
        ctx.part, ctx.group = part, GroupRef(group)
        send, hub = lists[2], lists[3]
        # the sent rows are held until the waits
        sent = [own[send.reshape(-1)]]
        halo = own.new_empty(p * s, f)
        waits = [exchange(halo, sent[0], group, async_op=True)]
        hubs = own.new_empty(p * hq, f)
        if hq:
            sent.append(own[hub])
            waits.append(gather_into(hubs, sent[1], group, async_op=True))
        nr = part.rows_per_part
        out = walk_or_zeros(lists[0], 0, val, draw, own, nr)
        for w in waits:
            w.wait()
        if lists[1] is not None:
            out = out + walk_or_zeros(lists[1], 0, val, draw,
                                      torch.cat([halo, hubs]), nr)
        return out

    @staticmethod
    def backward(ctx, g):
        part, group, lists = ctx.part, ctx.group(), ctx.lists
        p = part.n_parts
        s, hq, nr = part.halo_size, part.hub_rows, part.rows_per_part
        g = g.to(torch.float32).contiguous()
        d_tab = walk_or_zeros(lists[1], 1, ctx.val, ctx.draw, g,
                              part.table_rows)
        d_send = d_tab.new_empty(p * s, g.shape[1])
        waits = [exchange(d_send, d_tab[:p * s], group, async_op=True)]
        d_hubs = d_tab.new_empty(p * hq, g.shape[1])
        if hq:
            waits.append(exchange(d_hubs, d_tab[p * s:], group,
                                  async_op=True))
        d_own = walk_or_zeros(lists[0], 1, ctx.val, ctx.draw, g, nr)
        for w in waits:
            w.wait()
        # the rows sent to each rank are distinct (padding slots, row 0,
        # get zeros), so each index_add_ adds one term a row: a fixed order
        send, hub = lists[2], lists[3]
        d_send = d_send.view(p, s, -1)
        for q in range(p):
            d_own.index_add_(0, send[q], d_send[q])
        if hq:
            d_own.index_add_(0, hub, d_hubs.view(p, hq, -1).sum(0))
        return d_own, None, None, None, None, None


def halo_spmm(part: HaloPartition, x: torch.Tensor, mesh: Mesh,
              val: Optional[torch.Tensor] = None, *, drop=None,
              lists=None) -> torch.Tensor:
    """``out = A @ X`` with the rows of ``x`` (full, replicated, possibly
    unpadded) split over the mesh's ``edge`` axis; returns the full
    replicated product.  ``val`` holds the realized per-edge values in the
    original edge order (default: the build-time values); with ``drop=(salt,
    keep, n_drop)`` it holds the base values and the mask is hashed by global
    edge id in the masked walk.  ``lists``: this rank's
    :func:`halo_lists`, built when not given."""
    group = mesh.group(EDGE_AXIS)
    check_device(mesh, x)
    if val is None:
        val = torch.from_numpy(part.base_val).to(x.device)
    if val.shape[0] != part.n_edges:
        raise ValueError(
            f"halo partition built for {part.n_edges} edges, got values for "
            f"{val.shape[0]} (self-loop-appending normalizations need the "
            "partition rebuilt on the extended structure)")
    if lists is None:
        lists = halo_lists(part, rank_of(group), mesh.device)
    own = slice_of_replicated(_padded(x, part.padded_nodes), group,
                              part.rows_per_part)
    out = _HaloFn.apply(own, val.to(torch.float32).contiguous(), drop, lists,
                        part, group)
    return all_gather(out, group)[:part.n_nodes].to(x.dtype)


class HaloExecutor(_StructureCache):
    """An ``ops.spmm`` executor routing every propagation layer's SpMM
    through :func:`halo_spmm` (``fit(mesh=, spmm="halo")``), or, on a
    hierarchical mesh (an ``edge_host`` axis, ``multihost.make_pod_mesh(
    hierarchical=True)``), through ``hier_halo.hier_halo_spmm``'s
    three-phase exchange, selected from the mesh's axes as the JAX package
    selects it.  Plans and this rank's lists are built on the host once per
    graph structure, keyed on the identity of ``row``/``col`` with strong
    references kept, bounded LRU (16).  A lazily dropped graph arrives with
    its draw (``supports_lazy_dropout``).  The plans need the whole
    structure: an edge shard raises ``ValueError``."""

    supports_lazy_dropout = True

    def __init__(self, mesh: Mesh):
        super().__init__()
        from .multihost import EDGE_HOST_AXIS
        self.mesh = mesh
        self.hierarchical = EDGE_HOST_AXIS in mesh.shape

    def partition_for(self, graph: Graph):
        """``(plan, lists)``: the structure's plan and this rank's lists."""
        if graph.is_shard:
            raise ValueError("the halo plans need the whole edge structure "
                             "on every rank, not an edge shard")

        def build():
            structure = Graph(
                row=graph.row, col=graph.col,
                val=torch.ones(graph.n_edges), n_nodes=graph.n_nodes,
                num_self_loop=graph.num_self_loop,
                sorted_by_row=graph.sorted_by_row)
            if self.hierarchical:
                from .hier_halo import (build_hier_halo_partition,
                                        hier_groups, hier_lists)
                edge, host, _ = hier_groups(self.mesh)
                plan = build_hier_halo_partition(
                    structure, host.size(), edge.size())
                return plan, hier_lists(plan, rank_of(host), rank_of(edge),
                                        self.mesh.device)
            plan = build_halo_partition(structure,
                                        self.mesh.shape[EDGE_AXIS])
            rank = rank_of(self.mesh.group(EDGE_AXIS))
            return plan, halo_lists(plan, rank, self.mesh.device)
        return self.get(graph, build)

    def __call__(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        if graph.scaled or graph.eye_weight != 0.0:
            return _scaled_call(self, graph, x)
        plan, lists = self.partition_for(graph)
        val, draw = executor_drop_state(graph)
        if self.hierarchical:
            from .hier_halo import hier_halo_spmm
            return hier_halo_spmm(plan, x, self.mesh, val, drop=draw,
                                  lists=lists)
        return halo_spmm(plan, x, self.mesh, val, drop=draw, lists=lists)
