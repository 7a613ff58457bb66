"""Hierarchical halo-exchange SpMM over an ``(edge_host, edge, feat)`` mesh
(the JAX package's ``parallel/hier_halo.py``, on ``torch.distributed``).

The flat halo executor (``halo.py``) does one ``all_to_all`` over the whole
edge axis, so a boundary row needed on another host crosses between hosts
once per destination chip.  This plan splits the exchange over the
hierarchical mesh of ``multihost.make_pod_mesh(hierarchical=True)``:

  phase 1:  ``all_to_all_single`` over ``edge`` (the chips of one host):
            the boundary rows between chips of the same host;
  phase 2:  ``all_to_all_single`` over ``edge_host``: chip ``(h, c)``
            sends host ``h'`` the union of its rows that any chip of
            ``h'`` needs, once, to the chip of ``h'`` with its own index;
  phase 3:  ``all_to_all_single`` over ``edge``: each chip passes the
            cross-host rows it received on to the sibling chips that need
            them (the gather ``dcn[redis]``);
  hubs:     sources needed by ``hub_fanout`` or more remote partitions ride
            one ``all_gather_into_tensor`` over both edge axes (ranks in the
            order ``p = h * C + c``).

Rows between hosts are at most the flat plan's (per-host unions, not
per-chip lists); phase 3 adds traffic inside a host.
:func:`build_hier_halo_partition` is the JAX package's plan, bit-equal on
every array and scalar; partition ``p = h * C + c``'s table is ``[own rows
(Nr) | intra halo (C*S1) | redistributed cross-host rows (C*S3) | hubs
(P*Hq)]``.

As in ``halo.py``, each rank walks a local list (sources among its own
rows) and a remote list (over the rest of its table), with global edge
ids: K2's store-mode walk with realized values, or K1's masked walk under
a lazy draw.  Phases 1 and 2 and the hub gather start asynchronously and
the local walk runs while they are in flight; phase 3 waits for phase 2,
and only the remote walk waits for them all.  The backward runs the
phases in reverse: the remote transposed walk first, then the reverse
exchanges, under the local transposed walk.  Phase 3 sends one received
row to several sibling chips, so its gradient adds into the phase-2 buffer
one sibling's block at a time, each block's rows distinct: a fixed order,
so two identical runs are bit-equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph.coo import Graph
from .collectives import (GroupRef, all_gather, exchange, gather_into,
                          rank_of, slice_of_replicated)
from .dist import EDGE_AXIS, Mesh, check_device, walk_or_zeros
from .dropgrids import rank_lists, slot_ids
from .halo import _padded, structure
from .multihost import EDGE_HOST_AXIS


@dataclass(frozen=True)
class HierHaloPartition:
    """Host-precomputed plan for :func:`hier_halo_spmm` (numpy, the JAX
    package's fields).

    Per-device table layout (device = partition ``p = h*C + c``):
    ``[own rows (nr) | intra halo (C*S1) | redistributed cross-host rows
    (C*S3) | replicated hubs (P*Hq)]``.
    """

    rows: np.ndarray        # (H, C, Emax) int32 — local dest offsets
    cols: np.ndarray        # (H, C, Emax) int32 — positions in local table
    edge_slot: np.ndarray   # (E,) int64 — original edge -> flat value slot
    base_val: np.ndarray    # (E,)
    send_intra: np.ndarray  # (H, C, C, S1) int32 — to sibling chip cp
    send_dcn: np.ndarray    # (H, C, H, S2) int32 — to host hp (lane-aligned)
    redis: np.ndarray       # (H, C, C, S3) int32 — into (H*S2,) dcn buffer
    hub_idx: np.ndarray     # (H, C, Hq) int32 — hub rows each owner sends
    n_nodes: int
    n_edges: int
    n_hosts: int
    n_chips: int            # chips per host
    rows_per_part: int
    s1: int
    s2: int
    s3: int
    hub_rows: int

    @property
    def n_parts(self) -> int:
        return self.n_hosts * self.n_chips

    @property
    def padded_nodes(self) -> int:
        return self.n_parts * self.rows_per_part

    @property
    def edges_per_part(self) -> int:
        return int(self.rows.shape[2])

    @property
    def dcn_rows_per_device(self) -> int:
        """Rows each device sends to other hosts (compare with the flat
        plan's ``n_parts * halo_size``)."""
        return self.n_hosts * self.s2

    @property
    def table_rows(self) -> int:
        """Rows of a rank's remote table, ``[intra halo | redistributed |
        hubs]``."""
        return (self.n_chips * (self.s1 + self.s3)
                + self.n_parts * self.hub_rows)


def build_hier_halo_partition(graph: Graph, n_hosts: int, n_chips: int, *,
                              hub_fanout: int = 3,
                              max_hubs: int = 4096) -> HierHaloPartition:
    """Build the hierarchical plan (host, one-time, vectorized —
    composite-key sorts, no per-edge python loops)."""
    H, C = n_hosts, n_chips
    n_parts = H * C
    row, col, val = structure(graph)
    e = row.shape[0]
    n = graph.n_nodes
    nr = -(-n // n_parts)

    if e and np.any(row[1:] < row[:-1]):
        order = np.argsort(row, kind="stable")
    else:
        order = np.arange(e, dtype=np.int64)
    rs, cs = row[order], col[order]
    owner = rs // nr                       # dest partition p
    q_of = cs // nr                        # source partition
    remote = q_of != owner

    # remote fanout (distinct remote dest partitions) -> hub selection
    fanout = np.zeros(n, np.int64)
    if np.any(remote):
        upairs = np.unique(cs[remote] * n_parts + owner[remote])
        fan_nodes, fan = np.unique(upairs // n_parts, return_counts=True)
        fanout[fan_nodes] = fan
    is_hub_node = np.zeros(n, bool)
    if hub_fanout > 0:
        cand = np.flatnonzero(fanout >= hub_fanout)
        if cand.shape[0] > max_hubs:
            keep = np.argsort(-fanout[cand], kind="stable")[:max_hubs]
            cand = cand[keep]
        is_hub_node[cand] = True

    pairwise = remote & ~is_hub_node[cs]

    # ---- unique (source col, dest partition) pairs among pairwise edges
    s1 = s2 = s3 = 1
    send_intra = np.zeros((H, C, C, 1), np.int32)
    send_dcn = np.zeros((H, C, H, 1), np.int32)
    redis = np.zeros((H, C, C, 1), np.int32)
    table_pos_of_edge = np.zeros(e, np.int64)  # filled for pairwise edges
    if np.any(pairwise):
        pk = owner[pairwise] * (n + 1) + cs[pairwise]
        upk, inv = np.unique(pk, return_inverse=True)
        p_u = upk // (n + 1)
        c_u = upk % (n + 1)
        q_u = c_u // nr
        hq_u, cq_u = q_u // C, q_u % C
        hp_u, cp_u = p_u // C, p_u % C
        intra_u = hq_u == hp_u
        pos_of_unique = np.zeros(upk.shape[0], np.int64)

        def _ranks(keys, orderby):
            """Stable-group by key; returns (order, group_key_per_sorted,
            rank_within_group, max_count)."""
            o = np.lexsort((orderby, keys))
            ks = keys[o]
            newg = np.ones(ks.shape[0], bool)
            newg[1:] = ks[1:] != ks[:-1]
            starts = np.flatnonzero(newg)
            gid = np.cumsum(newg) - 1
            rank = np.arange(ks.shape[0]) - starts[gid]
            counts = np.diff(np.append(starts, ks.shape[0]))
            return o, ks, rank, int(counts.max()) if counts.size else 0

        # phase 1: intra-host pairs, group (q, p) == (q, cp)
        ii = np.flatnonzero(intra_u)
        if ii.size:
            o, ks, r1, s1m = _ranks(q_u[ii] * C + cp_u[ii], c_u[ii])
            s1 = max(1, s1m)
            send_intra = np.zeros((H, C, C, s1), np.int32)
            qs, cps = ks // C, ks % C
            send_intra[qs // C, qs % C, cps, r1] = \
                (c_u[ii][o] - qs * nr).astype(np.int32)
            # receiver table slot: nr + c_srclane*S1 + r1
            pos_of_unique[ii[o]] = nr + (qs % C) * s1 + r1

        # phase 2: cross-host — unique (source col, dest HOST)
        xi = np.flatnonzero(~intra_u)
        if xi.size:
            k2 = hp_u[xi] * (n + 1) + c_u[xi]
            uk2, inv2 = np.unique(k2, return_inverse=True)
            hp2 = uk2 // (n + 1)
            c2 = uk2 % (n + 1)
            q2 = c2 // nr
            o2, ks2, r2, s2m = _ranks(q2 * H + hp2, c2)
            s2 = max(1, s2m)
            send_dcn = np.zeros((H, C, H, s2), np.int32)
            q2s, hp2s = ks2 // H, ks2 % H
            send_dcn[q2s // C, q2s % C, hp2s, r2] = \
                (c2[o2] - q2s * nr).astype(np.int32)
            r2_of_uk2 = np.empty(uk2.shape[0], np.int64)
            r2_of_uk2[o2] = r2
            # flat position in the receiver's (H, S2) dcn buffer
            dcn_pos = (q2 // C) * s2 + r2_of_uk2       # hq * S2 + r2

            # phase 3: redistribute (sender device (hp, cq) -> dest chip cp)
            k3 = (hp_u[xi] * C + cq_u[xi]) * C + cp_u[xi]
            o3, ks3, r3, s3m = _ranks(k3, c_u[xi])
            s3 = max(1, s3m)
            redis = np.zeros((H, C, C, s3), np.int32)
            dev3 = ks3 // C           # hp * C + cq  (sender device)
            cp3 = ks3 % C
            redis[dev3 // C, dev3 % C, cp3, r3] = \
                dcn_pos[inv2[o3]].astype(np.int32)
            # receiver table slot: nr + C*S1 + c_srclane*S3 + r3
            pos_of_unique[xi[o3]] = nr + C * s1 + (dev3 % C) * s3 + r3

        table_pos_of_edge[pairwise] = pos_of_unique[inv]

    # ---- hub table (global partition id ordering matches the gather over
    # (edge_host, edge): p = h*C + c)
    hub_pos = np.full(n, -1, np.int64)
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
    hub_idx = np.zeros((H, C, hq), np.int32)
    if hq:
        hub_nodes = np.flatnonzero(hub_pos >= 0)
        po = hub_nodes // nr
        hub_idx[po // C, po % C, hub_pos[hub_nodes] % hq] = \
            (hub_nodes % nr).astype(np.int32)
    is_hub_edge = remote & (hub_pos[cs] >= 0)

    # ---- per-edge column remap into the local table
    final_cols = np.where(
        pairwise, table_pos_of_edge,
        np.where(is_hub_edge, nr + C * s1 + C * s3 + hub_pos[cs],
                 cs - owner * nr))

    # ---- contiguous per-partition edge blocks + edge -> slot map
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

    return HierHaloPartition(
        rows=rows_b.reshape(H, C, emax), cols=cols_b.reshape(H, C, emax),
        edge_slot=edge_slot, base_val=np.asarray(val),
        send_intra=send_intra, send_dcn=send_dcn, redis=redis,
        hub_idx=hub_idx, n_nodes=n, n_edges=e, n_hosts=H, n_chips=C,
        rows_per_part=nr, s1=s1, s2=s2, s3=s3, hub_rows=hq)


def hier_lists(part: HierHaloPartition, h: int, c: int, device):
    """Partition ``(h, c)``'s local and remote lists
    (``dropgrids.rank_lists`` with global edge ids; None where it has no
    such edge; remote sources index its remote table), then on ``device``
    the rows it sends: to each sibling chip (``send_intra[h, c]``), to each
    host (``send_dcn[h, c]``), its redistribution of the received cross-host
    rows to each sibling (``redis[h, c]``), and its hub rows
    (``hub_idx[h, c]``)."""
    p = h * part.n_chips + c
    eid, live = slot_ids(part, (part.n_parts, part.edges_per_part))
    keep = live[p]
    dst = part.rows.reshape(part.n_parts, -1)[p][keep].astype(np.int64)
    src = part.cols.reshape(part.n_parts, -1)[p][keep].astype(np.int64)
    ids = eid[p][keep].astype(np.int64)
    nr = part.rows_per_part
    local = src < nr
    index = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)
    return (rank_lists(dst[local], src[local], ids[local], nr, nr,
                       part.n_edges, device),
            rank_lists(dst[~local], src[~local] - nr, ids[~local], nr,
                       part.table_rows, part.n_edges, device),
            index(part.send_intra[h, c]), index(part.send_dcn[h, c]),
            index(part.redis[h, c]), index(part.hub_idx[h, c]))


def hier_rank_table(part: HierHaloPartition, x: torch.Tensor, h: int,
                    c: int):
    """Partition ``(h, c)``'s own rows and remote table ``[intra halo |
    redistributed | hubs]`` built from the full ``x`` in one process, as the
    three phases and the hub gather fill them."""
    H, C, nr = part.n_hosts, part.n_chips, part.rows_per_part
    blocks = _padded(x, part.padded_nodes).view(H, C, nr, x.shape[1])
    index = lambda a: torch.from_numpy(a.astype(np.int64)).to(x.device)

    def dcn(hh, cc):  # what device (hh, cc) receives in phase 2
        return torch.cat([blocks[hq, cc][index(part.send_dcn[hq, cc, hh])]
                          for hq in range(H)])

    halo1 = [blocks[h, q][index(part.send_intra[h, q, c])] for q in range(C)]
    halo3 = [dcn(h, q)[index(part.redis[h, q, c])] for q in range(C)]
    hubs = [blocks[hp, cp][index(part.hub_idx[hp, cp])]
            for hp in range(H) for cp in range(C)]
    return (blocks[h, c].contiguous(),
            torch.cat(halo1 + halo3 + hubs).contiguous())


class _HierHaloFn(torch.autograd.Function):
    """``own -> out_own``: this rank's rows of ``A @ x`` from its own rows
    and the rows the three phases and the hub gather bring (module
    docstring).  ``groups`` are the ``edge``, ``edge_host`` and
    both-axes groups."""

    @staticmethod
    def forward(ctx, own, val, draw, lists, part, groups):
        H, C, nr = part.n_hosts, part.n_chips, part.rows_per_part
        s1, s2, s3, hq = part.s1, part.s2, part.s3, part.hub_rows
        f = own.shape[1]
        own = own.to(torch.float32).contiguous()
        ctx.val, ctx.draw, ctx.lists = val, draw, lists
        ctx.part, ctx.groups = part, tuple(map(GroupRef, groups))
        edge, host, both = groups
        send1, send2, redis, hub = lists[2:]
        # the sent rows are held until the waits
        sent = [own[send1.reshape(-1)], own[send2.reshape(-1)]]
        halo1 = own.new_empty(C * s1, f)
        dcn = own.new_empty(H * s2, f)
        waits = [exchange(halo1, sent[0], edge, async_op=True)]
        phase2 = exchange(dcn, sent[1], host, async_op=True)
        hubs = own.new_empty(H * C * hq, f)
        if hq:
            sent.append(own[hub])
            waits.append(gather_into(hubs, sent[-1], both, async_op=True))
        out = walk_or_zeros(lists[0], 0, val, draw, own, nr)
        phase2.wait()
        halo3 = own.new_empty(C * s3, f)
        exchange(halo3, dcn[redis.reshape(-1)], edge)
        for w in waits:
            w.wait()
        if lists[1] is not None:
            out = out + walk_or_zeros(lists[1], 0, val, draw,
                                      torch.cat([halo1, halo3, hubs]), nr)
        return out

    @staticmethod
    def backward(ctx, g):
        part, lists = ctx.part, ctx.lists
        edge, host, both = (ref() for ref in ctx.groups)
        H, C, nr = part.n_hosts, part.n_chips, part.rows_per_part
        s1, s2, s3, hq = part.s1, part.s2, part.s3, part.hub_rows
        g = g.to(torch.float32).contiguous()
        f = g.shape[1]
        d_tab = walk_or_zeros(lists[1], 1, ctx.val, ctx.draw, g,
                              part.table_rows)
        d1 = g.new_empty(C * s1, f)
        waits = [exchange(d1, d_tab[:C * s1], edge, async_op=True)]
        d_hubs = g.new_empty(H * C * hq, f)
        if hq:
            waits.append(exchange(d_hubs, d_tab[C * (s1 + s3):], both,
                                  async_op=True))
        d3 = g.new_empty(C * s3, f)
        exchange(d3, d_tab[C * s1:C * (s1 + s3)], edge)
        send1, send2, redis, hub = lists[2:]
        # phase 3 sent a received row to several siblings: add their
        # gradients one sibling's block at a time, each block's rows
        # distinct (padding slots, position 0, carry zeros)
        d_dcn = g.new_zeros(H * s2, f)
        d3 = d3.view(C, s3, f)
        for q in range(C):
            d_dcn.index_add_(0, redis[q], d3[q])
        d2 = g.new_empty(H * s2, f)
        waits.append(exchange(d2, d_dcn, host, async_op=True))
        d_own = walk_or_zeros(lists[0], 1, ctx.val, ctx.draw, g, nr)
        for w in waits:
            w.wait()
        d1, d2 = d1.view(C, s1, f), d2.view(H, s2, f)
        for q in range(C):
            d_own.index_add_(0, send1[q], d1[q])
        for q in range(H):
            d_own.index_add_(0, send2[q], d2[q])
        if hq:
            d_own.index_add_(0, hub, d_hubs.view(H * C, hq, f).sum(0))
        return d_own, None, None, None, None, None


def hier_groups(mesh: Mesh):
    """The ``edge``, ``edge_host`` and both-axes groups of ``mesh``."""
    return (mesh.group(EDGE_AXIS), mesh.group(EDGE_HOST_AXIS),
            mesh.group((EDGE_HOST_AXIS, EDGE_AXIS)))


def hier_halo_spmm(part: HierHaloPartition, x: torch.Tensor, mesh: Mesh,
                   val: Optional[torch.Tensor] = None, *, drop=None,
                   lists=None) -> torch.Tensor:
    """``out = A @ X`` over a hierarchical ``(edge_host, edge, feat)`` mesh
    with the three-phase exchange (module docstring); ``x`` full and
    replicated, the product returned full and replicated.  ``val`` holds
    the realized per-edge values in the original edge order (default: the
    build-time values); with ``drop=(salt, keep, n_drop)`` the base values,
    the mask hashed by global edge id in the masked walk.  ``lists``: this
    rank's :func:`hier_lists`, built when not given."""
    groups = hier_groups(mesh)
    check_device(mesh, x)
    if val is None:
        val = torch.from_numpy(part.base_val).to(x.device)
    if val.shape[0] != part.n_edges:
        raise ValueError(
            f"hier halo partition built for {part.n_edges} edges, got "
            f"values for {val.shape[0]} (self-loop-appending normalizations "
            "need the partition rebuilt on the extended structure)")
    if lists is None:
        lists = hier_lists(part, rank_of(groups[1]), rank_of(groups[0]),
                           mesh.device)
    own = slice_of_replicated(_padded(x, part.padded_nodes), groups[2],
                              part.rows_per_part)
    out = _HierHaloFn.apply(own, val.to(torch.float32).contiguous(), drop,
                            lists, part, groups)
    return all_gather(out, groups[2])[:part.n_nodes].to(x.dtype)
