"""Graph attention: the score -> segment softmax -> aggregation chain of a
GAT layer (the JAX package's ``ops/attention.py``).

With ``h`` (N, H, F) the projected features and ``s_src``/``s_dst`` (N, H)
the per-node score halves, :func:`gat_attention` computes
``out[n] = sum_e alpha_e h[col_e]`` over the edges into n, where ``alpha``
is the softmax over n's incoming edges of ``leaky_relu(s_src[col] +
s_dst[row])``, optionally with inverted attention dropout.  The dropout is
counter-based: the keep decision of (edge id, head) is a hash of the two
together with the draw's two salts (:func:`_attn_keep_scale`, bit-equal to
the JAX package's), so every path realizes the same mask.

Small graphs (below ``stochastic.min_edges()`` edges, so
``min_edges_scope`` moves the gate) on the CPU take the segment form in
plain torch, whose gathers sum their backward in a fixed order
(``segment.gather_rows``).  Larger ones, and every graph on a card (where
the segment form would scatter with atomics), take two lists on the device, built once per structure
(:func:`attn_lists`): the row list (each destination's slots) and the
column list (each source's), each stably sorted by its row, which is the
order of the JAX package's attention grids flattened row by row at any
width (:class:`AttnGrids`, kept bit-equal for parity).  Two flavours, as
in the JAX package: one slot per original edge, which dropout passes need,
and one per unique (row, col) pair with its multiplicity, exact without
dropout (duplicates share their scores) and about half the slots on a
symmetrized graph.

On the lists the chain is one ``torch.autograd.Function`` over four
hand-written kernels (``csrc/attention.cu``; the JAX package computes the
chain in XLA, ``_make_gat_core``):

* A1 :func:`attn_stats` — per (destination, head), the row's maximum score
  ``rmax0`` and its inverse softmax denominator ``dinv``;
* A2 :func:`attn_aggregate` — the weighted aggregation;
* A1 and A2 as one walk, :func:`attn_softmax_aggregate` — each score
  gathered and exponentiated once, a split row's pieces folded by
  rescaling to the row's maximum (``csrc/softmax_walk.cuh``): the whole
  graph's forward where :func:`softmax_route` allows it; A1 then A2 serve
  the slices of the edges (:func:`sharded_forward`);
* A3 :func:`attn_bwd_rows` — the backward's row pass: ``rowdot`` and the
  gradient of ``s_dst``;
* A4 :func:`attn_bwd_cols` — the column pass: the gradients of ``h`` and
  ``s_src``.

The forward keeps only (N, ·) tensors (``[h | s_src]``, ``s_dst``,
``rmax0``, ``dinv``); the backward recomputes every per-edge quantity.
Each kernel's plain version, beside it, sums in the kernel's order
(``blocked.ordered_row_sums``); a CPU tensor takes it, a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.coo import Graph
from ..utils import kernels
from ..utils.idcache import IdLRU, sizeof
from .blocked import (EdgeList, list_rows, ordered_row_sums, row_ptr,
                      work_units)
from .segment import gather_rows, segment_softmax
from .spmm import current_executor
from .stochastic import (_MASK32, _fmix32, _salts, _threshold, device_salt,
                         min_edges)

_GOLD = 0x9E3779B9  # odd constant decorrelating the per-head salts
# items (slots and row ends) a unit of the attention walks: a lane walks a
# unit's slots one by one in the per-head walks, so units are small
_ATTN_ITEMS = 32
# pieces of a split row that a warp of the fused walk folds in turn, and the
# warps (parts) of a split row's merge (csrc/softmax_walk.cuh)
_RUN_PIECES = 8
_MERGE_WARPS = 32
# the most slots of a task of the fused walk (a run of whole rows, or a
# piece), and the most rows of a task (csrc/softmax_walk.cuh, kTaskRows)
_SEGMENT_SLOTS = 32
_TASK_ROWS = 16
# row-split width of the attention grids: the JAX package's default
# GNNTF_ATTN_K.  The kernels' lists do not depend on it.
_ATTN_K = 16


def _attn_keep_scale(eids: torch.Tensor, salt, n_heads: int, keep: float,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverted-dropout scale per (edge id, head): ``fp32(1 / keep)`` where
    kept, 0 where dropped; shape ``eids.shape + (n_heads,)``.  The hash
    ``fmix32(fmix32(id ^ s0) ^ (s1 + head * 0x9E3779B9)) >> 8 <
    round(keep * 2**24)`` runs in int64 (``stochastic._fmix32``)."""
    eids = eids.to(torch.int64)
    s0, s1 = _salts(salt, eids.device)
    base = _fmix32(eids ^ s0)
    heads = torch.arange(n_heads, dtype=torch.int64, device=eids.device)
    hsalt = (s1 + heads * _GOLD) & _MASK32
    hh = _fmix32(base[..., None] ^ hsalt)
    kept = (hh >> 8) < _threshold(keep)
    return torch.where(
        kept, torch.full((), 1.0 / keep, dtype=dtype, device=eids.device),
        torch.zeros((), dtype=dtype, device=eids.device))


@dataclasses.dataclass(frozen=True)
class SoftmaxPlan:
    """The fused walk's work over a row list (``csrc/softmax_walk.cuh``):
    ``task`` (T, 2) int32, a group's (first, count) each: first the runs of
    up to ``_RUN_PIECES`` consecutive pieces of each split row, in list
    order (first unit, pieces), then runs of consecutive whole rows of at
    most ``_SEGMENT_SLOTS`` slots and ``_TASK_ROWS`` rows (first row, rows),
    packed in row order; ``split_runs`` (S, 2) int32, each split row's first
    run and run count."""

    task: torch.Tensor
    split_runs: torch.Tensor
    n_runs: int

    @property
    def n_tasks(self) -> int:
        return int(self.task.shape[0])


def _row_tasks(deg: np.ndarray, split: np.ndarray) -> np.ndarray:
    """The whole rows' tasks, (first row, rows) each: consecutive rows that
    no unit splits, packed in row order while they hold at most
    ``_SEGMENT_SLOTS`` slots and ``_TASK_ROWS`` rows (each holds at most
    ``_SEGMENT_SLOTS``).  A task from row i ends at ``end[i]``, and the next
    starts at the first whole row from there (``nxt[i]``); the starts, the
    chain of ``nxt`` from the first whole row, are marked by doubling."""
    n = len(deg)
    cum = np.concatenate([[0], np.cumsum(deg)])
    at = np.arange(n)
    split_at = np.flatnonzero(split)
    next_split = np.append(split_at, n)[np.searchsorted(split_at, at)]
    fill = np.searchsorted(cum, cum[:-1] + _SEGMENT_SLOTS, side="right") - 1
    end = np.minimum(np.minimum(next_split, at + _TASK_ROWS), fill)
    whole = np.flatnonzero(~split)
    first_whole = np.append(whole, n)  # the first whole row at or after i
    nxt = np.append(first_whole[np.searchsorted(whole, end)], n)
    start = np.zeros(n + 1, bool)
    start[first_whole[0]] = True
    jump = nxt
    for _ in range(max(1, int(n).bit_length())):
        start[jump[start]] = True
        jump = jump[jump]
    first = np.flatnonzero(start[:n])
    return np.stack([first, end[first] - first], 1).reshape(-1, 2)


def softmax_plan(ptr: np.ndarray, items: int, device) -> SoftmaxPlan:
    """The :class:`SoftmaxPlan` of a row list with row pointers ``ptr`` cut
    into units of ``items <= _SEGMENT_SLOTS`` items (``blocked.work_units``:
    every whole row and every piece then holds at most that many slots)."""
    assert items <= _SEGMENT_SLOTS, items
    ptr = np.asarray(ptr, np.int64)
    _, _, split = work_units(ptr, items)
    split = split.astype(np.int64).reshape(-1, 3)
    deg = np.diff(ptr)
    is_split = np.zeros(len(deg), bool)
    is_split[split[:, 0]] = True
    n_runs = -(-split[:, 2] // _RUN_PIECES)
    first_run = np.cumsum(n_runs) - n_runs
    run_split = np.repeat(np.arange(len(split)), n_runs)
    k = np.arange(len(run_split)) - first_run[run_split]
    pieces = split[run_split, 2] - k * _RUN_PIECES
    runs = np.stack([split[run_split, 1] + k * _RUN_PIECES,
                     np.minimum(pieces, _RUN_PIECES)], 1).reshape(-1, 2)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return SoftmaxPlan(put(np.concatenate([runs, _row_tasks(deg, is_split)])),
                       put(np.stack([first_run, n_runs], 1).reshape(-1, 2)),
                       int(len(runs)))


@dataclasses.dataclass(frozen=True)
class AttnLists:
    """The kernels' two lists of one graph structure on a device: ``rows``
    (each destination's slots, ``ptr`` over the N destinations, ``idx`` the
    sources, ``eid`` the edge or pair id) and ``cols`` (each source's),
    ``mult``, each pair id's multiplicity (None for one slot an edge), and
    the fused walk's :class:`SoftmaxPlan` of ``rows`` (None for units of
    more than ``_SEGMENT_SLOTS`` items)."""

    rows: EdgeList
    cols: EdgeList
    mult: Optional[torch.Tensor]
    plan: Optional[SoftmaxPlan] = None


@dataclasses.dataclass(frozen=True)
class AttnGrids:
    """Row-split ELL grids of one graph structure, both orientations,
    host numpy, bit-equal to the JAX package's ``AttnGrids``: per original
    edge (``r_mult is None``) or duplicate-coalesced, with per-slot pair
    multiplicities.  Flattened row by row, they give :func:`attn_lists`'
    order at any width; the port keeps them for parity with the JAX
    package."""

    n_nodes: int
    r_idx: np.ndarray   # (Vr, k) int32 source ids (pad -> n_nodes)
    r_vrow: np.ndarray  # (Vr,)  int32 destination row, non-decreasing
    r_eid: np.ndarray   # (Vr, k) uint32 edge or pair ids (pad -> count)
    c_idx: np.ndarray   # (Vc, k) int32 destination ids (pad -> n_nodes)
    c_vrow: np.ndarray  # (Vc,)  int32 source row, non-decreasing
    c_eid: np.ndarray   # (Vc, k) uint32 edge or pair ids (pad -> count)
    r_mult: Optional[np.ndarray] = None  # (Vr, k) f32 multiplicity (pad 0)
    c_mult: Optional[np.ndarray] = None  # (Vc, k) f32


def _route_eids(layout, n_edges: int) -> np.ndarray:
    grid = np.full(layout.n_vrows * layout.k, n_edges, np.uint32)
    grid[layout.slot] = np.arange(n_edges, dtype=np.uint32)
    return grid.reshape(layout.n_vrows, layout.k)


def _coalesce(row: np.ndarray, col: np.ndarray):
    """The unique (row, col) pairs sorted by (row, col), and each one's
    multiplicity (float32)."""
    e = row.shape[0]
    order = np.lexsort((col, row))
    rs, cs = row[order], col[order]
    new = np.ones(e, bool)
    if e:
        new[1:] = (rs[1:] != rs[:-1]) | (cs[1:] != cs[:-1])
    uid = np.cumsum(new, dtype=np.int64) - 1
    return rs[new], cs[new], np.bincount(uid).astype(np.float32)


def build_attn_grids(row, col, n_nodes: int, dedup: bool = False,
                     k: int = _ATTN_K) -> AttnGrids:
    """One-time host build of the attention grids (the JAX package's
    ``build_attn_grids``, whose width ``k`` it reads from
    ``GNNTF_ATTN_K``): per original edge, or with ``dedup`` over the
    unique (row, col) pairs with their multiplicities, at half the
    row-split width."""
    from .spmm import build_ell
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    e = row.shape[0]
    if not dedup:
        rl = build_ell(row, col, n_nodes, k, dedup=False)
        cl = build_ell(col, row, n_nodes, k, dedup=False)
        return AttnGrids(n_nodes=n_nodes,
                         r_idx=rl.idx, r_vrow=rl.vrow_row,
                         r_eid=_route_eids(rl, e),
                         c_idx=cl.idx, c_vrow=cl.vrow_row,
                         c_eid=_route_eids(cl, e))

    ru, cu, mult = _coalesce(row, col)
    kd = max(4, k // 2)

    def one(r, c):
        layout = build_ell(r, c, n_nodes, kd, dedup=False)
        mg = np.zeros(layout.n_vrows * layout.k, np.float32)
        mg[layout.slot] = mult
        return layout, mg.reshape(layout.n_vrows, layout.k), \
            _route_eids(layout, len(ru))

    rl, rm, re_ = one(ru, cu)
    cl, cm, ce_ = one(cu, ru)
    return AttnGrids(n_nodes=n_nodes,
                     r_idx=rl.idx, r_vrow=rl.vrow_row, r_eid=re_,
                     c_idx=cl.idx, c_vrow=cl.vrow_row, c_eid=ce_,
                     r_mult=rm, c_mult=cm)


def attn_lists(row, col, n_nodes: int, device, dedup: bool = False,
               items: int = _ATTN_ITEMS, id_base: int = 0) -> AttnLists:
    """The kernels' lists of a structure on ``device``, in units of
    ``items`` items: per original edge (``eid`` the edge id, ``id_base``
    plus its position: a slice of a larger edge list hashes the dropout at
    its global ids), or with ``dedup`` per unique (row, col) pair (``eid``
    the pair id, in (row, col) order) with the pairs' multiplicities.  Each
    list is the slots stably sorted by their own row: the order of the JAX
    package's grids flattened row by row."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    mult = None
    if dedup:
        row, col, by_id = _coalesce(row, col)
        mult = torch.from_numpy(by_id).to(device)

    base = 0 if dedup else id_base

    def one(r, c):
        order = np.argsort(r, kind="stable")
        ptr = row_ptr(r[order], n_nodes)
        return ptr, EdgeList.build(ptr, c[order], order + base, device,
                                   items=items)

    ptr, rows = one(row, col)
    plan = softmax_plan(ptr, items, device) if items <= _SEGMENT_SLOTS \
        else None
    return AttnLists(rows, one(col, row)[1], mult, plan)


_LISTS_CACHE = IdLRU()


def _attn_lists(graph: Graph, dedup: bool = False) -> AttnLists:
    """The lists of ``graph``'s structure on its device, built once a
    flavour: memoized on the identity of ``row`` and ``col``.
    ``_attn_lists.builds`` counts the builds."""
    key = ("attn-lists", id(graph.row), id(graph.col), graph.n_nodes, dedup)
    anchors = (graph.row, graph.col)
    lists = _LISTS_CACHE.get(key, anchors)
    if lists is None:
        lists = attn_lists(graph.row.cpu().numpy(), graph.col.cpu().numpy(),
                           graph.n_nodes, graph.device, dedup=dedup)
        _LISTS_CACHE.put(key, anchors, lists, nbytes=sizeof(lists))
        _attn_lists.builds += 1
    return lists


_attn_lists.builds = 0


def _grid_eligible(graph: Graph) -> bool:
    """The grid path needs enough edges to amortize its one-time build
    (``stochastic.min_edges()``, so ``min_edges_scope`` applies)."""
    return graph.n_edges_global >= min_edges()


def gat_attention(graph: Graph, h: torch.Tensor, s_src: torch.Tensor,
                  s_dst: torch.Tensor, *, negative_slope: float = 0.2,
                  attn_dropout: float = 0.0, salt=None,
                  sorted_by_row: bool = False) -> torch.Tensor:
    """Attention-weighted aggregation ``out[n] = sum_e alpha_e h[col_e]``
    as an (N, H, F) tensor.

    ``h``: (N, H, F); ``s_src``/``s_dst``: (N, H).  ``attn_dropout`` with a
    ``salt`` (the draw's two uint32 salts, a (2,) tensor, as edge dropout
    draws them) applies inverted dropout to the normalized coefficients,
    one draw per (edge, head).  ``sorted_by_row`` is accepted for the JAX
    signature.

    An executor in force that offers ``attention`` (``parallel.dist.
    GspmdExecutor``: each rank's slice of the edges) computes it; an edge
    shard needs one."""
    if not (attn_dropout and salt is not None):
        salt = None
    executor = current_executor()
    if executor is not None and hasattr(executor, "attention"):
        return executor.attention(graph, h, s_src, s_dst,
                                  negative_slope=negative_slope,
                                  attn_dropout=attn_dropout, salt=salt)
    if graph.is_shard:
        raise ValueError("GAT's attention over an edge shard needs the "
                         "gspmd executor in force (parallel.dist."
                         "GspmdExecutor)")
    return gat_attention_local(graph, h, s_src, s_dst,
                               negative_slope=negative_slope,
                               attn_dropout=attn_dropout, salt=salt,
                               sorted_by_row=sorted_by_row)


def gat_attention_local(graph: Graph, h: torch.Tensor, s_src: torch.Tensor,
                        s_dst: torch.Tensor, *, negative_slope: float = 0.2,
                        attn_dropout: float = 0.0, salt=None,
                        sorted_by_row: bool = False) -> torch.Tensor:
    """:func:`gat_attention` on this device over the whole graph: the
    lists' chain (A1-A4) on a card or at or above ``min_edges()`` edges,
    else the segment form."""
    if _grid_eligible(graph) or h.device.type == "cuda":
        return _gat_attention_ell(graph, h, s_src, s_dst,
                                  negative_slope=negative_slope,
                                  attn_dropout=attn_dropout, salt=salt)
    return _gat_attention_segment(graph, h, s_src, s_dst,
                                  negative_slope=negative_slope,
                                  attn_dropout=attn_dropout, salt=salt,
                                  sorted_by_row=sorted_by_row)


def _gat_attention_segment(graph, h, s_src, s_dst, *, negative_slope,
                           attn_dropout, salt, sorted_by_row):
    """The chain over the edge list in plain torch (small graphs on the
    CPU), every gather's backward summed in a fixed order."""
    row, col = graph.row, graph.col
    n, h_cnt, f = h.shape
    scores = F.leaky_relu(gather_rows(s_src, col) + gather_rows(s_dst, row),
                          negative_slope)
    alpha = segment_softmax(scores, row, n, indices_are_sorted=sorted_by_row)
    if attn_dropout and salt is not None:
        eids = torch.arange(alpha.shape[0], device=alpha.device)
        alpha = alpha * _attn_keep_scale(eids, salt, h_cnt,
                                         1.0 - attn_dropout, alpha.dtype)
    msgs = gather_rows(h, col) * alpha[:, :, None].to(h.dtype)
    out = torch.zeros(n, h_cnt * f, dtype=msgs.dtype, device=msgs.device)
    out = out.index_add(0, row, msgs.reshape(msgs.shape[0], h_cnt * f))
    return out.reshape(n, h_cnt, f)


def _gat_attention_ell(graph, h, s_src, s_dst, *, negative_slope,
                       attn_dropout, salt):
    """The chain over the grids' lists: coalesced lists without dropout,
    per-edge lists with it."""
    keep = 1.0 - attn_dropout if (attn_dropout and salt is not None) \
        else 1.0
    lists = _attn_lists(graph, dedup=(keep >= 1.0))
    return _AttnFn.apply(h, s_src, s_dst, lists,
                         salt if keep < 1.0 else None, keep,
                         float(negative_slope))


def pack_table(*parts: torch.Tensor) -> torch.Tensor:
    """The (N, ·) float32 ``parts`` side by side, padded with zeros to a
    multiple of 4 columns: one row is a slot's gather, its feature part one
    aligned float4 a lane."""
    n = parts[0].shape[0]
    width = sum(p.shape[1] for p in parts)
    pad = -width % 4
    cols = [p.to(torch.float32) for p in parts]
    if pad:
        cols.append(torch.zeros(n, pad, dtype=torch.float32,
                                device=parts[0].device))
    return torch.cat(cols, dim=1).contiguous()


def column_table(g: torch.Tensor, s_dst, rmax0, dinv,
                 rowdot) -> torch.Tensor:
    """A4's gathered table (``tabc``): ``[g | s_dst, rmax0, dinv, rowdot of
    head 0 | ... of head H-1]``, the four (N, H) tables side by side a head
    (one float4 a head, aligned where W is a multiple of 4), padded as
    :func:`pack_table` pads."""
    n, heads = s_dst.shape
    scalars = torch.stack([t.to(torch.float32) for t in (s_dst, rmax0, dinv,
                                                          rowdot)], 2)
    return pack_table(g, scalars.reshape(n, 4 * heads))


class _AttnFn(torch.autograd.Function):
    """``(h, s_src, s_dst) -> out`` over one :class:`AttnLists`: the fused
    walk (or A1 and A2) forward, A3 and A4 backward; only (N, ·) tensors
    are saved."""

    @staticmethod
    def forward(ctx, h, s_src, s_dst, lists, salt, keep, slope):
        n, heads, feats = h.shape
        tab = pack_table(h.reshape(n, heads * feats), s_src)
        s_dst = s_dst.to(torch.float32).contiguous()
        outs = attn_forward(lists, tab, s_dst, heads, feats, slope, salt,
                            keep)
        ctx.save_for_backward(tab, s_dst, outs["rmax0"], outs["dinv"])
        ctx.lists, ctx.draw = lists, (slope, salt, keep)
        ctx.shape = (n, heads, feats)
        return outs["out"].view(n, heads, feats)

    @staticmethod
    def backward(ctx, g):
        tab, s_dst, rmax0, dinv = ctx.saved_tensors
        n, heads, feats = ctx.shape
        g = g.reshape(n, heads * feats).to(torch.float32).contiguous()
        outs = attn_backward(ctx.lists, tab, s_dst, rmax0, dinv, g, heads,
                             feats, *ctx.draw)
        return (outs["dh"].view(n, heads, feats), outs["ds_src"],
                outs["ds_dst"], None, None, None, None)


# the outputs of each kernel, by name, in the chain's order
ATTN_OUTPUTS = {"attn_stats": ("rmax0", "dinv"),
                "attn_aggregate": ("out",),
                "attn_softmax_aggregate": ("rmax0", "dinv", "out"),
                "attn_bwd_rows": ("rowdot", "ds_dst"),
                "attn_bwd_cols": ("dh", "ds_src")}


def _runner(plain, calls, outs):
    """``run(name, *args)``: kernel ``name`` (its plain version with
    ``plain``) on ``args``, its outputs stored in ``outs`` by name and the
    call in ``calls`` (when given) as a closure."""
    def run(name, *args):
        fn = _KERNELS[name][bool(plain)]
        call = functools.partial(fn, *args)
        if calls is not None:
            calls[name] = call
        res = call()
        outs.update(zip(ATTN_OUTPUTS[name],
                        res if isinstance(res, tuple) else (res,)))
    return run


def softmax_route(lists, heads: int, feats: int) -> bool:
    """Whether the whole graph's forward takes the fused walk
    (:func:`attn_softmax_aggregate`) over ``lists``: a plan (units of at
    most ``_SEGMENT_SLOTS`` items), and lanes that take (H, F) (at most 32
    heads, whole heads of lanes in A2's group, at most 128 feature vectors
    a row); else A1 then A2."""
    return lists.plan is not None and _softmax_lanes(heads, feats)


def _softmax_lanes(heads: int, feats: int) -> bool:
    """Whether the fused walk's lanes take (H, F): its group, A2's
    (:func:`feature_lanes`), must be whole heads of lanes, at most 4 chunks
    of 32 feature vectors a row."""
    vec, group = feature_lanes(heads, feats)
    return (heads <= 32 and heads * feats // vec <= 128
            and group % heads == 0)


def attn_forward(lists, tab, s_dst, heads, feats, slope, salt=None,
                 keep=1.0, *, plain=False, given=None, calls=None,
                 fused=None) -> dict:
    """The forward over the row list: ``rmax0``, ``dinv`` and ``out`` by
    name, from the fused walk where ``fused`` (default
    :func:`softmax_route`), else from A1 then A2; ``tab`` is ``[h |
    s_src]`` (:func:`pack_table`).  With ``plain`` the plain versions run;
    ``given`` (outputs by name) feeds A2 those in place of A1's, so that a
    plain version can be held to its kernel on the kernel's own inputs;
    ``calls`` gets each call by kernel name (to time it)."""
    outs = {}
    run = _runner(plain, calls, outs)
    if fused is None:
        fused = softmax_route(lists, heads, feats)
    if fused:
        run("attn_softmax_aggregate", lists.rows, lists.plan, lists.mult, tab,
            s_dst, heads, feats, slope, salt, keep)
        return outs
    run("attn_stats", lists.rows, lists.mult, tab, s_dst, heads, feats, slope)
    src = given or outs
    run("attn_aggregate", lists.rows, lists.mult, tab, s_dst, src["rmax0"],
        src["dinv"], heads, feats, slope, salt, keep)
    return outs


def attn_backward(lists, tab, s_dst, rmax0, dinv, g, heads, feats, slope,
                  salt=None, keep=1.0, *, plain=False, given=None,
                  calls=None) -> dict:
    """A3 over the row list, then A4 over the column list, with ``g``
    (N, H * F) the output's gradient: ``rowdot``, ``ds_dst``, ``dh`` and
    ``ds_src`` by name; ``plain``, ``given`` (A3's ``rowdot``) and
    ``calls`` as in :func:`attn_forward`."""
    outs = {}
    run = _runner(plain, calls, outs)
    run("attn_bwd_rows", lists.rows, lists.mult, tab, s_dst, rmax0, dinv, g,
        heads, feats, slope, salt, keep)
    tabc = column_table(g, s_dst, rmax0, dinv, (given or outs)["rowdot"])
    run("attn_bwd_cols", lists.cols, lists.mult, tab, tabc, heads, feats,
        slope, salt, keep)
    return outs


def attn_chain(lists, h, s_src, s_dst, g, slope, salt=None, keep=1.0,
               fused=None, **kw) -> dict:
    """The forward and A3-A4 as the autograd Function runs them, on ``h``
    (N, H, F), the score halves (N, H) and an output gradient ``g`` (N, H *
    F): every output by name (for checks and timings of the kernels;
    ``fused`` and ``kw`` as in :func:`attn_forward`)."""
    n, heads, feats = h.shape
    tab = pack_table(h.reshape(n, -1), s_src)
    fwd = attn_forward(lists, tab, s_dst, heads, feats, slope, salt, keep,
                       fused=fused, **kw)
    src = kw.get("given") or fwd
    return {**fwd, **attn_backward(lists, tab, s_dst, src["rmax0"],
                                   src["dinv"], g, heads, feats, slope, salt,
                                   keep, **kw)}


# ---- the chain over slices of the edges -----------------------------------
#
# Each rank walks its slice's row and column lists (the edges of a row may
# lie in several slices), and the per-row statistics are merged over the
# ranks with ``reduce(parts, op)``: ``parts`` the partials this process
# computed (one a rank under torch.distributed, where ``reduce`` is an
# all-reduce; every rank's in one process, where it folds the list), ``op``
# "max" or "sum".  A1 gives each slice's row maximum and denominator; the
# maxima merge by MAX (rows a slice does not hold count as -inf), the
# denominators are rescaled to the merged maximum and summed; A2's partial
# aggregations are summed.  In the backward A3's partial ``rowdot`` is
# summed first, then each slice's ``ds_dst`` is taken with that ``rowdot``
# (A3 again, given it) and summed, as are A4's ``dh`` and ``ds_src``.

def row_held(lst: EdgeList) -> torch.Tensor:
    """(N, 1) bool: the rows of ``lst`` that hold a slot."""
    return (lst.ptr[1:] > lst.ptr[:-1])[:, None]


def sharded_forward(ranks, tab, s_dst, heads, feats, slope, salt=None,
                    keep=1.0, *, reduce) -> dict:
    """A1 and A2 over the :class:`AttnLists` of the slices in ``ranks``,
    merged by ``reduce`` (above): ``rmax0``, ``dinv`` and ``out`` of the
    whole edge list, by name."""
    stats = [attn_stats(lst.rows, lst.mult, tab, s_dst, heads, feats, slope)
             for lst in ranks]
    held = [row_held(lst.rows) for lst in ranks]
    ninf = tab.new_full((), float("-inf"))
    mx = reduce([torch.where(hd, r0, ninf)
                 for (r0, _), hd in zip(stats, held)], "max")
    rmax0 = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    sums = reduce([torch.where(hd, torch.exp(r0 - rmax0) / dinv,
                               torch.zeros_like(dinv))
                   for (r0, dinv), hd in zip(stats, held)], "sum")
    dinv = 1.0 / sums.clamp(min=1e-30)
    out = reduce([attn_aggregate(lst.rows, lst.mult, tab, s_dst, rmax0,
                                 dinv, heads, feats, slope, salt, keep)
                  for lst in ranks], "sum")
    return dict(rmax0=rmax0, dinv=dinv, out=out)


def sharded_backward(ranks, tab, s_dst, rmax0, dinv, g, heads, feats, slope,
                     salt=None, keep=1.0, *, reduce) -> dict:
    """A3 and A4 over the slices in ``ranks`` with the merged ``rmax0`` and
    ``dinv``, merged by ``reduce``: ``rowdot``, ``ds_dst``, ``dh`` and
    ``ds_src`` by name."""
    args = (s_dst, rmax0, dinv, g, heads, feats, slope, salt, keep)
    rowdot = reduce([attn_bwd_rows(lst.rows, lst.mult, tab, *args)[0]
                     for lst in ranks], "sum")
    ds_dst = reduce([attn_bwd_rows(lst.rows, lst.mult, tab, *args,
                                   rowdot=rowdot)[1]
                     for lst in ranks], "sum")
    tabc = column_table(g, s_dst, rmax0, dinv, rowdot)
    cols = [attn_bwd_cols(lst.cols, lst.mult, tab, tabc, heads, feats, slope,
                          salt, keep) for lst in ranks]
    return dict(rowdot=rowdot, ds_dst=ds_dst,
                dh=reduce([c[0] for c in cols], "sum"),
                ds_src=reduce([c[1] for c in cols], "sum"))


def folded(parts, op):
    """``reduce`` over every rank's partials held in one process: their
    maximum, or their sum in rank order."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p) if op == "max" else out + p
    return out.contiguous()


# ---- the kernels' plain versions ------------------------------------------

def _slot_ids(lst: EdgeList) -> torch.Tensor:
    return (torch.arange(lst.n_edges, device=lst.device) if lst.eid is None
            else lst.eid.long())


def _weights(pre, m0, mu, slope):
    """``mult * exp(leaky_relu(pre) - m0)`` per (slot, head), rounded as
    the kernels round it."""
    e = torch.exp(F.leaky_relu(pre, slope) - m0)
    return e if mu is None else e * mu[:, None]


def _scale(lst, salt, keep, heads):
    """The dropout's scale per (slot, head), or None without dropout."""
    if salt is None:
        return None
    return _attn_keep_scale(_slot_ids(lst), salt, heads, keep)


def feature_lanes(heads: int, feats: int) -> Tuple[int, int]:
    """A1's and A2's lanes: ``(vec, group)``, float4 where F is a multiple
    of 4 (as :func:`head_lanes`), ``group`` lanes over the row's H * F
    features."""
    vec = 4 if feats % 4 == 0 else 1
    return vec, max(1, min(32, heads * feats // vec))


def head_lanes(heads: int, feats: int) -> Tuple[int, int, int]:
    """A3's and A4's lanes (``csrc/attention.cu``, ``head_lanes``): ``(vec,
    ne, group)``.  A head's F features are ``nq = F / vec`` vectors (float4
    where F is a multiple of 4), over ``ne = min(nq, 32)`` lanes; a unit's
    ``group`` lanes hold as many whole heads as fit in a warp."""
    vec = 4 if feats % 4 == 0 else 1
    ne = min(feats // vec, 32)
    return vec, ne, min(heads, 32 // ne) * ne


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_f a[..., f] * b[..., f]`` in A3's and A4's order: lane i of
    the head's ``ne`` lanes (:func:`head_lanes`) adds, from +0, the
    products of its vectors i, i + ne, ..., each vector's features in
    order; then, in steps s = 1, 2, 4, ..., lane i (a multiple of 2s, i +
    s < ne) adds lane i + s's sum, and lane 0's is the dot."""
    f = a.shape[-1]
    vec, ne, _ = head_lanes(1, f)
    prods = (a * b).reshape(*a.shape[:-1], f // vec, vec)
    lanes = torch.zeros(*a.shape[:-1], ne, dtype=torch.float32,
                        device=a.device)
    for c in range(0, f // vec, ne):
        n = min(ne, f // vec - c)
        for k in range(vec):
            lanes[..., :n] = lanes[..., :n] + prods[..., c:c + n, k]
    s = 1
    while s < ne:
        i = torch.arange(0, ne - s, 2 * s, device=a.device)
        lanes[..., i] = lanes[..., i] + lanes[..., i + s]
        s *= 2
    return lanes[..., 0]


def _slopes(pre, slope):
    """``leaky_relu``'s derivative at ``pre``: 1 where positive, else
    ``slope``."""
    return torch.where(pre > 0, torch.ones_like(pre),
                       torch.full_like(pre, slope))


def _mults(lst, mult):
    return None if mult is None else mult[_slot_ids(lst)]


def attn_stats_plain(lst, mult, tab, s_dst, heads, feats, slope):
    """The plain version of :func:`attn_stats`."""
    w = heads * feats
    rows, src = list_rows(lst), lst.idx.long()
    pre = tab[src, w:w + heads] + s_dst[rows]
    sg = F.leaky_relu(pre, slope)
    rmax = torch.full((lst.n_rows, heads), float("-inf"),
                      dtype=torch.float32, device=tab.device)
    rmax = rmax.scatter_reduce(0, rows[:, None].expand(-1, heads), sg,
                               reduce="amax")
    rmax0 = torch.where(torch.isfinite(rmax), rmax, torch.zeros_like(rmax))
    ex = _weights(pre, rmax0[rows], _mults(lst, mult), slope)
    dinv = 1.0 / ordered_row_sums(lst, ex).clamp(min=1e-30)
    return rmax0, dinv


def _alpha_rows(lst, mult, tab, s_dst, rmax0, dinv, heads, feats, slope):
    """Per slot of a row list: its source, ``pre`` and ``alpha``."""
    w = heads * feats
    rows, src = list_rows(lst), lst.idx.long()
    pre = tab[src, w:w + heads] + s_dst[rows]
    alpha = _weights(pre, rmax0[rows], _mults(lst, mult), slope) * dinv[rows]
    return rows, src, pre, alpha


def attn_aggregate_plain(lst, mult, tab, s_dst, rmax0, dinv, heads, feats,
                         slope, salt=None, keep=1.0):
    """The plain version of :func:`attn_aggregate`."""
    w = heads * feats
    _, src, _, alpha = _alpha_rows(lst, mult, tab, s_dst, rmax0, dinv,
                                   heads, feats, slope)
    scale = _scale(lst, salt, keep, heads)
    if scale is not None:
        alpha = alpha * scale
    terms = tab[src, :w].view(-1, heads, feats) * alpha[:, :, None]
    return ordered_row_sums(lst, terms.reshape(-1, w))


def _fold(m1, v1, m2, v2, col_head):
    """The fused walk's fold (``csrc/softmax_walk.cuh``, ``fold``) of
    ``(m2, v2)`` into ``(m1, v1)``, per row: ``M = max(m1, m2)`` per head
    ((R, H)), each column of ``v`` ((R, C), its head ``col_head``) ``v1 *
    exp(m1 - M) + v2 * exp(m2 - M)``, each product and the sum rounded."""
    big = torch.where(m2 > m1, m2, m1)
    e1 = torch.exp(m1 - big)[:, col_head]
    e2 = torch.exp(m2 - big)[:, col_head]
    return big, v1 * e1 + v2 * e2


def _fold_in_turn(m, v, index, count, col_head):
    """Per row i, the fold of the records ``index[i, 0], index[i, 1], ...``
    (the first ``count[i]``; (R, K) int64 into ``m`` (·, H) and ``v`` (·,
    C)) in turn: the first as it is, each next folded in."""
    fm, fv = m[index[:, 0]], v[index[:, 0]]
    for t in range(1, index.shape[1]):
        live = (t < count)[:, None]
        nm, nv = _fold(fm, fv, m[index[:, t]], v[index[:, t]], col_head)
        fm, fv = torch.where(live, nm, fm), torch.where(live, nv, fv)
    return fm, fv


def attn_softmax_aggregate_plain(lst, plan, mult, tab, s_dst, heads, feats,
                                 slope, salt=None, keep=1.0):
    """The plain version of :func:`attn_softmax_aggregate`: each segment (a
    row of a unit of whole rows, or a piece) as the walk takes it, then
    each split row's pieces folded as the walk and the merge fold them (runs
    of ``_RUN_PIECES`` pieces in turn; run q into part q % ``_MERGE_WARPS``
    in turn; the parts in order).  A whole row's outputs are those of
    :func:`attn_stats_plain` and :func:`attn_aggregate_plain`."""
    w = heads * feats
    n, dev = lst.n_rows, tab.device
    rows, src = list_rows(lst), lst.idx.long()
    unit = torch.searchsorted(
        lst.unit_edge.long(), torch.arange(lst.n_edges, device=dev),
        right=True) - 1
    piece = lst.unit_row.long()[unit] < 0
    seg = torch.where(piece, n + unit, rows)
    n_seg = n + lst.n_units
    pre = tab[src, w:w + heads] + s_dst[rows]
    big = torch.full((n_seg, heads), float("-inf"), dtype=torch.float32,
                     device=dev).scatter_reduce(
        0, seg[:, None].expand(-1, heads), F.leaky_relu(pre, slope),
        reduce="amax")
    m0 = torch.where(torch.isfinite(big), big, torch.zeros_like(big))
    wgt = _weights(pre, m0[seg], _mults(lst, mult), slope)
    sums = torch.zeros(n_seg, heads, dtype=torch.float32,
                       device=dev).index_add_(0, seg, wgt)
    dinv = 1.0 / sums.clamp(min=1e-30)
    alpha = torch.where(piece[:, None], wgt, wgt * dinv[seg])
    scale = _scale(lst, salt, keep, heads)
    if scale is not None:
        alpha = alpha * scale
    terms = (tab[src, :w].view(-1, heads, feats) * alpha[:, :, None])
    acc = torch.zeros(n_seg, w, dtype=torch.float32, device=dev).index_add_(
        0, seg, terms.reshape(-1, w))
    rmax0, dinv, out = m0[:n].clone(), dinv[:n].clone(), acc[:n].clone()
    split = lst.split.long()
    if split.shape[0] == 0:
        return rmax0, dinv, out
    # each piece a record: its maximum, and its sum and terms under it
    col_head = torch.cat([torch.arange(w, device=dev) // feats,
                          torch.arange(heads, device=dev)])
    rec_m, rec_v = m0[n:], torch.cat([acc[n:], sums[n:]], 1)
    task = plan.task.to(dev).long()[:plan.n_runs]
    k = torch.arange(_RUN_PIECES, device=dev)
    run_m, run_v = _fold_in_turn(
        rec_m, rec_v, (task[:, :1] + k).clamp(max=lst.n_units - 1),
        task[:, 1], col_head)
    # each split row's runs: part g folds runs g, g + P, ... in turn, then
    # the parts in order
    runs = plan.split_runs.to(dev).long()
    p = _MERGE_WARPS
    depth = -(-int(runs[:, 1].max()) // p)
    q = torch.arange(p, device=dev)[:, None] + p * torch.arange(
        depth, device=dev)
    idx = (runs[:, :1, None] + q).reshape(-1, depth).clamp(
        max=plan.n_runs - 1)
    count = (runs[:, 1:] - torch.arange(p, device=dev) + p - 1) // p
    part_m, part_v = _fold_in_turn(run_m, run_v, idx, count.reshape(-1),
                                   col_head)
    n_split = split.shape[0]
    part = (torch.arange(n_split, device=dev)[:, None] * p
            + torch.arange(p, device=dev))
    row_m, row_v = _fold_in_turn(part_m, part_v, part,
                                 runs[:, 1].clamp(max=p), col_head)
    row_dinv = 1.0 / row_v[:, w:].clamp(min=1e-30)
    target = split[:, 0]
    rmax0[target] = row_m
    dinv[target] = row_dinv
    out[target] = row_v[:, :w] * row_dinv[:, col_head[:w]]
    return rmax0, dinv, out


def attn_bwd_rows_plain(lst, mult, tab, s_dst, rmax0, dinv, g, heads, feats,
                        slope, salt=None, keep=1.0, rowdot=None):
    """The plain version of :func:`attn_bwd_rows`."""
    sums = _row_pass_sums(lst, mult, tab, s_dst, rmax0, dinv, g, heads,
                          feats, slope, salt, keep)
    own = sums[:, :heads]
    given = own if rowdot is None else rowdot
    return own, sums[:, heads:2 * heads] - given * sums[:, 2 * heads:]


def _row_pass_sums(lst, mult, tab, s_dst, rmax0, dinv, g, heads, feats,
                   slope, salt, keep):
    """A3's three sums a (row, head), ``[rowdot | P | Q]`` (N, 3H)."""
    w = heads * feats
    rows, src, pre, alpha = _alpha_rows(lst, mult, tab, s_dst, rmax0, dinv,
                                        heads, feats, slope)
    da = _dots(tab[src, :w].view(-1, heads, feats),
               g[rows].view(-1, heads, feats))
    scale = _scale(lst, salt, keep, heads)
    if scale is not None:
        da = da * scale
    wgt = alpha * da
    sp = _slopes(pre, slope)
    return ordered_row_sums(lst, torch.cat([wgt, wgt * sp, alpha * sp], 1))


def attn_error_scales(lists, tab, s_dst, rmax0, dinv, g, rowdot, heads,
                      feats, slope, salt=None, keep=1.0) -> dict:
    """For checks of A1-A4 against their plain versions: per output
    element, the sum of the magnitudes of the terms it adds (the scale of
    float32 summation error), by the plain versions on magnitudes.
    ``rmax0``: its own magnitude; ``dinv``: itself (a sum of positive
    terms); ``out`` and ``dh``: sums of ``alpha~ |h|`` and ``alpha~ |g|``;
    ``rowdot``: of ``alpha |h| . |g|``; ``ds_dst``: ``P + rowdot Q`` of
    those; ``ds_src``: of ``(alpha |dalpha| + alpha |rowdot|) sigma'``."""
    w = heads * feats
    abs_tab = pack_table(tab[:, :w].abs(), tab[:, w:w + heads])
    args = (slope, salt, keep)
    out = attn_aggregate_plain(lists.rows, lists.mult, abs_tab, s_dst, rmax0,
                               dinv, heads, feats, *args)
    sums = _row_pass_sums(lists.rows, lists.mult, abs_tab, s_dst, rmax0,
                          dinv, g.abs(), heads, feats, *args)
    tabc = column_table(g.abs(), s_dst, rmax0, dinv, -rowdot.abs())
    dh, ds_src = attn_bwd_cols_plain(lists.cols, lists.mult, abs_tab, tabc,
                                     heads, feats, *args)
    return dict(rmax0=rmax0.abs(), dinv=dinv, out=out,
                rowdot=sums[:, :heads],
                ds_dst=sums[:, heads:2 * heads]
                + sums[:, :heads] * sums[:, 2 * heads:],
                dh=dh, ds_src=ds_src)


def attn_bwd_cols_plain(lst, mult, tab, tabc, heads, feats, slope, salt=None,
                        keep=1.0):
    """The plain version of :func:`attn_bwd_cols`."""
    w = heads * feats
    own, dst = list_rows(lst), lst.idx.long()
    row = tabc[dst]
    sd, m0, di, rdot = row[:, w:w + 4 * heads].view(-1, heads, 4).unbind(2)
    pre = tab[own, w:w + heads] + sd
    alpha = _weights(pre, m0, _mults(lst, mult), slope) * di
    scale = _scale(lst, salt, keep, heads)
    alpha_t = alpha if scale is None else alpha * scale
    gs = row[:, :w].view(-1, heads, feats)
    dh = ordered_row_sums(lst, (gs * alpha_t[:, :, None]).reshape(-1, w))
    da = _dots(tab[own, :w].view(-1, heads, feats), gs)
    if scale is not None:
        da = da * scale
    dsig = alpha * da - alpha * rdot
    sp = _slopes(pre, slope)
    return dh, ordered_row_sums(lst, dsig * sp)


# ---- the kernels' wrappers --------------------------------------------------

_POINTERS = ("ptr", "idx", "eid", "unit_row", "unit_edge", "split",
             "part_item", "mult", "salt", "tab", "tabc", "s_dst", "rmax0",
             "dinv", "g", "rowdot", "out", "out2", "carry")
_INTS = ("n_units", "n_split", "n_part_items", "parts", "heads", "feats",
         "ld", "ldc", "vec", "group", "sgroup")


class _Args(ctypes.Structure):
    """``AttnArgs`` of ``csrc/attention.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in _POINTERS]
                + [(name, ctypes.c_int) for name in _INTS]
                + [("thresh", ctypes.c_uint32), ("scale", ctypes.c_float),
                   ("slope", ctypes.c_float)]
                + [(name, ctypes.c_void_p) for name in ("out3", "task",
                                                        "split_runs")]
                + [("n_tasks", ctypes.c_int), ("n_runs", ctypes.c_int)])


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built on
    first use, never at import)."""
    lib = kernels.load("attention")
    for entry in ("gnntf_attn_stats", "gnntf_attn_aggregate",
                  "gnntf_attn_softmax_aggregate", "gnntf_attn_bwd_rows",
                  "gnntf_attn_bwd_cols"):
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    return lib


def _check(what, lst, tab, heads, feats, per_row=(), gathered=()):
    """Raise unless the kernel can take these inputs: float32, contiguous,
    on the list's device; ``tab`` and the ``gathered`` tables (N, ld) with
    room for their columns; the ``per_row`` tensors (N, width)."""
    n = lst.n_rows
    w = heads * feats
    tensors = [(tab, w + heads)] + list(gathered) + list(per_row)
    for t, width in tensors:
        if t.dim() != 2 or t.shape[0] != n or t.shape[1] < width or (
                t.dtype != torch.float32):
            raise TypeError(f"{what}: expected ({n}, >= {width}) float32, got "
                            f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} inputs must be contiguous")
        if t.device != lst.device:
            raise ValueError(f"{what} inputs span devices {t.device} and "
                             f"{lst.device}")
    if tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {tab.device}")


def _launch(entry, lst, mult, heads, feats, slope, salt, keep, tensors,
            carry_width, lanes, plan=None):
    """Run ``entry`` of the library on the current stream.  ``tensors``
    names the launch's tables and outputs (``_POINTERS``, ``out3``); the
    carry is made here, ``carry_width`` floats a unit and a split row's
    part, or with a ``plan`` (the fused walk's) a run.  ``lanes`` is the
    kernel's ``(vec, group)`` (:func:`feature_lanes`, :func:`head_lanes`);
    a gathered table whose rows are not 16-byte aligned is copied
    (:func:`_aligned`)."""
    (ptr, idx, eid, _, unit_row, unit_edge, split, part_item), (
        n_units, n_split, n_part_items) = lst.addresses
    device = lst.device
    args = _Args(ptr=ptr, idx=idx, eid=eid, unit_row=unit_row,
                 unit_edge=unit_edge, split=split, part_item=part_item)
    keep_alive = []
    if mult is not None:
        args.mult = mult.data_ptr()
    if salt is not None:
        salt = device_salt(salt, device)
        keep_alive.append(salt)
        args.salt = salt.data_ptr()
        args.thresh = _threshold(keep)
        args.scale = float(torch.tensor(1.0 / keep, dtype=torch.float32))
    vec, group = lanes
    tensors = {name: _aligned(t, vec) if name in ("tab", "tabc", "g") else t
               for name, t in tensors.items()}
    for name, t in tensors.items():
        setattr(args, name, t.data_ptr())
    if plan is not None:
        args.task, args.split_runs = (plan.task.data_ptr(),
                                      plan.split_runs.data_ptr())
        args.n_tasks, args.n_runs = plan.n_tasks, plan.n_runs
    if n_split:
        records = (plan.n_runs if plan is not None
                   else n_units + n_split * lst.parts)
        c = torch.empty(records * carry_width, dtype=torch.float32,
                        device=device)
        keep_alive.append(c)
        args.carry = c.data_ptr()
    tab, tabc = tensors["tab"], tensors.get("tabc")
    args.n_units, args.n_split, args.n_part_items = n_units, n_split, \
        n_part_items
    args.parts, args.heads, args.feats = lst.parts, heads, feats
    args.ld = tab.shape[1]
    args.ldc = 0 if tabc is None else tabc.shape[1]
    args.vec, args.group = vec, group
    args.sgroup = max(1, min(32, heads))
    args.slope = slope
    lib = _library()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(ctypes.byref(args),
                                 torch.cuda.current_stream(device).cuda_stream)
    kernels.check(lib, rc, f"{entry} launch")
    del keep_alive  # the stream orders their reuse after the kernels


def _carry_width(cols: int) -> int:
    """A3's and A4's carry row of ``cols`` floats (``csrc/attention.cu``,
    ``carry_stride``): padded to a multiple of 4, summed a float4 at a
    time."""
    return -(-cols // 4) * 4


def _aligned(t: torch.Tensor, vec: int) -> torch.Tensor:
    """``t``, or where its rows are read a float4 at a time (``vec`` 4) and
    do not each start 16-byte aligned, a copy padded as :func:`pack_table`
    pads: the lanes, and so the order of A3's and A4's dots, depend on the
    shapes alone."""
    if vec == 1 or (t.data_ptr() % 16 == 0 and t.shape[1] % 4 == 0):
        return t
    return pack_table(t)


def attn_stats(lst: EdgeList, mult, tab: torch.Tensor, s_dst: torch.Tensor,
               heads: int, feats: int,
               slope: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """A1: per (destination, head) over the row list ``lst``, ``rmax0``
    (the row's maximum ``leaky_relu(s_src[src] + s_dst[dst])``, 0 where it
    has none or it is not finite) and ``dinv`` (``1 / max(sum mult *
    exp(sg - rmax0), 1e-30)``), each (N, H) float32.  ``tab`` is ``[h |
    s_src]`` (:func:`pack_table`), ``mult`` the pair multiplicities or
    None.  CPU tensors take :func:`attn_stats_plain`; CUDA tensors launch
    the kernel (counted in ``attn_stats.launches``)."""
    _check("attn_stats", lst, tab, heads, feats, per_row=[(s_dst, heads)])
    if tab.device.type == "cpu":
        return attn_stats_plain(lst, mult, tab, s_dst, heads, feats, slope)
    rmax0 = torch.empty(lst.n_rows, heads, dtype=torch.float32,
                        device=tab.device)
    dinv = torch.empty_like(rmax0)
    if lst.n_units:
        _launch("gnntf_attn_stats", lst, mult, heads, feats, slope, None, 1.0,
                dict(tab=tab, s_dst=s_dst, out=rmax0, out2=dinv), heads,
                feature_lanes(heads, feats))
        attn_stats.launches += 1
    return rmax0, dinv


attn_stats.launches = 0


def attn_aggregate(lst: EdgeList, mult, tab, s_dst, rmax0, dinv, heads: int,
                   feats: int, slope: float, salt=None,
                   keep: float = 1.0) -> torch.Tensor:
    """A2: ``out[dst, h, :] = sum alpha~ h[src, h, :]`` over the row list,
    as an (N, H * F) float32 tensor, ``alpha~ = mult * exp(sg - rmax0) *
    dinv`` times the dropout's scale where a ``salt`` is given.  CPU tensors
    take :func:`attn_aggregate_plain`; CUDA tensors launch the kernel
    (counted in ``attn_aggregate.launches``)."""
    _check("attn_aggregate", lst, tab, heads, feats,
           per_row=[(s_dst, heads), (rmax0, heads), (dinv, heads)])
    if tab.device.type == "cpu":
        return attn_aggregate_plain(lst, mult, tab, s_dst, rmax0, dinv,
                                    heads, feats, slope, salt, keep)
    out = torch.empty(lst.n_rows, heads * feats, dtype=torch.float32,
                      device=tab.device)
    if lst.n_units:
        _launch("gnntf_attn_aggregate", lst, mult, heads, feats, slope, salt,
                keep, dict(tab=tab, s_dst=s_dst, rmax0=rmax0, dinv=dinv,
                           out=out), heads * feats,
                feature_lanes(heads, feats))
        attn_aggregate.launches += 1
    return out


attn_aggregate.launches = 0


def attn_softmax_aggregate(lst: EdgeList, plan: SoftmaxPlan, mult, tab,
                           s_dst, heads: int, feats: int, slope: float,
                           salt=None, keep: float = 1.0):
    """A1 and A2 as one walk over the row list ``lst`` with its ``plan``
    (:func:`softmax_plan`): ``(rmax0, dinv, out)``, those of
    :func:`attn_stats` and :func:`attn_aggregate`, each score gathered and
    exponentiated once, a split row's pieces folded by rescaling to the
    row's maximum.  CPU tensors take :func:`attn_softmax_aggregate_plain`;
    CUDA tensors launch the walk and, where a row is split, the merge
    (counted once in ``attn_softmax_aggregate.launches``); inputs the walk
    cannot take (:func:`softmax_route`) raise."""
    _check("attn_softmax_aggregate", lst, tab, heads, feats,
           per_row=[(s_dst, heads)])
    if tab.device.type == "cpu":
        return attn_softmax_aggregate_plain(lst, plan, mult, tab, s_dst,
                                            heads, feats, slope, salt, keep)
    if plan is None or not _softmax_lanes(heads, feats):
        raise ValueError(f"attn_softmax_aggregate takes a plan, at most 32 "
                         f"heads, whole heads of lanes and at most 128 "
                         f"feature vectors a row, not H={heads} F={feats} "
                         f"plan={plan is not None}")
    rmax0 = torch.empty(lst.n_rows, heads, dtype=torch.float32,
                        device=tab.device)
    dinv = torch.empty_like(rmax0)
    out = torch.empty(lst.n_rows, heads * feats, dtype=torch.float32,
                      device=tab.device)
    if plan.n_tasks:
        _launch("gnntf_attn_softmax_aggregate", lst, mult, heads, feats,
                slope, salt, keep, dict(tab=tab, s_dst=s_dst, out=out,
                                        out2=dinv, out3=rmax0),
                _carry_width(heads * feats + 2 * heads),
                feature_lanes(heads, feats), plan=plan)
        attn_softmax_aggregate.launches += 1
    return rmax0, dinv, out


attn_softmax_aggregate.launches = 0


def attn_bwd_rows(lst: EdgeList, mult, tab, s_dst, rmax0, dinv, g, heads: int,
                  feats: int, slope: float, salt=None, keep: float = 1.0,
                  rowdot=None):
    """A3: the backward's row pass over the row list, with ``g`` (N, H * F)
    the output's gradient: ``rowdot = sum alpha dalpha`` and ``ds_dst = sum
    (alpha dalpha - alpha rowdot) sigma'(pre)``, computed as ``P - rowdot
    * Q``, each (N, H) float32 (``dalpha = <h[src], g[dst]>`` per head
    times the dropout's scale).  A given ``rowdot`` (N, H) takes the place
    of the row's own in ``ds_dst`` (a slice of the edges: the sum over every
    slice).  CPU tensors take :func:`attn_bwd_rows_plain`; CUDA tensors
    launch the kernel (counted in ``attn_bwd_rows.launches``)."""
    given = [] if rowdot is None else [(rowdot, heads)]
    _check("attn_bwd_rows", lst, tab, heads, feats,
           per_row=[(s_dst, heads), (rmax0, heads), (dinv, heads),
                    (g, heads * feats)] + given)
    if tab.device.type == "cpu":
        return attn_bwd_rows_plain(lst, mult, tab, s_dst, rmax0, dinv, g,
                                   heads, feats, slope, salt, keep, rowdot)
    own = torch.empty(lst.n_rows, heads, dtype=torch.float32,
                      device=tab.device)
    ds_dst = torch.empty_like(own)
    if lst.n_units:
        vec, _, group = head_lanes(heads, feats)
        tensors = dict(tab=tab, s_dst=s_dst, rmax0=rmax0, dinv=dinv, g=g,
                       out=own, out2=ds_dst)
        if rowdot is not None:
            tensors["rowdot"] = rowdot
        _launch("gnntf_attn_bwd_rows", lst, mult, heads, feats, slope, salt,
                keep, tensors, _carry_width(3 * heads), lanes=(vec, group))
        attn_bwd_rows.launches += 1
    return own, ds_dst


attn_bwd_rows.launches = 0


def attn_bwd_cols(lst: EdgeList, mult, tab, tabc, heads: int, feats: int,
                  slope: float, salt=None, keep: float = 1.0):
    """A4: the column pass over the column list (a row is a source c): ``dh
    [c, h, :] = sum alpha~ g[dst, h, :]`` ((N, H * F) float32) and ``ds_src
    [c, h] = sum (alpha dalpha - alpha rowdot[dst]) sigma'(pre)`` ((N, H)),
    ``tab`` as in :func:`attn_stats` and ``tabc`` the destinations' ``g``
    and per-head scalars (:func:`column_table`).  CPU tensors take
    :func:`attn_bwd_cols_plain`; CUDA tensors launch the kernel (counted in
    ``attn_bwd_cols.launches``)."""
    _check("attn_bwd_cols", lst, tab, heads, feats,
           gathered=[(tabc, heads * feats + 4 * heads)])
    if tab.device.type == "cpu":
        return attn_bwd_cols_plain(lst, mult, tab, tabc, heads, feats, slope,
                                   salt, keep)
    dh = torch.empty(lst.n_rows, heads * feats, dtype=torch.float32,
                     device=tab.device)
    ds_src = torch.empty(lst.n_rows, heads, dtype=torch.float32,
                         device=tab.device)
    if lst.n_units:
        vec, _, group = head_lanes(heads, feats)
        _launch("gnntf_attn_bwd_cols", lst, mult, heads, feats, slope, salt,
                keep, dict(tab=tab, tabc=tabc, out=dh, out2=ds_src),
                _carry_width(heads * feats + heads), lanes=(vec, group))
        attn_bwd_cols.launches += 1
    return dh, ds_src


attn_bwd_cols.launches = 0


# each kernel's wrapper and plain version, by name
_KERNELS = {"attn_stats": (attn_stats, attn_stats_plain),
            "attn_aggregate": (attn_aggregate, attn_aggregate_plain),
            "attn_softmax_aggregate": (attn_softmax_aggregate,
                                       attn_softmax_aggregate_plain),
            "attn_bwd_rows": (attn_bwd_rows, attn_bwd_rows_plain),
            "attn_bwd_cols": (attn_bwd_cols, attn_bwd_cols_plain)}
