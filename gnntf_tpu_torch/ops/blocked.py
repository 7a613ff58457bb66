"""K2, the blocked-COO SpMM, and its layout.

``block_coo`` re-blocks an edge list into chunks of ``block_edges`` slots
whose edges all fall inside one (row-window, col-tile) block of the
adjacency: rows of a chunk lie in ``[w*W, (w+1)*W)``, columns in
``[t*T, (t+1)*T)``.  Chunks are window-major; every window without edges
gets one all-padding chunk.  The layout is numpy, a copy of the JAX
package's ``ops/pallas/format.py`` so every field is bit-equal.  It pays off
on reordered or clustered graphs (``graph/reorder.py::rcm_order``), where
edges fill their chunks.

The kernel does not walk the slot grid.  :func:`edge_lists` turns the
layout's live slots into two per-edge CSR lists, one for ``A`` and one for
``A^T``; :func:`graph_lists` derives the same two lists from the edges with
two stable sorts, which is what :func:`blocked_layout` does.
:func:`work_units` cuts each list into units of :func:`unit_items` edges
and row ends for the kernel's workers.  :class:`BlockedSpMM` holds the two
lists on a device.

``blocked_spmm`` is the kernel's wrapper.  It replaces the TPU kernel
``gnntf_tpu/ops/pallas/spmm.py::_kernel``; the CUDA source,
``gnntf_tpu_torch/csrc/blocked_spmm.cu``, states its bound, and
``csrc/edge_walk.cuh`` the walk's design.  K1 (``ops/ell_gather.py``) runs
the same walk over a list with row ids, adding into a base.  A CPU tensor
takes :func:`blocked_spmm_plain`; a CUDA tensor launches the kernel or
raises.  ``spmm_pallas`` is the differentiable SpMM over it: the forward
runs the kernel over the forward list, the backward's ``dx = A^T dy`` runs
it over the transposed list, and the values' gradient (the JAX package's
``_pallas_vjp_fn``) is plain torch, computed only when asked for.

``spmm_pallas(..., bf16=True)`` is the TPU kernel's bfloat16 mode: ``x`` is
rounded to bfloat16 once a call and :func:`blocked_spmm_bf16` walks the
forward list over it, each term ``val * x`` rounded to bfloat16 and summed
in float32 (:func:`blocked_spmm_bf16_plain` on the CPU); :func:`bf16_plan`
picks its walk (``csrc/bf16_walk.cuh``'s staged walk,
``csrc/share_walk.cuh``'s walk over equal shares of the list's edges, or
the generic walk of ``edge_walk.cuh``).  The backward is the float32 one,
over the unrounded ``x``, as the JAX package's is.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..graph.coo import Graph
from ..utils import kernels
from ..utils.idcache import IdLRU, sizeof

# the unit sizes (items: edges and row ends) that unit_items picks from,
# and its scale: a list of n items takes the least size s with n <=
# (_UNIT_SCALE * s)^2, so s grows as the square root of n
_UNIT_SIZES = (16, 32, 64, 128)
_UNIT_SCALE = 12
# K2's bfloat16 mode (bf16_plan): None takes each width's walk by the rule;
# a number (8, 4, 2, 1) forces the generic walk at the widest load up to it,
# whatever the lanes (k2_sweep.py --kernels k2bf16 times each)
_BF16_VEC = None
# the staged walk (csrc/bf16_walk.cuh): batches in its ring and the ring's
# bytes a warp (the edges a batch follow from them, bf16_rows)
_BF16_DEPTH = 2
_BF16_RING_BYTES = 12288
# the widths the staged walk takes and, at each, the fewest edges of a list
# that it is given (bf16_plan)
_BF16_STAGED_EDGES = {16: 1_000_000, 24: 150_000, 32: 0, 40: 0}
# the sweep's override of the staged walk's ring: (depth, rows)
_BF16_RING = None
# warps a block of the staged walk and the most shared memory a block asks
# for (kWarps, kMaxSmem in csrc/bf16_walk.cuh)
_BF16_WARPS = 4
_BF16_SMEM = 49152
# the fewest loads a row that the wide walk takes (kNarrowLanes in
# csrc/blocked_spmm.cu)
_NARROW_LANES = 8
# a split row's pieces are summed in this many parts: part g takes pieces
# g, g + P, g + 2P, ... in turn, then the parts are added in order.  This
# fixes the order of the sum; the kernel's launch geometry does not.  A list
# keeps the value it was built with (``EdgeList.parts``).
_FIXUP_PARTS = 64
# K1's degree walk (csrc/degree_walk.cuh, kLanes and kEdges): lanes a block
# and consecutive edges a lane; a block takes DEGREE_SHARE edges of the list
DEGREE_LANES = 128
DEGREE_EDGES = 16
DEGREE_SHARE = DEGREE_LANES * DEGREE_EDGES
# K2's bfloat16 share walk (csrc/share_walk.cuh, kShare, kThreads and
# kFoldRange): edges a block's share of the list and threads a block (a
# group of bf16_share_lanes(F) lanes takes a run of BF16_SHARE *
# lanes / BF16_SHARE_THREADS of them), and the blocks' sums a range of its
# fold; the least and the most width it takes (F % 8 == 0)
BF16_SHARE = 1024
BF16_SHARE_THREADS = 256
BF16_FOLD_RANGE = 32
BF16_SHARE_WIDTHS = (64, 256)
# the lists that bf16_plan gives the share walk, by the lanes of its groups
# (bf16_share_lanes: 8 at F = 64, 16 at F = 72-128, 32 at F = 136-256): the
# fewest edges, and the fewest edges a row (the list's edges over its rows,
# empty ones too); {} gives it no list
_BF16_SHARE_LISTS = {8: (40_000, 0), 16: (150_000, 4), 32: (300_000, 0)}


@dataclasses.dataclass(frozen=True)
class BlockedCOO:
    """Edge structure re-blocked for K2.  ``rows``/``cols`` are relative to
    their window/tile base, flat over ``n_chunks * block_edges`` slots;
    ``perm[e]`` is the flat slot of original edge ``e``."""

    rows: np.ndarray          # (C*BE,) int32, in [0, window)
    cols: np.ndarray          # (C*BE,) int32, in [0, tile)
    perm: np.ndarray          # (E,) int32 — flat slot of original edge e
    chunk_window: np.ndarray  # (C,) int32 output row-window per chunk
    chunk_tile: np.ndarray    # (C,) int32 x col-tile per chunk
    n_nodes: int
    window: int
    tile: int
    block_edges: int
    n_windows: int
    n_tiles: int

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_window.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.perm.shape[0])

    @property
    def fill_factor(self) -> float:
        """Fraction of edge slots holding real edges (1.0 = no padding)."""
        return self.n_edges / max(1, self.rows.shape[0])

    @functools.cached_property
    def chunk_len(self) -> np.ndarray:
        """(C,) int32 live slots per chunk (a prefix of each chunk)."""
        return np.bincount(self.perm // self.block_edges,
                           minlength=self.n_chunks).astype(np.int32)


def block_coo(row, col, n_nodes: int, *, window: int = 256,
              tile: int = 256, block_edges: int = 1024) -> BlockedCOO:
    """Build the blocked layout from COO structure (host-side, once per
    structure).  Duplicate edges sum; edge order inside a block is free."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    n_windows = -(-n_nodes // window)
    n_tiles = -(-n_nodes // tile)

    w = row // window
    t = col // tile
    # window-major order, tile minor; stable so the layout is deterministic
    order = np.lexsort((t, w))
    row, col, w, t = row[order], col[order], w[order], t[order]

    block_key = w * n_tiles + t
    change = np.ones(len(row), dtype=bool)
    if len(row):
        change[1:] = block_key[1:] != block_key[:-1]
    run_id = np.cumsum(change) - 1 if len(row) else np.zeros(0, np.int64)
    run_starts = np.flatnonzero(change) if len(row) else np.zeros(0, np.int64)
    idx_in_run = np.arange(len(row)) - run_starts[run_id] if len(row) else row
    chunk_in_run = idx_in_run // block_edges

    chunk_key = run_id * (1 << 32) + chunk_in_run
    chunk_change = np.ones(len(row), dtype=bool)
    if len(row):
        chunk_change[1:] = chunk_key[1:] != chunk_key[:-1]
    chunk_id = (np.cumsum(chunk_change) - 1) if len(row) \
        else np.zeros(0, np.int64)
    slot = idx_in_run - chunk_in_run * block_edges

    n_edge_chunks = int(chunk_id[-1]) + 1 if len(row) else 0

    # windows with no edges still get one chunk, as in the TPU layout
    windows_with_edges = np.zeros(n_windows, dtype=bool)
    if len(row):
        windows_with_edges[w] = True
    empty_windows = np.flatnonzero(~windows_with_edges)
    n_chunks = n_edge_chunks + len(empty_windows)

    BE = block_edges
    rows_b = np.zeros(n_chunks * BE, np.int32)
    cols_b = np.zeros(n_chunks * BE, np.int32)
    perm = np.zeros(len(row), np.int64)
    cw = np.zeros(n_chunks, np.int32)
    ct = np.zeros(n_chunks, np.int32)

    if len(row):
        flat = chunk_id * BE + slot
        rows_b[flat] = (row - w * window).astype(np.int32)
        cols_b[flat] = (col - t * tile).astype(np.int32)
        perm[order] = flat
        first_of_chunk = np.flatnonzero(chunk_change)
        cw[:n_edge_chunks] = w[first_of_chunk].astype(np.int32)
        ct[:n_edge_chunks] = t[first_of_chunk].astype(np.int32)

    # append empty-window chunks, then re-sort chunks window-major
    cw[n_edge_chunks:] = empty_windows.astype(np.int32)
    ct[n_edge_chunks:] = 0
    corder = np.argsort(cw, kind="stable")
    cw, ct = cw[corder], ct[corder]
    reindex = (corder[:, None] * BE + np.arange(BE)[None, :]).ravel()
    rows_b, cols_b = rows_b[reindex], cols_b[reindex]
    inv = np.empty(n_chunks * BE, np.int64)
    inv[reindex] = np.arange(n_chunks * BE)
    perm = inv[perm]

    return BlockedCOO(
        rows=rows_b, cols=cols_b, perm=perm.astype(np.int32),
        chunk_window=cw, chunk_tile=ct,
        n_nodes=n_nodes, window=window, tile=tile, block_edges=block_edges,
        n_windows=n_windows, n_tiles=n_tiles,
    )


def row_ptr(rows: np.ndarray, n_rows: int) -> np.ndarray:
    """CSR row pointer (n_rows + 1,) of row ids sorted ascending."""
    return np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=n_rows))])


def edge_lists(layout: BlockedCOO):
    """The layout's live edges as two CSR lists, ``(ptr, idx, eid)`` each,
    all int32.  Forward (``A``): the live slots in the layout's work order
    (window, row inside the window, slot), so ``ptr`` (N+1) indexes
    destination rows, ``idx`` holds each edge's absolute source
    (``chunk_tile * T + cols``) and ``eid`` its edge id (``perm[eid] ==
    slot``).  Transposed (``A^T``): the same edges stable-sorted by
    (source, destination), ``ptr`` over sources and ``idx`` the
    destinations.  On a graph sorted by (row, col), as ``from_edges``
    builds it, the forward ``eid`` is ``arange(E)``."""
    perm = layout.perm.astype(np.int64)
    chunk = perm // layout.block_edges
    win = layout.chunk_window[chunk].astype(np.int64)
    rel = layout.rows[perm]
    eid = np.lexsort((perm, rel, win))
    dst = (win * layout.window + rel)[eid]
    src = (layout.chunk_tile[chunk].astype(np.int64) * layout.tile
           + layout.cols[perm])[eid]
    return _both_lists(dst, src, eid, layout.n_nodes)


def graph_lists(row, col, n_nodes: int, tile: int = 256):
    """:func:`edge_lists` of ``block_coo(row, col, n_nodes, tile=tile)``,
    bit for bit, from the edges alone: the forward list is the edges stably
    sorted by (row, col // tile), the order in which the layout holds a
    row's edges (tile by tile, each tile's in edge order); the transposed
    list is that stably sorted by (col, row).  The window and the chunk size
    do not change the lists."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    eid = np.lexsort((col // tile, row))
    return _both_lists(row[eid], col[eid], eid, n_nodes)


def _both_lists(dst, src, eid, n):
    """The forward list of the edges ``src -> dst`` in the given order and
    the transposed list, the same stably sorted by (src, dst), int32."""
    order = np.lexsort((dst, src))
    lists = ((row_ptr(dst, n), src, eid),
             (row_ptr(src[order], n), dst[order], eid[order]))
    return tuple(tuple(a.astype(np.int32) for a in lst) for lst in lists)


def unit_items(n_items: int) -> int:
    """The unit size of a list of ``n_items`` items (edges and row ends):
    the least of ``_UNIT_SIZES`` with ``n_items <= (_UNIT_SCALE * size) **
    2``, else the largest: 16 up to 36,864 items, 32 up to 147,456, 64 up
    to 589,824, then 128.  A pure function of the count, so the card and
    the CPU plain version cut a list alike.

    Why.  A unit is one worker's chain of dependent loads, so its time
    grows with its size; the units' count sets how many workers the card
    must hold and schedule.  The sum is least near a size that grows as
    the square root of the list; ``_UNIT_SCALE`` fits it to
    ``k2_sweep.py --kernels k2small`` (NVIDIA H100 80GB HBM3, 700 W; one
    call's device time over the forward and the transposed list at F = 1, 7
    and 64; PERF.md §6): at Cora's 13,264 items 16 was the fastest (4.5-5.9
    us on uniform edges, against 11.7-22.5 at 128; 8 splits 52 rows and
    takes 8.3-9.7), at 99,994 items 16 or 32, at 752,462 items 64 or 128,
    and at the benchmark graph's 2,501,821 items 128, the size its own
    sweep chose."""
    for size in _UNIT_SIZES:
        if n_items <= (_UNIT_SCALE * size) ** 2:
            return size
    return _UNIT_SIZES[-1]


def work_units(ptr: np.ndarray, items: int):
    """Cut a list's rows into K2's units of work, about ``items`` items each
    (an item is an edge or a row's end).  A unit is a run of whole rows, or,
    for a row of more than ``items`` edges, a piece of at most ``items`` of
    its edges.  Returns int32 ``(unit_row, unit_edge, split)``: unit ``u``
    holds edges ``unit_edge[u]:unit_edge[u + 1]``; ``unit_row[u]`` is its
    first row, or ``~row`` for a piece; ``unit_row[-1]`` is the row count.
    ``split`` (S, 3) lists each split row with its first piece and number
    of pieces, which are consecutive units."""
    ptr = np.asarray(ptr, np.int64)
    n = len(ptr) - 1
    deg = np.diff(ptr)
    split = deg > items
    cost = np.where(split, 0, deg + 1)
    bucket = (np.cumsum(cost) - cost) // items
    starts = ~split
    starts[1:] &= split[:-1] | (bucket[1:] != bucket[:-1])
    starts = np.flatnonzero(starts)
    rows_split = np.flatnonzero(split)
    n_pieces = -(-deg[rows_split] // items)
    first_piece = np.cumsum(n_pieces) - n_pieces
    piece_row = np.repeat(rows_split, n_pieces)
    piece_edge = ptr[piece_row] + items * (
        np.arange(len(piece_row)) - np.repeat(first_piece, n_pieces))
    row = np.concatenate([starts, piece_row])
    edge = np.concatenate([ptr[starts], piece_edge])
    order = np.lexsort((edge, row))
    position = np.empty(len(order), np.int64)
    position[order] = np.arange(len(order))
    unit_row = np.append(np.concatenate([starts, ~piece_row])[order], n)
    unit_edge = np.append(edge[order], ptr[-1])
    table = np.stack([rows_split, position[len(starts) + first_piece],
                      n_pieces], 1).reshape(-1, 3)
    return tuple(a.astype(np.int32) for a in (unit_row, unit_edge, table))


def part_items(split: np.ndarray, parts: int) -> np.ndarray:
    """The fix-up's items: part g of split row s, as ``s * parts + g``, for
    the parts that hold a piece (g below the row's piece count), part-major
    so the hub row's parts spread over the launch.  A part without a piece
    adds nothing to its row's sum, so it is left out."""
    count = np.minimum(np.asarray(split, np.int64).reshape(-1, 3)[:, 2],
                       parts)
    s = np.repeat(np.arange(len(count)), count)
    g = np.arange(len(s)) - np.repeat(np.cumsum(count) - count, count)
    return (s * parts + g)[np.lexsort((s, g))].astype(np.int32)


def share_folds(ptr: np.ndarray, share: int = DEGREE_SHARE) -> int:
    """The rows of a list that cross the end of a share of ``share`` edges
    (``DEGREE_SHARE``: ``csrc/degree_walk.cuh``, ``BF16_SHARE``:
    ``csrc/share_walk.cuh``; the rows whose blocks' sums the walk's fold
    kernel adds: without one, the walk is its only launch)."""
    ptr = np.asarray(ptr, np.int64)
    ends = np.arange(share, ptr[-1], share)
    row = np.searchsorted(ptr, ends, side="right") - 1
    start = ptr[row]
    # a row crossing several ends counts once, at the first it crosses
    return int(((start < ends) & (start >= ends - share)).sum())


def drop_tiles(ptr: np.ndarray, unit_row: np.ndarray,
               unit_edge: np.ndarray, items: int):
    """The tiles of K1's dropout walks (``csrc/drop_walk.cuh``) over a list
    cut into units (:func:`work_units`).  A segment is a row of a unit of
    whole rows, or a piece of a split row, in list order: ``seg_end[s]`` is
    the edge where it ends (it starts where segment ``s - 1`` ends) and
    ``seg_out[s]`` its row, or ``~unit`` for a piece (the piece's carry
    slot).  A tile is a run of consecutive segments of about ``items``
    items, a segment costing its edges and one more: tile ``t`` holds
    segments ``tile_seg[t]:tile_seg[t + 1]`` and edges
    ``tile_edge[t]:tile_edge[t + 1]``.  The tiles change where a warp
    works, not the order of any sum.  Returns int32 ``(tile_seg,
    tile_edge, seg_end, seg_out)`` and the most edges and segments of a
    tile."""
    ptr = np.asarray(ptr, np.int64)
    unit_row = np.asarray(unit_row, np.int64)
    unit_edge = np.asarray(unit_edge, np.int64)
    head, after = unit_row[:-1], unit_row[1:]
    piece = head < 0
    first = np.where(piece, ~head, head)
    count = np.where(piece, 1, np.where(after < 0, ~after, after) - first)
    unit = np.repeat(np.arange(len(head)), count)
    row = first[unit] + np.arange(len(unit)) - np.repeat(
        np.cumsum(count) - count, count)
    in_piece = piece[unit]
    seg_out = np.where(in_piece, ~unit, row)
    seg_end = np.where(in_piece, unit_edge[1:][unit], ptr[row + 1])
    seg_start = np.concatenate([[0], seg_end[:-1]])
    cost = seg_end - seg_start + 1
    bucket = (np.cumsum(cost) - cost) // items
    starts = np.flatnonzero(np.concatenate([[True],
                                            bucket[1:] != bucket[:-1]]))
    starts = starts[:len(seg_end)]
    tile_seg = np.append(starts, len(seg_end))
    tile_edge = np.append(seg_start[starts], ptr[-1])
    caps = (int(np.diff(tile_edge).max(initial=0)),
            int(np.diff(tile_seg).max(initial=0)))
    return tuple(a.astype(np.int32) for a in (tile_seg, tile_edge, seg_end,
                                              seg_out)) + caps


class Counters:
    """The split-row counters of one list, with which K1's scaled walk
    finishes a split row inside its launch (``csrc/scaled_walk.cuh``):
    sets of ``size`` int32 (``n_split * (parts + 1)``: a count a part of
    each split row, then a count a split row), each zero when a launch
    takes it and zero again when the launch ends.  Two launches that run
    at once must not share a set, so a set serves one place where launches
    run in turn (:func:`stream_counters`):

    * one CUDA stream, for eager launches (``sets``: made zeroed on the
      stream at its first launch, kept while the list lives; a stream's
      handle must name one stream while launches on it are pending, as
      torch's streams do, which are never destroyed);
    * one (graph capture, stream), for launches captured into a CUDA graph,
      whose replays CUDA runs in turn (``captured``: made zeroed inside the
      capture, so the graph holds its memory and its fill for as long as
      it lives).  The store lets go of a capture's set at the next eager
      take and at the first take of another capture, so it holds the sets
      of one capture at most."""

    def __init__(self, size: int):
        self.size = size
        self.sets = {}
        self.captured = {}

    def _zeros(self, device) -> torch.Tensor:
        return torch.zeros(self.size, dtype=torch.int32, device=device)

    def take(self, key, device, capture=None) -> torch.Tensor:
        """The set of ``key`` (a stream) on ``device`` for an eager launch,
        or, with ``capture`` (the capture's id), for one captured on that
        stream; made zeroed at its first take."""
        if capture is None:
            if self.captured:
                self.captured.clear()
            got = self.sets.get(key)
            if got is None:
                got = self.sets[key] = self._zeros(device)
            return got
        got = self.captured.get((key, capture))
        if got is None:
            for old in [k for k in self.captured if k[1] != capture]:
                del self.captured[old]
            got = self.captured[key, capture] = self._zeros(device)
        return got

    def zero(self) -> bool:
        """Whether every set the store holds reads zero."""
        return not any(bool(t.any()) for t in (*self.sets.values(),
                                                *self.captured.values()))


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """The walk's work on a device: a CSR list (``ptr``, ``idx``, ``eid``;
    ``eid`` is None where it is the identity), its units of work
    (:func:`work_units`), the fix-up's items (:func:`part_items`) and the
    number of parts that fixes its order, for K1's lists the output row of
    each list row (``rows``; None for K2's, where row r is output row r),
    and, for the lists of K1's dropout walks, their tiles
    (:func:`drop_tiles`; None where the list was built without them), and
    the split rows' counters with which K1's scaled walk finishes them in
    its own launch (``counters``, a :class:`Counters` of ``n_split * (parts
    + 1)`` int32 a set; None where no row is split), the rows that cross the
    end of a share of K1's degree walk (``share_folds``, :func:`share_folds`)
    and what the walks make once for the list (``memo``: the degree walk's
    copy of the base values in list order, ``ops/ell_gather.py::
    list_values``; :func:`bf16_folds`)."""

    ptr: torch.Tensor        # (N+1,) int32
    idx: torch.Tensor        # (E,) int32 source row of each edge
    eid: Optional[torch.Tensor]  # (E,) int32 edge id; None: arange(E)
    unit_row: torch.Tensor   # (U+1,) int32
    unit_edge: torch.Tensor  # (U+1,) int32
    split: torch.Tensor      # (S, 3) int32
    part_item: torch.Tensor  # (I,) int32
    parts: int
    rows: Optional[torch.Tensor] = None  # (N,) int32 output rows
    tile_seg: Optional[torch.Tensor] = None   # (T+1,) int32
    tile_edge: Optional[torch.Tensor] = None  # (T+1,) int32
    seg_end: Optional[torch.Tensor] = None    # (S,) int32
    seg_out: Optional[torch.Tensor] = None    # (S,) int32
    tile_caps: tuple = (0, 0)  # most edges and segments of a tile
    n_x: Optional[int] = None     # x rows read; None: n_rows
    n_ids: Optional[int] = None   # values read through eid; None: n_edges
    counters: Optional[Counters] = None
    share_folds: int = 0
    memo: dict = dataclasses.field(default_factory=dict, init=False,
                                   compare=False, repr=False)

    @classmethod
    def build(cls, ptr, idx, eid, device, rows=None, items=None,
              tile_items=None, n_x=None, n_ids=None):
        """The list on ``device``, cut into units of ``items`` items
        (default :func:`unit_items` of its edges and rows), its split rows
        summed in ``_FIXUP_PARTS`` parts, with tiles of ``tile_items`` items
        for the dropout walks (:func:`drop_tiles`; none without
        ``tile_items``) and the split rows' counters; ``eid`` None means
        the identity.  ``n_x`` and ``n_ids`` give the rows of ``x`` and the
        values a non-square list reads."""
        if len(idx) >= 2**31 - 1:
            raise ValueError(f"{len(idx)} edges exceed the walk's int32 "
                             "indices")

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                device)

        identity = (eid is None or np.array_equal(
            eid, np.arange(len(eid)))) and n_ids in (None, len(idx))
        if items is None:
            items = unit_items(len(idx) + len(ptr) - 1)
        units = work_units(ptr, items)
        parts = _FIXUP_PARTS
        tiles = {}
        if tile_items is not None:
            *arrays, cap_edges, cap_segs = drop_tiles(ptr, units[0],
                                                      units[1], tile_items)
            tiles = dict(zip(("tile_seg", "tile_edge", "seg_end", "seg_out"),
                             map(put, arrays)),
                         tile_caps=(cap_edges, cap_segs))
        n_split = len(units[2])
        return cls(put(ptr), put(idx), None if identity else put(eid),
                   *(put(a) for a in units),
                   put(part_items(units[2], parts)), parts,
                   rows=None if rows is None else put(rows), **tiles,
                   n_x=n_x, n_ids=n_ids,
                   counters=Counters(n_split * (parts + 1))
                   if n_split else None,
                   share_folds=share_folds(ptr))

    @property
    def n_rows(self) -> int:
        return int(self.ptr.shape[0]) - 1

    @property
    def n_edges(self) -> int:
        return int(self.idx.shape[0])

    @property
    def n_in(self) -> int:
        """The rows of ``x`` the list reads."""
        return self.n_rows if self.n_x is None else self.n_x

    @property
    def n_values(self) -> int:
        """The values the list reads through ``eid``."""
        return self.n_edges if self.n_ids is None else self.n_ids

    @property
    def n_units(self) -> int:
        return int(self.unit_row.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.ptr.device

    @functools.cached_property
    def addresses(self) -> tuple:
        """The list's device addresses, in the C entry points' order (ptr,
        idx, eid, rows, unit_row, unit_edge, split, part_item; None for an
        absent array), and its int arguments (n_units, n_split,
        n_part_items)."""
        arrays = (self.ptr, self.idx, self.eid, self.rows, self.unit_row,
                  self.unit_edge, self.split, self.part_item)
        return (tuple(None if a is None else a.data_ptr() for a in arrays),
                (self.n_units, int(self.split.shape[0]),
                 int(self.part_item.shape[0])))

    @property
    def n_tiles(self) -> int:
        return 0 if self.tile_seg is None else int(self.tile_seg.shape[0]) - 1

    @functools.cached_property
    def tile_addresses(self) -> tuple:
        """The tiles' device addresses and int arguments, in the dropout
        walks' C order: tile_seg, tile_edge, seg_end, seg_out, n_tiles,
        cap_edges, cap_segs."""
        if self.tile_seg is None:
            raise ValueError("the list was built without tiles "
                             "(EdgeList.build(tile_items=...))")
        return (*(a.data_ptr() for a in (self.tile_seg, self.tile_edge,
                                         self.seg_end, self.seg_out)),
                self.n_tiles, *self.tile_caps)


class BlockedSpMM:
    """The forward and transposed :class:`EdgeList` of one structure on a
    device: of a :class:`BlockedCOO` layout (:func:`edge_lists`; the layout
    is not kept) or of the two lists themselves (:func:`graph_lists`), cut
    into units of ``items`` items (default: each list's
    :func:`unit_items`)."""

    def __init__(self, lists, device, items: Optional[int] = None):
        if isinstance(lists, BlockedCOO):
            lists = edge_lists(lists)
        fwd, tr = lists
        self.forward = EdgeList.build(*fwd, device, items=items)
        self.transposed = EdgeList.build(*tr, device, items=items)


def scatter_values(layout: BlockedCOO, val: torch.Tensor) -> torch.Tensor:
    """Live edge values into the (C*BE,) float32 slot grid at ``perm``,
    zeros in the padding slots (the TPU kernel's value layout)."""
    flat = torch.zeros(layout.rows.shape[0], dtype=torch.float32,
                       device=val.device)
    flat[torch.from_numpy(layout.perm).long().to(val.device)] = \
        val.to(torch.float32)
    return flat


def blocked_spmm_plain(lst: EdgeList, val: torch.Tensor, x: torch.Tensor,
                       base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The walk's function in plain torch: ``out[r] = sum over the list's
    edges e of row r of val[eid[e]] * x[idx[e]]``, with ``index_add_`` and
    in the kernel's order: a row, or a piece of a split row, in edge order;
    then a split row's pieces in ``lst.parts`` parts (part g sums pieces g,
    g + P, ... in turn) and the parts in order.  On the CPU, where
    ``index_add_`` adds in index order, a row then gets the kernel's own
    roundings.  With a ``base`` (K1), row r's sum is added into ``base``'s
    row ``rows[r]`` in place, one addition an element, and ``base`` is
    returned."""
    out = _row_sums(lst, val, x)
    if base is None:
        return out
    rows = (torch.arange(lst.n_rows, device=x.device) if lst.rows is None
            else lst.rows.long())
    return base.index_add_(0, rows, out)


def _row_sums(lst: EdgeList, val: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    w = val if lst.eid is None else val[lst.eid.long()]
    return ordered_row_sums(lst, x[lst.idx.long()] * w[:, None])


def list_rows(lst: EdgeList) -> torch.Tensor:
    """The list row of each edge of ``lst`` (int64)."""
    return torch.repeat_interleave(
        torch.arange(lst.n_rows, device=lst.device), lst.ptr.diff().long(),
        output_size=lst.n_edges)


def ordered_row_sums(lst: EdgeList, terms: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum of terms[e]`` over row r's edges of ``lst`` (``terms``
    (E, F) float32, one row an edge in list order), in the walk's order:
    a row, or a piece of a split row, in edge order; then a split row's
    pieces in ``lst.parts`` parts and the parts in order."""
    n, f = lst.n_rows, terms.shape[1]
    dev = terms.device
    rows = list_rows(lst)
    split = lst.split.long()
    n_split = split.shape[0]
    if n_split == 0 or f == 0:
        out = torch.zeros(n, f, dtype=torch.float32, device=dev)
        return out.index_add_(0, rows, terms)
    # a split row's edges add into its pieces, rows n + unit
    unit = torch.searchsorted(
        lst.unit_edge.long(), torch.arange(lst.n_edges, device=dev),
        right=True) - 1
    target = torch.where(lst.unit_row.long()[unit] < 0, n + unit, rows)
    sums = torch.zeros(n + lst.n_units, f, dtype=torch.float32,
                       device=dev).index_add_(0, target, terms)
    # piece k of split row s adds into part s * P + k % P, in piece order;
    # then the row's P parts add into it, in order
    parts = lst.parts
    count = split[:, 2]
    s = torch.repeat_interleave(torch.arange(n_split, device=dev), count)
    k = torch.arange(len(s), device=dev) - torch.repeat_interleave(
        count.cumsum(0) - count, count)
    part = torch.zeros(n_split * parts, f, dtype=torch.float32,
                       device=dev).index_add_(0, s * parts + k % parts,
                                              sums[n + split[s, 1] + k])
    out = sums[:n]
    out[split[:, 0]] = torch.zeros(
        n_split, f, dtype=torch.float32, device=dev).index_add_(
            0, torch.arange(n_split * parts, device=dev) // parts, part)
    return out


def fold_runs(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The left fold, in order, of each run of ``values`` (rows of a
    tensor; a run begins where ``starts`` is True): ``((v0 + v1) + v2) +
    ...``, one rounded addition at a time."""
    first = torch.nonzero(starts).flatten()
    length = torch.diff(first, append=first.new_tensor([values.shape[0]]))
    acc = values[first].clone()
    order = torch.argsort(length, descending=True, stable=True)
    # runs longer than k, for k = 1, 2, ...: the first counts[k - 1] of order
    longest = int(length.max()) if length.numel() else 0
    ascending = torch.sort(length).values
    counts = (length.numel() - torch.searchsorted(
        ascending, torch.arange(1, max(1, longest), device=length.device),
        right=True)).tolist()
    for k, count in enumerate(counts, start=1):
        on = order[:count]
        acc[on] = acc[on] + values[first[on] + k]
    return acc


def bf16_share_lanes(f: int) -> int:
    """The lanes of the share walk's groups at width F: 8, 16 or 32, the
    least power of two that holds F / 8 lanes of 8 elements each."""
    return 8 if f <= 64 else 16 if f <= 128 else 32


def bf16_share_run(f: int) -> int:
    """The share walk's edges a run at width F: ``BF16_SHARE`` edges a
    block of ``BF16_SHARE_THREADS`` threads, groups of
    :func:`bf16_share_lanes` lanes (32, 64 or 128 edges at the
    defaults)."""
    return BF16_SHARE * bf16_share_lanes(f) // BF16_SHARE_THREADS


def share_row_sums(ptr: torch.Tensor, terms: torch.Tensor, run: int,
                   share: int, fold_range: Optional[int]) -> torch.Tensor:
    """Each list row's sum of ``terms`` ((E, F) float32, one row an edge in
    list order) in the order of a walk over equal shares of the list
    (``csrc/share_walk.cuh``; ``csrc/degree_walk.cuh`` at F = 1): a worker
    sums its run of ``run`` consecutive edges of each row in edge order,
    from +0; a row's runs in one block (``share`` edges) are folded in run
    order; a row's blocks' sums are left-folded by ranges of
    ``fold_range`` (each range left-folded, then the ranges in order; None:
    one range).  Empty rows are +0."""
    n, (n_items, f) = ptr.numel() - 1, terms.shape
    dev = terms.device
    out = torch.zeros(n, f, dtype=torch.float32, device=dev)
    if n_items == 0:
        return out
    row = torch.repeat_interleave(torch.arange(n, device=dev),
                                  ptr.diff().long(), output_size=n_items)
    item = torch.arange(n_items, device=dev)
    # 1. a run of a row, from +0, one item of each run at a time (a run
    # holds one item of a residue class, so each step writes a run once)
    starts = torch.ones(n_items, dtype=torch.bool, device=dev)
    starts[1:] = (item[1:] % run == 0) | (row[1:] != row[:-1])
    at_run = torch.cumsum(starts, 0) - 1
    sums = torch.zeros(int(at_run[-1]) + 1, f, dtype=torch.float32,
                       device=dev)
    for i in range(min(run, n_items)):
        at = torch.arange(i, n_items, run, device=dev)
        sums[at_run[at]] = sums[at_run[at]] + terms[at]
    # 2. a row's runs in a block, in run order
    first = torch.nonzero(starts).flatten()
    run_row, run_block = row[first], first // share
    grouped = torch.ones(len(first), dtype=torch.bool, device=dev)
    grouped[1:] = (run_row[1:] != run_row[:-1]) | (
        run_block[1:] != run_block[:-1])
    block_sums = fold_runs(sums, grouped)
    # 3. a row's blocks' sums, by ranges in block order
    block_row = run_row[grouped]
    rows = torch.ones(len(block_row), dtype=torch.bool, device=dev)
    rows[1:] = block_row[1:] != block_row[:-1]
    if fold_range is not None:
        k = torch.arange(len(block_row), device=dev)
        k = k - torch.cummax(torch.where(rows, k, 0), 0).values
        ranges = rows | (k % fold_range == 0)
        block_sums, block_row = (fold_runs(block_sums, ranges),
                                 block_row[ranges])
        rows = rows[ranges]
    out[block_row[rows]] = fold_runs(block_sums, rows)
    return out


def check(what, lst, val, x, base=None, values=(torch.float32,),
          x_dtype=torch.float32):
    """Raise unless the walk can take these inputs: ``x`` (``n_in``, F) of
    ``x_dtype`` (any number of rows where the list adds into a ``base``),
    ``val`` ``n_values`` of a dtype in ``values``, a ``base`` (M, F)
    float32 apart from ``x`` (the kernel reads ``x`` while it writes
    ``base``), all contiguous and on the list's device."""
    n = lst.n_in
    if x.dim() != 2 or x.dtype != x_dtype or (
            base is None and x.shape[0] != n):
        raise TypeError(f"{what}: x must be ({n}, F) {x_dtype}, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if val.shape != (lst.n_values,) or val.dtype not in values:
        raise TypeError(f"{what}: values must be ({lst.n_values},) of "
                        f"{' or '.join(map(str, values))}, got "
                        f"{tuple(val.shape)} {val.dtype}")
    tensors = [val, x]
    if base is not None:
        if (base.dim() != 2 or base.shape[1] != x.shape[1]
                or base.dtype != torch.float32):
            raise TypeError(f"{what}: base must be (M, {x.shape[1]}) "
                            f"float32, got {tuple(base.shape)} {base.dtype}")
        if (base.untyped_storage().data_ptr()
                == x.untyped_storage().data_ptr()):
            raise ValueError(f"{what}: base shares memory with x")
        tensors.append(base)
    devices = {t.device for t in tensors} | {lst.device}
    if len(devices) != 1:
        raise ValueError(f"{what} inputs span devices {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} inputs must be contiguous")


def bf16_vec(f: int, x_at: int, out_at: int) -> int:
    """The bfloat16 elements a lane of K2's bfloat16 mode loads at once: the
    most of 8, 4 and 2 that divides F, with ``x`` aligned to its bytes and
    ``out`` to its floats' (16 bytes at most), and leaves a row at least
    ``_NARROW_LANES`` loads (the wide walk), else 1.  On the RCM bench
    graph's forward list that load was the fastest of the four at F = 16,
    40, 64 and 128 (``k2_sweep.py --kernels k2bf16``, NVIDIA H100 80GB HBM3,
    700 W; PERF.md §6): 2 at F=16, 4 at F=40, 8 at F=64 and 128; the
    narrow walk over wider loads lost (F=40: 8 a lane 0.240 ms against
    0.112).  ``_BF16_VEC`` set to a number forces the widest load up to it
    instead."""
    widest = 8 if _BF16_VEC is None else _BF16_VEC
    for vec in (8, 4, 2):
        if (vec <= widest and f % vec == 0 and x_at % (2 * vec) == 0
                and out_at % min(16, 4 * vec) == 0
                and (_BF16_VEC is not None or f // vec >= _NARROW_LANES)):
            return vec
    return 1


@dataclasses.dataclass(frozen=True)
class Bf16Plan:
    """How K2's bfloat16 mode walks one product (:func:`bf16_plan`):
    ``walk`` is ``"staged"`` (``csrc/bf16_walk.cuh``, with ``depth``
    batches of ``rows`` edges in its ring), ``"share"``
    (``csrc/share_walk.cuh``) or ``"generic"`` (``edge_walk.cuh``); ``vec``
    and ``group`` are the entry's (the generic walk: bfloat16 a lane loads
    and lanes a unit; the staged walk: 4, a lane's float4 of sums, and F /
    4 lanes a unit; the share walk: 8 bfloat16 a lane's load, F / 8 lanes
    that hold a row's elements in a run's group)."""

    walk: str
    vec: int
    group: int
    depth: int = 0
    rows: int = 0

    @property
    def staged(self) -> bool:
        return self.walk == "staged"

    @property
    def share(self) -> bool:
        return self.walk == "share"

    def smem(self, f: int) -> int:
        """The shared memory a block of the staged walk asks for at F."""
        if not self.staged:
            return 0
        return bf16_ring_bytes(f, self.depth, self.rows) * _BF16_WARPS


def bf16_ring_bytes(f: int, depth: int, rows: int) -> int:
    """A warp's rings in the staged walk, one a unit of F / 4 lanes:
    ``depth`` batches of ``rows`` bfloat16 x rows of F elements, with their
    values and sources."""
    return 32 // (f // 4) * depth * rows * (2 * f + 8)


def bf16_rows(f: int, depth: int) -> int:
    """The staged walk's edges a batch: the most, up to 32 and a multiple
    of 4, whose rings fit ``_BF16_RING_BYTES`` a warp (at least 4): 16 at
    F = 16, 20 at F = 24, 32 and 40."""
    rows = _BF16_RING_BYTES // bf16_ring_bytes(f, depth, 1)
    return max(4, min(32, rows // 4 * 4))


def bf16_plan(f: int, x_at: int, out_at: int, edges: int,
              n_rows: int) -> Bf16Plan:
    """K2's bfloat16 mode's walk for an (N, F) bfloat16 ``x`` at address
    ``x_at``, writing ``out`` at ``out_at``, over a list of ``edges``
    edges and ``n_rows`` rows.

    The share walk (``csrc/share_walk.cuh``) takes F % 8 == 0 within
    ``BF16_SHARE_WIDTHS``, with ``x`` and ``out`` 16-byte aligned, on the
    lists of ``_BF16_SHARE_LISTS[bf16_share_lanes(F)]``: so many edges on,
    and so many edges a row on.

    The staged walk (``csrc/bf16_walk.cuh``) takes the widths of
    ``_BF16_STAGED_EDGES`` (F = 16, 24, 32, 40), each from its number of
    edges on, with ``x`` and ``out`` 16-byte aligned; its ring holds
    ``_BF16_DEPTH`` batches of :func:`bf16_rows` edges (``_BF16_RING``,
    (depth, rows), forces another).  The rest take the generic walk at
    :func:`bf16_vec`'s load (``_BF16_VEC`` set forces it everywhere).

    Why (NVIDIA H100 80GB HBM3, 700 W; device time of a call, walk + parts
    + fix-up, averaged over 20 calls; ``k2_sweep.py --kernels k2bf16``,
    PERF.md §6).  Staged / generic, in us:

    =============================  =========  ==========  =========  =========
    list (edges)                   F = 16     F = 24      F = 32     F = 40
    =============================  =========  ==========  =========  =========
    Cora, uniform (10,556)         6.5/5.9    6.3/5.4     5.7/6.5    6.1/6.7
    Cora, power law (10,554)       13.4/12.7  12.7/12.5   12.3/12.8  12.3/13.0
    power law (79,994)             19.0/19.3  18.0/17.7   17.3/19.2  18.3/20.0
    power law (199,996)            27.9/27.8  25.6/26.3   24.5/28.1  24.8/28.7
    power law (359,998)            29.9/29.7  29.0/29.6   27.7/31.2  29.9/31.3
    bench, first quarter (583,119) 39.3/36.6  35.0/42.1   36.6/53.1  39.8/59.1
    RCM bench (2,332,478)          72.2/74.4  71.0/107.5  74.4/92.0  86.6/106.4
    =============================  =========  ==========  =========  =========

    So F = 32 and 40 take it on any list; F = 24 from 150,000 edges (it
    lost at 79,994 and won at 199,996); F = 16 from 1,000,000 (it lost at
    583,119 and won at 2.33 M, also in ``--ab-bf16``: 0.0724 against
    0.0750-0.0782 ms).  Above F = 40 it lost on the bench list
    (0.1159-0.1166 ms against 0.1111-0.1120 at F = 64, 0.202 against
    0.169 at F = 128): both walks wait on L2's bandwidth there, and the
    staged walk moves each row through L1 and shared memory twice.

    The share walk's thresholds (``k2_sweep.py --kernels k2bf16``, the same
    card, PERF.md §6; the walk as built here, whose crossover kept the edge
    thresholds that an earlier build of it had set).  Share / generic,
    device us a call:

    ===============  ==========  ===========  ===========  ===========
    list             F = 64      F = 96       F = 128      F = 256
    ===============  ==========  ===========  ===========  ===========
    Cora, uniform    16.0/7.4    23.3/7.2     21.7/7.2     30.9/6.8
    Cora, power law  18.0/14.1   25.9/13.7    24.0/13.8    31.5/13.5
    power law 80 K   19.2/22.0   27.7/21.3    25.9/21.0    36.4/25.4
    power law 200 K  21.9/32.9   32.6/34.3    31.0/35.4    52.1/44.7
    power law 360 K  26.0/40.2   38.8/44.7    37.7/45.2    67.2/68.6
    bench quarter    56.6/74.6   84.0/77.4    92.4/85.8    153.5/158.7
    RCM bench        94.8/112.0  148.0/165.9  149.1/167.3  259.6/289.8
    ===============  ==========  ===========  ===========  ===========

    (Edges and edges a row: Cora 10,556 and 10,554, 3.9; power law 79,994,
    4.0, 199,996, 5.0, 359,998, 6.0; the bench's first quarter of edges
    over all its rows 583,119, 3.4, 168,159 of its 169,343 rows empty; RCM
    bench 2,332,478, 13.8.)

    So groups of 8 lanes (F = 64) take it from 40,000 edges (it lost at
    10,556 and won at 79,994), of 32 (F = 136-256) from 300,000 (lost at
    199,996, won at 359,998), and of 16 (F = 72-128) from 150,000 (lost at
    79,994, won at 199,996) on lists of 4 edges a row on: the bench's
    first quarter lost by 8% at F = 96 and 128, and the lists it won there
    hold 5 edges a row or more."""
    aligned = x_at % 16 == 0 and out_at % 16 == 0
    low, high = BF16_SHARE_WIDTHS
    least = _BF16_SHARE_LISTS.get(bf16_share_lanes(f))
    if (_BF16_VEC is None and aligned and f % 8 == 0 and low <= f <= high
            and least is not None and edges >= least[0]
            and edges >= least[1] * n_rows):
        return Bf16Plan("share", 8, f // 8)
    least = _BF16_STAGED_EDGES.get(f)
    if (_BF16_VEC is None and least is not None and edges >= least
            and aligned):
        depth, rows = _ring(f)
        return Bf16Plan("staged", 4, f // 4, depth, rows)
    vec = bf16_vec(f, x_at, out_at)
    return Bf16Plan("generic", vec, max(1, min(32, f // vec)))


def _ring(f):
    if _BF16_RING is None:
        return _BF16_DEPTH, bf16_rows(f, _BF16_DEPTH)
    depth, rows = _BF16_RING
    # the checks of csrc/blocked_spmm.cu's staged()
    if (depth not in (2, 3, 4) or not 1 <= rows <= 8 * (f // 4)
            or depth * rows % 4
            or bf16_ring_bytes(f, depth, rows) * _BF16_WARPS > _BF16_SMEM):
        raise ValueError(f"the staged walk takes no ring of {depth} batches "
                         f"of {rows} edges at F={f}")
    return depth, rows


def entry_args(lst: EdgeList, val: torch.Tensor, x: torch.Tensor,
               out: torch.Tensor, extra=(), shape=None, counters=None):
    """The C arguments of a walk's entry point but the stream (the list's,
    then ``extra``), and the scratch tensor they point into (None where no
    row is split), to be kept until the launch.  ``shape`` gives the
    entry's (vec, group) where the caller picked them; ``counters`` (the
    scaled walk's, a set of ``EdgeList.counters``) goes in the place of
    ``rows``."""
    f = x.shape[1]
    addresses, (n_units, n_split, n_part_items) = lst.addresses
    if counters is not None:
        addresses = (*addresses[:3], counters.data_ptr(), *addresses[4:])
    # float4 loads where rows are 16-byte aligned; a group of lanes a unit
    x_at, out_at = x.data_ptr(), out.data_ptr()
    if shape is not None:
        vec, group = shape
    else:
        vec = 4 if (f % 4 == 0 and x_at % 16 == 0 and out_at % 16 == 0) \
            else 1
        group = max(1, min(32, f // vec))
    # the pieces' sums, then the split rows' parts
    carry = (torch.empty(n_units + n_split * lst.parts, f,
                         dtype=torch.float32, device=out.device)
             if n_split else None)
    args = (*addresses, val.data_ptr(), x_at, out_at,
            None if carry is None else carry.data_ptr(), n_units, n_split,
            n_part_items, f, vec, group, lst.parts, *extra)
    return args, carry


def launch(lib: ctypes.CDLL, entry: str, lst: EdgeList, val: torch.Tensor,
           x: torch.Tensor, out: torch.Tensor,
           extra=(), shape=None, counted=False) -> None:
    """Run the walk through the C ``entry`` of a built library (K1's or
    K2's), writing into ``out`` on the current stream; counts nothing.
    ``extra`` holds the arguments a dropout walk's entry takes after the
    list's (``ops/ell_gather.py``: the tiles, the draw, the flag; K2's
    bfloat16 mode: its walk).  ``shape``: :func:`entry_args`'.
    ``counted``: the entry takes the list's split-row counters (K1's scaled
    walk), the set that :func:`stream_counters` picks for the launch's
    stream."""
    if lst.n_units == 0 or x.shape[1] == 0:
        return
    rc = on_device(out.device, _call, lib, entry, lst, val, x, out, extra,
                   shape, counted, out.device)
    kernels.check(lib, rc, f"{entry} launch")


def on_device(device: torch.device, fn, *args):
    """``fn(*args)`` with ``device`` the current CUDA device."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def _call(lib, entry, lst, val, x, out, extra, shape, counted, device):
    stream = torch.cuda.current_stream(device).cuda_stream
    counters = stream_counters(lib, lst, device, stream) if counted else None
    args, _carry = entry_args(lst, val, x, out, extra, shape, counters)
    return getattr(lib, entry)(*args, stream)


def stream_counters(lib: ctypes.CDLL, lst: EdgeList, device,
                    stream: int) -> Optional[torch.Tensor]:
    """The set of ``lst``'s split-row counters (:class:`Counters`) that a
    launch on ``stream`` (the current CUDA stream's handle on ``device``)
    takes: the stream's own, or, while the stream captures a CUDA graph,
    the capture's (its id from K1's library, ``gnntf_stream_capture``);
    None where no row is split."""
    if lst.counters is None:
        return None
    if not torch.cuda.is_current_stream_capturing():
        return lst.counters.take((device, stream), device)
    active, capture = ctypes.c_int(0), ctypes.c_ulonglong(0)
    kernels.check(lib, lib.gnntf_stream_capture(
        stream, ctypes.byref(active), ctypes.byref(capture)),
        "gnntf_stream_capture")
    return lst.counters.take((device, stream), device, capture.value)


def blocked_spmm(lst: EdgeList, val: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The list's product with ``x`` (``A @ x`` over the forward list,
    ``A^T @ x`` over the transposed one) as an (N, F) float32 tensor.
    ``val`` holds the graph's edge values in its own edge order.  CPU
    tensors take :func:`blocked_spmm_plain`; CUDA tensors launch the kernel
    (counted in ``blocked_spmm.launches``)."""
    if lst.rows is not None:
        raise ValueError("blocked_spmm stores row r at r; a list with row "
                         "ids is K1's (ops/ell_gather.py)")
    check("blocked_spmm", lst, val, x)
    if x.device.type == "cpu":
        return blocked_spmm_plain(lst, val, x)
    if x.device.type != "cuda":
        raise ValueError(f"blocked_spmm runs on cpu or cuda, not {x.device}")
    out = torch.empty(lst.n_rows, x.shape[1], dtype=torch.float32,
                      device=x.device)
    if lst.n_units == 0 or x.shape[1] == 0:
        return out
    launch(_library(), "gnntf_blocked_spmm", lst, val, x, out)
    blocked_spmm.launches += 1
    return out


blocked_spmm.launches = 0


def blocked_spmm_bf16_plain(lst: EdgeList, val: torch.Tensor,
                            xb: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`blocked_spmm_bf16`: each term
    ``fp32(bf16_rn(val[eid[e]] * fp32(xb[idx[e]])))`` (one float32 product,
    rounded to bfloat16 to nearest even), summed in the order of the walk
    that :func:`bf16_plan` gives ``xb`` (at its address, ``out`` aligned):
    :func:`share_row_sums` where it is the share walk, else
    :func:`ordered_row_sums`."""
    w = val if lst.eid is None else val[lst.eid.long()]
    terms = (xb[lst.idx.long()].to(torch.float32) * w[:, None]).to(
        torch.bfloat16).to(torch.float32)
    f = xb.shape[1]
    if bf16_plan(f, xb.data_ptr(), 0, lst.n_edges, lst.n_rows).share:
        return share_row_sums(lst.ptr, terms, bf16_share_run(f), BF16_SHARE,
                              BF16_FOLD_RANGE)
    return ordered_row_sums(lst, terms)


def blocked_spmm_bf16(lst: EdgeList, val: torch.Tensor,
                      xb: torch.Tensor) -> torch.Tensor:
    """K2's bfloat16 mode (the TPU kernel's ``bf16=True``) over the list:
    ``out[r] = sum_e fp32(bf16_rn(val[eid[e]] * fp32(xb[idx[e]])))`` as an
    (N, F) float32 tensor, ``xb`` (``n_in``, F) bfloat16 and ``val``
    float32.  CPU tensors take :func:`blocked_spmm_bf16_plain`; CUDA tensors
    launch the walk that :func:`bf16_plan` picks, counted in
    ``blocked_spmm_bf16.launches``, and those of the staged walk also in
    ``blocked_spmm_bf16.staged_launches``, those of the share walk in
    ``blocked_spmm_bf16.share_launches``."""
    if lst.rows is not None:
        raise ValueError("blocked_spmm_bf16 stores row r at r; a list with "
                         "row ids is K1's (ops/ell_gather.py)")
    check("blocked_spmm_bf16", lst, val, xb, x_dtype=torch.bfloat16)
    if xb.device.type == "cpu":
        return blocked_spmm_bf16_plain(lst, val, xb)
    if xb.device.type != "cuda":
        raise ValueError(f"blocked_spmm_bf16 runs on cpu or cuda, not "
                         f"{xb.device}")
    f = xb.shape[1]
    out = torch.empty(lst.n_rows, f, dtype=torch.float32, device=xb.device)
    if lst.n_units == 0 or f == 0:
        return out
    plan = bf16_plan(f, xb.data_ptr(), out.data_ptr(), lst.n_edges,
                     lst.n_rows)
    if plan.share:
        share_launch(_library(), lst, val, xb, out)
        blocked_spmm_bf16.share_launches += 1
    elif plan.staged:
        launch(_library(), "gnntf_blocked_spmm_bf16_staged", lst, val, xb,
               out, extra=(plan.depth, plan.rows), shape=(4, f // 4))
        blocked_spmm_bf16.staged_launches += 1
    else:
        launch(_library(), "gnntf_blocked_spmm_bf16", lst, val, xb, out,
               shape=(plan.vec, plan.group))
    blocked_spmm_bf16.launches += 1
    return out


blocked_spmm_bf16.launches = 0
blocked_spmm_bf16.staged_launches = 0
blocked_spmm_bf16.share_launches = 0


def bf16_folds(lst: EdgeList) -> int:
    """The rows of ``lst`` that cross the end of a share of the bfloat16
    share walk (:func:`share_folds` at ``BF16_SHARE``), counted once a list
    and share in ``lst.memo``.  The count reads ``ptr`` on the host, so a
    list on a card takes its first share walk outside a CUDA graph's
    capture, as the library's first load does."""
    key = ("bf16_folds", BF16_SHARE)
    if key not in lst.memo:
        lst.memo[key] = share_folds(lst.ptr.cpu().numpy(), BF16_SHARE)
    return lst.memo[key]


def share_launch(lib: ctypes.CDLL, lst: EdgeList, val: torch.Tensor,
                 xb: torch.Tensor, out: torch.Tensor) -> None:
    """The share walk (``gnntf_blocked_spmm_bf16_share``) over ``lst``,
    writing ``out`` on the current stream, then its fold where a row
    crosses a block's share (:func:`bf16_folds`); the blocks' partials
    (``carry_in``, ``carry_out``: F floats a block, ``col_in``: one) in a
    scratch tensor allocated for the call."""
    f = xb.shape[1]
    blocks = max(1, -(-lst.n_edges // BF16_SHARE))
    scratch = torch.empty(blocks * (2 * f + 1), dtype=torch.float32,
                          device=out.device)
    at = scratch.data_ptr()
    args = (lst.ptr.data_ptr(), lst.idx.data_ptr(),
            None if lst.eid is None else lst.eid.data_ptr(),
            val.data_ptr(), xb.data_ptr(), out.data_ptr(), at,
            at + 4 * blocks * f, at + 8 * blocks * f, lst.n_rows,
            lst.n_edges, blocks, f, BF16_SHARE, BF16_FOLD_RANGE,
            int(bf16_folds(lst) > 0))
    rc = on_device(out.device, lambda: lib.gnntf_blocked_spmm_bf16_share(
        *args, torch.cuda.current_stream(out.device).cuda_stream))
    kernels.check(lib, rc, "gnntf_blocked_spmm_bf16_share launch")


# the C signature of the walk's entry points (gnntf_blocked_spmm,
# gnntf_blocked_spmm_bf16, gnntf_ell_gather): ptr, idx, eid, rows,
# unit_row, unit_edge, split, part_item (the list), val, x, out, carry;
# n_units, n_split, n_part_items, f, vec, group, parts; stream
ENTRY_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]
# the staged walk of K2's bfloat16 mode (gnntf_blocked_spmm_bf16_staged)
# takes its ring's depth and rows a batch before the stream
STAGED_ARGTYPES = ENTRY_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
# its share walk (gnntf_blocked_spmm_bf16_share): ptr, idx, eid, val, x,
# out, carry_in, carry_out, col_in; n_rows, n_edges, n_blocks, f, share,
# fold_range, folds; stream
SHARE_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]
# the masked walk's entry points (gnntf_ell_gather_masked and its bfloat16
# twin) take before the stream the tiles (tile_seg, tile_edge,
# seg_end, seg_out; n_tiles, cap_edges, cap_segs), the draw (the salt
# pair's device address, thresh, n_drop, id_base, scale), the flag's device
# address and x's size in floats
DROP_ARGTYPES = ENTRY_ARGTYPES[:-1] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                         ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_void_p]


# K1's scaled walk (gnntf_ell_gather_scaled, gnntf_ell_gather_scaled_t)
# takes a set of its list's split-row counters (null where no row is
# split) in the place of rows and, before the stream, the row and column
# scales' device addresses (or null) and the identity's weight
SCALED_ARGTYPES = ENTRY_ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_float, ctypes.c_void_p]


def declare(entry, drop: bool = False, scaled: bool = False,
            staged: bool = False) -> None:
    entry.restype = ctypes.c_int
    entry.argtypes = (DROP_ARGTYPES if drop else
                      SCALED_ARGTYPES if scaled else
                      STAGED_ARGTYPES if staged else ENTRY_ARGTYPES)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared (built on
    first use, never at import)."""
    lib = kernels.load("blocked_spmm")
    declare(lib.gnntf_blocked_spmm)
    declare(lib.gnntf_blocked_spmm_bf16)
    declare(lib.gnntf_blocked_spmm_bf16_staged, staged=True)
    lib.gnntf_blocked_spmm_bf16_share.restype = ctypes.c_int
    lib.gnntf_blocked_spmm_bf16_share.argtypes = SHARE_ARGTYPES
    return lib


class _BlockedSpMMFn(torch.autograd.Function):
    """``(val, x) -> A @ x`` through K2 (with ``bf16``, its bfloat16 mode
    over ``x`` rounded to bfloat16 once, the output in ``x``'s dtype).  The
    backward is the JAX package's ``_pallas_vjp_fn.f_bwd``, which ignores
    ``bf16``: ``dx = A^T @ dy`` through K2 over the transposed list in
    float32 and, only when the values need it, ``dval[e] = <dy[row[e]],
    x[col[e]]>`` in plain torch over the unrounded ``x``."""

    @staticmethod
    def forward(ctx, val, x, prep, row, col, bf16=False):
        val32 = val.to(torch.float32).contiguous()
        if bf16:
            out = blocked_spmm_bf16(prep.forward, val32,
                                    x.to(torch.bfloat16).contiguous())
            out = out.to(x.dtype)
        else:
            out = blocked_spmm(prep.forward, val32, x.contiguous())
        ctx.prep = prep
        ctx.val_dtype, ctx.x_dtype = val.dtype, x.dtype
        ctx.save_for_backward(val32, x if ctx.needs_input_grad[0] else None,
                              row, col)
        return out

    @staticmethod
    def backward(ctx, dy):
        val32, x, row, col = ctx.saved_tensors
        dval = dx = None
        if ctx.needs_input_grad[1]:
            dx = blocked_spmm(ctx.prep.transposed, val32,
                              dy.to(torch.float32).contiguous())
            dx = dx.to(ctx.x_dtype)
        if ctx.needs_input_grad[0]:
            dval = (dy.to(torch.float32)[row]
                    * x.to(torch.float32)[col]).sum(-1).to(ctx.val_dtype)
        return dval, dx, None, None, None, None


# The lists of one structure, memoized on the identity of the graph's ``row``
# and ``col`` (strong references kept and re-checked, so a recycled id never
# aliases a dead graph's lists); the 10 layers of a model and every step
# share one entry.
_BLOCK_CACHE = IdLRU()


def blocked_layout(graph: Graph, window: int = 256, tile: int = 256,
                   block_edges: int = 1024) -> BlockedSpMM:
    """The forward and transposed lists of K2's layout of ``graph``'s
    structure on the graph's device, built once (``_BLOCK_CACHE``) from the
    edges (:func:`graph_lists`, equal to the layout's :func:`edge_lists`;
    ``window`` and ``block_edges`` do not change them)."""
    key = (id(graph.row), id(graph.col), graph.n_nodes, tile)
    anchors = (graph.row, graph.col)
    prep = _BLOCK_CACHE.get(key, anchors)
    if prep is None:
        prep = BlockedSpMM(graph_lists(graph.row.cpu().numpy(),
                                       graph.col.cpu().numpy(),
                                       graph.n_nodes, tile), graph.device)
        _BLOCK_CACHE.put(key, anchors, prep,
                         nbytes=sizeof((prep.forward, prep.transposed)))
    return prep


def spmm_pallas(graph: Graph, x: torch.Tensor, *, bf16: bool = False,
                window: int = 256, tile: int = 256,
                block_edges: int = 1024) -> torch.Tensor:
    """SpMM through K2 (the JAX package's ``spmm_impl="pallas"``).  Lazy
    scales and identity apply around it, lazy dropout is materialized
    first; the layout and its edge lists are built once per graph
    structure, and the kernel reads the graph's values in place.  With
    ``bf16`` the kernel's bfloat16 mode (the JAX package's
    ``spmm_pallas(bf16=True)``): each term ``val * x`` rounded to bfloat16,
    the sums in float32, the output in ``x``'s dtype.  Differentiable in
    the values and in ``x`` (a float32 backward either way)."""
    if graph.scaled or graph.eye_weight != 0.0:
        from .spmm import _scaled_call
        return _scaled_call(functools.partial(
            spmm_pallas, bf16=bf16, window=window, tile=tile,
            block_edges=block_edges), graph, x)
    graph = graph.materialized_dropout()
    prep = blocked_layout(graph, window, tile, block_edges)
    return _BlockedSpMMFn.apply(graph.val, x, prep, graph.row, graph.col,
                                bf16)
