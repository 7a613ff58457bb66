"""Counter-based edge dropout and the training grids (the JAX package's
``ops/stochastic.py``).

The keep decision of edge ``e`` is a pure hash of its id and two 32-bit
salts,

    fmix32(fmix32(e ^ s0) ^ s1) >> 8  <  round(keep * 2**24),

so every layout that knows an edge's id recomputes the same realized mask,
on any device.  The masks are bit-equal to the JAX package's for the same
ids, salts, keep rate and ``n_drop``.  On the host the hash runs in int64
with ``& 0xFFFFFFFF`` (``torch.uint32`` tensors do not support ``>>`` or
``<``), its multiplications split into 16-bit halves so no product leaves
the int64 range; the masked kernels run it in native uint32.

:class:`TrainGrids` holds, for one graph structure, a row-split ELL grid of
every original edge (for ``A @ x``) and a column-split twin (for ``A^T @ g``
and the column sums), bit-equal to the JAX package's.  The grids stay on
the host.  On a device only the walk's two lists go: each grid's live slots
in grid order as an :class:`~.blocked.EdgeList` (``ptr`` over all N rows,
``idx``, ``eid``; the row list's ``eid`` is the identity on a row-sorted
graph and is not stored).  The kernels read the graph's base values through
``eid`` and hash the mask themselves (``ops/ell_gather.py``):

* :func:`stochastic_spmm` — ``A_dropped @ x`` through ``_TrainGridsFn``:
  the masked walk over the row list, its backward ``dx`` the masked walk over
  the column list with the same draw (never a row scatter); no gradient
  flows to the values, as in the JAX package;
* :func:`stochastic_degree` — the dropped graph's column (or row) sums, the
  degree walk over the column (or row) list, with no E-sized scatter; it
  streams the base values in the list's order, a copy that each list
  makes once (``ell_gather.list_values``; ``train_grids`` makes it with the
  lists, so the grids cache counts it).

``GNNTF_GRID_VALUE_DTYPE=bfloat16`` (:func:`grid_value_dtype`, as in the
JAX package) stores the grids' base values rounded to bfloat16 (numpy holds
their bits as uint16).  The masked product, its backward and the degrees
then weight each edge by its rounded value: on a device the walks read a
bfloat16 copy of the values, one an edge id, that the grids make once
(:meth:`TrainGrids.values`); with float32 grids they read ``graph.val``.
Unit values (unweighted graphs) are exact in bfloat16, so there the knob
changes no bit.
"""
from __future__ import annotations

import contextvars
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..graph.coo import Graph
from ..utils.idcache import IdLRU, sizeof
from .blocked import EdgeList
from .ell_gather import (ell_degree_masked, ell_gather_masked, ell_list,
                         list_values)
# the row-split width of the ELL layouts (ops/spmm.py), shared by the grids
from .spmm import _ELL_DEFAULT_K as _K

# graphs below this many edges take an eager Bernoulli draw instead of the
# lazy salts (ops/normalize.py::edge_dropout), unless min_edges_scope says
# otherwise
MIN_EDGES = 65_536

_MIN_EDGES_VAR: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("gnntf_torch_min_edges", default=None)

_MASK32 = 0xFFFFFFFF


def min_edges() -> int:
    """The lazy-dropout threshold in force: the scoped override if one is
    active, else ``MIN_EDGES``."""
    override = _MIN_EDGES_VAR.get()
    return MIN_EDGES if override is None else override


class min_edges_scope:
    """Context manager scoping the lazy-dropout edge threshold, for tests
    that need the grid path on small graphs without changing the
    process-wide default."""

    def __init__(self, n: int):
        self.n = int(n)

    def __enter__(self):
        self._token = _MIN_EDGES_VAR.set(self.n)
        return self.n

    def __exit__(self, *exc):
        _MIN_EDGES_VAR.reset(self._token)
        return False


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``x`` in [0, 2**32) held in int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _salts(salt, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draw's two salts (a (2,) tensor on any device, or two ints) as
    0-d int64 tensors of uint32 values on ``device``: the hash takes them
    as tensor operands, so a salt in device memory is never read back."""
    salt = torch.as_tensor(salt, dtype=torch.int64, device=device) & _MASK32
    return salt[0], salt[1]


def _threshold(keep: float) -> int:
    return min(int(round(keep * (1 << 24))), 1 << 24)


def keep_mask(eids: torch.Tensor, salt, keep: float,
              n_drop: int) -> torch.Tensor:
    """Boolean keep decision per edge id (any shape, int64 ids).  Ids at or
    past ``n_drop`` (appended self-loops) are always kept."""
    eids = eids.to(torch.int64)
    s0, s1 = _salts(salt, eids.device)
    h = _fmix32(_fmix32(eids ^ s0) ^ s1)
    return ((h >> 8) < _threshold(keep)) | (eids >= n_drop)


def dropped_values(val: torch.Tensor, eids: torch.Tensor, salt, keep: float,
                   n_drop: int) -> torch.Tensor:
    """Inverted-dropout values: ``val / keep`` for kept ids below
    ``n_drop``, ``val`` at or past it, 0 for dropped ids."""
    kept = keep_mask(eids, salt, keep, n_drop)
    inv_keep = torch.full((), 1.0 / keep, dtype=val.dtype, device=val.device)
    scale = torch.where(eids < n_drop, inv_keep, torch.ones_like(inv_keep))
    return torch.where(kept, val * scale, torch.zeros_like(val))


def draw_scalars(keep: float, n_drop: int, id_base: int = 0) -> tuple:
    """The part of a draw that the masked kernels take as scalars, fixed for
    a layer over a run: ``(thresh, n_drop, id_base, scale)``, the threshold
    as :func:`keep_mask` computes it, the offset that turns a list's ids
    into the global ids hashed, and ``scale`` the float32 ``1 / keep`` of
    :func:`dropped_values`.  The salts stay in device memory
    (:func:`device_salt`)."""
    scale = float(np.float32(1.0 / keep))  # rounded to nearest, as torch
    return _threshold(keep), int(n_drop), int(id_base), scale


def device_salt(salt, device) -> torch.Tensor:
    """``salt`` as the contiguous (2,) int64 tensor on ``device`` that the
    masked kernels read.  A salt on another device is copied; one on the
    host goes to a card through pinned memory, without blocking."""
    salt = torch.as_tensor(salt, dtype=torch.int64)
    device = torch.device(device)
    if salt.device.type != device.type:
        if device.type == "cuda":
            salt = salt.pin_memory()
        salt = salt.to(device, non_blocking=True)
    return salt.contiguous()


def host_salt(generator: torch.Generator) -> torch.Tensor:
    """Two salts drawn from a CPU generator, as edge dropout draws them."""
    return torch.randint(0, 1 << 32, (2,), generator=generator,
                         dtype=torch.int64)


def draw_salt(source, device) -> torch.Tensor:
    """A lazy draw's salt pair on ``device``, from ``source``: a CPU
    ``torch.Generator`` (:func:`host_salt`, then :func:`device_salt`), or a
    draw tape (``nn/core.py::DrawTape``), which hands out the device slot
    that each replayed epoch refills."""
    if isinstance(source, torch.Generator):
        return device_salt(host_salt(source), device)
    return source.salt(device)


def draw_uniform(source, n: int, device) -> torch.Tensor:
    """``n`` uniforms on ``device`` for an eager Bernoulli edge mask, from a
    CPU ``torch.Generator`` or a draw tape (as :func:`draw_salt`)."""
    if isinstance(source, torch.Generator):
        return torch.rand(n, generator=source).to(device)
    return source.uniform(n, device)


# (salt, val, (their versions, keep, n_drop), values) of the last draw
# realized
_last_draw = None


def drawn_values(val: torch.Tensor, salt, keep: float, n_drop: int,
                 id_base: int = 0) -> torch.Tensor:
    """Per-edge dropped values of the draw (``salt``, ``keep``, ``n_drop``)
    over the base values ``val``, by edge id: value ``i`` has the global id
    ``id_base + i`` (a slice of a larger edge list at that offset).  The
    values of the last draw are kept, keyed on the identity of its salt and
    value tensors, which every copy of a dropped graph shares, and on their
    versions, which a write in place (a salt buffer refilled for the next
    draw) advances: a layer's degree sum and its SpMM hash the edge ids
    once.  Values that carry a gradient are not kept."""
    global _last_draw
    key = (getattr(salt, "_version", None), val._version, keep, n_drop,
           id_base)
    hit = _last_draw
    if hit is not None and hit[0] is salt and hit[1] is val \
            and hit[2] == key:
        return hit[3]
    eids = torch.arange(id_base, id_base + val.shape[0], dtype=torch.int64,
                        device=val.device)
    out = dropped_values(val.to(torch.float32), eids, salt, keep, n_drop)
    if not out.requires_grad:
        _last_draw = (salt, val, key, out)
    return out


def materialize_dropped(graph: Graph) -> torch.Tensor:
    """Per-edge dropped values of a lazily dropped graph (the same numbers
    every grid and kernel computes): :func:`drawn_values` of its draw."""
    return drawn_values(graph.val, graph.drop_salt, graph.drop_keep,
                        graph.drop_n, graph.edge_offset)


@dataclasses.dataclass
class TrainGrids:
    """Host-built per-original-edge row and column ELL grids for one graph
    structure and its base values (numpy, bit-equal to the JAX package's
    ``TrainGrids``).  :meth:`lists` puts the walk's two lists on a device,
    once a device; :meth:`core` is the masked product through them."""

    n_nodes: int
    # row-split (A @ x): gather sources, combine into destination rows
    r_idx: np.ndarray    # (Vr, k) int32 source ids (pad -> n_nodes)
    r_vrow: np.ndarray   # (Vr,)  int32 destination row per virtual row
    r_val: np.ndarray    # (Vr, k) float32 base values (pad -> 0), or
                         # uint16 bfloat16 bits (grid_value_dtype)
    r_eid: np.ndarray    # (Vr, k) uint32 edge ids (pad -> 0)
    # column-split (A^T @ g, column sums): the same over the transpose
    c_idx: np.ndarray
    c_vrow: np.ndarray   # destination *column* per virtual column
    c_val: np.ndarray
    c_eid: np.ndarray

    def __post_init__(self):
        self._lists = {}
        self._values = {}

    @property
    def value_dtype(self) -> torch.dtype:
        """The dtype of the grids' base values: float32, or bfloat16 under
        ``GNNTF_GRID_VALUE_DTYPE`` (numpy holds their bits as uint16)."""
        return torch.bfloat16 if self.r_val.dtype == np.uint16 \
            else torch.float32

    def values(self, device) -> torch.Tensor:
        """The base values one an edge id, as the row grid holds them (in
        :attr:`value_dtype`), on ``device``, made once a device: what the
        walks read through ``eid`` where the grids are bfloat16."""
        key = str(torch.device(device))
        if key not in self._values:
            live = self.r_idx.reshape(-1) < self.n_nodes
            eid = self.r_eid.reshape(-1)[live].astype(np.int64)
            val = np.empty(len(eid), self.r_val.dtype)
            val[eid] = self.r_val.reshape(-1)[live]
            self._values[key] = _as_tensor(val).to(device)
        return self._values[key]

    def lists(self, device) -> Tuple[EdgeList, EdgeList]:
        """The row list and the column list on ``device`` (built on first
        use there): each grid's live slots in grid order, ``ptr`` over all
        N rows, with the dropout walks' units and tiles."""
        key = str(torch.device(device))
        if key not in self._lists:
            self._lists[key] = tuple(
                _grid_list(idx, vrow, eid, self.n_nodes, device)
                for idx, vrow, eid in ((self.r_idx, self.r_vrow, self.r_eid),
                                       (self.c_idx, self.c_vrow, self.c_eid)))
        return self._lists[key]

    def core(self, val: torch.Tensor, salt, keep: float, n_drop: int,
             x: torch.Tensor) -> torch.Tensor:
        """``A_dropped @ x`` for base values ``val`` (float32 or bfloat16,
        one an edge) and the draw (``salt``, ``keep``, ``n_drop``),
        differentiable in ``x``."""
        return _TrainGridsFn.apply(x, self.lists(x.device), val, salt, keep,
                                   n_drop)


def _as_tensor(val: np.ndarray) -> torch.Tensor:
    """A grid's values as a tensor: float32, or bfloat16 from their uint16
    bits."""
    if val.dtype == np.uint16:
        return torch.from_numpy(val.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(val)


def _grid_list(idx: np.ndarray, vrow: np.ndarray, eid: np.ndarray,
               n_nodes: int, device) -> EdgeList:
    """A grid's live slots in grid order (``ell_list``'s) as an
    :class:`EdgeList` with ``ptr`` over all ``n_nodes`` rows, cut for the
    dropout walks (``ell_gather._DROP_ITEMS``, ``_TILE_ITEMS``)."""
    from .ell_gather import _DROP_ITEMS, _TILE_ITEMS  # read at each build
    rows, ptr, src, slot = ell_list(idx, vrow, n_nodes)
    count = np.zeros(n_nodes, np.int64)
    count[rows] = np.diff(ptr)
    full = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(count, out=full[1:])
    return EdgeList.build(full, src, eid.reshape(-1)[slot].astype(np.int64),
                          device, items=_DROP_ITEMS,
                          tile_items=_TILE_ITEMS)


class _TrainGridsFn(torch.autograd.Function):
    """``x -> A_dropped @ x``: the masked walk over the row list.  The
    backward's ``dx`` is the masked walk over the column list with the same
    draw; the values get no gradient (the JAX package's zero cotangents)."""

    @staticmethod
    def forward(ctx, x, lists, val, salt, keep, n_drop):
        rows, cols = lists
        ctx.cols, ctx.draw = cols, (val, salt, keep, n_drop)
        return ell_gather_masked(rows, val, salt, keep, n_drop, x)

    @staticmethod
    def backward(ctx, dy):
        dx = None
        if ctx.needs_input_grad[0]:
            dx = ell_gather_masked(ctx.cols, *ctx.draw, dy.contiguous())
        return dx, None, None, None, None, None


def _route(layout, arr: np.ndarray, fill) -> np.ndarray:
    grid = np.full(layout.n_vrows * layout.k, fill, arr.dtype)
    grid[layout.slot] = arr
    return grid.reshape(layout.n_vrows, layout.k)


def grid_value_dtype() -> torch.dtype:
    """The dtype of the grids' base values, read from
    ``GNNTF_GRID_VALUE_DTYPE`` as the JAX package reads it: ``bf16`` or
    ``bfloat16`` gives ``torch.bfloat16`` (half the values' bytes; exact
    for unit values, weighted graphs lose mantissa bits), anything else
    ``torch.float32``."""
    name = os.environ.get("GNNTF_GRID_VALUE_DTYPE", "float32")
    return torch.bfloat16 if name in ("bf16", "bfloat16") else torch.float32


def _grid_values(val) -> np.ndarray:
    """``val`` in :func:`grid_value_dtype`: float32, or the uint16 bits of
    its bfloat16 rounding (to nearest even, as ``ml_dtypes`` rounds)."""
    val = torch.from_numpy(np.asarray(val).astype(np.float32))
    if grid_value_dtype() == torch.float32:
        return val.numpy()
    return val.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def build_train_grids(row: np.ndarray, col: np.ndarray, val,
                      n_nodes: int, k: int = _K) -> TrainGrids:
    """One-time host build: per-original-edge row and column ELL layouts
    (``build_ell(..., dedup=False)`` on (row, col) and (col, row)) with
    base-value (:func:`grid_value_dtype`) and edge-id grids."""
    from .spmm import build_ell
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = _grid_values(val)
    eids = np.arange(row.shape[0], dtype=np.uint32)
    rl = build_ell(row, col, n_nodes, k, dedup=False)
    cl = build_ell(col, row, n_nodes, k, dedup=False)
    return TrainGrids(
        n_nodes=n_nodes,
        r_idx=rl.idx, r_vrow=rl.vrow_row,
        r_val=_route(rl, val, val.dtype.type(0)),
        r_eid=_route(rl, eids, np.uint32(0)),
        c_idx=cl.idx, c_vrow=cl.vrow_row,
        c_val=_route(cl, val, val.dtype.type(0)),
        c_eid=_route(cl, eids, np.uint32(0)),
    )


_GRIDS_CACHE = IdLRU()  # byte-bounded; shares the global layout budget


def train_grids(graph: Graph, k: int = _K) -> TrainGrids:
    """The grids of ``graph``'s structure and base values, with its lists on
    its device, built once: memoized on the identity of ``row``, ``col`` and
    ``val`` (strong references kept and re-checked), which every layer's
    dropped copy of a graph shares, and on :func:`grid_value_dtype`, so a
    change of ``GNNTF_GRID_VALUE_DTYPE`` builds them anew.
    ``train_grids.builds`` counts the builds."""
    key = (id(graph.row), id(graph.col), id(graph.val), graph.n_nodes, k,
           str(grid_value_dtype()))
    anchors = (graph.row, graph.col, graph.val)
    grids = _GRIDS_CACHE.get(key, anchors)
    if grids is None:
        grids = build_train_grids(graph.row.cpu().numpy(),
                                  graph.col.cpu().numpy(),
                                  graph.val.detach().cpu().numpy(),
                                  graph.n_nodes, k)
        held = [grids.lists(graph.device)]
        if grids.value_dtype != torch.float32:
            held.append(grids.values(graph.device))
        # the degree walk's copies of the values in each list's order
        for lst in held[0]:
            list_values(lst, _walk_values(grids, graph))
        _GRIDS_CACHE.put(key, anchors, grids,
                         nbytes=sizeof(grids) + sizeof(held))
        train_grids.builds += 1
    return grids


train_grids.builds = 0


def grids_eligible(graph: Graph) -> bool:
    """The grid path needs enough edges to amortize the one-time build
    (:func:`min_edges`)."""
    return graph.n_edges_global >= min_edges()


def masked_row_values(grids: TrainGrids, graph: Graph) -> torch.Tensor:
    """The row grid's dropped values under ``graph``'s draw (host, plain,
    float32; the kernels hash the mask themselves)."""
    return dropped_values(_as_tensor(grids.r_val).to(torch.float32),
                          torch.from_numpy(grids.r_eid.astype(np.int64)),
                          graph.drop_salt, graph.drop_keep, graph.drop_n)


def masked_col_values(grids: TrainGrids, graph: Graph) -> torch.Tensor:
    """The column grid's dropped values under ``graph``'s draw (host,
    plain, float32)."""
    return dropped_values(_as_tensor(grids.c_val).to(torch.float32),
                          torch.from_numpy(grids.c_eid.astype(np.int64)),
                          graph.drop_salt, graph.drop_keep, graph.drop_n)


def _walk_values(grids: TrainGrids, graph: Graph) -> torch.Tensor:
    """The base values the walks read through ``eid``: ``graph.val`` in
    float32, or the grids' bfloat16 copy (:meth:`TrainGrids.values`)."""
    if grids.value_dtype == torch.float32:
        return graph.val.to(torch.float32).contiguous()
    return grids.values(graph.device)


def stochastic_spmm(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """``A_dropped @ x`` for a lazily dropped graph through its grids'
    lists.  The lazy scales are applied by the ``spmm`` dispatcher around
    this call; ``graph`` here is the unscaled base."""
    grids = train_grids(graph)
    return grids.core(_walk_values(grids, graph), graph.drop_salt,
                      graph.drop_keep, graph.drop_n,
                      x.to(torch.float32).contiguous())


def stochastic_degree(graph: Graph, by: str = "col") -> torch.Tensor:
    """Degree vector of the *dropped* adjacency with no E-sized scatter: the
    degree walk over the column list (``by='col'``: column sums, for the
    symmetric and bipartite normalizations) or the row list (``by='row'``:
    row sums)."""
    grids = train_grids(graph)
    rows, cols = grids.lists(graph.device)
    return ell_degree_masked(cols if by == "col" else rows,
                             _walk_values(grids, graph),
                             graph.drop_salt, graph.drop_keep, graph.drop_n)
