"""Sparse matrix x dense matrix products (SpMM), SDDMM and the dispatcher.

* ``spmm_segment`` — on the CPU gather + ``index_add_``, the plain
  reference, the gather's backward summing in a fixed order.  On a card,
  at any size, it is ``spmm_pallas`` (K2's store-mode walk forward and
  transposed), never a scatter with atomics: ``auto`` sends every fixed or
  eagerly dropped graph below ``_ELL_MIN_EDGES`` edges to it, so that a
  small graph's run repeats bit for bit.
* ``spmm_ell`` / ``spmm_hybrid`` — the per-call forms: the layout (ELL, or
  the rest ELL beside a dense hub slice) and K1's list are built once per
  structure; each call routes the edge values into K1's list values (and
  the hub slice) with one ``index_add_`` each, runs the hub matmul, then
  the ELL gather-reduce kernel K1 (``ops/ell_gather.py``) adding into it.
  Differentiable in ``x`` (the walk over K1's transposed list) and in the
  values.
* :class:`PreparedSpMM` — a fixed adjacency's operator, the values routed
  once; ``spmm`` keeps one per (structure, values) (``_prepared_cached``).
  Under ``auto`` it is one walk, K1's scaled walk over every live slot of
  the hub-free ELL, with a normalized graph's scales and identity applied
  in its gathers and its store (``ell_gather.ell_gather_scaled``); under
  ``hybrid`` the JAX package's route, the dense hub slice's matmul and K1
  adding the rest into it, the scales around them.
* ``stochastic_spmm`` (``ops/stochastic.py``) — a lazily dropped graph
  through its training grids: K1's walk in masked mode, the mask hashed in
  the kernel, the backward over the column list.
* ``spmm_pallas`` (``ops/blocked.py``) — the blocked-COO kernel K2.

The implementation is selected as in the JAX package: ``auto`` (the
default), ``segment``, ``ell``, ``hybrid`` or ``pallas``, process-wide with
:func:`set_spmm_impl` or per call with the :class:`spmm_impl` scope.  An
executor override (:class:`spmm_executor`) takes precedence over every impl.

Layouts (built once per graph structure, numpy, copied from the JAX
package so the two stay bit-equal):

* ``build_ell`` — rows split into virtual rows of at most ``k`` edges,
  duplicate (row, col) pairs coalesced into one slot.
* ``build_hybrid`` — the ``n_hubs`` source nodes with the most unique edges
  go to a dense (N, H) slice; the rest take the ELL path.  ``None`` when hub
  coverage is low or the slice would exceed the memory cap.

Lazy scales and identity apply around the product in the JAX order,
``rs ⊙ (A @ (cs ⊙ x)) + w·x``.
"""
from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..graph.coo import Graph
from ..utils.idcache import IdLRU, sizeof
from .blocked import EdgeList, blocked_layout, blocked_spmm, spmm_pallas
from .ell_gather import (_UNIT_ITEMS, ell_gather_list, ell_gather_scaled,
                         ell_gather_scaled_backward, ell_gather_transposed,
                         ell_list, ell_transposed_list, whole_list)
from .segment import gather_rows

_IMPL_NAMES = ("auto", "segment", "ell", "hybrid", "pallas")
_ELL_MIN_EDGES = 65_536
_ELL_DEFAULT_K = 8

# The process-wide default (set_spmm_impl) and a per-context override (the
# spmm_impl scope), which takes precedence where it is set.
_SPMM_IMPL_DEFAULT = "auto"
_SPMM_IMPL_VAR: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("gnntf_torch_spmm_impl", default=None)

# Executor override: a callable ``(graph, x) -> out`` that takes precedence
# over every impl, per context (thread), as in the JAX package.  An executor
# with ``supports_lazy_dropout`` receives a dropped graph with its draw
# intact; any other receives the realized per-edge values.
_SPMM_EXECUTOR_VAR: contextvars.ContextVar[Optional[object]] = \
    contextvars.ContextVar("gnntf_torch_spmm_executor", default=None)


class spmm_executor:
    """Context manager scoping an executor override to a call."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        self._token = _SPMM_EXECUTOR_VAR.set(self.fn)
        return self.fn

    def __exit__(self, *exc):
        _SPMM_EXECUTOR_VAR.reset(self._token)
        return False


class spmm_impl:
    """Context manager scoping the SpMM implementation selection
    (``auto``/``segment``/``ell``/``hybrid``/``pallas``) to a call;
    ``None`` defers to the process default."""

    def __init__(self, name: Optional[str]):
        if name is not None and name not in _IMPL_NAMES:
            raise ValueError(name)
        self.name = name

    def __enter__(self):
        self._token = _SPMM_IMPL_VAR.set(self.name)
        return self.name

    def __exit__(self, *exc):
        _SPMM_IMPL_VAR.reset(self._token)
        return False


def set_spmm_executor(fn) -> None:
    """Install (or with ``None`` remove) the executor override for the
    current context.  Prefer the :class:`spmm_executor` scope."""
    _SPMM_EXECUTOR_VAR.set(fn)


def set_spmm_impl(name: str) -> None:
    """Set the process-wide default SpMM implementation."""
    global _SPMM_IMPL_DEFAULT
    if name not in _IMPL_NAMES:
        raise ValueError(name)
    _SPMM_IMPL_DEFAULT = name


def current_executor():
    """The executor override in force here, or None."""
    return _SPMM_EXECUTOR_VAR.get()


def current_impl() -> str:
    """The SpMM implementation in force here."""
    return _SPMM_IMPL_VAR.get() or _SPMM_IMPL_DEFAULT


def _scaled_call(fn, graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Apply a lazily-scaled graph's scales as (N, F) row-wise multiplies —
    and the lazy identity as ``+ w*x`` — around ``fn`` on the base graph."""
    rs, cs = graph.row_scale, graph.col_scale
    w = graph.eye_weight
    base = dataclasses.replace(graph, row_scale=None, col_scale=None,
                               eye_weight=0.0)
    xin = x
    if cs is not None:
        xin = xin * cs[:, None].to(x.dtype)
    out = fn(base, xin)
    if rs is not None:
        out = out * rs[:, None].to(out.dtype)
    if w != 0.0:
        out = out + w * x
    return out


def spmm_segment(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """out[i, :] = sum_e{row[e]=i} val[e] * x[col[e], :]  (out = A @ X).

    On the CPU the gather and ``index_add_`` in plain torch, the gather's
    backward an ``index_add_`` in index order (``segment.gather_rows``;
    autograd's backward of ``x[col]`` sums in no fixed order); on a card
    :func:`spmm_pallas`, K2's store-mode walk (its layout built once per
    structure).  Differentiable in ``x`` and in the values."""
    if graph.scaled or graph.eye_weight != 0.0:
        return _scaled_call(spmm_segment, graph, x)
    graph = graph.materialized_dropout()
    if x.device.type == "cuda":
        return spmm_pallas(graph, x)
    gathered = gather_rows(x, graph.col) * graph.val[:, None].to(x.dtype)
    out = x.new_zeros(graph.n_nodes, x.shape[1])
    return out.index_add_(0, graph.row, gathered)


def edge_degree(graph: Graph, by: str = "col",
                walk: bool = False) -> torch.Tensor:
    """The column sums (``by='col'``) or row sums of ``graph``'s values as
    an (N,) tensor: below ``_ELL_MIN_EDGES`` edges on a card, or at any size
    with ``walk``, K2's store-mode walk over the transposed (or forward)
    list of :func:`spmm_pallas`'s layout with a column of ones, never a
    scatter with atomics; elsewhere ``index_add_`` (in index order on the
    CPU; on a card a larger fixed graph's degrees are summed once, when its
    normalized adjacency is built)."""
    if graph.device.type != "cuda" or (graph.n_edges >= _ELL_MIN_EDGES
                                       and not walk):
        idx = graph.col if by == "col" else graph.row
        deg = torch.zeros(graph.n_nodes, dtype=graph.val.dtype,
                          device=graph.device)
        return deg.index_add_(0, idx, graph.val)
    prep = blocked_layout(graph)
    ones = torch.ones(graph.n_nodes, 1, dtype=torch.float32,
                      device=graph.device)
    return blocked_spmm(prep.transposed if by == "col" else prep.forward,
                        graph.val.to(torch.float32).contiguous(),
                        ones)[:, 0].to(graph.val.dtype)


@dataclasses.dataclass(frozen=True)
class ELLLayout:
    """Host-built row-split ELL layout for one graph *structure*.

    ``idx[v, j]`` — source node of the j-th edge of virtual row ``v``
    (padded with ``n_nodes``); ``slot[e]`` — flat position of unique edge
    ``e`` in the [V, k] value grid; ``vrow_row[v]`` — the destination row of
    virtual row ``v`` (non-decreasing).  With duplicates, ``dup_order`` sorts
    the original edges to (row, col) order, ``dup_seg`` numbers their unique
    pairs and ``edge_slot`` gives each *original* edge its pair's slot, so one
    scatter-add both coalesces and places the live values."""

    idx: np.ndarray        # (V, k) int32
    slot: np.ndarray       # (E_u,) int32 — per *unique* edge
    vrow_row: np.ndarray   # (V,) int32
    k: int
    n_nodes: int
    dup_order: Optional[np.ndarray] = None  # (E,) sort to (row,col) order
    dup_seg: Optional[np.ndarray] = None    # (E,) unique-pair id, sorted
    n_unique: int = 0
    edge_slot: Optional[np.ndarray] = None  # (E,) int32 per original edge

    @property
    def n_vrows(self) -> int:
        return int(self.idx.shape[0])


def build_ell(row: np.ndarray, col: np.ndarray, n_nodes: int,
              k: int = _ELL_DEFAULT_K, dedup: bool = True) -> ELLLayout:
    """Build the row-split ELL layout (host, once per structure): stable
    argsort by row, then a scatter of each edge to its virtual row; without
    deduplication one C++ pass (``utils/native.py::build_ell_native``, the
    same layout) where the library builds, as in the JAX package."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    e = row.shape[0]
    if dedup and e:
        order = np.lexsort((col, row))
        rs, cs = row[order], col[order]
        new = np.ones(e, bool)
        new[1:] = (rs[1:] != rs[:-1]) | (cs[1:] != cs[:-1])
        n_u = int(new.sum())
        if n_u < e:
            uid = np.cumsum(new, dtype=np.int64) - 1
            base = build_ell(rs[new], cs[new], n_nodes, k, dedup=False)
            es = np.empty(e, np.int32)
            es[order] = base.slot[uid]
            return dataclasses.replace(
                base, dup_order=order.astype(np.int32),
                dup_seg=uid.astype(np.int32), n_unique=n_u, edge_slot=es)
    if e and n_nodes < 2**31 and row.max() < n_nodes and col.max() <= n_nodes:
        deg = np.bincount(row, minlength=n_nodes)
        v_total = int(np.sum(-(-deg // k)))
        if v_total > 0:
            from ..utils.native import build_ell_native
            built = build_ell_native(row, col, n_nodes, k, v_total)
            if built is not None:
                idx, slot, vrow_row = built
                return ELLLayout(idx=idx, slot=slot, vrow_row=vrow_row, k=k,
                                 n_nodes=n_nodes, edge_slot=slot)
    order = None
    if e and np.any(row[1:] < row[:-1]):
        order = np.argsort(row, kind="stable")
        row_s, col_s = row[order], col[order]
    else:
        row_s, col_s = row, col
    deg = np.bincount(row_s, minlength=n_nodes)
    start = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=start[1:])
    rank = np.arange(e, dtype=np.int64) - start[row_s]
    vrows_per_row = -(-deg // k)
    voff = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(vrows_per_row, out=voff[1:])
    vrow = voff[row_s] + rank // k
    v_total = max(int(voff[-1]), 1)
    slot_sorted = vrow * k + rank % k
    idx = np.full((v_total, k), n_nodes, np.int32)
    idx.reshape(-1)[slot_sorted] = col_s
    slot = np.empty(e, np.int64)
    if order is not None:
        slot[order] = slot_sorted
    else:
        slot = slot_sorted
    vrow_row = np.repeat(np.arange(n_nodes, dtype=np.int32), vrows_per_row)
    if vrow_row.shape[0] == 0:
        vrow_row = np.zeros(1, np.int32)
    slot = slot.astype(np.int32)
    return ELLLayout(idx=idx, slot=slot,
                     vrow_row=vrow_row, k=k, n_nodes=n_nodes, edge_slot=slot)


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    """Host-built layout for the hub-densified SpMM.

    ``dup_order`` sorts original edges to (row, col) order, ``dup_seg``
    (when duplicates exist) numbers their unique pairs.  Unique edges whose
    source is a hub (``hub_sel``) go to the dense (N, H) slice at flat
    positions ``hub_flat``; the rest (``rest_sel``) take the ELL path.
    Per original edge, ``ell_slot_of_edge`` and ``dense_flat_of_edge`` hold
    its target on one side and an out-of-range sentinel (V*k, resp. N*H) on
    the other."""

    rest: ELLLayout
    dup_order: Optional[np.ndarray]  # (E,) or None (identity)
    dup_seg: Optional[np.ndarray]    # (E,) or None (no duplicates)
    n_unique: int
    rest_sel: np.ndarray             # (E_rest,) int32 into unique edges
    hub_sel: np.ndarray              # (E_hub,) int32 into unique edges
    hub_flat: np.ndarray             # (E_hub,) int32 into the (N*H,) slice
    hub_ids: np.ndarray              # (H,) int32 hub node ids
    n_hubs: int
    n_nodes: int
    ell_slot_of_edge: Optional[np.ndarray] = None    # (E,) into rest grid
    dense_flat_of_edge: Optional[np.ndarray] = None  # (E,) into (N*H,)


_HUB_COUNT = 256
_HUB_MIN_COVERAGE = 0.15        # below this the dense slice isn't worth it
_HUB_MEM_CAP = 512 * 1024 ** 2  # max bytes for the dense (N, H) f32 slice


def build_hybrid(row, col, n_nodes: int, k: int = _ELL_DEFAULT_K,
                 n_hubs: int = _HUB_COUNT,
                 min_coverage: float = _HUB_MIN_COVERAGE,
                 mem_cap: int = _HUB_MEM_CAP) -> Optional[HybridLayout]:
    """Build the hub-densified layout, or None when hub densification
    doesn't pay (low hub coverage, tiny graph, or dense-slice memory cap
    exceeded) — the caller then falls back to plain ELL."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    e = row.shape[0]
    if e == 0 or n_nodes * n_hubs * 4 > mem_cap:
        return None
    order = np.lexsort((col, row))
    rs, cs = row[order], col[order]
    new = np.ones(e, bool)
    new[1:] = (rs[1:] != rs[:-1]) | (cs[1:] != cs[:-1])
    n_u = int(new.sum())
    if n_u == e:
        dup_seg = None
        ru, cu = rs, cs
        dup_order = None if np.array_equal(order, np.arange(e)) \
            else order.astype(np.int32)
    else:
        dup_seg = (np.cumsum(new, dtype=np.int64) - 1).astype(np.int32)
        dup_order = order.astype(np.int32)
        ru, cu = rs[new], cs[new]
    cdeg = np.bincount(cu, minlength=n_nodes)
    n_hubs = min(n_hubs, int(np.sum(cdeg > 0)))
    if n_hubs == 0:
        return None
    hub_ids = np.argpartition(-cdeg, n_hubs - 1)[:n_hubs]
    coverage = float(cdeg[hub_ids].sum()) / max(1, n_u)
    if coverage < min_coverage:
        return None
    hub_pos = np.full(n_nodes, -1, np.int64)
    hub_pos[hub_ids] = np.arange(n_hubs)
    is_hub = hub_pos[cu] >= 0
    rest = build_ell(ru[~is_hub], cu[~is_hub], n_nodes, k, dedup=False)
    rest_sel = np.flatnonzero(~is_hub).astype(np.int32)
    hub_sel = np.flatnonzero(is_hub).astype(np.int32)
    hub_flat = (ru[is_hub] * n_hubs + hub_pos[cu[is_hub]]).astype(np.int32)
    # per-unique routing tables (out-of-range sentinel on the other half)
    u2ell = np.full(n_u, rest.n_vrows * k, np.int32)
    u2ell[rest_sel] = rest.slot
    u2dense = np.full(n_u, n_nodes * n_hubs, np.int32)
    u2dense[hub_sel] = hub_flat
    # per-original routing: duplicates of a pair share its target slot
    if dup_order is None:  # already in (row, col) order, no duplicates
        ell_of_edge, dense_of_edge = u2ell, u2dense
    else:
        per_sorted = (u2ell, u2dense) if dup_seg is None \
            else (u2ell[dup_seg], u2dense[dup_seg])
        ell_of_edge = np.empty(e, np.int32)
        dense_of_edge = np.empty(e, np.int32)
        ell_of_edge[dup_order] = per_sorted[0]
        dense_of_edge[dup_order] = per_sorted[1]
    return HybridLayout(
        rest=rest, dup_order=dup_order, dup_seg=dup_seg, n_unique=n_u,
        rest_sel=rest_sel, hub_sel=hub_sel, hub_flat=hub_flat,
        hub_ids=hub_ids.astype(np.int32), n_hubs=n_hubs, n_nodes=n_nodes,
        ell_slot_of_edge=ell_of_edge, dense_flat_of_edge=dense_of_edge)


def _route(slots: torch.Tensor, val: torch.Tensor, size: int) -> torch.Tensor:
    """Scatter-add per-edge values into a flat grid of ``size`` cells
    (duplicates add up); the sentinel ``size`` lands in one extra cell that
    is dropped."""
    grid = val.new_zeros(size + 1)
    grid.index_add_(0, slots, val)
    return grid[:size]


class _ELLGatherFn(torch.autograd.Function):
    """``(x, base, val) -> base + A_rest @ x`` through K1 over its list,
    adding into ``base`` in place (marked dirty).  The backward passes
    ``dy`` to ``base``.  ``x`` gets the transposed product ``A_rest^T dy``
    from one walk over the transposed list (``transposed``, a callable that
    gives the list's :func:`ell_transposed_list`, built once by its owner;
    without one the list is built per call): on a card the store-mode walk,
    on the CPU its plain version, which sums in the same order.  ``val``,
    only when it asks for it (no model's values do), gets ``dval[e] =
    <dy[rows[r]], x[idx[e]]>`` over each row r's slots in plain torch."""

    @staticmethod
    def forward(ctx, x, base, lst, val, transposed=None):
        ctx.mark_dirty(base)
        ctx.lst, ctx.n_in = lst, x.shape[0]
        ctx.transposed = transposed
        ctx.save_for_backward(x if ctx.needs_input_grad[3] else None, val)
        return ell_gather_list(lst, val, x, base)

    @staticmethod
    def backward(ctx, dy):
        lst, (x, val) = ctx.lst, ctx.saved_tensors
        dx = dval = None
        if ctx.needs_input_grad[0]:
            lst_t = (ell_transposed_list(lst, ctx.n_in)
                     if ctx.transposed is None else ctx.transposed())
            dx = ell_gather_transposed(lst_t, val, dy.contiguous())
        if ctx.needs_input_grad[3]:
            dst = torch.repeat_interleave(lst.rows.long(),
                                          lst.ptr.diff().long(),
                                          output_size=lst.n_edges)
            dval = (dy[dst] * x[lst.idx.long()]).sum(-1)
        return (dx, dy if ctx.needs_input_grad[1] else None, None, dval,
                None)


class _RoutedLayout:
    """One graph structure's layout for K1 on a device: the ELL (with hubs:
    the rest ELL beside the dense hub slice of ``build_hybrid``, when it
    pays), K1's list over its live slots, and each original edge's place in
    the list and in the hub slice.  :meth:`values` routes a vector of edge
    values into them, one ``index_add_`` each, so duplicates coalesce;
    :meth:`apply` runs the hub matmul (or zeros), then K1 adding into it.
    Only the list, the routes and the hub ids are kept on the device, and,
    from first use on, the scaled walk's list over all rows (:meth:`whole`)
    and the backward's transposed list (:meth:`transposed`; neither in
    :meth:`nbytes`, which the cache reads when the layout is new)."""

    def __init__(self, row: np.ndarray, col: np.ndarray, n_nodes: int,
                 k: int, device, hubs: bool):
        hybrid = build_hybrid(row, col, n_nodes, k) if hubs else None
        if hybrid is None:
            ell = build_ell(row, col, n_nodes, k)
            slots = ell.edge_slot
        else:
            ell = hybrid.rest
            slots = hybrid.ell_slot_of_edge
        self.n_nodes = n_nodes
        self.ell = ell
        rows, ptr, src, slot = ell_list(ell.idx, ell.vrow_row, n_nodes)
        self.list = EdgeList.build(ptr, src, None, device, rows=rows,
                                   items=_UNIT_ITEMS)
        self._host_list = (rows, ptr, src)
        self._transposed = self._whole = None
        # each edge's list position; the sentinel (hub edges, V*k) maps to
        # the extra cell that _route drops
        position = np.full(ell.n_vrows * ell.k + 1, len(slot), np.int64)
        position[slot] = np.arange(len(slot))
        self.to_list = torch.from_numpy(position[slots]).to(device)
        self.to_dense = self.hub_ids = None
        self.n_hubs = 0
        if hybrid is not None:
            self.n_hubs = hybrid.n_hubs
            self.to_dense = torch.from_numpy(
                hybrid.dense_flat_of_edge.astype(np.int64)).to(device)
            self.hub_ids = torch.from_numpy(
                hybrid.hub_ids.astype(np.int64)).to(device)

    def values(self, val: torch.Tensor):
        """K1's list values and the (N, H) hub slice (None without hubs)
        of the edge values ``val``, as float32."""
        val = val.to(torch.float32)
        list_val = _route(self.to_list, val, self.list.n_edges)
        dense = None
        if self.to_dense is not None:
            dense = _route(self.to_dense, val, self.n_nodes * self.n_hubs
                           ).view(self.n_nodes, self.n_hubs)
        return list_val, dense

    def apply(self, list_val: torch.Tensor, dense: Optional[torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        """``dense @ x[hub_ids] + A_rest @ x``, the hub product first and
        K1 adding the rest into it (the JAX package's ``ell + dense @
        x[hubs]``, one addition an element)."""
        x = x.contiguous()
        if dense is not None:
            out = torch.matmul(dense, x[self.hub_ids])
        else:
            out = x.new_zeros(self.n_nodes, x.shape[1])
        if torch.is_grad_enabled() and (x.requires_grad or out.requires_grad
                                        or list_val.requires_grad):
            return _ELLGatherFn.apply(x, out, self.list, list_val,
                                      self.transposed)
        return ell_gather_list(self.list, list_val, x, out)

    def transposed(self):
        """K1's transposed list (the backward's: K2's entry under
        ``hybrid`` and the per-call ``ell``, the scaled walk under
        ``auto``), built on first use."""
        if self._transposed is None:
            self._transposed = ell_transposed_list(self.list, self.n_nodes)
        return self._transposed

    def whole(self):
        """K1's list over all rows (``ell_gather.whole_list``, the scaled
        walk's; its slots and values are the list's), built on first
        use."""
        if self._whole is None:
            self._whole = whole_list(*self._host_list, self.n_nodes,
                                     self.list.device)
        return self._whole

    def nbytes(self) -> int:
        return sizeof((self.list, self.to_list, self.to_dense, self.hub_ids,
                       self.ell))


_ROUTED_CACHE = IdLRU()  # byte-bounded, anchored on the structure


def _routed_layout(graph: Graph, k: int, hubs: bool) -> _RoutedLayout:
    key = ("hybrid" if hubs else "ell", id(graph.row), id(graph.col),
           graph.n_nodes, k)
    anchors = (graph.row, graph.col)
    routed = _ROUTED_CACHE.get(key, anchors)
    if routed is None:
        routed = _RoutedLayout(graph.row.cpu().numpy(),
                               graph.col.cpu().numpy(), graph.n_nodes, k,
                               graph.device, hubs)
        _ROUTED_CACHE.put(key, anchors, routed, nbytes=routed.nbytes())
    return routed


def spmm_ell(graph: Graph, x: torch.Tensor,
             k: int = _ELL_DEFAULT_K) -> torch.Tensor:
    """SpMM through the row-split ELL layout (duplicates coalesced), built
    once per structure; the values are routed per call, so dropped or
    learned values work, and the product is differentiable in ``x`` and in
    the values."""
    if graph.scaled or graph.eye_weight != 0.0:
        return _scaled_call(functools.partial(spmm_ell, k=k), graph, x)
    graph = graph.materialized_dropout()
    routed = _routed_layout(graph, k, hubs=False)
    list_val, _ = routed.values(graph.val)
    return routed.apply(list_val, None, x)


def spmm_hybrid(graph: Graph, x: torch.Tensor,
                k: int = _ELL_DEFAULT_K) -> torch.Tensor:
    """Hub-densified SpMM: a dense (N, H) matmul for the edges whose source
    is one of the ``H`` busiest nodes, K1 over the rest ELL adding into it;
    plain ELL where the hub slice does not pay.  The values are routed per
    call; differentiable in ``x`` and in the values."""
    if graph.scaled or graph.eye_weight != 0.0:
        return _scaled_call(functools.partial(spmm_hybrid, k=k), graph, x)
    graph = graph.materialized_dropout()
    routed = _routed_layout(graph, k, hubs=True)
    return routed.apply(*routed.values(graph.val), x)


class _ScaledGatherFn(torch.autograd.Function):
    """``x -> rs ⊙ (A @ (cs ⊙ x)) + w·x`` through K1's scaled walk over the
    whole list (the values are constants).  The backward's ``dx = cs ⊙
    (A^T (rs ⊙ dy)) + w·dy`` is one launch of the same walk over the
    transposed list, the scales and the identity in its gathers and its
    store (:func:`ell_gather_scaled_backward`)."""

    @staticmethod
    def forward(ctx, x, routed, val, rs, cs, w):
        ctx.routed, ctx.val, ctx.rs, ctx.cs, ctx.w = routed, val, rs, cs, w
        return ell_gather_scaled(routed.whole(), val, x, rs, cs, w)

    @staticmethod
    def backward(ctx, dy):
        dx = ell_gather_scaled_backward(ctx.routed.transposed(), ctx.val,
                                        dy.contiguous(), ctx.rs, ctx.cs,
                                        ctx.w)
        return dx, None, None, None, None, None


class PreparedSpMM:
    """``x -> A @ x`` for a fixed adjacency, with the layout, K1's list and
    the value routing done once at construction, on the graph's device; a
    normalized graph's lazy scales and identity apply in the JAX order,
    ``rs ⊙ (A @ (cs ⊙ x)) + w·x``.

    The route (``hubs=False``, what ``auto`` takes): one walk per call, K1's
    scaled walk over every live slot of the hub-free ELL
    (``ell_gather.ell_gather_scaled``), which scales the gathered rows by
    ``cs`` and writes each row as ``rs ⊙ sum + w·x``; no hub slice is
    built.  With ``hubs`` (``impl="hybrid"``), the JAX package's route:
    ``torch.matmul(dense, xin[hub_ids])`` when the graph has a hub slice
    (else zeros), then K1 over the rest ELL's list adding into it (``ell +
    dense @ x[hubs]``, one addition an element), the scales and identity
    around them in plain torch.  Only the lists, the values and the hub
    slice are kept on the device; ``ell`` is the host layout.  The values
    are constants: no gradient flows to them."""

    def __init__(self, graph: Graph, k: int = _ELL_DEFAULT_K,
                 hubs: bool = False):
        if graph.dropped:
            raise TypeError("PreparedSpMM is for fixed adjacencies; a lazily "
                            "dropped graph resamples per call: use spmm()")
        self.n_nodes = graph.n_nodes
        self.row_scale = graph.row_scale
        self.col_scale = graph.col_scale
        self.eye_weight = graph.eye_weight
        self._routed = _routed_layout(graph, k, hubs=hubs)
        self.ell = self._routed.ell
        self.hub_ids = self._routed.hub_ids
        self.k1_val, self.dense = self._routed.values(graph.val.detach())
        self.hubs = hubs
        if hubs:
            self.k1_list = self._routed.list
            return
        self.k1_list = self._routed.whole()
        self._scales = tuple(
            None if v is None else v.to(torch.float32).contiguous()
            for v in (self.row_scale, self.col_scale))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.hubs:
            rs, cs = self._scales
            x32 = x.to(torch.float32).contiguous()
            if torch.is_grad_enabled() and x.requires_grad:
                return _ScaledGatherFn.apply(x32, self._routed, self.k1_val,
                                             rs, cs, float(self.eye_weight))
            return ell_gather_scaled(self.k1_list, self.k1_val, x32, rs, cs,
                                     float(self.eye_weight))
        xin = x
        if self.col_scale is not None:
            xin = xin * self.col_scale[:, None].to(x.dtype)
        out = self._routed.apply(self.k1_val, self.dense, xin)
        if self.row_scale is not None:
            out = out * self.row_scale[:, None].to(out.dtype)
        if self.eye_weight != 0.0:
            out = out + self.eye_weight * x
        return out

    def nbytes(self) -> int:
        return sizeof((self.k1_val, self.dense, self.row_scale,
                       self.col_scale))


def prepare_spmm(graph: Graph, k: int = _ELL_DEFAULT_K) -> PreparedSpMM:
    """A :class:`PreparedSpMM` for a fixed (undropped) graph, as the JAX
    package's ``prepare_spmm`` builds one: the route of ``auto``."""
    return PreparedSpMM(graph, k)


_PREPARED_CACHE = IdLRU()


def _prepared_cached(graph: Graph, k: int,
                     hubs: bool = False) -> PreparedSpMM:
    """The :class:`PreparedSpMM` of an unscaled, undropped graph, built once
    per (structure, values, route): memoized on the identity of ``row``,
    ``col`` and ``val`` (strong references kept and re-checked)."""
    key = ("prep", id(graph.row), id(graph.col), id(graph.val),
           graph.n_nodes, k, hubs)
    anchors = (graph.row, graph.col, graph.val)
    prep = _PREPARED_CACHE.get(key, anchors)
    if prep is None:
        prep = PreparedSpMM(graph, k, hubs)
        _PREPARED_CACHE.put(key, anchors, prep, nbytes=prep.nbytes())
    return prep


def prepare(graph: Graph, impl: Optional[str] = None
            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The operator ``x -> A @ x`` that :func:`spmm` applies to the fixed
    (undropped) ``graph`` under ``impl`` (default: the one in force), built
    once so a caller holding a fixed adjacency can reuse it: ``pallas`` runs
    K2; ``segment`` :func:`spmm_segment` (the plain product on the CPU, K2
    on a card); ``ell`` the per-call :func:`spmm_ell`; ``auto``/``hybrid``
    a :class:`PreparedSpMM` with the scales folded in at or above
    ``_ELL_MIN_EDGES`` edges (``auto``: K1's scaled walk over every edge;
    ``hybrid``: the hub slice beside K1), below it :func:`spmm_segment`
    (``auto``) or the per-call :func:`spmm_hybrid`."""
    impl = current_impl() if impl is None else impl
    if impl not in _IMPL_NAMES:
        raise ValueError(impl)
    if graph.dropped:
        raise ValueError("prepare() takes a fixed adjacency; a dropped graph "
                         "goes through spmm()")
    if graph.is_shard:  # only the executor in force multiplies by a shard
        return functools.partial(spmm, graph)
    if impl in ("auto", "hybrid") and graph.n_edges >= _ELL_MIN_EDGES:
        return PreparedSpMM(graph, _ELL_DEFAULT_K, hubs=impl == "hybrid")
    return functools.partial(_per_call, impl, graph)


def _per_call(impl: str, graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """The product under ``impl`` with the values routed per call: ``auto``
    takes ``ell`` (K1 over every edge, no hub slice) at or above
    ``_ELL_MIN_EDGES`` edges, else ``segment``."""
    if impl == "auto":
        impl = "ell" if graph.n_edges >= _ELL_MIN_EDGES else "segment"
    if impl == "pallas":
        return spmm_pallas(graph, x)
    if impl == "hybrid":
        return spmm_hybrid(graph, x)
    if impl == "ell":
        return spmm_ell(graph, x)
    return spmm_segment(graph, x)


def spmm(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Dispatching SpMM under the implementation in force (the JAX
    package's dispatcher).

    The lazy scales and identity apply around the product.  An executor
    override takes the product first.  A lazily dropped graph at or above
    ``min_edges()`` edges goes through ``stochastic_spmm`` (its training
    grids, K1's masked walk) under ``auto``/``hybrid``/``ell``; any other
    dropped graph is realized per edge and takes the per-call form of its
    impl (``pallas``: K2).  A fixed graph under ``auto``/``hybrid`` at or
    above ``_ELL_MIN_EDGES`` edges, whose values need no gradient, takes the
    :class:`PreparedSpMM` kept for it (``_prepared_cached``); otherwise the
    per-call form of its impl."""
    if graph.scaled or graph.eye_weight != 0.0:
        return _scaled_call(spmm, graph, x)
    executor = _SPMM_EXECUTOR_VAR.get()
    if executor is not None:
        if graph.dropped and not getattr(executor, "supports_lazy_dropout",
                                         False):
            graph = graph.materialized_dropout()
        return executor(graph, x)
    if graph.is_shard:
        raise ValueError("the product of an edge shard needs the gspmd "
                         "executor in force (parallel.dist.GspmdExecutor)")
    impl = current_impl()
    if graph.dropped:
        from .stochastic import grids_eligible, stochastic_spmm
        if impl in ("auto", "hybrid", "ell") and grids_eligible(graph):
            return stochastic_spmm(graph, x)
        # realized values are new every draw: never a prepared operator
        return _per_call(impl, graph.materialized_dropout(), x)
    if (impl in ("auto", "hybrid") and graph.n_edges >= _ELL_MIN_EDGES
            and not graph.val.requires_grad):
        return _prepared_cached(graph, _ELL_DEFAULT_K, impl == "hybrid")(x)
    return _per_call(impl, graph, x)


class _EdgeDotFn(torch.autograd.Function):
    """``(x[row] * y[col]).sum(-1)`` whose backward scatters with
    ``index_add_``: on the CPU it sums in a fixed order, where the backward
    of ``x[row]`` (``index_put_`` with ``accumulate``) does not."""

    @staticmethod
    def forward(ctx, row, col, x, y):
        ctx.save_for_backward(row, col, x, y)
        return (x[row] * y[col]).sum(-1)

    @staticmethod
    def backward(ctx, g):
        row, col, x, y = ctx.saved_tensors
        g = g[:, None]
        dx = dy = None
        if ctx.needs_input_grad[2]:
            dx = torch.zeros_like(x).index_add_(0, row, g * y[col])
        if ctx.needs_input_grad[3]:
            dy = torch.zeros_like(y).index_add_(0, col, g * x[row])
        return None, None, dx, dy


def edge_dot(row: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
             y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pair dot products ``s[e] = <x[row[e]], y[col[e]]>`` (``y``
    defaults to ``x``): the SDDMM core on an explicit index list, in plain
    torch (the JAX package has no kernel for it)."""
    return _EdgeDotFn.apply(row, col, x, x if y is None else y)


def sddmm(graph: Graph, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul on the sparsity pattern:
    ``s[e] = <x[row[e]], y[col[e]]>``."""
    return edge_dot(graph.row, graph.col, x, y)
