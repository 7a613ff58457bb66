"""K1, the ELL gather-reduce with the virtual-row combine fused in, added
into a base:

    out[r] = base[r] + sum_{v: vrow_row[v] = r} sum_{j<k} vals[v, j] * x[idx[v, j]]

It replaces the TPU kernel ``gnntf_tpu/ops/pallas/dma_gather.py::_kernel``
(with the ``segment_sum`` over ``vrow_row`` that runs after it), the heart of
``_ell_compute`` in the JAX package; ``PreparedSpMM`` adds its result to the
hub slice's product, as the JAX package does with ``ell + dense @ x[hubs]``.

The kernel does not walk the (V, k) grid.  :func:`ell_list` keeps the grid's
live slots in grid order (virtual row, then slot: the order ``_ell_compute``
sums a row in) as a CSR list over the rows that have a slot, and
``EdgeList.build`` cuts it into units of ``_UNIT_ITEMS`` items.  The kernel
is the edge-balanced walk of K2 (``csrc/edge_walk.cuh``) with row ids, in
accumulate mode: each held row's sum is added to the base once, rows without
a slot are not touched, and nothing is zero-filled or added atomically.  The
CUDA source, ``gnntf_tpu_torch/csrc/ell_gather.cu``, states its bound.

:func:`ell_gather_list` is the kernel's wrapper over a list built once (what
``PreparedSpMM`` calls); :func:`ell_gather` and :func:`ell_gather_plain`
take the ELL grid and derive the list per call.  A CPU tensor takes the
plain version, ``blocked_spmm_plain`` over the list, which sums in the
kernel's order; a CUDA tensor launches the kernel or raises.

The prepared operator's route on the card (``ops/spmm.py::PreparedSpMM``
under ``auto``) has no hub slice: :func:`ell_gather_scaled` walks every
live slot of the hub-free ELL, as :func:`whole_list` (K1's list with
``ptr`` over all N rows), in store mode, and finishes a normalized graph's
product in its store: ``out[r] = rs[r] * sum_e val[e] * (cs[c] * x[c]) + w
* x[r]``, the JAX package's order, each product and sum rounded apart
(``csrc/scaled_walk.cuh``, a design of its own for the whole list's short
rows, which also finishes split rows inside its launch with the list's
counters).  Its plain version applies the same scales in the same order
around ``blocked_spmm_plain``.  The operator's backward ``dx = cs *
(A^T (rs * dy)) + w * dy`` is one launch of the same walk over the
transposed list, the scales swapped (:func:`ell_gather_scaled_backward`,
counted in its own ``launches`` and in ``ell_gather.backward_launches``).

The transposed list (:func:`ell_transposed_list`: K1's live slots
stable-sorted by source, ``ptr`` over the sources, each slot's output row
as its ``idx`` and its place in K1's list as its ``eid``) also carries
``hybrid``'s backward ``dx = A_rest^T dy``, in the walk's store mode,
through K2's entry point, which takes such a list as it is
(:func:`ell_gather_transposed`, counted in its own ``launches`` and in
``ell_gather.backward_launches`` as well).

Two more walks carry the training step's edge dropout
(``ops/stochastic.py::TrainGrids``), over a list of every edge with ``ptr``
over all N rows, in store mode.  :func:`ell_gather_masked`
(``csrc/drop_walk.cuh``: a warp stages a tile of the list, its kept edges
in shared memory, then sums them) weights each edge by its dropped value,
hashed in the kernel from its id and the draw (the salt pair read from
device memory, so a launch captured in a CUDA graph takes each replay's
draw), and gathers only the kept edges' ``x`` rows unless ``x`` holds an
inf or a NaN (then a second pass gathers every edge's, as JAX's product
multiplies them); its lists carry tiles (``EdgeList.build(tile_items=)``).
:func:`ell_degree_masked` sums those weights a row, with no ``x``, as one
segmented sum over equal shares of the list's edges
(``csrc/degree_walk.cuh``: a block takes ``blocked.DEGREE_SHARE`` edges,
a lane ``blocked.DEGREE_EDGES`` of them; a row's lanes' sums are folded in
lane order, its blocks' sums in block order by a second kernel), streaming
the values in list order (:func:`list_values`, a copy made once a list).
The plain versions take the draw's per-edge values
(``stochastic.drawn_values``, which equal the kernels' weights bit for
bit) and sum them in the kernels' orders.  Both walks take the base values
in float32 or in bfloat16 (the grids of ``GNNTF_GRID_VALUE_DTYPE=bfloat16``,
``stochastic.grid_value_dtype``), each through an entry point of its own;
a bfloat16 value is widened exactly and weighted in float32, so the
weights are those of the float32 walk over the rounded values.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..utils import kernels
from . import blocked
from .blocked import EdgeList, blocked_spmm_plain

# items (live slots and row ends) per unit of the walk's work: the list is a
# quarter of K2's, so its units are smaller than K2's to fill the card (32
# is the fastest of 32, 64 and 128 at F=40 in k2_sweep.py)
_UNIT_ITEMS = 32
# the scaled walk's whole list (every live slot, ptr over all N rows)
# (k2_sweep.py --kernels k1)
_WHOLE_ITEMS = 64
# the dropout walks' lists (ops/stochastic.py::TrainGrids.lists): a split
# row's pieces of at most _DROP_ITEMS edges, tiles of about _TILE_ITEMS
# items (k2_sweep.py --kernels train)
_DROP_ITEMS = 128
_TILE_ITEMS = 256


def ell_list(idx: np.ndarray, vrow_row: np.ndarray, n_nodes: int):
    """K1's list from an ELL grid (host, numpy): the live slots (``idx <
    n_nodes``) in grid order, stably sorted by their row, over the rows that
    hold one.  Returns int32 ``rows`` (R,) ascending, ``ptr`` (R+1,) and
    ``src`` (E,), and int64 ``slot`` (E,), each live slot's flat position in
    the (V*k) grid, so a slot's value is ``vals.reshape(-1)[slot]``."""
    idx = np.asarray(idx)
    flat = idx.reshape(-1)
    slot = np.flatnonzero(flat < n_nodes)
    row = np.asarray(vrow_row, np.int64)[slot // max(1, idx.shape[1])]
    order = np.argsort(row, kind="stable")
    slot, row = slot[order], row[order]
    rows, count = np.unique(row, return_counts=True)
    ptr = np.concatenate([[0], np.cumsum(count)])
    return (rows.astype(np.int32), ptr.astype(np.int32),
            flat[slot].astype(np.int32), slot)


def ell_edge_list(idx: np.ndarray, vrow_row: np.ndarray, n_nodes: int,
                  device):
    """K1's :func:`ell_list` on ``device`` as an :class:`EdgeList` with row
    ids, cut into units of ``_UNIT_ITEMS`` items; returns it and ``slot``."""
    rows, ptr, src, slot = ell_list(idx, vrow_row, n_nodes)
    return EdgeList.build(ptr, src, None, device, rows=rows,
                          items=_UNIT_ITEMS), slot


def whole_list(rows, ptr, src, n_rows: int, device,
               items: int = _WHOLE_ITEMS) -> EdgeList:
    """K1's list (:func:`ell_list`'s ``rows``, ``ptr``, ``src``) over all
    ``n_rows`` rows on ``device``: the same slots in the same order, ``ptr``
    over every row (a row without a slot is empty), no row ids, for the
    scaled walk's store mode; cut into units of ``items`` items."""
    dst = np.repeat(np.asarray(rows, np.int64), np.diff(ptr))
    return EdgeList.build(blocked.row_ptr(dst, n_rows), src, None, device,
                          items=items)


def _grid_list(idx, vals, vrow_row, n_nodes, device):
    lst, slot = ell_edge_list(idx.cpu().numpy(), vrow_row.cpu().numpy(),
                              n_nodes, device)
    val = vals.reshape(-1)[torch.from_numpy(slot).to(vals.device)]
    return lst, val.contiguous()


def _check_grid(idx, vals, x, vrow_row, n_nodes, out):
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be (V, k) int32, got {tuple(idx.shape)} "
                        f"{idx.dtype}")
    if vals.shape != idx.shape or vals.dtype != torch.float32:
        raise TypeError(f"vals must be {tuple(idx.shape)} float32, got "
                        f"{tuple(vals.shape)} {vals.dtype}")
    if x.dim() != 2 or x.shape[0] != n_nodes or x.dtype != torch.float32:
        raise TypeError(f"x must be ({n_nodes}, F) float32, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if vrow_row.shape != idx.shape[:1] or vrow_row.dtype != torch.int32:
        raise TypeError(f"vrow_row must be ({idx.shape[0]},) int32, got "
                        f"{tuple(vrow_row.shape)} {vrow_row.dtype}")
    if out is not None and out.shape != x.shape:
        raise TypeError(f"out must be {tuple(x.shape)}, got "
                        f"{tuple(out.shape)}")
    tensors = [idx, vals, x, vrow_row] + ([] if out is None else [out])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ell_gather inputs span devices {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ell_gather inputs must be contiguous")


def ell_gather_plain(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                     vrow_row: torch.Tensor, n_nodes: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`ell_gather`: the list derived from the
    grid, then ``blocked_spmm_plain`` in the kernel's order, adding into
    ``out`` (zeros when None) in place."""
    _check_grid(idx, vals, x, vrow_row, n_nodes, out)
    lst, val = _grid_list(idx, vals, vrow_row, n_nodes, x.device)
    if out is None:
        out = torch.zeros_like(x)
    return blocked_spmm_plain(lst, val, x, out)


def ell_gather(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
               vrow_row: torch.Tensor, n_nodes: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out + combine(vrow_row, sum_j vals * x[idx])`` as an (n_nodes, F)
    float32 tensor, added into ``out`` in place (zeros when None);
    ``idx == n_nodes`` marks a pad slot.  The list is derived from the grid
    on the host at every call; hold an :func:`ell_edge_list` and call
    :func:`ell_gather_list` to reuse it.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``ell_gather.launches``)."""
    _check_grid(idx, vals, x, vrow_row, n_nodes, out)
    lst, val = _grid_list(idx, vals, vrow_row, n_nodes, x.device)
    if out is None:
        out = torch.zeros_like(x)
    return ell_gather_list(lst, val, x, out)


def ell_gather_list(lst: EdgeList, val: torch.Tensor, x: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """Add K1's product over ``lst`` (an :class:`EdgeList` with row ids,
    ``val`` one value a live slot) into ``out`` in place and return it:
    ``out[rows[r]] += sum_e val[e] * x[idx[e]]`` over row r's slots.

    CPU tensors take ``blocked_spmm_plain``; CUDA tensors launch the kernel
    (counted in ``ell_gather.launches``)."""
    if lst.rows is None:
        raise ValueError("K1's list holds row ids (ell_list)")
    blocked.check("ell_gather", lst, val, x, out)
    if x.device.type == "cpu":
        return blocked_spmm_plain(lst, val, x, out)
    if x.device.type != "cuda":
        raise ValueError(f"ell_gather runs on cpu or cuda, not {x.device}")
    if lst.n_units == 0 or x.shape[1] == 0:
        return out
    blocked.launch(_library(), "gnntf_ell_gather", lst, val, x, out)
    ell_gather.launches += 1
    return out


ell_gather.launches = 0
ell_gather.backward_launches = 0


def _check_scales(lst, x, rs, cs):
    for name, v in (("rs", rs), ("cs", cs)):
        if v is None:
            continue
        if (v.shape != (lst.n_rows,) or v.dtype != torch.float32
                or v.device != x.device or not v.is_contiguous()):
            raise TypeError(f"ell_gather_scaled: {name} must be a contiguous "
                            f"({lst.n_rows},) float32 tensor on {x.device}, "
                            f"got {tuple(v.shape)} {v.dtype} on {v.device}")


def ell_gather_scaled_plain(lst: EdgeList, val: torch.Tensor,
                            x: torch.Tensor, rs=None, cs=None,
                            w: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`ell_gather_scaled`: ``cs * x``, the
    store-mode sum in the kernel's order (``blocked_spmm_plain``), then
    ``rs *`` it and ``+ w * x``, each a rounded pass of its own, as the
    kernel rounds them."""
    xin = x if cs is None else x * cs[:, None]
    out = blocked_spmm_plain(lst, val, xin)
    if rs is not None:
        out = out * rs[:, None]
    if w != 0.0:
        out = out + w * x
    return out


def _scaled(what, entry, lst, val, x, rs, cs, w):
    """The scaled walk over ``lst`` through the C ``entry`` and whether it
    launched: the plain version on the CPU; on a card one launch, or none
    where there is nothing to walk (the output unwritten)."""
    if lst.rows is not None:
        raise ValueError(f"{what} stores row r at r (whole_list, "
                         "ell_transposed_list)")
    blocked.check(what, lst, val, x)
    _check_scales(lst, x, rs, cs)
    if x.device.type == "cpu":
        return ell_gather_scaled_plain(lst, val, x, rs, cs, w), False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    out = torch.empty(lst.n_rows, x.shape[1], dtype=torch.float32,
                      device=x.device)
    if lst.n_units == 0 or x.shape[1] == 0:
        return out, False
    address = lambda t: None if t is None else t.data_ptr()
    blocked.launch(_library(), entry, lst, val, x, out,
                   extra=(address(rs), address(cs), float(w)), counted=True)
    return out, True


def ell_gather_scaled(lst: EdgeList, val: torch.Tensor, x: torch.Tensor,
                      rs: Optional[torch.Tensor] = None,
                      cs: Optional[torch.Tensor] = None,
                      w: float = 0.0) -> torch.Tensor:
    """The normalized product ``rs ⊙ (A @ (cs ⊙ x)) + w·x`` over
    :func:`whole_list` ``lst`` (every row stored; ``val`` one value a live
    slot) as an (N, F) float32 tensor; ``rs``/``cs`` (N,) float32 or None (a
    scale of one), ``w`` the identity's weight.

    CPU tensors take :func:`ell_gather_scaled_plain`; CUDA tensors launch
    the scaled walk, the scales and identity applied in its gathers and
    its store (counted in ``ell_gather_scaled.launches``).  The walk counts
    its split rows' pieces in a set of the list's counters
    (``EdgeList.counters``) that no launch running at the same time
    shares: each CUDA stream, and each graph capture, takes its own."""
    out, launched = _scaled("ell_gather_scaled", "gnntf_ell_gather_scaled",
                            lst, val, x, rs, cs, w)
    ell_gather_scaled.launches += launched
    return out


ell_gather_scaled.launches = 0


def ell_gather_scaled_backward_plain(lst_t: EdgeList, val: torch.Tensor,
                                     dy: torch.Tensor, rs=None, cs=None,
                                     w: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`ell_gather_scaled_backward`: ``rs *
    dy``, the transposed sum in the walk's order (``blocked_spmm_plain``),
    ``cs *`` it, ``+ w * dy``, each a rounded pass of its own: the scaled
    walk's plain version with the scales swapped."""
    return ell_gather_scaled_plain(lst_t, val, dy, cs, rs, w)


def ell_gather_scaled_backward(lst_t: EdgeList, val: torch.Tensor,
                               dy: torch.Tensor,
                               rs: Optional[torch.Tensor] = None,
                               cs: Optional[torch.Tensor] = None,
                               w: float = 0.0) -> torch.Tensor:
    """The backward of :func:`ell_gather_scaled`, ``dx = cs ⊙ (A^T (rs ⊙
    dy)) + w·dy``, over the transposed list ``lst_t``
    (:func:`ell_transposed_list` of its whole list; ``val`` the whole
    list's values, read through ``eid``) as an (N, F) float32 tensor, with
    the forward's ``rs``, ``cs`` and ``w``.

    CPU tensors take :func:`ell_gather_scaled_backward_plain`; CUDA tensors
    launch the scaled walk once (kernel ``ell_gather_scaled_bwd_walk``), rs
    gathered and cs stored (counted in ``ell_gather_scaled_backward.launches``
    and, with hybrid's backward walk, in ``ell_gather.backward_launches``)."""
    out, launched = _scaled("ell_gather_scaled_backward",
                            "gnntf_ell_gather_scaled_t", lst_t, val, dy, cs,
                            rs, w)
    ell_gather_scaled_backward.launches += launched
    ell_gather.backward_launches += launched
    return out


ell_gather_scaled_backward.launches = 0


def pair_lists(dst, src, eid, n_out: int, n_in: int, device,
               n_ids: Optional[int] = None):
    """The lists of the edges ``src -> dst`` (numpy) on ``device``, for the
    store-mode and the masked walks (units of ``_DROP_ITEMS`` items, tiles
    of ``_TILE_ITEMS``): the forward list, one stable sort of the edges by
    (dst, src), ``ptr`` over ``n_out`` rows and ``idx`` the sources; the
    transposed list, one stable sort by (src, dst), ``ptr`` over ``n_in``
    rows and ``idx`` the destinations.  Each edge keeps its id ``eid``
    (None: its position), through which the walks read the values
    (``n_ids`` of them; None: one an edge) and hash the dropout mask."""
    dst = np.asarray(dst, np.int64)
    src = np.asarray(src, np.int64)
    eid = np.arange(len(dst)) if eid is None else np.asarray(eid, np.int64)

    def one(r, c, n_r, n_c):
        order = np.lexsort((c, r))
        return EdgeList.build(blocked.row_ptr(r[order], n_r), c[order],
                              eid[order], device, items=_DROP_ITEMS,
                              tile_items=_TILE_ITEMS,
                              n_x=n_c, n_ids=n_ids)

    return one(dst, src, n_out, n_in), one(src, dst, n_in, n_out)


def ell_transposed_list(lst: EdgeList, n_in: int) -> EdgeList:
    """The transposed list of K1's list ``lst`` on its device: its live
    slots stable-sorted by source (so by (source, output row, slot), as
    ``TrainGrids`` and ``edge_lists`` sort), ``ptr`` over the ``n_in``
    sources, ``idx`` each slot's output row and ``eid`` its place in
    ``lst`` (values are read through it), in units of ``_UNIT_ITEMS``
    items.  Built on the host from the device list."""
    ptr = lst.ptr.cpu().numpy()
    src = lst.idx.cpu().numpy()
    rows = (np.arange(lst.n_rows) if lst.rows is None
            else lst.rows.cpu().numpy())
    dst = np.repeat(rows, np.diff(ptr))
    order = np.argsort(src, kind="stable")
    return EdgeList.build(blocked.row_ptr(src[order], n_in), dst[order],
                          order, lst.device, items=_UNIT_ITEMS)


def ell_gather_transposed(lst_t: EdgeList, val: torch.Tensor,
                          dy: torch.Tensor) -> torch.Tensor:
    """K1's transposed product, the backward's ``dx = A_rest^T dy``, as an
    (n_in, F) float32 tensor: ``dx[s] = sum_e val[eid[e]] * dy[idx[e]]``
    over source s's slots of :func:`ell_transposed_list`, ``val`` K1's list
    values.  ``dy`` has as many rows as ``dx``.

    CPU tensors take ``blocked_spmm_plain``; CUDA tensors launch the walk in
    store mode, K2's entry point (counted in
    ``ell_gather_transposed.launches`` and ``ell_gather.backward_launches``,
    not in ``blocked_spmm.launches``)."""
    if lst_t.rows is not None:
        raise ValueError("the transposed list stores row r at r "
                         "(ell_transposed_list)")
    blocked.check("ell_gather_transposed", lst_t, val, dy)
    if dy.device.type == "cpu":
        return blocked_spmm_plain(lst_t, val, dy)
    if dy.device.type != "cuda":
        raise ValueError(f"ell_gather_transposed runs on cpu or cuda, not "
                         f"{dy.device}")
    out = torch.empty(lst_t.n_rows, dy.shape[1], dtype=torch.float32,
                      device=dy.device)
    if lst_t.n_units == 0 or dy.shape[1] == 0:
        return out
    blocked.launch(blocked._library(), "gnntf_blocked_spmm", lst_t, val, dy,
                   out)
    ell_gather_transposed.launches += 1
    ell_gather.backward_launches += 1
    return out


ell_gather_transposed.launches = 0


# the base values' dtypes that the dropout walks take, and the suffix of
# each one's entry points
_DROP_VALUES = {torch.float32: "", torch.bfloat16: "_bf16"}


def _check_masked(what, lst, val, tiles=True):
    """Raise unless a dropout walk (``tiles``: the masked walk, whose list
    carries tiles) can take this list and these values."""
    if lst.rows is not None:
        raise ValueError(f"{what} stores row r at r; a list with row ids is "
                         "K1's (ell_list)")
    if tiles and lst.tile_seg is None:
        raise ValueError(f"{what} walks a list built with tiles "
                         "(EdgeList.build(tile_items=...))")
    if val.shape != (lst.n_values,) or val.dtype not in _DROP_VALUES:
        raise TypeError(f"{what}: values must be ({lst.n_values},) float32 "
                        f"or bfloat16, one an edge id, got "
                        f"{tuple(val.shape)} {val.dtype}")
    if val.device != lst.device:
        raise ValueError(f"{what} inputs span devices {val.device} and "
                         f"{lst.device}")
    if not val.is_contiguous():
        raise ValueError(f"{what} values must be contiguous")


def ell_gather_masked_plain(lst: EdgeList, val: torch.Tensor, salt,
                            keep: float, n_drop: int, x: torch.Tensor,
                            id_base: int = 0) -> torch.Tensor:
    """The plain version of :func:`ell_gather_masked`:
    ``blocked_spmm_plain`` over the draw's per-edge values, in the kernel's
    order (a dropped edge's ``+0 * x`` included, so an inf or a NaN there
    gives NaN, as in JAX's product)."""
    from .stochastic import drawn_values
    return blocked_spmm_plain(
        lst, drawn_values(val, salt, keep, n_drop, id_base), x)


def ell_gather_masked(lst: EdgeList, val: torch.Tensor, salt, keep: float,
                      n_drop: int, x: torch.Tensor,
                      id_base: int = 0) -> torch.Tensor:
    """The product of the dropped graph's list with ``x`` as an (N, F)
    float32 tensor: ``out[r] = sum_e w(eid[e]) * x[idx[e]]`` over row r's
    edges, where ``w(e)`` is edge e's dropped value under the draw (``salt``,
    ``keep``, ``n_drop``; ``stochastic.dropped_values``) and ``val`` holds
    the graph's base values, one an edge id.  The mask is hashed at the
    global id ``id_base + eid[e]`` (a rank's slice of a larger edge list),
    the value read at ``eid[e]``.

    CPU tensors take :func:`ell_gather_masked_plain`; CUDA tensors launch
    the masked walk, which hashes the mask in the kernel and gathers only
    the kept edges' rows of ``x``, unless ``x`` holds an inf or a NaN
    (counted in ``ell_gather_masked.launches``, or ``.bf16_launches`` over
    bfloat16 values: one a call, of its two passes)."""
    _check_masked("ell_gather_masked", lst, val)
    blocked.check("ell_gather_masked", lst, val, x, values=_DROP_VALUES)
    if x.device.type == "cpu":
        return ell_gather_masked_plain(lst, val, salt, keep, n_drop, x,
                                       id_base)
    if x.device.type != "cuda":
        raise ValueError(f"ell_gather_masked runs on cpu or cuda, not "
                         f"{x.device}")
    out = torch.empty(lst.n_rows, x.shape[1], dtype=torch.float32,
                      device=x.device)
    if lst.n_units == 0 or x.shape[1] == 0:
        return out
    flag = torch.empty(1, dtype=torch.int32, device=x.device)
    _launch_drop("gnntf_ell_gather_masked", lst, val, x, out, salt, keep,
                 n_drop, id_base, flag)
    if val.dtype == torch.float32:
        ell_gather_masked.launches += 1
    else:
        ell_gather_masked.bf16_launches += 1
    return out


# launches over float32 values, and over bfloat16 ones
ell_gather_masked.launches = 0
ell_gather_masked.bf16_launches = 0


def share_sums(ptr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each list row's sum of ``w`` (float32, one a list item, in list
    order) in the degree walk's order (``csrc/degree_walk.cuh``): a lane
    sums its run of each row in list order (lanes take
    ``blocked.DEGREE_EDGES`` consecutive items each); a row's runs in one
    block (``blocked.DEGREE_SHARE`` items) are folded in lane order, and a
    row's blocks' sums in block order (``blocked.share_row_sums`` at width
    one, in one range).  Empty rows are +0."""
    return blocked.share_row_sums(ptr, w[:, None], blocked.DEGREE_EDGES,
                                  blocked.DEGREE_SHARE, None)[:, 0]


def ell_degree_masked_plain(lst: EdgeList, val: torch.Tensor, salt,
                            keep: float, n_drop: int,
                            id_base: int = 0) -> torch.Tensor:
    """The plain version of :func:`ell_degree_masked`: the draw's per-edge
    values (``stochastic.drawn_values``, the kernel's weights bit for bit)
    in list order, summed in the walk's order (:func:`share_sums`)."""
    from .stochastic import drawn_values
    w = drawn_values(val, salt, keep, n_drop, id_base)
    if lst.eid is not None:
        w = w[lst.eid.long()]
    return share_sums(lst.ptr, w)


def list_values(lst: EdgeList, val: torch.Tensor) -> torch.Tensor:
    """``val`` (one an edge id) in ``lst``'s order, ``val[eid]``: the copy
    that the degree walk streams beside ``eid``, made once for the list and
    these values (kept in ``lst.memo``, keyed on the values' address,
    version, dtype and shape, with the values held so the address stays
    theirs); ``val`` itself where ``eid`` is the identity."""
    if lst.eid is None:
        return val
    key = (val.data_ptr(), val._version, val.dtype, val.shape, val.device)
    held = lst.memo.get("values")
    if held is None or held[0] != key:
        held = lst.memo["values"] = (key, val[lst.eid.long()].contiguous(),
                                     _Held(val))
    return held[1]


class _Held:
    """A reference that ``utils.idcache.sizeof`` does not count (the base
    values belong to the graph, not to the list)."""

    def __init__(self, obj):
        self.obj = obj


def ell_degree_masked(lst: EdgeList, val: torch.Tensor, salt, keep: float,
                      n_drop: int, id_base: int = 0) -> torch.Tensor:
    """Each list row's sum of its edges' dropped values as an (N,) float32
    tensor: over the column list the dropped graph's column sums, over the
    row list its row sums (``id_base`` as in :func:`ell_gather_masked`).

    CPU tensors take :func:`ell_degree_masked_plain`; CUDA tensors launch
    the degree walk (``csrc/degree_walk.cuh``: equal shares of the list's
    edges, the values streamed in list order from :func:`list_values`),
    then its fold kernel where a row crosses a block's share
    (``lst.share_folds``), counted in ``ell_degree_masked.launches``, or
    ``.bf16_launches`` over bfloat16 values.  The scratch of the blocks'
    sums is allocated for each call."""
    _check_masked("ell_degree_masked", lst, val, tiles=False)
    if val.device.type == "cpu":
        return ell_degree_masked_plain(lst, val, salt, keep, n_drop,
                                       id_base)
    if val.device.type != "cuda":
        raise ValueError(f"ell_degree_masked runs on cpu or cuda, not "
                         f"{val.device}")
    out = torch.empty(lst.n_rows, dtype=torch.float32, device=val.device)
    if lst.n_rows == 0:
        return out
    from .stochastic import device_salt
    args, _scratch = degree_args(lst, list_values(lst, val), out,
                                 device_salt(salt, val.device), keep, n_drop,
                                 id_base)
    entry = getattr(_library(), "gnntf_ell_degree" + _DROP_VALUES[val.dtype])
    rc = blocked.on_device(out.device, lambda: entry(
        *args, torch.cuda.current_stream(out.device).cuda_stream))
    kernels.check(_library(), rc, "gnntf_ell_degree launch")
    if val.dtype == torch.float32:
        ell_degree_masked.launches += 1
    else:
        ell_degree_masked.bf16_launches += 1
    return out


ell_degree_masked.launches = 0
ell_degree_masked.bf16_launches = 0


def degree_args(lst: EdgeList, ordered: torch.Tensor, out: torch.Tensor,
                salt: torch.Tensor, keep: float, n_drop: int,
                id_base: int = 0) -> tuple:
    """The degree walk's C arguments but the stream, and the scratch tensor
    they point into (to be kept until the launch): the list's ``ptr`` and
    ``eid``, the values in list order, ``out``, the blocks' scratch (their
    sums of the rows coming in and going on, and the row coming in: one
    each a block), the counts, the walk's lanes and edges a lane, whether
    a row crosses a block's share, then the draw (the salt pair's device
    address and ``stochastic.draw_scalars``)."""
    from .stochastic import draw_scalars
    blocks = max(1, -(-lst.n_edges // blocked.DEGREE_SHARE))
    scratch = torch.empty(3, blocks, dtype=torch.int32, device=out.device)
    at = scratch.data_ptr()
    return (lst.ptr.data_ptr(),
            None if lst.eid is None else lst.eid.data_ptr(),
            ordered.data_ptr(), out.data_ptr(), at, at + 4 * blocks,
            at + 8 * blocks, lst.n_rows, lst.n_edges, blocks,
            blocked.DEGREE_LANES, blocked.DEGREE_EDGES,
            int(lst.share_folds > 0), salt.data_ptr(),
            *draw_scalars(keep, n_drop, id_base)), scratch


def drop_args(lst, salt, keep, n_drop, flag, x, id_base=0) -> tuple:
    """The masked walk's arguments after the list's: the tiles, the draw
    (the salt pair's device address, then ``stochastic.draw_scalars``), the
    address of its flag (one int32 of scratch, zeroed by the launch) and
    ``x``'s size in floats."""
    from .stochastic import draw_scalars
    return (*lst.tile_addresses, salt.data_ptr(),
            *draw_scalars(keep, n_drop, id_base), flag.data_ptr(),
            x.numel())


def _launch_drop(entry, lst, val, x, out, salt, keep, n_drop, id_base,
                 flag):
    """The masked walk's launch, through ``entry`` or its bfloat16 values'
    twin (``entry + "_bf16"``): the kernel reads the salt pair from device
    memory (:func:`stochastic.device_salt`; a host salt is uploaded first),
    the rest of the draw as kernel scalars."""
    from .stochastic import device_salt
    salt = device_salt(salt, out.device)
    blocked.launch(_library(), entry + _DROP_VALUES[val.dtype], lst, val, x,
                   out,
                   extra=drop_args(lst, salt, keep, n_drop, flag, x,
                                   id_base))


# the degree walk's C signature (gnntf_ell_degree and its bfloat16 twin):
# ptr, eid, val, out, carry_in, carry_out, col_in; n_rows, n_edges,
# n_blocks, lanes, edges, folds; salt, thresh, n_drop, id_base, scale;
# stream
DEGREE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
    ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _library():
    """The built kernel library with its C signatures declared (built on
    first use, never at import)."""
    lib = kernels.load("ell_gather")
    declare(lib)
    return lib


def declare(lib) -> None:
    """Declare the C signatures of K1's library (the built one, or one
    built with other settings)."""
    blocked.declare(lib.gnntf_ell_gather)
    blocked.declare(lib.gnntf_ell_gather_scaled, scaled=True)
    blocked.declare(lib.gnntf_ell_gather_scaled_t, scaled=True)
    for suffix in _DROP_VALUES.values():
        blocked.declare(getattr(lib, "gnntf_ell_gather_masked" + suffix),
                        drop=True)
        degree = getattr(lib, "gnntf_ell_degree" + suffix)
        degree.restype = ctypes.c_int
        degree.argtypes = DEGREE_ARGTYPES
    lib.gnntf_stream_capture.restype = ctypes.c_int
    lib.gnntf_stream_capture.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_ulonglong)]
