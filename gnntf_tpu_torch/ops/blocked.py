"""K2, the blocked-COO SpMM, and its layout.

``block_coo`` re-blocks an edge list into chunks of ``block_edges`` slots
whose edges all fall inside one (row-window, col-tile) block of the
adjacency: rows of a chunk lie in ``[w*W, (w+1)*W)``, columns in
``[t*T, (t+1)*T)``.  Chunks are window-major; every window without edges
gets one all-padding chunk.  The layout is numpy, a copy of the JAX
package's ``ops/pallas/format.py`` so every field is bit-equal.  It pays off
on reordered or clustered graphs (``graph/reorder.py::rcm_order``), where
edges fill their chunks.

:class:`BlockedSpMM` is one layout on a device, with the kernel's work
partition derived from it on the host: the live slots (a prefix of each
chunk, ``chunk_len`` of them) window by window and by row inside a window,
cut into runs of ``_RUN`` live edges and, inside a run, into segments of
one window.

``blocked_spmm`` is the kernel's wrapper.  It replaces the TPU kernel
``gnntf_tpu/ops/pallas/spmm.py::_kernel``; the CUDA source,
``gnntf_tpu_torch/csrc/blocked_spmm.cu``, states its bound and design.  A CPU
tensor takes :func:`blocked_spmm_plain`; a CUDA tensor launches the kernel
or raises.  ``spmm_pallas`` is the differentiable SpMM over it: the forward
runs the kernel, the backward is the JAX package's ``_pallas_vjp_fn`` in
plain torch (the TPU kernel has no backward kernel either).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from collections import OrderedDict

import numpy as np
import torch

from ..graph.coo import Graph
from ..utils import kernels

# live edges per block of the kernel
_RUN = 2048
# largest shared-memory window a block accumulates into; wider features are
# tiled over a second grid dimension
_WINDOW_BYTES = 128 * 1024


@dataclasses.dataclass(frozen=True)
class BlockedCOO:
    """Edge structure re-blocked for K2.  ``rows``/``cols`` are relative to
    their window/tile base, flat over ``n_chunks * block_edges`` slots;
    ``perm[e]`` is the flat slot of original edge ``e``, so live values are
    scattered into the slot grid per call (:func:`scatter_values`)."""

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


def work_partition(layout: BlockedCOO, run: int):
    """The kernel's work partition: ``(live_slots, seg_begin, seg_window,
    run_seg)``, all int32.  ``live_slots`` lists the live slots window by
    window, by destination row inside a window; it is cut into runs of
    ``run`` live edges, and each run where the window changes into segments:
    segment ``k`` holds ``live_slots[seg_begin[k]:seg_begin[k + 1]]``, all
    in window ``seg_window[k]``, and run ``r`` owns segments ``run_seg[r]``
    to ``run_seg[r + 1]``."""
    slots = layout.perm.astype(np.int64)
    win = layout.chunk_window[slots // layout.block_edges]
    live = slots[np.lexsort((slots, layout.rows[slots], win))]
    window = layout.chunk_window[live // layout.block_edges]
    cut = np.zeros(len(live), bool)
    cut[::run] = True
    cut[1:] |= window[1:] != window[:-1]
    first = np.flatnonzero(cut)
    seg_begin = np.append(first, len(live))
    run_seg = np.append(np.searchsorted(first, np.arange(0, len(live), run)),
                        len(first))
    return tuple(a.astype(np.int32) for a in
                 (live, seg_begin, window[first], run_seg))


class BlockedSpMM:
    """One :class:`BlockedCOO` layout on a device, with the kernel's work
    partition (:func:`work_partition`) in runs of ``_RUN`` live edges."""

    def __init__(self, layout: BlockedCOO, device):
        self.layout = layout

        def put(a, dtype=np.int32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        live, seg_begin, seg_window, run_seg = work_partition(layout, _RUN)
        self.rows = put(layout.rows)
        self.cols = put(layout.cols)
        self.chunk_window = put(layout.chunk_window)
        self.chunk_tile = put(layout.chunk_tile)
        self.live_slots = put(live)
        self.seg_begin = put(seg_begin)
        self.seg_window = put(seg_window)
        self.run_seg = put(run_seg)
        self.perm = put(layout.perm, np.int64)

    @property
    def n_runs(self) -> int:
        return int(self.run_seg.shape[0]) - 1

    @property
    def n_slots(self) -> int:
        return int(self.rows.shape[0])


def scatter_values(prep: BlockedSpMM, val: torch.Tensor) -> torch.Tensor:
    """Live edge values into the (C*BE,) float32 slot grid at ``perm``,
    zeros in the padding slots."""
    flat = torch.zeros(prep.n_slots, dtype=torch.float32, device=val.device)
    flat[prep.perm] = val.to(torch.float32)
    return flat


def blocked_spmm_plain(prep: BlockedSpMM, slot_vals: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: walks the live slots only
    (through ``perm``), gathers their source rows and ``index_add_``s them
    into their destination rows."""
    lay = prep.layout
    slot = prep.perm
    chunk = slot // lay.block_edges
    dst = (prep.chunk_window.long()[chunk] * lay.window
           + prep.rows.long()[slot])
    src = prep.chunk_tile.long()[chunk] * lay.tile + prep.cols.long()[slot]
    out = torch.zeros(lay.n_nodes, x.shape[1], dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, dst, x[src] * slot_vals[slot][:, None])


def _check(prep, slot_vals, x):
    n = prep.layout.n_nodes
    if x.dim() != 2 or x.shape[0] != n or x.dtype != torch.float32:
        raise TypeError(f"x must be ({n}, F) float32, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if slot_vals.shape != (prep.n_slots,) or slot_vals.dtype != torch.float32:
        raise TypeError(f"slot values must be ({prep.n_slots},) float32, got "
                        f"{tuple(slot_vals.shape)} {slot_vals.dtype}")
    devices = {slot_vals.device, x.device, prep.rows.device}
    if len(devices) != 1:
        raise ValueError(f"blocked_spmm inputs span devices {devices}")
    if not (x.is_contiguous() and slot_vals.is_contiguous()):
        raise ValueError("blocked_spmm inputs must be contiguous")


def blocked_spmm(prep: BlockedSpMM, slot_vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over the layout's live slots as an (n_nodes, F) float32
    tensor.  CPU tensors take :func:`blocked_spmm_plain`; CUDA tensors
    launch the kernel (counted in ``blocked_spmm.launches``)."""
    _check(prep, slot_vals, x)
    if x.device.type == "cpu":
        return blocked_spmm_plain(prep, slot_vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"blocked_spmm runs on cpu or cuda, not {x.device}")
    lay = prep.layout
    f = x.shape[1]
    out = torch.zeros(lay.n_nodes, f, dtype=torch.float32, device=x.device)
    if prep.n_runs == 0 or f == 0:
        return out
    vec = 4 if f % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    tile_floats = _WINDOW_BYTES // (4 * lay.window) // vec * vec
    if tile_floats == 0:
        raise ValueError(f"window {lay.window} is too tall for one block's "
                         "shared memory")
    ftv = min(f, tile_floats) // vec
    group = 1
    while group < min(32, ftv):
        group *= 2
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gnntf_blocked_spmm(
            prep.rows.data_ptr(), prep.cols.data_ptr(), slot_vals.data_ptr(),
            prep.chunk_tile.data_ptr(), prep.live_slots.data_ptr(),
            prep.seg_begin.data_ptr(), prep.seg_window.data_ptr(),
            prep.run_seg.data_ptr(), x.data_ptr(), out.data_ptr(),
            prep.n_runs, lay.n_nodes, lay.window, lay.tile, lay.block_edges,
            f, ftv, vec, group, stream)
    kernels.check(lib, rc, "blocked_spmm launch")
    blocked_spmm.launches += 1
    return out


blocked_spmm.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared (built on
    first use, never at import)."""
    lib = kernels.load("blocked_spmm")
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.gnntf_blocked_spmm.restype = i
    lib.gnntf_blocked_spmm.argtypes = [p] * 10 + [i] * 9 + [p]
    return lib


class _BlockedSpMMFn(torch.autograd.Function):
    """``(val, x) -> A @ x`` through K2.  The backward is the JAX package's
    ``_pallas_vjp_fn.f_bwd``: ``dx = A^T @ dy`` with ``index_add_`` and, only
    when the values need it, ``dval[e] = <dy[row[e]], x[col[e]]>``."""

    @staticmethod
    def forward(ctx, val, x, prep, row, col):
        out = blocked_spmm(prep, scatter_values(prep, val), x.contiguous())
        ctx.save_for_backward(val, x if ctx.needs_input_grad[0] else None,
                              row, col)
        return out

    @staticmethod
    def backward(ctx, dy):
        val, x, row, col = ctx.saved_tensors
        gathered = dy[row]
        dval = dx = None
        if ctx.needs_input_grad[1]:
            dx = torch.zeros_like(dy).index_add_(
                0, col, gathered * val[:, None].to(dy.dtype))
        if ctx.needs_input_grad[0]:
            dval = (gathered * x[col]).sum(-1).to(val.dtype)
        return dval, dx, None, None, None


# Layouts keyed on the identity of the graph's ``row`` tensor, which pins a
# reference to it so a recycled id never aliases a dead graph's layout; the
# 10 layers of a model and every step share one layout.
_BLOCK_CACHE: OrderedDict = OrderedDict()
_BLOCK_CACHE_MAX = 16


def _blocked_layout(graph: Graph, window: int, tile: int,
                    block_edges: int) -> BlockedSpMM:
    key = (id(graph.row), window, tile, block_edges, str(graph.device))
    hit = _BLOCK_CACHE.get(key)
    if hit is not None and hit[0] is graph.row:
        _BLOCK_CACHE.move_to_end(key)
        return hit[1]
    layout = block_coo(graph.row.cpu().numpy(), graph.col.cpu().numpy(),
                       graph.n_nodes, window=window, tile=tile,
                       block_edges=block_edges)
    prep = BlockedSpMM(layout, graph.device)
    _BLOCK_CACHE[key] = (graph.row, prep)
    while len(_BLOCK_CACHE) > _BLOCK_CACHE_MAX:
        _BLOCK_CACHE.popitem(last=False)
    return prep


def spmm_pallas(graph: Graph, x: torch.Tensor, *, window: int = 256,
                tile: int = 256, block_edges: int = 1024) -> torch.Tensor:
    """SpMM through K2 (the JAX package's ``spmm_impl="pallas"``).  Lazy
    scales and identity apply around it, lazy dropout is materialized
    first; the layout is built once per graph structure and the live values
    are scattered into it on every call.  Differentiable in the values and
    in ``x``."""
    if graph.scaled or graph.eye_weight != 0.0:
        from .spmm import _scaled_call
        return _scaled_call(functools.partial(
            spmm_pallas, window=window, tile=tile, block_edges=block_edges),
            graph, x)
    graph = graph.materialized_dropout()
    prep = _blocked_layout(graph, window, tile, block_edges)
    return _BlockedSpMMFn.apply(graph.val, x, prep, graph.row, graph.col)
