"""Scale-out on ``torch.distributed`` (the JAX package's
``parallel/dist.py``).

The design is SPMD: every rank of the mesh holds the features and the
batch, and computes the same loss from the same parameters, so the
parameter gradients, and after the optimizer's update the parameters, are
equal on every rank.  The edges are sharded, by an executor installed
through ``ops.spmm.spmm_executor``:

* :class:`GspmdExecutor` (``fit(mesh=, spmm=None | "gspmd")``, JAX's GSPMD
  path): each rank takes its contiguous slice of the padded edge list
  (:func:`shard_graph`, or the slice it holds alone,
  ``multihost.shard_graph_local``) and computes over it every pass that
  reads the edges, each partial all-reduced over the ``edge`` group (JAX's
  psum): the product ``A_r @ x`` over all N rows (the backward's ``dx =
  sum_r A_r^T dy`` likewise), the degrees of ``normalize_adjacency`` and
  GAT's attention chain (``ops/attention.py``'s chain over slices, its row
  statistics merged by MAX and SUM);
* ``halo.HaloExecutor`` and ``ring.RingExecutor`` (``spmm="halo"`` and
  ``"ring"``), which need the whole structure on every rank.

Each rank's product is a walk over its lists (``dropgrids.rank_walk``):
K2's store-mode walk with realized values, or K1's masked walk under a
lazy draw, hashed by global edge id.  Its degrees are K1's degree walk
over its slice's column list under a lazy draw, else K2's store-mode walk
with a column of ones; its attention is A1-A4 over its slice's lists.

Mesh axes, as in the JAX package: ``edge`` shards the edges; ``feat`` is
the feature axis.  Under gspmd (``fit(mesh=, spmm=None | "gspmd")``) each
rank of the ``feat`` group holds only its column block of every 2-D hidden
weight that JAX's GSPMD shards (:func:`param_shardings`, :func:`place_state`),
and its optimizer moments are made on that block: a layer's read gathers
the whole weight over the group (:class:`FeatShards`, through
``Network.param``), and the backward keeps this rank's columns of the
gradient, which every rank computes whole.  So only the parameters' and
the moments' memory is split, and a run equals the replicated one bit for
bit; halo and ring keep every parameter whole, as in JAX.  A hierarchical
mesh (``multihost.make_pod_mesh(hierarchical=True)``) has an ``edge_host``
axis before them.  The mesh is built inside an initialized process group
(``multihost.launch_distributed``, or the caller's ``init_process_group``).
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..graph.coo import Graph
from ..ops.spmm import _scaled_call, spmm_executor
from .collectives import GroupRef, all_gather, all_reduce, rank_of
from .dropgrids import rank_lists, rank_walk
from .partition import pad_graph

EDGE_AXIS = "edge"
FEAT_AXIS = "feat"


class Mesh:
    """A mesh of the process group's ranks, read from a
    ``torch.distributed.device_mesh.DeviceMesh``: ``shape`` maps each axis
    name to its size, :meth:`group` gives an axis's process group.

    ``flatten`` names leading axes, such as ``("edge_host", "edge")``, that
    also get one group spanning them all, its ranks in the order ``p = h *
    C + c`` (JAX's order for a collective over several axes).  Every rank
    makes every such group with ``dist.new_group``, in one order, when the
    mesh is built (``DeviceMesh._flatten`` would do it, but it is private
    and its signature differs between torch versions).

    The mesh keeps neither the ``DeviceMesh`` nor its groups, only weak
    references to them (``collectives.GroupRef``): ``torch.distributed``
    holds the groups, and ``multihost.shutdown_distributed`` frees them all
    while the interpreter is live, whatever meshes are still referenced."""

    def __init__(self, device_mesh, flatten: Optional[tuple] = None):
        names = tuple(device_mesh.mesh_dim_names)
        self._shape = dict(zip(names, device_mesh.shape))
        self.device_type = device_mesh.device_type
        self._groups = {name: GroupRef(device_mesh.get_group(name))
                        for name in names}
        if flatten is not None:
            ranks = device_mesh.mesh.reshape(
                int(np.prod(device_mesh.shape[:len(flatten)])), -1)
            me = dist.get_rank()
            for column in ranks.T.tolist():
                group = dist.new_group(column)
                if me in column:
                    self._groups[tuple(flatten)] = GroupRef(group)

    @property
    def shape(self) -> dict:
        return dict(self._shape)

    def group(self, axis):
        """The process group of ``axis``, or of the axes in a tuple given to
        ``flatten``."""
        return self._groups[axis]()

    @property
    def device(self) -> torch.device:
        """The device of this rank's tensors: its card under NCCL, else the
        CPU."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)


def make_mesh(n_edge: Optional[int] = None, n_feat: int = 1) -> Mesh:
    """An (edge, feat) mesh over the ranks of the initialized process group,
    on the cards under NCCL, else on the CPU; raises ``ValueError`` when
    ``n_edge * n_feat`` is not the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if n_edge is None:
        n_edge = n // n_feat
    if n_edge * n_feat != n:
        raise ValueError(f"mesh {n_edge}x{n_feat} != {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device_type, (n_edge, n_feat),
                                 mesh_dim_names=(EDGE_AXIS, FEAT_AXIS)))


def graph_shardings(mesh: Mesh, graph: Graph) -> slice:
    """The slice of the edge list, padded to a multiple of the ``edge``
    axis's size, that this rank holds (JAX's ``P(EDGE_AXIS)`` on row, col
    and val); ``graph`` may be padded or not."""
    n_edge = mesh.shape[EDGE_AXIS]
    per = -(-graph.n_edges // n_edge)
    r = rank_of(mesh.group(EDGE_AXIS))
    return slice(r * per, (r + 1) * per)


def shard_graph(graph: Graph, mesh: Mesh) -> Graph:
    """This rank's contiguous slice of the edge list padded to a multiple of
    the ``edge`` axis's size (:func:`~.partition.pad_graph`)."""
    padded = pad_graph(graph, mesh.shape[EDGE_AXIS])
    part = graph_shardings(mesh, padded)
    return Graph(row=padded.row[part], col=padded.col[part],
                 val=padded.val[part], n_nodes=padded.n_nodes,
                 num_self_loop=padded.num_self_loop,
                 sorted_by_row=padded.sorted_by_row)


def param_shardings(model, mesh: Mesh) -> dict:
    """JAX's layout decision for each parameter: ``("feat",)`` where it
    column-shards a 2-D hidden weight over ``feat`` (divisible columns, more
    than one row), else ``()`` (replicated).  :func:`place_state` holds
    each rank's block of the sharded ones (:class:`FeatShards`)."""
    n_feat = mesh.shape[FEAT_AXIS]
    out = {}
    for spec in model.param_specs:
        if (len(spec.shape) == 2 and n_feat > 1
                and spec.shape[1] % n_feat == 0 and spec.shape[1] >= n_feat
                and spec.shape[0] > 1):
            out[spec.name] = (FEAT_AXIS,)
        else:
            out[spec.name] = ()
    return out


def walk_or_zeros(lists, i, val, draw, x, n_out):
    """``rank_walk`` over ``lists[i]``, or zeros (``n_out`` rows) for a
    rank without edges (``lists`` None)."""
    if lists is None:
        return x.new_zeros(n_out, x.shape[1], dtype=torch.float32)
    return rank_walk(lists[i], val, draw, x)


class _PartialFn(torch.autograd.Function):
    """``x -> A_r @ x`` over this rank's forward list, ``x`` replicated; the
    backward's ``dx = sum_r A_r^T dy`` walks the transposed list and
    all-reduces over ``group``."""

    @staticmethod
    def forward(ctx, x, val, draw, lists, group):
        ctx.val, ctx.draw, ctx.lists = val, draw, lists
        ctx.group = GroupRef(group)
        return walk_or_zeros(lists, 0, val, draw, x, x.shape[0])

    @staticmethod
    def backward(ctx, dy):
        dx = walk_or_zeros(ctx.lists, 1, ctx.val, ctx.draw, dy, dy.shape[0])
        dist.all_reduce(dx, group=ctx.group())
        return dx, None, None, None, None


def check_device(mesh: Mesh, x: torch.Tensor) -> None:
    """Raise unless ``x`` lies on the mesh's kind of device: a rank's
    product never drops to the CPU or to another card."""
    if x.device.type != mesh.device.type:
        raise ValueError(f"the mesh runs on {mesh.device}, got x on "
                         f"{x.device}")


class _StructureCache:
    """Per-structure entries keyed on the identity of a graph's ``row`` and
    ``col`` with strong references kept and re-checked, bounded LRU (the
    JAX package's executor caches)."""

    _CACHE_MAX = 16

    def __init__(self):
        self._plans: OrderedDict = OrderedDict()

    def get(self, graph: Graph, build):
        key = (id(graph.row), id(graph.col), graph.n_nodes)
        hit = self._plans.get(key)
        if hit is not None and hit[0] is graph.row and hit[1] is graph.col:
            self._plans.move_to_end(key)
            return hit[2]
        value = build()
        self._plans[key] = (graph.row, graph.col, value)
        while len(self._plans) > self._CACHE_MAX:
            self._plans.popitem(last=False)
        return value


class RankSlice:
    """This rank's slice of one structure's edge list: its ``row`` and
    ``col`` (views), where it starts in the graph's own arrays (``start``:
    0 for a shard, which holds only its slice) and the global id of its
    first edge (``base``), with its lists built on first use: the product's
    (:meth:`products`), the degree walk's (:meth:`grids`) and the attention
    chain's (:meth:`attention`).  Every list reads values and ids local to
    the slice; the dropout hashes ``base`` plus them."""

    def __init__(self, row, col, start: int, base: int, n_nodes: int,
                 device):
        self.row, self.col = row, col
        self.start, self.base = start, base
        self.n_nodes, self.device = n_nodes, device
        self._lists = {}

    @property
    def n_edges(self) -> int:
        return int(self.row.shape[0])

    def values(self, graph: Graph) -> torch.Tensor:
        """The slice of ``graph``'s values (base values under a lazy draw)
        as float32."""
        return graph.val[self.start:self.start + self.n_edges].to(
            torch.float32).contiguous()

    def _memo(self, key, build):
        if key not in self._lists:
            self._lists[key] = build(self.row.cpu().numpy(),
                                     self.col.cpu().numpy())
        return self._lists[key]

    def products(self):
        """The forward and transposed lists (``dropgrids.rank_lists``), or
        None without edges."""
        return self._memo("products", lambda r, c: rank_lists(
            r, c, None, self.n_nodes, self.n_nodes, self.n_edges,
            self.device))

    def grids(self):
        """The row and column lists of the slice's training grids
        (``stochastic.TrainGrids``, as one device builds them for its
        graph), for the degree walk."""
        from ..ops.stochastic import build_train_grids
        return self._memo("grids", lambda r, c: build_train_grids(
            r, c, np.zeros(len(r), np.float32), self.n_nodes).lists(
                self.device))

    def attention(self, dedup: bool):
        """The attention chain's lists (``ops.attention.attn_lists``, per
        edge with global ids, or coalesced)."""
        from ..ops.attention import attn_lists
        return self._memo(("attention", dedup), lambda r, c: attn_lists(
            r, c, self.n_nodes, self.device, dedup=dedup,
            id_base=self.base))


class _ShardAttnFn(torch.autograd.Function):
    """``(h, s_src, s_dst) -> out``: GAT's attention over this rank's
    slice, its row statistics and partials merged over ``group``
    (``ops.attention.sharded_forward``/``sharded_backward``); the
    gradients, all-reduced, are equal on every rank."""

    @staticmethod
    def forward(ctx, h, s_src, s_dst, lists, salt, keep, slope, group):
        from ..ops.attention import pack_table, sharded_forward
        n, heads, feats = h.shape
        tab = pack_table(h.reshape(n, heads * feats), s_src)
        s_dst = s_dst.to(torch.float32).contiguous()
        reduce = _reducer(group)
        outs = sharded_forward(lists, tab, s_dst, heads, feats, slope, salt,
                               keep, reduce=reduce)
        ctx.save_for_backward(tab, s_dst, outs["rmax0"], outs["dinv"])
        ctx.lists, ctx.draw, ctx.reduce = lists, (slope, salt, keep), reduce
        ctx.shape = (n, heads, feats)
        return outs["out"].view(n, heads, feats)

    @staticmethod
    def backward(ctx, g):
        from ..ops.attention import sharded_backward
        tab, s_dst, rmax0, dinv = ctx.saved_tensors
        n, heads, feats = ctx.shape
        g = g.reshape(n, heads * feats).to(torch.float32).contiguous()
        outs = sharded_backward(ctx.lists, tab, s_dst, rmax0, dinv, g, heads,
                                feats, *ctx.draw, reduce=ctx.reduce)
        return (outs["dh"].view(n, heads, feats), outs["ds_src"],
                outs["ds_dst"], None, None, None, None, None)


def _reducer(group):
    """The chain's ``reduce`` over ``group``: this rank's one partial,
    all-reduced (MAX or SUM).  The backward keeps it, so it holds the
    group weakly."""
    ref = GroupRef(group)

    def reduce(parts, op):
        t = parts[0].contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=ref())
        return t
    return reduce


class GspmdExecutor(_StructureCache):
    """An ``ops.spmm`` executor over this rank's slice of the padded edge
    list (module docstring): the product, all-reduced over the ``edge``
    group, and, offered to ``normalize_adjacency`` and ``gat_attention``,
    the degrees and GAT's attention.  It takes the whole graph (each rank
    slices it, :func:`graph_shardings`; padding slots have value 0 and are
    left out of the lists) or an edge shard (``multihost.
    shard_graph_local``), whose arrays are the slice.  A lazily dropped
    graph arrives with its draw and is hashed by global edge id in the
    masked and degree walks."""

    supports_lazy_dropout = True

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh

    @property
    def group(self):
        return self.mesh.group(EDGE_AXIS)

    def slice_of(self, graph: Graph) -> RankSlice:
        """This rank's :class:`RankSlice` of ``graph``'s structure."""
        def build():
            if graph.is_shard:
                return RankSlice(graph.row, graph.col, 0, graph.edge_offset,
                                 graph.n_nodes, self.mesh.device)
            e = graph.n_edges
            part = graph_shardings(self.mesh, graph)
            start, stop = min(part.start, e), min(part.stop, e)
            return RankSlice(graph.row[start:stop], graph.col[start:stop],
                             start, start, graph.n_nodes, self.mesh.device)
        return self.get(graph, build)

    @staticmethod
    def _draw(graph: Graph, sl: RankSlice):
        if not graph.dropped:
            return None
        return (graph.drop_salt, graph.drop_keep, graph.drop_n, sl.base)

    def __call__(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        if graph.scaled or graph.eye_weight != 0.0:
            return _scaled_call(self, graph, x)
        check_device(self.mesh, x)
        sl = self.slice_of(graph)
        partial = _PartialFn.apply(x, sl.values(graph), self._draw(graph, sl),
                                   sl.products(), self.group)
        return all_reduce(partial, self.group)

    def degree(self, graph: Graph, by: str = "col") -> torch.Tensor:
        """The column (or row) sums of ``graph``'s (dropped) values: this
        rank's partial over its slice, all-reduced.  Under a lazy draw at or
        above ``min_edges()`` edges, K1's degree walk over the slice's
        column (row) list; otherwise K2's store-mode walk over its layout
        with a column of ones on a card, ``index_add_`` on the CPU (as one
        device sums)."""
        from ..ops.spmm import edge_degree
        from ..ops.stochastic import (drawn_values, ell_degree_masked,
                                      grids_eligible)
        sl = self.slice_of(graph)
        val = sl.values(graph)
        draw = self._draw(graph, sl)
        if sl.n_edges == 0:
            part = val.new_zeros(graph.n_nodes)
        elif draw is not None and grids_eligible(graph):
            rows, cols = sl.grids()
            part = ell_degree_masked(cols if by == "col" else rows, val,
                                     *draw)
        else:
            if draw is not None:
                val = drawn_values(val, *draw)
            part = edge_degree(Graph(sl.row, sl.col, val, graph.n_nodes), by,
                               walk=True)
        return all_reduce(part.to(graph.val.dtype), self.group)

    def attention(self, graph: Graph, h, s_src, s_dst, *, negative_slope,
                  attn_dropout, salt) -> torch.Tensor:
        """GAT's attention over ``graph`` (``ops.attention.gat_attention``'s
        arguments, ``salt`` None without dropout): over this rank's slice,
        merged over the ranks.  A mesh of one rank runs one device's chain
        over the whole graph."""
        from ..ops.attention import gat_attention_local
        check_device(self.mesh, h)
        keep = 1.0 - attn_dropout if salt is not None else 1.0
        if self.group.size() == 1:
            whole = dataclasses.replace(graph, edge_offset=0,
                                        global_edges=None)
            return gat_attention_local(whole, h, s_src, s_dst,
                                       negative_slope=negative_slope,
                                       attn_dropout=attn_dropout, salt=salt)
        lists = self.slice_of(graph).attention(dedup=keep >= 1.0)
        return _ShardAttnFn.apply(h, s_src, s_dst, [lists],
                                  salt if keep < 1.0 else None, keep,
                                  float(negative_slope), self.group)


def executor_for(mesh: Mesh, spmm: Optional[str]):
    """The executor of ``fit(mesh=, spmm=)``: :class:`GspmdExecutor` for
    None or ``"gspmd"``, else ``halo.HaloExecutor`` or
    ``ring.RingExecutor``."""
    if spmm == "halo":
        from .halo import HaloExecutor
        return HaloExecutor(mesh)
    if spmm == "ring":
        from .ring import RingExecutor
        return RingExecutor(mesh)
    return GspmdExecutor(mesh)


def make_train_step_raw(model, task, tx, regularization: float = 5e-4,
                        graph: Optional[Graph] = None):
    """The train step's body ``step(opt_state, generator, deg, batch) ->
    (opt_state, loss)``: the training forward with the draws of
    ``generator`` (over ``graph`` in place of the model's own, where given:
    the JAX package passes the sharded graph to its step), the task loss
    with the layer losses and ``regularization`` times the weight L2, the
    gradients of ``loss * deg`` and the optimizer's update of
    ``model.params`` in place (``train/trainer.py``'s host loop).  The loss
    is a 0-d tensor."""
    from ..train.trainer import _train_step
    names = [k for k, t in model.trainable_mask().items() if t]

    def step(opt_state, generator, deg, batch):
        return _train_step(model, task, batch, regularization, generator,
                           False, names, tx, opt_state, deg, graph)

    return step


def make_distributed_train_step(model, task, mesh: Mesh, tx,
                                regularization: float = 5e-4,
                                spmm: Optional[str] = None,
                                graph: Optional[Graph] = None):
    """:func:`make_train_step_raw` with every SpMM of the step through the
    mesh's executor (:func:`executor_for`); ``graph`` may be this rank's
    edge shard (``multihost.shard_graph_local``) under gspmd."""
    return _scoped(make_train_step_raw(model, task, tx, regularization,
                                       graph), executor_for(mesh, spmm))


def make_eval_raw(model):
    """The clean forward's body ``eval_fn(features, graph=None)``."""
    def eval_fn(features, graph=None):
        with torch.no_grad():
            return model.forward(features, training=False, graph=graph)
    return eval_fn


def make_distributed_eval(model, mesh: Mesh, spmm: Optional[str] = None,
                          graph: Optional[Graph] = None):
    """:func:`make_eval_raw` through the mesh's executor, over ``graph``
    (this rank's edge shard, say) where given and the call gives none."""
    eval_fn = make_eval_raw(model)
    if graph is not None:
        eval_fn = functools.partial(eval_fn, graph=graph)
    return _scoped(eval_fn, executor_for(mesh, spmm))


def _scoped(fn, executor):
    def wrapped(*args, **kw):
        with spmm_executor(executor):
            return fn(*args, **kw)
    return wrapped


class FeatShards:
    """This rank's column blocks of the parameters that
    :func:`param_shardings` marks ``("feat",)``: rank ``r`` of the ``feat``
    group holds columns ``[r * c, (r + 1) * c)`` of each, ``c`` its columns
    over the axis's size.  :meth:`whole` gathers a block back (the layers'
    reads, through ``Network.param``); :meth:`blocks` and :meth:`wholes`
    map a tree of them (parameters, optimizer moments, a checkpoint's
    arrays) either way, a leaf taken for a block where its dict key names a
    sharded parameter."""

    def __init__(self, mesh: Mesh, names):
        self.mesh = mesh
        self.n = mesh.shape[FEAT_AXIS]
        self.rank = rank_of(self.group)
        self.names = frozenset(names)

    @property
    def group(self):
        return self.mesh.group(FEAT_AXIS)

    def block(self, whole):
        """This rank's columns of ``whole`` (a tensor or an array)."""
        c = whole.shape[1] // self.n
        part = whole[:, self.rank * c:(self.rank + 1) * c]
        return part.contiguous() if isinstance(part, torch.Tensor) \
            else np.ascontiguousarray(part)

    def whole(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """Parameter ``name`` whole: the blocks of every rank side by side
        in column order (``collectives.all_gather`` of the transposes,
        whose backward takes this rank's columns of the gradient), or
        ``p`` where it is not sharded."""
        if name not in self.names:
            return p
        return all_gather(p.t(), self.group).t().contiguous()

    def _map(self, tree, fn, key=None):
        if isinstance(tree, dict):
            return {k: self._map(v, fn, k) for k, v in tree.items()}
        if key in self.names and getattr(tree, "ndim", 0) == 2:
            return fn(key, tree)
        return tree

    def blocks(self, tree):
        """``tree`` with each whole sharded leaf cut to this rank's
        block."""
        return self._map(tree, lambda _, t: self.block(t))

    @torch.no_grad()
    def wholes(self, tree):
        """``tree`` with each sharded block gathered whole."""
        return self._map(tree, self.whole)


def place_state(model, mesh: Mesh, shard: bool = True):
    """The features replicated on every rank and the parameters placed as
    JAX's GSPMD places them (``shard``: ``fit``'s gspmd executor; halo and
    ring keep every parameter whole): each parameter that
    :func:`param_shardings` marks ``("feat",)`` replaced by this rank's
    column block, ``model.shards`` their :class:`FeatShards`.  Raises
    unless the parameters and features lie on the mesh's kind of device.
    :func:`unshard` puts the whole parameters back."""
    params = model.params
    for name, p in params.items():
        if p.device.type != mesh.device.type:
            raise ValueError(f"parameter {name} is on {p.device}, the mesh "
                             f"on {mesh.device}")
    check_device(mesh, model.features)
    names = [k for k, axes in param_shardings(model, mesh).items()
             if axes == (FEAT_AXIS,)] if shard else []
    if names:
        shards = FeatShards(mesh, names)
        for name in names:
            p = params[name]
            params[name] = torch.nn.Parameter(shards.block(p.detach()),
                                              requires_grad=p.requires_grad)
        model.shards = shards
    return params, model.features


def unshard(model) -> None:
    """Put the whole parameters back in place of the column blocks that
    :func:`place_state` left (every rank of the ``feat`` group joins)."""
    shards = model.shards
    if shards is None:
        return
    params = model.params
    for name in sorted(shards.names):
        p = params[name]
        params[name] = torch.nn.Parameter(shards.whole(name, p.detach()),
                                          requires_grad=p.requires_grad)
    model.shards = None
