"""Single-host scale-out on ``torch.distributed`` (the JAX package's
``parallel/dist.py``).

The design is SPMD with a replicated model: every rank of the mesh holds
the parameters, the features and the batch, and computes the same loss, so
the parameter gradients, and after the optimizer's update the parameters,
are equal on every rank.  Only the propagation is sharded, by an executor
installed through ``ops.spmm.spmm_executor``:

* :class:`GspmdExecutor` (``fit(mesh=, spmm=None | "gspmd")``, JAX's GSPMD
  path): each rank takes its contiguous slice of the padded edge list
  (:func:`shard_graph`), computes its partial ``A_r @ x`` over all N rows
  and all-reduces it over the ``edge`` group (JAX's psum); the backward's
  ``dx = sum_r A_r^T dy`` is all-reduced the same way;
* ``halo.HaloExecutor`` and ``ring.RingExecutor`` (``spmm="halo"`` and
  ``"ring"``).

Each rank's product is a walk over its lists (``dropgrids.rank_walk``):
K2's store-mode walk with realized values, or K1's masked walk under a
lazy draw, hashed by global edge id.  What is not an SpMM (the degree pass
of ``normalize_adjacency``, GAT's attention chain) runs replicated over the
whole graph on every rank; JAX's GSPMD edge-shards it (ROADMAP.md).

Mesh axes, as in the JAX package: ``edge`` shards the edges; ``feat`` is
the feature axis, over which this port replicates every parameter
(:func:`param_shardings` gives JAX's decisions).  The mesh is built inside
an initialized process group: the caller runs ``init_process_group`` with
its address, world size and rank.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..graph.coo import Graph
from ..ops.spmm import _scaled_call, spmm_executor
from .collectives import all_reduce, rank_of
from .dropgrids import executor_drop_state, rank_lists, rank_walk
from .partition import pad_graph

EDGE_AXIS = "edge"
FEAT_AXIS = "feat"


class Mesh:
    """An (edge, feat) mesh of the process group's ranks over a
    ``torch.distributed.device_mesh.DeviceMesh``: ``shape`` maps each axis
    name to its size, :meth:`group` gives an axis's process group."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh

    @property
    def shape(self) -> dict:
        return dict(zip(self.device_mesh.mesh_dim_names,
                        self.device_mesh.shape))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def device(self) -> torch.device:
        """The device of this rank's tensors: its card under NCCL, else the
        CPU."""
        if self.device_mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_mesh.device_type)


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
    than one row), else ``()`` (replicated).  This port replicates every
    parameter: the numbers do not depend on the layout."""
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
        ctx.val, ctx.draw, ctx.lists, ctx.group = val, draw, lists, group
        return walk_or_zeros(lists, 0, val, draw, x, x.shape[0])

    @staticmethod
    def backward(ctx, dy):
        dx = walk_or_zeros(ctx.lists, 1, ctx.val, ctx.draw, dy, dy.shape[0])
        dist.all_reduce(dx, group=ctx.group)
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


class GspmdExecutor(_StructureCache):
    """An ``ops.spmm`` executor: each product is this rank's partial over
    its slice of the padded edge list, all-reduced over the ``edge`` group
    (module docstring).  A lazily dropped graph arrives with its draw and is
    hashed by global edge id in the masked walk; padding slots have value 0
    and are left out of the lists."""

    supports_lazy_dropout = True

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh
        self.group = mesh.group(EDGE_AXIS)

    def lists_for(self, graph: Graph):
        """This rank's forward and transposed lists of ``graph``'s
        structure (None when its slice holds no edge)."""
        def build():
            e = graph.n_edges
            part = graph_shardings(self.mesh, graph)
            stop = min(part.stop, e)
            row = graph.row[part.start:stop].cpu().numpy()
            col = graph.col[part.start:stop].cpu().numpy()
            return rank_lists(row, col, np.arange(part.start, stop),
                              graph.n_nodes, graph.n_nodes, e,
                              self.mesh.device)
        return self.get(graph, build)

    def __call__(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        if graph.scaled or graph.eye_weight != 0.0:
            return _scaled_call(self, graph, x)
        check_device(self.mesh, x)
        val, draw = executor_drop_state(graph)
        partial = _PartialFn.apply(x, val, draw, self.lists_for(graph),
                                   self.group)
        return all_reduce(partial, self.group)


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


def make_train_step_raw(model, task, tx, regularization: float = 5e-4):
    """The train step's body ``step(opt_state, generator, deg, batch) ->
    (opt_state, loss)``: the training forward with the draws of
    ``generator``, the task loss with the layer losses and ``regularization``
    times the weight L2, the gradients of ``loss * deg`` and the optimizer's
    update of ``model.params`` in place (``train/trainer.py``'s host loop).
    The loss is a 0-d tensor."""
    from ..train.trainer import _train_step
    names = [k for k, t in model.trainable_mask().items() if t]

    def step(opt_state, generator, deg, batch):
        return _train_step(model, task, batch, regularization, generator,
                           False, names, tx, opt_state, deg)

    return step


def make_distributed_train_step(model, task, mesh: Mesh, tx,
                                regularization: float = 5e-4,
                                spmm: Optional[str] = None):
    """:func:`make_train_step_raw` with every SpMM of the step through the
    mesh's executor (:func:`executor_for`)."""
    return _scoped(make_train_step_raw(model, task, tx, regularization),
                   executor_for(mesh, spmm))


def make_eval_raw(model):
    """The clean forward's body ``eval_fn(features, graph=None)``."""
    def eval_fn(features, graph=None):
        with torch.no_grad():
            return model.forward(features, training=False, graph=graph)
    return eval_fn


def make_distributed_eval(model, mesh: Mesh, spmm: Optional[str] = None):
    """:func:`make_eval_raw` through the mesh's executor."""
    return _scoped(make_eval_raw(model), executor_for(mesh, spmm))


def _scoped(fn, executor):
    def wrapped(*args, **kw):
        with spmm_executor(executor):
            return fn(*args, **kw)
    return wrapped


def place_state(model, mesh: Mesh):
    """The parameters and the features, replicated on every rank: raises
    unless they lie on the mesh's kind of device."""
    params = model.params
    for name, p in params.items():
        if p.device.type != mesh.device.type:
            raise ValueError(f"parameter {name} is on {p.device}, the mesh "
                             f"on {mesh.device}")
    check_device(mesh, model.features)
    return params, model.features
