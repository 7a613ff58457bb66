"""Collectives over a mesh axis's process group, with the gradients of a
replicated model.

Every rank holds the parameters, the features and the batch, and computes
the same loss; only the propagation is sharded.  So each operation's
backward returns the gradient of that one loss:

* :func:`all_reduce` — forward the sum of the ranks' partials (JAX's
  ``psum``); backward the output's gradient, which every rank holds alike;
* :func:`slice_of_replicated` — forward the rank's block of rows of a
  replicated tensor; backward the all-gather of every rank's block gradient;
* :func:`all_gather` — forward the ranks' blocks stacked into the replicated
  tensor; backward the rank's own block of the gradient;
* :func:`all_to_all` — forward block q to rank q; backward the reverse
  exchange.

The raw exchanges (:func:`exchange`, :func:`gather_into`) take
``async_op`` so that a caller can walk its local edges while one is in
flight; such work is kept in ``IN_FLIGHT`` (weakly) until it is freed, so
that ``multihost.shutdown_distributed`` can wait on it.  A group of one
rank runs the collective all the same.

No object of the port holds a process group strongly: meshes, executors and
autograd contexts keep a :class:`GroupRef`.  A group then lives as long as
``torch.distributed`` holds it, and ``destroy_process_group`` frees it,
with its worker threads, while the interpreter is live.
"""
from __future__ import annotations

import weakref

import torch
import torch.distributed as dist

# the async work the exchanges started and their callers still hold
IN_FLIGHT: "weakref.WeakSet" = weakref.WeakSet()


class GroupRef:
    """A weak reference to a process group, which the port's meshes,
    executors and autograd contexts keep in its place: calling it gives the
    group, or raises once the group was destroyed."""

    __slots__ = ("_ref", "name")

    def __init__(self, group):
        self._ref = weakref.ref(group)
        self.name = group.group_name

    def __call__(self):
        group = self._ref()
        if group is None:
            raise RuntimeError(f"process group {self.name} is gone "
                               "(shutdown_distributed or "
                               "destroy_process_group ran)")
        return group


def rank_of(group) -> int:
    return dist.get_rank(group)


def size_of(group) -> int:
    return dist.get_world_size(group)


def _held(work):
    if work is not None:
        IN_FLIGHT.add(work)
    return work


def exchange(out: torch.Tensor, x: torch.Tensor, group, async_op=False):
    """``all_to_all_single``: block q of ``x`` (split on dim 0) goes to rank
    q, block q of ``out`` comes from rank q."""
    return _held(dist.all_to_all_single(out, x.contiguous(), group=group,
                                        async_op=async_op))


def gather_into(out: torch.Tensor, x: torch.Tensor, group, async_op=False):
    """Every rank's ``x`` stacked on dim 0 into ``out``."""
    return _held(dist.all_gather_into_tensor(out, x.contiguous(),
                                             group=group, async_op=async_op))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial ``x``."""
    return _AllReduce.apply(x, group)


def _gathered(x: torch.Tensor, group) -> torch.Tensor:
    out = x.new_empty((size_of(group) * x.shape[0],) + tuple(x.shape[1:]))
    gather_into(out, x, group)
    return out


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rows):
        ctx.group = GroupRef(group)
        r = rank_of(group)
        return x[r * rows:(r + 1) * rows].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.group()), None, None


def slice_of_replicated(x: torch.Tensor, group, rows: int) -> torch.Tensor:
    """Rows ``[r * rows, (r + 1) * rows)`` of the replicated ``x`` on rank
    ``r`` of ``group`` (``x`` holds ``size * rows`` rows)."""
    return _Slice.apply(x, group, rows)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = GroupRef(group), x.shape[0]
        return _gathered(x, group)

    @staticmethod
    def backward(ctx, g):
        r = rank_of(ctx.group())
        return g[r * ctx.rows:(r + 1) * ctx.rows].contiguous(), None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block ``x`` stacked into the replicated tensor."""
    return _AllGather.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = GroupRef(group)
        out = torch.empty_like(x)
        exchange(out, x, group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        exchange(out, g, ctx.group())
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block q of ``x`` (dim 0 split in ``size`` blocks) to rank q."""
    return _AllToAll.apply(x, group)
