"""Segment reductions beyond ``index_add_``: the segment softmax of graph
attention (the JAX package's ``ops/segment.py``), and :func:`gather_rows`,
the row gather that the plain products use."""
from __future__ import annotations

import torch


class _GatherRowsFn(torch.autograd.Function):
    """``x[idx]`` along dim 0 whose backward sums with ``index_add_``, in
    index order on the CPU, where autograd's backward of ``x[idx]``
    (``index_put_`` with ``accumulate``) sums in no fixed order."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dx = g.new_zeros((ctx.n,) + tuple(g.shape[1:]))
        return dx.index_add_(0, idx, g), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (``idx`` int64, one dimension), with a backward that sums
    in a fixed order on the CPU, so a run repeats bit for bit."""
    return _GatherRowsFn.apply(x, idx)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    indices_are_sorted: bool = False) -> torch.Tensor:
    """Numerically stable softmax of ``scores`` within each segment.

    ``scores``: (E,) or (E, H); ``segment_ids``: (E,).  The segment maximum
    is taken first (0 where a segment's maximum is not finite), then each
    score's exponential is divided by its segment's sum, at least 1e-30.
    ``indices_are_sorted`` is accepted for the JAX signature; the result
    does not depend on it."""
    del indices_are_sorted
    ids = segment_ids.long()
    index = ids.view(-1, *([1] * (scores.dim() - 1))).expand_as(scores)
    seg_max = torch.full((num_segments, *scores.shape[1:]), float("-inf"),
                         dtype=scores.dtype, device=scores.device)
    seg_max = seg_max.scatter_reduce(0, index, scores, reduce="amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    shifted = torch.exp(scores - gather_rows(seg_max, ids))
    denom = torch.zeros_like(seg_max).index_add_(0, ids, shifted)
    return shifted / gather_rows(denom, ids).clamp(min=1e-30)
