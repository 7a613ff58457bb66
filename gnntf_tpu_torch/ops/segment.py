"""Segment reductions beyond ``index_add_``: the segment softmax of graph
attention (the JAX package's ``ops/segment.py``)."""
from __future__ import annotations

import torch


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
    shifted = torch.exp(scores - seg_max[ids])
    denom = torch.zeros_like(seg_max).index_add_(0, ids, shifted)
    return shifted / denom[ids].clamp(min=1e-30)
