"""Counter-based edge dropout: the keep decision of edge ``e`` is a pure
hash of its id and two 32-bit salts,

    fmix32(fmix32(e ^ s0) ^ s1) >> 8  <  round(keep * 2**24),

so every layout that knows an edge's id recomputes the same realized mask,
on any device.  The masks are bit-equal to the JAX package's for the same
ids, salts, keep rate and ``n_drop``.

The hash runs in int64 with ``& 0xFFFFFFFF``: ``torch.uint32`` tensors do not
support ``>>`` or ``<``.  Multiplications are split into 16-bit halves so no
product leaves the int64 range.
"""
from __future__ import annotations

from typing import Tuple

import torch

# graphs below this many edges take an eager Bernoulli draw instead of the
# lazy salts (ops/normalize.py::edge_dropout)
MIN_EDGES = 65_536

_MASK32 = 0xFFFFFFFF


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


def _salts(salt) -> Tuple[int, int]:
    s0, s1 = (int(s) & _MASK32 for s in torch.as_tensor(salt).tolist())
    return s0, s1


def keep_mask(eids: torch.Tensor, salt, keep: float,
              n_drop: int) -> torch.Tensor:
    """Boolean keep decision per edge id (any shape, int64 ids).  Ids at or
    past ``n_drop`` (appended self-loops) are always kept."""
    s0, s1 = _salts(salt)
    eids = eids.to(torch.int64)
    h = _fmix32(_fmix32(eids ^ s0) ^ s1)
    thresh = min(int(round(keep * (1 << 24))), 1 << 24)
    return ((h >> 8) < thresh) | (eids >= n_drop)


def dropped_values(val: torch.Tensor, eids: torch.Tensor, salt, keep: float,
                   n_drop: int) -> torch.Tensor:
    """Inverted-dropout values: ``val / keep`` for kept ids below
    ``n_drop``, ``val`` at or past it, 0 for dropped ids."""
    kept = keep_mask(eids, salt, keep, n_drop)
    inv_keep = torch.tensor(1.0 / keep, dtype=val.dtype, device=val.device)
    scale = torch.where(eids < n_drop, inv_keep, torch.ones_like(inv_keep))
    return torch.where(kept, val * scale, torch.zeros_like(val))


# (salt, val, keep, n_drop, values) of the last draw materialized
_last_draw = None


def materialize_dropped(graph) -> torch.Tensor:
    """Per-edge dropped values of a lazily dropped graph.  The values of the
    last draw are kept, keyed on the identity of its salt and value tensors,
    which every copy of the dropped graph shares: a layer's degree sum and
    its SpMM hash the edge ids once.  Values that carry a gradient are not
    kept."""
    global _last_draw
    hit = _last_draw
    if hit is not None and hit[0] is graph.drop_salt and hit[1] is graph.val \
            and hit[2:4] == (graph.drop_keep, graph.drop_n):
        return hit[4]
    eids = torch.arange(graph.n_edges, dtype=torch.int64, device=graph.device)
    out = dropped_values(graph.val, eids, graph.drop_salt, graph.drop_keep,
                         graph.drop_n)
    if not out.requires_grad:
        _last_draw = (graph.drop_salt, graph.val, graph.drop_keep,
                      graph.drop_n, out)
    return out
