"""Dropout with the reference's semantics: ``tf.nn.dropout(x, rate)`` zeroes
entries with probability ``rate`` and scales the survivors by
``1 / (1 - rate)`` (reference gnntf/core/nn/layered.py:44-50)."""
from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout; ``rate`` is the drop probability.  The mask is drawn
    from ``generator``, which must live on ``x``'s device."""
    if rate == 0.0:
        return x
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
