"""Dict-of-arrays batching generator (reference core/nn/batching.py:1-9;
the reference exports it but never calls it)."""
from __future__ import annotations

from typing import Dict, Iterator


def batches(data: Dict, batch_size: int) -> Iterator[Dict]:
    """Yield successive dict slices of ``batch_size`` rows."""
    size = len(next(iter(data.values())))
    for start in range(0, size, batch_size):
        yield {k: v[start:start + batch_size] for k, v in data.items()}
