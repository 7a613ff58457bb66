"""Profiling and tracing hooks (the JAX package's ``utils/profiling.py``
over ``torch.profiler``; the reference has none).

* :func:`trace`: a ``torch.profiler`` session around the enclosed region,
  its Chrome trace written into ``log_dir``.
* :func:`fetch_barrier`: wait until a result is computed.
* :class:`StepTimer`: wall-clock step times, each stopped at a barrier.
* :func:`named_scope`: ``torch.profiler.record_function``, a named span in
  the trace.
* :func:`roofline`: an SpMM's bandwidth bound.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import numpy as np
import torch

named_scope = torch.profiler.record_function

# the HBM rate of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data
# sheet, at its full 700 W power limit
H100_SXM_HBM_GBPS = 3350.0


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region (the CPU, and the card when there is
    one) and write its Chrome trace to ``log_dir/trace.json`` (view with
    Perfetto or ``chrome://tracing``).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(result):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            yield from _tensors(v)


def fetch_barrier(result) -> None:
    """Block until ``result`` (a tensor, or dicts, tuples and lists of
    them) is computed: synchronize the card of each of its CUDA
    tensors."""
    for device in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(device)


class StepTimer:
    """Collects per-step wall times; ``summary()`` gives mean/min/p50/p95."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._steps_seen = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            fetch_barrier(result)
        dt = time.perf_counter() - self._t0
        self._steps_seen += 1
        if self._steps_seen > self.warmup:
            self.times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self, result_holder=None):
        """Time the enclosed step; ``result_holder`` (a list) may receive
        its result, which the stop waits for."""
        self.start()
        yield self
        self.stop(result_holder)

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": int(arr.size),
            "mean_s": float(arr.mean()),
            "min_s": float(arr.min()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }


def roofline(edges: int, features: int, seconds: float, *,
             dtype_bytes: int = 4,
             hbm_gbps: float = H100_SXM_HBM_GBPS) -> dict:
    """SpMM roofline estimate for one propagation.  Traffic model: each
    edge reads one source row, the output is written once.  ``hbm_gbps``
    defaults to an H100 SXM's memory rate; pass the card's own where it
    differs."""
    bytes_moved = edges * features * dtype_bytes  # source-row reads
    bound_s = bytes_moved / (hbm_gbps * 1e9)
    return {
        "bytes_moved": bytes_moved,
        "bound_s": bound_s,
        "achieved_fraction": bound_s / seconds if seconds > 0 else 0.0,
        "edges_per_s": edges / seconds if seconds > 0 else 0.0,
    }
