"""Structured training logs (the JAX package's ``utils/logging.py``).

The reference logs through a single ``print`` on improved epochs
(trainable.py:91-95).  Here every epoch emits a structured record to any
combination of sinks: an in-memory list, a JSONL file, and (optionally)
a stream in the reference's one-line format.

Use as a ``fit(..., callbacks=[logger])`` callback or call ``log(record)``
directly.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, List, Optional


class TrainLogger:
    """Callback-compatible structured logger.

    ``fit`` invokes callbacks with keyword arguments
    ``epoch, params, valid_loss, best_loss, patience_remaining``; the
    record drops the params and adds a timestamp.  Returning False never
    stops training.
    """

    def __init__(self, jsonl_path: Optional[str] = None, echo: bool = False,
                 stream: IO = sys.stderr):
        self.records: List[dict] = []
        self.echo = echo
        self.stream = stream
        self._fh: Optional[IO] = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._fh = open(jsonl_path, "a", buffering=1)

    def log(self, record: dict) -> None:
        record = dict(record, ts=time.time())
        self.records.append(record)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
        if self.echo:
            fields = " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in record.items()
                              if k != "ts")
            print(fields, file=self.stream)

    # fit() callback protocol
    def __call__(self, *, epoch, params, valid_loss, best_loss,
                 patience_remaining, **kw) -> bool:
        self.log({"epoch": int(epoch), "valid_loss": float(valid_loss),
                  "best_loss": float(best_loss),
                  "patience_remaining": int(patience_remaining), **kw})
        return False

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
