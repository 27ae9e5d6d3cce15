"""Structured metrics: an append-only JSONL stream.

Counterpart of the JAX package's ``utils/observability.py``
``MetricsWriter`` (its ``jax.profiler`` hooks are not ported): one
``{"step", "time", **scalars}`` object per line.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    """Append-only JSONL metrics: one {"step", "time", **scalars} per line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def write(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
