"""Structured metrics and profiler hooks.

Counterpart of the JAX package's ``utils/observability.py``:

- ``MetricsWriter``: an append-only JSONL stream, one
  ``{"step", "time", **scalars}`` object per line;
- ``profile_trace(log_dir)``: a ``torch.profiler`` trace of the block (host
  activity, and the GPU's kernels where CUDA is present) written into
  ``log_dir`` as a Chrome / TensorBoard trace (``trace.json``), the JAX
  package's ``jax.profiler`` trace; nothing for a falsy ``log_dir``;
- ``annotate(name)``: a named region in such a trace
  (``torch.profiler.record_function``), and an NVTX range on CUDA for an
  outside profiler.

As in the JAX package, no CLI flag turns them on: a caller wraps the code
it wants to see.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Optional

import torch

TRACE_FILE = "trace.json"


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


@contextmanager
def profile_trace(log_dir: Optional[str]):
    """Profile the block; write ``log_dir/trace.json`` (open it in
    ``chrome://tracing``, Perfetto, or TensorBoard's profiler plugin).
    A no-op when ``log_dir`` is falsy. Yields the profiler (None when
    off), whose ``key_averages()`` tabulate the same events."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextmanager
def annotate(name: str):
    """A named region in profiler traces; an NVTX range as well on CUDA."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
