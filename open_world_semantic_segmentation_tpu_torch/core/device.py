"""Device selection for the port's entry points, and the asynchronous
copy of results to the host."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device. Asking for CUDA on a
    machine without a GPU raises; there is no silent CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "--device cpu (device='cpu') to run on the CPU")
    return device


def to_host_async(tensors):
    """Start copying ``tensors`` to the host; returns a function that
    waits for the copies and returns numpy arrays. On CUDA the copies go
    to pinned memory behind the work already queued, so waiting for them
    does not wait for work queued later."""
    if tensors[0].device.type != "cuda":
        return lambda: [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return [h.numpy() for h in host]
    return wait
