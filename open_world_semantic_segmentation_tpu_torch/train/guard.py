"""Training failure detection: the non-finite loss / gradient guard.

Counterpart of the JAX package's ``train/guard.py``: a step whose loss or
any gradient is not finite is skipped, that is parameters, momentum
buffers and batch-norm statistics keep the values they had before it, and
the step reports ``skipped``. The flag stays on the device: selecting
between the new and the saved values is a device op, so the guard costs
no host synchronisation (the trainer reads the flag when it logs).

One difference from the JAX package: there, a skipped step also keeps
optax's schedule count, so the next step's learning rate is the skipped
one's; here the optimizer's step count, which the schedule reads, advances
over a skipped step as the JAX state's ``step`` does, since the host would
have to read the flag to hold it back.
"""

from __future__ import annotations

from typing import Iterable, List

import torch


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor: every element of every float tensor is finite. The
    inf-norm of a tensor is finite exactly when all its elements are (NaN
    and inf propagate through the max)."""
    tensors = [t for t in tensors if t.is_floating_point()]
    if not tensors:
        return torch.tensor(True)
    norms = torch._foreach_norm(tensors, float("inf"))
    return torch.stack([n.float() for n in norms]).isfinite().all()


def save_state(tensors: List[torch.Tensor], saved=None) -> List[torch.Tensor]:
    """Copies of ``tensors``, into ``saved`` where given (reused across
    steps)."""
    if saved is None:
        return [t.detach().clone() for t in tensors]
    for s, t in zip(saved, tensors):
        s.copy_(t)
    return saved


@torch.no_grad()
def select_update(finite: torch.Tensor, tensors: List[torch.Tensor],
                  saved: List[torch.Tensor]):
    """In place: each tensor keeps its new value where ``finite``, else
    takes back its saved one."""
    for t, s in zip(tensors, saved):
        t.copy_(torch.where(finite, t, s))
