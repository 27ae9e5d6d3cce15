"""Data-parallel training over ``torch.distributed`` ranks.

Counterpart of the JAX package's ``parallel/mesh.py`` on its multi-host
tier (one process per host, each holding its local batch): here one
process per rank, each holding its local batch on its own device. The
global batch is ranks x local batch, and a step over N ranks computes
what one process computes on the global batch:

- ``init_distributed`` stands for ``make_mesh``: it joins the process
  group ``torch.distributed.run`` (``torchrun``) describes in the
  environment and picks the rank's device;
- ``shard_index_space`` (the same numpy code as the JAX package's) gives
  each rank a disjoint covering shard of the sample index space, as
  ``data_sharding`` / ``shard_batch`` lay a batch over the data axis; the
  loaders take it through ``num_hosts`` / ``host_id`` and each rank puts
  its own shard on its device;
- ``replicate`` broadcasts rank 0's parameters and buffers, so every rank
  starts from the same weights;
- ``all_reduce_sum`` is the ``psum`` that carries gradients: batch norm's
  global statistics (``models/layers.py``) and the losses' global sums
  (``train/losses.py``) reduce through it, and ``average_gradients`` is the
  gradient all-reduce of ``train/state.py TrainStep``;
- ``replicas_agree`` checks that every rank holds bit-identical tensors.

The spatial mesh (``make_spatial_mesh``) and ``make_mesh_for_batch``'s
shrinking to a divisor of the batch are not ported (``ROADMAP.md``).
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 1800          # a collective waits this long for the other ranks


def shard_index_space(num_samples: int, num_hosts: int, host_id: int,
                      *, shuffle_seed: Optional[int] = None):
    """Per-host contiguous shard of the sample index space (the reference's
    DistributedSampler). With a seed, a permutation every host agrees on
    comes first; the last shard is padded from the front of the order, so
    every host gets the same count."""
    idx = np.arange(num_samples)
    if shuffle_seed is not None:
        idx = np.random.default_rng(shuffle_seed).permutation(idx)
    per_host = (num_samples + num_hosts - 1) // num_hosts
    pad = per_host * num_hosts - num_samples
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[host_id * per_host:(host_id + 1) * per_host]


def check_shard(num_hosts: int, host_id: int):
    """Refuse a host id outside ``range(num_hosts)``."""
    if num_hosts < 1 or not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} of num_hosts {num_hosts}")


def init_distributed(device=None, *, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S):
    """Join the process group; return ``(rank, world, device)``.

    Without ``WORLD_SIZE`` in the environment (no launcher) this does
    nothing and returns ``(0, 1, device)``, ``device`` resolved as the
    entry points resolve it (``cuda`` unless named). Under
    ``torch.distributed.run`` it reads ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK``; a CUDA rank runs on ``cuda:LOCAL_RANK`` (modulo the
    device count, so that ranks may share one card) and makes it the
    current device. ``backend`` unless named: NCCL where every rank of the
    host has a card of its own, gloo on the CPU and where ranks share a
    card (NCCL refuses two ranks on one device; gloo takes CUDA tensors
    through host copies). ``init_method``: ``env://`` (the launcher's
    address) unless given, such as a ``file://`` store. Where the group
    already exists it is joined as it is."""
    from ..core.device import resolve_device

    device = resolve_device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), _rank_device(device)
    if "WORLD_SIZE" not in os.environ:
        return 0, 1, device
    if backend is None:
        backend = _default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    device = _rank_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size(), device


def _default_backend(device: torch.device) -> str:
    """NCCL for CUDA ranks with a card each (``LOCAL_WORLD_SIZE``, which
    ``torch.distributed.run`` sets, at most the device count), else gloo."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def _rank_device(device: torch.device) -> torch.device:
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", 0))
    device = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def data_group():
    """The group data-parallel training reduces over: the default group
    when ``torch.distributed`` is initialised, else None (one process)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def world_size(group) -> int:
    """The rank count of ``group``; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    the ranks' output gradients (every rank holds the same sum, and the
    loss of every rank reads it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, with its gradient (``x`` itself
    without a group). Each rank computes the same replicated value; the
    backward sums the ranks' gradients, so that with gradients averaged
    over the ranks (``average_gradients``) a parameter's gradient is that of
    the one-process loss on the global batch."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def _flat_buckets(tensors):
    """``tensors`` grouped by dtype and device, in order."""
    buckets = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    return buckets.values()


def _unflatten_into(flat, tensors):
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor], group):
    """Average the parameters' gradients over ``group``: one flat buffer per
    dtype and device, all-reduced once and divided by the rank count.
    Every rank ends with the same bits."""
    world = world_size(group)
    for grads in _flat_buckets([p.grad for p in params
                                if p.grad is not None]):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        _unflatten_into(flat, grads)


@torch.no_grad()
def replicate(module: torch.nn.Module, group=None, src: int = 0):
    """Broadcast ``module``'s parameters and buffers from rank ``src`` of
    ``group`` (the default group when None) to every rank, in place, one
    flat buffer per dtype and device; a no-op in one process."""
    group = data_group() if group is None else group
    if world_size(group) == 1:
        return module
    tensors = [t.data for t in list(module.parameters())
               + list(module.buffers())]
    for bucket in _flat_buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.broadcast(flat, dist.get_global_rank(group, src), group=group)
        _unflatten_into(flat, bucket)
    return module


@torch.no_grad()
def replicas_agree(tensors: Iterable[torch.Tensor], group=None) -> bool:
    """True when every rank of ``group`` holds the same bits in
    ``tensors``: a 64-bit sum of each tensor's bit patterns, gathered and
    compared. True in one process."""
    group = data_group() if group is None else group
    if world_size(group) == 1:
        return True
    sums = []
    for t in tensors:
        t = t.detach().contiguous().reshape(-1)
        if t.is_floating_point():
            t = t.view({8: torch.int64, 4: torch.int32,
                        2: torch.int16}[t.element_size()])
        sums.append(t.sum(dtype=torch.int64))
    mine = torch.stack(sums)
    every = [torch.empty_like(mine) for _ in range(world_size(group))]
    dist.all_gather(every, mine, group=group)
    return all(torch.equal(mine, other) for other in every)
