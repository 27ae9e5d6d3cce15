"""Map-style dataset batcher (host-side, thread pool).

Counterpart of the JAX package's ``data/loader.py``: it stands in for the
torch DataLoader of the DeepLab stack; every batch of the eval is one
shape, so a stacking collate suffices. With ``num_hosts > 1`` each rank
reads its own shard of every epoch (``parallel/mesh.py
shard_index_space``), as torch's DistributedSampler does.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

from ..parallel.mesh import check_shard, shard_index_space


def default_collate(samples):
    """Stack tuples of (image, target, target_true) arrays into a batch."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(np.stack([s[i] for s in samples])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    return np.stack(samples)


def batch_iterator(dataset, batch_size: int, *, shuffle: bool = True,
                   seed: int = 1, drop_last: bool = True,
                   collate: Callable = default_collate,
                   num_workers: int = 8,
                   epochs: Optional[int] = None,
                   num_hosts: int = 1, host_id: int = 0) -> Iterator:
    """Yield collated batches, epoch after epoch (``epochs`` None: for
    ever). The order of an epoch is a permutation seeded by ``seed +
    epoch`` (numpy's default_rng), or the dataset order without
    ``shuffle``; a batch's samples are loaded by a pool of
    ``num_workers`` threads. A dataset with ``set_epoch`` is told each
    epoch before its first sample is read.

    With ``num_hosts > 1`` host ``host_id`` draws a disjoint covering shard
    of the epoch's order, the permutation seeded by ``seed + epoch`` that
    every host agrees on (the dataset order without ``shuffle``), as the
    JAX package's loader does."""
    check_shard(num_hosts, host_id)
    n = len(dataset)
    epoch = 0
    pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers else None
    try:
        while epochs is None or epoch < epochs:
            if hasattr(dataset, "set_epoch"):
                dataset.set_epoch(epoch)
            if num_hosts > 1:
                order = shard_index_space(
                    n, num_hosts, host_id,
                    shuffle_seed=(seed + epoch) if shuffle else None)
            else:
                order = (np.random.default_rng(seed + epoch).permutation(n)
                         if shuffle else np.arange(n))
            for start in range(0, len(order), batch_size):
                idx = order[start:start + batch_size]
                if len(idx) < batch_size and drop_last:
                    continue
                if pool is not None:
                    samples = list(pool.map(dataset.__getitem__, idx))
                else:
                    samples = [dataset[i] for i in idx]
                yield collate(samples)
            epoch += 1
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
