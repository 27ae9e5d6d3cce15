"""Data-parallel training across ranks on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/`` (``mesh.py``): one process
per rank, each holding its local batch; batch norm, the losses and the
gradients reduce over the ranks, so N ranks compute what one process
computes on the global batch.
"""

from .mesh import (
    all_reduce_sum,
    average_gradients,
    check_shard,
    data_group,
    init_distributed,
    replicas_agree,
    replicate,
    shard_index_space,
    world_size,
)
