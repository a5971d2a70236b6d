"""Data-parallel training over ``torch.distributed`` (twin of
:mod:`tdwss.parallel`): :mod:`tdwss_torch.parallel.dp`.

The reference's exports (``make_dp_train_step``, ``make_mesh``,
``shard_batch``, ``stack_batches``) build one jitted program over a
device mesh from batches stacked to one shape; each rank of the port
plans and steps on its own batch, and these functions keep the ranks'
replicas equal.
"""

from tdwss_torch.parallel.dp import (  # noqa: F401
    average_batch_stats,
    average_gradients,
    average_scalars,
    broadcast_state,
    dp_device,
)
