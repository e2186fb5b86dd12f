"""Data parallelism across processes: the process group and device mesh,
this rank's block of a batch, sharded rollouts and their statistics (port
of ``mpinets_tpu/parallel``; the reference's Lightning/NCCL DDP,
``mpinets/run_training.py:71-77``)."""

from mpinets_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Sharding,
    data_sharding,
    fold_seed,
    local_device,
    make_mesh,
    multihost_init,
    pad_to_multiple,
    process_count,
    process_index,
    process_local_slice,
    replicated_sharding,
    shard_leading_axis,
)
from mpinets_torch.parallel.rollout import (  # noqa: F401
    make_sharded_rollout,
    make_sharded_success_stats,
)
