"""Data and tensor parallelism over ``torch.distributed`` (port of
``sparse_pooling_tpu.parallel``): the ``(data, model)`` grid of ranks and
its sharding layout (``mesh``), process-group start-up (``multihost``), the
column-split FC's collectives (``tensor_parallel``), a launcher of local
ranks (``launch``) and the CPU dry run (``dryrun``)."""

from sparse_pooling_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    auto_mesh,
    batch_rows,
    make_mesh,
    param_sharding_rules,
    shard_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "auto_mesh",
    "batch_rows",
    "make_mesh",
    "param_sharding_rules",
    "shard_params",
]
