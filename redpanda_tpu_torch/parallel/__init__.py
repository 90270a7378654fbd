from redpanda_tpu_torch.parallel.mesh import (
    PARTITION_AXIS,
    PartitionMesh,
    Sharded,
    partition_mesh,
    shard_to_mesh,
)
from redpanda_tpu_torch.parallel.collectives import (
    make_crc_vote_step,
    make_sharded_coproc_step,
    make_sharded_crc_check,
    make_vote_aggregator,
)

__all__ = [
    "PARTITION_AXIS",
    "PartitionMesh",
    "Sharded",
    "partition_mesh",
    "shard_to_mesh",
    "make_vote_aggregator",
    "make_crc_vote_step",
    "make_sharded_crc_check",
    "make_sharded_coproc_step",
]
