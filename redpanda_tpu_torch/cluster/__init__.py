"""Cluster layer: the partition runtime (the JAX package's cluster/,
the part a standalone broker stands on).

Parity with src/v/cluster: ``Partition`` fronts a pluggable consensus
(direct-log single-node here), ``TopicTable`` is the topic/partition
metadata and its delta stream, ``OffsetTranslator`` hides non-data batches
from Kafka offsets. The controller, its backend and the rest of the
cluster's control plane come with the RPC and raft layers.
"""

from redpanda_tpu_torch.cluster.partition import Partition, PartitionManager
from redpanda_tpu_torch.cluster.topic_table import (
    PartitionAssignment,
    TopicConfig,
    TopicMetadata,
    TopicTable,
)

__all__ = [
    "Partition",
    "PartitionAssignment",
    "PartitionManager",
    "TopicConfig",
    "TopicMetadata",
    "TopicTable",
]
