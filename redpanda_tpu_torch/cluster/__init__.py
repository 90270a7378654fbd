"""Cluster layer: control plane + partition runtime.

Parity with src/v/cluster: the ``Controller`` replicates typed commands
over raft group 0 (controller.h:31), every node's STM applies them to
shared tables (topic_table, members_table), and the ``ControllerBackend``
reconciles deltas into local raft groups/partitions
(controller_backend.cc:202). ``Partition`` fronts a pluggable consensus
(direct-log single-node, raft::consensus replicated).

(The JAX package's cluster/, with the same exports; ``rm_stm`` and
``tx_gateway`` are imported from their modules, as in the reference.)
"""

from redpanda_tpu_torch.cluster.allocator import AllocationError, PartitionAllocator
from redpanda_tpu_torch.cluster.commands import Command, CommandType
from redpanda_tpu_torch.cluster.controller import (
    CONTROLLER_GROUP,
    CONTROLLER_NTP,
    ClusterError,
    Controller,
    NotControllerError,
)
from redpanda_tpu_torch.cluster.controller_backend import ControllerBackend
from redpanda_tpu_torch.cluster.leaders_table import PartitionLeadersTable
from redpanda_tpu_torch.cluster.members import Broker, MembersTable, MembershipState
from redpanda_tpu_torch.cluster.metadata_cache import MetadataCache
from redpanda_tpu_torch.cluster.metadata_dissemination import MetadataDisseminationService
from redpanda_tpu_torch.cluster.partition import Partition, PartitionManager
from redpanda_tpu_torch.cluster.service import ClusterService, ControllerDispatcher, join_cluster
from redpanda_tpu_torch.cluster.shard_table import ShardTable
from redpanda_tpu_torch.cluster.topic_table import (
    PartitionAssignment,
    TopicConfig,
    TopicMetadata,
    TopicTable,
)

__all__ = [
    "AllocationError",
    "Broker",
    "CONTROLLER_GROUP",
    "CONTROLLER_NTP",
    "ClusterError",
    "ClusterService",
    "Command",
    "CommandType",
    "Controller",
    "ControllerBackend",
    "ControllerDispatcher",
    "MembersTable",
    "MembershipState",
    "MetadataCache",
    "MetadataDisseminationService",
    "NotControllerError",
    "Partition",
    "PartitionAllocator",
    "PartitionAssignment",
    "PartitionLeadersTable",
    "PartitionManager",
    "ShardTable",
    "TopicConfig",
    "TopicMetadata",
    "TopicTable",
    "join_cluster",
]
