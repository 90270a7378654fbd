"""Raft consensus layer (parity with src/v/raft).

One ``Consensus`` per partition replica over the storage log; batched
cross-group heartbeats; prevote elections; recovery with a shared throttle;
snapshot install; joint-consensus membership changes; state-machine apply
loops. The ``GroupManager`` wires it all to the internal RPC mesh.

(The JAX package's raft/ (beside it, device_plane.py is the port's own), copied.)
"""

from redpanda_tpu_torch.raft.configuration import ConfigurationManager, GroupConfiguration
from redpanda_tpu_torch.raft.consensus import Consensus, OffsetMonitor, RaftTimings
from redpanda_tpu_torch.raft.group_manager import GroupManager
from redpanda_tpu_torch.raft.heartbeat_manager import HeartbeatManager
from redpanda_tpu_torch.raft.service import RaftService, raftgen_service
from redpanda_tpu_torch.raft.state_machine import MuxStateMachine, StateMachine
from redpanda_tpu_torch.raft.types import (
    ConsistencyLevel,
    Errc,
    FollowerIndex,
    RaftError,
    ReplicateResult,
    VNode,
)

__all__ = [
    "ConfigurationManager", "GroupConfiguration", "Consensus", "OffsetMonitor",
    "RaftTimings", "GroupManager", "HeartbeatManager", "RaftService",
    "raftgen_service", "MuxStateMachine", "StateMachine", "ConsistencyLevel",
    "Errc", "FollowerIndex", "RaftError", "ReplicateResult", "VNode",
]
