"""Raft domain types.

Parity with raft/types.h: vnode (id + revision), consistency levels
(raft/types.h replicate_options — quorum_ack / leader_ack / no_ack),
replicate results, and error codes (raft/errc.h).

(The JAX package's raft/types.py, copied.)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ConsistencyLevel(enum.IntEnum):
    quorum_ack = 0  # acks=-1: majority has fsynced
    leader_ack = 1  # acks=1: leader appended (no flush wait)
    no_ack = 2      # acks=0: fire and forget


class Errc(enum.IntEnum):
    success = 0
    not_leader = 1
    timeout = 2
    shutting_down = 3
    append_entries_rejection = 4
    leadership_transfer_in_progress = 5
    node_does_not_exist = 6
    configuration_change_in_progress = 7
    group_not_exists = 8


class RaftError(Exception):
    def __init__(self, errc: Errc, msg: str = "") -> None:
        super().__init__(msg or errc.name)
        self.errc = errc


@dataclass(frozen=True, order=True)
class VNode:
    """Node id + revision: a re-added node gets a new revision so stale
    votes/acks from its previous incarnation are ignored (raft/types.h vnode)."""

    id: int
    revision: int = 0


@dataclass
class ReplicateResult:
    last_offset: int
    term: int


@dataclass
class FollowerIndex:
    """Leader-side view of one follower (raft/follower_index.h semantics)."""

    node: VNode
    last_dirty_offset: int = -1
    last_flushed_offset: int = -1
    next_index: int = 0
    is_recovering: bool = False
    last_hbeat_ok: bool = True
    suppress_heartbeats: bool = False
