"""Cluster membership: broker table + state transitions.

Parity with cluster/members_table + members_manager + members_backend:
brokers join by RPC to the controller leader, which replicates a
register_node command (the reference folds this into raft0 configuration +
members_manager; commands.h:164-173 covers decommission/recommission).
Decommission drains every replica off the node (members_backend reallocates
partitions), then the node can be removed.

(The JAX package's cluster/members.py, copied.)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class MembershipState(enum.IntEnum):
    active = 0
    draining = 1  # decommissioning: replicas being moved away
    removed = 2


@dataclass
class Broker:
    node_id: int
    host: str
    port: int  # internal rpc
    kafka_host: str = "127.0.0.1"
    kafka_port: int = 9092
    admin_port: int = 0  # 0 = not advertised (pre-pandascope log entries)
    state: MembershipState = MembershipState.active


class MembersTable:
    """node_id → Broker, plus change callbacks (members_table.h)."""

    def __init__(self) -> None:
        self._brokers: dict[int, Broker] = {}
        self._callbacks: list = []

    def register_change_callback(self, cb) -> None:
        """cb(broker) on every membership update."""
        self._callbacks.append(cb)

    def _notify(self, b: Broker) -> None:
        for cb in self._callbacks:
            cb(b)

    def apply_register(self, b: Broker) -> None:
        existing = self._brokers.get(b.node_id)
        if existing is not None and existing.state != MembershipState.removed:
            # re-join of a live node: update address only
            existing.host, existing.port = b.host, b.port
            existing.kafka_host, existing.kafka_port = b.kafka_host, b.kafka_port
            existing.admin_port = b.admin_port
            self._notify(existing)
            return
        self._brokers[b.node_id] = b
        self._notify(b)

    def apply_state(self, node_id: int, state: MembershipState) -> None:
        b = self._brokers.get(node_id)
        if b is not None:
            b.state = state
            self._notify(b)

    def get(self, node_id: int) -> Broker | None:
        return self._brokers.get(node_id)

    def contains(self, node_id: int) -> bool:
        b = self._brokers.get(node_id)
        return b is not None and b.state != MembershipState.removed

    def all_brokers(self) -> list[Broker]:
        return [b for b in self._brokers.values() if b.state != MembershipState.removed]

    def node_ids(self) -> list[int]:
        return [b.node_id for b in self.all_brokers()]
