"""Partition allocator.

Parity with cluster/partition_allocator + cluster/scheduling/ (allocation
nodes, constraints; docs/rfcs/20191020_partition_allocator.md): the
controller leader assigns a replica set per partition subject to hard
constraints (distinct nodes, node not decommissioned, capacity) and a
soft objective (least-allocated node first). Deterministic given the same
table state, so tests can predict placements.

(The JAX package's cluster/allocator.py, copied.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from redpanda_tpu_torch.models.fundamental import NodeId


class AllocationError(Exception):
    pass


@dataclass
class AllocationNode:
    """Per-node allocation bookkeeping (cluster/scheduling/allocation_node)."""

    node_id: NodeId
    # One "core" ~ capacity for partition_capacity_per_core replicas; the
    # TPU build has no seastar shards, so capacity is a flat per-node count.
    max_capacity: int = 7000
    allocated: int = 0
    decommissioned: bool = False

    @property
    def free(self) -> int:
        return self.max_capacity - self.allocated

    def can_host(self) -> bool:
        return not self.decommissioned and self.free > 0


class PartitionAllocator:
    def __init__(self) -> None:
        self._nodes: dict[NodeId, AllocationNode] = {}

    # ------------------------------------------------------------ membership
    def register_node(self, node_id: NodeId, max_capacity: int = 7000) -> None:
        if node_id not in self._nodes:
            self._nodes[node_id] = AllocationNode(node_id, max_capacity)

    def unregister_node(self, node_id: NodeId) -> None:
        self._nodes.pop(node_id, None)

    def decommission_node(self, node_id: NodeId) -> None:
        n = self._nodes.get(node_id)
        if n:
            n.decommissioned = True

    def recommission_node(self, node_id: NodeId) -> None:
        n = self._nodes.get(node_id)
        if n:
            n.decommissioned = False

    def node(self, node_id: NodeId) -> AllocationNode | None:
        return self._nodes.get(node_id)

    def nodes(self) -> list[AllocationNode]:
        return list(self._nodes.values())

    # ------------------------------------------------------------ allocate
    def allocate(
        self, partition_count: int, replication_factor: int, *, commit: bool = False
    ) -> list[list[NodeId]]:
        """Replica sets for a new topic; raises if constraints unsatisfiable.

        With commit=False (the frontend path) the bookkeeping increments are
        rolled back: real accounting happens when the replicated command is
        APPLIED (note_allocated), so every node's allocator converges and a
        controller failover doesn't reset the load picture.
        """
        eligible = [n for n in self._nodes.values() if not n.decommissioned]
        if replication_factor > len(eligible):
            raise AllocationError(
                f"replication factor {replication_factor} > {len(eligible)} usable nodes"
            )
        out: list[list[NodeId]] = []
        try:
            for _ in range(partition_count):
                out.append(self._allocate_one(replication_factor))
        finally:
            if not commit:
                for s in out:
                    self.deallocate(s)
        return out

    def note_allocated(self, replicas: list[NodeId]) -> None:
        """Apply-path bookkeeping for a replicated assignment."""
        for r in replicas:
            n = self._nodes.get(r)
            if n is not None:
                n.allocated += 1

    def _allocate_one(
        self, replication_factor: int, exclude: set[NodeId] = frozenset()
    ) -> list[NodeId]:
        candidates = sorted(
            (
                n
                for n in self._nodes.values()
                if n.can_host() and n.node_id not in exclude
            ),
            # soft constraint: least allocated first; node id tiebreak for
            # determinism
            key=lambda n: (n.allocated, n.node_id),
        )
        if len(candidates) < replication_factor:
            raise AllocationError(
                f"cannot place {replication_factor} replicas on "
                f"{len(candidates)} candidate nodes"
            )
        chosen = candidates[:replication_factor]
        for n in chosen:
            n.allocated += 1
        return [n.node_id for n in chosen]

    def reallocate_replica(
        self, current: list[NodeId], leaving: NodeId
    ) -> list[NodeId]:
        """Replica set with `leaving` replaced (decommission path,
        members_backend semantics). Pure choice — accounting happens when
        finish_moving_partition_replicas is applied."""
        keep = [r for r in current if r != leaving]
        replacement = self._allocate_one(1, exclude=set(current))
        self.deallocate(replacement)  # roll back the selection increment
        return keep + replacement

    def deallocate(self, replicas: list[NodeId]) -> None:
        for r in replicas:
            n = self._nodes.get(r)
            if n and n.allocated > 0:
                n.allocated -= 1
