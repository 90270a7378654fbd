"""Raft group configuration and its offset-indexed history.

Parity with raft/group_configuration.h (voters/learners, joint-consensus
transitions) and raft/configuration_manager.h (configurations tracked by the
offset of the batch that introduced them, so truncation can roll them back).

Configurations travel in the log as ``raft_configuration`` batches; the
offset translator later subtracts them from Kafka offsets
(kafka/server/offset_translator.h:11-26).

(The JAX package's raft/configuration.py, copied.)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from redpanda_tpu_torch.raft.types import VNode


@dataclass
class GroupConfiguration:
    voters: list[VNode] = field(default_factory=list)
    learners: list[VNode] = field(default_factory=list)
    # During a joint-consensus membership change both old and new voter sets
    # must independently reach majority (group_configuration.h old/current).
    old_voters: list[VNode] | None = None
    revision: int = 0

    def all_nodes(self) -> list[VNode]:
        seen: dict[int, VNode] = {}
        for n in self.voters + self.learners + (self.old_voters or []):
            seen.setdefault(n.id, n)
        return list(seen.values())

    def all_voters(self) -> list[VNode]:
        seen: dict[int, VNode] = {}
        for n in self.voters + (self.old_voters or []):
            seen.setdefault(n.id, n)
        return list(seen.values())

    def contains(self, node: VNode) -> bool:
        return any(n.id == node.id for n in self.all_nodes())

    def is_voter(self, node: VNode) -> bool:
        return any(n.id == node.id for n in self.all_voters())

    def majority(self, acked: set[int]) -> bool:
        """True when `acked` (node ids) is a majority of voters — and of the
        old voter set too while a joint configuration is active."""

        def maj(nodes: list[VNode]) -> bool:
            if not nodes:
                return True
            return len([n for n in nodes if n.id in acked]) * 2 > len(nodes)

        if not maj(self.voters):
            return False
        if self.old_voters is not None and not maj(self.old_voters):
            return False
        return True

    def enter_joint(self, new_voters: list[VNode]) -> "GroupConfiguration":
        return GroupConfiguration(
            voters=list(new_voters),
            learners=list(self.learners),
            old_voters=list(self.voters),
            revision=self.revision + 1,
        )

    def leave_joint(self) -> "GroupConfiguration":
        return GroupConfiguration(
            voters=list(self.voters),
            learners=list(self.learners),
            old_voters=None,
            revision=self.revision + 1,
        )

    # ------------------------------------------------------------ codec
    def encode(self) -> bytes:
        return json.dumps(
            {
                "voters": [[n.id, n.revision] for n in self.voters],
                "learners": [[n.id, n.revision] for n in self.learners],
                "old_voters": None
                if self.old_voters is None
                else [[n.id, n.revision] for n in self.old_voters],
                "revision": self.revision,
            }
        ).encode()

    @staticmethod
    def decode(buf: bytes) -> "GroupConfiguration":
        d = json.loads(bytes(buf).decode())
        mk = lambda pairs: [VNode(i, r) for i, r in pairs]
        return GroupConfiguration(
            voters=mk(d["voters"]),
            learners=mk(d["learners"]),
            old_voters=None if d["old_voters"] is None else mk(d["old_voters"]),
            revision=d["revision"],
        )


class ConfigurationManager:
    """Offset-ordered configuration history (configuration_manager.h)."""

    def __init__(self, initial: GroupConfiguration) -> None:
        self._history: list[tuple[int, GroupConfiguration]] = [(-1, initial)]

    def add(self, offset: int, cfg: GroupConfiguration) -> None:
        assert offset > self._history[-1][0], "configs must arrive in offset order"
        self._history.append((offset, cfg))

    def latest(self) -> GroupConfiguration:
        return self._history[-1][1]

    def latest_offset(self) -> int:
        return self._history[-1][0]

    def get(self, offset: int) -> GroupConfiguration:
        """Config active at `offset`."""
        ans = self._history[0][1]
        for off, cfg in self._history:
            if off <= offset:
                ans = cfg
            else:
                break
        return ans

    def truncate(self, offset: int) -> None:
        """Drop configs introduced at or after `offset` (log suffix truncate)."""
        self._history = [(o, c) for o, c in self._history if o < offset] or [
            (-1, GroupConfiguration())
        ]

    def prefix_truncate(self, offset: int) -> None:
        """Keep the newest config at or below `offset` as the base entry."""
        base = self.get(offset)
        self._history = [(-1, base)] + [(o, c) for o, c in self._history if o > offset]

    def configs_up_to(self, offset: int) -> int:
        """Number of configuration batches at offsets <= `offset` (for the
        kafka offset delta)."""
        return sum(1 for o, _ in self._history if 0 <= o <= offset)
