"""Partition leaders table.

Parity with cluster/partition_leaders_table.h: the per-node cache of who
leads each partition, fed locally by raft leadership notifications and
remotely by metadata dissemination gossip. Waiters let the kafka layer block
until a leader is known (e.g. right after topic creation).

(The JAX package's cluster/leaders_table.py, copied.)
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from redpanda_tpu_torch.models.fundamental import NTP, NodeId, Term


@dataclass
class LeaderInfo:
    leader: NodeId | None
    term: Term


class PartitionLeadersTable:
    def __init__(self) -> None:
        self._leaders: dict[NTP, LeaderInfo] = {}
        self._waiters: dict[NTP, list[asyncio.Future]] = {}

    def update(self, ntp: NTP, leader: NodeId | None, term: Term) -> None:
        cur = self._leaders.get(ntp)
        if cur is not None and term < cur.term:
            return  # stale gossip
        if (
            cur is not None
            and term == cur.term
            and leader is None
            and cur.leader is not None
        ):
            # A deposed leader gossips (None, term N) while the term-N
            # winner gossips (winner, term N): raft guarantees ONE leader
            # per term, so known always beats unknown within a term —
            # otherwise arrival order could blank the winner's entry
            # (observed: every node missing exactly the partitions it
            # leads itself).
            return
        self._leaders[ntp] = LeaderInfo(leader, term)
        if leader is not None:
            for fut in self._waiters.pop(ntp, []):
                if not fut.done():
                    fut.set_result(leader)

    def remove(self, ntp: NTP) -> None:
        self._leaders.pop(ntp, None)
        for fut in self._waiters.pop(ntp, []):
            if not fut.done():
                fut.cancel()

    def get_leader(self, ntp: NTP) -> NodeId | None:
        info = self._leaders.get(ntp)
        return info.leader if info else None

    def get_term(self, ntp: NTP) -> Term:
        info = self._leaders.get(ntp)
        return info.term if info else -1

    async def wait_for_leader(self, ntp: NTP, timeout: float = 5.0) -> NodeId:
        leader = self.get_leader(ntp)
        if leader is not None:
            return leader
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(ntp, []).append(fut)
        return await asyncio.wait_for(fut, timeout)

    def snapshot(self) -> dict[NTP, LeaderInfo]:
        return dict(self._leaders)
