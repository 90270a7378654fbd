"""Consumer group state machine.

Parity with kafka/server/group.h + group.cc (2,254 LoC in the reference):
states {Empty, PreparingRebalance, CompletingRebalance, Stable, Dead}, the
join/sync rebalance barrier with deferred responses, heartbeat-driven
liveness, protocol selection, and the per-group committed-offset map.
Persistence hooks (group metadata + offset commits into the group topic)
are injected by the GroupManager so this stays a pure state machine.

(The JAX package's kafka/server/group.py, copied.)
"""

from __future__ import annotations

import asyncio
import enum
import logging
import time
import uuid
from dataclasses import dataclass, field

from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode as E

logger = logging.getLogger("rptpu.kafka.group")


class GroupState(enum.Enum):
    empty = "Empty"
    preparing_rebalance = "PreparingRebalance"
    completing_rebalance = "CompletingRebalance"
    stable = "Stable"
    dead = "Dead"


@dataclass
class Member:
    member_id: str
    group_instance_id: str | None
    client_id: str
    client_host: str
    session_timeout_ms: int
    rebalance_timeout_ms: int
    protocol_type: str
    protocols: list[tuple[str, bytes]]
    assignment: bytes = b""
    last_heartbeat: float = field(default_factory=time.monotonic)
    # deferred response futures (group.cc join/sync response callbacks)
    join_future: asyncio.Future | None = None
    sync_future: asyncio.Future | None = None

    def protocol_names(self) -> set[str]:
        return {name for name, _ in self.protocols}

    def metadata_for(self, protocol: str) -> bytes:
        for name, md in self.protocols:
            if name == protocol:
                return md
        return b""


@dataclass
class OffsetCommit:
    offset: int
    leader_epoch: int = -1
    metadata: str | None = None
    commit_ts: float = field(default_factory=time.time)


class Group:
    def __init__(
        self, group_id: str, on_change=None, initial_rebalance_delay_s: float = 0.2
    ) -> None:
        """initial_rebalance_delay_s mirrors group.initial.rebalance.delay.ms
        (3s in upstream kafka, shortened here): a brand-new group lingers in
        PreparingRebalance so a burst of founding members lands in one
        generation instead of N."""
        self.group_id = group_id
        self.initial_rebalance_delay_s = initial_rebalance_delay_s
        self.state = GroupState.empty
        self.generation = 0
        self.protocol_type: str | None = None
        self.protocol: str | None = None
        self.leader: str | None = None
        self.members: dict[str, Member] = {}
        self.offsets: dict[tuple[str, int], OffsetCommit] = {}
        self._rebalance_task: asyncio.Task | None = None
        self._on_change = on_change  # async callable(group) -> persist hook
        # members that joined the CURRENT rebalance round
        self._joined: set[str] = set()

    # ------------------------------------------------------------ helpers
    def _new_member_id(self, client_id: str) -> str:
        return f"{client_id or 'member'}-{uuid.uuid4()}"

    def in_states(self, *states: GroupState) -> bool:
        return self.state in states

    def _select_protocol(self) -> str:
        """Pick the protocol every member supports (vote by join order)."""
        if not self.members:
            return ""
        common = set.intersection(*(m.protocol_names() for m in self.members.values()))
        if not common:
            return ""
        # first listed preference of the leader-ish first member that's common
        for name, _ in next(iter(self.members.values())).protocols:
            if name in common:
                return name
        return sorted(common)[0]

    async def _notify_change(self) -> None:
        if self._on_change is not None:
            try:
                await self._on_change(self)
            except Exception:
                logger.exception("group %s persistence hook failed", self.group_id)

    # ------------------------------------------------------------ join
    async def join(
        self,
        member_id: str,
        group_instance_id: str | None,
        client_id: str,
        client_host: str,
        session_timeout_ms: int,
        rebalance_timeout_ms: int,
        protocol_type: str,
        protocols: list[tuple[str, bytes]],
    ) -> dict:
        if self.state == GroupState.dead:
            return self._join_error(member_id, E.coordinator_not_available)
        if self.protocol_type is not None and self.members and protocol_type != self.protocol_type:
            return self._join_error(member_id, E.inconsistent_group_protocol)
        if member_id and member_id not in self.members:
            return self._join_error(member_id, E.unknown_member_id)

        if not member_id:
            member_id = self._new_member_id(client_id)
            member = Member(
                member_id, group_instance_id, client_id, client_host,
                session_timeout_ms, rebalance_timeout_ms if rebalance_timeout_ms > 0 else session_timeout_ms,
                protocol_type, protocols,
            )
            self.members[member_id] = member
            self.protocol_type = protocol_type
        else:
            member = self.members[member_id]
            member.protocols = protocols
            member.session_timeout_ms = session_timeout_ms
            member.rebalance_timeout_ms = (
                rebalance_timeout_ms if rebalance_timeout_ms > 0 else session_timeout_ms
            )
            member.last_heartbeat = time.monotonic()

        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        old = member.join_future
        if old is not None and not old.done():
            # superseded join (client retried): answer the old one
            old.set_result(self._join_error(member_id, E.unknown_member_id))
        member.join_future = fut
        self._joined.add(member_id)

        self._prepare_rebalance()
        return await fut

    def _join_error(self, member_id: str, code: E) -> dict:
        return {
            "error_code": int(code),
            "generation_id": -1,
            "protocol_name": "",
            "leader": "",
            "member_id": member_id,
            "members": [],
        }

    def _prepare_rebalance(self) -> None:
        if self.state == GroupState.preparing_rebalance:
            self._maybe_complete_join()
            return
        self.state = GroupState.preparing_rebalance
        # kick pending syncs back to re-join (rebalance interrupts them)
        for m in self.members.values():
            if m.sync_future is not None and not m.sync_future.done():
                m.sync_future.set_result(
                    {"error_code": int(E.rebalance_in_progress), "assignment": b""}
                )
                m.sync_future = None
        if self._rebalance_task is None or self._rebalance_task.done():
            self._rebalance_task = asyncio.create_task(self._rebalance_timer())
        self._maybe_complete_join()

    def _rebalance_timeout_s(self) -> float:
        if not self.members:
            return 0.3
        return max(m.rebalance_timeout_ms for m in self.members.values()) / 1000.0

    async def _rebalance_timer(self) -> None:
        """Completes the join phase when every member rejoined or the
        rebalance timeout expires (whichever first). New groups also wait
        out the initial rebalance delay."""
        now = time.monotonic()
        deadline = now + self._rebalance_timeout_s()
        earliest = now + (self.initial_rebalance_delay_s if self.generation == 0 else 0)
        try:
            while time.monotonic() < deadline:
                if self.state != GroupState.preparing_rebalance:
                    return
                if time.monotonic() >= earliest and self._all_joined():
                    break
                await asyncio.sleep(0.02)
            if self.state == GroupState.preparing_rebalance:
                self._complete_join(evict_stragglers=True)
        except asyncio.CancelledError:
            pass

    def _all_joined(self) -> bool:
        return bool(self.members) and all(
            m.join_future is not None and not m.join_future.done()
            for m in self.members.values()
        )

    def _maybe_complete_join(self) -> None:
        # brand-new groups (generation 0) ride out the initial rebalance
        # delay in the timer; established groups fast-complete on full rejoin
        if (
            self.state == GroupState.preparing_rebalance
            and self.generation > 0
            and self._all_joined()
        ):
            self._complete_join()

    def _complete_join(self, evict_stragglers: bool = False) -> None:
        if evict_stragglers:
            for mid in list(self.members):
                m = self.members[mid]
                if m.join_future is None or m.join_future.done():
                    del self.members[mid]
        if not self.members:
            self.state = GroupState.empty
            self.generation += 1
            self._joined.clear()
            return
        self.generation += 1
        self.protocol = self._select_protocol()
        if self.leader not in self.members:
            self.leader = next(iter(self.members))
        members_for_leader = [
            {
                "member_id": m.member_id,
                "group_instance_id": m.group_instance_id,
                "metadata": m.metadata_for(self.protocol),
            }
            for m in self.members.values()
        ]
        self.state = GroupState.completing_rebalance
        self._joined.clear()
        for m in self.members.values():
            fut, m.join_future = m.join_future, None
            if fut is None or fut.done():
                continue
            fut.set_result(
                {
                    "error_code": 0,
                    "generation_id": self.generation,
                    "protocol_name": self.protocol or "",
                    "leader": self.leader,
                    "member_id": m.member_id,
                    "members": members_for_leader if m.member_id == self.leader else [],
                }
            )

    # ------------------------------------------------------------ sync
    async def sync(
        self, member_id: str, generation_id: int, assignments: list[dict]
    ) -> dict:
        if self.state == GroupState.dead:
            return {"error_code": int(E.coordinator_not_available), "assignment": b""}
        if member_id not in self.members:
            return {"error_code": int(E.unknown_member_id), "assignment": b""}
        if generation_id != self.generation:
            return {"error_code": int(E.illegal_generation), "assignment": b""}
        if self.state == GroupState.preparing_rebalance:
            return {"error_code": int(E.rebalance_in_progress), "assignment": b""}
        member = self.members[member_id]
        member.last_heartbeat = time.monotonic()
        if self.state == GroupState.stable:
            return {"error_code": 0, "assignment": member.assignment}
        # completing_rebalance: leader's sync distributes the assignments
        if member_id == self.leader:
            by_member = {a["member_id"]: a["assignment"] for a in assignments}
            for mid, m in self.members.items():
                m.assignment = by_member.get(mid, b"")
            self.state = GroupState.stable
            await self._notify_change()
            for m in self.members.values():
                if m.sync_future is not None and not m.sync_future.done():
                    m.sync_future.set_result(
                        {"error_code": 0, "assignment": m.assignment}
                    )
                    m.sync_future = None
            return {"error_code": 0, "assignment": member.assignment}
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        member.sync_future = fut
        return await fut

    # ------------------------------------------------------------ heartbeat / leave
    def heartbeat(self, member_id: str, generation_id: int) -> E:
        if self.state == GroupState.dead:
            return E.coordinator_not_available
        if member_id not in self.members:
            return E.unknown_member_id
        if generation_id != self.generation:
            return E.illegal_generation
        self.members[member_id].last_heartbeat = time.monotonic()
        if self.state == GroupState.preparing_rebalance:
            return E.rebalance_in_progress
        return E.none

    async def leave(self, member_ids: list[str]) -> list[tuple[str, E]]:
        out = []
        changed = False
        for mid in member_ids:
            if mid in self.members:
                self._remove_member(mid)
                changed = True
                out.append((mid, E.none))
            else:
                out.append((mid, E.unknown_member_id))
        if changed:
            if self.members:
                self._prepare_rebalance()
            else:
                self.state = GroupState.empty
                await self._notify_change()
        return out

    def _remove_member(self, member_id: str) -> None:
        m = self.members.pop(member_id, None)
        if m is None:
            return
        for fut in (m.join_future, m.sync_future):
            if fut is not None and not fut.done():
                fut.set_result(
                    {"error_code": int(E.unknown_member_id), "assignment": b"",
                     "generation_id": -1, "protocol_name": "", "leader": "",
                     "member_id": member_id, "members": []}
                )

    def expire_members(self) -> bool:
        """Session-timeout eviction; True when membership changed."""
        now = time.monotonic()
        expired = [
            mid
            for mid, m in self.members.items()
            if (m.join_future is None or m.join_future.done())
            and now - m.last_heartbeat > m.session_timeout_ms / 1000.0
        ]
        for mid in expired:
            logger.info("group %s: member %s session timed out", self.group_id, mid)
            self._remove_member(mid)
        if expired:
            if self.members:
                self._prepare_rebalance()
            else:
                self.state = GroupState.empty
        return bool(expired)

    # ------------------------------------------------------------ offsets
    def commit_offsets(
        self,
        member_id: str,
        generation_id: int,
        commits: dict[tuple[str, int], OffsetCommit],
        *,
        trusted: bool = False,
    ) -> E:
        if self.state == GroupState.dead:
            return E.coordinator_not_available
        if member_id == "" and generation_id < 0:
            # Simple (non-group) offset storage: only allowed while the
            # group is Empty (the reference rejects generation<0 commits
            # against a live group, group.cc:1920) — otherwise a stray
            # non-member client could overwrite a stable group's offsets.
            # `trusted` is the internal path (tx coordinator applying
            # staged offsets at commit time), which bypasses the check.
            if trusted or self.state == GroupState.empty:
                self.offsets.update(commits)
                return E.none
            return E.illegal_generation
        if member_id not in self.members:
            return E.unknown_member_id
        if generation_id != self.generation:
            return E.illegal_generation
        if self.state == GroupState.completing_rebalance:
            return E.rebalance_in_progress
        self.members[member_id].last_heartbeat = time.monotonic()
        self.offsets.update(commits)
        return E.none

    def fetch_offset(self, topic: str, partition: int) -> OffsetCommit | None:
        return self.offsets.get((topic, partition))

    # ------------------------------------------------------------ admin views
    def can_delete(self) -> bool:
        return self.state in (GroupState.empty, GroupState.dead)

    def shutdown(self) -> None:
        self.state = GroupState.dead
        if self._rebalance_task is not None:
            self._rebalance_task.cancel()
        for mid in list(self.members):
            self._remove_member(mid)

    def describe(self) -> dict:
        return {
            "error_code": 0,
            "group_id": self.group_id,
            "group_state": self.state.value,
            "protocol_type": self.protocol_type or "",
            "protocol_data": self.protocol or "",
            "members": [
                {
                    "member_id": m.member_id,
                    # v4+ exposes static membership; the encoder drops the
                    # key below that version
                    "group_instance_id": m.group_instance_id,
                    "client_id": m.client_id,
                    "client_host": m.client_host,
                    "member_metadata": m.metadata_for(self.protocol or ""),
                    "member_assignment": m.assignment,
                }
                for m in self.members.values()
            ],
        }
