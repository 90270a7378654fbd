"""Group coordinator: manager + persistence + coordinator mapping.

Parity with kafka/server/group_manager.h:126-140 (attach/detach groups to
the group-metadata topic partitions, recovery on leadership), group_router
(shard routing by group → coordinator partition) and coordinator_ntp_mapper
(hash(group) % N over ``__consumer_offsets``). Group metadata and offset
commits are appended to the group topic partition the group maps to, and
recovered from it on startup — members are ephemeral (like the reference,
only offsets + group existence survive restart).

Record format (documented deviation: JSON values instead of the reference's
binary group-topic codec): key = {"t": "md"|"off"|"tomb", "g": group, ...},
value = payload.

(The JAX package's kafka/server/group_manager.py, copied.)
"""

from __future__ import annotations

import asyncio
import json
import logging

from redpanda_tpu_torch.hashing.xx import xxhash64
from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode as E
from redpanda_tpu_torch.kafka.server.group import Group, GroupState, OffsetCommit
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.models.record import Record, RecordBatch
from redpanda_tpu_torch.cluster.partition import ConsistencyLevel
from redpanda_tpu_torch.cluster.topic_table import TopicConfig

logger = logging.getLogger("rptpu.kafka.group_mgr")

GROUP_TOPIC = "__consumer_offsets"


class GroupManager:
    def __init__(self, broker, n_partitions: int = 16, expire_interval_s: float = 1.0):
        self.broker = broker
        self.n_partitions = n_partitions
        self.expire_interval_s = expire_interval_s
        self.groups: dict[str, Group] = {}
        self._expire_task: asyncio.Task | None = None
        self._started = False
        self._start_lock = asyncio.Lock()
        # group-topic partitions whose failover replay is in flight (the
        # coordinator_load_in_progress window): idx -> generation token, so
        # an older replay finishing cannot reopen the gate a newer replay
        # (re-gained leadership) still holds. Strong refs keep tasks alive.
        self._loading: dict[int, object] = {}
        self._recover_tasks: set[asyncio.Task] = set()

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> "GroupManager":
        async with self._start_lock:
            if self._started:
                return self
            if not self.broker.topic_table.contains(GROUP_TOPIC):
                try:
                    await self.broker.create_topic(
                        TopicConfig(
                            GROUP_TOPIC,
                            self.n_partitions,
                            self.broker.config.default_replication,
                            cleanup_policy="compact",
                        )
                    )
                except ValueError:
                    pass  # concurrent create
            # the topic may predate us (restart recovery, another node's
            # create): group→partition hashing must follow its REAL count or
            # most coordinator lookups point at nonexistent partitions
            md = self.broker.topic_table.get(GROUP_TOPIC)
            if md is not None:
                self.n_partitions = md.config.partition_count
            await self._recover()
            self._expire_task = asyncio.create_task(self._expire_loop())
            self._started = True
            return self

    async def stop(self) -> None:
        if self._expire_task is not None:
            self._expire_task.cancel()
            try:
                await self._expire_task
            except asyncio.CancelledError:
                pass
            self._expire_task = None
        for g in self.groups.values():
            g.shutdown()
        self.groups.clear()
        self._started = False

    async def _expire_loop(self) -> None:
        while True:
            await asyncio.sleep(self.expire_interval_s)
            for g in list(self.groups.values()):
                try:
                    if g.expire_members() and g.state == GroupState.empty:
                        await self._persist_group(g)
                except Exception:
                    logger.exception("expiry failed for group %s", g.group_id)

    # ------------------------------------------------------------ mapping
    def partition_for(self, group_id: str) -> int:
        return xxhash64(group_id.encode()) % self.n_partitions

    def coordinator_ntp(self, group_id: str) -> NTP:
        return NTP.kafka(GROUP_TOPIC, self.partition_for(group_id))

    def is_coordinator(self, group_id: str) -> bool:
        idx = self.partition_for(group_id)
        if idx in self._loading:
            # Failover replay in flight: serving group requests now would
            # expose empty state and let live commits interleave with the
            # replay (the reference's coordinator_load_in_progress window —
            # clients re-discover and retry on not_coordinator).
            return False
        p = self.broker.get_partition(GROUP_TOPIC, idx)
        return p is not None and p.is_leader()

    # ------------------------------------------------------------ groups
    async def get_or_create(self, group_id: str) -> Group | None:
        """None when this broker is not the group's coordinator."""
        await self.start()
        if not self.is_coordinator(group_id):
            return None
        g = self.groups.get(group_id)
        if g is None or g.state == GroupState.dead:
            g = Group(group_id, on_change=self._persist_group)
            self.groups[group_id] = g
        return g

    def get(self, group_id: str) -> Group | None:
        return self.groups.get(group_id)

    async def delete_group(self, group_id: str) -> E:
        g = self.groups.get(group_id)
        if g is None:
            return E.invalid_group_id if not self.is_coordinator(group_id) else E.group_id_not_found
        if not g.can_delete():
            return E.non_empty_group
        g.shutdown()
        del self.groups[group_id]
        await self._append(group_id, [
            Record(key=self._key("tomb", group_id), value=None)
        ])
        return E.none

    # ------------------------------------------------------------ offsets api
    async def commit_offsets(
        self, group_id: str, member_id: str, generation_id: int,
        commits: dict[tuple[str, int], OffsetCommit],
        *, trusted: bool = False,
    ) -> E:
        g = await self.get_or_create(group_id)
        if g is None:
            return E.not_coordinator
        code = g.commit_offsets(member_id, generation_id, commits, trusted=trusted)
        if code == E.none and commits:
            records = [
                Record(
                    offset_delta=i,
                    key=self._key("off", group_id, topic=t, partition=p),
                    value=json.dumps(
                        {"o": oc.offset, "e": oc.leader_epoch, "m": oc.metadata}
                    ).encode(),
                )
                for i, ((t, p), oc) in enumerate(commits.items())
            ]
            await self._append(group_id, records)
        return code

    # ------------------------------------------------------------ persistence
    def _key(self, t: str, group: str, topic: str | None = None, partition: int | None = None) -> bytes:
        k: dict = {"t": t, "g": group}
        if topic is not None:
            k["topic"], k["partition"] = topic, partition
        return json.dumps(k, separators=(",", ":")).encode()

    async def _persist_group(self, g: Group) -> None:
        md = {
            "protocol_type": g.protocol_type,
            "generation": g.generation,
            "protocol": g.protocol,
            "leader": g.leader,
            "state": g.state.value,
        }
        await self._append(
            g.group_id,
            [Record(key=self._key("md", g.group_id), value=json.dumps(md).encode())],
        )

    async def _append(self, group_id: str, records: list[Record]) -> None:
        p = self.broker.get_partition(GROUP_TOPIC, self.partition_for(group_id))
        if p is None or not p.is_leader():
            raise RuntimeError(f"not coordinator for {group_id}")
        batch = RecordBatch.build(records)
        await p.replicate([batch], ConsistencyLevel.quorum_ack)

    async def _recover(self) -> None:
        """Rebuild group existence + offsets from the group topic
        (group_manager recovery on coordinator leadership)."""
        md = self.broker.topic_table.get(GROUP_TOPIC)
        if md is None:
            return
        for idx in md.assignments:
            await self.recover_partition(idx)
        if self.groups:
            logger.info("recovered %d groups", len(self.groups))

    async def recover_partition(self, idx: int) -> None:
        """Replay one group-topic partition into coordinator state.

        Called at start for every local partition AND whenever this node
        GAINS leadership of a group partition (the reference's
        group_manager handle_leader_change -> recovery, group_manager.cc):
        after a coordinator dies, the new leader must rebuild that
        partition's groups/offsets from the replicated log or committed
        offsets silently vanish for every group hashed onto it."""
        p = self.broker.get_partition(GROUP_TOPIC, idx)
        if p is None:
            return
        offset = p.start_offset
        hwm = p.high_watermark
        while offset < hwm:
            batches = await p.make_reader(offset, 1 << 20)
            if not batches:
                break
            for b in batches:
                for rec in b.records():
                    self._apply_recovered(rec)
                offset = b.last_offset + 1

    def on_leadership_gained(self, idx: int) -> None:
        """Sync notification hook (raft leadership callback): gate the
        partition and schedule the replay; no-op before start (start()
        replays everything anyway). Strong task refs are kept — a bare
        create_task result can be GC'd before it runs — and failures are
        retried, then surfaced in the log rather than swallowed."""
        if not self._started:
            return
        token = object()
        self._loading[idx] = token
        task = asyncio.create_task(self._recover_gated(idx, token))
        self._recover_tasks.add(task)
        task.add_done_callback(self._recover_tasks.discard)

    async def _recover_gated(self, idx: int, token: object) -> None:
        for attempt in (1, 2, 3):
            try:
                await self.recover_partition(idx)
                if self._loading.get(idx) is token:
                    del self._loading[idx]  # only OUR generation reopens
                return
            except Exception:
                logger.exception(
                    "group partition %d failover replay failed "
                    "(attempt %d/3)", idx, attempt,
                )
                await asyncio.sleep(0.5)
        # All attempts failed: STAY GATED — answering not_coordinator keeps
        # clients retrying elsewhere/later; serving empty state would
        # silently reset committed offsets.
        logger.error(
            "group partition %d replay failed permanently; coordinator "
            "stays unavailable for its groups", idx,
        )

    def _apply_recovered(self, rec: Record) -> None:
        try:
            k = json.loads(rec.key.decode())
        except Exception:
            return
        gid = k.get("g")
        if k.get("t") == "tomb":
            g = self.groups.pop(gid, None)
            if g is not None:
                g.shutdown()
            return
        g = self.groups.get(gid)
        if g is None:
            g = Group(gid, on_change=self._persist_group)
            self.groups[gid] = g
        if k["t"] == "off" and rec.value:
            v = json.loads(rec.value.decode())
            g.offsets[(k["topic"], k["partition"])] = OffsetCommit(
                v["o"], v.get("e", -1), v.get("m")
            )
        elif k["t"] == "md" and rec.value:
            v = json.loads(rec.value.decode())
            g.protocol_type = v.get("protocol_type")
            g.generation = v.get("generation", 0)
