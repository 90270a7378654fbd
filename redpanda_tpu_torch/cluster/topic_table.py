"""Topic metadata table (the JAX package's cluster/topic_table.py, copied).

Parity with cluster::topic_table (cluster/topic_table.h): the in-memory
source of truth for topic/partition metadata plus a delta stream consumed by
reconciliation (controller_backend.cc:202). In single-node mode mutations
are applied locally; once the controller lands, mutations arrive as applied
controller commands.
"""

from __future__ import annotations

import asyncio
import enum
from dataclasses import dataclass, field

from redpanda_tpu_torch.models.fundamental import NTP, DEFAULT_NAMESPACE, NodeId


@dataclass
class TopicConfig:
    name: str
    partition_count: int
    replication_factor: int = 1
    ns: str = DEFAULT_NAMESPACE
    cleanup_policy: str = "delete"
    retention_bytes: int | None = None
    retention_ms: int | None = None
    delete_retention_ms: int | None = None  # tombstone retention (compact)
    segment_size: int | None = None
    compression: str = "producer"
    # incarnation id: bumped on recreate so tiered-storage object paths
    # never collide with a deleted topic's uploads (partition_path _<rev>)
    revision: int = 0
    extra: dict[str, str] = field(default_factory=dict)

    def log_overrides(self, base):
        """Per-topic storage knobs → a LogConfig for this topic's logs
        (log_config overrides in log_manager::manage). Kafka's -1 sentinel
        means UNLIMITED retention, never 'delete everything'."""
        import dataclasses

        overrides = {}
        if self.segment_size is not None and self.segment_size > 0:
            overrides["max_segment_size"] = self.segment_size
        if self.retention_bytes is not None and self.retention_bytes >= 0:
            overrides["retention_bytes"] = self.retention_bytes
        if self.retention_ms is not None and self.retention_ms >= 0:
            overrides["retention_ms"] = self.retention_ms
        if self.cleanup_policy != "delete":
            overrides["cleanup_policy"] = self.cleanup_policy
        if self.delete_retention_ms is not None:
            overrides["delete_retention_ms"] = self.delete_retention_ms
        return dataclasses.replace(base, **overrides) if overrides else None

    def apply_override(self, key: str, value: str | None) -> None:
        """Kafka config key → typed field (alter_configs / controller
        update_topic_properties apply path)."""
        if value is None:
            return
        if key == "cleanup.policy":
            self.cleanup_policy = value
        elif key == "retention.bytes":
            self.retention_bytes = int(value)
        elif key == "retention.ms":
            self.retention_ms = int(value)
        elif key == "delete.retention.ms":
            self.delete_retention_ms = int(value)
        elif key == "segment.bytes":
            self.segment_size = int(value)
        elif key == "compression.type":
            self.compression = value
        else:
            self.extra[key] = value

    def config_map(self) -> dict[str, str | None]:
        m: dict[str, str | None] = {
            "cleanup.policy": self.cleanup_policy,
            "compression.type": self.compression,
            "retention.bytes": None if self.retention_bytes is None else str(self.retention_bytes),
            "retention.ms": None if self.retention_ms is None else str(self.retention_ms),
        }
        if self.segment_size is not None:
            m["segment.bytes"] = str(self.segment_size)
        m.update(self.extra)
        return m


@dataclass
class PartitionAssignment:
    ntp: NTP
    replicas: list[NodeId]
    leader: NodeId | None = None
    # raft group id, allocated by the controller leader and carried in the
    # create command so the apply is deterministic on every node
    # (cluster/partition_assignment.h `group`); -1 = single-node direct log.
    group: int = -1
    # replica set being moved to, while a move_partition_replicas is in
    # flight (topic_table in_progress updates)
    moving_to: list[NodeId] | None = None


@dataclass
class TopicMetadata:
    config: TopicConfig
    assignments: dict[int, PartitionAssignment] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.config.name


class DeltaType(enum.IntEnum):
    added = 0
    removed = 1
    updated = 2


@dataclass
class TopicDelta:
    type: DeltaType
    ntp: NTP
    assignment: PartitionAssignment | None = None


class TopicTable:
    def __init__(self):
        self._topics: dict[str, TopicMetadata] = {}
        self._waiters: list[asyncio.Future] = []
        self._deltas: list[TopicDelta] = []

    # ------------------------------------------------------------ mutate
    def add_topic(self, config: TopicConfig, replicas_for=lambda p: [0]) -> TopicMetadata:
        if config.name in self._topics:
            raise ValueError(f"topic exists: {config.name}")
        md = TopicMetadata(config)
        for p in range(config.partition_count):
            ntp = NTP(config.ns, config.name, p)
            reps = list(replicas_for(p))
            md.assignments[p] = PartitionAssignment(ntp, reps, leader=reps[0] if reps else None)
            self._push_delta(TopicDelta(DeltaType.added, ntp, md.assignments[p]))
        self._topics[config.name] = md
        return md

    def remove_topic(self, name: str) -> TopicMetadata:
        md = self._topics.pop(name)
        for pa in md.assignments.values():
            self._push_delta(TopicDelta(DeltaType.removed, pa.ntp))
        return md

    def add_partitions(self, name: str, new_count: int, replicas_for=lambda p: [0]) -> None:
        md = self._topics[name]
        old = md.config.partition_count
        if new_count <= old:
            raise ValueError("partition count can only grow")
        for p in range(old, new_count):
            ntp = NTP(md.config.ns, name, p)
            reps = list(replicas_for(p))
            md.assignments[p] = PartitionAssignment(ntp, reps, leader=reps[0] if reps else None)
            self._push_delta(TopicDelta(DeltaType.added, ntp, md.assignments[p]))
        md.config.partition_count = new_count

    def apply_create(self, config: TopicConfig, assignments: list[PartitionAssignment]) -> TopicMetadata:
        """Deterministic apply of a replicated create_topic command: the
        assignments (incl. raft group ids) were fixed by the leader.

        A DUPLICATE create in the log (two brokers raced the same name past
        the leader's pre-check; both commands committed) applies as a no-op
        keeping the FIRST winner's assignments — the command sits in the
        log forever, so raising here would also fail every restart replay."""
        if config.name in self._topics:
            import logging

            logging.getLogger("rptorch.cluster.topics").info(
                "ignoring duplicate create for existing topic %r", config.name
            )
            return self._topics[config.name]
        md = TopicMetadata(config)
        for pa in assignments:
            md.assignments[pa.ntp.partition] = pa
            self._push_delta(TopicDelta(DeltaType.added, pa.ntp, pa))
        config.partition_count = len(assignments)
        self._topics[config.name] = md
        return md

    def apply_add_partitions(self, name: str, assignments: list[PartitionAssignment]) -> None:
        md = self._topics[name]
        for pa in assignments:
            md.assignments[pa.ntp.partition] = pa
            self._push_delta(TopicDelta(DeltaType.added, pa.ntp, pa))
        md.config.partition_count = len(md.assignments)

    def update_properties(self, name: str, overrides: dict) -> None:
        md = self._topics[name]
        for k, v in overrides.items():
            md.config.apply_override(k, v)

    def begin_move(self, ntp: NTP, replicas: list[NodeId]) -> None:
        """move_partition_replicas: new set recorded, reconciliation begins
        (topic_table in-progress update + delta)."""
        pa = self._topics[ntp.topic].assignments[ntp.partition]
        pa.moving_to = list(replicas)
        self._push_delta(TopicDelta(DeltaType.updated, ntp, pa))

    def finish_move(self, ntp: NTP, replicas: list[NodeId]) -> None:
        """finish_moving_partition_replicas: the new replica set is caught
        up; old replicas can drop their copy."""
        pa = self._topics[ntp.topic].assignments[ntp.partition]
        pa.replicas = list(replicas)
        pa.moving_to = None
        self._push_delta(TopicDelta(DeltaType.updated, ntp, pa))

    def set_leader(self, ntp: NTP, leader: NodeId | None) -> None:
        md = self._topics.get(ntp.topic)
        if md and ntp.partition in md.assignments:
            md.assignments[ntp.partition].leader = leader
            self._push_delta(TopicDelta(DeltaType.updated, ntp, md.assignments[ntp.partition]))

    # ------------------------------------------------------------ query
    def get(self, name: str) -> TopicMetadata | None:
        return self._topics.get(name)

    def contains(self, name: str) -> bool:
        return name in self._topics

    def topics(self) -> dict[str, TopicMetadata]:
        return dict(self._topics)

    def all_ntps(self) -> list[NTP]:
        return [pa.ntp for md in self._topics.values() for pa in md.assignments.values()]

    # ------------------------------------------------------------ deltas
    def _push_delta(self, d: TopicDelta) -> None:
        self._deltas.append(d)
        waiters, self._waiters = self._waiters, []
        for w in waiters:
            if not w.done():
                w.set_result(None)

    def drain_deltas(self) -> list[TopicDelta]:
        out, self._deltas = self._deltas, []
        return out

    async def wait_for_deltas(self) -> list[TopicDelta]:
        if not self._deltas:
            fut = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
            await fut
        return self.drain_deltas()
