"""Partition facade + partition manager (the JAX package's
cluster/partition.py, copied; ``Partition.remote`` stays None until
``cloud_storage`` is ported).

Parity with cluster::partition (cluster/partition.h:34-69) and
cluster::partition_manager (partition_manager.cc:53): the partition is the
broker-facing handle for one replicated log — replicate / make_reader /
offsets — delegating to a consensus implementation. Single-node mode uses
``DirectConsensus`` (append straight to storage, always leader); the raft
layer plugs in behind the same interface.
"""

from __future__ import annotations

from dataclasses import dataclass

from redpanda_tpu_torch.models.fundamental import NTP, NodeId
from redpanda_tpu_torch.models.record import RecordBatch, RecordBatchType
from redpanda_tpu_torch.storage.log import DiskLog
from redpanda_tpu_torch.storage.log_manager import StorageApi


class ConsistencyLevel:
    """raft/types.h consistency levels."""

    quorum_ack = 0  # acks=-1
    leader_ack = 1  # acks=1
    no_ack = 2  # acks=0


@dataclass
class ReplicateResult:
    base_offset: int
    last_offset: int


class DirectConsensus:
    """Single-node consensus: the local log IS the replicated log.

    Mirrors the no-raft slice of SURVEY.md §7 step 3; replaced by
    raft.Consensus for replicated topics.
    """

    def __init__(self, log: DiskLog, node_id: NodeId, term: int = 0):
        self.log = log
        self.node_id = node_id
        self._term = term

    @property
    def term(self) -> int:
        return self._term

    def is_leader(self) -> bool:
        return True

    def leadership_settled(self) -> bool:
        return True  # no elections on a direct log

    @property
    def leader_id(self) -> NodeId | None:
        return self.node_id

    @property
    def committed_offset(self) -> int:
        return self.log.offsets().dirty_offset

    @property
    def last_stable_offset(self) -> int:
        return self.committed_offset + 1  # exclusive, kafka LSO convention

    @property
    def start_offset(self) -> int:
        return self.log.offsets().start_offset

    async def replicate(self, batches: list[RecordBatch], level: int) -> ReplicateResult:
        res = await self.log.append(batches, term=self._term)
        if level == ConsistencyLevel.quorum_ack:
            await self.log.flush()
        return ReplicateResult(res.base_offset, res.last_offset)

    async def make_reader(
        self, start: int, max_bytes: int, max_offset: int | None = None, type_filter=None
    ) -> list[RecordBatch]:
        return await self.log.read(
            start,
            max_bytes,
            max_offset=max_offset,
            type_filter=type_filter,
        )


class Partition:
    """Broker-facing partition handle (cluster/partition.h:34).

    Every offset crossing this boundary is a KAFKA offset: raft config
    batches occupy raw log offsets that clients must never see
    (offset_translator.h:11-26), so produce results, reader start/limits,
    watermarks, and fetched batch base offsets are all translated here.
    Raft and storage below this line speak raw log offsets.
    """

    def __init__(self, ntp: NTP, consensus, log: DiskLog, kvs=None):
        from redpanda_tpu_torch.cluster.offset_translator import OffsetTranslator

        self.ntp = ntp
        self.consensus = consensus
        self.log = log
        self.otl = OffsetTranslator(ntp, kvs)
        log.append_listeners.append(self.otl.observe)
        log.truncate_listeners.append(self.otl.truncate)
        self._otl_ready = False
        # tiered storage read side (cloud_storage.RemotePartition); serves
        # offsets below the local log start when attached
        self.remote = None

    async def start(self) -> "Partition":
        """Bootstrap the offset translator from kvstore + log scan."""
        if not self._otl_ready:
            await self.otl.bootstrap(self.log)
            self._otl_ready = True
        return self

    # -------------------------------------------------------------- state
    def is_leader(self) -> bool:
        return self.consensus.is_leader()

    def ready_for_reads(self) -> bool:
        """Leader AND settled (own-term entry committed): the read barrier
        consumers need for linearizable fetches right after an election."""
        settled = getattr(self.consensus, "leadership_settled", None)
        return self.is_leader() and (settled is None or settled())

    @property
    def leader_id(self) -> NodeId | None:
        return self.consensus.leader_id

    @property
    def term(self) -> int:
        return self.consensus.term

    def attach_remote(self, remote_partition) -> None:
        self.remote = remote_partition

    @property
    def start_offset(self) -> int:
        """Kafka-visible log start: extends back into tiered storage when a
        remote partition with uploaded data is attached."""
        local = self.otl.to_kafka_excl(self.consensus.start_offset)
        if self.remote is not None and self.remote.manifest.segments:
            return min(local, self.otl.to_kafka_excl(self.remote.start_offset))
        return local

    @property
    def high_watermark(self) -> int:
        """Exclusive next-offset convention, like kafka HWM."""
        return self.otl.to_kafka_excl(self.consensus.committed_offset + 1)

    @property
    def last_stable_offset(self) -> int:
        return self.otl.to_kafka_excl(self.consensus.last_stable_offset)

    # -------------------------------------------------------------- io
    async def replicate(self, batches: list[RecordBatch], level: int) -> ReplicateResult:
        res = await self.consensus.replicate(batches, level)
        base = getattr(res, "base_offset", None)
        if base is None:
            # raft's ReplicateResult carries only last_offset; offsets are
            # assigned contiguously, so the base falls out of the span
            span = sum(b.header.last_offset_delta + 1 for b in batches)
            base = res.last_offset - span + 1
        return ReplicateResult(
            self.otl.to_kafka(base), self.otl.to_kafka(res.last_offset)
        )

    async def make_reader(
        self, start: int, max_bytes: int = 1 << 20, max_offset: int | None = None
    ) -> list[RecordBatch]:
        """Read data batches in [start, max_offset] (kafka domain), re-based
        into kafka offsets. Safe to rewrite base_offset: the Kafka CRC
        covers attributes..records only."""
        if max_offset is None:
            max_offset = self.high_watermark - 1
        if start > max_offset:
            return []
        raft_start = self.otl.from_kafka(start)
        raft_max = self.otl.from_kafka(max_offset)
        batches: list[RecordBatch] = []
        if self.remote is not None and raft_start < self.consensus.start_offset:
            # tiered fall-through: the prefix lives only in the bucket
            batches = await self.remote.read(
                raft_start,
                max_bytes,
                max_offset=min(raft_max, self.consensus.start_offset - 1),
                type_filter=(RecordBatchType.raft_data,),
            )
            raft_start = self.consensus.start_offset
            max_bytes -= sum(b.size_bytes for b in batches)
        if max_bytes > 0 and raft_start <= raft_max:
            batches += await self.consensus.make_reader(
                raft_start,
                max_bytes,
                max_offset=raft_max,
                type_filter=(RecordBatchType.raft_data,),
            )
        out = []
        for b in batches:
            k = self.otl.to_kafka(b.base_offset)
            out.append(b.with_base_offset(k) if k != b.base_offset else b)
        return out

    async def timequery(self, ts: int) -> int | None:
        raft_off = await self.log.timequery(ts)
        return None if raft_off is None else self.otl.to_kafka(raft_off)

    async def prefix_truncate(self, offset: int) -> None:
        """offset is a kafka offset (DeleteRecords / archival housekeeping).

        The translator keeps its FULL gap history (no advance_base): evicted
        prefixes may still be served from tiered storage, and those reads
        need per-offset translation below the local start."""
        raft_off = self.otl.from_kafka(offset)
        await self.log.prefix_truncate(raft_off)


class PartitionManager:
    """Creates/looks up partitions over the storage api
    (cluster/partition_manager.cc:53 manage())."""

    def __init__(self, storage: StorageApi, node_id: NodeId):
        self.storage = storage
        self.node_id = node_id
        self._partitions: dict[NTP, Partition] = {}

    async def manage(self, ntp: NTP, *, term: int = 0, log_overrides=None) -> Partition:
        if ntp in self._partitions:
            return self._partitions[ntp]
        log = await self.storage.log_mgr.manage(ntp, overrides=log_overrides)
        consensus = DirectConsensus(log, self.node_id, term)
        p = await Partition(ntp, consensus, log, kvs=self.storage.kvs).start()
        self._partitions[ntp] = p
        return p

    def attach(self, ntp: NTP, partition: Partition) -> None:
        """Register an externally built partition (raft-backed)."""
        self._partitions[ntp] = partition

    def detach(self, ntp: NTP) -> Partition | None:
        """Unregister without touching storage (raft-backed partitions: the
        group manager owns the log teardown)."""
        return self._partitions.pop(ntp, None)

    def get(self, ntp: NTP) -> Partition | None:
        return self._partitions.get(ntp)

    def partitions(self) -> dict[NTP, Partition]:
        return dict(self._partitions)

    async def remove(self, ntp: NTP) -> None:
        p = self._partitions.pop(ntp, None)
        if p is not None:
            await self.storage.log_mgr.remove(ntp)
