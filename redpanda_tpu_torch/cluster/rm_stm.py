"""Per-partition producer / transaction state machine.

Parity with cluster/rm_stm.h:45 + rm_stm.cc (1,388 LoC in the reference):
idempotent-producer sequence tracking, open-transaction ranges, commit/abort
control markers written to the log, aborted-range tracking for
read_committed fetches, and the last-stable-offset (LSO) clamp. State is
rebuilt by scanning the log on open (the reference snapshots via
persisted_stm at an offset and replays the suffix; a full scan is the
bootstrap path here, with the same replay logic).

(The JAX package's cluster/rm_stm.py, copied.)
"""

from __future__ import annotations

import logging
import struct
from dataclasses import dataclass, field

from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode as E
from redpanda_tpu_torch.models.record import Record, RecordBatch

logger = logging.getLogger("rptpu.cluster.rm_stm")

# Kafka control-record key: version int16, type int16 (0 = abort, 1 = commit)
_ABORT_MARKER = 0
_COMMIT_MARKER = 1


def make_control_marker(
    marker_type: int, producer_id: int, producer_epoch: int, coordinator_epoch: int = 0
) -> RecordBatch:
    key = struct.pack(">hh", 0, marker_type)
    value = struct.pack(">hi", 0, coordinator_epoch)
    return RecordBatch.build(
        [Record(key=key, value=value)],
        producer_id=producer_id,
        producer_epoch=producer_epoch,
        transactional=True,
        control=True,
    )


def parse_control_marker(batch: RecordBatch) -> int | None:
    """Returns the marker type, or None when not a control batch."""
    if not batch.header.is_control:
        return None
    recs = batch.records()
    if not recs or recs[0].key is None or len(recs[0].key) < 4:
        return None
    (_version, mtype) = struct.unpack_from(">hh", recs[0].key, 0)
    return mtype


@dataclass
class ProducerState:
    epoch: int
    last_seq: int = -1


@dataclass
class AbortedTx:
    producer_id: int
    first_offset: int
    last_offset: int


class RmStm:
    """Attached to one partition by the broker (partition.h stm hooks)."""

    def __init__(self, partition) -> None:
        self.partition = partition
        self._producers: dict[int, ProducerState] = {}
        # pid -> first offset of the open transaction on THIS partition
        self._ongoing: dict[int, int] = {}
        # pids whose AddPartitionsToTxn arrived but no data yet (tx_fence)
        self._pending_begin: set[int] = set()
        self._aborted: list[AbortedTx] = []
        self._recovered = False
        self._recover_lock = None  # lazily created (needs a running loop)
        self._lock = None  # produce-path critical section, lazily created

    # ------------------------------------------------------------ recovery
    async def ensure_recovered(self) -> "RmStm":
        import asyncio

        if self._recovered:
            return self
        if self._recover_lock is None:
            self._recover_lock = asyncio.Lock()
        async with self._recover_lock:
            if not self._recovered:
                await self.recover()
                self._recovered = True
        return self

    async def recover(self) -> None:
        """Replay the log to rebuild producer/tx state (persisted_stm
        bootstrap; full-scan variant)."""
        start = self.partition.start_offset
        hwm = self.partition.high_watermark
        offset = start
        while offset < hwm:
            batches = await self.partition.make_reader(offset, 4 << 20)
            if not batches:
                break
            for b in batches:
                self._apply(b)
                offset = b.last_offset + 1

    def _apply(self, batch: RecordBatch) -> None:
        hdr = batch.header
        pid = hdr.producer_id
        if pid < 0:
            return
        mtype = parse_control_marker(batch)
        if mtype is not None:
            first = self._ongoing.pop(pid, None)
            if mtype == _ABORT_MARKER and first is not None:
                self._aborted.append(AbortedTx(pid, first, hdr.base_offset))
            return
        st = self._producers.get(pid)
        if st is None or hdr.producer_epoch > st.epoch:
            st = ProducerState(hdr.producer_epoch)
            self._producers[pid] = st
        if hdr.base_sequence >= 0:
            st.last_seq = hdr.base_sequence + hdr.record_count - 1
        if hdr.is_transactional and pid not in self._ongoing:
            self._ongoing[pid] = hdr.base_offset

    # ------------------------------------------------------------ produce path
    async def replicate(self, batches: list[RecordBatch], level: int):
        """Gate + append + state update, atomically per partition.

        The check and the append MUST be one critical section: two retried
        produces for the same pid would otherwise both pass the sequence
        check while the first is suspended in the log append, writing the
        duplicate idempotence exists to prevent (rm_stm does its checks
        inside replicate under op_lock for the same reason).

        Returns (errc, ReplicateResult | None); (none, None) = every batch
        was a duplicate and the request is acked without appending.
        """
        import asyncio

        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            to_append: list[RecordBatch] = []
            sim: dict[int, int] = {}  # pid -> last_seq incl. earlier batches in THIS request
            for b in batches:
                code = self._check(b, sim)
                if code == E.duplicate_sequence_number:
                    continue  # retried batch: skip, ack the rest
                if code != E.none:
                    return code, None
                if b.header.producer_id >= 0 and b.header.base_sequence >= 0:
                    sim[b.header.producer_id] = (
                        b.header.base_sequence + b.header.record_count - 1
                    )
                to_append.append(b)
            if not to_append:
                return E.none, None
            res = await self.partition.replicate(to_append, level)  # pandalint: disable=LCK702 -- idempotency stm: sequence-check + replicate + note_appended must be one atom or dedup state races the log
            base = res.base_offset
            for b in to_append:
                self._note_appended(b, base)
                base += b.header.record_count
            return E.none, res

    def _check(self, batch: RecordBatch, sim: dict[int, int]) -> E:
        hdr = batch.header
        pid = hdr.producer_id
        if pid < 0:
            return E.none
        st = self._producers.get(pid)
        if st is not None and hdr.producer_epoch < st.epoch:
            return E.invalid_producer_epoch
        if hdr.is_transactional and pid not in self._ongoing and pid not in self._pending_begin:
            # transactional produce requires AddPartitionsToTxn first
            return E.invalid_txn_state
        if hdr.base_sequence >= 0:
            # earlier batches of THIS request count even for a brand-new
            # producer (st None) — a retried duplicate inside one request
            # must still dedup
            last = sim.get(pid)
            if last is None and st is not None and hdr.producer_epoch == st.epoch:
                last = st.last_seq if st.last_seq != -1 else None
            if last is not None:
                if hdr.base_sequence == last + 1:
                    return E.none
                if hdr.base_sequence <= last:
                    return E.duplicate_sequence_number
                return E.out_of_order_sequence_number
        return E.none

    def _note_appended(self, batch: RecordBatch, base_offset: int) -> None:
        hdr = batch.header
        pid = hdr.producer_id
        if pid < 0:
            return
        st = self._producers.get(pid)
        if st is None or hdr.producer_epoch > st.epoch:
            st = ProducerState(hdr.producer_epoch)
            self._producers[pid] = st
        if hdr.base_sequence >= 0:
            st.last_seq = hdr.base_sequence + hdr.record_count - 1
        if hdr.is_transactional:
            self._pending_begin.discard(pid)
            if pid not in self._ongoing:
                self._ongoing[pid] = base_offset

    # ------------------------------------------------------------ tx control
    def begin_tx(self, pid: int, epoch: int) -> E:
        """AddPartitionsToTxn landed here: open the tx gate for pid."""
        st = self._producers.get(pid)
        if st is not None and epoch < st.epoch:
            return E.invalid_producer_epoch
        if st is None:
            self._producers[pid] = ProducerState(epoch)
        self._pending_begin.add(pid)
        return E.none

    async def end_tx(self, pid: int, epoch: int, commit: bool) -> E:
        from redpanda_tpu_torch.cluster.partition import ConsistencyLevel

        st = self._producers.get(pid)
        if st is not None and epoch < st.epoch:
            return E.invalid_producer_epoch
        self._pending_begin.discard(pid)
        if pid not in self._ongoing:
            return E.none  # no data written here; nothing to mark
        marker = make_control_marker(
            _COMMIT_MARKER if commit else _ABORT_MARKER, pid, epoch
        )
        res = await self.partition.replicate([marker], ConsistencyLevel.quorum_ack)
        first = self._ongoing.pop(pid)
        if not commit:
            self._aborted.append(AbortedTx(pid, first, res.last_offset))
        return E.none

    # ------------------------------------------------------------ fetch path
    @property
    def last_stable_offset(self) -> int:
        """Exclusive LSO: first offset of the earliest open tx, else HWM."""
        hwm = self.partition.high_watermark
        if not self._ongoing:
            return hwm
        return min(min(self._ongoing.values()), hwm)

    def aborted_ranges(self, fetch_offset: int, max_offset: int) -> list[AbortedTx]:
        return [
            a
            for a in self._aborted
            if a.last_offset >= fetch_offset and a.first_offset <= max_offset
        ]
