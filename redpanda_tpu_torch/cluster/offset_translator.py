"""Kafka <-> raft offset translation (the JAX package's
cluster/offset_translator.py, copied: its kvstore keys and values are the
JAX package's, so a data directory written by either package opens in the
other).

Parity with kafka/server/offset_translator.h:11-26: raft configuration (and
any other non-data) batches occupy log offsets that Kafka clients must never
see — a topic that went through elections or membership changes would
otherwise show offset gaps on the client side. The translator tracks every
non-data batch range ("gap") and converts between the two domains:

    kafka_offset = raft_offset - (# non-data offsets at or below it)

Design differences from the reference (which derives state from raft's
configuration_manager): this translator is self-contained at the partition
level. It observes every append through a log listener (leader, follower,
and recovery paths all funnel through DiskLog.append), persists its state in
the kvstore keyspace reserved for it in round 1 (storage/kvstore.py
KeySpace.offset_translator), and catches up by scanning only the log suffix
written since the last persisted state.

All Partition-facing APIs (produce results, fetch reads, watermarks,
timequery, list_offsets) speak Kafka offsets; raft internals keep raw log
offsets. Batches returned to clients are re-based into the Kafka domain —
safe because the Kafka CRC covers attributes..records, not base_offset.
"""

from __future__ import annotations

import struct

from redpanda_tpu_torch.models.record import RecordBatchType

_HDR = struct.Struct("<qqqI")  # base_offset, base_delta, upto, ngaps
_GAP = struct.Struct("<qq")  # start, length


class OffsetTranslator:
    def __init__(self, ntp, kvs=None):
        self.ntp = ntp
        self._kvs = kvs
        self._key = f"otl/{ntp.path()}".encode()
        # raft offsets < _base are summarized by _base_delta gap offsets
        self._base = 0
        self._base_delta = 0
        self._gaps: list[tuple[int, int]] = []  # (raft start, length), sorted
        self._upto = -1  # highest raft offset observed

    # ------------------------------------------------------------ state
    @property
    def upto(self) -> int:
        return self._upto

    def total_delta(self) -> int:
        return self._base_delta + sum(l for _, l in self._gaps)

    # ------------------------------------------------------------ conversion
    def gaps_below(self, bound: int) -> int:
        """Number of gap (non-data) offsets strictly below `bound` (raft)."""
        total = self._base_delta
        for s, l in self._gaps:
            if s >= bound:
                break
            total += min(l, bound - s)
        return total

    def to_kafka_excl(self, bound: int) -> int:
        """Translate an exclusive raft upper bound (HWM/LSO convention)."""
        return bound - self.gaps_below(bound)

    def to_kafka(self, raft_offset: int) -> int:
        """Translate an inclusive raft offset (must not sit inside a gap)."""
        return self.to_kafka_excl(raft_offset + 1) - 1

    def from_kafka(self, kafka_offset: int) -> int:
        """Inclusive kafka -> raft (the first raft offset whose kafka
        translation is >= kafka_offset)."""
        r = kafka_offset + self._base_delta
        for s, l in self._gaps:
            if s <= r:
                r += l
            else:
                break
        return r

    def from_kafka_excl(self, bound: int) -> int:
        return self.from_kafka(bound - 1) + 1 if bound > 0 else self.from_kafka(0)

    # ------------------------------------------------------------ updates
    def observe(self, btype: RecordBatchType, base: int, last: int) -> None:
        """Feed one appended batch (any type); idempotent for replays."""
        if last <= self._upto:
            return
        if btype != RecordBatchType.raft_data:
            start = max(base, self._upto + 1)
            length = last - start + 1
            if length > 0:
                if self._gaps and self._gaps[-1][0] + self._gaps[-1][1] == start:
                    s, l = self._gaps[-1]
                    self._gaps[-1] = (s, l + length)
                else:
                    self._gaps.append((start, length))
                self._upto = last
                self._persist()
                return
        self._upto = last

    def truncate(self, offset: int) -> None:
        """Raft suffix truncation: forget gaps at/after `offset`."""
        changed = False
        while self._gaps and self._gaps[-1][0] + self._gaps[-1][1] > offset:
            s, l = self._gaps.pop()
            if s < offset:  # partial: keep the prefix of the gap
                self._gaps.append((s, offset - s))
                changed = True
                break
            changed = True
        if self._upto >= offset:
            self._upto = offset - 1
            changed = True
        if changed:
            self._persist()

    def advance_base(self, new_base: int) -> None:
        """Prefix truncation: collapse gaps fully below `new_base`."""
        changed = False
        while self._gaps and self._gaps[0][0] + self._gaps[0][1] <= new_base:
            s, l = self._gaps.pop(0)
            self._base_delta += l
            changed = True
        if new_base > self._base:
            self._base = new_base
            changed = True
        if changed:
            self._persist()

    # ------------------------------------------------------------ persistence
    def _persist(self) -> None:
        if self._kvs is None:
            return
        from redpanda_tpu_torch.storage.kvstore import KeySpace

        blob = _HDR.pack(self._base, self._base_delta, self._upto, len(self._gaps))
        blob += b"".join(_GAP.pack(s, l) for s, l in self._gaps)
        self._kvs.put(KeySpace.offset_translator, self._key, blob)

    def _load(self) -> bool:
        if self._kvs is None:
            return False
        from redpanda_tpu_torch.storage.kvstore import KeySpace

        blob = self._kvs.get(KeySpace.offset_translator, self._key)
        if not blob or len(blob) < _HDR.size:
            return False
        self._base, self._base_delta, self._upto, n = _HDR.unpack_from(blob, 0)
        self._gaps = [
            _GAP.unpack_from(blob, _HDR.size + i * _GAP.size) for i in range(n)
        ]
        return True

    async def bootstrap(self, log) -> "OffsetTranslator":
        """Load persisted state, then scan the log suffix written since
        (covers crashes between append and persist, and fresh logs)."""
        self._load()
        offs = log.offsets()
        if self._upto >= offs.dirty_offset:
            # persisted state may be AHEAD of the log after an unflushed
            # crash: clamp back so re-appends re-observe correctly
            self.truncate(offs.dirty_offset + 1)
            return self
        start = max(self._upto + 1, offs.start_offset)
        while start <= offs.dirty_offset:
            batches = await log.read(start, 4 << 20)
            if not batches:
                break
            for b in batches:
                self.observe(b.header.type, b.base_offset, b.last_offset)
            start = batches[-1].last_offset + 1
        if self._upto < offs.dirty_offset:
            # tail entirely non-data or empty reads: mark caught-up anyway
            self._upto = offs.dirty_offset
        self._persist()
        return self
