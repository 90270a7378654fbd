"""In-memory log backend for tests (the JAX package's storage/mem_log.py,
copied; parity with storage/mem_log_impl.cc).

Same surface as DiskLog, no files. Used by raft/cluster/kafka tests where
disk behavior is not under test.
"""

from __future__ import annotations

from dataclasses import replace

from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.models.record import RecordBatch
from redpanda_tpu_torch.storage.log import AppendResult, LogOffsets


class MemLog:
    def __init__(self, ntp: NTP, start_offset: int = 0):
        self.ntp = ntp
        self._batches: list[RecordBatch] = []
        self._start_offset = start_offset
        self._term = 0

    @property
    def term(self) -> int:
        return self._term

    def offsets(self) -> LogOffsets:
        dirty = self._batches[-1].last_offset if self._batches else self._start_offset - 1
        return LogOffsets(self._start_offset, dirty, dirty)

    async def append(self, batches, *, term=None, assign_offsets: bool = True) -> AppendResult:
        if term is not None:
            self._term = max(self._term, term)
        off = self.offsets()
        next_offset = off.dirty_offset + 1
        first = None
        size = 0
        for batch in batches:
            if assign_offsets:
                batch = batch.with_base_offset(next_offset)
                batch.header.term = self._term
            elif batch.header.term < 0:
                batch.header.term = self._term
            else:
                # Follower-path append keeps the replicated term (MemLog has
                # no segments, so the term survives only in the header).
                self._term = batch.header.term
            if first is None:
                first = batch.base_offset
            self._batches.append(batch)
            size += batch.size_bytes
            next_offset = batch.last_offset + 1
        last = next_offset - 1
        return AppendResult(first if first is not None else last + 1, last, size)

    async def read(self, start_offset, max_bytes=1 << 20, *, max_offset=None, type_filter=None):
        out = []
        taken = 0
        for b in self._batches:
            if b.last_offset < start_offset or b.last_offset < self._start_offset:
                continue
            if max_offset is not None and b.base_offset > max_offset:
                break
            if type_filter is not None and b.header.type not in type_filter:
                continue
            out.append(b)
            taken += b.size_bytes
            if taken >= max_bytes:
                break
        return out

    async def flush(self):
        pass

    async def truncate(self, offset: int):
        self._batches = [b for b in self._batches if b.last_offset < offset]

    async def prefix_truncate(self, offset: int):
        self._start_offset = max(self._start_offset, offset)
        self._batches = [b for b in self._batches if b.last_offset >= self._start_offset]

    async def timequery(self, ts: int):
        for b in self._batches:
            if b.header.max_timestamp >= ts:
                return b.base_offset
        return None

    async def close(self):
        pass

    async def remove(self):
        self._batches.clear()
