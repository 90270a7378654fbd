"""Global LRU batch cache fronting segment reads (the JAX package's
storage/batch_cache.py, copied).

Reference: storage/batch_cache.h:99 — one process-wide LRU of decoded
record batches with a byte budget, integrated with the memory reclaimer;
readers check it before touching segment files (batch_cache_index per log).
Here the budget is a plain byte cap (the asyncio runtime has no Seastar
reclaimer; the kafka layer's MemoryBudget guards request memory
separately), eviction is LRU, and each DiskLog holds an index keyed by
batch base offset with bisect range lookup.

Invalidation rules (all enforced by DiskLog calling ``invalidate``):
- suffix truncate(offset): drop every cached batch with last_offset >= offset
- prefix_truncate(offset): drop every batch below the new start
- compaction rewrites a segment in place: drop the log's whole index
- close/remove: drop the log's whole index
"""

from __future__ import annotations

from bisect import bisect_right, insort
from collections import OrderedDict

from redpanda_tpu_torch.models.record import RecordBatch


class BatchCache:
    """Process-wide LRU over decoded batches, byte-budgeted."""

    def __init__(self, max_bytes: int = 64 << 20):
        self.max_bytes = max_bytes
        self._bytes = 0
        # (log_key, base_offset) -> RecordBatch, in LRU order (oldest first)
        self._lru: "OrderedDict[tuple[int, int], RecordBatch]" = OrderedDict()
        # log_key -> sorted [base_offset]
        self._index: dict[int, list[int]] = {}
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------ lookup
    def get(self, log_key: int, offset: int) -> RecordBatch | None:
        """The cached batch COVERING `offset`, else None."""
        bases = self._index.get(log_key)
        if not bases:
            self.misses += 1
            return None
        i = bisect_right(bases, offset) - 1
        if i < 0:
            self.misses += 1
            return None
        key = (log_key, bases[i])
        b = self._lru.get(key)
        if b is None or b.last_offset < offset:
            self.misses += 1
            return None
        self._lru.move_to_end(key)
        self.hits += 1
        return b

    # ------------------------------------------------------------ insert
    def put(self, log_key: int, batch: RecordBatch) -> None:
        if batch.size_bytes > self.max_bytes:
            return
        key = (log_key, batch.header.base_offset)
        old = self._lru.pop(key, None)
        if old is not None:
            self._bytes -= old.size_bytes
        self._lru[key] = batch
        if old is None:
            insort(self._index.setdefault(log_key, []), batch.header.base_offset)
        self._bytes += batch.size_bytes
        while self._bytes > self.max_bytes and self._lru:
            (lk, base), evicted = self._lru.popitem(last=False)
            self._bytes -= evicted.size_bytes
            bases = self._index.get(lk)
            if bases:
                i = bisect_right(bases, base) - 1
                if i >= 0 and bases[i] == base:
                    bases.pop(i)
                if not bases:
                    del self._index[lk]

    # ------------------------------------------------------------ invalidate
    def invalidate(
        self,
        log_key: int,
        *,
        from_offset: int | None = None,
        below_offset: int | None = None,
    ) -> None:
        """Drop cached batches of one log: everything (no bounds), the
        suffix with last_offset >= from_offset, or the prefix with
        base_offset < below_offset."""
        bases = self._index.get(log_key)
        if not bases:
            return
        keep: list[int] = []
        for base in bases:
            key = (log_key, base)
            b = self._lru.get(key)
            if b is None:
                continue
            drop = True
            if from_offset is not None:
                drop = b.last_offset >= from_offset
            elif below_offset is not None:
                drop = base < below_offset
            if drop:
                del self._lru[key]
                self._bytes -= b.size_bytes
            else:
                keep.append(base)
        if keep:
            self._index[log_key] = keep
        else:
            self._index.pop(log_key, None)

    # ------------------------------------------------------------ stats
    @property
    def bytes_used(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "bytes_used": self._bytes,
            "max_bytes": self.max_bytes,
            "batches": len(self._lru),
        }
