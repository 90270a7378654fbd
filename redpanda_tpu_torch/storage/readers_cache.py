"""Positioned-reader cache for sequential fetch continuation (the JAX
package's storage/readers_cache.py, copied).

Reference: storage/readers_cache.h:36 — `disk_log_impl` keeps a per-log
cache of live `log_reader`s keyed by their next read position; a fetch
whose start offset matches a cached reader's position adopts it instead of
re-opening and re-seeking, and truncation/compaction/start-offset moves
evict affected readers.

Our readers are not long-lived objects (each DiskLog.read decodes from a
file position), so the cached thing is the *cursor*: next_offset →
(segment base, exact file position just past the last decoded frame).
A continuation read seeks straight there, skipping the sparse-index lookup
and the decode-and-skip scan from the index point. Cursors at the log tail
stay valid across appends — the next frame lands exactly at the cached
position, so steady-state sequential consumers never re-scan.

Invalidation (DiskLog mirrors its batch-cache hooks):
- truncate(offset): drop cursors with next_offset > offset (their position
  may now be past EOF or point into rewritten bytes)
- prefix_truncate(offset): drop cursors below the new start offset
- compaction (in-place segment rewrite): drop the log's cursors entirely
- close/remove: drop the log's cursors entirely
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass


@dataclass(frozen=True)
class ReadCursor:
    segment_base: int  # base offset of the segment the position lies in
    file_pos: int  # byte position of the next frame within that segment


class ReadersCache:
    """Process-wide LRU of read cursors, shared by all managed logs."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        # (log_key, next_offset) -> ReadCursor, oldest first
        self._lru: "OrderedDict[tuple[int, int], ReadCursor]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, log_key: int, next_offset: int) -> ReadCursor | None:
        cur = self._lru.get((log_key, next_offset))
        if cur is None:
            self.misses += 1
            return None
        self._lru.move_to_end((log_key, next_offset))
        self.hits += 1
        return cur

    def put(self, log_key: int, next_offset: int, cursor: ReadCursor) -> None:
        key = (log_key, next_offset)
        self._lru.pop(key, None)
        self._lru[key] = cursor
        while len(self._lru) > self.max_entries:
            self._lru.popitem(last=False)

    def invalidate(
        self,
        log_key: int,
        *,
        from_offset: int | None = None,
        below_offset: int | None = None,
    ) -> None:
        """No range args = drop every cursor for the log."""
        doomed = []
        for (lk, off) in self._lru:
            if lk != log_key:
                continue
            if from_offset is not None:
                # a cursor at exactly `from_offset` points at the first
                # truncated byte — the position is stale too; drop >= hence
                if off >= from_offset:
                    doomed.append((lk, off))
            elif below_offset is not None:
                if off < below_offset:
                    doomed.append((lk, off))
            else:
                doomed.append((lk, off))
        for key in doomed:
            del self._lru[key]

    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "entries": len(self._lru)}
