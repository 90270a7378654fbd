"""Per-NTP append-only segmented log (the JAX package's storage/log.py,
copied; a log directory written by either package opens in the other).

Capability parity with the reference's storage/disk_log_impl.h behind the
storage/log.h pimpl interface: append / read / flush / truncate /
prefix-truncate (eviction) / timequery / segment roll / retention, with
recovery via a CRC scan of the tail segment (log_replayer.h) that can run
as one launch of the CRC kernel on the card (``LogConfig.use_device_recovery``
with ``recovery_device``; storage/recovery.py).

Design note: the log keeps batches byte-contiguous on disk in the internal
layout so recovery and compaction hashing feed the device CRC kernel
without re-framing; readers return RecordBatch views whose payloads slice
directly out of the read blob.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
import time
from dataclasses import dataclass, field

from redpanda_tpu_torch.finjector import honey_badger
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.models.record import RecordBatch
from redpanda_tpu_torch.observability import probes
from redpanda_tpu_torch.observability.trace import tracer
from redpanda_tpu_torch.storage.segment import Segment
from redpanda_tpu_torch.storage.recovery import recover_segment

# storage failure probes (reference storage/failure_probes.h:24
# log_failure_probes {append, roll, truncate}, driven over the admin
# honey-badger API like tests/rptest services/honey_badger.py)
honey_badger.register_probe("storage", "log_append", "log_roll", "log_truncate")


@dataclass
class LogConfig:
    base_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "redpanda_tpu_torch_data")
    )
    max_segment_size: int = 128 * 1024 * 1024
    segment_age_s: float = float("inf")
    retention_bytes: int | None = None
    retention_ms: int | None = None
    fsync_on_append: bool = False
    use_device_recovery: bool = False  # the tail's CRC scan as one K5 launch
    # where that launch runs: the card unless the caller asks for "cpu" (K5's
    # plain version); a failed build or launch raises out of DiskLog.open
    recovery_device: str = "cuda"
    # cleanup.policy: "delete", "compact", or "compact,delete"
    cleanup_policy: str = "delete"
    # debug file-handle sanitizer (storage::debug_sanitize_files)
    sanitize_files: bool = False
    delete_retention_ms: int | None = 86_400_000  # tombstone retention
    compaction_max_keys_in_memory: int = 128 * 1024  # key-index spill bound


@dataclass
class AppendResult:
    base_offset: int
    last_offset: int
    byte_size: int


@dataclass
class LogOffsets:
    start_offset: int
    dirty_offset: int  # highest appended
    committed_offset: int  # highest fsynced


class DiskLog:
    def __init__(self, ntp: NTP, config: LogConfig):
        self.ntp = ntp
        self.config = config
        self.dir = os.path.join(config.base_dir, ntp.path())
        self.segments: list[Segment] = []
        self._start_offset = 0
        self._committed = -1
        self._active_created_at = 0.0
        self._lock = asyncio.Lock()
        self._term = 0
        # sync callables (type, base_offset, last_offset) fired per appended
        # batch under the log lock; truncation listeners get (offset)
        self.append_listeners: list = []
        self.truncate_listeners: list = []
        # global LRU fronting segment reads (batch_cache.h:99); assigned by
        # the LogManager, None in bare/standalone usage
        self.batch_cache = None
        # positioned-cursor cache for sequential fetch continuation
        # (readers_cache.h:36); assigned by the LogManager like batch_cache
        self.readers_cache = None

    def _cache_put(self, batch: RecordBatch) -> None:
        if self.batch_cache is not None:
            self.batch_cache.put(id(self), batch)

    def _cache_invalidate(self, **kw) -> None:
        if self.batch_cache is not None:
            self.batch_cache.invalidate(id(self), **kw)
        if self.readers_cache is not None:
            self.readers_cache.invalidate(id(self), **kw)

    # ------------------------------------------------------------ lifecycle
    @classmethod
    async def open(cls, ntp: NTP, config: LogConfig) -> "DiskLog":
        if config.sanitize_files:
            from redpanda_tpu_torch.storage import file_sanitizer

            file_sanitizer.enable()
        log = cls(ntp, config)
        # The segment scan + tail CRC recovery is pure disk work on an
        # object nothing else references yet; inline it and a node restart
        # with many partitions would stall every other recovery on the loop.
        await asyncio.to_thread(log._open_sync)
        return log

    def _open_sync(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        stems = sorted(
            (f for f in os.listdir(self.dir) if f.endswith(".log")),
            key=lambda f: int(f.split("-")[0]),
        )
        for i, fname in enumerate(stems):
            base, term, _ = fname.split("-", 2)
            seg = Segment(self.dir, int(base), int(term))
            last = i == len(stems) - 1
            seg.open_existing(writable=False)
            if last:
                # CRC-scan the tail (crash recovery), truncating at the
                # first corrupt frame, then reopen for append.
                recover_segment(
                    seg,
                    use_device=self.config.use_device_recovery,
                    device=self.config.recovery_device,
                )
                seg._file = open(seg.data_path, "ab")
            self.segments.append(seg)
            self._term = max(self._term, seg.term)
        if self.segments:
            self._start_offset = self.segments[0].base_offset
            self._committed = self.segments[-1].dirty_offset
            self._active_created_at = time.monotonic()

    async def close(self):
        async with self._lock:
            self._cache_invalidate()
            for seg in self.segments:
                seg.close()

    async def remove(self):
        async with self._lock:
            self._cache_invalidate()
            for seg in self.segments:
                seg.remove()
            self.segments.clear()
            try:
                os.removedirs(self.dir)
            except OSError:
                pass

    # ------------------------------------------------------------ offsets
    def offsets(self) -> LogOffsets:
        dirty = self.segments[-1].dirty_offset if self.segments else self._start_offset - 1
        return LogOffsets(self._start_offset, dirty, self._committed)

    @property
    def term(self) -> int:
        return self._term

    # ------------------------------------------------------------ append
    async def append(
        self, batches: list[RecordBatch], *, term: int | None = None, assign_offsets: bool = True
    ) -> AppendResult:
        """Append sealed batches; assigns monotone base offsets by default."""
        if not batches:
            off = self.offsets()
            return AppendResult(off.dirty_offset + 1, off.dirty_offset, 0)
        # storage account (resource_mgmt budget plane): append-buffer bytes
        # inflight through this call. Waiting (not shedding) is correct
        # here — every producer of appends sits behind an admission gate
        # (kafka produce, coproc submit, rpc dispatch), so the wait is
        # bounded backpressure and peak occupancy never breaches the
        # account. Plane-less processes skip both branches.
        from redpanda_tpu_torch.resource_mgmt import budgets as _budgets

        acct = _budgets.account_or_none("storage")
        reserved = 0
        if acct is not None:
            reserved = await acct.acquire(
                sum(b.size_bytes for b in batches)
            )
        t_probe = time.perf_counter()
        try:
            with tracer.span("storage.append"):
                return await self._append_locked(batches, term, assign_offsets)
        finally:
            if acct is not None:
                acct.release(reserved)
            probes.observe_us(probes.storage_append_hist, t_probe)

    async def _append_locked(
        self, batches: list[RecordBatch], term: int | None, assign_offsets: bool
    ) -> AppendResult:
        async with self._lock:
            honey_badger.inject_sync("storage", "log_append")
            if term is not None and term > self._term:
                self._term = term
            seg = self._active_segment_for_append()
            next_offset = seg.dirty_offset + 1
            first = None
            size = 0
            for batch in batches:
                if assign_offsets:
                    batch = batch.with_base_offset(next_offset)
                    batch.header.term = self._term
                elif batch.header.term < 0:
                    batch.header.term = self._term
                else:
                    # Follower-path append: batches arrive with the leader's
                    # term already stamped; adopt it (terms may also go DOWN
                    # after a divergent suffix was truncated).
                    self._term = batch.header.term
                if first is None:
                    first = batch.base_offset
                # The segment filename is the durable term record (the packed
                # header has no term field), so the active segment's term must
                # match every batch written into it.
                seg = self._segment_for_term(seg, batch.header.term)
                seg = self._maybe_roll(seg)
                seg.append(batch)
                # hot tail into the cache: fetch-after-produce never touches
                # the segment file (batch_cache put-on-append)
                self._cache_put(batch)
                size += batch.size_bytes
                next_offset = batch.last_offset + 1
                for fn in self.append_listeners:
                    fn(batch.header.type, batch.base_offset, batch.last_offset)
            if self.config.fsync_on_append:
                seg.fsync()
                self._committed = seg.dirty_offset
            last = next_offset - 1
            return AppendResult(first if first is not None else last + 1, last, size)

    def _active_segment_for_append(self) -> Segment:
        if not self.segments or not self.segments[-1].writable:
            base = self.offsets().dirty_offset + 1
            seg = Segment(self.dir, base, self._term).create()
            self.segments.append(seg)
            self._active_created_at = time.monotonic()
            return seg
        return self.segments[-1]

    def _segment_for_term(self, seg: Segment, term: int) -> Segment:
        """Roll (or, if still empty, replace) the active segment so its
        filename term matches `term`."""
        if seg.term == term:
            return seg
        if seg.size_bytes == 0:
            # Nothing written yet: replace it so no batch is ever mislabeled.
            base = seg.base_offset
            seg.remove()
            self.segments.pop()
        else:
            base = seg.dirty_offset + 1
            seg.release_appender()
        new = Segment(self.dir, base, term).create()
        self.segments.append(new)
        self._active_created_at = time.monotonic()
        return new

    def _maybe_roll(self, seg: Segment) -> Segment:
        too_big = seg.size_bytes >= self.config.max_segment_size
        too_old = (
            seg.size_bytes > 0
            and (time.monotonic() - self._active_created_at) >= self.config.segment_age_s
        )
        if too_big or too_old:
            honey_badger.inject_sync("storage", "log_roll")
            seg.release_appender()
            new = Segment(self.dir, seg.dirty_offset + 1, self._term).create()
            self.segments.append(new)
            self._active_created_at = time.monotonic()
            return new
        return seg

    async def flush(self):
        async with self._lock:
            if self.segments:
                self.segments[-1].fsync()
                self._committed = self.segments[-1].dirty_offset

    # ------------------------------------------------------------ read
    async def read(
        self,
        start_offset: int,
        max_bytes: int = 1 << 20,
        *,
        max_offset: int | None = None,
        type_filter=None,
    ) -> list[RecordBatch]:
        async with self._lock:
            start = max(start_offset, self._start_offset)
            cached = self._read_cached(start, max_bytes, max_offset, type_filter)
            if cached is not None:
                return cached
            out: list[RecordBatch] = []
            taken = 0
            # adopt a cached read cursor for the first touched segment: the
            # scan seeks straight to the frame boundary instead of going
            # through the sparse index (readers_cache.h continuation)
            cursor = (
                self.readers_cache.get(id(self), start)
                if self.readers_cache is not None
                else None
            )
            end_seg = end_pos = None
            for seg in self.segments:
                if seg.dirty_offset < start:
                    continue
                if max_offset is not None and seg.base_offset > max_offset:
                    break
                start_pos = None
                if cursor is not None and cursor.segment_base == seg.base_offset:
                    start_pos = cursor.file_pos
                cursor = None  # only valid for the first segment touched
                batches, next_pos = seg.scan(
                    start,
                    max_bytes - taken,
                    type_filter=type_filter,
                    max_offset=max_offset,
                    start_pos=start_pos,
                )
                end_seg, end_pos = seg, next_pos
                for b in batches:
                    out.append(b)
                    self._cache_put(b)
                    taken += b.size_bytes
                if taken >= max_bytes:
                    break
                if out:
                    start = out[-1].last_offset + 1
            if self.readers_cache is not None and out and end_seg is not None:
                from redpanda_tpu_torch.storage.readers_cache import ReadCursor

                self.readers_cache.put(
                    id(self),
                    out[-1].last_offset + 1,
                    ReadCursor(end_seg.base_offset, end_pos),
                )
            return out

    def _read_cached(self, start, max_bytes, max_offset, type_filter):
        """Serve the read purely from the batch cache, or None.

        Only a COMPLETE answer counts: the cached chain must run unbroken
        from `start` to the dirty offset / max_offset / byte budget —
        a mid-range miss falls back to the segment scan (which re-populates
        the cache), so callers never see a silently shortened read."""
        if self.batch_cache is None or not self.segments:
            return None
        end = self.segments[-1].dirty_offset
        if max_offset is not None:
            end = min(end, max_offset)
        out: list[RecordBatch] = []
        taken = 0
        cur = start
        key = id(self)
        while cur <= end and taken < max_bytes:
            b = self.batch_cache.get(key, cur)
            if b is None:
                return None  # chain broken: not a complete answer
            if type_filter is None or b.header.type in type_filter:
                out.append(b)
                taken += b.size_bytes
            cur = b.last_offset + 1
        return out

    async def timequery(self, ts: int) -> int | None:
        """First offset with max_timestamp >= ts (storage timequery)."""
        async with self._lock:
            for seg in self.segments:
                if seg.max_timestamp >= ts:
                    off = seg.first_offset_with_ts(ts)
                    if off is not None:
                        return off
            return None

    # ------------------------------------------------------------ truncate
    async def truncate(self, offset: int):
        """Drop everything at and after `offset` (suffix truncation)."""
        async with self._lock:
            honey_badger.inject_sync("storage", "log_truncate")
            self._cache_invalidate(from_offset=offset)
            keep: list[Segment] = []
            for seg in self.segments:
                if seg.dirty_offset < offset:
                    keep.append(seg)
                    continue
                if seg.base_offset >= offset:
                    seg.remove()
                    continue
                # partial: find the file position of the first batch >= offset
                blob = seg.read_from(0)
                at = 0
                new_dirty = seg.base_offset - 1
                new_max_ts = -1
                from redpanda_tpu_torch.models.record import INTERNAL_HEADER_SIZE

                while at + INTERNAL_HEADER_SIZE <= len(blob):
                    batch, consumed = RecordBatch.decode_internal(blob, at)
                    if batch.last_offset >= offset:
                        break
                    new_dirty = batch.last_offset
                    new_max_ts = max(new_max_ts, batch.header.max_timestamp)
                    at += consumed
                seg.truncate_to_file_pos(at, new_dirty, new_max_ts)
                keep.append(seg)
            self.segments = keep
            self._committed = min(self._committed, self.offsets().dirty_offset)
            for fn in self.truncate_listeners:
                fn(offset)

    async def prefix_truncate(self, offset: int):
        """Evict whole segments below `offset` (retention / raft snapshot)."""
        async with self._lock:
            self._cache_invalidate(below_offset=offset)
            while self.segments and self.segments[0].dirty_offset < offset and (
                len(self.segments) > 1 or not self.segments[0].writable
            ):
                self.segments.pop(0).remove()
            self._start_offset = max(self._start_offset, offset)

    # ------------------------------------------------------------ compaction
    @property
    def is_compacted(self) -> bool:
        return "compact" in self.config.cleanup_policy

    def compaction_backlog(self) -> int:
        """Closed-segment bytes accumulated SINCE the last compaction pass —
        the controller's process variable (backlog_controller.h). Measured
        against the post-compaction closed-bytes baseline so steady trickle
        appends into the active segment read as zero backlog (total closed
        bytes would keep the controller pinned at max pressure forever)."""
        if not self.is_compacted:
            return 0
        if getattr(self, "_compacted_through", None) == self.offsets().dirty_offset:
            return 0
        closed = sum(s.size_bytes for s in self.segments if not s.writable)
        return max(0, closed - getattr(self, "_compacted_closed_bytes", 0))

    async def compact(self) -> tuple[int, int]:
        """Self-compact all closed segments (storage/compaction.py); no-op
        until new data has arrived since the previous pass."""
        offs = self.offsets()
        if getattr(self, "_compacted_through", None) == offs.dirty_offset:
            return 0, 0
        from redpanda_tpu_torch.storage.compaction import compact_log

        result = await compact_log(
            self,
            delete_retention_ms=self.config.delete_retention_ms,
            max_keys_in_memory=self.config.compaction_max_keys_in_memory,
        )
        # compaction rewrote segment contents in place: cached batches for
        # dropped keys would resurrect them on a cache-served fetch
        self._cache_invalidate()
        self._compacted_through = offs.dirty_offset
        # baseline for the backlog measure: closed bytes as they stand
        # post-rewrite, so only NEW closed data counts as backlog
        self._compacted_closed_bytes = sum(
            s.size_bytes for s in self.segments if not s.writable
        )
        return result

    # ------------------------------------------------------------ retention
    async def apply_retention(self):
        cfg = self.config
        if cfg.retention_bytes is not None:
            total = sum(s.size_bytes for s in self.segments)
            while len(self.segments) > 1 and total > cfg.retention_bytes:
                seg = self.segments[0]
                total -= seg.size_bytes
                await self.prefix_truncate(seg.dirty_offset + 1)
        if cfg.retention_ms is not None:
            cutoff = int(time.time() * 1000) - cfg.retention_ms
            while len(self.segments) > 1 and self.segments[0].max_timestamp < cutoff and self.segments[0].max_timestamp >= 0:
                await self.prefix_truncate(self.segments[0].dirty_offset + 1)
