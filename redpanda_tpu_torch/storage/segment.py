"""Log segment: one append-only data file + a sparse offset index.

The JAX package's storage/segment.py, copied: the data file and the index
file are byte for byte the JAX package's, so a segment written by either
package opens in the other. Capability parity with the reference's
storage/segment.h + segment_appender.h (chunked buffered writes,
background flush) + segment_index.h (sparse index sampled every
`index_step` bytes). The on-disk payload is the internal batch layout
(61-byte LE header + payload, models/record.py), so a recovery scan is a
straight walk of [header][payload] frames whose CRCs can be validated in
one batched device kernel on the card (see recovery.py).

File naming: <base_offset>-<term>-v1.log / .index under the ntp directory.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

from redpanda_tpu_torch.models.record import (
    INTERNAL_HEADER_SIZE,
    CorruptBatchError,
    RecordBatch,
    RecordBatchHeader,
)
from redpanda_tpu_torch.storage import file_sanitizer

INDEX_STEP = 32 * 1024
_INDEX_ENTRY = struct.Struct("<IQq")  # rel_offset u32, file_pos u64, ts i64
_INDEX_MAGIC = b"RPXI\x02"
_INDEX_FOOTER = struct.Struct("<qq")  # dirty_offset i64, max_timestamp i64


@dataclass
class IndexEntry:
    rel_offset: int
    file_pos: int
    timestamp: int


class SegmentIndex:
    """Sparse offset -> file position index, rebuilt on demand if missing."""

    def __init__(self, path: str, base_offset: int):
        self.path = path
        self.base_offset = base_offset
        self.entries: list[IndexEntry] = []
        self._acc_bytes = 0

    def maybe_track(self, batch_header: RecordBatchHeader, file_pos: int):
        self._acc_bytes += batch_header.size_bytes
        if not self.entries or self._acc_bytes >= INDEX_STEP:
            self.entries.append(
                IndexEntry(
                    batch_header.base_offset - self.base_offset,
                    file_pos,
                    batch_header.first_timestamp,
                )
            )
            self._acc_bytes = 0

    def lookup(self, offset: int) -> int:
        """Largest indexed file position whose batch base_offset <= offset."""
        rel = offset - self.base_offset
        pos = 0
        for e in self.entries:
            if e.rel_offset <= rel:
                pos = e.file_pos
            else:
                break
        return pos

    def lookup_time(self, ts: int) -> int:
        pos = 0
        for e in self.entries:
            if e.timestamp <= ts:
                pos = e.file_pos
            else:
                break
        return pos

    def persist(self, dirty_offset: int = -1, max_timestamp: int = -1):
        with open(self.path, "wb") as f:
            f.write(_INDEX_MAGIC)
            f.write(_INDEX_FOOTER.pack(dirty_offset, max_timestamp))
            for e in self.entries:
                f.write(_INDEX_ENTRY.pack(e.rel_offset, e.file_pos, e.timestamp))

    def load(self) -> tuple[int, int] | None:
        """Returns (dirty_offset, max_timestamp) on success, else None."""
        try:
            with open(self.path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        hdr = len(_INDEX_MAGIC) + _INDEX_FOOTER.size
        if not blob.startswith(_INDEX_MAGIC) or len(blob) < hdr:
            return None
        dirty, max_ts = _INDEX_FOOTER.unpack_from(blob, len(_INDEX_MAGIC))
        self.entries = []
        body = blob[hdr:]
        if len(body) % _INDEX_ENTRY.size:
            return None
        for i in range(0, len(body), _INDEX_ENTRY.size):
            rel, pos, ts = _INDEX_ENTRY.unpack_from(body, i)
            self.entries.append(IndexEntry(rel, pos, ts))
        return dirty, max_ts

    def truncate_at_pos(self, file_pos: int):
        self.entries = [e for e in self.entries if e.file_pos < file_pos]


class Segment:
    """One data file; open for append only when it is the active segment."""

    APPEND_BUF_LIMIT = 1 << 20  # flush the write buffer at 1 MiB

    def __init__(self, dir_path: str, base_offset: int, term: int):
        self.dir = dir_path
        self.base_offset = base_offset
        self.term = term
        stem = f"{base_offset}-{term}-v1"
        self.data_path = os.path.join(dir_path, stem + ".log")
        self.index = SegmentIndex(os.path.join(dir_path, stem + ".index"), base_offset)
        self._file = None
        self._buf = bytearray()
        self.size_bytes = 0
        self.dirty_offset = base_offset - 1  # highest appended offset
        self.max_timestamp = -1

    # ------------------------------------------------------------ lifecycle
    def create(self):
        self._file = file_sanitizer.maybe_wrap(
            open(self.data_path, "wb"), self.data_path
        )
        return self

    def open_existing(self, writable: bool):
        self.size_bytes = os.path.getsize(self.data_path)
        if writable:
            self._file = file_sanitizer.maybe_wrap(
                open(self.data_path, "ab"), self.data_path
            )
        loaded = self.index.load()
        if loaded is None:
            self.rebuild_index()
        else:
            self.dirty_offset, self.max_timestamp = loaded
            if self.dirty_offset < self.base_offset:
                # stale/pre-footer index: derive state from the data file
                self.rebuild_index()
        return self

    @property
    def writable(self) -> bool:
        return self._file is not None

    # ------------------------------------------------------------ append
    def append(self, batch: RecordBatch) -> None:
        assert self._file is not None, "segment not writable"
        encoded = batch.encode_internal()
        # this batch's file position == bytes appended so far (incl. buffered)
        self.index.maybe_track(batch.header, self.size_bytes)
        self._buf += encoded
        self.size_bytes += len(encoded)
        self.dirty_offset = batch.last_offset
        self.max_timestamp = max(self.max_timestamp, batch.header.max_timestamp)
        if len(self._buf) >= self.APPEND_BUF_LIMIT:
            self.flush_buffer()

    def flush_buffer(self):
        if self._buf and self._file:
            self._file.write(self._buf)
            self._buf.clear()

    def fsync(self):
        self.flush_buffer()
        if self._file:
            self._file.flush()
            os.fsync(self._file.fileno())

    def release_appender(self):
        """Close for writing (segment roll); persists the index."""
        if self._file:
            self.flush_buffer()
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
            self._file = None
        self.index.persist(self.dirty_offset, self.max_timestamp)

    def close(self):
        self.release_appender()

    # ------------------------------------------------------------ read
    def read_from(self, file_pos: int, max_len: int | None = None) -> bytes:
        self.flush_buffer()
        if self._file:
            self._file.flush()
        with open(self.data_path, "rb") as f:
            f.seek(file_pos)
            return f.read() if max_len is None else f.read(max_len)

    def scan(
        self,
        start_offset: int,
        max_bytes: int,
        *,
        type_filter=None,
        max_offset: int | None = None,
        start_pos: int | None = None,
    ) -> tuple[list[RecordBatch], int]:
        """Batches overlapping [start_offset, max_offset], bounded by size,
        with cursor support (readers_cache.h continuation).

        `start_pos` is an exact file position of a frame boundary (from a
        cached read cursor) — when given, the sparse-index lookup and the
        decode-and-skip scan up to `start_offset` are bypassed. Returns
        (batches, next_file_pos) where next_file_pos is the byte position
        just past the last KEPT batch (or the scan start when nothing was
        kept) — the cursor for the follow-up read at
        `batches[-1].last_offset + 1`. Frames consumed but filtered out
        AFTER the last kept batch are deliberately not covered by the
        cursor, so a continuation under a different type_filter re-scans
        them instead of silently skipping.
        """
        pos = start_pos if start_pos is not None else self.index.lookup(start_offset)
        # bounded chunked reads (ONE handle, window trimmed as frames are
        # consumed): a sequential consumer with a cursor reads ~max_bytes
        # per call instead of slurping the segment tail
        chunk = max(min(max_bytes * 2, 8 << 20), 1 << 16)
        out: list[RecordBatch] = []
        taken = 0
        kept_end = pos  # file offset just past the last KEPT batch
        for batch, end_pos in self._frames_from(pos, chunk):
            if max_offset is not None and batch.base_offset > max_offset:
                break  # NOT consumed: cursor stays before this frame
            if batch.last_offset < start_offset:
                continue
            if type_filter is not None and batch.header.type not in type_filter:
                continue
            # Runtime term context comes from the segment (the packed
            # header carries no term; the reference derives it the same
            # way, from the raft configuration tracking / segment naming)
            batch.header.term = self.term
            out.append(batch)
            kept_end = end_pos
            taken += batch.size_bytes
            if taken >= max_bytes:
                break
        return out, kept_end

    def _frames_from(self, pos: int, chunk: int):
        """Yield (batch, end_file_pos) for each frame from file position
        `pos`, reading the file in `chunk`-sized windows trimmed as frames
        are consumed. A frame cut at EOF raises CorruptBatchError: appends
        are whole-frame and recovery truncates torn tails at open, so a
        partial frame is corruption, never a legitimate state."""
        self.flush_buffer()
        if self._file:
            self._file.flush()
        with open(self.data_path, "rb") as f:
            f.seek(pos)
            blob = bytearray(f.read(chunk))
            base = pos  # file offset of blob[0]
            at = 0  # decode position within blob
            while True:
                if at >= chunk:
                    del blob[:at]
                    base += at
                    at = 0
                if at + INTERNAL_HEADER_SIZE > len(blob):
                    more = f.read(chunk)
                    if not more:
                        if at < len(blob):
                            raise CorruptBatchError(
                                f"partial batch header at EOF ({self.data_path}"
                                f" pos {base + at})"
                            )
                        return
                    blob += more
                    continue
                frame_len = RecordBatch.peek_size(blob, at)
                if at + frame_len > len(blob):
                    more = f.read(chunk)
                    if not more:
                        raise CorruptBatchError(
                            f"batch frame overruns EOF ({self.data_path} pos "
                            f"{base + at}, size_bytes={frame_len})"
                        )
                    blob += more
                    continue
                batch, consumed = RecordBatch.decode_internal(blob, at)
                at += consumed
                yield batch, base + at

    def first_offset_with_ts(self, ts: int) -> int | None:
        """First batch offset whose max_timestamp >= ts (index-accelerated).

        Bounded chunked reads via the shared frame iterator: a timequery
        that resolves near the index point must not slurp the rest of the
        segment file; corruption raises loudly like every read path."""
        pos = self.index.lookup_time(ts)
        for batch, _end in self._frames_from(pos, 1 << 20):
            if batch.header.max_timestamp >= ts:
                return batch.base_offset
        return None

    def rebuild_index(self, blob: bytes | None = None):
        """Recreate the sparse index (and dirty/max_ts) by scanning the data."""
        self.index.entries = []
        self.index._acc_bytes = 0
        self.dirty_offset = self.base_offset - 1
        self.max_timestamp = -1
        if blob is None:
            blob = self.read_from(0)
        at = 0
        while at + INTERNAL_HEADER_SIZE <= len(blob):
            try:
                batch, consumed = RecordBatch.decode_internal(blob, at)
            except Exception:
                break
            self.index.maybe_track(batch.header, at)
            self.dirty_offset = batch.last_offset
            self.max_timestamp = max(self.max_timestamp, batch.header.max_timestamp)
            at += consumed

    def truncate_to_file_pos(self, file_pos: int, new_dirty: int, new_max_ts: int = -1):
        self.flush_buffer()
        was_writable = self._file is not None
        if self._file:
            self._file.close()
        with open(self.data_path, "r+b") as f:
            f.truncate(file_pos)
        self.size_bytes = file_pos
        self.dirty_offset = new_dirty
        self.max_timestamp = new_max_ts
        self.index.truncate_at_pos(file_pos)
        if was_writable:
            self._file = file_sanitizer.maybe_wrap(
                open(self.data_path, "ab"), self.data_path
            )

    def remove(self):
        self.release_appender()
        for p in (self.data_path, self.index.path):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass

    def __repr__(self):
        return f"Segment(base={self.base_offset}, term={self.term}, size={self.size_bytes})"
