"""Log compaction: key-index build (with disk spill) + segment rewrite (the
JAX package's storage/compaction.py, copied: a compacted segment is byte
for byte the JAX package's on the same input and the same cutoff).

Behavior parity with the reference's storage compaction stack
(segment_utils.cc:517 self_compact_segment, spill_key_index.cc,
compaction_reducers.h), redesigned for this engine's storage layout:

- A whole-log key index maps record key -> the highest log offset holding
  that key. It is built oldest->newest in one pass; when it outgrows the
  in-memory bound it spills sorted runs to disk and stream-merges them
  (the reference's spill_key_index writes compacted-index files for the
  same reason: bounded memory over unbounded key spaces).
- Every CLOSED segment is rewritten in place (atomic tmp+rename): a data
  record survives only if it is the latest occurrence of its key.
  Offsets are immutable — surviving records keep their original
  offset_delta, batch headers keep base_offset and last_offset_delta, so
  compaction only ever creates gaps, never renumbers (Kafka semantics).
- Non-data batches (raft config, control markers, tx markers) pass through
  verbatim: compaction applies to the Kafka data plane only.
- The final batch of each segment is never dropped outright (it shrinks to
  record_count=0 if everything in it is shadowed) so the segment's dirty
  offset — and with it the log's next-offset accounting — is preserved.
- Tombstones (null value) survive while they are the latest write for
  their key and are dropped once older than delete_retention_ms, matching
  delete.retention.ms semantics.

The per-record hot work (key extraction, re-framing) rides the existing
native record codecs; compaction itself is IO-bound and stays host-side by
design (Python per batch, C per record, the card per byte).
"""

from __future__ import annotations

import heapq
import logging
import os
import struct
import tempfile
import time

from redpanda_tpu_torch.models.record import (
    INTERNAL_HEADER_SIZE,
    Compression,
    Record,
    RecordBatch,
    RecordBatchType,
)

logger = logging.getLogger("rptorch.storage.compaction")

# Keys held in memory before a sorted run spills to disk.
DEFAULT_MAX_KEYS_IN_MEMORY = 128 * 1024


class KeyLatestIndex:
    """key bytes -> highest offset, with sorted-run spill above a bound."""

    def __init__(self, max_keys_in_memory: int = DEFAULT_MAX_KEYS_IN_MEMORY):
        self._mem: dict[bytes, int] = {}
        self._max = max_keys_in_memory
        self._runs: list[str] = []
        self._spill_dir: str | None = None

    def put(self, key: bytes, offset: int) -> None:
        cur = self._mem.get(key)
        if cur is None or offset > cur:
            self._mem[key] = offset
        if len(self._mem) >= self._max:
            self._spill()

    def _spill(self) -> None:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="rptorch-compact-")
        path = os.path.join(self._spill_dir, f"run-{len(self._runs)}.idx")
        with open(path, "wb") as f:
            for key in sorted(self._mem):
                f.write(struct.pack("<Iq", len(key), self._mem[key]))
                f.write(key)
        self._runs.append(path)
        self._mem.clear()

    @staticmethod
    def _iter_run(path: str):
        with open(path, "rb") as f:
            while True:
                hdr = f.read(12)
                if len(hdr) < 12:
                    return
                klen, off = struct.unpack("<Iq", hdr)
                yield f.read(klen), off

    def finish(self) -> dict[bytes, int]:
        """Merge memory + spilled runs into the final latest-offset map."""
        if not self._runs:
            return self._mem
        merged: dict[bytes, int] = dict(self._mem)
        for key, off in heapq.merge(*(self._iter_run(p) for p in self._runs)):
            cur = merged.get(key)
            if cur is None or off > cur:
                merged[key] = off
        self.cleanup()
        return merged

    def cleanup(self) -> None:
        for p in self._runs:
            try:
                os.remove(p)
            except OSError:
                pass
        self._runs.clear()
        if self._spill_dir is not None:
            try:
                os.rmdir(self._spill_dir)
            except OSError:
                pass
            self._spill_dir = None


def _iter_batches(blob: bytes):
    at = 0
    while at + INTERNAL_HEADER_SIZE <= len(blob):
        batch, consumed = RecordBatch.decode_internal(blob, at)
        yield batch
        at += consumed


def build_key_index(
    segments, *, max_keys_in_memory: int = DEFAULT_MAX_KEYS_IN_MEMORY
) -> dict[bytes, int]:
    """Latest offset per key over the given segments (oldest -> newest)."""
    idx = KeyLatestIndex(max_keys_in_memory)
    for seg in segments:
        for batch in _iter_batches(seg.read_from(0)):
            if batch.header.type != RecordBatchType.raft_data or batch.header.is_control:
                continue
            base = batch.base_offset
            for rec in batch.records():
                if rec.key is not None:
                    idx.put(rec.key, base + rec.offset_delta)
    return idx.finish()


def self_compact_segment(
    seg,
    key_index: dict[bytes, int],
    *,
    tombstone_cutoff_ms: int | None = None,
) -> tuple[int, int]:
    """Rewrite one closed segment keeping only live records.

    Returns (bytes_before, bytes_after). The caller holds the log lock.
    """
    assert not seg.writable, "only closed segments are compacted"
    blob = seg.read_from(0)
    out = bytearray()
    batches = list(_iter_batches(blob))
    for i, batch in enumerate(batches):
        is_final = i == len(batches) - 1
        if batch.header.type != RecordBatchType.raft_data or batch.header.is_control:
            out += batch.encode_internal()
            continue
        base = batch.base_offset
        kept: list[Record] = []
        for rec in batch.records():
            if rec.key is None:
                kept.append(rec)  # keyless records cannot be compacted
                continue
            off = base + rec.offset_delta
            if key_index.get(rec.key, off) > off:
                continue  # shadowed by a newer write of the same key
            if (
                rec.value is None
                and tombstone_cutoff_ms is not None
                and batch.header.max_timestamp < tombstone_cutoff_ms
            ):
                continue  # expired tombstone
            kept.append(rec)
        if len(kept) == batch.header.record_count:
            out += batch.encode_internal()
            continue
        if not kept and not is_final:
            continue  # fully shadowed: drop the batch (offset gap, like Kafka)
        # shrink in place: original offset deltas + last_offset_delta keep
        # the offset math identical for readers and for the next append
        hdr = batch.header
        payload = b"".join(r.encode() for r in kept)
        attrs = hdr.attrs
        codec = hdr.compression
        if codec != Compression.none and payload:
            from redpanda_tpu_torch.compression import compress

            payload = compress(payload, codec)
        elif not payload:
            attrs &= ~0x07  # empty batches are stored uncompressed
        import dataclasses

        new_hdr = dataclasses.replace(
            hdr, attrs=attrs, record_count=len(kept), size_bytes=0
        )
        nb = RecordBatch(new_hdr, payload)
        nb.reseal()
        out += nb.encode_internal()
    before = seg.size_bytes
    if len(out) == before:
        return before, before
    tmp = seg.data_path + ".compact.tmp"
    with open(tmp, "wb") as f:
        f.write(out)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, seg.data_path)
    seg.size_bytes = len(out)
    seg.rebuild_index(bytes(out))
    seg.index.persist(seg.dirty_offset, seg.max_timestamp)
    return before, len(out)


async def compact_log(
    log,
    *,
    delete_retention_ms: int | None = None,
    max_keys_in_memory: int = DEFAULT_MAX_KEYS_IN_MEMORY,
) -> tuple[int, int]:
    """Compact every closed segment of a log. Returns (bytes_before, after).

    The key index spans the WHOLE log including the active segment, so a
    record in a closed segment is dropped when a newer write exists even if
    that write is still in the active head (self-compaction with whole-log
    shadowing, one pass).
    """
    async with log._lock:
        closed = [s for s in log.segments if not s.writable]
        if not closed:
            return 0, 0
        key_index = build_key_index(
            log.segments, max_keys_in_memory=max_keys_in_memory
        )
        cutoff = (
            int(time.time() * 1000) - delete_retention_ms
            if delete_retention_ms is not None
            else None
        )
        before = after = 0
        for seg in closed:
            b, a = self_compact_segment(seg, key_index, tombstone_cutoff_ms=cutoff)
            before += b
            after += a
        if before != after:
            logger.info(
                "compacted %s: %d -> %d bytes (%d closed segments)",
                log.ntp, before, after, len(closed),
            )
        return before, after
