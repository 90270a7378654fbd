"""Host-side record-batch explode/rebuild for the engine data path.

The per-record work (varint framing parse, JSON walk, framing) runs in the
native library (native/redpanda_native.cc through redpanda_tpu_torch.native);
Python only touches per-batch metadata. This is the JAX package's staged
lane (coproc/batch_codec.py): explode -> [device] -> frame -> seal, with the
same bytes at every step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from redpanda_tpu_torch import native
from redpanda_tpu_torch.compression import compress, registry, uncompress
from redpanda_tpu_torch.models.record import Compression, RecordBatch, RecordBatchHeader


@dataclass
class ExplodedBatches:
    """All record values of a batch list, as offsets into one joined blob."""

    joined: bytes
    offsets: np.ndarray  # int64 [N]
    sizes: np.ndarray  # int32 [N] (null values -> 0)
    ranges: list[tuple[int, int]]  # per input batch: [start, end) in N


def _gather_payloads(batches: list[RecordBatch]):
    """Decompress + concatenate batch payloads."""
    payloads: list[bytes] = []
    counts = np.empty(len(batches), np.int32)
    p_off = np.empty(len(batches), np.int64)
    p_len = np.empty(len(batches), np.int32)
    ranges: list[tuple[int, int]] = []
    base = 0
    n = 0
    for i, b in enumerate(batches):
        payload = b.payload
        if b.header.compression != Compression.none:
            payload = uncompress(payload, b.header.compression)
        count = b.header.record_count
        payloads.append(payload)
        counts[i] = count
        p_off[i] = base
        p_len[i] = len(payload)
        ranges.append((n, n + count))
        base += len(payload)
        n += count
    return counts, p_off, p_len, ranges, b"".join(payloads), n


def _empty(joined: bytes, ranges) -> ExplodedBatches:
    return ExplodedBatches(joined, np.zeros(0, np.int64), np.zeros(0, np.int32), ranges)


def explode_and_find(batches: list[RecordBatch], paths: list[str]):
    """Fused explode + find (rp_explode_find): framing parse and the k-path
    JSON walk in one native crossing. Returns (ExplodedBatches, types, vs,
    ve), or None when there are no paths (the caller explodes alone)."""
    if not paths:
        return None
    counts, p_off, p_len, ranges, joined, n = _gather_payloads(batches)
    if n == 0:
        k = len(paths)
        return (
            _empty(joined, ranges),
            np.zeros((0, k), np.int8), np.zeros((0, k), np.int64), np.zeros((0, k), np.int64),
        )
    off, ln, types, vs, ve = native.lib().explode_find(joined, p_off, p_len, counts, paths)
    return ExplodedBatches(joined, off, np.maximum(ln, 0), ranges), types, vs, ve


def explode_batches(batches: list[RecordBatch]) -> ExplodedBatches:
    """Record value offsets/sizes of every batch, in one native crossing."""
    counts, p_off, p_len, ranges, joined, n = _gather_payloads(batches)
    if n == 0:
        return _empty(joined, ranges)
    off, ln = native.lib().parse_many(joined, p_off, p_len, counts)
    return ExplodedBatches(joined, off, np.maximum(ln, 0), ranges)


def frame_ranges(
    rows: np.ndarray, lens: np.ndarray, keep: np.ndarray, ranges: list[tuple[int, int]]
) -> list[tuple[bytes, int]]:
    """Frame every [start, end) record range of a launch in one native
    crossing (rp_frame_many): [(payload, kept)] per range."""
    if not ranges:
        return []
    starts = np.fromiter((s for s, _ in ranges), np.int64, len(ranges))
    ends = np.fromiter((e for _, e in ranges), np.int64, len(ranges))
    dst, off, ln, kept = native.lib().frame_many(rows, lens, keep, starts, ends)
    return [(dst[off[i] : off[i] + ln[i]].tobytes(), int(kept[i])) for i in range(len(ranges))]


def build_output_batch(
    source: RecordBatch,
    payload: bytes,
    kept: int,
    *,
    compress_threshold: int = 512,
    codec: Compression = Compression.zstd,
) -> RecordBatch | None:
    """Seal a framed payload into a materialized output batch: term reset,
    recompression above a size threshold, fresh CRCs. Returns None when no
    record survives the transform."""
    if kept == 0:
        return None
    attrs = 0
    if len(payload) >= compress_threshold and codec != Compression.none:
        if not registry.is_available(codec):
            # degrade, don't drop: a missing optional codec library must
            # not silently discard every transformed batch (gzip is stdlib)
            codec = Compression.gzip
        payload = compress(payload, codec)
        attrs = int(codec)
    hdr = RecordBatchHeader(
        base_offset=0,  # assigned by the materialized log appender
        type=source.header.type,
        attrs=attrs,
        last_offset_delta=kept - 1,
        first_timestamp=source.header.first_timestamp,
        max_timestamp=source.header.max_timestamp,
        record_count=kept,
        term=0,
    )
    batch = RecordBatch(hdr, payload)
    batch.reseal()
    return batch
