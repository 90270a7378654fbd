"""Variable-length records <-> fixed-shape device staging arrays.

The device data plane works on zero-padded uint8 rows [N, row_stride] plus
an int32 length array. Packing is the host-side loop (the native row
packer): scatter record payloads into zero-padded rows; unpack gathers them
back out.

``pack_batches_prefixed`` packs whole record batches as
``kafka_crc_prefix(40B) + payload`` rows, so that a device CRC over each
row's valid prefix equals the batch's Kafka CRC-32C: the rows the
produce-path validator (ops/pipeline.py make_batch_validator) checks.
"""

from __future__ import annotations

import numpy as np

from redpanda_tpu_torch import native
from redpanda_tpu_torch.models.record import RecordBatch


def pack_rows(payloads: list[bytes], row_stride: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack N byte strings into zero-padded uint8 [N, row_stride] + int32
    lengths. Oversized payloads are truncated to the stride (callers bucket
    by size to avoid this)."""
    n = len(payloads)
    sizes = np.fromiter((len(p) for p in payloads), np.int64, n)
    rows = np.empty((n, row_stride), dtype=np.uint8)
    if n:
        offsets = np.zeros(n, dtype=np.int64)
        np.cumsum(sizes[:-1], out=offsets[1:])
        native.lib().pack_rows_into(b"".join(payloads), offsets, sizes.astype(np.int32), rows)
    return rows, np.minimum(sizes, row_stride).astype(np.int32)


def unpack_rows(rows: np.ndarray, lengths: np.ndarray) -> list[bytes]:
    """The first clip(length, 0, stride) bytes of each row."""
    rows = np.asarray(rows, dtype=np.uint8)
    lengths = np.clip(np.asarray(lengths, dtype=np.int64), 0, rows.shape[1])
    if not len(lengths):
        return []
    blob = native.lib().unpack_rows(rows, lengths.astype(np.int32))
    ends = np.cumsum(lengths)
    return [blob[e - m : e] for e, m in zip(ends.tolist(), lengths.tolist())]


def pack_batches_prefixed(
    batches: list[RecordBatch], row_stride: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack batches as their Kafka-CRC-covered bytes.

    Returns (rows uint8 [N, row_stride], lengths int32 [N], claimed CRCs
    uint32 [N]); the CRC of each row's valid prefix equals its claimed CRC
    iff the batch is intact.
    """
    payloads = [b.header.kafka_header_crc_prefix() + b.payload for b in batches]
    rows, lengths = pack_rows(payloads, row_stride)
    crcs = np.array([b.header.crc for b in batches], dtype=np.uint32)
    return rows, lengths, crcs
