"""Kafka wire RecordBatch (v2) <-> internal RecordBatch adapter.

Parity with the reference's kafka_batch_adapter (kafka/server/
kafka_batch_adapter.cc:43-121): the wire layout is

    base_offset       int64   BE
    batch_length      int32   BE   (bytes after this field)
    partition_leader_epoch int32 BE
    magic             int8         (must be 2)
    crc               uint32  BE   (CRC-32C over attributes..records)
    attributes        int16   BE
    last_offset_delta int32   BE
    first_timestamp   int64   BE
    max_timestamp     int64   BE
    producer_id       int64   BE
    producer_epoch    int16   BE
    base_sequence     int32   BE
    record_count      int32   BE
    records           bytes

while the internal layout is the little-endian 61-byte header
(model/record.h:475-487) with a leading header_crc. The records payload is
byte-identical between the two, so adaptation is a header rewrite plus CRC
verification — the CRC itself can be validated host-side or batched onto
the device CRC kernel (redpanda_tpu_torch.ops.crc32c_device).

The produce path MUST verify the wire CRC (kafka_batch_adapter.cc:93-121);
the fetch path re-emits the wire header from the stored internal header.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from redpanda_tpu_torch.hashing.crc32c import crc32c
from redpanda_tpu_torch.models.record import (
    RecordBatch,
    RecordBatchHeader,
    RecordBatchType,
)

WIRE_HEADER_SIZE = 61  # same size as internal, different layout/endianness
_WIRE_PACK = ">qiibIhiqqqhii"
KAFKA_MAGIC = 2

# Offset (from batch start) of the attributes field — the first byte
# covered by the Kafka CRC: 8+4+4+1+4 = 21.
_CRC_COVER_START = 21


@dataclass
class AdaptResult:
    """Outcome of adapting one wire batch (v2_format/valid_crc flags mirror
    kafka_batch_adapter.h)."""

    batch: RecordBatch | None
    v2_format: bool
    valid_crc: bool


def decode_wire_batch(buf: bytes | memoryview, offset: int = 0, verify_crc: bool = True) -> tuple[AdaptResult, int]:
    """Decode one wire RecordBatch starting at ``offset``; returns the
    adapted internal batch and the next offset."""
    buf = memoryview(buf)
    if len(buf) - offset < WIRE_HEADER_SIZE:
        raise EOFError("short wire batch header")
    (
        base_offset,
        batch_length,
        _leader_epoch,
        magic,
        crc,
        attrs,
        last_offset_delta,
        first_timestamp,
        max_timestamp,
        producer_id,
        producer_epoch,
        base_sequence,
        record_count,
    ) = struct.unpack_from(_WIRE_PACK, buf, offset)
    if batch_length < WIRE_HEADER_SIZE - 12:
        # covers negative/zero lengths that would otherwise stall the
        # decode loop or alias overlapping batches
        raise EOFError(f"invalid wire batch_length {batch_length}")
    end = offset + 12 + batch_length  # base_offset + batch_length fields
    if magic != KAFKA_MAGIC:
        return AdaptResult(None, v2_format=False, valid_crc=False), end
    if end > len(buf):
        raise EOFError("short wire batch payload")
    payload = bytes(buf[offset + WIRE_HEADER_SIZE : end])
    valid = True
    if verify_crc:
        # zero-copy: crc32c takes the memoryview straight off the frame —
        # the CRC cover region is the whole batch, copying it per batch
        # doubled produce-path memory traffic
        valid = crc32c(buf[offset + _CRC_COVER_START : end]) == crc
    header = RecordBatchHeader(
        size_bytes=WIRE_HEADER_SIZE + len(payload),
        base_offset=base_offset,
        type=RecordBatchType.raft_data,
        crc=crc,
        attrs=attrs,
        last_offset_delta=last_offset_delta,
        first_timestamp=first_timestamp,
        max_timestamp=max_timestamp,
        producer_id=producer_id,
        producer_epoch=producer_epoch,
        base_sequence=base_sequence,
        record_count=record_count,
    )
    header.header_crc = header.internal_header_only_crc()
    batch = RecordBatch(header=header, payload=payload)
    return AdaptResult(batch, v2_format=True, valid_crc=valid), end


def decode_wire_batches(buf: bytes | memoryview, verify_crc: bool = True) -> list[AdaptResult]:
    """Decode a full produce `records` blob (possibly several batches)."""
    out = []
    pos = 0
    buf = memoryview(buf)
    while pos + WIRE_HEADER_SIZE <= len(buf):
        res, pos = decode_wire_batch(buf, pos, verify_crc=verify_crc)
        out.append(res)
    return out


def encode_wire_batch(batch: RecordBatch) -> bytes:
    """Internal -> wire RecordBatch v2 (batch_reader.h inverse direction)."""
    h = batch.header
    payload = batch.payload
    batch_length = WIRE_HEADER_SIZE - 12 + len(payload)
    return (
        struct.pack(
            _WIRE_PACK,
            h.base_offset,
            batch_length,
            -1,  # partition_leader_epoch: not tracked on disk
            KAFKA_MAGIC,
            h.crc & 0xFFFFFFFF,
            h.attrs,
            h.last_offset_delta,
            h.first_timestamp,
            h.max_timestamp,
            h.producer_id,
            h.producer_epoch,
            h.base_sequence,
            h.record_count,
        )
        + payload
    )


def encode_wire_batches(batches: list[RecordBatch]) -> bytes:
    return b"".join(encode_wire_batch(b) for b in batches)
