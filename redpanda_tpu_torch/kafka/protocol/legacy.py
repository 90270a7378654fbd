"""Legacy (magic 0/1) MessageSet up-conversion for old produce versions.

Parity with the reference's legacy path (kafka/protocol/legacy_message.h:40
decode_legacy_batch, kafka/protocol/kafka_batch_adapter.cc
convert_message_set/adapt_with_version): produce v0-2 carries a MessageSet —
a packed sequence of

    offset      int64 BE
    length      int32 BE   (bytes after this field)
    crc         int32 BE   (CRC-32 — zlib crc32, NOT crc32c — over magic..value)
    magic       int8       (0 or 1)
    attributes  int8       (low 3 bits: compression codec)
    [timestamp  int64 BE]  (magic 1 only)
    key         int32-prefixed bytes (-1 = null)
    value       int32-prefixed bytes (-1 = null)

A compressed message's value wraps a nested MessageSet (one level deep).
The whole set converts into ONE v2/internal RecordBatch so the rest of the
produce path (raft, storage, fetch) only ever sees modern batches.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

from redpanda_tpu_torch.models.record import Compression, Record, RecordBatch

# attributes bits 0-2 select the codec (legacy_message.h compression_mask)
_COMPRESSION_MASK = 0x07
_LEGACY_CODECS = {
    0: Compression.none,
    1: Compression.gzip,
    2: Compression.snappy,
    3: Compression.lz4,
}


class LegacyBatchError(Exception):
    """Malformed/unverifiable legacy message set (answers corrupt_message)."""


class LegacyUnsupportedError(Exception):
    """Valid but unsupported legacy form (magic-0 + lz4: Kafka's magic-0 lz4
    framing was buggy and clients themselves refuse it)."""


@dataclass
class _LegacyMessage:
    magic: int
    attributes: int
    timestamp: int | None
    key: bytes | None
    value: bytes | None

    @property
    def compression(self) -> Compression:
        codec = self.attributes & _COMPRESSION_MASK
        if codec not in _LEGACY_CODECS:
            raise LegacyBatchError(f"unknown legacy compression {codec}")
        return _LEGACY_CODECS[codec]


def _decode_one(buf: memoryview, pos: int) -> tuple[_LegacyMessage, int]:
    if len(buf) - pos < 12:
        raise LegacyBatchError("short legacy message header")
    _offset, length = struct.unpack_from(">qi", buf, pos)
    pos += 12
    if length < 6 or pos + length > len(buf):
        raise LegacyBatchError(f"bad legacy message length {length}")
    end = pos + length
    (expected_crc,) = struct.unpack_from(">i", buf, pos)
    # the crc covers everything after the crc field, magic through value
    computed = zlib.crc32(buf[pos + 4 : end]) & 0xFFFFFFFF
    if computed != expected_crc & 0xFFFFFFFF:
        raise LegacyBatchError(
            f"legacy crc mismatch: expected {expected_crc & 0xFFFFFFFF:#x},"
            f" computed {computed:#x}"
        )
    pos += 4
    magic, attributes = struct.unpack_from(">bb", buf, pos)
    pos += 2
    if magic not in (0, 1):
        raise LegacyBatchError(f"expected magic 0 or 1, got {magic}")
    timestamp = None
    if magic == 1:
        if pos + 8 > end:
            raise LegacyBatchError("legacy message too short for timestamp")
        (timestamp,) = struct.unpack_from(">q", buf, pos)
        pos += 8

    def sized(p: int) -> tuple[bytes | None, int]:
        if p + 4 > end:
            raise LegacyBatchError("legacy message too short for kv size")
        (n,) = struct.unpack_from(">i", buf, p)
        p += 4
        if n == -1:
            return None, p
        if n < 0 or p + n > end:
            raise LegacyBatchError(f"bad legacy kv size {n}")
        return bytes(buf[p : p + n]), p + n

    key, pos = sized(pos)
    value, pos = sized(pos)
    if pos != end:
        raise LegacyBatchError("legacy message trailing bytes")
    return _LegacyMessage(magic, attributes, timestamp, key, value), end


def _walk(buf: memoryview, kvs: list, state: dict, nested: bool) -> None:
    pos = 0
    while pos < len(buf):
        msg, pos = _decode_one(buf, pos)
        if msg.timestamp is not None:
            # the LAST message's timestamp stamps the converted batch
            # (kafka_batch_adapter.cc convert_message_set)
            state["timestamp"] = msg.timestamp
        if msg.compression == Compression.none:
            kvs.append((msg.key, msg.value))
            continue
        if msg.magic == 0 and msg.compression == Compression.lz4:
            raise LegacyUnsupportedError(
                "magic=0 lz4 framing is not supported (known-broken in Kafka)"
            )
        if nested:
            raise LegacyBatchError("MessageSet nests more than one level")
        if msg.value is None:
            raise LegacyBatchError("compressed legacy message without value")
        from redpanda_tpu_torch.compression import uncompress

        try:
            inner = uncompress(msg.value, msg.compression)
        except Exception as e:
            # codec-native errors (zlib.error, BadGzipFile, ...) are wire
            # corruption, not server faults: same taxonomy as a bad CRC
            raise LegacyBatchError(f"corrupt compressed legacy value: {e}") from e
        _walk(memoryview(inner), kvs, state, nested=True)


def convert_message_set(buf: bytes | memoryview) -> RecordBatch:
    """MessageSet -> one internal v2 RecordBatch (decompressed: legacy codec
    choice is a transport detail of the dead wire format, not a storage
    property worth preserving through re-compression)."""
    kvs: list[tuple[bytes | None, bytes | None]] = []
    state: dict = {"timestamp": None}
    _walk(memoryview(buf), kvs, state, nested=False)
    if not kvs:
        raise LegacyBatchError("empty legacy message set")
    # magic-0 messages carry no timestamp: stamp NO_TIMESTAMP (-1), not
    # epoch 0 — time-based retention/ListOffsets must not see 1970
    ts = state["timestamp"] if state["timestamp"] is not None else -1
    records = [
        Record(
            attributes=0,
            timestamp_delta=0,
            offset_delta=i,
            key=k,
            value=v,
            headers=(),
        )
        for i, (k, v) in enumerate(kvs)
    ]
    return RecordBatch.build(records, first_timestamp=ts, max_timestamp=ts)
