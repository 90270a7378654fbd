"""Record / RecordBatch domain model.

Capability parity with the reference's model/record.h:

- ``Record`` — Kafka v2 record: varint-framed {attrs, timestamp_delta,
  offset_delta, key, value, headers}.
- ``RecordBatchHeader`` — the 61-byte packed internal header
  (model/record.h:475-487): little-endian, leading ``header_crc`` (CRC-32C of
  the remaining 57 header bytes, model/record_utils.cc internal_header_only_crc)
  plus the Kafka ``crc`` field (CRC-32C computed per Kafka semantics: header
  fields big-endian from attributes onward, then the records payload —
  model/record_utils.cc:34-91).
- ``RecordBatch`` — header + records, encodable either in the internal
  storage layout or the Kafka wire RecordBatch v2 layout

Byte-identical on the wire to the JAX package's models/record.py (the port
keeps its own copy so that it imports nothing of that package). Batches are
kept as contiguous `bytes` payloads so they can be scattered into
fixed-shape device staging buffers without re-serialization; per-record
access lazily parses the payload.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field, replace

from redpanda_tpu_torch.hashing.crc32c import Crc32c, crc32c
from redpanda_tpu_torch.utils.vint import decode_zigzag, encode_zigzag

INTERNAL_HEADER_SIZE = 61  # bytes; model/record.h:475-487


class RecordBatchType(enum.IntEnum):
    """Batch types multiplexed onto logs (parity with model::record_batch_type)."""

    raft_data = 1
    raft_configuration = 2
    controller = 3
    kvstore = 4
    checkpoint = 5
    topic_management_cmd = 6
    ghost_batch = 7
    id_allocator = 8
    tx_prepare = 9
    tx_fence = 10
    tm_update = 11
    user_management_cmd = 12
    acl_management_cmd = 13
    group_prepare_tx = 14
    group_commit_tx = 15
    group_abort_tx = 16
    node_management_cmd = 17
    data_policy_management_cmd = 18
    archival_metadata = 19


class Compression(enum.IntEnum):
    """Codec ids as stored in batch attributes bits 0-2 (Kafka encoding)."""

    none = 0
    gzip = 1
    snappy = 2
    lz4 = 3
    zstd = 4


class TimestampType(enum.IntEnum):
    create_time = 0
    append_time = 1


ATTR_COMPRESSION_MASK = 0x7
ATTR_TIMESTAMP_TYPE = 0x8
ATTR_TRANSACTIONAL = 0x10
ATTR_CONTROL = 0x20


@dataclass(frozen=True)
class RecordHeader:
    key: bytes
    value: bytes | None


@dataclass(frozen=True)
class Record:
    attributes: int = 0
    timestamp_delta: int = 0
    offset_delta: int = 0
    key: bytes | None = None
    value: bytes | None = None
    headers: tuple[RecordHeader, ...] = ()

    def encode(self) -> bytes:
        body = bytearray()
        body += struct.pack("b", self.attributes)
        body += encode_zigzag(self.timestamp_delta)
        body += encode_zigzag(self.offset_delta)
        if self.key is None:
            body += encode_zigzag(-1)
        else:
            body += encode_zigzag(len(self.key))
            body += self.key
        if self.value is None:
            body += encode_zigzag(-1)
        else:
            body += encode_zigzag(len(self.value))
            body += self.value
        body += encode_zigzag(len(self.headers))
        for h in self.headers:
            body += encode_zigzag(len(h.key))
            body += h.key
            if h.value is None:
                body += encode_zigzag(-1)
            else:
                body += encode_zigzag(len(h.value))
                body += h.value
        # bytes + bytearray concatenates to bytes: one copy, not three
        return encode_zigzag(len(body)) + body

    @staticmethod
    def decode(buf, offset: int = 0) -> tuple["Record", int]:
        def take(pos: int, n: int) -> bytes:
            if n < 0 or pos + n > len(buf):
                raise ValueError(f"truncated record: need {n} bytes at {pos}, have {len(buf)}")
            return bytes(buf[pos : pos + n])

        start = offset
        length, n = decode_zigzag(buf, offset)
        offset += n
        end = offset + length
        if end > len(buf):
            raise ValueError(f"truncated record: body ends at {end}, buffer has {len(buf)}")
        attributes = struct.unpack_from("b", take(offset, 1))[0]
        offset += 1
        ts_delta, n = decode_zigzag(buf, offset)
        offset += n
        off_delta, n = decode_zigzag(buf, offset)
        offset += n
        klen, n = decode_zigzag(buf, offset)
        offset += n
        key = None
        if klen >= 0:
            key = take(offset, klen)
            offset += klen
        vlen, n = decode_zigzag(buf, offset)
        offset += n
        value = None
        if vlen >= 0:
            value = take(offset, vlen)
            offset += vlen
        hcount, n = decode_zigzag(buf, offset)
        offset += n
        headers = []
        for _ in range(hcount):
            hklen, n = decode_zigzag(buf, offset)
            offset += n
            hkey = take(offset, hklen)
            offset += hklen
            hvlen, n = decode_zigzag(buf, offset)
            offset += n
            hval = None
            if hvlen >= 0:
                hval = take(offset, hvlen)
                offset += hvlen
            headers.append(RecordHeader(hkey, hval))
        if offset != end:
            raise ValueError(f"record decode mismatch: ended at {offset}, expected {end}")
        return Record(attributes, ts_delta, off_delta, key, value, tuple(headers)), offset - start


@dataclass
class RecordBatchHeader:
    header_crc: int = 0
    size_bytes: int = 0  # header + payload
    base_offset: int = 0
    type: RecordBatchType = RecordBatchType.raft_data
    crc: int = 0  # Kafka CRC-32C (attributes..records)
    attrs: int = 0
    last_offset_delta: int = 0
    first_timestamp: int = 0
    max_timestamp: int = 0
    producer_id: int = -1
    producer_epoch: int = -1
    base_sequence: int = -1
    record_count: int = 0
    # Runtime-only (not part of the 61 packed bytes; parity with
    # record_batch_header::context):
    term: int = -1

    _PACK = "<IiqbiHiqqqhii"  # 61 bytes, little-endian

    @property
    def last_offset(self) -> int:
        return self.base_offset + self.last_offset_delta

    @property
    def compression(self) -> Compression:
        return Compression(self.attrs & ATTR_COMPRESSION_MASK)

    @property
    def is_transactional(self) -> bool:
        return bool(self.attrs & ATTR_TRANSACTIONAL)

    @property
    def is_control(self) -> bool:
        return bool(self.attrs & ATTR_CONTROL)

    def internal_header_only_crc(self) -> int:
        """CRC-32C over the post-header_crc header fields, little-endian
        (model/record_utils.cc internal_header_only_crc)."""
        c = Crc32c()
        c.extend_le(
            "iqbiHiqqqhii",
            self.size_bytes,
            self.base_offset,
            int(self.type),
            _i32(self.crc),
            self.attrs,
            self.last_offset_delta,
            self.first_timestamp,
            self.max_timestamp,
            self.producer_id,
            self.producer_epoch,
            self.base_sequence,
            self.record_count,
        )
        return c.value()

    def kafka_header_crc_prefix(self) -> bytes:
        """The big-endian header-field prefix covered by the Kafka CRC
        (attributes .. record_count), per model/record_utils.cc:34-70."""
        return struct.pack(
            ">hiqqqhii",
            self.attrs,
            self.last_offset_delta,
            self.first_timestamp,
            self.max_timestamp,
            self.producer_id,
            self.producer_epoch,
            self.base_sequence,
            self.record_count,
        )

    def encode(self) -> bytes:
        return struct.pack(
            self._PACK,
            self.header_crc & 0xFFFFFFFF,
            self.size_bytes,
            self.base_offset,
            int(self.type),
            _i32(self.crc),
            self.attrs,
            self.last_offset_delta,
            self.first_timestamp,
            self.max_timestamp,
            self.producer_id,
            self.producer_epoch,
            self.base_sequence,
            self.record_count,
        )

    @staticmethod
    def decode(buf, offset: int = 0) -> "RecordBatchHeader":
        (
            header_crc,
            size_bytes,
            base_offset,
            btype,
            crc,
            attrs,
            last_offset_delta,
            first_timestamp,
            max_timestamp,
            producer_id,
            producer_epoch,
            base_sequence,
            record_count,
        ) = struct.unpack_from(RecordBatchHeader._PACK, buf, offset)
        return RecordBatchHeader(
            header_crc=header_crc,
            size_bytes=size_bytes,
            base_offset=base_offset,
            type=RecordBatchType(btype),
            crc=crc & 0xFFFFFFFF,
            attrs=attrs,
            last_offset_delta=last_offset_delta,
            first_timestamp=first_timestamp,
            max_timestamp=max_timestamp,
            producer_id=producer_id,
            producer_epoch=producer_epoch,
            base_sequence=base_sequence,
            record_count=record_count,
        )


def _i32(v: int) -> int:
    """Clamp an unsigned 32-bit value into the signed range for struct 'i'."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


@dataclass
class RecordBatch:
    """Header + raw records payload (possibly compressed).

    ``payload`` is the byte-exact Kafka records section: concatenated
    varint-framed records, or the codec-compressed form when
    header.compression != none.
    """

    header: RecordBatchHeader
    payload: bytes

    # ------------------------------------------------------------ build
    @staticmethod
    def build(
        records: list[Record],
        *,
        base_offset: int = 0,
        type: RecordBatchType = RecordBatchType.raft_data,
        compression: Compression = Compression.none,
        first_timestamp: int = 0,
        max_timestamp: int | None = None,
        producer_id: int = -1,
        producer_epoch: int = -1,
        base_sequence: int = -1,
        transactional: bool = False,
        control: bool = False,
        compressor=None,
    ) -> "RecordBatch":
        payload = b"".join(r.encode() for r in records)
        attrs = int(compression) & ATTR_COMPRESSION_MASK
        if transactional:
            attrs |= ATTR_TRANSACTIONAL
        if control:
            attrs |= ATTR_CONTROL
        if compression != Compression.none:
            if compressor is None:
                from redpanda_tpu_torch.compression import compress as compressor
            payload = compressor(payload, compression)
        hdr = RecordBatchHeader(
            base_offset=base_offset,
            type=type,
            attrs=attrs,
            last_offset_delta=(records[-1].offset_delta if records else 0),
            first_timestamp=first_timestamp,
            max_timestamp=max_timestamp if max_timestamp is not None else first_timestamp,
            producer_id=producer_id,
            producer_epoch=producer_epoch,
            base_sequence=base_sequence,
            record_count=len(records),
        )
        hdr.size_bytes = INTERNAL_HEADER_SIZE + len(payload)
        batch = RecordBatch(hdr, payload)
        batch.reseal()
        return batch

    def reseal(self) -> "RecordBatch":
        """Recompute both CRCs (e.g. after a transform rewrote the payload)."""
        self.header.size_bytes = INTERNAL_HEADER_SIZE + len(self.payload)
        self.header.crc = crc32c(self.header.kafka_header_crc_prefix() + self.payload)
        self.header.header_crc = self.header.internal_header_only_crc()
        return self

    # ------------------------------------------------------------ verify
    def crc_region(self) -> bytes:
        """The byte region covered by the Kafka CRC (header prefix +
        payload) — what the device batch validator hashes
        (kafka_batch_adapter.cc:93 equivalent)."""
        return self.header.kafka_header_crc_prefix() + self.payload

    def verify_kafka_crc(self) -> bool:
        return self.header.crc == crc32c(self.crc_region())

    def verify_header_crc(self) -> bool:
        return self.header.header_crc == self.header.internal_header_only_crc()

    # ------------------------------------------------------------ access
    def records(self, decompressor=None) -> list[Record]:
        payload = self.payload
        if self.header.compression != Compression.none:
            if decompressor is None:
                from redpanda_tpu_torch.compression import uncompress as decompressor
            payload = decompressor(payload, self.header.compression)
        out = []
        offset = 0
        for _ in range(self.header.record_count):
            rec, n = Record.decode(payload, offset)
            out.append(rec)
            offset += n
        return out

    def record_values(self) -> list[bytes]:
        return [r.value or b"" for r in self.records()]

    @property
    def base_offset(self) -> int:
        return self.header.base_offset

    @property
    def last_offset(self) -> int:
        return self.header.last_offset

    @property
    def size_bytes(self) -> int:
        return self.header.size_bytes

    def with_base_offset(self, base_offset: int) -> "RecordBatch":
        hdr = replace(self.header, base_offset=base_offset)
        batch = RecordBatch(hdr, self.payload)
        hdr.header_crc = hdr.internal_header_only_crc()
        return batch

    # ------------------------------------------------------------ storage io
    def encode_internal(self) -> bytes:
        """Internal on-disk layout: 61-byte LE header + payload."""
        return self.header.encode() + self.payload

    @staticmethod
    def peek_size(buf, offset: int = 0) -> int:
        """Total frame length (size_bytes field, 4 bytes in at offset 4)
        without decoding — lets readers grow a bounded window to frame
        boundaries before decode_internal."""
        if len(buf) - offset < 8:
            raise CorruptBatchError("truncated batch header")
        return int(struct.unpack_from("<i", buf, offset + 4)[0])

    @staticmethod
    def decode_internal(buf, offset: int = 0, verify: bool = True) -> tuple["RecordBatch", int]:
        if len(buf) - offset < INTERNAL_HEADER_SIZE:
            raise CorruptBatchError("truncated batch header")
        hdr = RecordBatchHeader.decode(buf, offset)
        if verify and hdr.header_crc != hdr.internal_header_only_crc():
            raise CorruptBatchError(
                f"header_crc mismatch at offset {offset}: "
                f"{hdr.header_crc:#x} != {hdr.internal_header_only_crc():#x}"
            )
        payload_len = hdr.size_bytes - INTERNAL_HEADER_SIZE
        start = offset + INTERNAL_HEADER_SIZE
        payload = bytes(buf[start : start + payload_len])
        if len(payload) != payload_len:
            raise CorruptBatchError("truncated batch payload")
        return RecordBatch(hdr, payload), hdr.size_bytes


class CorruptBatchError(Exception):
    pass
