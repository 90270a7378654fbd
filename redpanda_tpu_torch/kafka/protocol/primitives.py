"""Kafka wire primitives.

Parity with the reference's kafka/protocol/{request_reader.h,
response_writer.h}: big-endian fixed ints, varint/uvarint (protobuf
zig-zag for signed), STRING / NULLABLE_STRING / COMPACT_STRING, BYTES
variants, ARRAY / COMPACT_ARRAY, UUID, and KIP-482 tagged fields for
flexible versions.
"""

from __future__ import annotations

import struct


class Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes | bytearray | memoryview, pos: int = 0):
        self.buf = memoryview(buf)
        self.pos = pos

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise EOFError(f"kafka reader underflow: need {n}, have {self.remaining()}")
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v

    def int8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def int16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def int32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def int64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def uint32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def float64(self) -> float:
        return struct.unpack(">d", self._take(8))[0]

    def boolean(self) -> bool:
        return self.int8() != 0

    def uvarint(self) -> int:
        shift = 0
        result = 0
        while True:
            b = self._take(1)[0]
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                return result
            shift += 7
            if shift > 63:
                raise ValueError("uvarint too long")

    def varint(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)

    def uuid(self) -> bytes:
        return bytes(self._take(16))

    def string(self) -> str:
        n = self.int16()
        if n < 0:
            raise ValueError("non-nullable string was null")
        return bytes(self._take(n)).decode("utf-8")

    def nullable_string(self) -> str | None:
        n = self.int16()
        if n < 0:
            return None
        return bytes(self._take(n)).decode("utf-8")

    def compact_string(self) -> str:
        n = self.uvarint() - 1
        if n < 0:
            raise ValueError("non-nullable compact string was null")
        return bytes(self._take(n)).decode("utf-8")

    def compact_nullable_string(self) -> str | None:
        n = self.uvarint() - 1
        if n < 0:
            return None
        return bytes(self._take(n)).decode("utf-8")

    def bytes_(self) -> bytes:
        n = self.int32()
        if n < 0:
            raise ValueError("non-nullable bytes was null")
        return bytes(self._take(n))

    def nullable_bytes(self) -> bytes | None:
        n = self.int32()
        if n < 0:
            return None
        return bytes(self._take(n))

    def compact_bytes(self) -> bytes:
        n = self.uvarint() - 1
        if n < 0:
            raise ValueError("non-nullable compact bytes was null")
        return bytes(self._take(n))

    def compact_nullable_bytes(self) -> bytes | None:
        n = self.uvarint() - 1
        if n < 0:
            return None
        return bytes(self._take(n))

    def array(self, fn) -> list | None:
        n = self.int32()
        if n < 0:
            return None
        return [fn(self) for _ in range(n)]

    def compact_array(self, fn) -> list | None:
        n = self.uvarint() - 1
        if n < 0:
            return None
        return [fn(self) for _ in range(n)]

    def tagged_fields(self) -> dict[int, bytes]:
        """KIP-482 unknown-tag passthrough: {tag: raw bytes}."""
        out: dict[int, bytes] = {}
        for _ in range(self.uvarint()):
            tag = self.uvarint()
            size = self.uvarint()
            out[tag] = bytes(self._take(size))  # pandalint: disable=IOB401 -- passthrough tags outlive the frame buffer; they must own their bytes
        return out


class Writer:
    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list[bytes] = []

    def build(self) -> bytes:
        return b"".join(self._parts)

    def size(self) -> int:
        return sum(len(p) for p in self._parts)

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(bytes(b))
        return self

    def int8(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">b", v))
        return self

    def int16(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">h", v))
        return self

    def int32(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">i", v))
        return self

    def int64(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">q", v))
        return self

    def uint32(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">I", v & 0xFFFFFFFF))
        return self

    def float64(self, v: float) -> "Writer":
        self._parts.append(struct.pack(">d", v))
        return self

    def boolean(self, v: bool) -> "Writer":
        return self.int8(1 if v else 0)

    def uvarint(self, v: int) -> "Writer":
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        self._parts.append(bytes(out))
        return self

    def varint(self, v: int) -> "Writer":
        return self.uvarint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def uuid(self, v: bytes) -> "Writer":
        assert len(v) == 16
        self._parts.append(v)
        return self

    def string(self, v: str) -> "Writer":
        b = v.encode("utf-8")
        return self.int16(len(b)).raw(b)

    def nullable_string(self, v: str | None) -> "Writer":
        if v is None:
            return self.int16(-1)
        return self.string(v)

    def compact_string(self, v: str) -> "Writer":
        b = v.encode("utf-8")
        return self.uvarint(len(b) + 1).raw(b)

    def compact_nullable_string(self, v: str | None) -> "Writer":
        if v is None:
            return self.uvarint(0)
        return self.compact_string(v)

    def bytes_(self, v: bytes) -> "Writer":
        return self.int32(len(v)).raw(v)

    def nullable_bytes(self, v: bytes | None) -> "Writer":
        if v is None:
            return self.int32(-1)
        return self.bytes_(v)

    def compact_bytes(self, v: bytes) -> "Writer":
        return self.uvarint(len(v) + 1).raw(v)

    def compact_nullable_bytes(self, v: bytes | None) -> "Writer":
        if v is None:
            return self.uvarint(0)
        return self.compact_bytes(v)

    def array(self, items, fn) -> "Writer":
        if items is None:
            return self.int32(-1)
        self.int32(len(items))
        for it in items:
            fn(self, it)
        return self

    def compact_array(self, items, fn) -> "Writer":
        if items is None:
            return self.uvarint(0)
        self.uvarint(len(items) + 1)
        for it in items:
            fn(self, it)
        return self

    def tagged_fields(self, fields: dict[int, bytes] | None = None) -> "Writer":
        fields = fields or {}
        self.uvarint(len(fields))
        for tag in sorted(fields):
            self.uvarint(tag).uvarint(len(fields[tag])).raw(fields[tag])
        return self
