"""Variable-length integer codecs.

Capability parity with the reference's ``utils/vint.h`` (LEB128 unsigned
varints and zigzag-encoded signed varints, as used by the Kafka record
format). Layout is the Kafka/protobuf standard: 7 bits per byte, LSB group
first, high bit = continuation.
"""

from __future__ import annotations


def encode_uvarint(value: int) -> bytes:
    if value < 0:
        raise ValueError("uvarint cannot encode negative values")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_uvarint(buf, offset: int = 0) -> tuple[int, int]:
    """Return (value, bytes_consumed) reading from buf[offset:]."""
    result = 0
    shift = 0
    pos = offset
    while True:
        if pos >= len(buf):
            raise ValueError("truncated uvarint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos - offset
        shift += 7
        if shift > 70:
            raise ValueError("uvarint too long")


def encode_zigzag(value: int) -> bytes:
    if value >= 0:
        v = value << 1
    else:
        v = ((~value) << 1) | 1
    return encode_uvarint(v)


def decode_zigzag(buf, offset: int = 0) -> tuple[int, int]:
    u, n = decode_uvarint(buf, offset)
    return (u >> 1) ^ -(u & 1), n


def uvarint_size(value: int) -> int:
    return len(encode_uvarint(value))


def zigzag_size(value: int) -> int:
    return len(encode_zigzag(value))
