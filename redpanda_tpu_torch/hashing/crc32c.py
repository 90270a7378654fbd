"""CRC-32C (Castagnoli) — host side.

Capability parity with the reference's ``hashing/crc32c.h`` (which wraps
google/crc32c): an incremental ``Crc32c`` object with ``extend`` over bytes
and fixed-width integers.

Polynomial 0x1EDC6F41 (reflected 0x82F63B78), init 0xFFFFFFFF, xorout
0xFFFFFFFF. Golden vector: crc32c(b"123456789") == 0xE3069283 (RFC 3720).

The port's own build of native/redpanda_native.cc (redpanda_tpu_torch.native)
serves single-buffer CRC when it loads; the numpy path is the fallback.
"""

from __future__ import annotations

import struct

import numpy as np

_POLY = 0x82F63B78


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if (c & 1) else 0)
        table[i] = c
    return table


TABLE = _make_table()

# Slicing-by-8 tables: TABLE8[k][b] = CRC update contribution of byte b seen
# k bytes before the end of an 8-byte group.
def _make_table8() -> np.ndarray:
    t8 = np.zeros((8, 256), dtype=np.uint32)
    t8[0] = TABLE
    for k in range(1, 8):
        t8[k] = TABLE[t8[k - 1] & 0xFF] ^ (t8[k - 1] >> 8)
    return t8


TABLE8 = _make_table8()

_native = None


def _load_native():
    global _native
    if _native is None:
        from redpanda_tpu_torch import native

        _native = native.try_lib() or False
    return _native


def crc32c_update(crc: int, data) -> int:
    """Core update: crc is the *internal* state (already inverted).

    Accepts any C-contiguous buffer (bytes, bytearray, memoryview): the
    produce path hands us zero-copy views of the network frame and must not
    pay a materialization per batch.
    """
    native = _load_native()
    if native:
        if not isinstance(data, bytes):
            data = bytes(data)  # ctypes c_char_p needs an owned contiguous blob
        return native.crc32c_update(crc, data)
    buf = np.frombuffer(data, dtype=np.uint8)
    c = np.uint32(crc)
    n = len(buf)
    # slicing-by-8 main loop
    i = 0
    t = TABLE8
    while n - i >= 8:
        b = buf[i : i + 8]
        c = np.uint32(c) ^ np.uint32(
            b[0] | (np.uint32(b[1]) << 8) | (np.uint32(b[2]) << 16) | (np.uint32(b[3]) << 24)
        )
        c = (
            t[7][c & 0xFF]
            ^ t[6][(c >> 8) & 0xFF]
            ^ t[5][(c >> 16) & 0xFF]
            ^ t[4][(c >> 24) & 0xFF]
            ^ t[3][b[4]]
            ^ t[2][b[5]]
            ^ t[1][b[6]]
            ^ t[0][b[7]]
        )
        i += 8
    while i < n:
        c = TABLE[(np.uint32(c) ^ buf[i]) & 0xFF] ^ (np.uint32(c) >> 8)
        i += 1
    return int(c)


def crc32c(data, value: int = 0) -> int:
    """CRC-32C of data, optionally continuing from a previous *final* value."""
    state = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    state = crc32c_update(state, data)
    return state ^ 0xFFFFFFFF


def crc32c_extend(crc: int, data) -> int:
    return crc32c(data, crc)


class Crc32c:
    """Incremental CRC mirroring crc::crc32c (hashing/crc32c.h:19-40):
    extend() over raw bytes and over little/big-endian fixed-width ints."""

    __slots__ = ("_state",)

    def __init__(self) -> None:
        self._state = 0xFFFFFFFF

    def extend(self, data) -> "Crc32c":
        self._state = crc32c_update(self._state, data)  # pandalint: disable=RAC1101 -- Crc32c instances are per-call locals (built, extended, read, dropped inside one function); the multi-context affinity comes from callers in different contexts each using their OWN instance
        return self

    def extend_le(self, fmt: str, *values) -> "Crc32c":
        return self.extend(struct.pack("<" + fmt, *values))

    def extend_be(self, fmt: str, *values) -> "Crc32c":
        return self.extend(struct.pack(">" + fmt, *values))

    def value(self) -> int:
        return self._state ^ 0xFFFFFFFF
