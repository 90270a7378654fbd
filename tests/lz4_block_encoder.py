"""A small greedy LZ4 block encoder: a data generator for the LZ4 decoder's
tests and for chip_smoke.py where the system liblz4 cannot be loaded. It is
never on a device path.

It writes the LZ4 block format (lz4_Block_format.md): sequences of a token,
literal-length extension bytes, literals, a 2-byte little-endian offset and
match-length extension bytes, and a last sequence of literals only. Matches
are found through a table of the last position of every 4-byte key; the
last match starts at least 12 bytes before the end and the last 5 bytes
are literals, as the format asks.
"""

from __future__ import annotations

MIN_MATCH = 4
LAST_LITERALS = 5
MF_LIMIT = 12
MAX_OFFSET = 65535


def _length(out: bytearray, n: int) -> None:
    """Extension bytes of a length whose token nibble is 15."""
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)


def _sequence(out: bytearray, literals: bytes, offset: int | None, match_len: int) -> None:
    lit = len(literals)
    ml = match_len - MIN_MATCH if offset is not None else 0
    out.append((min(lit, 15) << 4) | min(ml, 15))
    if lit >= 15:
        _length(out, lit - 15)
    out += literals
    if offset is not None:
        out += offset.to_bytes(2, "little")
        if ml >= 15:
            _length(out, ml - 15)


def lz4_block_encode(data: bytes) -> bytes:
    n = len(data)
    out = bytearray()
    last_pos: dict[bytes, int] = {}
    anchor = i = 0
    while i + MF_LIMIT <= n:
        key = data[i : i + MIN_MATCH]
        cand = last_pos.get(key)
        last_pos[key] = i
        if cand is None or i - cand > MAX_OFFSET:
            i += 1
            continue
        length = MIN_MATCH
        while i + length < n - LAST_LITERALS and data[cand + length] == data[i + length]:
            length += 1
        _sequence(out, data[anchor:i], i - cand, length)
        i += length
        anchor = i
    _sequence(out, data[anchor:], None, 0)
    return bytes(out)
