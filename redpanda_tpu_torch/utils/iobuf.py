"""Fragmented buffer — the data-plane currency (the JAX package's
utils/iobuf.py, copied).

Capability parity with the reference's ``bytes/iobuf.h``: an append-only
sequence of fragments supporting zero-copy share/slice, cheap concatenation,
and linearization only at API boundaries (wire encode, device packing).

On the host side Python's ``memoryview`` gives refcounted zero-copy
windows.
"""

from __future__ import annotations


class IOBuf:
    __slots__ = ("_frags", "_size")

    def __init__(self, data: bytes | bytearray | memoryview | None = None):
        self._frags: list[memoryview] = []
        self._size = 0
        if data is not None:
            self.append(data)

    def append(self, data) -> "IOBuf":
        if isinstance(data, IOBuf):
            self._frags.extend(data._frags)
            self._size += data._size
        else:
            mv = memoryview(data).cast("B")
            if len(mv):
                self._frags.append(mv)
                self._size += len(mv)
        return self

    def prepend(self, data) -> "IOBuf":
        mv = memoryview(data).cast("B")
        if len(mv):
            self._frags.insert(0, mv)
            self._size += len(mv)
        return self

    def __len__(self) -> int:
        return self._size

    def __bytes__(self) -> bytes:
        return b"".join(self._frags)

    def linearize(self) -> bytes:
        """Collapse to one contiguous bytes object (copies)."""
        if len(self._frags) == 1:
            return bytes(self._frags[0])
        return b"".join(self._frags)

    def share(self, pos: int, length: int) -> "IOBuf":
        """Zero-copy sub-window [pos, pos+length)."""
        if pos < 0 or length < 0 or pos + length > self._size:
            raise IndexError("share out of range")
        out = IOBuf()
        remaining = length
        for frag in self._frags:
            if remaining == 0:
                break
            if pos >= len(frag):
                pos -= len(frag)
                continue
            take = min(len(frag) - pos, remaining)
            out.append(frag[pos : pos + take])
            pos = 0
            remaining -= take
        return out

    def fragments(self) -> list[memoryview]:
        return list(self._frags)

    def __eq__(self, other) -> bool:
        if isinstance(other, (bytes, bytearray)):
            return self.linearize() == bytes(other)
        if isinstance(other, IOBuf):
            return len(self) == len(other) and self.linearize() == other.linearize()
        return NotImplemented

    def __repr__(self) -> str:
        return f"IOBuf(size={self._size}, frags={len(self._frags)})"
