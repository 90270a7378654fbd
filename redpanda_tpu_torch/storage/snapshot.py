"""General snapshot file format (the JAX package's storage/snapshot.py,
copied; parity with storage/snapshot.h). The bytes are the JAX package's:
a snapshot written by either package reads in the other.

Layout: magic(4) | version(1) | metadata_len(u32) | metadata_crc(u32) |
metadata | payload_crc(u32) | payload. Both CRCs are CRC-32C. Writes go
through a temp file + atomic rename; `SnapshotManager` keeps the
last-good snapshot per directory.
"""

from __future__ import annotations

import os
import struct

from redpanda_tpu_torch.hashing.crc32c import crc32c

_MAGIC = b"RPSN"
_VERSION = 1
_HDR = struct.Struct("<4sBII")


class SnapshotError(Exception):
    pass


def write_snapshot(path: str, metadata: bytes, payload: bytes) -> None:
    tmp = path + ".partial"
    with open(tmp, "wb") as f:
        f.write(_HDR.pack(_MAGIC, _VERSION, len(metadata), crc32c(metadata)))
        f.write(metadata)
        f.write(struct.pack("<I", crc32c(payload)))
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_snapshot(path: str) -> tuple[bytes, bytes]:
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _HDR.size:
        raise SnapshotError("snapshot too short")
    magic, version, mlen, mcrc = _HDR.unpack_from(blob)
    if magic != _MAGIC or version != _VERSION:
        raise SnapshotError("bad snapshot magic/version")
    meta_end = _HDR.size + mlen
    metadata = blob[_HDR.size : meta_end]
    if len(metadata) != mlen or crc32c(metadata) != mcrc:
        raise SnapshotError("snapshot metadata corrupt")
    (pcrc,) = struct.unpack_from("<I", blob, meta_end)
    payload = blob[meta_end + 4 :]
    if crc32c(payload) != pcrc:
        raise SnapshotError("snapshot payload corrupt")
    return metadata, payload


class SnapshotManager:
    """Named snapshot in a directory with atomic replacement."""

    def __init__(self, dir_path: str, name: str = "snapshot"):
        self.dir = dir_path
        self.path = os.path.join(dir_path, name)
        os.makedirs(dir_path, exist_ok=True)

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def write(self, metadata: bytes, payload: bytes) -> None:
        write_snapshot(self.path, metadata, payload)

    def read(self) -> tuple[bytes, bytes] | None:
        if not self.exists():
            return None
        return read_snapshot(self.path)

    def remove(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass
