"""Per-shard durable key-value store (the JAX package's storage/kvstore.py,
copied; parity with storage/kvstore.h:61-91). Its WAL and snapshot bytes
are the JAX package's, so a kvstore directory opens in either package.

Small metadata only — raft voted_for/terms, log start offsets, coproc
offsets — exactly the uses the reference lists. In-memory dict + WAL file
of CRC-framed ops + periodic snapshot; recovery = snapshot + WAL replay.
Keys are namespaced by ``KeySpace``.
"""

from __future__ import annotations

import enum
import os
import struct

from redpanda_tpu_torch.hashing.crc32c import crc32c
from redpanda_tpu_torch.storage import file_sanitizer
from redpanda_tpu_torch.storage.snapshot import SnapshotManager, SnapshotError


class KeySpace(enum.IntEnum):
    testing = 0
    consensus = 1
    storage = 2
    controller = 3
    offset_translator = 4
    coproc = 5


_OP = struct.Struct("<IBBI")  # crc, keyspace, op, key_len  (value_len follows for puts)


class KvStore:
    SNAPSHOT_THRESHOLD = 1 << 20  # snapshot + truncate WAL at 1 MiB

    def __init__(self, dir_path: str):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self._data: dict[tuple[int, bytes], bytes] = {}
        self._snap = SnapshotManager(dir_path, "kvstore.snapshot")
        self._wal_path = os.path.join(dir_path, "kvstore.wal")
        self._wal = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "KvStore":
        snap = None
        try:
            snap = self._snap.read()
        except SnapshotError:
            snap = None  # corrupt snapshot: fall back to WAL-only replay
        if snap:
            _, payload = snap
            self._load_payload(payload)
        self._replay_wal()
        self._wal = file_sanitizer.maybe_wrap(
            open(self._wal_path, "ab"), self._wal_path
        )
        return self

    def stop(self):
        if self._wal is None:
            return  # never started: don't clobber on-disk state with nothing
        self._do_snapshot()
        self._wal.close()
        self._wal = None

    # ------------------------------------------------------------ ops
    def get(self, space: KeySpace, key: bytes) -> bytes | None:
        return self._data.get((int(space), bytes(key)))

    def put(self, space: KeySpace, key: bytes, value: bytes) -> None:
        key, value = bytes(key), bytes(value)
        self._data[(int(space), key)] = value
        self._log_op(space, 0, key, value)

    def remove(self, space: KeySpace, key: bytes) -> None:
        key = bytes(key)
        self._data.pop((int(space), key), None)
        self._log_op(space, 1, key, b"")

    def keys(self, space: KeySpace) -> list[bytes]:
        s = int(space)
        return [k for (sp, k) in self._data if sp == s]

    # ------------------------------------------------------------ internals
    def _log_op(self, space: KeySpace, op: int, key: bytes, value: bytes):
        if self._wal is None:
            raise RuntimeError("kvstore not started")
        body = struct.pack("<BBI", int(space), op, len(key)) + key
        if op == 0:
            body += struct.pack("<I", len(value)) + value
        frame = struct.pack("<I", crc32c(body)) + body
        self._wal.write(struct.pack("<I", len(frame)) + frame)
        self._wal.flush()
        os.fsync(self._wal.fileno())
        if self._wal.tell() >= self.SNAPSHOT_THRESHOLD:
            self._do_snapshot()

    def _replay_wal(self):
        try:
            with open(self._wal_path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return
        at = 0
        while at + 4 <= len(blob):
            (flen,) = struct.unpack_from("<I", blob, at)
            frame = blob[at + 4 : at + 4 + flen]
            if len(frame) != flen or flen < 4:
                break  # torn tail
            (crc,) = struct.unpack_from("<I", frame)
            body = frame[4:]
            if crc32c(body) != crc:
                break
            space, op, klen = struct.unpack_from("<BBI", body)
            key = body[6 : 6 + klen]
            if op == 0:
                (vlen,) = struct.unpack_from("<I", body, 6 + klen)
                value = body[10 + klen : 10 + klen + vlen]
                self._data[(space, key)] = value
            else:
                self._data.pop((space, key), None)
            at += 4 + flen

    def _payload(self) -> bytes:
        out = bytearray()
        for (space, key), value in sorted(self._data.items()):
            out += struct.pack("<BII", space, len(key), len(value))
            out += key
            out += value
        return bytes(out)

    def _load_payload(self, payload: bytes):
        at = 0
        while at + 9 <= len(payload):
            space, klen, vlen = struct.unpack_from("<BII", payload, at)
            at += 9
            key = payload[at : at + klen]
            at += klen
            value = payload[at : at + vlen]
            at += vlen
            self._data[(space, key)] = value

    def _do_snapshot(self):
        self._snap.write(b"kvstore-v1", self._payload())
        if self._wal:
            self._wal.close()
        with open(self._wal_path, "wb"):
            pass  # truncate
        self._wal = file_sanitizer.maybe_wrap(
            open(self._wal_path, "ab"), self._wal_path
        )
