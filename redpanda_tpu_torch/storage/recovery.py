"""Crash-recovery CRC scan of a segment tail (parity with storage/
log_replayer.h and the header-CRC validation in storage/parser.cc:159-173).

The scan walks [header][payload] frames; each header's header_crc and each
batch's Kafka CRC must verify. The host scan validates frame by frame with
the native CRC; the device scan reads the frame boundaries from the
headers on the host, packs every frame of the segment into one [N, R]
staging array and validates all Kafka CRCs in one launch of the CRC kernel
(ops/crc32c_device.py) on the card.

The segment is cut at the first corrupt frame (everything after a torn
write is discarded, as the reference does): ``recover_segment`` truncates
the file there and rebuilds its index. ``DiskLog.open`` runs it on the
tail segment of every log, on the card when its ``LogConfig`` asks for
device recovery.
"""

from __future__ import annotations

import numpy as np

from redpanda_tpu_torch.models.record import (
    INTERNAL_HEADER_SIZE,
    CorruptBatchError,
    RecordBatch,
    RecordBatchHeader,
)

# bytes of the header that the Kafka CRC covers (attributes..records)
KAFKA_CRC_PREFIX = 40


def scan_valid_prefix_host(blob: bytes) -> tuple[int, int]:
    """Returns (valid_byte_length, last_valid_offset)."""
    at = 0
    last_offset = -1
    n = len(blob)
    while at + INTERNAL_HEADER_SIZE <= n:
        try:
            batch, consumed = RecordBatch.decode_internal(blob, at, verify=True)
        except CorruptBatchError:
            break
        if not batch.verify_kafka_crc():
            break
        last_offset = batch.last_offset
        at += consumed
    return at, last_offset


def scan_valid_prefix_device(blob: bytes, row_stride: int = 4096, device="cuda") -> tuple[int, int]:
    """The device-batched scan: frame boundaries come from the headers
    (host, cheap); every frame's Kafka CRC validates in one kernel launch
    on ``device`` (the card unless the caller asks for the CPU). A frame
    wider than ``row_stride`` sends the whole segment to the host scan."""
    from redpanda_tpu_torch.ops.crc32c_device import make_crc_fn
    from redpanda_tpu_torch.ops.packing import pack_rows

    crc_fn = make_crc_fn(row_stride, device)  # raises without the card
    frames: list[tuple[int, RecordBatchHeader]] = []
    at = 0
    n = len(blob)
    while at + INTERNAL_HEADER_SIZE <= n:
        try:
            hdr = RecordBatchHeader.decode(blob, at)
        except Exception:
            break
        if hdr.size_bytes < INTERNAL_HEADER_SIZE or at + hdr.size_bytes > n:
            break
        if hdr.header_crc != hdr.internal_header_only_crc():
            break
        if hdr.size_bytes - INTERNAL_HEADER_SIZE + KAFKA_CRC_PREFIX > row_stride:
            return scan_valid_prefix_host(blob)
        frames.append((at, hdr))
        at += hdr.size_bytes
    if not frames:
        return 0, -1
    regions = [
        hdr.kafka_header_crc_prefix() + blob[pos + INTERNAL_HEADER_SIZE : pos + hdr.size_bytes]
        for pos, hdr in frames
    ]
    rows, lens = pack_rows(regions, row_stride)
    claimed = np.array([hdr.crc for _, hdr in frames], dtype=np.uint32)
    bad = crc_fn(rows, lens) != claimed
    valid = int(np.argmax(bad)) if bad.any() else len(frames)
    if valid == 0:
        return 0, -1
    end_pos, last_hdr = frames[valid - 1]
    return end_pos + last_hdr.size_bytes, last_hdr.base_offset + last_hdr.last_offset_delta


def recover_segment(seg, *, use_device: bool = False, device="cuda") -> None:
    """Truncate `seg` after its last intact batch and rebuild its index.

    Single read: the blob is scanned once for CRC validity and the surviving
    prefix is handed to rebuild_index (which also resets dirty_offset and
    max_timestamp — crucial when the whole tail is corrupt and the stale
    index footer would otherwise claim offsets that no longer exist).
    With ``use_device`` the scan's CRCs run on ``device`` (the card unless
    the caller asks for the CPU); a failed build or launch raises, and
    nothing is scanned on the host in its place."""
    blob = seg.read_from(0)
    if use_device:
        valid_len, _last_offset = scan_valid_prefix_device(blob, device=device)
    else:
        valid_len, _last_offset = scan_valid_prefix_host(blob)
    if valid_len < len(blob):
        with open(seg.data_path, "r+b") as f:
            f.truncate(valid_len)
        seg.size_bytes = valid_len
        blob = blob[:valid_len]
    seg.rebuild_index(blob)
