"""Host-side record-batch explode/rebuild for the engine data path.

The per-record work (varint framing parse, JSON walk, framing) runs in the
native library (native/redpanda_native.cc through redpanda_tpu_torch.native);
Python only touches per-batch metadata. These are the JAX package's lanes
(coproc/batch_codec.py), with the same bytes at every step:

  * staged: ``explode_and_find`` / ``explode_batches`` join the decompressed
    payloads into one blob and parse it;
  * structural: ``explode_find_structural`` hands the payloads to the
    structural-index parse as a table of pointers (the blob is built in
    the crossing only when the harvest gathers from it);
  * pointer-table staging: ``explode_ptrs`` keeps each batch's record
    offsets relative to its own payload, so the payload lane packs its
    staging rows straight from the payloads;
  * framing: ``frame_ranges`` frames padded rows, ``frame_ranges_gather``
    frames kept records straight from the joined blob (zero copy); an
    ``Arena`` lends both their scratch buffers across launches.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from redpanda_tpu_torch import native
from redpanda_tpu_torch.compression import compress, registry, uncompress
from redpanda_tpu_torch.coproc import lockwatch
from redpanda_tpu_torch.models.record import Compression, RecordBatch, RecordBatchHeader
from redpanda_tpu_torch.utils.vint import decode_zigzag, encode_zigzag


class Arena:
    """Reusable scratch buffers for the harvest's framing crossings.

    A fresh framing buffer per launch is megabytes of allocator churn at a
    steady tick cadence for buffers whose size barely changes; the arena
    keeps a small free list instead. ``acquire`` hands back a released
    buffer when one is big enough, ``release`` returns it. Thread-safe:
    tickets of one launch may harvest from different threads."""

    # a one-off giant launch must not pin its buffers forever
    MAX_FREE = 8

    def __init__(self) -> None:
        self._lock = lockwatch.wrap(threading.Lock(), "Arena._lock")
        self._free: list[np.ndarray] = []
        self._allocs = 0
        self._reuses = 0
        self._alloc_bytes = 0
        self._trims = 0

    def acquire(self, nbytes: int) -> np.ndarray:
        """A uint8 1-D buffer of at least nbytes (callers track their own
        logical lengths)."""
        with self._lock:
            best = None
            for i, b in enumerate(self._free):
                if b.nbytes >= nbytes and (best is None or b.nbytes < self._free[best].nbytes):
                    best = i
            if best is not None:
                self._reuses += 1
                return self._free.pop(best)
            self._allocs += 1
            self._alloc_bytes += max(nbytes, 1)
        return np.empty(max(nbytes, 1), dtype=np.uint8)

    def release(self, buf: np.ndarray | None) -> None:
        if buf is None:
            return
        with self._lock:
            if len(self._free) < self.MAX_FREE:
                self._free.append(buf)

    def trim(self) -> int:
        """Free every parked buffer; returns how many. Buffers in flight are
        untouched and re-park on release."""
        with self._lock:
            n = len(self._free)
            self._free.clear()
            self._trims += 1
        return n

    def stats(self) -> dict:
        with self._lock:
            return {
                "allocs": self._allocs,
                "reuses": self._reuses,
                "alloc_bytes": self._alloc_bytes,
                "free_buffers": len(self._free),
                "trims": self._trims,
            }


@dataclass
class ExplodedBatches:
    """All record values of a batch list, as offsets into one joined blob."""

    joined: bytes
    offsets: np.ndarray  # int64 [N]
    sizes: np.ndarray  # int32 [N] (null values -> 0)
    ranges: list[tuple[int, int]]  # per input batch: [start, end) in N


def _payloads(batches: list[RecordBatch]):
    """Each batch's decompressed payload, its record count and its [start,
    end) record range in the launch."""
    payloads: list[bytes] = []
    counts = np.empty(len(batches), np.int32)
    ranges: list[tuple[int, int]] = []
    n = 0
    for i, b in enumerate(batches):
        payload = b.payload
        if b.header.compression != Compression.none:
            payload = uncompress(payload, b.header.compression)
        count = b.header.record_count
        payloads.append(payload)
        counts[i] = count
        ranges.append((n, n + count))
        n += count
    return payloads, counts, ranges, n


def _gather_payloads(batches: list[RecordBatch]):
    """Decompress + concatenate batch payloads."""
    payloads, counts, ranges, n = _payloads(batches)
    p_len = np.fromiter((len(p) for p in payloads), np.int32, len(payloads))
    p_off = np.zeros(len(payloads), np.int64)
    np.cumsum(p_len[:-1], out=p_off[1:])
    return counts, p_off, p_len, ranges, b"".join(payloads), n


def _empty(joined: bytes, ranges) -> ExplodedBatches:
    return ExplodedBatches(joined, np.zeros(0, np.int64), np.zeros(0, np.int32), ranges)


def explode_and_find(batches: list[RecordBatch], paths: list[str]):
    """Fused explode + find (rp_explode_find): framing parse and the k-path
    JSON walk in one native crossing. Returns (ExplodedBatches, types, vs,
    ve), or None when there are no paths (the caller explodes alone)."""
    if not paths:
        return None
    counts, p_off, p_len, ranges, joined, n = _gather_payloads(batches)
    if n == 0:
        k = len(paths)
        return (
            _empty(joined, ranges),
            np.zeros((0, k), np.int8), np.zeros((0, k), np.int64), np.zeros((0, k), np.int64),
        )
    off, ln, types, vs, ve = native.lib().explode_find(joined, p_off, p_len, counts, paths)
    return ExplodedBatches(joined, off, np.maximum(ln, 0), ranges), types, vs, ve


def explode_batches(batches: list[RecordBatch]) -> ExplodedBatches:
    """Record value offsets/sizes of every batch, in one native crossing."""
    counts, p_off, p_len, ranges, joined, n = _gather_payloads(batches)
    if n == 0:
        return _empty(joined, ranges)
    off, ln = native.lib().parse_many(joined, p_off, p_len, counts)
    return ExplodedBatches(joined, off, np.maximum(ln, 0), ranges)


class StructuralParse:
    """One launch's structural-index parse: the span tables the fused
    extraction reads, with the decompressed per-batch payloads kept so the
    record bytes stay reachable without a joined blob. ``joined`` (a uint8
    array over the in-crossing copy) is there only when the caller asked
    for it: passthrough plans gather their output from it; projection
    plans never read the raw bytes again."""

    __slots__ = ("payloads", "counts", "ranges", "joined", "val_off", "val_len",
                 "types", "vs", "ve", "n")

    def __init__(self, payloads, counts, ranges, joined, val_off, val_len, types, vs, ve):
        self.payloads = payloads
        self.counts = counts
        self.ranges = ranges
        self.joined = joined
        self.val_off = val_off
        self.val_len = val_len
        self.types = types
        self.vs = vs
        self.ve = ve
        self.n = len(val_len)

    @property
    def sizes(self) -> np.ndarray:
        return np.maximum(self.val_len, 0)

    def exploded(self) -> ExplodedBatches:
        """The classic exploded table (needs ``joined``)."""
        return ExplodedBatches(self.joined, self.val_off, self.sizes, self.ranges)


def explode_find_structural(
    batches: list[RecordBatch], paths: list[str], need_joined: bool
) -> StructuralParse:
    """Structural-index fused parse (rp_explode_find2): the decompressed
    payloads cross the native boundary once as a table of pointers; the
    joined blob is built in the crossing only when ``need_joined`` says the
    harvest gathers from it. The span tables equal explode_and_find's."""
    payloads, counts, ranges, n = _payloads(batches)
    if n == 0:
        k = len(paths)
        return StructuralParse(
            payloads, counts, ranges, np.zeros(0, np.uint8) if need_joined else None,
            np.zeros(0, np.int64), np.zeros(0, np.int32),
            np.zeros((0, k), np.int8), np.zeros((0, k), np.int64), np.zeros((0, k), np.int64),
        )
    joined, off, ln, types, vs, ve = native.lib().explode_find_structural(
        payloads, counts, paths, need_joined
    )
    return StructuralParse(payloads, counts, ranges, joined, off, ln, types, vs, ve)


@dataclass
class PtrExploded:
    """Pointer-table explode for the payload staging lane: the decompressed
    per-batch payloads are kept and each record's (offset, len) stays
    relative to its own payload, so staging packs straight from them and
    the joined blob never exists."""

    payloads: list[bytes]
    rel_off: list[np.ndarray]  # int64 per batch, relative to its payload
    rel_len: list[np.ndarray]  # int32 per batch (raw; -1 for null values)
    sizes: np.ndarray  # int32 [N] launch-wide, clamped >= 0
    ranges: list[tuple[int, int]]  # per input batch: [start, end) in N


def explode_ptrs(batches: list[RecordBatch]) -> PtrExploded:
    """Explode a batch list without building the joined blob (one
    rp_parse_record_values crossing per batch)."""
    lib = native.lib()
    payloads, counts, ranges, _ = _payloads(batches)
    rel_off: list[np.ndarray] = []
    rel_len: list[np.ndarray] = []
    for payload, count in zip(payloads, counts):
        if count:
            off, ln = lib.parse_record_values(payload, int(count))
        else:
            off, ln = np.zeros(0, np.int64), np.zeros(0, np.int32)
        rel_off.append(off)
        rel_len.append(ln)
    sizes = (np.maximum(np.concatenate(rel_len), 0).astype(np.int32) if rel_len
             else np.zeros(0, np.int32))
    return PtrExploded(payloads, rel_off, rel_len, sizes, ranges)


def merge_exploded(parts: list[ExplodedBatches]) -> ExplodedBatches:
    """Concatenate per-shard explode results into one launch-wide table.

    Shards are contiguous batch slices in input order, so the merge is a
    concatenation with rebasing: value offsets shift by the preceding
    shards' joined length, per-batch record ranges by their record count.
    The result is byte- and index-identical to exploding the whole batch
    list at once."""
    if len(parts) == 1:
        return parts[0]
    if not parts:
        return _empty(b"", [])
    joined = b"".join(p.joined for p in parts)
    offs, sizes, ranges = [], [], []
    byte_base = rec_base = 0
    for p in parts:
        offs.append(p.offsets + byte_base)
        sizes.append(p.sizes)
        ranges.extend((s + rec_base, e + rec_base) for s, e in p.ranges)
        byte_base += len(p.joined)
        rec_base += len(p.sizes)
    return ExplodedBatches(joined, np.concatenate(offs), np.concatenate(sizes), ranges)


def merge_ptrs(parts: list[PtrExploded]) -> PtrExploded:
    """Concatenate per-shard pointer-table explodes into the launch-wide
    one. Offsets stay relative to each batch's own payload, so only the
    record ranges rebase; the result is the one explode_ptrs gives for the
    whole batch list."""
    if len(parts) == 1:
        return parts[0]
    ranges: list[tuple[int, int]] = []
    base = 0
    for p in parts:
        ranges.extend((s + base, e + base) for s, e in p.ranges)
        base += len(p.sizes)
    return PtrExploded(
        [x for p in parts for x in p.payloads],
        [x for p in parts for x in p.rel_off],
        [x for p in parts for x in p.rel_len],
        np.concatenate([p.sizes for p in parts]) if parts else np.zeros(0, np.int32),
        ranges,
    )


def _parse_record_values_py(payload: bytes, count: int):
    """Plain Python version of rp_parse_record_values: each record's value
    offset and length (-1 for null) within one batch payload."""
    off = np.empty(count, dtype=np.int64)
    ln = np.empty(count, dtype=np.int32)
    pos = 0
    for i in range(count):
        body_len, k = decode_zigzag(payload, pos)
        pos += k
        body_end = pos + body_len
        p = pos + 1  # attributes
        _, k = decode_zigzag(payload, p)
        p += k
        _, k = decode_zigzag(payload, p)
        p += k
        klen, k = decode_zigzag(payload, p)
        p += k
        if klen > 0:
            p += klen
        vlen, k = decode_zigzag(payload, p)
        p += k
        off[i] = p
        ln[i] = vlen if vlen >= 0 else -1
        pos = body_end
    return off, ln


def frame_records(rows: np.ndarray, lens: np.ndarray, keep: np.ndarray) -> tuple[bytes, int]:
    """Frame the kept rows of one batch (rp_frame_records): (payload, kept)."""
    return native.lib().frame_records(rows, lens, keep)


def _bounds(ranges):
    starts = np.fromiter((s for s, _ in ranges), np.int64, len(ranges))
    ends = np.fromiter((e for _, e in ranges), np.int64, len(ranges))
    return starts, ends


def _slice_parts(dst, off, ln, kept, scratch, arena: Arena | None):
    parts = [(dst[off[i] : off[i] + ln[i]].tobytes(), int(kept[i])) for i in range(len(off))]
    if arena is not None:
        arena.release(dst)
        if dst is not scratch:
            # the binding replaced an undersized scratch; the old buffer can
            # still serve a smaller launch
            arena.release(scratch)
    return parts


def frame_ranges(
    rows: np.ndarray,
    lens: np.ndarray,
    keep: np.ndarray,
    ranges: list[tuple[int, int]],
    arena: Arena | None = None,
) -> list[tuple[bytes, int]]:
    """Frame every [start, end) record range of a launch in one native
    crossing (rp_frame_many): [(payload, kept)] per range. ``arena`` lends
    the framing buffer."""
    if not ranges:
        return []
    starts, ends = _bounds(ranges)
    n, stride = rows.shape
    scratch = arena.acquire(n * (stride + 16) + 16) if arena is not None else None
    dst, off, ln, kept = native.lib().frame_many(rows, lens, keep, starts, ends, out=scratch)
    return _slice_parts(dst, off, ln, kept, scratch, arena)


def _frame_gather_py(src, offsets, lens, keep, start: int, end: int) -> tuple[bytes, int]:
    """Plain Python version of rp_frame_gather over one range: identical
    bytes to frame_records over rows packed from the same (offset, len)
    table."""
    out = bytearray()
    seq = 0
    for i in range(start, end):
        if not keep[i]:
            continue
        o = int(offsets[i])
        vlen = max(int(lens[i]), 0)
        body = bytearray()
        body += b"\x00"
        body += encode_zigzag(0)
        body += encode_zigzag(seq)
        body += encode_zigzag(-1)
        body += encode_zigzag(vlen)
        body += bytes(src[o : o + vlen])
        body += encode_zigzag(0)
        out += encode_zigzag(len(body))
        out += body
        seq += 1
    return bytes(out), seq


def frame_ranges_gather(
    src,
    offsets: np.ndarray,
    lens: np.ndarray,
    keep: np.ndarray,
    ranges: list[tuple[int, int]],
    arena: Arena | None = None,
) -> list[tuple[bytes, int]]:
    """Zero-copy launch framing (rp_frame_many_gather): kept records frame
    straight from ``src`` (the launch's joined blob) through per-record
    (offset, len) columns, so the padded row matrix is never built. The
    bytes equal ``frame_ranges`` over rows packed from the same table; the
    engine takes this path only for byte-identity plans."""
    if not ranges:
        return []
    starts, ends = _bounds(ranges)
    n = len(offsets)
    scratch = (arena.acquire(int(np.maximum(lens, 0).sum()) + 16 * n + 16)
               if arena is not None else None)
    dst, off, ln, kept = native.lib().frame_many_gather(
        src, offsets, lens, keep, starts, ends, out=scratch
    )
    return _slice_parts(dst, off, ln, kept, scratch, arena)


def build_output_batch(
    source: RecordBatch,
    payload: bytes,
    kept: int,
    *,
    compress_threshold: int = 512,
    codec: Compression = Compression.zstd,
) -> RecordBatch | None:
    """Seal a framed payload into a materialized output batch: term reset,
    recompression above a size threshold, fresh CRCs. Returns None when no
    record survives the transform."""
    if kept == 0:
        return None
    attrs = 0
    if len(payload) >= compress_threshold and codec != Compression.none:
        if not registry.is_available(codec):
            # degrade, don't drop: a missing optional codec library must
            # not silently discard every transformed batch (gzip is stdlib)
            codec = Compression.gzip
        payload = compress(payload, codec)
        attrs = int(codec)
    hdr = RecordBatchHeader(
        base_offset=0,  # assigned by the materialized log appender
        type=source.header.type,
        attrs=attrs,
        last_offset_delta=kept - 1,
        first_timestamp=source.header.first_timestamp,
        max_timestamp=source.header.max_timestamp,
        record_count=kept,
        term=0,
    )
    batch = RecordBatch(hdr, payload)
    batch.reseal()
    return batch
