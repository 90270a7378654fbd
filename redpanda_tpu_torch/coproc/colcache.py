"""Device-resident column cache: a launch's columnar products kept across
launches (the JAX package's coproc/colcache.py).

A repeat script over the same partitions (re-runs, replayed reads, any
workload that re-submits an unchanged batch window) would pay the whole host
ladder again -- decompress, parse, find, extract -- plus the copy up of the
very same predicate columns. The cache keys one launch's products by
``(script_id, content fingerprint of the batch list)`` and hands them back
whole: a hit skips every host dispatch stage, and once the predicate has run
on the card the entry's ``cols_dev`` block is already there, so not a byte
crosses the link.

Staleness is impossible by construction of the key: the fingerprint covers
each batch's payload CRC, base offset, record count, payload length and
attributes, so an append, rewrite or reorder is a different key and a clean
miss. The invalidation hooks exist for memory, not correctness: script
unload drops the script's entries, and ``invalidate`` reclaims the entries of
inputs that moved on.

Eviction is LRU under a byte budget that counts host and device bytes alike.
``stats()`` feeds ``TorchEngine.stats()["colcache"]``.
"""

from __future__ import annotations

import struct
import threading
from collections import OrderedDict

from redpanda_tpu_torch.coproc import lockwatch
from redpanda_tpu_torch.hashing.xx import xxhash64


def fingerprint(batches) -> int:
    """Content fingerprint of a batch list. The per-batch tuple (payload
    CRC, base offset, record count, payload length, attrs) pins both the
    bytes and their order; any append or rewrite changes it."""
    buf = bytearray()
    pack = struct.pack
    for b in batches:
        hdr = b.header
        buf += pack(
            "<qIiiI",
            hdr.base_offset,
            hdr.crc & 0xFFFFFFFF,
            hdr.record_count,
            len(b.payload),
            hdr.attrs & 0xFFFFFFFF,
        )
    return xxhash64(buf)


class Entry:
    """One launch's cached columnar products.

    ``cols`` are the host predicate column arrays (always present);
    ``cols_dev`` the CUDA block the first device launch copied them into
    (one uint8 tensor in ``ColumnarPlan.block_layout(n_pad)``), kept so
    that later hits launch over it with no copy up (None on the CPU).
    ``exploded`` is kept only for passthrough plans, whose harvest gathers
    output bytes from the joined blob; projection plans keep the packed
    rows and the ok mask instead. Entries are read-only once put, which is
    what makes a hit bit-identical to a cold run, save that their device
    block can be dropped (``DeviceColumnCache.drop_device``)."""

    __slots__ = (
        "n", "n_pad", "ranges", "cols", "cols_dev", "proj_data", "proj_ok",
        "exploded", "parse_mode", "nbytes",
    )

    def __init__(self, *, n, n_pad, ranges, cols, proj_data=None,
                 proj_ok=None, exploded=None, parse_mode="staged"):
        self.n = n
        self.n_pad = n_pad
        self.ranges = list(ranges)
        self.cols = cols
        self.cols_dev = None
        self.proj_data = proj_data
        self.proj_ok = proj_ok
        self.exploded = exploded
        self.parse_mode = parse_mode
        self.nbytes = self._measure()

    def _measure(self) -> int:
        """Host and device bytes the entry holds."""
        total = 0
        for c in self.cols or ():
            total += getattr(c, "nbytes", 0)
        if self.cols_dev is not None:
            total += self.cols_dev.nbytes
        if self.proj_ok is not None:
            total += self.proj_ok.nbytes
        for item in self.proj_data or ():
            for part in item[1:]:
                total += getattr(part, "nbytes", 0)
        if self.exploded is not None:
            j = self.exploded.joined
            total += getattr(j, "nbytes", len(j))
            total += self.exploded.offsets.nbytes + self.exploded.sizes.nbytes
        return total


class DeviceColumnCache:
    """Keyed LRU over Entry objects with a byte budget."""

    def __init__(self, budget_bytes: int):
        self._lock = lockwatch.wrap(threading.Lock(), "DeviceColumnCache._lock")
        self._budget = max(0, int(budget_bytes))
        self._entries: "OrderedDict[tuple, Entry]" = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0
        # memory pressure: while critical the effective budget halves, and
        # LRU entries beyond it evict at once and stay out until it clears
        self._pressure = False
        self._pressure_evictions = 0

    def _effective_budget(self) -> int:
        return self._budget // 2 if self._pressure else self._budget

    def set_pressure(self, critical: bool) -> int:
        """Enter or leave the reduced-budget posture. Entering evicts LRU
        entries beyond the halved budget (counted as pressure evictions);
        leaving restores the configured budget. Returns entries evicted."""
        evicted = 0
        with self._lock:
            self._pressure = bool(critical)
            budget = self._effective_budget()
            while self._bytes > budget and self._entries:
                _, entry = self._entries.popitem(last=False)
                self._bytes -= entry.nbytes
                self._evictions += 1
                self._pressure_evictions += 1
                evicted += 1
        return evicted

    def lookup(self, key: tuple) -> Entry | None:
        """The cached entry (refreshing its LRU place) or None."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._hits += 1
                return entry
            self._misses += 1
            return None

    def put(self, key: tuple, entry: Entry) -> bool:
        """Insert and evict LRU entries down to the budget. An entry bigger
        than the whole budget is refused outright."""
        with self._lock:
            budget = self._effective_budget()
            if entry.nbytes > budget:
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = entry
            self._bytes += entry.nbytes
            while self._bytes > budget and len(self._entries) > 1:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= evicted.nbytes
                self._evictions += 1
            if self._bytes > budget:
                # the new entry is alone and still over a shrunken budget
                self._entries.popitem(last=False)
                self._bytes -= entry.nbytes
                self._evictions += 1
                return False
        return True

    def drop_device(self, key: tuple, entry: Entry) -> int:
        """Drop a cached entry's device block, whose predicate now runs on
        the host, and stop charging it (a launch that holds it keeps its own
        reference). Returns the bytes released."""
        with self._lock:
            if self._entries.get(key) is not entry or entry.cols_dev is None:
                return 0
            entry.cols_dev = None
            freed = entry.nbytes - entry._measure()
            entry.nbytes -= freed
            self._bytes -= freed
            return freed

    def invalidate(self, script_id: int | None = None) -> int:
        """Drop entries (every script's when script_id is None); returns the
        number dropped. Correctness never depends on this: the key is
        content-addressed."""
        with self._lock:
            if script_id is None:
                dropped = len(self._entries)
                self._entries.clear()
                self._bytes = 0
            else:
                keys = [k for k in self._entries if k[0] == script_id]
                for k in keys:
                    self._bytes -= self._entries.pop(k).nbytes
                dropped = len(keys)
            self._invalidations += dropped
        return dropped

    def reset(self) -> None:
        """Drop every entry and zero the counters."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._hits = self._misses = 0
            self._evictions = self._invalidations = 0
            self._pressure = False
            self._pressure_evictions = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "budget_bytes": self._budget,
                "effective_budget_bytes": self._effective_budget(),
                "evictions": self._evictions,
                "invalidations": self._invalidations,
                "pressure": self._pressure,
                "pressure_evictions": self._pressure_evictions,
            }
