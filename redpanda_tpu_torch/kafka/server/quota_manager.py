"""Client quotas: per-client-id token buckets -> throttle_time_ms.

Parity with kafka/server/quota_manager.h: the reference tracks per-client
produce/fetch byte rates and tells clients to back off via the
throttle_time_ms field every Kafka response carries. Token buckets refill
continuously; when a client overdraws, the deficit converts into the
throttle duration. Idle clients are garbage-collected.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class _Bucket:
    rate: float  # bytes/s
    burst: float  # bucket capacity
    tokens: float = 0.0
    last_refill: float = field(default_factory=time.monotonic)

    def __post_init__(self):
        self.tokens = self.burst

    def record(self, n: int) -> float:
        """Consume n bytes; returns throttle seconds (0 when within rate)."""
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self.last_refill) * self.rate)
        self.last_refill = now
        self.tokens -= n
        if self.tokens >= 0:
            return 0.0
        return -self.tokens / self.rate


class QuotaManager:
    """quota_manager.h equivalent over client-id keyed buckets."""

    MAX_THROTTLE_MS = 30_000
    GC_AGE_S = 120.0

    def __init__(
        self,
        *,
        produce_rate: int | None = None,  # bytes/s per client, None = unlimited
        fetch_rate: int | None = None,
        burst_seconds: float = 1.0,
    ):
        self.produce_rate = produce_rate
        self.fetch_rate = fetch_rate
        self.burst_seconds = burst_seconds
        self._produce: dict[str, _Bucket] = {}
        self._fetch: dict[str, _Bucket] = {}
        self._last_gc = time.monotonic()

    def _bucket(self, table: dict, client_id: str, rate: int) -> _Bucket:
        b = table.get(client_id)
        if b is None or b.rate != rate:
            b = table[client_id] = _Bucket(rate=rate, burst=rate * self.burst_seconds)
        return b

    def record_produce(self, client_id: str | None, n_bytes: int) -> int:
        """Returns throttle_time_ms for the produce response."""
        if self.produce_rate is None:
            return 0
        b = self._bucket(self._produce, client_id or "", self.produce_rate)
        self._maybe_gc()
        return min(int(b.record(n_bytes) * 1000), self.MAX_THROTTLE_MS)

    def record_fetch(self, client_id: str | None, n_bytes: int) -> int:
        if self.fetch_rate is None:
            return 0
        b = self._bucket(self._fetch, client_id or "", self.fetch_rate)
        self._maybe_gc()
        return min(int(b.record(n_bytes) * 1000), self.MAX_THROTTLE_MS)

    def _maybe_gc(self) -> None:
        now = time.monotonic()
        if now - self._last_gc < self.GC_AGE_S:
            return
        self._last_gc = now
        for table in (self._produce, self._fetch):
            stale = [k for k, b in table.items() if now - b.last_refill > self.GC_AGE_S]
            for k in stale:
                del table[k]
