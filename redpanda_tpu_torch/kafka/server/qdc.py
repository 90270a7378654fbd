"""Queue-depth latency control (qdc).

Parity with the reference's kafka queue-depth monitor (qdc wiring in
application.cc:1002-1016, `kafka_qdc_*` configuration): an AIMD controller
bounds how many requests may execute concurrently server-wide so observed
handler latency tracks a target. When the latency EWMA runs past the
target the window shrinks multiplicatively (shedding queue depth is the
only way an overloaded broker can bound tail latency); while latency is
healthy the window creeps back up additively. Disabled by default, like
the reference's kafka_qdc_enable.
"""

from __future__ import annotations

import asyncio
import time


class QdcMonitor:
    def __init__(
        self,
        *,
        enabled: bool = False,
        target_latency_ms: float = 80.0,
        window_s: float = 1.0,
        min_depth: int = 1,
        max_depth: int = 100,
        alpha: float = 0.2,
        decrease_factor: float = 0.8,
    ) -> None:
        self.enabled = enabled
        self.target_latency_ms = target_latency_ms
        self.window_s = window_s
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.alpha = alpha
        self.decrease_factor = decrease_factor
        self.depth = max_depth  # optimistic start; AIMD finds the level
        self.inflight = 0
        self.ewma_ms = 0.0
        self._cond = asyncio.Condition()
        self._window_started = time.monotonic()

    async def acquire(self) -> None:
        if not self.enabled:
            return
        async with self._cond:
            while self.inflight >= self.depth:
                await self._cond.wait()
            self.inflight += 1

    async def release(self, latency_s: float) -> None:
        if not self.enabled:
            return
        lat_ms = latency_s * 1e3
        self.ewma_ms = (
            lat_ms
            if self.ewma_ms == 0.0
            else self.alpha * lat_ms + (1 - self.alpha) * self.ewma_ms
        )
        now = time.monotonic()
        if now - self._window_started >= self.window_s:
            self._window_started = now
            if self.ewma_ms > self.target_latency_ms:
                self.depth = max(self.min_depth, int(self.depth * self.decrease_factor))
            else:
                self.depth = min(self.max_depth, self.depth + 1)
        async with self._cond:
            self.inflight = max(0, self.inflight - 1)
            self._cond.notify_all()

    def stats(self) -> dict[str, float]:
        return {
            "depth": self.depth,
            "inflight": self.inflight,
            "ewma_ms": round(self.ewma_ms, 3),
        }
