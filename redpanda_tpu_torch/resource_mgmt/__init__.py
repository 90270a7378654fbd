"""Resource management: memory budgets + scheduling groups (the JAX
package's resource_mgmt, copied).

Parity with resource_mgmt/ (memory_groups.h static memory split,
cpu_scheduling.h scheduling groups). The reference divides Seastar shard
memory between subsystems and gates every Kafka request on size-based
memory units before parsing (connection_context.cc:32). Here:

- ``MemoryBudget``: an async byte-budget semaphore. The Kafka server
  acquires a request's frame size before reading its body and releases it
  after the response drains, so a flood of large produce requests
  backpressures at the socket instead of ballooning the heap.
- ``MemoryGroups``: the static split of a total budget between subsystems
  (kafka request memory, rpc, coproc staging), mirroring memory_groups.h.
- ``SchedulingGroup``: a named concurrency gate + runtime counter for
  per-subsystem attribution (asyncio has no preemptive scheduler to donate
  shares to, so groups bound concurrent tasks and publish aggregate
  runtime to the metrics registry instead).

The BUDGET PLANE (budgets.py + admission.py, re-exported here) grows this
into the process-wide split: per-subsystem ``MemoryAccount``s carved from
one configurable total, a derived ok/warn/critical ``MemoryPressure``
signal, and admission controllers that shed with retriable backpressure
before the ack (kafka produce, coproc submit, rpc dispatch) instead of
queueing unboundedly. See budgets.py's docstring for the account map.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass

from redpanda_tpu_torch.resource_mgmt.budgets import (  # noqa: F401  (re-exports)
    BudgetPlane,
    MemoryAccount,
    PRESSURE_CRITICAL,
    PRESSURE_OK,
    PRESSURE_WARN,
)
from redpanda_tpu_torch.resource_mgmt.admission import (  # noqa: F401
    AdmissionController,
    InflightGate,
    ShedError,
)


class MemoryBudget(MemoryAccount):
    """Async byte budget: acquire(n) waits until n bytes are available.

    A single request larger than the whole budget is clamped to the budget
    (it proceeds alone rather than deadlocking), matching the reference's
    semaphore-units behavior for oversized requests.

    ONE implementation, not two: this is the budget plane's
    ``MemoryAccount`` (budgets.py) under its historical name — the FIFO
    waiter machinery with its delicate cancel-after-grant and
    dead-loop-head liveness rules lives there alone, plus the
    available/in_use views this class's consumers (the kafka frame
    memory gate) read."""

    def __init__(self, limit_bytes: int):
        super().__init__("memory_budget", limit_bytes)

    @property
    def available(self) -> int:
        return self.limit - self.held

    @property
    def in_use(self) -> int:
        return self.held


@dataclass
class MemoryGroups:
    """Static split of the process budget (memory_groups.h)."""

    total_bytes: int = 512 * 1024 * 1024

    @property
    def kafka_request_memory(self) -> int:
        return self.total_bytes // 4

    @property
    def rpc_memory(self) -> int:
        return self.total_bytes // 8

    @property
    def coproc_staging_memory(self) -> int:
        return self.total_bytes // 4

    @property
    def storage_cache_memory(self) -> int:
        return self.total_bytes - (
            self.kafka_request_memory + self.rpc_memory + self.coproc_staging_memory
        )


class SchedulingGroup:
    """Named concurrency gate with runtime attribution (cpu_scheduling.h's
    observable cousin: bounds concurrent tasks per subsystem and records
    cumulative runtime for /metrics)."""

    def __init__(self, name: str, max_concurrency: int = 0):
        self.name = name
        self._sem = asyncio.Semaphore(max_concurrency) if max_concurrency else None
        self.runtime_s = 0.0
        self.tasks_run = 0

    async def run(self, coro):
        if self._sem is not None:
            async with self._sem:
                return await self._timed(coro)
        return await self._timed(coro)

    async def _timed(self, coro):
        t0 = time.monotonic()
        try:
            return await coro
        finally:
            self.runtime_s += time.monotonic() - t0
            self.tasks_run += 1


def default_scheduling_groups() -> dict[str, SchedulingGroup]:
    """The reference's group set (application.h scheduling_groups)."""
    return {
        name: SchedulingGroup(name)
        for name in ("raft", "kafka", "cluster", "coproc", "admin", "archival")
    }
