"""The engine's host-stage pool (the JAX package's coproc/host_pool.py).

A launch's per-record host stages -- explode and find, column extraction,
projection, framing, the recompress and seal -- work over disjoint record
ranges, and nearly all of their time is spent inside ctypes crossings
(which drop the GIL), zlib/zstd calls or wide numpy passes. So the engine
cuts a launch's batches into contiguous shards (``partition_counts``) and
runs each shard's stages on a small thread pool (``HostStagePool``); the
merged index tables are plain concatenations with rebased offsets, and the
output is byte-identical to the inline path.

Sizing: ``default_host_workers`` (``min(4, os.cpu_count())``); 0 or 1
keeps the inline path, so the pool exists only at 2 or more workers. Whether
the pool runs at all is the engine's measured decision (``PROBE_MARGIN``).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from redpanda_tpu_torch.coproc import lockwatch
from redpanda_tpu_torch.observability import probes


def default_host_workers() -> int:
    """One worker per core, capped at 4 (past that the serial merge
    dominates before memory bandwidth does)."""
    return min(4, os.cpu_count() or 1)


# A measured choice of the engine (the host pool against the inline path,
# the structural-vs-staged parse ladder, the mesh lane against the single
# device) pins the new path only when it wins by this factor: the old one
# is the known path.
PROBE_MARGIN = 1.25


def measure_parallel_capacity(workers: int = 2) -> dict:
    """Do GIL-releasing numpy tasks run concurrently here? ``os.cpu_count()``
    overstates quota-limited machines. A diagnostic only: the engine
    calibrates on its own explode stage. Returns {'speedup', 'workers'},
    best of 3 on both sides."""
    workers = max(2, int(workers))

    def task() -> None:
        x = np.arange(200_000, dtype=np.float64)
        for _ in range(4):
            x = np.sqrt(x * 1.0001 + 1.0)

    ex = ThreadPoolExecutor(max_workers=workers)
    try:
        task()  # warm numpy and the allocator
        serial = parallel = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(workers):
                task()
            serial = min(serial, time.perf_counter() - t0)
            t0 = time.perf_counter()
            futs = [ex.submit(task) for _ in range(workers)]
            for f in futs:
                f.result()
            parallel = min(parallel, time.perf_counter() - t0)
    finally:
        ex.shutdown(wait=False)
    speedup = serial / parallel if parallel > 0 else 1.0
    return {"speedup": round(speedup, 3), "workers": workers}


def partition_counts(counts: list[int], n_shards: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) slices over ``counts`` (per-batch record
    counts), balanced by total records per shard.

    Contiguity is the invariant everything downstream leans on: shard i's
    records form one contiguous record range, so merged offset/size/span
    tables are plain concatenations with rebased indices and the framed
    per-batch outputs concatenate back in input order byte-identically.
    Never returns empty slices; may return fewer than ``n_shards`` when
    there are fewer batches than shards.
    """
    n = len(counts)
    if n == 0 or n_shards <= 1:
        return [(0, n)] if n else []
    n_shards = min(n_shards, n)
    total = sum(counts)
    target = total / n_shards
    cuts = [0]
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        # cut when this shard reached its share, leaving enough batches
        # for the remaining shards to be non-empty
        remaining_shards = n_shards - len(cuts)
        if (
            remaining_shards > 0
            and acc >= target * len(cuts)
            and (n - (i + 1)) >= remaining_shards
            and i + 1 > cuts[-1]
        ):
            cuts.append(i + 1)
            if len(cuts) == n_shards:
                break
    cuts.append(n)
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1) if cuts[i + 1] > cuts[i]]


class HostStagePool:
    """A named thread pool for the engine's per-shard host stages.

    The executor is made on first use (an engine that never sees a
    shardable launch starts no thread) and ``shutdown`` stops its threads;
    a later ``run`` makes a new one."""

    def __init__(self, workers: int):
        self.workers = int(workers)
        self._executor: ThreadPoolExecutor | None = None
        self._lock = lockwatch.wrap(threading.Lock(), "HostStagePool._lock")

    def _ensure_executor(self) -> ThreadPoolExecutor:
        # locked check-then-create: concurrent first launches must not each
        # build (and leak) an executor
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix="rptorch-host-stage"
                )
            return self._executor

    def run(self, fns: list) -> list:
        """Run thunks concurrently; returns their results in input order.

        The first exception (in input order) is raised once every task has
        ended, so no task still touches the launch when the caller handles
        the failure. One thunk runs on the calling thread. Each task counts
        in the ``coproc_host_pool_busy_workers`` gauge while it runs."""
        if len(fns) == 1:
            return [self._tracked(fns[0])]
        ex = self._ensure_executor()
        futures = [ex.submit(self._tracked, fn) for fn in fns]
        results = []
        first_exc: BaseException | None = None
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:  # collected; the first re-raises below
                results.append(None)
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        return results

    @staticmethod
    def _tracked(fn):
        probes.host_pool_task_started()
        try:
            return fn()
        finally:
            probes.host_pool_task_finished()

    def shutdown(self) -> None:
        """Stop the worker threads once their tasks end (joined)."""
        with self._lock:
            ex, self._executor = self._executor, None
        if ex is not None:
            ex.shutdown(wait=True)
