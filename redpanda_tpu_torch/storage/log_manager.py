"""Log manager + storage API facade (the JAX package's
storage/log_manager.py, copied).

Parity with storage/api.h:20 (`storage::api` = log_manager + kvstore) and
log_manager.h:171 (`manage(ntp)` creates/opens the per-ntp log, housekeeping
applies retention).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.observability import probes
from redpanda_tpu_torch.storage.kvstore import KvStore
from redpanda_tpu_torch.storage.log import DiskLog, LogConfig


class LogManager:
    def __init__(self, config: LogConfig, *, batch_cache_bytes: int = 64 << 20):
        from redpanda_tpu_torch.storage.batch_cache import BatchCache
        from redpanda_tpu_torch.storage.readers_cache import ReadersCache

        self.config = config
        self._logs: dict[NTP, DiskLog] = {}
        self._housekeeping_task: asyncio.Task | None = None
        self._compaction_task: asyncio.Task | None = None
        # ONE cache across every managed log (batch_cache.h:99 is a global
        # LRU): hot partitions naturally take budget from cold ones
        self.batch_cache = BatchCache(batch_cache_bytes)
        # positioned read cursors for sequential fetch (readers_cache.h:36)
        self.readers_cache = ReadersCache()
        # set by start_housekeeping; pacing state exported as metrics
        self.backlog_controller = None

    async def manage(self, ntp: NTP, *, overrides: LogConfig | None = None) -> DiskLog:
        if ntp in self._logs:
            return self._logs[ntp]
        log = await DiskLog.open(ntp, overrides or self.config)
        log.batch_cache = self.batch_cache
        log.readers_cache = self.readers_cache
        self._logs[ntp] = log
        return log

    def get(self, ntp: NTP) -> DiskLog | None:
        return self._logs.get(ntp)

    def logs(self) -> dict[NTP, DiskLog]:
        return dict(self._logs)

    async def shutdown(self, ntp: NTP):
        log = self._logs.pop(ntp, None)
        if log:
            await log.close()

    async def remove(self, ntp: NTP):
        log = self._logs.pop(ntp, None)
        if log:
            await log.remove()

    def compaction_backlog(self) -> int:
        """Total compaction backlog across managed logs (controller PV)."""
        return sum(log.compaction_backlog() for log in self._logs.values())

    async def start_housekeeping(
        self, interval_s: float = 10.0, compaction_interval_s: float | None = None
    ):
        """Retention + compaction fibers (log_manager housekeeping). The
        compaction cadence is backlog-driven: `compaction_interval_s` (or
        `interval_s`) is the controller's lazy ceiling, and the pass rate
        rises as closed un-compacted bytes pile past the setpoint
        (compaction_controller/backlog_controller.h posture)."""
        from redpanda_tpu_torch.storage.backlog_controller import BacklogController

        ceiling = (
            compaction_interval_s if compaction_interval_s is not None else interval_s
        )
        self.backlog_controller = BacklogController(
            max_interval_s=ceiling, min_interval_s=min(0.5, ceiling)
        )

        async def housekeep_once(log) -> None:
            t0 = time.perf_counter()
            policy = log.config.cleanup_policy
            if "delete" in policy:
                await log.apply_retention()
            probes.observe_us(probes.storage_housekeeping_hist, t0)

        async def loop():
            while True:
                await asyncio.sleep(interval_s)
                for log in list(self._logs.values()):
                    try:
                        await housekeep_once(log)
                    except Exception:
                        pass

        async def compaction_loop():
            while True:
                # one backlog sample drives both the interval and the order
                backlogs = {
                    log: log.compaction_backlog() for log in self._logs.values()
                }
                await asyncio.sleep(
                    self.backlog_controller.update(sum(backlogs.values()))
                )
                # biggest backlog first, so pressure relieves fastest
                for log in sorted(backlogs, key=backlogs.get, reverse=True):
                    if not log.is_compacted:
                        continue
                    try:
                        t0 = time.perf_counter()
                        await log.compact()
                        probes.observe_us(probes.storage_housekeeping_hist, t0)
                    except Exception:
                        pass

        self._housekeeping_task = asyncio.create_task(loop())
        self._compaction_task = asyncio.create_task(compaction_loop())

    async def stop(self):
        for task_attr in ("_housekeeping_task", "_compaction_task"):
            task = getattr(self, task_attr, None)
            if task:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, task_attr, None)
        for log in self._logs.values():
            await log.close()
        self._logs.clear()


class StorageApi:
    """storage::api equivalent: one kvstore + one log_manager per shard."""

    def __init__(self, base_dir: str, log_config: LogConfig | None = None, shard: int = 0):
        self.base_dir = base_dir
        cfg = log_config or LogConfig(base_dir=os.path.join(base_dir, "data"))
        self.log_mgr = LogManager(cfg)
        self.kvs = KvStore(os.path.join(base_dir, f"kvstore-{shard}"))

    async def start(self) -> "StorageApi":
        self.kvs.start()
        return self

    async def stop(self):
        await self.log_mgr.stop()
        self.kvs.stop()
        from redpanda_tpu_torch.storage import file_sanitizer

        if file_sanitizer.enabled():
            # scope to this instance's tree: another StorageApi in the same
            # process (multi-node fixtures) keeps its live handles
            leaked = file_sanitizer.verify_all_closed(prefix=self.base_dir)
            if leaked:
                logging.getLogger("rptorch.storage").warning(
                    "file sanitizer: %d handle(s) leaked at shutdown: %s",
                    len(leaked), leaked,
                )
