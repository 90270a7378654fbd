"""State machine apply loops over a raft log.

Parity with raft/state_machine.h:57 (a fiber that reads committed batches
and calls ``apply``) and raft/mux_state_machine.h (several STMs demultiplexed
from one log by batch type — the controller pattern).

(The JAX package's raft/state_machine.py, copied.)
"""

from __future__ import annotations

import asyncio
import logging

from redpanda_tpu_torch.raft.types import Errc, RaftError

logger = logging.getLogger("rptorch.raft.stm")


class StateMachine:
    """Applies committed batches in order; tracks last_applied."""

    def __init__(self, consensus) -> None:
        self.consensus = consensus
        self.last_applied = -1
        self._task: asyncio.Task | None = None
        self._applied_waiters: list[tuple[int, asyncio.Future]] = []

    async def apply(self, batch) -> None:  # override
        raise NotImplementedError

    async def start(self) -> "StateMachine":
        self._task = asyncio.create_task(self._apply_loop())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def wait_applied(self, offset: int, timeout: float | None = None) -> None:
        if self.last_applied >= offset:
            return
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._applied_waiters.append((offset, fut))
        if timeout is None:
            await fut
        else:
            try:
                await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                raise RaftError(Errc.timeout, f"offset {offset} not applied in time")

    def _notify_applied(self) -> None:
        fire = [w for w in self._applied_waiters if w[0] <= self.last_applied]
        self._applied_waiters = [w for w in self._applied_waiters if w[0] > self.last_applied]
        for _, fut in fire:
            if not fut.done():
                fut.set_result(None)

    async def _apply_loop(self) -> None:
        c = self.consensus
        while True:
            try:
                if c.commit_index <= self.last_applied:
                    try:
                        await c.wait_for_commit(self.last_applied + 1, timeout=0.5)
                    except RaftError as e:
                        if e.errc == Errc.shutting_down:
                            return
                        continue
                    except Exception:
                        continue
                start = max(self.last_applied + 1, c.start_offset)
                batches = await c.make_reader(start, 4 << 20)
                if not batches:
                    # Prefix-truncated past our cursor (snapshot install).
                    if c.start_offset > self.last_applied + 1:
                        self.last_applied = c.start_offset - 1
                        self._notify_applied()
                    else:
                        await asyncio.sleep(0.01)
                    continue
                for b in batches:
                    await self.apply(b)
                    self.last_applied = b.last_offset
                self._notify_applied()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("stm apply loop error (group %d)", c.group)
                await asyncio.sleep(0.05)


class MuxStateMachine(StateMachine):
    """Routes batches to sub-STMs by batch type (mux_state_machine.h)."""

    def __init__(self, consensus, handlers: dict) -> None:
        """handlers: RecordBatchType -> async callable(batch)."""
        super().__init__(consensus)
        self._handlers = dict(handlers)

    async def apply(self, batch) -> None:
        handler = self._handlers.get(batch.header.type)
        if handler is not None:
            await handler(batch)
