"""Streaming batch reader abstraction (the JAX package's models/reader.py,
copied; parity with model/record_batch_reader.h:48).

A ``RecordBatchReader`` yields ``RecordBatch``es asynchronously; consumers
pull with ``read_some``/``consume``. Memory and generator-backed factories
cover the in-process uses (tests, coproc frontend, raft replicate input).
"""

from __future__ import annotations

from typing import AsyncIterator, Awaitable, Callable, Iterable

from redpanda_tpu_torch.models.record import RecordBatch


class RecordBatchReader:
    def __init__(self, gen: AsyncIterator[RecordBatch]):
        self._gen = gen

    def __aiter__(self) -> AsyncIterator[RecordBatch]:
        return self._gen

    async def consume(self, consumer: Callable[[RecordBatch], Awaitable[bool] | bool]):
        """Feed every batch to `consumer`; stop early if it returns False."""
        import inspect

        async for batch in self._gen:
            res = consumer(batch)
            if inspect.isawaitable(res):
                res = await res
            if res is False:
                break
        return consumer

    async def collect(self) -> list[RecordBatch]:
        return [b async for b in self._gen]


def make_memory_reader(batches: Iterable[RecordBatch]) -> RecordBatchReader:
    async def gen():
        for b in batches:
            yield b

    return RecordBatchReader(gen())


def make_generator_reader(agen: AsyncIterator[RecordBatch]) -> RecordBatchReader:
    return RecordBatchReader(agen)
