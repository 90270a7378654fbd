"""Coproc pacemaker + script contexts: the steady-state transform loop (the
JAX package's coproc/pacemaker.py, ported over ``TorchEngine``).

Parity with coproc/pacemaker.h:41-145 and script_context.cc:47-135:
one ``ScriptContext`` fiber per deployed script runs
  read_from_inputs (per-ntp, from last_acked+1 up to the LSO, bounded by
  coproc_max_batch_size and the shared inflight-bytes semaphore,
  script_context_frontend.cc:80-117)
  → engine.process_batch (the engine replaces the Node.js RPC hop)
  → write_materialized (CRC-checked, recompressed batches appended
  DIRECTLY to the materialized storage log, bypassing raft —
  script_context_backend.cc:40-68)
  → advance last_acked.
Offsets are snapshotted per flush interval into the kvstore's coproc
keyspace and recovered on startup (offset_storage_utils.cc:36-104), as the
JAX package's JSON under the same key, so either package resumes from the
other's offsets.

A materialized topic is created through the controller where the broker
has a ``controller_dispatcher`` (replicated, every broker's table agrees),
else as a local topic next to its source.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

from redpanda_tpu_torch.coproc import faults, leakwatch
from redpanda_tpu_torch.coproc.engine import (
    ProcessBatchItem,
    ProcessBatchRequest,
    TorchEngine,
)
from redpanda_tpu_torch.models.fundamental import NTP, MaterializedNTP
from redpanda_tpu_torch.observability.trace import tracer
from redpanda_tpu_torch.resource_mgmt.admission import ShedError
from redpanda_tpu_torch.resource_mgmt.budgets import MemoryAccount
from redpanda_tpu_torch.storage.kvstore import KeySpace

logger = logging.getLogger("rptorch.coproc.pacemaker")


class _StopScript(Exception):
    """Raised inside a script's own fiber to end it (deregistration from
    within tick — the fiber cannot await its own cancellation)."""


def _release_abandoned(engine):
    """Done-callback for a submit future whose tick gave up waiting: the
    orphan ticket will never be harvested, so its admission reservation
    releases here (a failed submit released its own in submit_group)."""

    def cb(fut):
        try:
            ticket = fut.result()
        except BaseException:  # pandalint: disable=EXC901 -- not a swallow: a raising submit released its own reservation and already classified the failure inside submit_group; this callback only exists for the SUCCESS-after-abandon path
            return
        engine._release_admission(ticket)

    return cb


class ScriptContext:
    def __init__(
        self,
        pacemaker: "Pacemaker",
        script_id: int,
        name: str,
        input_topics: tuple[str, ...],
    ) -> None:
        self.pacemaker = pacemaker
        self.script_id = script_id
        self.name = name
        self.input_topics = input_topics
        # per input ntp: offsets {last_read, last_acked}
        # (ntp_context.h:54-60 offset_tracker)
        self.offsets: dict[NTP, int] = {}
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        """do_execute (script_context.cc:66): run ticks until cancelled;
        jittered idle sleep when no input advanced, exponential backoff on
        consecutive tick failures (a dead engine must not busy-spin reads).

        The retry posture IS the loop: a failed/timed-out tick advanced no
        offsets and wrote nothing, so the next tick re-reads the same
        records — bounded only by backoff, never by a give-up that would
        strand input."""
        pm = self.pacemaker
        failures = 0
        while True:
            try:
                moved = await self.tick()
                failures = 0
            except asyncio.CancelledError:
                raise
            except _StopScript:
                return
            except Exception as exc:
                failures += 1
                faults.note_failure("pacemaker_tick", exc)
                if failures == 1:
                    logger.exception("script %s tick failed", self.name)
                else:
                    logger.debug(
                        "script %s tick failed again (%d consecutive): %r",
                        self.name, failures, exc,
                    )
                moved = False
            if not moved:
                delay = pm.idle_sleep_s
                if failures:
                    delay = min(
                        pm.idle_sleep_s * (2 ** min(failures, 7)), 5.0
                    )
                await asyncio.sleep(delay)

    async def tick(self) -> bool:
        """One read → transform → write round; True if any offset moved.

        Offsets advance ONLY after the materialized write lands
        (script_context.cc's read → process → write → last_acked order) —
        advancing at read time would drop records on any write failure.
        """
        pm = self.pacemaker
        knobs = pm.launch_knobs()
        items = []
        read_high: dict[NTP, int] = {}
        t_read0 = time.perf_counter()
        # group_ticks_per_launch fuses N ticks' worth of input into one
        # launch (deeper batching amortizes the device round trip; the
        # governor shrinks it back to 1 under memory pressure)
        read_budget = pm.max_batch_size * knobs["group_ticks"]
        for ntp in self._input_ntps():
            batches = await self._read_ntp(ntp, read_budget)
            if batches:
                items.append(ProcessBatchItem(self.script_id, ntp, batches))
                read_high[ntp] = batches[-1].last_offset
        if not items:
            return False
        # One trace per productive tick (idle ticks would drown the ring);
        # the read phase is back-dated into it once we know work exists.
        with tracer.span(
            "coproc.tick", root=True,
            node=self.pacemaker.broker.config.node_id,
        ) as tick_span:
            tracer.record(
                "coproc.read",
                (time.perf_counter() - t_read0) * 1e6,
                tick_span.trace_id,
                start_perf=t_read0,
            )
            # Submit AND harvest run in worker threads: the first dispatch of
            # a spec jit-compiles for seconds, and anything that blocks the
            # broker's event loop that long stops raft heartbeats and forces
            # cluster-wide re-elections (measured: every group re-elected
            # ~10s after the first deploy when submit ran on-loop).
            loop = asyncio.get_running_loop()
            req = ProcessBatchRequest(items, trace_id=tick_span.trace_id)
            ex = pm.engine_executor
            # tick deadline: the engine's internal deadlines bound every
            # device leg, so these only fire when that machinery is itself
            # wedged. A timed-out executor call is ABANDONED, not retried
            # in place: its ticket is never harvested, so nothing is
            # written (no duplicates), and the un-advanced offsets make the
            # next tick re-read the same records (no loss). The governor
            # may have adaptively RAISED per-domain deadlines since the
            # static backstop was sized at startup, so re-derive per tick:
            # the backstop must always sit above the engine's own envelope
            # or it would abandon legitimately mid-envelope ticks.
            deadline_s = pm.tick_deadline_for(pm.engine)
            # launch_depth bounds concurrent submit+harvest regions across
            # every script fiber: the staged bytes of at most depth
            # launches are in flight, which is what keeps the coproc
            # account's occupancy (and so the pressure signal) meaningful
            async with pm._launch_cond:
                while pm._launch_inflight >= knobs["launch_depth"]:
                    await pm._launch_cond.wait()
                pm._launch_inflight += 1
            shed_retry_s = None
            try:
                sub_fut = loop.run_in_executor(ex, pm.engine.submit, req)
                try:
                    with tracer.span("coproc.submit.wait"):
                        ticket = await asyncio.wait_for(
                            asyncio.shield(sub_fut), timeout=deadline_s
                        )
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    # timeout OR fiber cancellation (script removal): the
                    # executor thread cannot be cancelled, and the shielded
                    # submit's eventual ticket will never be harvested —
                    # hand its reservation back or the account ratchets
                    # shut one abandoned tick at a time
                    sub_fut.add_done_callback(_release_abandoned(pm.engine))
                    raise
                res_fut = loop.run_in_executor(ex, ticket.result)
                try:
                    with tracer.span("coproc.harvest.wait"):
                        reply = await asyncio.wait_for(
                            asyncio.shield(res_fut), timeout=deadline_s
                        )
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    # shield the work item too: an un-started queued
                    # result() would otherwise be CANCELLED outright and
                    # its finally (the release) never run. Release here
                    # for promptness — _release_admission is atomic and
                    # idempotent, so the racing executor-side finally is
                    # harmless either way.
                    pm.engine._release_admission(ticket)
                    raise
            except ShedError as exc:
                # admission refused the staged bytes BEFORE any dispatch:
                # no offsets moved, nothing was written — back off the
                # throttle hint and re-read the same records (counted via
                # coproc_admission_shed_total, journaled as an ADMISSION
                # shed episode; not a fault, so no note_failure here)
                logger.debug(
                    "script %s submit shed: %s", self.name, exc
                )
                shed_retry_s = min(exc.retry_after_ms / 1000.0, 5.0)
            finally:
                async with pm._launch_cond:
                    pm._launch_inflight -= 1
                    pm._launch_cond.notify_all()
            if shed_retry_s is not None:
                # backoff OUTSIDE the depth gate: under a floored depth a
                # shed script sleeping inside the slot would head-of-line
                # block every other script's admissible launch
                await asyncio.sleep(shed_retry_s)
                return False
            if self.script_id in reply.deregistered:
                logger.warning("script %s deregistered by engine policy", self.name)
                pm.detach_script(self.name)
                self._task = None
                raise _StopScript()
            moved = False
            with tracer.span("coproc.write"):
                for item in reply.items:
                    if await self._write_materialized(item.source, item.batches):
                        self.offsets[item.source] = read_high[item.source]
                        moved = True
            if moved:
                # append-invalidation hook for the device column cache:
                # this script's input window just advanced, so its cached
                # columns can never be re-read (the cache key is
                # content-addressed — this reclaims memory, it is not
                # what keeps hits correct)
                pm.engine.invalidate_columns(self.script_id)
            return moved

    def _input_ntps(self) -> list[NTP]:
        out = []
        for topic in self.input_topics:
            md = self.pacemaker.broker.topic_table.get(topic)
            if md is None:
                continue
            out.extend(pa.ntp for pa in md.assignments.values())
        return out

    async def _read_ntp(self, ntp: NTP, max_bytes: int | None = None) -> list:
        """read_ntp (script_context_frontend.cc:80-98): from last_acked+1 up
        to the LSO, bounded by the read budget (max batch size scaled by
        the group_ticks launch knob) + the read semaphore."""
        pm = self.pacemaker
        p = pm.broker.partition_manager.get(ntp)
        if p is None or not p.is_leader():
            return []
        start = self.offsets.get(ntp, p.start_offset - 1) + 1
        lso = p.last_stable_offset  # exclusive
        if start >= lso:
            return []
        budget = max_bytes if max_bytes is not None else pm.max_batch_size
        reserved = await pm.read_budget.acquire(budget)
        try:
            # read what was RESERVED, not what was asked: an oversized
            # budget clamps to the whole account and must read that much,
            # or the bytes in flight exceed the bound they reserved against
            return await p.make_reader(start, reserved, max_offset=lso - 1)
        finally:
            pm.read_budget.release(reserved)

    async def _write_materialized(self, source: NTP, batches: list) -> bool:
        """do_write_materialized_partition (script_context_backend.cc:40-68):
        CRC check + append directly to the materialized log, no raft.
        Returns True when the source's offset may advance."""
        if not batches:
            return True  # everything filtered out: the read is still acked
        pm = self.pacemaker
        mntp = MaterializedNTP(source, self.name).ntp
        partition = await pm.ensure_materialized(source, mntp)
        if partition is None:
            return False  # create raced/failed: retry this read next tick
        good = []
        for b in batches:
            if b.verify_kafka_crc():
                good.append(b)
            else:
                logger.error("dropping corrupt transformed batch for %s", mntp)
        if good:
            await partition.replicate(good, 2)  # no_ack: direct log write
        return True


class Pacemaker:
    def __init__(
        self,
        broker,
        engine: TorchEngine,
        *,
        max_batch_size: int = 32 * 1024,
        max_inflight_reads: int = 8,
        offset_flush_interval_s: float = 5.0,
        idle_sleep_s: float = 0.05,
        tick_deadline_s: float = 120.0,
        group_ticks_per_launch: int = 1,
        launch_depth: int = 4,
    ) -> None:
        self.broker = broker
        self.engine = engine
        self.max_batch_size = max_batch_size
        self.tick_deadline_s = tick_deadline_s
        # The read bound is BYTE-denominated (a FIFO-waiting account of
        # max_inflight_reads * max_batch_size bytes), not a read-count
        # semaphore: the group_ticks launch knob scales each read's byte
        # budget, and a count-based gate sized for one-tick reads would
        # let concurrent buffers reach group_ticks_cap x the configured
        # coproc_max_inflight_bytes. An oversized single read clamps to
        # the whole account and proceeds alone (MemoryAccount semantics).
        self.read_budget = leakwatch.wrap(
            MemoryAccount(
                "coproc_read",
                max(1, int(max_inflight_reads)) * max(1, int(max_batch_size)),
            ),
            "pacemaker.read_budget",
        )
        # launch knobs (resource_mgmt / governor ADMISSION domain):
        # group_ticks_per_launch scales how many ticks' worth of input one
        # launch fuses (the read budget per ntp), launch_depth bounds
        # concurrent submit+harvest regions across ALL scripts. Static
        # here; when the engine's governor has autotune configured
        # (CoprocApi does), launch_knobs() returns ITS hysteresis-bounded
        # dynamic verdicts instead — the engine trades launch depth for
        # latency as memory pressure rises.
        self.group_ticks_per_launch = max(1, int(group_ticks_per_launch))
        self.launch_depth = max(1, int(launch_depth))
        self._launch_inflight = 0
        self._launch_cond = asyncio.Condition()
        self.offset_flush_interval_s = offset_flush_interval_s
        self.idle_sleep_s = idle_sleep_s
        self._scripts: dict[str, ScriptContext] = {}
        self._flush_task: asyncio.Task | None = None
        self._materialized_locks: dict[NTP, asyncio.Lock] = {}
        # Dedicated executor for engine submit/harvest: these block for a
        # whole launch (sharded host stages + a device round trip), and on
        # the loop's DEFAULT executor they would starve every
        # asyncio.to_thread user in the broker (storage/archival blocking
        # I/O shares that pool). Lazily created; sized like the default
        # executor it replaced — a harvest can block up to the 30s mask
        # timeout, so a small fixed cap would head-of-line block every
        # other script's tick behind a few wedged fetches.
        self._engine_executor: ThreadPoolExecutor | None = None

    def launch_knobs(self) -> dict:
        """Effective {"group_ticks", "launch_depth"} for the next tick:
        the governor's dynamic verdict when its autotune is configured
        (journaled, hysteresis-bounded), the static constructor knobs for
        bare engines/test doubles."""
        gov = getattr(self.engine, "governor", None)
        if gov is not None and gov.autotune_snapshot() is not None:
            return gov.launch_knobs()
        return {
            "group_ticks": self.group_ticks_per_launch,
            "launch_depth": self.launch_depth,
        }

    def tick_deadline_for(self, engine) -> float:
        """Effective tick backstop: the configured static deadline, never
        below 4x the engine's worst-case per-domain retry envelope (the
        governor can raise per-domain deadlines adaptively at runtime; a
        backstop sized once at startup would then fire on healthy-but-slow
        ticks). Engines without a governor (bare test doubles) keep the
        static value."""
        gov = getattr(engine, "governor", None)
        if gov is None:
            return self.tick_deadline_s
        return max(self.tick_deadline_s, 4.0 * gov.max_envelope_s())

    @property
    def engine_executor(self) -> ThreadPoolExecutor:
        if self._engine_executor is None:
            self._engine_executor = ThreadPoolExecutor(
                max_workers=min(32, (os.cpu_count() or 1) + 4),
                thread_name_prefix="rptpu-coproc-tick",
            )
        return self._engine_executor

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> "Pacemaker":
        self._recover_offsets()
        self._flush_task = asyncio.create_task(self._flush_loop())
        return self

    async def stop(self) -> None:
        if self._flush_task is not None:
            self._flush_task.cancel()
            try:
                await self._flush_task
            except asyncio.CancelledError:
                pass
            self._flush_task = None
        for ctx in list(self._scripts.values()):
            await ctx.stop()
        self._save_offsets()
        self._scripts.clear()
        if self._engine_executor is not None:
            # fibers are stopped, nothing new can be submitted; don't block
            # broker shutdown on a straggling harvest
            self._engine_executor.shutdown(wait=False)
            self._engine_executor = None

    # ------------------------------------------------------------ scripts
    async def add_source(self, name: str, script_id: int, input_topics: tuple[str, ...]) -> None:
        """pacemaker.h:75 add_source: one fiber per script."""
        if name in self._scripts:
            return
        ctx = ScriptContext(self, script_id, name, input_topics)
        for key, off in self._saved_offsets().get(name, {}).items():
            ns, topic, part = key.rsplit("/", 2)
            ctx.offsets[NTP(ns, topic, int(part))] = off
        self._scripts[name] = ctx
        ctx.start()

    async def remove_script(self, name: str) -> None:
        ctx = self._scripts.pop(name, None)
        if ctx is not None:
            await ctx.stop()

    def detach_script(self, name: str) -> None:
        """Unregister without awaiting the fiber (used from INSIDE the
        fiber, which then exits via _StopScript)."""
        self._scripts.pop(name, None)

    def scripts(self) -> dict[str, ScriptContext]:
        return dict(self._scripts)

    # ------------------------------------------------------------ materialized logs
    async def ensure_materialized(self, source: NTP, mntp: NTP):
        """Create the materialized topic/partition on demand under a
        per-ntp mutex (script_context_backend.cc:70-78)."""
        lock = self._materialized_locks.setdefault(mntp, asyncio.Lock())
        async with lock:
            p = self.broker.partition_manager.get(mntp)
            if p is not None:
                return p
            if not self.broker.topic_table.contains(mntp.topic):
                from redpanda_tpu_torch.cluster.topic_table import TopicConfig

                src_md = self.broker.topic_table.get(source.topic)
                n_parts = src_md.config.partition_count if src_md else 1
                try:
                    dispatcher = getattr(self.broker, "controller_dispatcher", None)
                    if dispatcher is not None:
                        # Clustered: replicate create_non_replicable_topic
                        # so every broker's metadata agrees; assignments
                        # mirror the source (group -1, coproc writes bypass
                        # raft — commands.h:112 non_replicable semantics)
                        from redpanda_tpu_torch.cluster.service import (
                            OP_CREATE_NON_REPLICABLE,
                        )

                        await dispatcher.topic_op(  # pandalint: disable=LCK702 -- create-once-per-mntp mutex: a serialized tick beats duplicate create ops racing the controller
                            OP_CREATE_NON_REPLICABLE,
                            {"source": source.topic, "name": mntp.topic,
                             "ns": mntp.ns},
                        )
                        await self.broker._await_topic_table(
                            lambda: self.broker.topic_table.contains(mntp.topic),
                            f"materialize {mntp.topic}",
                        )
                    else:
                        # Standalone: the materialized log lives NEXT TO its
                        # source partition (script_context_backend.cc:70-78
                        # direct storage append, no raft)
                        await self.broker.create_topic(
                            TopicConfig(mntp.topic, n_parts, 1, ns=mntp.ns),
                            local_only=True,
                        )
                except ValueError:
                    pass
            # the local log: reconciled by the backend (clustered) or
            # created by the local path above
            p = self.broker.partition_manager.get(mntp)
            if p is None:
                for _ in range(100):
                    await asyncio.sleep(0.05)
                    p = self.broker.partition_manager.get(mntp)
                    if p is not None:
                        break
            return p

    # ------------------------------------------------------------ offsets
    def _kvs(self):
        return self.broker.storage.kvs

    def _saved_offsets(self) -> dict[str, dict[str, int]]:
        raw = self._kvs().get(KeySpace.coproc, b"offsets")
        return json.loads(raw.decode()) if raw else {}

    def _save_offsets(self) -> None:
        data = {
            name: {
                f"{ntp.ns}/{ntp.topic}/{ntp.partition}": off
                for ntp, off in ctx.offsets.items()
            }
            for name, ctx in self._scripts.items()
        }
        self._kvs().put(KeySpace.coproc, b"offsets", json.dumps(data).encode())

    def _recover_offsets(self) -> None:
        # contexts pick their saved offsets up in add_source
        pass

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.offset_flush_interval_s)
            try:
                self._save_offsets()
            except Exception as exc:
                # classified: losing offset snapshots silently would turn a
                # later restart into a giant re-read with no warning
                faults.note_failure("offset_flush", exc)
                logger.exception("coproc offset flush failed")
