"""Coproc API: event listener + script dispatcher + pacemaker + engine (the
JAX package's coproc/api.py, ported over ``TorchEngine``).

Parity with coproc/api.h (api.cc:19-49 owns pacemaker + event listener),
wasm/event_listener (event_listener.cc:139-156 polls the internal topic),
and script_dispatcher.cc:166 enable_coprocessors (register with the engine
AND the pacemaker). The reference's listener is an in-proc kafka::client
over loopback; running inside the broker process, this listener reads the
internal topic's partition directly — same log, no socket hop.

Deploy surface (used by the CLI's `wasm deploy` and tests): produce a
validated deploy/remove event to ``coprocessor_internal_topic``; the
listener reconciles events in log order on every node that hosts it.

One departure: ``CoprocApi(broker, config, device=...)`` hands ``device``
to ``TorchEngine``, "cuda" by default. Tests pass "cpu"; with no CUDA
device the default raises, as ``TorchEngine``'s does, and nothing falls
back to the CPU. On a standalone broker the caller recovers the topic
tree (``broker.recover_topics()``) before it starts the api::

    storage = await StorageApi(data_dir).start()
    broker = Broker(BrokerConfig(data_dir=data_dir), storage)
    await broker.recover_topics()
    api = await CoprocApi(broker, device="cpu").start()
    await api.deploy("errs", spec.to_json(), ["logs"])
"""

from __future__ import annotations

import asyncio
import logging

from redpanda_tpu_torch.coproc import faults, wasm_event
from redpanda_tpu_torch.coproc.engine import EnableResponseCode, TorchEngine
from redpanda_tpu_torch.coproc.pacemaker import Pacemaker
from redpanda_tpu_torch.models.fundamental import COPROC_INTERNAL_TOPIC, NTP
from redpanda_tpu_torch.cluster.topic_table import TopicConfig

logger = logging.getLogger("rptorch.coproc.api")


class CoprocApi:
    def __init__(self, broker, config=None, *, device="cuda") -> None:
        self.broker = broker

        def _knob(name, default):
            return getattr(config, name, default) if config is not None else default

        max_batch = _knob("coproc_max_batch_size", 32 * 1024)
        inflight_bytes = _knob("coproc_max_inflight_bytes", 10 * 1024 * 1024)
        flush_ms = _knob("coproc_offset_flush_interval_ms", 300_000)
        # budget plane (resource_mgmt): installed on the broker by the
        # application; bare brokers (unit harnesses) run plane-less, which
        # keeps admission off and the historical semantics
        plane = getattr(broker, "budget_plane", None)
        if _knob("coproc_lockwatch", False):
            # must flip BEFORE the engine is built: per-object locks bind
            # their recorder (or lack of one) at construction
            from redpanda_tpu_torch.coproc import lockwatch

            lockwatch.enable()
        if _knob("coproc_leakwatch", False):
            # same contract: the engine's admission controller and arena
            # bind their balance recorder (or lack of one) at construction
            from redpanda_tpu_torch.coproc import leakwatch

            leakwatch.enable()
        # None -> the engine resolves min(4, cores); the property default
        # matches, so an unset config and a default config agree
        self.engine = TorchEngine(
            device=device,
            host_workers=_knob("coproc_host_workers", None),
            host_pool_probe=_knob("coproc_host_pool_probe", True),
            host_pool_recal_launches=_knob(
                "coproc_host_pool_recal_launches", None
            ),
            gather_frame=_knob("coproc_gather_frame", True),
            structural_parse=_knob("coproc_structural_parse", None),
            device_column_cache_mb=_knob(
                "coproc_device_column_cache_mb", 32
            ),
            # the mesh's shards are cards of the engine's device type;
            # coproc_mesh_backend names a JAX backend and has no counterpart
            mesh_devices=_knob("coproc_mesh_devices", 0) or None,
            mesh_probe=_knob("coproc_mesh_probe", True),
            device_deadline_ms=_knob("coproc_device_deadline_ms", None),
            launch_retries=_knob("coproc_launch_retries", None),
            retry_backoff_ms=_knob("coproc_retry_backoff_ms", None),
            breaker_threshold=_knob("coproc_breaker_threshold", None),
            breaker_cooldown_ms=_knob("coproc_breaker_cooldown_ms", None),
            adaptive_deadline=_knob("coproc_adaptive_deadline", None),
            adaptive_deadline_margin=_knob(
                "coproc_adaptive_deadline_margin", None
            ),
            governor_journal_capacity=_knob(
                "coproc_governor_journal_capacity", None
            ),
            budget_plane=plane,
        )
        # close the autotune loop: the governor's ADMISSION domain owns
        # the dynamic group_ticks/launch_depth verdicts, driven by the
        # success-only dispatch-leg histogram and the plane's occupancy
        group_ticks = _knob("coproc_group_ticks_per_launch", 1)
        launch_depth = _knob("coproc_launch_depth", 4)
        self.engine.governor.configure_autotune(
            enabled=_knob("coproc_autotune_launch", True),
            group_ticks=group_ticks,
            group_ticks_cap=_knob("coproc_group_ticks_max", 8),
            launch_depth=launch_depth,
            launch_depth_cap=_knob("coproc_launch_depth_max", 8),
            pressure_fn=(
                (lambda: (plane.pressure(), plane.max_occupancy()[1]))
                if plane is not None
                else None
            ),
        )
        self.pacemaker = Pacemaker(
            broker, self.engine,
            max_batch_size=max_batch,
            group_ticks_per_launch=group_ticks,
            launch_depth=launch_depth,
            # the byte budget bounds concurrent reads: each read holds at
            # most max_batch_size bytes (configuration.h:57-61 semantics)
            max_inflight_reads=max(1, inflight_bytes // max(max_batch, 1)),
            offset_flush_interval_s=flush_ms / 1000.0,
            # the tick backstop sits ABOVE the engine's own retry envelope
            # (a few device legs per tick, each up to one full envelope) —
            # it only fires when the in-engine machinery itself is wedged
            tick_deadline_s=max(
                60.0, 4 * self.engine._fault_policy.envelope_s()
            ),
        )
        self._listener_task: asyncio.Task | None = None
        self._listen_offset = 0
        self._active: dict[str, wasm_event.WasmEvent] = {}
        self.poll_interval_s = 0.05

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> "CoprocApi":
        await self.pacemaker.start()
        # topic creation happens inside the listener loop with retries:
        # at startup the cluster may not have a quorum of REGISTERED nodes
        # yet (replication = default factor needs them), and blocking app
        # start on cluster formation would deadlock — every node is doing
        # the same thing
        self._listener_task = asyncio.create_task(self._listen_loop())
        return self

    async def _ensure_internal_topic(self) -> bool:
        if self.broker.topic_table.contains(COPROC_INTERNAL_TOPIC):
            return True
        try:
            # replicated to the default factor: every broker's listener
            # reads its LOCAL raft replica of the event log, so deploys
            # reconcile cluster-wide without a client hop
            await self.broker.create_topic(
                TopicConfig(
                    COPROC_INTERNAL_TOPIC, 1,
                    self.broker.config.default_replication,
                )
            )
            return True
        except ValueError:
            return True  # lost a concurrent create: it exists
        except Exception as e:  # pandalint: disable=EXC901 -- startup poll: the topic is not creatable until a controller leader exists; retried every 0.5s, not a fault
            logger.debug("coproc internal topic not creatable yet: %s", e)
            return False

    async def stop(self) -> None:
        if self._listener_task is not None:
            self._listener_task.cancel()
            try:
                await self._listener_task
            except asyncio.CancelledError:
                pass
            self._listener_task = None
        await self.pacemaker.stop()
        # stop the engine's background machinery LAST: the pacemaker's
        # final ticks may still be harvesting (engine.shutdown joins the
        # harvester off-loop; it can block up to a drain, so thread it)
        await asyncio.to_thread(self.engine.shutdown)

    # ------------------------------------------------------------ deploy surface
    async def deploy(self, name: str, spec_json: str, input_topics: list[str]) -> None:
        from redpanda_tpu_torch.models.fundamental import MaterializedNTP

        for t in input_topics:
            if not self.broker.topic_table.contains(t):
                raise ValueError(f"input topic does not exist: {t}")
            # one canonical predicate: internal topics and materialized
            # topics (MaterializedNTP convention) cannot be inputs
            if self.broker.is_internal_topic(t) or MaterializedNTP.parse(NTP("kafka", t, 0)):
                raise ValueError(f"invalid input topic: {t}")
        await self._produce_event(
            wasm_event.make_deploy_record(name, spec_json, input_topics)
        )

    async def remove(self, name: str) -> None:
        await self._produce_event(wasm_event.make_remove_record(name))

    async def _produce_event(self, rec) -> None:
        # topic creation is deferred to the listener loop (cluster
        # formation); a deploy right after start must drive it itself
        deadline = asyncio.get_event_loop().time() + 10.0
        p = self.broker.get_partition(COPROC_INTERNAL_TOPIC, 0)
        while p is None and asyncio.get_event_loop().time() < deadline:
            await self._ensure_internal_topic()
            await asyncio.sleep(0.05)
            p = self.broker.get_partition(COPROC_INTERNAL_TOPIC, 0)
        if p is None:
            raise RuntimeError("coproc internal topic missing")
        await p.replicate([wasm_event.deploy_batch([rec])], 0)

    # ------------------------------------------------------------ listener
    async def _listen_loop(self) -> None:
        """do_ingest (event_listener.cc:139): poll, validate, reconcile,
        dispatch enable/disable to engine + pacemaker."""
        created = False
        while True:
            try:
                if not created:
                    created = await self._ensure_internal_topic()
                await self._ingest_once()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # classified: a broker that can no longer ingest deploys is
                # degraded even though this loop survives to retry
                faults.note_failure("wasm_ingest", exc)
                logger.exception("coproc event ingest failed")
            await asyncio.sleep(self.poll_interval_s if created else 0.5)

    async def _ingest_once(self) -> None:
        p = self.broker.get_partition(COPROC_INTERNAL_TOPIC, 0)
        if p is None:
            return
        hwm = p.high_watermark
        if self._listen_offset >= hwm:
            return
        events = []
        next_offset = self._listen_offset
        while next_offset < hwm:
            batches = await p.make_reader(next_offset, 1 << 20, max_offset=hwm - 1)
            if not batches:
                break
            for b in batches:
                for rec in b.records():
                    ev = wasm_event.parse_event(rec)
                    if ev is not None:
                        events.append(ev)
                    else:
                        logger.warning("ignoring malformed coproc event")
                next_offset = b.last_offset + 1
        # dispatch BEFORE advancing the cursor, but isolate per event: a
        # POISON event — the script itself is bad (SandboxViolation from
        # validation, ValueError from a malformed event body) — is logged
        # and skipped, otherwise one bad deploy would wedge every later
        # deploy/remove on every broker forever. Anything else is a
        # TRANSIENT infrastructure failure (partition moving, engine
        # mid-restart): re-raise WITHOUT advancing the cursor so the whole
        # chunk retries on the next poll — swallowing it would silently
        # diverge script state across the cluster (this broker skips a
        # deploy its peers applied). Retried events are idempotent:
        # _enable dedupes unchanged redeploys by checksum and _disable of
        # an inactive name is a no-op.
        from redpanda_tpu_torch.coproc.sandbox import SandboxViolation

        for name, ev in wasm_event.reconcile(events).items():
            try:
                if ev.action == wasm_event.DEPLOY:
                    await self._enable(ev)
                else:
                    await self._disable(name)
            except asyncio.CancelledError:
                raise
            except (SandboxViolation, ValueError) as exc:
                faults.note_failure("wasm_event", exc)
                logger.exception("poison coproc event %r skipped", name)
        self._listen_offset = next_offset

    async def _enable(self, ev: wasm_event.WasmEvent) -> None:
        """script_dispatcher::enable_coprocessors: engine first, then the
        pacemaker source (script_dispatcher.cc:166)."""
        if ev.name in self._active and self._active[ev.name].checksum == ev.checksum:
            return  # unchanged redeploy
        if ev.name in self._active:
            await self._disable(ev.name)
        if ev.py_source:
            # sandboxed python transform: restricted-AST validation runs
            # inside enable_py_sandboxed on THIS broker before registration
            from redpanda_tpu_torch.coproc.engine import ErrorPolicy

            codes = [self.engine.enable_py_sandboxed(
                ev.script_id, ev.py_source, ev.input_topics,
                ErrorPolicy.deregister if ev.policy == "deregister"
                else ErrorPolicy.skip_on_failure,
            )]
        else:
            codes = self.engine.enable_coprocessors(
                [(ev.script_id, ev.spec_json, ev.input_topics)]
            )
        if codes[0] != EnableResponseCode.success:
            logger.error("enable %s failed: %s", ev.name, codes[0].name)
            return
        await self.pacemaker.add_source(ev.name, ev.script_id, ev.input_topics)
        self._active[ev.name] = ev
        logger.info("coprocessor %s enabled on %s", ev.name, list(ev.input_topics))

    async def _disable(self, name: str) -> None:
        ev = self._active.pop(name, None)
        if ev is None:
            return
        await self.pacemaker.remove_script(name)
        self.engine.disable_coprocessors([ev.script_id])
        logger.info("coprocessor %s disabled", name)

    # ------------------------------------------------------------ views
    def active_scripts(self) -> list[str]:
        return sorted(self._active)
