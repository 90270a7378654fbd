"""Broker aggregate: the service graph a request handler can reach (the
JAX package's kafka/server/broker.py).

Parity with kafka::request_context's view of the world (metadata_cache,
partition_manager, group router, quota manager — kafka/server/
request_context.h) plus the topic mutation entry points that the reference
routes through cluster::topics_frontend. Single-node phase: mutations apply
locally; the controller replaces the mutation path later.

The port holds ``BrokerConfig`` whole and the ``Broker``'s data plane: the
topic table, the partition manager, topic create/delete/grow, restart
recovery of the topic tree, quotas, fetch sessions, data policies and the
authorizer. ``device`` is where the produce path's CRC backend and the
policy engine run: the card unless the caller asks for the CPU. It is
resolved where the Kafka path first needs it (``KafkaServer.start``, a
produce, a policy fetch), so a broker that only hosts storage or a coproc
runtime is built anywhere.

The group coordinator (``group_manager.GroupManager`` over
``__consumer_offsets``), the transaction coordinator
(``tx_coordinator.TxCoordinator``) and one producer state machine a
partition (``rm_stm_for``) are the reference's. The replicated
``SecurityManager`` comes with ROADMAP item 10d: until then reading
``security`` raises ``AttributeError`` and the authorizer runs over a
store of the broker's own.

A ``KafkaServer`` calls ``recover_topics`` on start. Without one (a coproc
runtime over the broker alone) the caller does, after a restart::

    storage = await StorageApi(data_dir).start()
    broker = Broker(BrokerConfig(data_dir=data_dir), storage, device="cuda")
    await broker.recover_topics()
    api = await CoprocApi(broker, device="cuda").start()
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from redpanda_tpu_torch.cluster.partition import Partition, PartitionManager
from redpanda_tpu_torch.cluster.topic_table import TopicConfig, TopicTable
from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.models.fundamental import NTP, DEFAULT_NAMESPACE, NodeId
from redpanda_tpu_torch.storage.log_manager import StorageApi


@dataclass
class BrokerConfig:
    node_id: NodeId = 0
    cluster_id: str = "redpanda_tpu"
    advertised_host: str = "127.0.0.1"
    advertised_port: int = 9092
    data_dir: str = "/tmp/redpanda_tpu"
    auto_create_topics: bool = True
    default_partitions: int = 1
    default_replication: int = 1
    fetch_poll_interval_s: float = 0.02
    sasl_enabled: bool = False
    superusers: list = field(default_factory=list)
    # client quotas (quota_manager.h): bytes/s per client-id, None=unlimited
    target_quota_byte_rate: int | None = None
    target_fetch_quota_byte_rate: int | None = None
    # produce-path memory gate (connection_context.cc:32 memory units)
    kafka_request_max_memory: int = 64 * 1024 * 1024
    # queue-depth latency control (qdc, application.cc:1002-1016); off by
    # default like the reference's kafka_qdc_enable
    kafka_qdc_enable: bool = False
    kafka_qdc_max_latency_ms: float = 80.0
    kafka_qdc_window_s: float = 1.0
    kafka_qdc_min_depth: int = 1
    kafka_qdc_max_depth: int = 100
    fetch_session_cache_size: int = 1000
    # consistency-testing ONLY: ack quorum produces at leader level,
    # deliberately violating acks=-1 so the linearizability checker can
    # prove it catches the violation (tools/consistency; never set this
    # in production)
    unsafe_relaxed_acks: bool = False


class Broker:
    def __init__(self, config: BrokerConfig, storage: StorageApi, *, device="cuda"):
        self.config = config
        self.storage = storage
        self.topic_table = TopicTable()
        self.partition_manager = PartitionManager(storage, config.node_id)
        from redpanda_tpu_torch.kafka.server.group_manager import GroupManager

        self.group_coordinator = GroupManager(self)
        self.metadata_cache = None  # multi-node: cluster.MetadataCache
        self.coproc_api = None  # wired once the transform engine attaches
        from redpanda_tpu_torch.kafka.server.tx_coordinator import TxCoordinator

        self.tx_coordinator = TxCoordinator(self)
        self._rm_stms: dict = {}  # NTP -> RmStm
        from redpanda_tpu_torch.kafka.server.fetch_session_cache import FetchSessionCache
        from redpanda_tpu_torch.kafka.server.quota_manager import QuotaManager

        self.quota_manager = QuotaManager(
            produce_rate=config.target_quota_byte_rate,
            fetch_rate=config.target_fetch_quota_byte_rate,
        )
        self.fetch_sessions = FetchSessionCache(config.fetch_session_cache_size)
        # per-topic fetch-path transform policies (v8_engine equivalent);
        # the engine is built on first use, on the broker's device
        from redpanda_tpu_torch.policy import DataPolicyTable

        self.data_policies = DataPolicyTable()
        self._device_arg = device
        self._device: torch.device | None = None
        self._policy_engine = None
        self.controller_dispatcher = None  # multi-node: routes security/topic cmds
        self.controller_leader_fn = None  # multi-node: live controller leader id
        # ACLs over a store of the broker's own until the replicated
        # SecurityManager is ported (ROADMAP item 10d)
        from redpanda_tpu_torch.security import AclStore, Authorizer

        self.authorizer = Authorizer(AclStore(), set(config.superusers))
        self.sasl_enabled = config.sasl_enabled
        # resource_mgmt budget plane + produce admission controller:
        # installed by the application (app.py). None = admission off —
        # bare broker harnesses keep the historical semantics.
        self.budget_plane = None
        self.produce_admission = None

    @property
    def device(self) -> torch.device:
        """The Kafka path's device, resolved on first use: RuntimeError for
        ``"cuda"`` without a card."""
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    @property
    def policy_engine(self):
        """The fetch path's ``PolicyEngine`` on the broker's device (K4 for
        fetches of 256 records or more), built on first use."""
        if self._policy_engine is None:
            from redpanda_tpu_torch.policy import PolicyEngine

            self._policy_engine = PolicyEngine(device=self.device)
        return self._policy_engine

    # ------------------------------------------------------------ data policy
    async def set_data_policy(self, topic: str, name: str, spec_json: str) -> None:
        """data_policy_frontend: replicate through the controller when
        clustered, apply locally otherwise."""
        from redpanda_tpu_torch.cluster.commands import create_data_policy_cmd

        cmd = create_data_policy_cmd(topic, name, spec_json)
        if self.controller_dispatcher is not None:
            await self.controller_dispatcher.replicate(cmd)
        else:
            await self.data_policies.apply_command(cmd)

    async def delete_data_policy(self, topic: str) -> None:
        from redpanda_tpu_torch.cluster.commands import delete_data_policy_cmd

        cmd = delete_data_policy_cmd(topic)
        if self.controller_dispatcher is not None:
            await self.controller_dispatcher.replicate(cmd)
        else:
            await self.data_policies.apply_command(cmd)

    # ------------------------------------------------------------ recovery
    def _persist_topic_config(self, cfg: TopicConfig) -> None:
        """Topic configs go to the kvstore so restart recovery restores
        overrides (cleanup.policy, retention, …) — in a cluster the
        controller log is the durable copy instead."""
        import json

        from redpanda_tpu_torch.storage.kvstore import KeySpace

        payload = {"ns": cfg.ns, "partitions": cfg.partition_count,
                   "revision": cfg.revision, "config": cfg.config_map()}
        self.storage.kvs.put(
            KeySpace.storage, f"topic_cfg/{cfg.ns}/{cfg.name}".encode(),
            json.dumps(payload).encode(),
        )

    async def recover_topics(self) -> None:
        """Single-node restart: rediscover topics from the on-disk log tree
        (<data>/<ns>/<topic>/<partition>) plus their persisted configs. In a
        cluster the controller STM replay rebuilds the topic table instead;
        here the disk IS the source of truth (log_manager.cc:179 recovery)."""
        import asyncio
        import json

        from redpanda_tpu_torch.storage.kvstore import KeySpace

        base = self.storage.log_mgr.config.base_dir
        # the three-level dir walk is pure disk metadata: off-loop, so a
        # restart over a large data dir doesn't freeze the accept loop
        found = await asyncio.to_thread(_scan_topic_tree, base)
        for (ns, topic), n_parts in sorted(found.items()):
            if self.topic_table.contains(topic):
                continue
            cfg = TopicConfig(topic, n_parts, ns=ns)
            saved = self.storage.kvs.get(
                KeySpace.storage, f"topic_cfg/{ns}/{topic}".encode()
            )
            if saved is not None:
                payload = json.loads(saved.decode())
                cfg.revision = payload.get("revision", 0)
                for k, v in payload.get("config", {}).items():
                    cfg.apply_override(k, v)
            elif topic == "__consumer_offsets":
                cfg.cleanup_policy = "compact"
            await self.create_topic(cfg)

    def _log_overrides(self, config: TopicConfig):
        return config.log_overrides(self.storage.log_mgr.config)

    def update_log_configs(self, name: str) -> None:
        """Push altered topic storage configs into LIVE logs so retention /
        segment-size changes apply without a restart."""
        md = self.topic_table.get(name)
        if md is None:
            return
        new_cfg = md.config.log_overrides(self.storage.log_mgr.config)
        if new_cfg is None:
            new_cfg = self.storage.log_mgr.config
        for pa in md.assignments.values():
            p = self.partition_manager.get(pa.ntp)
            if p is not None:
                p.log.config = new_cfg

    def _next_revision(self) -> int:
        """Monotonic topic-incarnation counter (kvstore-durable), so a
        recreate never reuses a prior incarnation's archival paths."""
        from redpanda_tpu_torch.storage.kvstore import KeySpace

        raw = self.storage.kvs.get(KeySpace.storage, b"topic_revision_counter")
        rev = (int(raw.decode()) if raw else 0) + 1
        self.storage.kvs.put(
            KeySpace.storage, b"topic_revision_counter", str(rev).encode()
        )
        return rev

    # ------------------------------------------------------------ topics
    async def _await_topic_table(self, pred, what: str, timeout: float = 15.0) -> None:
        """The requesting node applies committed controller commands
        asynchronously (its own STM replay); callers of the kafka API see
        the mutation once the LOCAL table reflects it.

        Polling is deliberate: TopicTable.wait_for_deltas() is a DRAINING
        single-consumer queue owned by the controller backend's reconcile
        loop — a second consumer here would steal its deltas."""
        import asyncio
        import time as _t

        deadline = _t.monotonic() + timeout
        while not pred():
            if _t.monotonic() > deadline:
                raise TimeoutError(f"{what} not applied locally in {timeout}s")
            await asyncio.sleep(0.05)

    async def create_topic(self, config: TopicConfig, *, local_only: bool = False) -> None:
        """Create a topic. Clustered: route through the controller leader
        (allocation + replicated create_topic_cmd — topics_frontend path,
        SURVEY §3.5); every replica node reconciles its own raft member.
        Standalone (or local_only, used for per-node materialized logs):
        single-replica local creation."""
        if self.controller_dispatcher is not None and not local_only:
            await self.controller_dispatcher.topic_op(0, {
                "name": config.name,
                "ns": config.ns,
                "partitions": config.partition_count,
                "replication": config.replication_factor,
                "overrides": {
                    k: v for k, v in config.config_map().items() if v is not None
                },
            })
            await self._await_topic_table(
                lambda: self.topic_table.contains(config.name),
                f"create {config.name}",
            )
            return
        if config.revision == 0:
            config.revision = self._next_revision()
        md = self.topic_table.add_topic(
            config, replicas_for=lambda p: [self.config.node_id]
        )
        for pa in md.assignments.values():
            await self.partition_manager.manage(
                pa.ntp, log_overrides=self._log_overrides(config)
            )
        self._persist_topic_config(config)

    async def delete_topic(self, name: str) -> None:
        from redpanda_tpu_torch.storage.kvstore import KeySpace

        if self.controller_dispatcher is not None:
            md = self.topic_table.get(name)
            ns = md.config.ns if md is not None else "kafka"
            await self.controller_dispatcher.topic_op(1, {"name": name, "ns": ns})
            await self._await_topic_table(
                lambda: not self.topic_table.contains(name), f"delete {name}"
            )
            return
        md = self.topic_table.remove_topic(name)
        for pa in md.assignments.values():
            await self.partition_manager.remove(pa.ntp)
            # drop the producer/tx stm: a recreated topic must not inherit
            # the old incarnation's sequence/transaction state
            self._rm_stms.pop(pa.ntp, None)
        self.storage.kvs.remove(
            KeySpace.storage, f"topic_cfg/{md.config.ns}/{name}".encode()
        )

    async def create_partitions(self, name: str, new_count: int) -> None:
        if self.controller_dispatcher is not None:
            await self.controller_dispatcher.topic_op(
                2, {"name": name, "total": new_count}
            )
            await self._await_topic_table(
                lambda: (
                    (md := self.topic_table.get(name)) is not None
                    and md.config.partition_count >= new_count
                ),
                f"add_partitions {name}",
            )
            return
        self.topic_table.add_partitions(
            name, new_count, replicas_for=lambda p: [self.config.node_id]
        )
        md = self.topic_table.get(name)
        for pa in md.assignments.values():
            await self.partition_manager.manage(
                pa.ntp, log_overrides=self._log_overrides(md.config)
            )

    # ------------------------------------------------------------ lookup
    def get_partition(self, topic: str, partition: int, ns: str = DEFAULT_NAMESPACE) -> Partition | None:
        return self.partition_manager.get(NTP(ns, topic, partition))

    def rm_stm_for(self, partition: Partition):
        """Producer/tx state machine attached to a partition, created on
        first touch (partition.h stm_manager hooks). Callers must
        ``await ensure_rm_recovered`` before first use after restart."""
        from redpanda_tpu_torch.cluster.rm_stm import RmStm

        stm = self._rm_stms.get(partition.ntp)
        if stm is None:
            stm = RmStm(partition)
            self._rm_stms[partition.ntp] = stm
        return stm

    async def recovered_rm_stm(self, partition: Partition):
        return await self.rm_stm_for(partition).ensure_recovered()

    def is_internal_topic(self, name: str) -> bool:
        return name.startswith("__") or name.startswith("_redpanda")


def _scan_topic_tree(base: str) -> dict[tuple[str, str], int]:
    """(ns, topic) -> partition count from <base>/<ns>/<topic>/<partition>."""
    import os

    found: dict[tuple[str, str], int] = {}
    if not os.path.isdir(base):
        return found
    for ns in os.listdir(base):
        ns_dir = os.path.join(base, ns)
        if not os.path.isdir(ns_dir):
            continue
        for topic in os.listdir(ns_dir):
            t_dir = os.path.join(ns_dir, topic)
            if not os.path.isdir(t_dir):
                continue
            parts = [p for p in os.listdir(t_dir) if p.isdigit()]
            if parts:
                found[(ns, topic)] = max(int(p) for p in parts) + 1
    return found
