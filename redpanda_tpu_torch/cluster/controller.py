"""Cluster controller: raft group 0 + command STM + frontends.

Parity with cluster/controller.h:31-79: one raft group (id 0, ntp
{redpanda/controller/0}) spanning the seed brokers replicates typed
``Command`` batches; every node's ``ControllerStm`` (a mux state machine,
controller_stm.h) applies them to the same in-memory tables
(topic_table, members_table, credential/acl stores), and each node's
``ControllerBackend`` (controller_backend.py) reconciles the deltas into
local partitions. Frontends (topics_frontend, members_frontend,
security_frontend) build commands and ``replicate_and_wait`` them,
forwarding to the current controller leader when invoked elsewhere
(cluster/service.cc forwarding pattern).

(The JAX package's cluster/controller.py, copied. Nothing here picks a
device: group 0 and every data group validate on the device of the
``GroupManager`` the controller is given, and ``start`` resolves that
device before it creates group 0, so a controller on ``"cuda"`` without a
card raises there and creates nothing.)
"""

from __future__ import annotations

import asyncio
import logging

from redpanda_tpu_torch.cluster import commands as cmds
from redpanda_tpu_torch.cluster.allocator import PartitionAllocator
from redpanda_tpu_torch.cluster.commands import Command, CommandType
from redpanda_tpu_torch.cluster.members import Broker, MembersTable, MembershipState
from redpanda_tpu_torch.cluster.topic_table import (
    PartitionAssignment,
    TopicConfig,
    TopicTable,
)
from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.models.fundamental import NTP, INTERNAL_NAMESPACE, NodeId
from redpanda_tpu_torch.models.record import RecordBatchType
from redpanda_tpu_torch.raft.state_machine import MuxStateMachine
from redpanda_tpu_torch.raft.types import ConsistencyLevel, Errc, RaftError, VNode

logger = logging.getLogger("rptorch.cluster.controller")

CONTROLLER_GROUP = 0
CONTROLLER_NTP = NTP(INTERNAL_NAMESPACE, "controller", 0)


class ClusterError(Exception):
    def __init__(self, msg: str, *, retriable: bool = False) -> None:
        super().__init__(msg)
        self.retriable = retriable


class NotControllerError(ClusterError):
    def __init__(self, leader: NodeId | None) -> None:
        super().__init__(f"not the controller leader (leader={leader})", retriable=True)
        self.leader = leader


class TopicExistsError(ClusterError):
    """Typed so the RPC/dispatcher layers map it to the single-node
    contract (ValueError from topic_table.add_topic) instead of pattern-
    matching error strings."""

    def __init__(self, name: str) -> None:
        super().__init__(f"topic exists: {name}")
        self.topic = name


class ControllerStm(MuxStateMachine):
    """Applies replicated commands to the node-local tables.

    Mirrors controller_stm.h's mux over {topic_updates_dispatcher,
    members_manager, security_manager, data_policy_manager}; security and
    data-policy applies are pluggable callbacks so those layers attach
    without a dependency cycle.
    """

    def __init__(self, controller: "Controller", consensus) -> None:
        handlers = {
            RecordBatchType.topic_management_cmd: self._apply_cmd_batch,
            RecordBatchType.user_management_cmd: self._apply_cmd_batch,
            RecordBatchType.acl_management_cmd: self._apply_cmd_batch,
            RecordBatchType.node_management_cmd: self._apply_cmd_batch,
            RecordBatchType.data_policy_management_cmd: self._apply_cmd_batch,
        }
        super().__init__(consensus, handlers)
        self.controller = controller
        # offset -> error string, so replicate_and_wait can surface apply
        # failures to the caller instead of reporting false success
        # (bounded: controller command rates are tiny)
        self._apply_errors: dict[int, str] = {}

    def error_at(self, offset: int) -> str | None:
        return self._apply_errors.get(offset)

    async def _apply_cmd_batch(self, batch) -> None:
        for rec in batch.records():
            try:
                cmd = Command.from_record(rec)
            except Exception:
                logger.exception("undecodable controller command, skipping")
                self._record_error(batch.last_offset, "undecodable command")
                continue
            try:
                await self.controller.apply_command(cmd)
            except Exception as e:
                # Apply must never wedge the loop; a deterministic command
                # that fails here fails identically on every node — record
                # it so the issuing frontend can report the failure.
                logger.exception("controller command apply failed: %s", cmd.type)
                self._record_error(batch.last_offset, f"{cmd.type.name}: {e}")

    def _record_error(self, offset: int, msg: str) -> None:
        self._apply_errors[offset] = msg
        if len(self._apply_errors) > 1024:
            for k in sorted(self._apply_errors)[:512]:
                del self._apply_errors[k]


class Controller:
    def __init__(
        self,
        self_node: VNode,
        group_manager,  # raft.GroupManager
        connection_cache,  # rpc.ConnectionCache
    ) -> None:
        self.self_node = self_node
        self.gm = group_manager
        self.connections = connection_cache
        self.topic_table = TopicTable()
        self.members = MembersTable()
        self.allocator = PartitionAllocator()
        self.consensus = None
        self.stm: ControllerStm | None = None
        self._next_group = CONTROLLER_GROUP + 1
        # pluggable appliers: CommandType -> async callable(cmd)
        self._extra_appliers: dict[CommandType, object] = {}
        # strong refs for background fibers (drain watchers): the loop only
        # holds weak refs, so an unreferenced task can be GC'd mid-flight
        self._bg_tasks: set[asyncio.Task] = set()
        # keep connection cache in sync with membership
        self.members.register_change_callback(self._on_member_change)

    # ------------------------------------------------------------ wiring
    def register_applier(self, types: list[CommandType], fn) -> None:
        """Attach an apply function for command types owned by another
        subsystem (security, data policy)."""
        for t in types:
            self._extra_appliers[t] = fn

    def _on_member_change(self, b: Broker) -> None:
        if b.node_id == self.self_node.id:
            return
        if b.state == MembershipState.removed:
            # deferred close happens inside the cache on next touch
            pass
        else:
            self.connections.register(b.node_id, b.host, b.port)

    # ------------------------------------------------------------ lifecycle
    async def start(self, seed_nodes: list[VNode]) -> "Controller":
        """Create/join raft0 across the seed set (controller.cc bootstrap:
        every seed broker starts group 0 with the same voter set)."""
        resolve_device(self.gm.device)
        self.consensus = await self.gm.create_group(
            CONTROLLER_GROUP, CONTROLLER_NTP, seed_nodes
        )
        self.stm = ControllerStm(self, self.consensus)
        await self.stm.start()
        return self

    async def stop(self) -> None:
        for t in list(self._bg_tasks):
            t.cancel()
        if self._bg_tasks:
            await asyncio.gather(*self._bg_tasks, return_exceptions=True)
        self._bg_tasks.clear()
        if self.stm is not None:
            await self.stm.stop()
            self.stm = None

    # ------------------------------------------------------------ state
    def is_leader(self) -> bool:
        return self.consensus is not None and self.consensus.is_leader()

    @property
    def leader_id(self) -> NodeId | None:
        return self.consensus.leader_id if self.consensus else None

    async def wait_for_leader(self, timeout: float = 8.0) -> NodeId:
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            lid = self.leader_id
            if lid is not None:
                return lid
            if asyncio.get_running_loop().time() > deadline:
                raise ClusterError("no controller leader", retriable=True)
            await asyncio.sleep(0.05)

    # ------------------------------------------------------------ replicate
    async def replicate_and_wait(self, cmd: Command, timeout: float = 10.0) -> None:
        """Leader: replicate with quorum ack and wait until OUR stm applied
        it. Non-leader: raise NotControllerError (the cluster service /
        frontends forward)."""
        if not self.is_leader():
            raise NotControllerError(self.leader_id)
        try:
            res = await self.consensus.replicate(
                [cmd.to_batch()], ConsistencyLevel.quorum_ack
            )
        except RaftError as e:
            if e.errc == Errc.not_leader:
                raise NotControllerError(self.leader_id) from e
            raise ClusterError(str(e), retriable=True) from e
        await self.stm.wait_applied(res.last_offset, timeout)
        err = self.stm.error_at(res.last_offset)
        if err is not None:
            raise ClusterError(f"command apply failed: {err}")

    # ------------------------------------------------------------ apply
    async def apply_command(self, cmd: Command) -> None:
        d = cmd.data
        t = cmd.type
        if t == CommandType.create_topic:
            cfg = TopicConfig(name=d["config"]["name"], partition_count=0)
            for k, v in d["config"].get("overrides", {}).items():
                cfg.apply_override(k, v)
            cfg.replication_factor = int(d["config"].get("replication_factor", 1))
            cfg.ns = d["config"].get("ns", cfg.ns)
            assignments = [self._pa(a) for a in d["assignments"]]
            self.topic_table.apply_create(cfg, assignments)
            self._track_groups(assignments)
            for pa in assignments:
                self.allocator.note_allocated(pa.replicas)
        elif t == CommandType.delete_topic:
            md = self.topic_table.remove_topic(d["topic"])
            for pa in md.assignments.values():
                self.allocator.deallocate(pa.replicas)
        elif t == CommandType.create_partition:
            assignments = [self._pa(a) for a in d["assignments"]]
            self.topic_table.apply_add_partitions(d["topic"], assignments)
            self._track_groups(assignments)
            for pa in assignments:
                self.allocator.note_allocated(pa.replicas)
        elif t == CommandType.update_topic_properties:
            self.topic_table.update_properties(d["topic"], d["overrides"])
        elif t == CommandType.move_partition_replicas:
            self.topic_table.begin_move(
                NTP(d["ns"], d["topic"], d["partition"]), d["replicas"]
            )
        elif t == CommandType.finish_moving_partition_replicas:
            ntp = NTP(d["ns"], d["topic"], d["partition"])
            md = self.topic_table.get(ntp.topic)
            old = (
                list(md.assignments[ntp.partition].replicas)
                if md and ntp.partition in md.assignments
                else []
            )
            self.topic_table.finish_move(ntp, d["replicas"])
            new = list(d["replicas"])
            self.allocator.note_allocated([r for r in new if r not in old])
            self.allocator.deallocate([r for r in old if r not in new])
        elif t == CommandType.create_non_replicable_topic:
            src = self.topic_table.get(d["source_topic"])
            if src is None:
                raise ClusterError(f"source topic missing: {d['source_topic']}")
            cfg = TopicConfig(
                name=d["name"], partition_count=0, ns=src.config.ns,
                replication_factor=1,
            )
            # materialized topics mirror the source's partitioning but are
            # NOT raft-replicated (coproc writes bypass raft) — group -1
            assignments = [
                PartitionAssignment(
                    NTP(cfg.ns, cfg.name, pa.ntp.partition), list(pa.replicas), group=-1
                )
                for pa in src.assignments.values()
            ]
            self.topic_table.apply_create(cfg, assignments)
        elif t == CommandType.register_node:
            self.members.apply_register(
                Broker(
                    d["node_id"], d["host"], d["port"],
                    d.get("kafka_host", d["host"]), d.get("kafka_port", 9092),
                    admin_port=d.get("admin_port", 0),
                )
            )
            self.allocator.register_node(d["node_id"])
        elif t == CommandType.decommission_node:
            self.members.apply_state(d["node_id"], MembershipState.draining)
            self.allocator.decommission_node(d["node_id"])
        elif t == CommandType.recommission_node:
            self.members.apply_state(d["node_id"], MembershipState.active)
            self.allocator.recommission_node(d["node_id"])
        elif t == CommandType.finish_reallocations:
            self.members.apply_state(d["node_id"], MembershipState.removed)
            self.allocator.unregister_node(d["node_id"])
        elif t in self._extra_appliers:
            await self._extra_appliers[t](cmd)
        else:
            logger.warning("no applier for controller command %s", t)

    def _pa(self, a: dict) -> PartitionAssignment:
        return PartitionAssignment(
            NTP(a["ns"], a["topic"], a["partition"]), list(a["replicas"]),
            leader=None, group=a.get("group", -1),
        )

    def _track_groups(self, assignments: list[PartitionAssignment]) -> None:
        for pa in assignments:
            if pa.group >= self._next_group:
                self._next_group = pa.group + 1

    # ------------------------------------------------------------ topics frontend
    async def create_topic(self, cfg: TopicConfig) -> None:
        if not self.is_leader():
            raise NotControllerError(self.leader_id)
        if self.topic_table.contains(cfg.name):
            raise TopicExistsError(cfg.name)
        replica_sets = self.allocator.allocate(
            cfg.partition_count, cfg.replication_factor
        )
        assignments = []
        for p, replicas in enumerate(replica_sets):
            ntp = NTP(cfg.ns, cfg.name, p)
            assignments.append(
                cmds.assignment_payload(ntp, self._alloc_group(), replicas)
            )
        overrides = {k: v for k, v in cfg.config_map().items() if v is not None}
        # concurrent same-name creates that both pass the contains() check
        # apply as first-wins no-ops (see topic_table.apply_create), so the
        # loser observes success with the winner's assignments
        await self.replicate_and_wait(
            cmds.create_topic_cmd(
                {
                    "name": cfg.name,
                    "ns": cfg.ns,
                    "replication_factor": cfg.replication_factor,
                    "overrides": overrides,
                },
                assignments,
            )
        )

    def _alloc_group(self) -> int:
        g = self._next_group
        self._next_group += 1
        return g

    async def delete_topic(self, name: str, ns: str = "kafka") -> None:
        if not self.topic_table.contains(name):
            raise ClusterError(f"unknown topic: {name}")
        await self.replicate_and_wait(cmds.delete_topic_cmd(ns, name))

    async def create_partitions(self, name: str, new_total: int) -> None:
        md = self.topic_table.get(name)
        if md is None:
            raise ClusterError(f"unknown topic: {name}")
        if new_total <= md.config.partition_count:
            raise ClusterError("partition count can only grow")
        n_new = new_total - md.config.partition_count
        replica_sets = self.allocator.allocate(n_new, md.config.replication_factor)
        assignments = []
        for i, replicas in enumerate(replica_sets):
            p = md.config.partition_count + i
            ntp = NTP(md.config.ns, name, p)
            assignments.append(
                cmds.assignment_payload(ntp, self._alloc_group(), replicas)
            )
        await self.replicate_and_wait(
            cmds.create_partition_cmd(md.config.ns, name, assignments)
        )

    async def update_topic_properties(self, name: str, overrides: dict) -> None:
        if not self.topic_table.contains(name):
            raise ClusterError(f"unknown topic: {name}")
        await self.replicate_and_wait(
            cmds.update_topic_properties_cmd("kafka", name, overrides)
        )

    async def move_partition_replicas(self, ntp: NTP, replicas: list[NodeId]) -> None:
        md = self.topic_table.get(ntp.topic)
        if md is None or ntp.partition not in md.assignments:
            raise ClusterError(f"unknown partition: {ntp}")
        for r in replicas:
            if not self.members.contains(r) and r != self.self_node.id:
                raise ClusterError(f"unknown node: {r}")
        await self.replicate_and_wait(cmds.move_partition_replicas_cmd(ntp, replicas))

    async def finish_move(self, ntp: NTP, replicas: list[NodeId]) -> None:
        await self.replicate_and_wait(cmds.finish_moving_cmd(ntp, replicas))

    async def create_non_replicable_topic(
        self, source: str, name: str, ns: str = "kafka"
    ) -> None:
        if self.topic_table.contains(name):
            return  # idempotent: coproc recreates on redeploy
        await self.replicate_and_wait(
            cmds.create_non_replicable_topic_cmd(ns, source, name)
        )

    # ------------------------------------------------------------ members frontend
    async def register_broker(self, b: Broker) -> None:
        await self.replicate_and_wait(
            cmds.register_node_cmd(
                b.node_id, b.host, b.port, b.kafka_host, b.kafka_port,
                admin_port=b.admin_port,
            )
        )

    async def decommission_node(self, node_id: NodeId) -> None:
        if not self.members.contains(node_id):
            raise ClusterError(f"unknown node: {node_id}")
        # validate BEFORE replicating anything: every replica on the node
        # must have somewhere to go, or the cluster would be left half-
        # drained (the reference refuses with "not enough nodes")
        survivors = sum(
            1
            for b in self.members.all_brokers()
            if b.node_id != node_id and b.state.name == "active"
        )
        for md in self.topic_table.topics().values():
            for pa in md.assignments.values():
                if node_id in pa.replicas and pa.group >= 0:
                    if survivors < len(pa.replicas):
                        raise ClusterError(
                            f"cannot decommission node {node_id}: "
                            f"{pa.ntp} needs {len(pa.replicas)} replicas but "
                            f"only {survivors} active nodes would remain"
                        )
        await self.replicate_and_wait(cmds.decommission_node_cmd(node_id))
        # kick replica drain: every partition hosted on the node gets a
        # move command to a reallocated set (members_backend semantics)
        for md in self.topic_table.topics().values():
            for pa in md.assignments.values():
                if node_id in pa.replicas and pa.group >= 0:
                    new_set = self.allocator.reallocate_replica(pa.replicas, node_id)
                    await self.replicate_and_wait(
                        cmds.move_partition_replicas_cmd(pa.ntp, new_set)
                    )
        # watch the drain and seal it with finish_reallocations so the node
        # transitions draining -> removed (members_backend completion)
        t = asyncio.create_task(self._watch_drain(node_id))
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)

    def _node_is_drained(self, node_id: NodeId) -> bool:
        for md in self.topic_table.topics().values():
            for pa in md.assignments.values():
                if node_id in pa.replicas or (
                    pa.moving_to is not None and node_id in pa.moving_to
                ):
                    return False
        return True

    async def _watch_drain(self, node_id: NodeId, timeout: float = 120.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while asyncio.get_running_loop().time() < deadline:
            if not self.is_leader():
                return  # the new leader's operator re-drives; state is replicated
            if self._node_is_drained(node_id):
                try:
                    await self.replicate_and_wait(
                        Command(CommandType.finish_reallocations, {"node_id": node_id})
                    )
                except ClusterError:
                    logger.exception("finish_reallocations failed for node %d", node_id)
                return
            await asyncio.sleep(0.25)
        logger.warning("drain of node %d did not finish within %ss", node_id, timeout)

    async def recommission_node(self, node_id: NodeId) -> None:
        await self.replicate_and_wait(cmds.recommission_node_cmd(node_id))
